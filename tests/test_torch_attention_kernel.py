"""The fused attention kernel's route, formulas, split products and gate.

- :func:`route` on every kind of input (a pure function of device, dtypes
  and shapes), and ``blockwise_attention`` on CPU and meta tensors, which
  stay on the plain loop;
- :func:`check_rows_see_keys` against the mask itself;
- the kernels' formulas in plain torch (below: D from fp32 O, P
  recomputed from the log-sum-exp, GQA summed per kv head) against
  autograd through the plain ``blockwise_attention``, in fp64;
- the hi/lo split of the kernels' fp32 operands against fp64;
- the card's gate (``chip_smoke.attn_gaps`` within ``ATTN_LIMITS``) on
  the kernels' arithmetic emulated here: it passes, and fails with a lo
  half dropped or a key tile skipped;
- on a card (``-k on_the_card`` or ``-m card``; skipped without one), the
  kernel against the plain loop through the same gate, forward and
  backward, within one tile and across several, and the same bits twice.

No JAX here: the card test runs in this file.
"""
import math
import sys
from pathlib import Path
from typing import Optional

import pytest
import torch

from repro_torch.kernels import attention as kattn
from repro_torch.models import attention as tattn

ROOT = str(Path(__file__).resolve().parents[1])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the card's gate)

BF16, F16, F32, F64 = torch.bfloat16, torch.float16, torch.float32, \
    torch.float64


@pytest.fixture
def card():
    """Skip the test where there is no CUDA card (decided here, when the
    test runs, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# -- the route ----------------------------------------------------------------


@pytest.mark.parametrize("device, dtypes, q_shape, kv_shape, want", [
    ("cpu", (BF16,) * 3, (2, 8, 4, 64), (2, 8, 2, 64), "plain"),
    ("meta", (BF16,) * 3, (2, 8, 4, 64), (2, 8, 2, 64), "plain"),
    ("cpu", (F16,) * 3, (2, 8, 4, 64), (2, 8, 2, 64), "plain"),
    ("cpu", (BF16,) * 3, (2, 8, 4, 72), (2, 8, 2, 72), "plain"),
    ("cuda", (F32,) * 3, (2, 8, 4, 64), (2, 8, 2, 64), "plain"),
    ("cuda", (F64,) * 3, (2, 8, 4, 8), (2, 8, 2, 8), "plain"),
    ("cuda", (BF16,) * 3, (4, 4096, 16, 64), (4, 4096, 8, 64), "kernel"),
    ("cuda", (BF16,) * 3, (1, 9, 4, 16), (1, 9, 4, 16), "kernel"),
    ("cuda", (BF16,) * 3, (1, 9, 48, 128), (1, 30, 1, 128), "kernel"),
    ("cuda", (BF16,) * 3, (1, 9, 4, 48), (1, 9, 2, 48), "kernel"),
    ("cuda", (BF16,) * 3, (1, 9, 4, 8), (1, 9, 2, 8), ValueError),
    ("cuda", (BF16,) * 3, (1, 9, 4, 72), (1, 9, 2, 72), ValueError),
    ("cuda", (BF16,) * 3, (1, 9, 4, 256), (1, 9, 2, 256), ValueError),
    ("cuda", (F16,) * 3, (1, 9, 4, 64), (1, 9, 2, 64), ValueError),
    ("cuda", (BF16, F32, F32), (1, 9, 4, 64), (1, 9, 2, 64), ValueError),
    ("cuda", (BF16,) * 3, (1, 9, 6, 64), (1, 9, 4, 64), ValueError),
    ("cuda", (BF16,) * 3, (1, 9, 4, 64), (2, 9, 2, 64), ValueError),
    ("cuda", (BF16,) * 3, (9, 4, 64), (9, 2, 64), ValueError),
], ids=["cpu", "meta", "cpu-fp16", "cpu-odd-dh", "cuda-fp32", "cuda-fp64",
        "granite", "dh16", "mqa-dh128", "dh48", "dh8", "dh72", "dh256",
        "cuda-fp16", "mixed", "heads", "batch", "rank3"])
def test_route(device, dtypes, q_shape, kv_shape, want):
    if isinstance(want, str):
        assert kattn.route(device, dtypes, q_shape, kv_shape) == want
    else:
        with pytest.raises(want):
            kattn.route(device, dtypes, q_shape, kv_shape)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_blockwise_attention_stays_plain_off_the_card(device):
    """bf16 tensors off the card run the plain loop: no kernel call, no
    plain call counted on CUDA, and the plain loop's shape and dtype."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g).to(BF16).to(device)
               for shape in ((2, 9, 4, 16), (2, 9, 2, 16), (2, 9, 2, 16)))
    before = (kattn.fused_attention.forward_calls,
              tattn.blockwise_attention.plain_cuda_calls)
    out = tattn.blockwise_attention(q, k, v, causal=True, window=4)
    assert out.shape == q.shape and out.dtype == BF16
    assert out.device.type == device
    assert (kattn.fused_attention.forward_calls,
            tattn.blockwise_attention.plain_cuda_calls) == before


def test_check_rows_see_keys_matches_the_mask():
    """It raises exactly where some row of the plain loop's mask is empty."""
    for sq in (1, 2, 5):
        for sk in (1, 3, 6):
            for causal in (True, False):
                for window in (None, 1, 2, 4):
                    for q_offset in (-2, 0, 1, 3, 7):
                        seen = kattn.visible(sq, sk, causal, window,
                                             q_offset)
                        empty = bool((~seen.any(dim=1)).any())
                        if empty:
                            with pytest.raises(ValueError):
                                kattn.check_rows_see_keys(
                                    sq, sk, causal, window, q_offset)
                        else:
                            kattn.check_rows_see_keys(sq, sk, causal,
                                                      window, q_offset)


# -- the kernels' formulas in plain torch ------------------------------------


def _grouped(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, Hkv, Dh) -> (B, S, heads, Dh): kv head h // n_rep."""
    return t.repeat_interleave(heads // t.shape[2], dim=2)


def _scores(q, k, causal, window, q_offset, scale):
    """Scaled scores (B, Hq, Sq, Sk), the visibility mask and the scale."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q, _grouped(k, q.shape[2])) * scale
    seen = kattn.visible(q.shape[1], k.shape[1], causal, window, q_offset,
                         q.device)
    return s, seen, scale


def attention_reference(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0,
                        scale: Optional[float] = None):
    """The forward's formulas on dense scores, in the inputs' dtype:
    ``(O (B, Sq, Hq, Dh), lse (B, Hq, Sq))``, lse the natural log-sum-exp
    of each row's visible scaled scores."""
    s, seen, _ = _scores(q, k, causal, window, q_offset, scale)
    s = s.masked_fill(~seen, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, _grouped(v, q.shape[2]))
    return o, lse


def _sum_groups(t: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, Sk, Hq, Dh) -> (B, Sk, Hkv, Dh): each kv head's query heads
    summed."""
    b, sk, hq, dh = t.shape
    return t.reshape(b, sk, hkv, hq // hkv, dh).sum(3)


def attention_backward_reference(q, k, v, o, lse, do, *, causal: bool = True,
                                 window: Optional[int] = None,
                                 q_offset: int = 0,
                                 scale: Optional[float] = None):
    """The backward kernels' formulas, in the inputs' dtype:
    ``(dq, dk, dv)`` from the forward's unrounded ``o`` and ``lse``.

    D = rowsum(dO * O); P = exp(S - lse) on visible scores, else 0;
    dV = P^T dO and dP = dO V^T per query head; dS = P (dP - D); dQ =
    scale dS K, dK = scale dS^T Q; dK and dV summed over the query heads
    of each kv head."""
    hq, hkv = q.shape[2], k.shape[2]
    s, seen, scale = _scores(q, k, causal, window, q_offset, scale)
    p = torch.where(seen, torch.exp(s - lse[..., None]), 0.0)
    delta = (do * o).sum(-1).transpose(1, 2)                # (B, Hq, Sq)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, _grouped(v, hq))
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _grouped(k, hq)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
    return dq, _sum_groups(dk, hkv), _sum_groups(dv, hkv)


def split_bf16(x: torch.Tensor):
    """fp32 ``x`` as bf16 ``hi + lo``: hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(BF16)
    return hi, (x - hi.float()).to(BF16)


def split_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernels form it: fp32 ``a`` split into bf16
    hi + lo, bf16 ``b``, both products summed in fp32 (a bf16 x bf16
    product is exact in fp32)."""
    hi, lo = split_bf16(a)
    bf = b.float()
    return hi.float() @ bf + lo.float() @ bf


def _split_einsum(eq, a, b, drop_lo):
    """``einsum(eq, a, b)`` with fp32 ``a`` split as the kernels split it
    (its hi half alone where ``drop_lo``)."""
    hi, lo = split_bf16(a)
    out = torch.einsum(eq, hi.float(), b)
    return out if drop_lo else out + torch.einsum(eq, lo.float(), b)


def _skip_last_tiles(seen: torch.Tensor) -> torch.Tensor:
    """``seen`` with each 64-row query tile's last visible 64-key tile
    hidden, where the tile sees more than one."""
    seen = seen.clone()
    t = kattn.TILE
    for i0 in range(0, seen.shape[0], t):
        cols = seen[i0:i0 + t].any(0).nonzero().flatten()
        lo, hi = int(cols.min()) // t, int(cols.max()) // t
        if hi > lo:
            seen[i0:i0 + t, hi * t:(hi + 1) * t] = False
    return seen


def kernel_emulation(q, k, v, do, *, causal: bool = True,
                     window: Optional[int] = None, q_offset: int = 0,
                     scale: Optional[float] = None, drop_lo: bool = False,
                     skip_last: bool = False):
    """The kernels' arithmetic on dense scores from bf16 q, k, v and dO:
    ``(o32, (O, dQ, dK, dV) in bf16)``.  Products of bf16 operands summed
    in fp32; the fp32 P and dS split into bf16 hi + lo.  ``drop_lo`` and
    ``skip_last`` (:func:`_skip_last_tiles`) plant the faults the card's
    gate must catch."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    hq, hkv = q.shape[2], k.shape[2]
    s, seen, scale = _scores(qf, kf, causal, window, q_offset, scale)
    if skip_last:
        seen = _skip_last_tiles(seen)
    s = s.masked_fill(~seen, float("-inf"))
    p = torch.exp(s - torch.logsumexp(s, dim=-1)[..., None])
    o32 = _split_einsum("bhqk,bkhd->bqhd", p, _grouped(vf, hq), drop_lo)
    delta = (dof * o32).sum(-1).transpose(1, 2)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, _grouped(vf, hq))
    ds = p * (dp - delta[..., None])
    dq = _split_einsum("bhqk,bkhd->bqhd", ds, _grouped(kf, hq),
                       drop_lo) * scale
    dk = _split_einsum("bhqk,bqhd->bkhd", ds, qf, drop_lo) * scale
    dv = _split_einsum("bhqk,bqhd->bkhd", p, dof, drop_lo)
    outs = (o32, dq, _sum_groups(dk, hkv), _sum_groups(dv, hkv))
    return o32, tuple(t.to(BF16) for t in outs)


# -- the formulas against autograd, in fp64 -----------------------------------

# (B, Sq, Sk, Hq, Hkv, Dh, mask keywords)
CASES = {
    "causal": (2, 9, 9, 4, 2, 16, dict(causal=True)),
    "window": (1, 11, 11, 4, 2, 16, dict(causal=True, window=4)),
    "offset": (1, 7, 12, 4, 2, 16, dict(causal=True, q_offset=5)),
    "offset-window": (2, 6, 10, 4, 4, 16,
                      dict(causal=True, q_offset=4, window=3)),
    "cross": (2, 5, 13, 4, 2, 16, dict(causal=False)),
    "mqa": (1, 8, 8, 4, 1, 16, dict(causal=True)),
    "dh64-scale": (1, 10, 10, 4, 2, 64, dict(causal=True, scale=0.015625)),
    "dh128": (1, 6, 6, 2, 1, 128, dict(causal=True)),
}
#: shapes of several 64-row, 64-key tiles: the online softmax's rescale
#: across key tiles, skipped and unmasked tiles, partial tiles, the
#: double buffer, the longest-first grid, dK/dV summed over several query
#: tiles and heads, and the head-dim instances 32, 64 (48 padded) and 128
TILED = {
    "tiles": (1, 200, 200, 4, 2, 64, dict(causal=True, scale=0.015625)),
    "tiles-window-offset": (2, 200, 330, 4, 2, 64,
                            dict(causal=True, window=100, q_offset=130)),
    "tiles-cross-dh128": (1, 150, 330, 4, 4, 128, dict(causal=False)),
    "tiles-mqa": (1, 330, 330, 8, 1, 128, dict(causal=True)),
    "tiles-window-dh32": (1, 200, 200, 2, 1, 32,
                          dict(causal=True, window=64)),
    "tiles-dh48": (1, 130, 130, 2, 2, 48, dict(causal=True)),
}


def _inputs(case, dtype=F64, seed=0, device=None):
    b, sq, sk, hq, hkv, dh, kw = {**CASES, **TILED}[case]
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, sq, hq, dh), generator=g, dtype=F64)
    k = torch.randn((b, sk, hkv, dh), generator=g, dtype=F64)
    v = torch.randn((b, sk, hkv, dh), generator=g, dtype=F64)
    do = torch.randn((b, sq, hq, dh), generator=g, dtype=F64)
    return [t.to(dtype).to(device) for t in (q, k, v, do)], kw


@pytest.mark.parametrize("case", list(CASES))
def test_forward_formulas_match_the_plain_loop(case):
    """O and the log-sum-exp on dense scores against the plain loop (small
    blocks, several of each) and logsumexp over the visible scores."""
    (q, k, v, _), kw = _inputs(case)
    o, lse = attention_reference(q, k, v, **kw)
    want = tattn.blockwise_attention(q, k, v, block_q=4, block_k=3, **kw)
    torch.testing.assert_close(o, want, rtol=1e-12, atol=1e-12)
    scale = kw.get("scale", 1 / math.sqrt(q.shape[-1]))
    s = torch.einsum("bqhd,bkhd->bhqk", q,
                     k.repeat_interleave(q.shape[2] // k.shape[2], 2))
    seen = kattn.visible(q.shape[1], k.shape[1], kw["causal"],
                         kw.get("window"), kw.get("q_offset", 0))
    lse_want = torch.logsumexp((s * scale).masked_fill(~seen, -math.inf), -1)
    torch.testing.assert_close(lse, lse_want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", list(CASES))
def test_backward_formulas_match_autograd(case):
    """dQ, dK, dV from D = rowsum(dO * O), P from the log-sum-exp and dS,
    summed per kv head, against autograd through the plain loop."""
    (q, k, v, do), kw = _inputs(case)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = tattn.blockwise_attention(q, k, v, block_q=4, block_k=3, **kw)
    want = torch.autograd.grad(out, (q, k, v), do)
    with torch.no_grad():
        o, lse = attention_reference(q, k, v, **kw)
        got = attention_backward_reference(q, k, v, o, lse, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10,
                                   msg=lambda m, n=name: f"{n}: {m}")


@pytest.mark.parametrize("depth", [16, 64, 128])
@pytest.mark.parametrize("kind", ["probabilities", "signed", "wide"])
def test_split_product_error(kind, depth):
    """An fp32 operand split into bf16 hi + lo, times a bf16 operand,
    summed in fp32: within 2**-15 of the fp64 product, relative to the
    product's largest term, and within 2**-15 of each entry's sum of
    |terms|.  bf16 alone misses the first bound by far."""
    g = torch.Generator().manual_seed(depth)
    a = {"probabilities": lambda: torch.rand((64, depth), generator=g),
         "signed": lambda: torch.randn((64, depth), generator=g),
         "wide": lambda: torch.randn((64, depth), generator=g)
         * torch.exp(4 * torch.randn((64, depth), generator=g))}[kind]()
    b = torch.randn((depth, 64), generator=g).to(BF16)
    exact = a.double() @ b.double()
    terms = a.double().abs()[:, :, None] * b.double().abs()[None]
    err = (split_product(a, b).double() - exact).abs()
    assert err.max() <= 2 ** -15 * terms.max()
    assert (err <= 2 ** -15 * terms.sum(1)).all()
    hi, lo = split_bf16(a)
    assert hi.dtype == lo.dtype == BF16
    assert ((hi.double() + lo.double() - a.double()).abs()
            <= 2 ** -16 * a.double().abs()).all()
    plain = (a.to(BF16).double() @ b.double() - exact).abs()
    assert plain.max() > 8 * 2 ** -15 * terms.max()


# -- the card's gate -----------------------------------------------------------


def _plain(q, k, v, do, kw):
    """The plain loop's O, dQ, dK and dV in fp32 on the bf16 values."""
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    out = tattn.blockwise_attention(*leaves, **kw)
    return (out.detach(), *torch.autograd.grad(out, leaves, do.float()))


@pytest.mark.parametrize("fault", [None, "drop_lo", "skip_last"])
@pytest.mark.parametrize("case", ["tiles", "tiles-window-offset"])
def test_the_card_gate_fails_planted_faults(case, fault):
    """The kernels' arithmetic, emulated, passes ``chip_smoke``'s gate; P
    and dS rounded to bf16 (lo dropped) fail it by ``o32.row`` and every
    ``.miss``, a key tile skipped by every ``.row``."""
    (q, k, v, do), kw = _inputs(case, BF16, seed=5)
    o32, got = kernel_emulation(q, k, v, do, drop_lo=fault == "drop_lo",
                                skip_last=fault == "skip_last", **kw)
    gaps = chip_smoke.attn_gaps(got, _plain(q, k, v, do, kw), o32)
    over = set(chip_smoke.attn_over(gaps))
    outputs = chip_smoke.ATTN_OUTPUTS
    want = {None: set(),
            "drop_lo": {"o32.row", *(f"{n}.miss" for n in outputs)},
            "skip_last": {"o32.row", *(f"{n}.row" for n in outputs)}}[fault]
    assert want <= over, gaps
    if fault is None:
        assert not over, gaps


def test_a_nan_is_over_every_limit():
    gaps = dict.fromkeys(chip_smoke.ATTN_LIMITS, math.nan)
    assert set(chip_smoke.attn_over(gaps)) == set(chip_smoke.ATTN_LIMITS)
    fine = {n: lim / 2 for n, lim in chip_smoke.ATTN_LIMITS.items()}
    assert chip_smoke.attn_over(fine) == {}


# -- on the card --------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("case", ["causal", "window", "offset-window",
                                  "cross", "mqa", "dh64-scale", "dh128",
                                  *TILED])
def test_kernel_matches_the_plain_loop_on_the_card(card, case):
    """Output and gradients of the kernel, and its forward's fp32 O,
    against the plain loop on the same bf16 values (widened to fp32, the
    plain loop's own arithmetic) through ``chip_smoke``'s gate, row by
    row; every launch twice for the same bits.  Run it there with
    ``PYTHONPATH=src python -m pytest -q tests/test_torch_attention_kernel.py
    -m card``."""
    (q, k, v, do), kw = _inputs(case, BF16, seed=3, device=card)
    runs = []
    for _ in range(2):
        qk, kk, vk = (t.clone().requires_grad_() for t in (q, k, v))
        out = tattn.blockwise_attention(qk, kk, vk, **kw)
        grads = torch.autograd.grad(out, (qk, kk, vk), do)
        runs.append((out, *grads))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert all(t.dtype == BF16 for t in runs[0])
    scale = kw.get("scale", 1 / math.sqrt(q.shape[-1]))
    _, o32, _ = kattn._forward(q, k, v, kw.get("causal", True),
                               kw.get("window"), kw.get("q_offset", 0),
                               scale, keep=True)
    gaps = chip_smoke.attn_gaps(runs[0], _plain(q, k, v, do, kw), o32)
    assert not chip_smoke.attn_over(gaps), gaps
