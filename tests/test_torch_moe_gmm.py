"""Kernel K3 (grouped matmul) of the port against the JAX package's.

On the CPU ``repro_torch.kernels.moe_gmm.gmm`` runs its plain version; the
JAX ``gmm`` runs its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it.  Same numpy inputs, fp32,
``rtol = atol = 1e-4`` (both sum in fp32, in different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gmm import gmm as jax_gmm
from repro.kernels.moe_gmm import pad_groups as jax_pad_groups

from repro_torch.kernels import moe_gmm as tg

SIZES = [[8, 16, 0, 24], [0, 0, 8], [32]]


def _padded_case(sizes, bm, k=16, n=24, seed=7):
    rng = np.random.default_rng(seed)
    sizes = np.asarray(sizes)
    x = rng.standard_normal((int(sizes.sum()), k)).astype(np.float32)
    w = rng.standard_normal((len(sizes), k, n)).astype(np.float32)
    padded, gids, scatter = jax_pad_groups(sizes, bm)
    xp = np.zeros((int(padded.sum()), k), np.float32)
    xp[scatter] = x
    return x, w, xp, gids, scatter


@pytest.mark.parametrize("bm", [8, 16])
@pytest.mark.parametrize("sizes", SIZES, ids=["mixed", "leading-empty",
                                              "one-group"])
def test_gmm_plain_matches_pallas_interpret(sizes, bm):
    _, w, xp, gids, scatter = _padded_case(sizes, bm)
    want = np.asarray(jax_gmm(jnp.asarray(xp), jnp.asarray(w), gids, bm=bm,
                              bk=8, bn=8, interpret=True))
    got = tg.gmm(torch.as_tensor(xp), torch.as_tensor(w),
                 torch.as_tensor(gids), bm=bm, bk=8, bn=8)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


PAD_CASES = [[8, 16, 0, 24], [0, 0, 8], [32], [0, 0, 0], [5], [3, 0, 17, 1],
             [0]]


@pytest.mark.parametrize("bm", [4, 8, 16])
@pytest.mark.parametrize("sizes", PAD_CASES,
                         ids=lambda s: "-".join(map(str, s)))
def test_pad_groups_byte_equal(sizes, bm):
    """Host copy and device form against JAX's ``pad_groups``, all-empty and
    single-group cases included; the device form marks the tiles past the
    real ones idle."""
    want = jax_pad_groups(np.asarray(sizes), bm)
    got = tg.pad_groups(np.asarray(sizes), bm)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    rows = int(sum(sizes))
    gids, scatter = tg.pad_groups_device(torch.tensor(sizes), bm, rows)
    n_real = want[1].size
    assert gids.shape == (tg.tile_bound(rows, len(sizes), bm),)
    assert gids.dtype == torch.int32 and scatter.dtype == torch.int32
    assert gids[:n_real].numpy().tobytes() == want[1].tobytes()
    assert (gids[n_real:] == tg.IDLE).all()
    assert scatter.numpy().tobytes() == want[2].tobytes()


def test_idle_tiles_give_zero_rows():
    """A device padding with idle tiles: real rows match JAX's ``gmm`` on
    the host padding, idle rows are zero."""
    sizes = np.array([3, 0, 9, 1])
    bm = 4
    x, w, xp, jgids, scatter = _padded_case(sizes, bm)
    gids, tscatter = tg.pad_groups_device(torch.as_tensor(sizes), bm,
                                          int(sizes.sum()))
    xd = torch.zeros((gids.shape[0] * bm, x.shape[1]))
    xd[tscatter.long()] = torch.as_tensor(x)
    out = tg.gmm(xd, torch.as_tensor(w), gids, bm=bm, bk=8, bn=8)
    want = np.asarray(jax_gmm(jnp.asarray(xp), jnp.asarray(w), jgids, bm=bm,
                              bk=8, bn=8, interpret=True))
    np.testing.assert_allclose(out[tscatter.long()].numpy(), want[scatter],
                               rtol=1e-4, atol=1e-4)
    assert not out[jgids.size * bm:].any()
    # any id outside [0, G) is idle, not an out-of-range read: a real
    # tile relabelled G gives zero rows
    assert out[:bm].any()
    gids[0] = len(sizes)
    assert not tg.gmm(xd, torch.as_tensor(w), gids, bm=bm, bk=8, bn=8
                      )[:bm].any()


def test_gmm_bf16_rounds_an_fp32_sum():
    """bf16 in, bf16 out: the fp32 sum rounded once, as the kernel does."""
    _, w, xp, gids, _ = _padded_case([8, 8], 8)
    xb = torch.as_tensor(xp).to(torch.bfloat16)
    wb = torch.as_tensor(w).to(torch.bfloat16)
    got = tg.gmm(xb, wb, torch.as_tensor(gids), bm=8, bk=8, bn=8)
    want = tg.gmm(xb, wb, torch.as_tensor(gids), bm=8, bk=8, bn=8,
                  out_dtype=torch.float32).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("bad", ["k", "bm", "gids", "bk"])
def test_gmm_rejects_shapes_outside_the_contract(bad):
    x, w, gids = torch.zeros(16, 8), torch.zeros(2, 8, 8), \
        torch.zeros(2, dtype=torch.int32)
    kw = dict(bm=8, bk=8, bn=8)
    if bad == "k":
        w = torch.zeros(2, 4, 8)
    elif bad == "bm":
        kw["bm"] = 5
    elif bad == "gids":
        gids = torch.zeros(3, dtype=torch.int32)
    else:
        kw["bk"] = 3
    with pytest.raises(ValueError):
        tg.gmm(x, w, gids, **kw)


# -- the host's launch plan for the kernel ------------------------------------

# granite-moe-1b-a400m's sort path (bm 16, d_model 1024, d_ff 512, 32
# experts top-8): decode of 4 slots (32 routed rows) and a 128-token
# prefill (1024 routed rows), each at the static tile bound
DECODE = tg.tile_bound(32, 32, 16) * 16
PREFILL = tg.tile_bound(1024, 32, 16) * 16


@pytest.mark.parametrize("m,k,n,grid", [
    (DECODE, 1024, 512, (34, 8, 1)),      # gate / up
    (DECODE, 512, 1024, (34, 16, 1)),     # down
    (PREFILL, 1024, 512, (96, 8, 1)),
    (PREFILL, 512, 1024, (96, 16, 1)),
], ids=["decode-gate", "decode-down", "prefill-gate", "prefill-down"])
def test_launch_plan_serving_shapes(m, k, n, grid):
    """Serving calls fill the card with 16-row blocks and no K split."""
    plan = tg.launch_plan(m, k, n, 16)
    assert plan.rows == 16 and plan.grid == grid
    assert plan.k_len == k
    assert plan.row_blocks * plan.col_blocks >= tg.TARGET_BLOCKS


@pytest.mark.parametrize("bm", [16, 64, 128])
@pytest.mark.parametrize("tiles,k,n", [(4, 1024, 512), (3, 512, 1024),
                                       (40, 1024, 512), (2, 260, 100),
                                       (1, 64, 8)])
def test_launch_plan_rows_and_split(bm, tiles, k, n):
    """Rows follow bm; a few-tile bf16 call splits K into pieces of whole
    slices, at least MIN_SPLIT_K deep, that cover K once; fp32 never
    splits."""
    m = tiles * bm
    plan = tg.launch_plan(m, k, n, bm)
    rows = 16 if bm <= 16 else 64
    assert plan.rows == rows
    assert plan.row_blocks == tiles * -(-bm // rows)
    assert plan.col_blocks == -(-n // tg.BLOCK_N)
    blocks = plan.row_blocks * plan.col_blocks
    assert plan.k_len % tg.SLICE_K == 0
    assert (plan.splits - 1) * plan.k_len < k <= plan.splits * plan.k_len
    if plan.splits > 1:
        assert blocks < tg.TARGET_BLOCKS
        assert plan.k_len >= tg.MIN_SPLIT_K
    elif blocks < tg.TARGET_BLOCKS:
        assert k < 2 * tg.MIN_SPLIT_K          # too shallow to split
    fp32 = tg.launch_plan(m, k, n, bm, torch.float32)
    assert fp32.splits == 1 and fp32.rows == rows


def test_launch_plan_splits_a_few_tile_call():
    plan = tg.launch_plan(tg.tile_bound(16, 2, 16) * 16, 1024, 512, 16)
    assert plan.grid == (3, 8, 4) and plan.k_len == 256
    plan = tg.launch_plan(tg.tile_bound(110, 2, 64) * 64, 1024, 512, 64)
    assert plan.grid == (4, 8, 4) and plan.k_len == 256


@pytest.mark.parametrize("bm", [16, 64])
def test_k_split_partials_sum_to_the_plain_version(bm):
    """The kernel's K split emulated on the CPU: each split's fp32 partial
    plane over its k range, summed in split order, then rounded once,
    equals ``gmm_plain`` (fp32 to 1e-4, bf16 within one bf16 ulp)."""
    sizes = [9, 7] if bm == 16 else [40, 70]
    rng = np.random.default_rng(11)
    k, n = 1024, 64
    x = rng.standard_normal((sum(sizes), k)).astype(np.float32)
    w = rng.standard_normal((len(sizes), k, n)).astype(np.float32)
    gids, scatter = tg.pad_groups_device(torch.tensor(sizes), bm, sum(sizes))
    xp = torch.zeros((gids.numel() * bm, k))
    xp[scatter.long()] = torch.as_tensor(x)
    xb = xp.to(torch.bfloat16)
    wb = torch.as_tensor(w).to(torch.bfloat16)
    plan = tg.launch_plan(xb.shape[0], k, n, bm)
    assert plan.splits > 1
    planes = []
    for z in range(plan.splits):
        lo, hi = z * plan.k_len, min(k, (z + 1) * plan.k_len)
        planes.append(tg.gmm_plain(xb[:, lo:hi].contiguous(),
                                   wb[:, lo:hi].contiguous(), gids, bm=bm,
                                   bk=hi - lo, bn=n, out_dtype=torch.float32))
    total = planes[0]
    for p in planes[1:]:
        total = total + p
    want = tg.gmm_plain(xb, wb, gids, bm=bm, bk=k, bn=n,
                        out_dtype=torch.float32)
    torch.testing.assert_close(total, want, rtol=1e-4, atol=1e-4)
    wantb = tg.gmm_plain(xb, wb, gids, bm=bm, bk=k, bn=n)
    torch.testing.assert_close(total.to(torch.bfloat16).float(),
                               wantb.float(), rtol=2 ** -7, atol=1e-4)


# -- K3's gradient: GroupedMatmul and K3w's plain version ---------------------


def test_grouped_matmul_gradcheck_fp64():
    """The Function's backward (K3 on w^T for dx, K3w for dw) against
    finite differences, in fp64 through its CPU path, with an empty group
    and an idle tile."""
    rng = np.random.default_rng(3)
    sizes = torch.tensor([3, 0, 6, 1])
    bm, k, n = 4, 5, 3
    gids, scatter = tg.pad_groups_device(sizes, bm, int(sizes.sum()))
    assert (gids == tg.IDLE).any()
    xp = torch.zeros((gids.numel() * bm, k), dtype=torch.float64)
    xp[scatter.long()] = torch.as_tensor(
        rng.standard_normal((int(sizes.sum()), k)))
    w = torch.as_tensor(rng.standard_normal((4, k, n)))
    xp.requires_grad_(True)
    w.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, b: tg.gmm(a, b, gids, bm=bm, bk=k, bn=n), (xp, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_grads_match_autograd_of_plain(dtype):
    """dx and dw from the Function against autograd through ``gmm_plain``
    on the same inputs: fp32 to 1e-5, bf16 within one bf16 ulp."""
    sizes = [5, 0, 12, 3]
    bm, k, n = 4, 16, 24
    _, w, xp, gids, _ = _padded_case(sizes, bm, k=k, n=n)
    rng = np.random.default_rng(5)
    dy = torch.as_tensor(rng.standard_normal((xp.shape[0], n)),
                         dtype=torch.float32).to(dtype)
    gids = torch.as_tensor(gids)
    grads = []
    for fn in (tg.gmm, tg.gmm_plain):
        x = torch.as_tensor(xp).to(dtype).requires_grad_(True)
        ww = torch.as_tensor(w).to(dtype).requires_grad_(True)
        out = fn(x, ww, gids, bm=bm, bk=k, bn=n)
        out.backward(dy)
        grads.append((x.grad, ww.grad))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 \
        else dict(rtol=2 ** -7, atol=1e-4)
    for got, want in zip(*grads):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("bm", [4, 8])
@pytest.mark.parametrize("sizes", [[8, 16, 0, 24], [0, 0, 8], [3, 0, 17, 1]],
                         ids=["mixed", "leading-empty", "ragged"])
def test_wgrad_plain_matches_jax_grad_of_ragged_dot(sizes, bm):
    """``gmm_wgrad_plain`` on the device padding (idle tiles after the real
    ones) against ``jax.grad`` of ``ragged_dot`` on the same sorted rows;
    a group with no rows gets a zero gradient."""
    import jax

    rng = np.random.default_rng(9)
    k, n = 12, 10
    rows = sum(sizes)
    x = rng.standard_normal((rows, k)).astype(np.float32)
    w = rng.standard_normal((len(sizes), k, n)).astype(np.float32)
    dy = rng.standard_normal((rows, n)).astype(np.float32)
    gs = jnp.asarray(sizes, jnp.int32)
    want = np.asarray(jax.grad(lambda ww: jnp.sum(
        jax.lax.ragged_dot(jnp.asarray(x), ww, gs) * dy))(jnp.asarray(w)))
    gids, scatter = tg.pad_groups_device(torch.tensor(sizes), bm, rows)
    assert (gids == tg.IDLE).any()
    xp = torch.zeros((gids.numel() * bm, k))
    dyp = torch.zeros((gids.numel() * bm, n))
    xp[scatter.long()] = torch.as_tensor(x)
    dyp[scatter.long()] = torch.as_tensor(dy)
    got = tg.gmm_wgrad(xp, dyp, gids, len(sizes), bm=bm)
    assert got.shape == (len(sizes), k, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for g, s in enumerate(sizes):
        if s == 0:
            assert not got[g].any()


def test_wgrad_rejects_shapes_outside_the_contract():
    x, dy = torch.zeros(16, 8), torch.zeros(16, 4)
    gids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        tg.gmm_wgrad(x, dy[:8], gids, 2, bm=8)
    with pytest.raises(ValueError):
        tg.gmm_wgrad(x, dy, gids, 2, bm=4)
    with pytest.raises(ValueError):
        tg.gmm_wgrad(x, dy, gids, 0, bm=8)


# -- K3w's launch plan ---------------------------------------------------------

#: granite-moe-1b-a400m's training calls: 4,096 tokens x top-8 over 32
#: experts, padded to 16-row tiles (tile_bound(32768, 32, 16) tiles)
GRANITE_ROWS = tg.tile_bound(4096 * 8, 32, 16) * 16


@pytest.mark.parametrize("k,n", [(1024, 512), (512, 1024)])
def test_wgrad_plan_takes_tma_at_granite_training_shapes(k, n):
    plan = tg.wgrad_plan(GRANITE_ROWS, k, n, 32, 16)
    assert plan.variant == "tma" and plan.tile == (128, 256)
    assert plan.grid == (k // 128 * (n // 256), 32)


#: chip_smoke.py phase 16(a)'s sweep at K = 256, N = 200: (sizes, bm)
SWEEP_SHAPES = [
    ([16, 32, 0, 48], 16), ([0, 0, 16], 16), ([64], 16), ([11, 0, 33, 1], 16),
    ([64, 128, 0, 192], 64), ([0, 0, 64], 64), ([256], 64),
    ([35, 0, 129, 1], 64),
    ([128, 256, 0, 384], 128), ([0, 0, 128], 128), ([512], 128),
    ([67, 0, 257, 1], 128)]


@pytest.mark.parametrize("sizes,bm", SWEEP_SHAPES)
def test_wgrad_plan_at_the_sweep_shapes(sizes, bm):
    m = tg.tile_bound(sum(sizes), len(sizes), bm) * bm
    plan = tg.wgrad_plan(m, 256, 200, len(sizes), bm)
    assert plan == ("tma", (128, 256), (2, len(sizes)))
    # the same call with a base off 16 bytes takes the general kernel
    general = tg.wgrad_plan(m, 256, 200, len(sizes), bm, aligned=False)
    assert general == ("mma", (64, 64), (4 * 4, len(sizes)))


@pytest.mark.parametrize("m,k,n,bm,dtype,variant", [
    (448, 260, 100, 16, torch.bfloat16, "mma"),   # the sweep's K = 260
    (448, 256, 100, 16, torch.bfloat16, "mma"),   # N not a multiple of 8
    (448, 256, 200, 8, torch.bfloat16, "mma"),    # bm not a multiple of 16
    (0, 256, 200, 16, torch.bfloat16, "mma"),     # no rows to read
    (448, 256, 200, 16, torch.float32, "fma")])
def test_wgrad_plan_takes_the_general_kernels(m, k, n, bm, dtype, variant):
    plan = tg.wgrad_plan(m, k, n, 4, bm, dtype)
    assert plan.variant == variant and plan.tile == (64, 64)
    assert plan.grid == (-(-k // 64) * -(-n // 64), 4)


def test_moe_sort_grads_match_jax():
    """The port's ``_moe_sort`` (K3 forward and backward, CPU path) against
    JAX's (``ragged_dot``) on the same params and input, in fp32: the grads
    of x, the router and the three expert weights, each within 1e-5 of its
    largest magnitude."""
    import dataclasses

    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models import moe as jmoe

    from repro_torch.configs import get_config
    from repro_torch.models import moe as tmoe

    jcfg = jax_get_config("granite-moe-1b-a400m", smoke=True)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, strategy="sort"))
    cfg = get_config("granite-moe-1b-a400m", smoke=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, strategy="sort"))
    rng = np.random.default_rng(17)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    p = {"router": {"w": rng.standard_normal((d, e)) / np.sqrt(d)},
         "w_gate": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_up": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
    x = rng.standard_normal((24, d)).astype(np.float32)
    dy = rng.standard_normal((24, d)).astype(np.float32)

    def jloss(pp, xx):
        return jnp.sum(jmoe._moe_sort(pp, jcfg, xx) * dy)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), p)
    tx = torch.tensor(x, requires_grad=True)
    (tmoe._moe_sort(tp, cfg, tx) * torch.as_tensor(dy)).sum().backward()
    pairs = [(tx.grad, jg_x)] + [
        (a.grad, b) for a, b in zip(jax.tree.leaves(tp),
                                    jax.tree.leaves(jg_p))]
    for got, want in pairs:
        want = np.asarray(want)
        assert got is not None and got.shape == want.shape
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got.numpy() - want).max() / scale < 1e-5


# -- K3 and K3w as torch operators ----------------------------------------


def _op_case(bm=8, sizes=(8, 16, 0, 24), k=16, n=24):
    _, w, xp, gids, _ = _padded_case(list(sizes), bm, k=k, n=n)
    return (torch.as_tensor(xp), torch.as_tensor(w),
            torch.as_tensor(gids.astype(np.int32)))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_gmm_op_fake_allocates_the_output(out_dtype):
    """On meta tensors both operators only allocate the output: K3's (M, N)
    and K3w's (G, K, N), in the dtype asked for."""
    x, w, gids = _op_case()
    meta = [t.to("meta") for t in (x, w, gids)]
    out = torch.ops.repro_torch.gmm(*meta, 8, 8, 8, out_dtype)
    assert out.device.type == "meta" and out.dtype == out_dtype
    assert tuple(out.shape) == (x.shape[0], w.shape[2])
    dy = torch.empty((x.shape[0], w.shape[2]), device="meta")
    dw = torch.ops.repro_torch.gmm_wgrad(meta[0], dy, meta[2], w.shape[0], 8,
                                         out_dtype)
    assert tuple(dw.shape) == tuple(w.shape) and dw.dtype == out_dtype
    # the operators' own shape checks run on meta tensors too
    with pytest.raises(ValueError):
        torch.ops.repro_torch.gmm(meta[0][:-8], meta[1], meta[2], 8, 8, 8,
                                  out_dtype)


def test_gmm_op_flop_formula_counts_padded_rows():
    """``2 M K N`` over the padded rows, idle tiles included, for K3 (and
    for the backward's dx, K3 on w^T) and K3w, as FlopCounterMode sees
    them through ``GroupedMatmul``."""
    from torch.utils.flop_counter import FlopCounterMode

    x, w, gids = _op_case()
    gids[-1] = tg.IDLE                        # an idle tile still counts
    (m, k), n = x.shape, w.shape[2]
    x.requires_grad_(True)
    w.requires_grad_(True)
    with FlopCounterMode(display=False) as fc:
        out = tg.gmm(x, w, gids, bm=8, bk=8, bn=8)
        out.sum().backward()
    counts = {str(op): c for op, c in fc.get_flop_counts()["Global"].items()}
    assert counts["repro_torch.gmm"] == 2 * (2 * m * k * n)      # fwd + dx
    assert counts["repro_torch.gmm_wgrad"] == 2 * m * k * n
    with FlopCounterMode(display=False) as fc:
        torch.ops.repro_torch.gmm(x.detach().to("meta"), w.detach().to("meta"),
                                  gids.to("meta"), 8, 8, 8, torch.float32)
    assert fc.get_total_flops() == 2 * m * k * n


def test_gmm_ops_keep_the_plain_results_on_the_cpu():
    """Through the operators the CPU runs exactly the plain versions."""
    x, w, gids = _op_case()
    got = torch.ops.repro_torch.gmm(x, w, gids, 8, 8, 8, torch.float32)
    want = tg.gmm_plain(x, w, gids, bm=8, bk=8, bn=8)
    assert torch.equal(got, want)
    assert torch.equal(tg.gmm(x, w, gids, bm=8, bk=8, bn=8), want)
    dy = torch.randn((x.shape[0], w.shape[2]),
                     generator=torch.Generator().manual_seed(3))
    got = torch.ops.repro_torch.gmm_wgrad(x, dy, gids, w.shape[0], 8,
                                          torch.float32)
    assert torch.equal(got, tg.gmm_wgrad_plain(x, dy, gids, w.shape[0], bm=8))
    assert torch.equal(tg.gmm_wgrad(x, dy, gids, w.shape[0], bm=8), got)
