"""Fused attention for the card (``csrc/attention.cu``).

- :func:`route` — where
  :func:`repro_torch.models.attention.blockwise_attention` sends a call,
  from the inputs' device, dtypes and shapes alone: a tensor off the card,
  or an fp32/fp64 one, runs the plain loop; a bf16 CUDA call whose head
  dim is a multiple of 16 up to 128 runs the kernel; any other
  half-precision CUDA call raises.  No exception hands a CUDA call to the
  plain loop.
- :func:`fused_attention` — the kernel's forward, differentiable through
  :class:`FusedAttention`, whose backward launches the backward kernels
  inside the span ``block.attn``.  ``fused_attention.forward_calls`` and
  ``.backward_calls`` count the calls that launched, ``.launches`` the
  kernels they launched (one a forward, three a backward).
- :func:`visible` — the plain loop's mask, for counting the work.

The TPU package has no attention kernel: ``repro.models.attention`` is
plain JAX.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import obs
from . import build

__all__ = ["FusedAttention", "HEAD_DIMS", "check_rows_see_keys",
           "fused_attention", "route", "visible"]

#: head dims the kernel takes: multiples of 16 up to 128 (instances 16, 32,
#: 64, 128; a head dim between runs zero-padded in shared memory)
HEAD_DIMS = tuple(range(16, 129, 16))
#: query rows and keys of a kernel tile (``csrc/attention.cu``)
TILE = 64
_HALF = (torch.bfloat16, torch.float16)
#: CUDA's limit on a grid's y extent (query or key tiles)
_MAX_GRID_Y = 65535


def route(device_type: str, dtypes, q_shape, kv_shape) -> str:
    """``"kernel"`` or ``"plain"`` for one attention call, or raise.

    ``dtypes``: those of q, k and v; ``q_shape`` (B, Sq, Hq, Dh),
    ``kv_shape`` (B, Sk, Hkv, Dh).  Off the card (the CPU, meta tensors),
    and for fp32/fp64 inputs on it, the plain loop.  On the card a call
    with any bf16 or fp16 input runs the kernel if all three are bf16 and
    the head dim is in :data:`HEAD_DIMS`, else raises ``ValueError``.
    """
    if device_type != "cuda" or not any(d in _HALF for d in dtypes):
        return "plain"
    if any(d != torch.bfloat16 for d in dtypes):
        raise ValueError(f"attention on the card: the kernel takes bf16 q, "
                         f"k and v, got {tuple(dtypes)}")
    if len(q_shape) != 4 or len(kv_shape) != 4:
        raise ValueError(f"attention: want q (B, Sq, Hq, Dh) and k, v "
                         f"(B, Sk, Hkv, Dh), got {tuple(q_shape)}, "
                         f"{tuple(kv_shape)}")
    (b, _sq, hq, dh), (bk, _sk, hkv, dhk) = q_shape, kv_shape
    if b != bk or dh != dhk or hkv <= 0 or hq % hkv:
        raise ValueError(f"attention: q {tuple(q_shape)} and k, v "
                         f"{tuple(kv_shape)} disagree (batch, head dim, or "
                         "query heads not a multiple of kv heads)")
    if dh not in HEAD_DIMS:
        raise ValueError(f"attention on the card: the kernel takes head "
                         f"dims {HEAD_DIMS}, got {dh}")
    return "kernel"


def check_rows_see_keys(sq: int, sk: int, causal: bool,
                        window: Optional[int], q_offset: int) -> None:
    """Raise unless every query row sees at least one key.

    Row i sits at key position ``q_offset + i`` and sees the keys
    ``[lo, hi]``, lo = max(0, pos - window + 1) with a window, hi =
    min(pos, Sk - 1) if causal (else Sk - 1).  lo - hi falls, then rises,
    with the position, so the first and the last rows decide.  The plain
    loop would give such a row the mean of V; the kernel does not."""
    for i in {0, sq - 1} if sq > 0 else ():
        pos = q_offset + i
        lo = 0 if window is None else max(0, pos - window + 1)
        hi = min(pos, sk - 1) if causal else sk - 1
        if lo > hi:
            raise ValueError(
                f"attention: query row {i} (position {pos}) sees no key of "
                f"{sk} (causal={causal}, window={window}, "
                f"q_offset={q_offset})")


def visible(sq: int, sk: int, causal: bool, window: Optional[int],
            q_offset: int, device=None) -> torch.Tensor:
    """(Sq, Sk) bool: does query row i see key j (the plain loop's mask)?"""
    qp = q_offset + torch.arange(sq, device=device)[:, None]
    kp = torch.arange(sk, device=device)[None, :]
    seen = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        seen = seen & (qp >= kp)
    if window is not None:
        seen = seen & (qp - window < kp)
    return seen


# -- the kernels --------------------------------------------------------------


class _Params(ctypes.Structure):
    """``AttnParams`` of ``csrc/attention.cu``, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("q", "k", "v", "dout")]
                + [(n, ctypes.c_longlong) for n in (
                    "q_b", "q_s", "q_h", "k_b", "k_s", "k_h", "v_b", "v_s",
                    "v_h", "do_b", "do_s", "do_h", "window", "q_offset")]
                + [(n, ctypes.c_int) for n in (
                    "B", "Sq", "Sk", "Hq", "Hkv", "D", "causal",
                    "has_window")]
                + [("scale", ctypes.c_float)]
                + [(n, ctypes.c_void_p) for n in (
                    "o", "o32", "lse", "delta", "dq", "dk", "dv")])


def _lib() -> ctypes.CDLL:
    lib = build.library("attention")
    if not getattr(lib, "_bound", False):
        for fn in (lib.flexagon_attn_fwd, lib.flexagon_attn_bwd):
            fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.flexagon_attn_error_string.argtypes = [ctypes.c_int]
        lib.flexagon_attn_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def _readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernel can read it through its strides (head dim
    contiguous, 16-byte aligned rows and base), else a contiguous copy."""
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in t.stride()[:-1])):
        return t
    return torch.empty(t.shape, dtype=t.dtype,
                       device=t.device).copy_(t)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _params(q, k, v, causal, window, q_offset, scale, **bufs) -> _Params:
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    do = bufs.pop("dout", None)
    do_strides = do.stride()[:3] if do is not None else (0, 0, 0)
    return _Params(
        q=_ptr(q), k=_ptr(k), v=_ptr(v), dout=_ptr(do),
        q_b=q.stride(0), q_s=q.stride(1), q_h=q.stride(2),
        k_b=k.stride(0), k_s=k.stride(1), k_h=k.stride(2),
        v_b=v.stride(0), v_s=v.stride(1), v_h=v.stride(2),
        do_b=do_strides[0], do_s=do_strides[1], do_h=do_strides[2],
        window=0 if window is None else window, q_offset=q_offset,
        B=b, Sq=sq, Sk=sk, Hq=hq, Hkv=hkv, D=dh, causal=int(causal),
        has_window=int(window is not None), scale=scale,
        **{n: _ptr(t) for n, t in bufs.items()})


def _launch(entry: str, params: _Params, device, kernels: int) -> None:
    """Launch ``entry``, which launches ``kernels`` kernels, on the current
    stream; raise on its CUDA error."""
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, entry)(ctypes.byref(params), ctypes.c_void_p(stream))
    if err:
        msg = lib.flexagon_attn_error_string(err).decode()
        raise RuntimeError(f"attention: {entry} launch failed: CUDA error "
                           f"{err} ({msg})")
    fused_attention.launches += kernels


def _check(q, k, v, causal, window, q_offset):
    if route(q.device.type, (q.dtype, k.dtype, v.dtype), q.shape,
             k.shape) != "kernel" or v.shape != k.shape:
        raise ValueError(f"attention: the kernel does not take q "
                         f"{tuple(q.shape)} {q.dtype} on {q.device}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"attention: q, k and v on {q.device}, {k.device}, "
                         f"{v.device}; want one device")
    b, sq, hq, _ = q.shape
    sk = k.shape[1]
    if b * hq >= 2 ** 31 or -(-max(sq, sk) // TILE) > _MAX_GRID_Y:
        raise ValueError(f"attention: B x Hq = {b * hq}, Sq = {sq}, Sk = "
                         f"{sk} exceed the kernel's grid")
    check_rows_see_keys(sq, sk, causal, window, q_offset)


def _forward(q, k, v, causal, window, q_offset, scale, keep: bool):
    """One launch of the forward kernel: ``(o, o32, lse)``, the last two
    None unless ``keep``."""
    b, sq, hq, dh = q.shape
    o = torch.empty((b, sq, hq, dh), dtype=q.dtype, device=q.device)
    o32 = lse = None
    if keep:
        o32 = torch.empty(o.shape, dtype=torch.float32, device=q.device)
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if o.numel():
        _launch("flexagon_attn_fwd",
                _params(q, k, v, causal, window, q_offset, scale, o=o,
                        o32=o32, lse=lse), q.device, 1)
        fused_attention.forward_calls += 1
    return o, o32, lse


def _backward(q, k, v, o32, lse, do, causal, window, q_offset, scale):
    """One launch of the backward kernels: ``(dq, dk, dv)``."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if q.numel():
        delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
        _launch("flexagon_attn_bwd",
                _params(q, k, v, causal, window, q_offset, scale, dout=do,
                        o32=o32, lse=lse, delta=delta, dq=dq, dk=dk, dv=dv),
                q.device, 3)        # D, then dK and dV, then dQ
        fused_attention.backward_calls += 1
    else:
        dk.zero_()
        dv.zero_()
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """The kernel's attention with its gradient.

    The forward keeps O in fp32 and the row log-sum-exp where any input
    wants a gradient; the backward recomputes P from them and launches
    the three backward kernels, inside the span ``block.attn``, so the
    device time of the layer's backward is the layer's in the trace."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale):
        keep = any(ctx.needs_input_grad[:3])
        o, o32, lse = _forward(q, k, v, causal, window, q_offset, scale,
                               keep)
        if keep:
            ctx.save_for_backward(q, k, v, o32, lse)
            ctx.args = (causal, window, q_offset, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o32, lse = ctx.saved_tensors
        with obs.span("block.attn"):
            dq, dk, dv = _backward(q, k, v, o32, lse,
                                   _readable(do.to(q.dtype)), *ctx.args)
        return dq, dk, dv, None, None, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention on the card's kernel: q (B, Sq, Hq, Dh), k and v (B, Sk,
    Hkv, Dh), all bf16 on one CUDA device, Dh in :data:`HEAD_DIMS`, Hq a
    multiple of Hkv (query head h reads kv head h // (Hq / Hkv)).  Masks,
    ``q_offset`` and ``scale`` (None: 1/sqrt(Dh)) as the plain loop's.
    Raises on anything else, and where a query row would see no key.
    Differentiable in q, k and v (:class:`FusedAttention`)."""
    _check(q, k, v, causal, window, q_offset)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    window = None if window is None else int(window)
    q, k, v = _readable(q), _readable(k), _readable(v)
    return FusedAttention.apply(q, k, v, bool(causal), window,
                                int(q_offset), scale)


fused_attention.forward_calls = 0
fused_attention.backward_calls = 0
fused_attention.launches = 0
