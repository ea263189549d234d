"""Mamba (S6) block: selective state-space mixer for the jamba hybrid.

The port of ``repro.models.mamba``, in plain PyTorch as the JAX module is
plain JAX (no TPU kernel lies here).  The diagonal-A recurrence
``h_t = exp(Δ_t A) h_{t-1} + Δ_t B_t x_t`` is linear, so its (decay,
increment) pairs compose associatively.  The training/prefill path walks
the sequence in chunks of 256 (JAX's production chunk) with a Python loop
in place of ``lax.scan``, and scans inside each chunk with a log₂(L)-step
doubling (Hillis-Steele) scan over the same combine as JAX's
``associative_scan``.  Only per-chunk ``(B, L, d_inner, d_state)`` tensors
exist; the output ``y_t = C_t · h_t`` is contracted inside the loop.

A short last chunk is scanned at its own length: JAX pads it with
``dt = 0`` (decay 1, increment 0), which leaves the real positions and the
final carry exactly as they are.  Decode is the O(1) single-step update
over the carried (conv, ssm) state.  ``repro.models.scan_config`` (an XLA
cost-probe switch) has no counterpart.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..sharding.act import shard
from .layers import dense, dense_init, normal

__all__ = ["mamba_init", "mamba_apply", "mamba_decode", "MambaCache",
           "init_mamba_cache"]

#: sequence chunk of the selective scan (JAX's production chunk)
CHUNK = 256


class MambaCache(NamedTuple):
    conv: torch.Tensor    # (B, d_conv - 1, d_inner) trailing inputs
    ssm: torch.Tensor     # (B, d_inner, d_state)


def _dims(cfg):
    d_inner = cfg.mamba_expand * cfg.d_model
    dt_rank = max(1, math.ceil(cfg.d_model / 16))
    return d_inner, dt_rank, cfg.mamba_d_state, cfg.mamba_d_conv


def mamba_init(gen: torch.Generator, cfg, dtype=torch.float32):
    d = cfg.d_model
    d_inner, dt_rank, d_state, d_conv = _dims(cfg)
    dev = gen.device
    a = torch.arange(1, d_state + 1, dtype=torch.float32,
                     device=dev).repeat(d_inner, 1)
    return {
        "in_proj": dense_init(gen, d, 2 * d_inner, dtype=dtype),
        "conv_w": normal(gen, (d_conv, d_inner), 0.1, dtype),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, d_inner, dt_rank + 2 * d_state,
                             dtype=dtype),
        "dt_proj": dense_init(gen, dt_rank, d_inner, bias=True, dtype=dtype),
        "a_log": torch.log(a).to(dtype),
        "d_skip": torch.ones((d_inner,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, d_inner, d, dtype=dtype),
    }


def _causal_conv(x, w, b, init_state=None):
    """Depthwise causal conv1d.  x: (B, S, dI); w: (d_conv, dI).

    Returns the output and the last ``d_conv - 1`` inputs (the conv state).
    """
    d_conv = w.shape[0]
    if init_state is None:
        pad = torch.zeros((x.shape[0], d_conv - 1, x.shape[2]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = init_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i: i + x.shape[1], :] * w[i].to(x.dtype)
              for i in range(d_conv))
    return out + b.to(x.dtype), xp[:, -(d_conv - 1):, :]


def _ssm_params(p, cfg, x_conv):
    """x_conv: (B, S, dI) -> dt (B,S,dI), B/C (B,S,dS) and A (dI,dS), fp32."""
    _, dt_rank, d_state, _ = _dims(cfg)
    proj = dense(p["x_proj"], x_conv, compute_dtype=torch.float32)
    dt, b_ssm, c_ssm = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus(dense(p["dt_proj"], dt, compute_dtype=torch.float32))
    a = -torch.exp(p["a_log"].float())
    return dt, b_ssm, c_ssm, a


def _scan_chunk(h0, decay, inc):
    """Scan of h_t = decay_t * h_{t-1} + inc_t within one chunk.

    decay/inc: (B, L, dI, dS); h0: (B, dI, dS).  A doubling scan: at step
    ``s`` each position combines with the one ``s`` before it through
    JAX's ``comb(a, b) = (a0 * b0, a1 * b0 + b1)`` (``a`` the earlier).
    Returns per-step h and the final carry.
    """
    d_acc, i_acc = decay, inc
    shift, length = 1, decay.shape[1]
    while shift < length:
        d_cur, i_cur = d_acc[:, shift:], i_acc[:, shift:]
        i_acc = torch.cat([i_acc[:, :shift],
                           i_acc[:, :-shift] * d_cur + i_cur], dim=1)
        d_acc = torch.cat([d_acc[:, :shift], d_acc[:, :-shift] * d_cur],
                          dim=1)
        shift *= 2
    h = d_acc * h0[:, None] + i_acc
    return h, h[:, -1]


def _selective_scan_chunked(p, cfg, x_conv, *, chunk: int = CHUNK,
                            h0: Optional[torch.Tensor] = None):
    """Chunked selective scan; decay and increment are built per chunk and
    ``C · h`` is contracted per chunk.

    Returns (y: (B, S, dI) fp32, h_final: (B, dI, dS) fp32).
    """
    b, s, d_inner = x_conv.shape
    dt, b_ssm, c_ssm, a = _ssm_params(p, cfg, x_conv)
    dt = shard(dt, "dp", None, "model")
    xf = x_conv.float()
    chunk = min(chunk, s)
    h = (torch.zeros((b, d_inner, cfg.mamba_d_state), dtype=torch.float32,
                     device=x_conv.device) if h0 is None else h0.float())
    ys = []
    for start in range(0, s, chunk):
        sl = slice(start, start + chunk)
        dtc, bc, cc, xc = dt[:, sl], b_ssm[:, sl], c_ssm[:, sl], xf[:, sl]
        decay = torch.exp(dtc[..., None] * a[None, None])     # (B,L,dI,dS)
        inc = (dtc * xc)[..., None] * bc[:, :, None, :]
        decay = shard(decay, "dp", None, "model", None)
        inc = shard(inc, "dp", None, "model", None)
        hs, h = _scan_chunk(h, decay, inc)
        ys.append(shard(torch.einsum("blds,bls->bld", hs, cc),
                        "dp", None, "model"))
    y = torch.cat(ys, dim=1)
    y = y + xf * p["d_skip"].float()
    return y, h


def _mamba_forward(p, cfg, x, chunk: int = CHUNK):
    """The whole-sequence pass: (output, conv state, final ssm state)."""
    xz = dense(p["in_proj"], x)
    x_in, z = torch.chunk(xz, 2, dim=-1)
    x_in = shard(x_in, "dp", None, "model")
    z = shard(z, "dp", None, "model")
    x_conv, conv_state = _causal_conv(x_in, p["conv_w"], p["conv_b"])
    x_conv = F.silu(x_conv)
    y, h = _selective_scan_chunked(p, cfg, x_conv, chunk=chunk)
    y = y.to(x.dtype) * F.silu(z)
    return dense(p["out_proj"], y), conv_state, h


def mamba_apply(p, cfg, x, *, chunk: int = CHUNK) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    return _mamba_forward(p, cfg, x, chunk)[0]


def init_mamba_cache(cfg, batch: int, dtype=torch.float32,
                     device=None) -> MambaCache:
    d_inner, _, d_state, d_conv = _dims(cfg)
    return MambaCache(
        conv=torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, d_inner, d_state), dtype=dtype,
                        device=device),
    )


def mamba_decode(p, cfg, x, cache: MambaCache
                 ) -> Tuple[torch.Tensor, MambaCache]:
    """Single-token step.  x: (B, 1, D).  Returns the output and the new
    state (conv state in ``x``'s dtype, ssm state fp32), as JAX does."""
    xz = dense(p["in_proj"], x)
    x_in, z = torch.chunk(xz, 2, dim=-1)
    x_conv, conv_state = _causal_conv(x_in, p["conv_w"], p["conv_b"],
                                      init_state=cache.conv)
    x_conv = F.silu(x_conv)
    dt, b_ssm, c_ssm, a = _ssm_params(p, cfg, x_conv)
    xf = x_conv.float()
    decay = torch.exp(dt[:, 0, :, None] * a[None])                # (B,dI,dS)
    inc = (dt[:, 0] * xf[:, 0])[..., None] * b_ssm[:, 0, None, :]
    h = decay * cache.ssm.float() + inc
    y = torch.einsum("bdn,bn->bd", h, c_ssm[:, 0])[:, None, :]
    y = y + xf * p["d_skip"].float()
    y = y.to(x.dtype) * F.silu(z)
    return dense(p["out_proj"], y), MambaCache(conv=conv_state, ssm=h)
