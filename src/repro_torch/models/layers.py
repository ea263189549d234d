"""Model primitives: params are plain nested dicts of tensors; each primitive
has an ``init`` and a pure apply function, as in ``repro.models.layers``.

Init functions draw from a ``torch.Generator`` (the port's stand-in for a
JAX key); they give other numbers than JAX from the same seed, so tests
carry JAX parameters over with :func:`repro_torch.convert.lm_params_from_jax`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["dense_init", "dense", "rmsnorm_init", "rmsnorm", "embed_init",
           "embedding_lookup", "rope", "apply_rope", "normal"]


def normal(gen: torch.Generator, shape, scale: float, dtype=torch.float32
           ) -> torch.Tensor:
    """``scale`` x standard normal of ``shape`` on ``gen``'s device, drawn
    in fp32 and stored as ``dtype``."""
    out = torch.randn(shape, generator=gen, device=gen.device,
                      dtype=torch.float32)
    return (out * scale).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, scale: Optional[float] = None,
               dtype=torch.float32):
    scale = 1.0 / math.sqrt(d_in) if scale is None else scale
    p = {"w": normal(gen, (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense(p, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ w (+ b)`` with both operands in ``compute_dtype``."""
    y = torch.matmul(x.to(compute_dtype), p["w"].to(compute_dtype))
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32):
    return {"table": normal(gen, (vocab, d), 0.02, dtype)}


def embedding_lookup(p, ids: torch.Tensor, compute_dtype=torch.bfloat16
                     ) -> torch.Tensor:
    # gather, then cast: the same values as casting the table first,
    # without a full-table copy per call
    return p["table"][ids].to(compute_dtype)


def rope(positions: torch.Tensor, d_head: int, theta: float = 1e4):
    """Rotary position embedding angles.  positions: (..., S) integer."""
    half = d_head // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs          # (..., S, half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, Dh); cos/sin: (S, Dh/2) or (B, S, Dh/2)."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:                     # (S, half)
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:                                  # (B, S, half)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)
