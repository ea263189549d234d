"""Gradient compression with error feedback (distributed-optimization trick).

The port of ``repro.train.compression``: row-wise int8 quantization of
gradients along the last axis, with an error-feedback residual so the
quantization error is re-injected on the next step (1-bit-Adam / EF-SGD
lineage).  The quantize→dequantize pair models the wire format of a
compressed all-reduce.  Plain torch, no kernel: it is an elementwise pass
that the JAX package leaves to XLA.  Rows run along the last axis, so the
port's per-layer leaves quantize exactly as JAX's stacked ones do.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..checkpoint.checkpointer import tree_flatten, tree_map, tree_unflatten

__all__ = ["init_error_feedback", "compress_decompress"]


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quant_dequant(g: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 quantization along the last axis."""
    g32 = g.float()
    scale = torch.amax(torch.abs(g32), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q.float() * scale


@torch.no_grad()
def compress_decompress(grads, ef) -> Tuple[Any, Any]:
    """Returns (dequantized grads, new error-feedback residuals)."""

    def one(g, e):
        g32 = g.float() + e
        gq = _quant_dequant(g32)
        return gq, g32 - gq

    out = [one(g, e) for g, e in zip(tree_flatten(grads), tree_flatten(ef))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))
