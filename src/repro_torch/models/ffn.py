"""Feed-forward helpers for the block-sparse FFN.

Only the block-mask expansion is ported so far; the dense SwiGLU layers
come with the model zoo (ROADMAP queue 1, item 7).
"""
from __future__ import annotations

import torch

__all__ = ["_masked_weight"]


def _masked_weight(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``w`` with every block whose ``mask`` entry is 0 zeroed.

    Block sizes are inferred from the mask's shape, as in the JAX package.
    """
    gd, gf = mask.shape
    bm = -(-w.shape[0] // gd)
    bn = -(-w.shape[1] // gf)
    full = mask.repeat_interleave(bm, 0).repeat_interleave(bn, 1)
    return w * full[: w.shape[0], : w.shape[1]].to(w.dtype)
