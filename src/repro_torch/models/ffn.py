"""Feed-forward layers: SwiGLU (dense) and the block-mask expansion of the
block-sparse FFN, as in ``repro.models.ffn``.

A weight with a ``block_mask`` is applied here as the masked dense product;
the planned sparse path is :mod:`repro_torch.models.sparse_linear`.
"""
from __future__ import annotations

import torch

from ..sharding.act import shard
from .layers import dense, dense_init

__all__ = ["ffn_init", "ffn_apply", "_masked_weight"]


def ffn_init(gen: torch.Generator, cfg, dtype=torch.float32):
    d, f = cfg.d_model, cfg.d_ff
    p = {
        "w_gate": dense_init(gen, d, f, dtype=dtype),
        "w_up": dense_init(gen, d, f, dtype=dtype),
        "w_down": dense_init(gen, f, d, dtype=dtype),
    }
    if cfg.ffn_block_sparsity > 0:
        # block occupancy masks (128-aligned pruning structure)
        bm = 128
        gd, gf = max(1, d // bm), max(1, f // bm)
        keep = 1.0 - cfg.ffn_block_sparsity
        p["block_mask"] = (torch.rand((gd, gf), generator=gen,
                                      device=gen.device) < keep).float()
    return p


def _masked_weight(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``w`` with every block whose ``mask`` entry is 0 zeroed.

    Block sizes are inferred from the mask's shape, as in the JAX package.
    """
    gd, gf = mask.shape
    bm = -(-w.shape[0] // gd)
    bn = -(-w.shape[1] // gf)
    full = mask.repeat_interleave(bm, 0).repeat_interleave(bn, 1)
    return w * full[: w.shape[0], : w.shape[1]].to(w.dtype)


def ffn_apply(p, cfg, x: torch.Tensor) -> torch.Tensor:
    if "block_mask" in p:
        wg = {"w": _masked_weight(p["w_gate"]["w"], p["block_mask"])}
        wu = {"w": _masked_weight(p["w_up"]["w"], p["block_mask"])}
        wd = {"w": _masked_weight(p["w_down"]["w"], p["block_mask"].T)}
    else:
        wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    g = shard(torch.nn.functional.silu(dense(wg, x)), "dp", None, "model")
    u = shard(dense(wu, x), "dp", None, "model")
    return dense(wd, g * u)
