"""The yardstick's arithmetic: block patterns drawn from the seed, the work
one product of such patterns carries, and the chip's published peaks.

Everything here is counted from the patterns the benchmark drew, never
from a plan, so the count stays the same whatever dataflow, kernel or
dense escape the program picks.  Imports numpy alone.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
FP32_BYTES = 4


def block_pattern(rng, shape, block, density):
    """Occupancy bitmap of a ``shape`` matrix cut into ``block`` x ``block``
    blocks: exactly round(density x blocks) blocks present (at least one
    where density > 0), placed uniformly at random."""
    gm, gk = -(-shape[0] // block), -(-shape[1] // block)
    keep = min(gm * gk, max(int(density > 0), round(density * gm * gk)))
    mask = np.zeros(gm * gk, bool)
    mask[rng.choice(gm * gk, size=keep, replace=False)] = True
    return mask.reshape(gm, gk)


def valid(count, block, total):
    """Valid extent of each of ``count`` blocks along an axis of length
    ``total`` (the last block may hang over the edge)."""
    return np.clip(total - np.arange(count) * block, 0, block)


def product_work(occ_a, occ_b, shape, block):
    """(effectual operations, bytes) of C = A @ B on these bitmaps.

    Operations: 2 per multiply-add of every block pair in which both
    blocks are present, on the blocks' valid extents.  Bytes: each
    present input block once and the dense fp32 output once.
    """
    m, k, n = shape
    va, vk, vn = (valid(c, block, t) for c, t in
                  ((occ_a.shape[0], m), (occ_a.shape[1], k),
                   (occ_b.shape[1], n)))
    rows = occ_a.T.astype(np.float64) @ va        # per depth block
    cols = occ_b.astype(np.float64) @ vn
    flops = 2.0 * float(np.sum(vk * rows * cols))
    values = (float(va @ occ_a.astype(np.float64) @ vk)
              + float(vk @ occ_b.astype(np.float64) @ vn))
    return flops, FP32_BYTES * (values + m * n)


def bound_s(flops, nbytes, peaks):
    """Least time the chip could take on fp32 products outside the tensor
    cores: the larger of the two terms."""
    return max(flops / peaks["fp32_flop_per_s"],
               nbytes / peaks["hbm_bytes_per_s"])


def peaks_for(kind):
    """The published peaks of the card named ``kind`` (``peaks.json``):
    ``fp32_flop_per_s``, ``bf16_flop_per_s`` (dense, on the tensor cores)
    and ``hbm_bytes_per_s``; None for a card the table does not hold."""
    table = json.loads((HERE / "peaks.json").read_text())
    for entry in table["cards"]:
        if entry["match"] in kind:
            return entry
    return None
