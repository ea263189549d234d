"""On-chip capacity model — the paper's 3-tier memory hierarchy as a budget.

Flexagon's third pillar (paper §3.4–§3.5) is a memory hierarchy tailored to
SpMSpM access characteristics:

- **L1** — the per-cluster structures next to the multipliers: the STA FIFOs
  holding the *stationary* operand slice and the PSRAM holding in-flight
  partial sums (256 KiB in Table 5);
- **L2** — the SpMSpM-customized streaming cache (the 1 MiB STR cache) that
  the *streamed* operand flows through, with a replacement policy per
  dataflow;
- **off-chip** — DRAM, unbounded but priced.

A :class:`MemoryBudget` captures the two on-chip tiers as byte capacities.
The tile schedulers (:mod:`repro_torch.memory.tiling`) partition an SpMSpM at
pattern granularity until every tile's *stationary* footprint fits L1 and
its *streamed* working set fits L2; the traffic model
(:mod:`repro_torch.memory.traffic`) then prices what moves through each tier.

Footprints are computed from block-occupancy bitmaps — pattern granularity,
never values — so budget decisions are phase-1 work like everything else in
the planner.  The module is the JAX package's ``repro.memory.budget``,
copied.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["MemoryBudget", "PAPER_BUDGET", "operand_bytes", "output_bytes"]


@dataclasses.dataclass(frozen=True)
class MemoryBudget:
    """Byte capacities of the two on-chip tiers (see module docstring).

    ``l1_bytes``   — stationary tier: STA FIFOs + PSRAM (stationary operand
                     slice and the psum/output working set of one tile).
    ``l2_bytes``   — streaming tier: the SpMSpM-customized L2 (STR cache)
                     the streamed operand's tile working set must fit.
    ``dtype_bytes`` — bytes per stored scalar (4 = fp32 values; the paper's
                     32-bit (coord, value) element uses the same figure).

    Frozen and hashable, so budgets ride in cache keys.
    """

    l1_bytes: int = 256 << 10           # Table 5 PSRAM
    l2_bytes: int = 1 << 20             # Table 5 STR cache
    dtype_bytes: int = 4

    def __post_init__(self):
        if self.l1_bytes <= 0 or self.l2_bytes <= 0:
            raise ValueError(
                f"budget tiers must be positive, got l1={self.l1_bytes} "
                f"l2={self.l2_bytes}")

    @classmethod
    def from_accelerator(cls, cfg) -> "MemoryBudget":
        """Budget matching an :class:`AcceleratorConfig` (Table 5)."""
        return cls(l1_bytes=cfg.psram_bytes + cfg.sta_fifo_bytes,
                   l2_bytes=cfg.str_cache_bytes,
                   dtype_bytes=cfg.word_bytes)

    def block_bytes(self, block_shape: Tuple[int, int]) -> int:
        """Bytes of one dense value block."""
        return block_shape[0] * block_shape[1] * self.dtype_bytes

    def fits(self, stationary_bytes: float, streamed_bytes: float) -> bool:
        """Does one tile's working set fit on chip (L1 + L2 split)?"""
        return (stationary_bytes <= self.l1_bytes
                and streamed_bytes <= self.l2_bytes)

    def scaled(self, factor: float) -> "MemoryBudget":
        """A proportionally larger/smaller budget (tests, sweeps)."""
        return dataclasses.replace(
            self, l1_bytes=max(1, int(self.l1_bytes * factor)),
            l2_bytes=max(1, int(self.l2_bytes * factor)))


#: The paper's Table 5 on-chip configuration as a budget.
PAPER_BUDGET = MemoryBudget()


def operand_bytes(occ: np.ndarray, block_shape: Tuple[int, int],
                  dtype_bytes: int = 4) -> int:
    """Compressed footprint of a block-occupancy bitmap slice: occupied
    blocks × dense block bytes (coordinate vectors are noise at block
    granularity and ride the tile-reader registers, paper §3.4)."""
    bm, bk = block_shape
    return int(occ.sum()) * bm * bk * dtype_bytes


def output_bytes(occ_a: np.ndarray, occ_b: np.ndarray,
                 block_mn: Tuple[int, int], dtype_bytes: int = 4) -> int:
    """Exact output-tile footprint: C's block occupancy is the boolean
    product of the operand bitmaps (a C block exists iff some k intersects).
    """
    c_occ = (occ_a.astype(np.int64) @ occ_b.astype(np.int64)) > 0
    bm, bn = block_mn
    return int(c_occ.sum()) * bm * bn * dtype_bytes
