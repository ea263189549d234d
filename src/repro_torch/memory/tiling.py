"""Per-dataflow tile schedulers — partition one SpMSpM until tiles fit.

Each of the paper's dataflows keeps a different operand *stationary* (in the
L1 FIFOs/PSRAM) and streams a different operand (through the L2 STR cache),
so each wants a different tiling axis when the operation outgrows the chip
(FlexiSAGA's observation: dataflow-aware tiling is what makes a flexible
sparse accelerator practical at real layer sizes):

- **IP** (``ip_m``) — stationary C-tiles: split M × N; each tile holds an A
  row stripe + its C tile stationary and streams a B column stripe.  Tiles
  are disjoint in C — no cross-tile partial sums.
- **OP** (``op_m``) — k-slab streaming: split K; each slab holds its A
  column elements stationary and streams its B rows.  Every slab produces
  partial sums for the *whole* C — the cross-slab merge is the MRN's job
  lifted to tile granularity (:class:`TileMergePlan`; SegFold's
  segment-merge mechanism).
- **Gust** (``gust_m``) — row-band streaming: split M; each band keeps its A
  rows stationary, gathers only the B rows its pattern touches, and owns a
  disjoint C band.  Per-band index plans are rebuilt per band at plan
  time — pattern-only, like every phase-1 artifact.

N-stationary variants schedule the transposed problem (the paper: "in the
same manner by exchanging matrices A and B") and map the tiles back.

- **mixed** (``dataflow="mixed"``) — output-grid tiling for *heterogeneous*
  per-tile dataflows: split M × N with full K per tile, so
  every tile owns a disjoint C region.  Disjoint outputs are the one tiling
  under which any per-tile dataflow choice stays merge-compatible — there
  are no cross-tile partial sums whose accumulation order the per-tile
  dataflows would have to agree on, so the selection policy is free to pick
  a different dataflow for every tile (SegFold's fine-grained dynamic
  selection at our tile seam).

Schedulers work at *pattern granularity*: footprints come from block
occupancy bitmap slices, never from values.  Split counts refine
geometrically (doubling) on whichever tier is violated, down to single-block
granularity; a tile that still exceeds the budget at one block is accepted
(the traffic model prices the resulting spills instead of failing).

The module is the JAX package's ``repro.memory.tiling``, copied: its tiles
and merge plans are byte-equal.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import List, Tuple

import numpy as np

from .budget import MemoryBudget, operand_bytes, output_bytes

__all__ = [
    "Tile",
    "TileMergePlan",
    "TileScheduler",
    "IPTileScheduler",
    "OPTileScheduler",
    "GustTileScheduler",
    "MixedTileScheduler",
    "get_scheduler",
    "schedule",
]


@dataclasses.dataclass(frozen=True)
class Tile:
    """One tile, as half-open *block* ranges of the (M, K, N) grid."""

    i0: int
    i1: int
    k0: int
    k1: int
    j0: int
    j1: int

    @property
    def out_region(self) -> Tuple[int, int, int, int]:
        """The (i0, i1, j0, j1) output region this tile contributes to."""
        return (self.i0, self.i1, self.j0, self.j1)

    def a_slice(self, occ_a: np.ndarray) -> np.ndarray:
        return occ_a[self.i0:self.i1, self.k0:self.k1]

    def b_slice(self, occ_b: np.ndarray) -> np.ndarray:
        return occ_b[self.k0:self.k1, self.j0:self.j1]


@dataclasses.dataclass(frozen=True)
class TileMergePlan:
    """Which tiles accumulate into which output region (phase-1 output).

    Regions with one contribution write through; regions with several (OP
    k-slabs) merge partial sums across tiles — the MRN-across-tiles role the
    executor realizes as accumulation at block coordinates
    and the traffic model prices as psum round trips per extra contribution.
    """

    regions: Tuple[Tuple[int, int, int, int], ...]
    tile_region: Tuple[int, ...]            # tile index -> region index

    @property
    def n_regions(self) -> int:
        return len(self.regions)

    def contributions(self) -> np.ndarray:
        """(n_regions,) number of tiles merging into each region."""
        counts = np.zeros(len(self.regions), dtype=np.int64)
        for r in self.tile_region:
            counts[r] += 1
        return counts

    @property
    def max_contributions(self) -> int:
        return int(self.contributions().max(initial=0))

    @classmethod
    def from_tiles(cls, tiles: List[Tile]) -> "TileMergePlan":
        regions: List[Tuple[int, int, int, int]] = []
        index = {}
        tile_region = []
        for t in tiles:
            r = t.out_region
            if r not in index:
                index[r] = len(regions)
                regions.append(r)
            tile_region.append(index[r])
        return cls(tuple(regions), tuple(tile_region))


def _ranges(n_blocks: int, splits: int) -> List[Tuple[int, int]]:
    """Even contiguous half-open ranges of ``n_blocks`` into ``splits``."""
    splits = max(1, min(int(splits), n_blocks))
    edges = np.linspace(0, n_blocks, splits + 1).round().astype(int)
    return [(int(edges[i]), int(edges[i + 1])) for i in range(splits)]


class TileScheduler(abc.ABC):
    """Partition one SpMSpM's pattern into budget-fitting tiles."""

    def __init__(self, budget: MemoryBudget):
        self.budget = budget

    @abc.abstractmethod
    def tiles(self, occ_a: np.ndarray, occ_b: np.ndarray,
              block_shape: Tuple[int, int, int]) -> List[Tile]:
        """Tiles covering the whole operation, in execution order."""


class IPTileScheduler(TileScheduler):
    """Stationary C-tiles: split M (stationary tier) × N (streaming tier)."""

    def tiles(self, occ_a, occ_b, block_shape) -> List[Tile]:
        bm, bk, bn = block_shape
        mb, kb = occ_a.shape
        _, nb = occ_b.shape
        dt = self.budget.dtype_bytes
        si = sj = 1
        while True:
            rows, cols = _ranges(mb, si), _ranges(nb, sj)
            sta_bad = str_bad = False
            stripe_b = {c: operand_bytes(occ_b[:, c[0]:c[1]], (bk, bn), dt)
                        for c in cols}
            for i0, i1 in rows:
                a_stripe = operand_bytes(occ_a[i0:i1], (bm, bk), dt)
                for j0, j1 in cols:
                    c_tile = output_bytes(occ_a[i0:i1], occ_b[:, j0:j1],
                                          (bm, bn), dt)
                    if a_stripe + c_tile > self.budget.l1_bytes:
                        sta_bad = True
                    if stripe_b[(j0, j1)] > self.budget.l2_bytes:
                        str_bad = True
            progressed = False
            if sta_bad:
                # the C tile shrinks along either axis; prefer rows (keeps
                # the A stripe shrinking too), fall back to columns when M
                # is already at single-block stripes
                if len(rows) < mb:
                    si, progressed = min(mb, si * 2), True
                elif len(cols) < nb:
                    sj, progressed = min(nb, sj * 2), True
            if str_bad and len(cols) < nb:
                sj, progressed = min(nb, sj * 2), True
            if not (sta_bad or str_bad) or not progressed:
                return [Tile(i0, i1, 0, kb, j0, j1)
                        for i0, i1 in rows for j0, j1 in cols]


class OPTileScheduler(TileScheduler):
    """K-slab streaming: split K into *uniform-extent* slabs.

    Uniform extents (the last slab zero-padded at the pattern level) keep
    every slab's sub-plan the same shape, which is what lets
    :class:`repro_torch.memory.tiled_plan.TiledPlan` pad the slab plans to
    one extent and stream them through one loop into a single carry.
    """

    def tiles(self, occ_a, occ_b, block_shape) -> List[Tile]:
        bm, bk, bn = block_shape
        mb, kb = occ_a.shape
        _, nb = occ_b.shape
        dt = self.budget.dtype_bytes
        s = 1
        while True:
            ke = -(-kb // max(1, min(s, kb)))        # uniform slab extent
            # the last slab runs past the K grid rather than shrinking —
            # the overhang is empty fibers (plan_tiled zero-pads the
            # bitmaps), and uniform extents are what the scan path needs
            slabs = [(k0, k0 + ke) for k0 in range(0, kb, ke)]
            sta_bad = any(
                operand_bytes(occ_a[:, k0:k1], (bm, bk), dt)
                > self.budget.l1_bytes for k0, k1 in slabs)
            str_bad = any(
                operand_bytes(occ_b[k0:k1], (bk, bn), dt)
                > self.budget.l2_bytes for k0, k1 in slabs)
            if not (sta_bad or str_bad) or len(slabs) >= kb:
                return [Tile(0, mb, k0, k1, 0, nb) for k0, k1 in slabs]
            s = min(kb, s * 2)


class GustTileScheduler(TileScheduler):
    """Row-band streaming: split M; each band gathers only touched B rows."""

    def tiles(self, occ_a, occ_b, block_shape) -> List[Tile]:
        bm, bk, bn = block_shape
        mb, kb = occ_a.shape
        _, nb = occ_b.shape
        dt = self.budget.dtype_bytes
        s = 1
        while True:
            bands = _ranges(mb, s)
            sta_bad = str_bad = False
            for i0, i1 in bands:
                if operand_bytes(occ_a[i0:i1], (bm, bk), dt) \
                        > self.budget.l1_bytes:
                    sta_bad = True
                touched = occ_a[i0:i1].any(axis=0)       # leader's K fibers
                if operand_bytes(occ_b[touched], (bk, bn), dt) \
                        > self.budget.l2_bytes:
                    str_bad = True
            if not (sta_bad or str_bad) or len(bands) >= mb:
                return [Tile(i0, i1, 0, kb, 0, nb) for i0, i1 in bands]
            s = min(mb, s * 2)


class MixedTileScheduler(TileScheduler):
    """Output-grid tiling for heterogeneous per-tile dataflows.

    Splits M (× N only as a last resort) with full K per tile, so tiles own
    disjoint C regions — see the module docstring.  The footprint check is
    the most *permissive* of the per-family residency requirements — the
    stationary A stripe in L1 and the touched-B working set in L2, i.e. the
    Gust test generalized to output-column slices: a tile is accepted as
    soon as at least one candidate dataflow can hold it resident, and the
    tiling stays as coarse as the coarsest single-dataflow scheduler's —
    which is what lets the per-tile argmin beat every single-dataflow plan
    instead of drowning the gain in extra re-streaming.
    """

    def _feasible(self, occ_a, occ_b, block_shape, rows, cols) -> bool:
        """Every tile resident under *some* family (M-dual OR N-dual)."""
        bm, bk, bn = block_shape
        dt = self.budget.dtype_bytes
        for i0, i1 in rows:
            a_stripe = operand_bytes(occ_a[i0:i1], (bm, bk), dt)
            touched_b = occ_a[i0:i1].any(axis=0)     # leader's K fibers
            for j0, j1 in cols:
                # M-dual (gust_m-style): A stripe stationary in L1, the
                # touched B working set streaming through L2
                if a_stripe <= self.budget.l1_bytes \
                        and operand_bytes(occ_b[touched_b][:, j0:j1],
                                          (bk, bn), dt) \
                        <= self.budget.l2_bytes:
                    continue
                # N-dual (gust_n-style): B column stripe stationary, the
                # touched A working set streaming
                touched_a = occ_b[:, j0:j1].any(axis=1)
                if operand_bytes(occ_b[:, j0:j1], (bk, bn), dt) \
                        <= self.budget.l1_bytes \
                        and operand_bytes(occ_a[i0:i1][:, touched_a],
                                          (bm, bk), dt) \
                        <= self.budget.l2_bytes:
                    continue
                return False
        return True

    def tiles(self, occ_a, occ_b, block_shape) -> List[Tile]:
        mb, kb = occ_a.shape
        _, nb = occ_b.shape
        # coarsest feasible output grid: geometric split candidates on both
        # axes, fewest tiles wins; ties prefer M splits (row bands keep the
        # per-band sparsity contrast that makes mixing pay off)
        splits = lambda nblk: sorted({min(nblk, 1 << p)
                                      for p in range(nblk.bit_length() + 1)})
        grids = sorted(((len(_ranges(mb, si)) * len(_ranges(nb, sj)), sj, si)
                        for si in splits(mb) for sj in splits(nb)))
        for _, sj, si in grids:
            rows, cols = _ranges(mb, si), _ranges(nb, sj)
            if self._feasible(occ_a, occ_b, block_shape, rows, cols):
                break
        else:                              # single-block tiles: accept spills
            rows, cols = _ranges(mb, mb), _ranges(nb, nb)
        return [Tile(i0, i1, 0, kb, j0, j1)
                for i0, i1 in rows for j0, j1 in cols]


_SCHEDULERS = {"ip": IPTileScheduler, "op": OPTileScheduler,
               "gust": GustTileScheduler, "mixed": MixedTileScheduler}


def get_scheduler(dataflow: str, budget: MemoryBudget) -> TileScheduler:
    """The scheduler for ``dataflow``'s base family (N variants share it)."""
    base = dataflow[:-2] if dataflow.endswith(("_m", "_n")) else dataflow
    try:
        return _SCHEDULERS[base](budget)
    except KeyError:
        raise ValueError(f"unknown dataflow {dataflow!r}") from None


def schedule(dataflow: str, occ_a: np.ndarray, occ_b: np.ndarray,
             block_shape: Tuple[int, int, int], budget: MemoryBudget
             ) -> Tuple[List[Tile], TileMergePlan]:
    """Tiles + merge plan for one operation under ``budget``.

    N-stationary dataflows are scheduled on the transposed problem
    (A' = Bᵀ, B' = Aᵀ) and the tiles mapped back to the original grid.
    """
    sched = get_scheduler(dataflow, budget)
    if dataflow.endswith("_n"):
        bm, bk, bn = block_shape
        t_tiles = sched.tiles(occ_b.T, occ_a.T, (bn, bk, bm))
        tiles = [Tile(t.j0, t.j1, t.k0, t.k1, t.i0, t.i1) for t in t_tiles]
    else:
        tiles = sched.tiles(occ_a, occ_b, block_shape)
    return tiles, TileMergePlan.from_tiles(tiles)
