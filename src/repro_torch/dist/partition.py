"""``Partitioner`` — assign one SpMSpM's block grid (or tile stream) to mesh
shards, with a per-dataflow strategy.

The paper's Merger-Reduction Network unifies reducing and merging in one
substrate; the tiled engine (DESIGN.md §12) lifted that merge to tile
granularity, and this module lifts it once more — to *device* granularity.
Placement is orthogonal to tiling: a :class:`Partitioner` splits the block
grid into per-shard sub-problems along the axis its dataflow parallelizes
naturally, and each shard then tiles (or not) under its own memory budget:

- **IP** (``ip_m``) — stationary C-tiles are disjoint in the output, so the
  partition is embarrassingly parallel over *output regions*: shards own
  column panels of C (full A working set, a B column stripe each).  No
  cross-shard merge.
- **OP** (``op_m``) — k-slabs: every shard owns a K slab of both operands
  and produces a partial sum for the *whole* C.  The cross-shard merge is a
  ``all_reduce`` collective — the MRN's merge phase as the top tier of the merge
  hierarchy (tile merge below it, block merge below that).
- **Gust** (``gust_m``) — row bands: shards own row bands of A and C with a
  replicated-B working set.  Disjoint outputs, no collective.

N-stationary variants partition the dual axis (the paper: "in the same
manner by exchanging matrices A and B"): ``ip_n`` shards M, ``gust_n``
shards N, ``op_n`` still shards K.

Everything here is host-side phase-1 work on numpy bitmaps, so traffic
pricing and cache-key fingerprinting can use it freely.  The module is the
JAX package's ``repro.dist.partition``, copied; ``mesh_device_count`` and
``mesh_key`` read the port's two kinds of mesh
(:mod:`repro_torch.launch.mesh`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..launch.mesh import mesh_axis_names, mesh_shape
from ..memory.tiling import Tile

__all__ = [
    "DistPartition",
    "Partitioner",
    "default_axis",
    "mesh_device_count",
    "resolve_shards",
    "mesh_key",
    "merge_ici_bytes",
]

#: Partition axis per dataflow (see module docstring).  ``"mixed"`` plans
#: (heterogeneous per-tile dataflows, DESIGN.md §14) shard row bands of the
#: output grid — disjoint C regions, no collective — so every shard is free
#: to hold its own per-tile dataflow mix.
DEFAULT_AXIS = {
    "ip_m": "n", "ip_n": "m",
    "op_m": "k", "op_n": "k",
    "gust_m": "m", "gust_n": "n",
    "mixed": "m",
}


@dataclasses.dataclass(frozen=True)
class DistPartition:
    """How to place one plan on a mesh (the ``partition=`` argument).

    ``axis``   — "m" / "k" / "n" block-grid axis to shard, or ``None`` for
                 the dataflow's default strategy (:data:`DEFAULT_AXIS`).
    ``shards`` — shard count, or ``None`` for the mesh's device count.

    Frozen and hashable so partitions ride in plan-cache keys, exactly like
    :class:`repro_torch.memory.MemoryBudget`.
    """

    axis: Optional[str] = None
    shards: Optional[int] = None

    def __post_init__(self):
        if self.axis is not None and self.axis not in ("m", "k", "n"):
            raise ValueError(f"axis must be 'm', 'k' or 'n', got {self.axis!r}")
        if self.shards is not None and self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")


def default_axis(dataflow: str) -> str:
    """The axis ``dataflow``'s partition strategy shards (module docstring)."""
    try:
        return DEFAULT_AXIS[dataflow]
    except KeyError:
        raise ValueError(f"unknown dataflow {dataflow!r}") from None


def mesh_device_count(mesh) -> int:
    """Shards a mesh holds; 0 when ``mesh`` is None (callers gating on
    real ranks — the collective path — want the 0, callers defaulting a
    shard count clamp with ``max(1, ...)``)."""
    if mesh is None:
        return 0
    shape = mesh_shape(mesh)
    n = 1
    for s in shape:
        n *= s
    return n


def resolve_shards(mesh, partition: Optional[DistPartition]) -> int:
    """Shard count for a (mesh, partition) pair: an explicit
    ``partition.shards`` wins, else every device in the mesh is one shard."""
    if partition is not None and partition.shards is not None:
        return int(partition.shards)
    return max(1, mesh_device_count(mesh))


def mesh_key(mesh) -> Optional[Tuple]:
    """Hashable identity of a mesh's *shape* for plan-cache fingerprints.

    Two meshes with the same device grid and axis names produce identical
    plans, so the key deliberately ignores device identity."""
    if mesh is None:
        return None
    return (mesh_shape(mesh), mesh_axis_names(mesh))


def merge_ici_bytes(axis: str, n_shards: int, c_bytes: float) -> float:
    """Interconnect bytes of the cross-shard partial-sum merge.

    Only k-slab partitions merge across devices (an all-reduce of the full
    partial C).  Ring all-reduce moves ``2 (S-1)/S`` of the payload per
    device; summed over ``S`` devices the links carry ``2 (S-1)`` payloads.
    Disjoint-output partitions (m/n) exchange nothing.
    """
    if axis != "k" or n_shards <= 1:
        return 0.0
    return 2.0 * (n_shards - 1) * float(c_bytes)


class Partitioner:
    """Per-dataflow shard assignment over the (M, K, N) block grid.

    ``shard_tiles`` yields one :class:`repro_torch.memory.tiling.Tile` per shard —
    the shard's sub-grid as half-open block ranges, with the sharded axis
    padded to a uniform extent (every rank of
    :class:`repro_torch.dist.sharded_plan.ShardedPlan`'s collective path
    then owns an equal slice).  ``assign`` places an existing
    :class:`TileScheduler` tile stream onto shards by each tile's position
    along the strategy axis, so tiling decisions stay orthogonal to
    placement.
    """

    def __init__(self, dataflow: str, *, axis: Optional[str] = None,
                 shards: Optional[int] = None):
        self.dataflow = dataflow
        self.axis = axis or default_axis(dataflow)
        self.shards = shards

    @classmethod
    def for_dataflow(cls, dataflow: str,
                     partition: Optional[DistPartition] = None
                     ) -> "Partitioner":
        p = partition or DistPartition()
        return cls(dataflow, axis=p.axis, shards=p.shards)

    def n_shards(self, mesh) -> int:
        if self.shards is not None:
            return int(self.shards)
        return max(1, mesh_device_count(mesh))

    # -- grid partitioning -----------------------------------------------
    def padded_extent(self, n_blocks: int, n_shards: int) -> int:
        """The sharded axis, padded so every shard gets an equal extent."""
        return -(-max(1, n_blocks) // n_shards) * n_shards

    def shard_tiles(self, grid: Tuple[int, int, int], n_shards: int
                    ) -> List[Tile]:
        """One uniform sub-grid Tile per shard (padded along ``self.axis``)."""
        mb, kb, nb = grid
        if self.axis == "m":
            mp = self.padded_extent(mb, n_shards)
            e = mp // n_shards
            return [Tile(s * e, (s + 1) * e, 0, kb, 0, nb)
                    for s in range(n_shards)]
        if self.axis == "k":
            kp = self.padded_extent(kb, n_shards)
            e = kp // n_shards
            return [Tile(0, mb, s * e, (s + 1) * e, 0, nb)
                    for s in range(n_shards)]
        np_ = self.padded_extent(nb, n_shards)
        e = np_ // n_shards
        return [Tile(0, mb, 0, kb, s * e, (s + 1) * e)
                for s in range(n_shards)]

    def padded_grid(self, grid: Tuple[int, int, int], n_shards: int
                    ) -> Tuple[int, int, int]:
        mb, kb, nb = grid
        if self.axis == "m":
            return (self.padded_extent(mb, n_shards), kb, nb)
        if self.axis == "k":
            return (mb, self.padded_extent(kb, n_shards), nb)
        return (mb, kb, self.padded_extent(nb, n_shards))

    # -- tile-stream placement -------------------------------------------
    def assign(self, tiles: Sequence[Tile], n_shards: int) -> List[int]:
        """Shard index per tile: a tile goes to the shard owning the start
        of its range along the strategy axis (contiguous block ownership,
        so IP C-tiles / OP k-slabs / Gust row bands land where their
        operand slices live)."""
        lo_of = {"m": lambda t: t.i0, "k": lambda t: t.k0,
                 "n": lambda t: t.j0}[self.axis]
        hi_of = {"m": lambda t: t.i1, "k": lambda t: t.k1,
                 "n": lambda t: t.j1}[self.axis]
        extent = max((hi_of(t) for t in tiles), default=1)
        padded = self.padded_extent(extent, n_shards)
        per = padded // n_shards
        return [min(n_shards - 1, lo_of(t) // per) for t in tiles]

    # -- bitmap slicing ----------------------------------------------------
    def shard_bitmaps(self, occ_a: np.ndarray, occ_b: np.ndarray,
                      n_shards: int
                      ) -> List[Tuple[Tile, np.ndarray, np.ndarray]]:
        """Per-shard (sub-grid tile, A bitmap slice, B bitmap slice), with
        slices zero-padded out to the uniform shard extents."""
        mb, kb = occ_a.shape
        nb = occ_b.shape[1]
        tiles = self.shard_tiles((mb, kb, nb), n_shards)
        mp, kp, np_ = self.padded_grid((mb, kb, nb), n_shards)
        occ_a_p = np.zeros((mp, kp), dtype=bool)
        occ_a_p[:mb, :kb] = occ_a
        occ_b_p = np.zeros((kp, np_), dtype=bool)
        occ_b_p[:kb, :nb] = occ_b
        return [(t, t.a_slice(occ_a_p), t.b_slice(occ_b_p)) for t in tiles]
