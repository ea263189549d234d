"""3-tier traffic pricing for tiled execution.

Prices what a tiled SpMSpM moves through each tier of the paper's memory
hierarchy, reusing the cycle models of
:mod:`repro_torch.core.simulator.accelerators` per tile:

- **L1** — STA FIFO reads of the stationary operand + PSRAM psum round
  trips (``sta_read_bytes`` + ``psram_rw_bytes`` of each tile's
  :class:`SimResult`);
- **L2** — STR-cache accesses of the streamed operand (``str_read_bytes``);
- **DRAM** — each tile's off-chip bytes (``offchip_bytes``) *plus* the
  cross-tile merge traffic: every output region written by more than one
  tile (OP k-slabs) spills its partial C off chip between contributions and
  reads it back to merge — by construction a tiled operation's partials
  cannot stay resident (that is why it was tiled).

Two entry points share the aggregation:

- :func:`tiled_traffic` prices a (dataflow, pattern, budget) triple — what
  selection policies consult to become traffic-aware;
- :func:`plan_traffic` prices an existing
  :class:`repro_torch.memory.tiled_plan.TiledPlan` — what the simulator
  backend's ``report`` returns (with the per-tile :class:`SimResult`\\ s
  attached).

:func:`tiled_estimate` is the analytic (roofline) counterpart used where
only shape features exist (the ``plan_network`` DP): per-tile
:func:`repro_torch.core.selector.estimate` sums, plus merge traffic.

:func:`sharded_traffic` / :func:`sharded_plan_traffic` /
:func:`sharded_estimate` price a *sharded* execution: per-shard tiers plus
the fourth, interconnect tier that carries the cross-shard merge.

The module is the JAX package's ``repro.memory.traffic`` with the
roofline's ``DeviceSpec`` in place of ``TPUSpec``.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.selector import DataflowEstimate, DeviceSpec, LayerShape, estimate
from ..core.simulator import LayerSpec, from_layer, simulate
from ..core.simulator.config import PAPER_CONFIG, AcceleratorConfig
from .budget import MemoryBudget, output_bytes
from .tiling import TileMergePlan, schedule

__all__ = [
    "TierTraffic",
    "TiledSimReport",
    "ShardedSimReport",
    "tiled_traffic",
    "plan_traffic",
    "tiled_estimate",
    "sharded_traffic",
    "sharded_plan_traffic",
    "sharded_estimate",
    "mixed_tile_choices",
    "synthetic_occupancy",
]

_SIM_OF_BASE = {"ip": "sigma_like", "op": "sparch_like", "gust": "gamma_like"}


@dataclasses.dataclass(frozen=True)
class TierTraffic:
    """Bytes moved through each tier for one (possibly tiled, possibly
    sharded) operation.  ``ici_bytes`` is the fourth tier — inter-chip
    interconnect traffic from the cross-shard partial-sum merge (zero for
    single-device plans and disjoint-output partitions)."""

    l1_bytes: float            # STA FIFO + PSRAM
    l2_bytes: float            # STR cache
    dram_bytes: float          # off-chip, incl. cross-tile merge round trips
    merge_bytes: float         # the cross-tile share of dram_bytes
    cycles: float
    tiles: int
    ici_bytes: float = 0.0     # cross-shard merge collective (dist tier)

    @property
    def onchip_bytes(self) -> float:
        return self.l1_bytes + self.l2_bytes

    @property
    def total_bytes(self) -> float:
        return self.onchip_bytes + self.dram_bytes + self.ici_bytes

    def time_s(self, cfg: AcceleratorConfig = PAPER_CONFIG) -> float:
        return self.cycles / cfg.freq_hz


@dataclasses.dataclass
class TiledSimReport:
    """``SimulatorBackend.report`` result for a tiled plan.

    ``tile_dataflows`` names the dataflow each tile ran (all equal for
    single-dataflow plans, the policy's per-tile choices for ``"mixed"``);
    ``per_group`` re-aggregates the per-tile results into one
    :class:`TierTraffic` per distinct dataflow, so a mixed report shows
    where each lane's traffic went.
    """

    dataflow: str
    per_tile: List                      # SimResult per tile
    traffic: TierTraffic
    tile_dataflows: Tuple[str, ...] = ()
    per_group: Dict[str, TierTraffic] = dataclasses.field(
        default_factory=dict)

    @property
    def cycles(self) -> float:
        return self.traffic.cycles

    @property
    def n_tiles(self) -> int:
        return self.traffic.tiles

    @property
    def dataflow_histogram(self) -> Dict[str, int]:
        """Tile count per dataflow (the ``tile_dataflows`` bench field)."""
        return dict(Counter(self.tile_dataflows))


def _tile_result(dataflow: str, dims: Tuple[int, int, int],
                 da: float, db: float, cfg: AcceleratorConfig, seed: int):
    """Cycle-model result for one tile (N variants priced as the M dual)."""
    m, k, n = dims
    if dataflow.endswith("_n"):
        m, n, da, db = n, m, db, da
    spec = LayerSpec(name="tile", m=m, n=n, k=k,
                     sp_a=100.0 * (1.0 - da), sp_b=100.0 * (1.0 - db))
    st = from_layer(spec, seed=seed)
    return simulate(_SIM_OF_BASE[dataflow[:-2]], st, cfg)


def _merge_dram_bytes(merge_plan: TileMergePlan, region_c_bytes: List[int]
                      ) -> float:
    """Cross-tile merge traffic: each contribution beyond the first spills
    the region's partial C off chip and reads it back (write + read)."""
    contribs = merge_plan.contributions()
    return float(sum(2.0 * c_bytes * max(0, int(c) - 1)
                     for c_bytes, c in zip(region_c_bytes, contribs)))


def _aggregate(dataflow: str, results: List, merge_bytes: float,
               cfg: AcceleratorConfig) -> TierTraffic:
    l1 = sum(r.sta_read_bytes + r.psram_rw_bytes for r in results)
    l2 = sum(r.str_read_bytes for r in results)
    dram = sum(r.offchip_bytes for r in results) + merge_bytes
    cycles = sum(r.cycles for r in results) \
        + merge_bytes / cfg.dram_bytes_per_cycle
    return TierTraffic(l1_bytes=float(l1), l2_bytes=float(l2),
                       dram_bytes=float(dram), merge_bytes=float(merge_bytes),
                       cycles=float(cycles), tiles=len(results))


def _region_c_bytes(merge_plan: TileMergePlan, occ_a: np.ndarray,
                    occ_b: np.ndarray, block_shape: Tuple[int, int, int],
                    dtype_bytes: int) -> List[int]:
    bm, bk, bn = block_shape
    out = []
    for i0, i1, j0, j1 in merge_plan.regions:
        out.append(output_bytes(occ_a[i0:i1], occ_b[:, j0:j1], (bm, bn),
                                dtype_bytes))
    return out


def _occ_density(occ: np.ndarray) -> float:
    return float(occ.mean()) if occ.size else 0.0


def mixed_tile_choices(occ_a: np.ndarray, occ_b: np.ndarray,
                       block_shape: Tuple[int, int, int],
                       budget: MemoryBudget,
                       cfg: AcceleratorConfig = PAPER_CONFIG, seed: int = 0,
                       allowed: Sequence[str] = None, tiles=None
                       ) -> Tuple[str, ...]:
    """Cycle-model argmin dataflow per mixed-schedule tile.

    The policy-free pricing counterpart of
    :func:`repro_torch.memory.tiled_plan.mixed_tile_dataflows` — equivalent to
    what the ``simulator`` policy's ``select_tile`` picks (same cycle
    models, same seed-0 sampled patterns); used where only a traffic
    estimate is wanted (``tiled_traffic("mixed", ...)``, the bench rows).
    ``tiles`` skips the schedule when the caller already ran it.
    """
    from ..core.dataflows import DATAFLOWS

    allowed = tuple(allowed) if allowed else tuple(DATAFLOWS)
    bm, bk, bn = block_shape
    if tiles is None:
        tiles, _ = schedule("mixed", occ_a, occ_b, block_shape, budget)
    choices = []
    for tile in tiles:
        occ_at = tile.a_slice(occ_a)
        occ_bt = tile.b_slice(occ_b)
        dims = ((tile.i1 - tile.i0) * bm, (tile.k1 - tile.k0) * bk,
                (tile.j1 - tile.j0) * bn)
        da, db = _occ_density(occ_at), _occ_density(occ_bt)
        choices.append(min(allowed, key=lambda d: (
            _tile_result(d, dims, da, db, cfg, seed).cycles, d)))
    return tuple(choices)


def tiled_traffic(dataflow: str, occ_a: np.ndarray, occ_b: np.ndarray,
                  block_shape: Tuple[int, int, int], budget: MemoryBudget,
                  cfg: AcceleratorConfig = PAPER_CONFIG, seed: int = 0,
                  tile_dataflows: Optional[Sequence[str]] = None
                  ) -> TierTraffic:
    """Schedule ``dataflow`` under ``budget`` and price the tile stream.

    Tile dimensions come from the bitmaps and block shape alone.
    Deterministic for fixed inputs (tile patterns are seeded samples at the
    tile's density, exactly like ``SimulatorBackend.cost``).
    ``dataflow="mixed"`` prices each tile under its own dataflow —
    ``tile_dataflows`` pins the choices, else the cycle-model argmin per
    tile (:func:`mixed_tile_choices`).
    """
    bm, bk, bn = block_shape
    tiles, merge_plan = schedule(dataflow, occ_a, occ_b, block_shape, budget)
    if dataflow == "mixed" and tile_dataflows is None:
        tile_dataflows = mixed_tile_choices(occ_a, occ_b, block_shape,
                                            budget, cfg, seed, tiles=tiles)
    if tile_dataflows is None:
        tile_dataflows = (dataflow,) * len(tiles)
    elif len(tile_dataflows) != len(tiles):
        raise ValueError(f"got {len(tile_dataflows)} pinned dataflows for "
                         f"{len(tiles)} scheduled tiles")
    results = []
    for tile, d in zip(tiles, tile_dataflows):
        occ_at = tile.a_slice(occ_a)
        occ_bt = tile.b_slice(occ_b)
        dims = ((tile.i1 - tile.i0) * bm, occ_at.shape[1] * bk,
                (tile.j1 - tile.j0) * bn)
        results.append(_tile_result(d, dims, _occ_density(occ_at),
                                    _occ_density(occ_bt), cfg, seed))
    merge = _merge_dram_bytes(
        merge_plan, _region_c_bytes(merge_plan, occ_a, occ_b, block_shape,
                                    budget.dtype_bytes))
    return _aggregate(dataflow, results, merge, cfg)


def plan_traffic(plan, cfg: AcceleratorConfig = PAPER_CONFIG,
                 seed: int = 0) -> TiledSimReport:
    """Per-tile cycle models + tier aggregation for a built ``TiledPlan``.

    Each tile is priced under the dataflow it actually runs
    (``plan.tile_dataflows`` — heterogeneous for mixed plans), and the
    report re-aggregates per distinct dataflow in ``per_group``.
    """
    occ_a, occ_b = plan.occ_a, plan.occ_b
    bm, bk, bn = plan.block_shape
    tile_dataflows = tuple(getattr(plan, "tile_dataflows", ())) \
        or (plan.dataflow,) * len(plan.tiles)
    results = []
    for tile, sub, d in zip(plan.tiles, plan.plans, tile_dataflows):
        occ_at = occ_a[tile.i0: tile.i1, tile.k0: min(tile.k1,
                                                      occ_a.shape[1])]
        occ_bt = occ_b[tile.k0: min(tile.k1, occ_b.shape[0]),
                       tile.j0: tile.j1]
        results.append(_tile_result(d, sub.shapes,
                                    _occ_density(occ_at),
                                    _occ_density(occ_bt), cfg, seed))
    merge = _merge_dram_bytes(
        plan.merge_plan,
        _region_c_bytes(plan.merge_plan, occ_a, occ_b, plan.block_shape,
                        plan.budget.dtype_bytes))
    per_group: Dict[str, TierTraffic] = {}
    for d in dict.fromkeys(tile_dataflows):        # insertion order
        group = [r for r, dd in zip(results, tile_dataflows) if dd == d]
        # the cross-tile merge is a whole-plan cost; attribute it to the
        # aggregate only (mixed plans have none — disjoint C regions)
        per_group[d] = _aggregate(d, group, 0.0, cfg)
    return TiledSimReport(dataflow=plan.dataflow, per_tile=results,
                          traffic=_aggregate(plan.dataflow, results, merge,
                                             cfg),
                          tile_dataflows=tile_dataflows,
                          per_group=per_group)


def synthetic_occupancy(grid: Tuple[int, int], density: float,
                        seed: int = 0) -> np.ndarray:
    """Deterministic sampled bitmap for shape-only callers (network DP)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, grid[0], grid[1],
                                int(max(0.0, density) * 1e6)]))
    return rng.random(grid) < density


def tiled_estimate(shape: LayerShape, dataflow: str, budget: MemoryBudget,
                   spec: Optional[DeviceSpec] = None,
                   occ_a: Optional[np.ndarray] = None,
                   occ_b: Optional[np.ndarray] = None) -> DataflowEstimate:
    """Analytic (roofline) estimate of the tiled execution.

    Summing per-tile estimates naturally charges cross-tile re-streaming —
    operand stripes shared by several tiles are counted once per tile — and
    the cross-tile merge rides in ``bytes_psum``.  ``dataflow="mixed"``
    prices each tile under its roofline-argmin dataflow (the heuristic
    policy's per-tile choice rule).
    """
    from ..core.dataflows import DATAFLOWS

    spec = spec or DeviceSpec()
    bm, bk, bn = shape.block
    mb, kb, nb = shape.grid
    if occ_a is None:
        occ_a = synthetic_occupancy((mb, kb), shape.density_a)
    if occ_b is None:
        occ_b = synthetic_occupancy((kb, nb), shape.density_b, seed=1)
    tiles, merge_plan = schedule(dataflow, occ_a, occ_b, shape.block, budget)

    agg = None
    for tile in tiles:
        occ_at = tile.a_slice(occ_a)
        occ_bt = tile.b_slice(occ_b)
        sub = LayerShape(m=(tile.i1 - tile.i0) * bm,
                         k=max(1, occ_at.shape[1]) * bk,
                         n=(tile.j1 - tile.j0) * bn,
                         density_a=_occ_density(occ_at),
                         density_b=_occ_density(occ_bt),
                         block=shape.block)
        if dataflow == "mixed":
            e = min((estimate(sub, d, spec) for d in DATAFLOWS),
                    key=lambda est: (est.time_s, est.dataflow))
        else:
            e = estimate(sub, dataflow, spec)
        if agg is None:
            agg = dataclasses.replace(e)
        else:
            agg = DataflowEstimate(
                dataflow=dataflow, flops=agg.flops + e.flops,
                bytes_a=agg.bytes_a + e.bytes_a,
                bytes_b=agg.bytes_b + e.bytes_b,
                bytes_c=agg.bytes_c + e.bytes_c,
                bytes_psum=agg.bytes_psum + e.bytes_psum,
                compute_s=agg.compute_s + e.compute_s,
                memory_s=agg.memory_s + e.memory_s)
    merge = _merge_dram_bytes(
        merge_plan, _region_c_bytes(merge_plan, occ_a, occ_b, shape.block,
                                    budget.dtype_bytes))
    return DataflowEstimate(
        dataflow=dataflow, flops=agg.flops, bytes_a=agg.bytes_a,
        bytes_b=agg.bytes_b, bytes_c=agg.bytes_c,
        bytes_psum=agg.bytes_psum + merge, compute_s=agg.compute_s,
        memory_s=agg.memory_s + merge / spec.hbm_bw)


@dataclasses.dataclass
class ShardedSimReport:
    """``SimulatorBackend.report`` result for a sharded plan.

    ``per_shard`` holds one :class:`TierTraffic` per mesh shard; ``traffic``
    aggregates them with the interconnect tier (shards run in parallel, so
    aggregate cycles take the slowest shard plus the merge collective)."""

    dataflow: str
    axis: str
    shards: int
    per_shard: List
    traffic: TierTraffic

    @property
    def cycles(self) -> float:
        return self.traffic.cycles

    @property
    def ici_bytes(self) -> float:
        return self.traffic.ici_bytes


def _shard_tier(dataflow: str, tile, occ_at: np.ndarray, occ_bt: np.ndarray,
                block_shape: Tuple[int, int, int],
                budget: Optional[MemoryBudget],
                cfg: AcceleratorConfig, seed: int,
                tile_dataflows: Optional[Sequence[str]] = None
                ) -> TierTraffic:
    """One shard's tier traffic: tiled under its budget, single-tile else.

    ``tile_dataflows`` pins the shard's per-tile choices (mixed sharded
    plans price what each tile *actually* runs, not the argmin re-derive).
    """
    if budget is not None:
        return tiled_traffic(dataflow, occ_at, occ_bt, block_shape, budget,
                             cfg, seed, tile_dataflows=tile_dataflows)
    bm, bk, bn = block_shape
    dims = ((tile.i1 - tile.i0) * bm, (tile.k1 - tile.k0) * bk,
            (tile.j1 - tile.j0) * bn)
    res = _tile_result(dataflow, dims, _occ_density(occ_at),
                       _occ_density(occ_bt), cfg, seed)
    return _aggregate(dataflow, [res], 0.0, cfg)


def _aggregate_shards(per_shard: List[TierTraffic], ici: float,
                      cfg: AcceleratorConfig) -> TierTraffic:
    return TierTraffic(
        l1_bytes=float(sum(t.l1_bytes for t in per_shard)),
        l2_bytes=float(sum(t.l2_bytes for t in per_shard)),
        dram_bytes=float(sum(t.dram_bytes for t in per_shard)),
        merge_bytes=float(sum(t.merge_bytes for t in per_shard)),
        cycles=float(max(t.cycles for t in per_shard)
                     + ici / cfg.ici_bytes_per_cycle),
        tiles=int(sum(t.tiles for t in per_shard)),
        ici_bytes=float(ici))


def sharded_traffic(dataflow: str, occ_a: np.ndarray, occ_b: np.ndarray,
                    block_shape: Tuple[int, int, int], n_shards: int,
                    budget: Optional[MemoryBudget] = None,
                    cfg: AcceleratorConfig = PAPER_CONFIG, seed: int = 0,
                    axis: Optional[str] = None) -> TierTraffic:
    """Partition ``dataflow`` over ``n_shards`` and price the shard ensemble.

    The fourth (interconnect) tier carries the cross-shard merge: k-slab
    partitions all-reduce their partial C over the mesh; disjoint-output
    partitions move nothing.  Shards run in parallel, so cycles are the
    slowest shard's plus the collective — what mesh-aware selection
    policies rank (dataflow × partition) candidates by.
    """
    from ..dist.partition import Partitioner, merge_ici_bytes  # lazy: no cycle

    if n_shards <= 1:
        if budget is not None:
            return tiled_traffic(dataflow, occ_a, occ_b, block_shape, budget,
                                 cfg, seed)
        from .tiling import Tile

        mb, kb = occ_a.shape
        nb = occ_b.shape[1]
        return _shard_tier(dataflow, Tile(0, mb, 0, kb, 0, nb), occ_a, occ_b,
                           block_shape, None, cfg, seed)
    part = Partitioner(dataflow, axis=axis, shards=n_shards)
    per_shard = [
        _shard_tier(dataflow, tile, occ_at, occ_bt, block_shape, budget,
                    cfg, seed)
        for tile, occ_at, occ_bt in part.shard_bitmaps(occ_a, occ_b,
                                                       n_shards)]
    dt = budget.dtype_bytes if budget is not None else 4
    c_bytes = output_bytes(occ_a, occ_b,
                           (block_shape[0], block_shape[2]), dt)
    ici = merge_ici_bytes(part.axis, n_shards, c_bytes)
    return _aggregate_shards(per_shard, ici, cfg)


def sharded_plan_traffic(plan, cfg: AcceleratorConfig = PAPER_CONFIG,
                         seed: int = 0) -> ShardedSimReport:
    """Per-shard tier traffic + interconnect aggregation for a built
    :class:`repro_torch.dist.ShardedPlan` (the simulator backend's ``report``)."""
    from ..dist.partition import Partitioner   # lazy: dist imports memory

    # re-derive the shard slices through the partitioner so they are
    # zero-padded to the uniform shard extents, exactly as plan_sharded
    # built them (raw bitmap slicing would hand the tile schedulers
    # zero-size grids for padding-only shards)
    part = Partitioner(plan.dataflow, axis=plan.axis, shards=plan.n_shards)
    shard_choices: List[Optional[Tuple[str, ...]]] = [None] * plan.n_shards
    if plan.dataflow == "mixed":
        # each shard's per-tile choices come from its built sub-plan —
        # price what the tiles actually run, never the argmin re-derive
        shard_choices = [
            tuple(getattr(sub, "tile_dataflows", ()) or (sub.dataflow,))
            for sub in plan.plans]
    per_shard = [
        _shard_tier(plan.dataflow, tile, occ_at, occ_bt, plan.block_shape,
                    plan.budget, cfg, seed, tile_dataflows=choices)
        for (tile, occ_at, occ_bt), choices in zip(
            part.shard_bitmaps(plan.occ_a, plan.occ_b, plan.n_shards),
            shard_choices)]
    return ShardedSimReport(
        dataflow=plan.dataflow, axis=plan.axis, shards=plan.n_shards,
        per_shard=per_shard,
        traffic=_aggregate_shards(per_shard, float(plan.ici_bytes), cfg))


def sharded_estimate(shape: LayerShape, dataflow: str, n_shards: int,
                     budget: Optional[MemoryBudget] = None,
                     spec: Optional[DeviceSpec] = None,
                     occ_a: Optional[np.ndarray] = None,
                     occ_b: Optional[np.ndarray] = None,
                     axis: Optional[str] = None) -> float:
    """Analytic (roofline) seconds for the sharded execution.

    Shards run in parallel — the wall clock is the slowest shard's roofline
    time plus the cross-shard merge over the ``spec.ici_bw`` interconnect.
    The heuristic policy's mesh-aware oracle.
    """
    from ..dist.partition import Partitioner, merge_ici_bytes  # lazy

    spec = spec or DeviceSpec()
    mb, kb, nb = shape.grid
    if occ_a is None:
        occ_a = synthetic_occupancy((mb, kb), shape.density_a)
    if occ_b is None:
        occ_b = synthetic_occupancy((kb, nb), shape.density_b, seed=1)
    if n_shards <= 1:
        est = tiled_estimate(shape, dataflow, budget, spec, occ_a, occ_b) \
            if budget is not None else estimate(shape, dataflow, spec)
        return est.time_s
    part = Partitioner(dataflow, axis=axis, shards=n_shards)
    bm, bk, bn = shape.block
    worst = 0.0
    for tile, occ_at, occ_bt in part.shard_bitmaps(occ_a, occ_b, n_shards):
        sub = LayerShape(m=(tile.i1 - tile.i0) * bm,
                         k=(tile.k1 - tile.k0) * bk,
                         n=(tile.j1 - tile.j0) * bn,
                         density_a=_occ_density(occ_at),
                         density_b=_occ_density(occ_bt),
                         block=shape.block)
        est = tiled_estimate(sub, dataflow, budget, spec, occ_at, occ_bt) \
            if budget is not None else estimate(sub, dataflow, spec)
        worst = max(worst, est.time_s)
    dt = budget.dtype_bytes if budget is not None else 4
    c_bytes = output_bytes(occ_a, occ_b, (bm, bn), dt)
    ici = merge_ici_bytes(part.axis, n_shards, c_bytes)
    return worst + ici / spec.ici_bw
