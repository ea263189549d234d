"""``TiledPlan`` — per-tile :class:`FlexagonPlan`\\ s composed into one apply.

The out-of-core execution engine: when one SpMSpM's pattern exceeds the
:class:`repro_torch.memory.budget.MemoryBudget`, phase 1 partitions it with
the dataflow's :mod:`tile scheduler <repro_torch.memory.tiling>` and builds
one ordinary ``FlexagonPlan`` per tile (same frozen-layout / frozen-index-
plan machinery, same backend ``prepare``).  ``TiledPlan.apply`` then runs
the tiles one after another, each through its sub-plan's backend (on the
``cuda`` backend: one K1 or K2 launch per tile):

- disjoint-output tiles (IP C-tiles, Gust row bands, mixed tiles) add
  into their own output region, at static Python-int offsets;
- OP k-slabs each add their full-M/N partial product into the same fp32
  carry, in slab order — the MRN's merge phase lifted to tile granularity
  (:class:`repro_torch.memory.tiling.TileMergePlan` records the regions).

On backends that declare ``scan_streaming``, same-extent sub-plans (OP
slabs; a mixed plan's same-dataflow, same-extent tiles) are padded to one
extent at plan time, as the JAX package pads them for its ``lax.scan``
lanes: appended layout slots are never referenced by the frozen work
lists, and padded work entries aim one row past the grid and are dropped.
``scan_ok`` / ``scan_group_meta`` record those groups; ``apply`` runs every
tile the same way whether padded or not.

Mixed-dataflow plans (``dataflow="mixed"``): the mixed scheduler tiles on
the *output grid* (disjoint C regions, so per-tile dataflow choices stay
merge-compatible) and the selection policy's ``select_tile`` picks each
tile's dataflow on the tile's own occupancy slice.

Every tile, merge plan, per-tile dataflow and padded index plan is
byte-equal to the JAX package's ``repro.memory.tiled_plan``.  Phase-1
counters behave exactly like the untiled plan: all layout/index-plan
construction happens here at build time; ``apply`` uploads nothing.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..backends import get_backend
from ..backends.base import TABLE3_FORMATS
from ..core import dataflows as df
from ..core.formats import SparseFormat
from ..core.selector import DataflowEstimate, DeviceSpec, LayerShape, estimate
from .budget import MemoryBudget
from .tiling import Tile, TileMergePlan, schedule

__all__ = ["TiledPlan", "plan_tiled", "mixed_tile_dataflows"]


def _pack_bitmap(occ: np.ndarray) -> Tuple[bytes, Tuple[int, int]]:
    """Bitmap -> hashable (bytes, shape), as the JAX package keeps it."""
    return np.packbits(occ.astype(bool)).tobytes(), tuple(occ.shape)


def _unpack_bitmap(packed: Tuple[bytes, Tuple[int, int]]) -> np.ndarray:
    buf, shape = packed
    flat = np.unpackbits(np.frombuffer(buf, np.uint8))
    return flat[: shape[0] * shape[1]].reshape(shape).astype(bool)


def _pad_layout(layout, nnzb_max: int):
    """Append never-referenced slots so slab layouts share one shape.

    ``indptr`` keeps the real fiber boundaries, and the frozen work lists
    only index real slots, so the appended (0, 0) coordinates are inert —
    they just make ``compress`` emit a uniformly-shaped block stack.
    """
    pad = nnzb_max - layout.nnzb
    if pad == 0:
        return layout
    z = np.zeros(pad, np.int32)
    return dataclasses.replace(
        layout,
        rows=np.concatenate([np.asarray(layout.rows, np.int32), z]),
        cols=np.concatenate([np.asarray(layout.cols, np.int32), z]))


def _pad_stream(plan: df.StreamPlan, w_max: int, oob_row: int
                ) -> df.StreamPlan:
    """Pad a work list to ``w_max`` entries that land out of the grid.

    Padded entries gather slot 0 (a real block) but write their psum to
    block-row ``oob_row`` — one past the output grid — which every
    executor drops (the torch executor, and the kernels' pad-run skip).
    Numerics are untouched; shapes become uniform.
    """
    pad = w_max - int(plan.a_slot.shape[0])
    if pad == 0:
        return plan
    z = np.zeros(pad, np.int32)
    return df.StreamPlan(
        np.concatenate([np.asarray(plan.a_slot, np.int32), z]),
        np.concatenate([np.asarray(plan.b_slot, np.int32), z]),
        np.concatenate([np.asarray(plan.ci, np.int32),
                        np.full(pad, oob_row, np.int32)]),
        np.concatenate([np.asarray(plan.cj, np.int32), z]),
        plan.seg_ptr, plan.order)


def _pad_ip(plan: df.IPPlan, p_max: int) -> df.IPPlan:
    """Pad an IP intersection plan's pair axis to ``p_max`` slots.

    Appended pairs point at slot 0 but are masked out by ``npairs`` in the
    executor, so numerics are untouched; shapes become uniform across the
    lane's sub-plans.
    """
    pad = p_max - plan.pair_a.shape[2]
    if pad == 0 and plan.max_pairs == p_max:
        return plan
    wid = ((0, 0), (0, 0), (0, pad))
    return df.IPPlan(np.pad(np.asarray(plan.pair_a, np.int32), wid),
                     np.pad(np.asarray(plan.pair_b, np.int32), wid),
                     np.asarray(plan.npairs, np.int32), p_max)


def _build_sub_plan(dataflow: str, occ_at: np.ndarray, occ_bt: np.ndarray,
                    block_shape: Tuple[int, int, int], backend,
                    fingerprint: str, device: torch.device, spec: DeviceSpec,
                    est: Optional[DataflowEstimate] = None):
    """One tile sub-``FlexagonPlan`` on an occupancy slice (phase 1).

    The single construction path for every sub-plan of a tiled or mixed
    plan: layouts from the slice bitmaps, the dataflow's index plan, and a
    per-slice estimate unless the caller supplies a shared one.  ``aux`` is
    left for the caller's ``backend.prepare`` pass — lanes pad first.
    """
    from ..api import CompressionLayout, FlexagonPlan, _build_index_plan

    bm, bk, bn = block_shape
    fmt_a, fmt_b = TABLE3_FORMATS[dataflow]
    shape_a = (occ_at.shape[0] * bm, occ_at.shape[1] * bk)
    shape_b = (occ_bt.shape[0] * bk, occ_bt.shape[1] * bn)
    a_layout = CompressionLayout.from_bitmap(occ_at, shape_a, (bm, bk),
                                             fmt_a, device)
    b_layout = CompressionLayout.from_bitmap(occ_bt, shape_b, (bk, bn),
                                             fmt_b, device)
    index_plan = _build_index_plan(dataflow, a_layout, b_layout)
    if est is None:
        est = estimate(
            LayerShape(m=shape_a[0], k=shape_a[1], n=shape_b[1],
                       density_a=float(occ_at.mean()) if occ_at.size else 0.0,
                       density_b=float(occ_bt.mean()) if occ_bt.size else 0.0,
                       block=tuple(block_shape)), dataflow, spec)
    return FlexagonPlan(
        dataflow=dataflow, a_layout=a_layout, b_layout=b_layout,
        index_plan=index_plan, aux=None, estimate=est,
        fingerprint=fingerprint,
        shapes=(shape_a[0], shape_a[1], shape_b[1]),
        block_shape=tuple(block_shape), backend=backend.name, device=device)


def _pad_lane(plans: List[Any], oob_row: int) -> Tuple[List[Any], bool]:
    """Pad one lane's sub-plans to shared layout and index-plan extents.

    Returns the padded plans and whether the lane has any work: an
    all-empty lane is not a lane (``scan_ok`` / ``scan_group_meta`` leave
    it out, as the JAX package's unrolled loop does)."""
    nnz_a = max(p.a_layout.nnzb for p in plans)
    nnz_b = max(p.b_layout.nnzb for p in plans)
    if isinstance(plans[0].index_plan, df.IPPlan):
        p_max = max(int(p.index_plan.pair_a.shape[2]) for p in plans)
        pad = [_pad_ip(p.index_plan, p_max) for p in plans]
        busy = True
    else:
        w_max = max(int(p.index_plan.a_slot.shape[0]) for p in plans)
        pad = [_pad_stream(p.index_plan, w_max, oob_row) for p in plans]
        busy = w_max > 0
    return [dataclasses.replace(p, a_layout=_pad_layout(p.a_layout, nnz_a),
                                b_layout=_pad_layout(p.b_layout, nnz_b),
                                index_plan=ip)
            for p, ip in zip(plans, pad)], busy


def _prepared(plans: List[Any], backend) -> List[Any]:
    return [dataclasses.replace(p, aux=backend.prepare(p)) for p in plans]


def mixed_tile_dataflows(occ_a: np.ndarray, occ_b: np.ndarray,
                         block_shape: Tuple[int, int, int],
                         budget: MemoryBudget, *, backend, policy=None,
                         spec: DeviceSpec = DeviceSpec(),
                         fingerprint: str = "",
                         tiles: Optional[List[Tile]] = None,
                         device=None) -> Tuple[str, ...]:
    """Per-tile dataflow choices for one ``"mixed"`` schedule (phase 1).

    Evaluates the selection policy's ``select_tile`` on every tile's own
    occupancy slice.  Deterministic for a fixed (pattern, budget, policy,
    backend) — :class:`repro_torch.api.PlanCache` keys mixed plans under
    exactly this tuple, so two policies that agree tile-by-tile share one
    plan.  ``device`` is where a measuring policy times its candidates.
    """
    from ..backends.base import allowed_dataflows
    from ..backends.policies import SelectionContext, get_policy

    backend = get_backend(backend)
    policy = get_policy(policy, "mixed")
    if tiles is None:
        tiles, _ = schedule("mixed", occ_a, occ_b, block_shape, budget)
    allowed = allowed_dataflows(backend, tuple(block_shape))
    if not allowed:
        raise ValueError(f"backend {backend.name!r} supports no dataflow "
                         f"at block_shape={tuple(block_shape)}")
    bm, bk, bn = block_shape
    choices = []
    for idx, tile in enumerate(tiles):
        occ_at = tile.a_slice(occ_a)
        occ_bt = tile.b_slice(occ_b)
        shape = LayerShape(
            m=(tile.i1 - tile.i0) * bm, k=(tile.k1 - tile.k0) * bk,
            n=(tile.j1 - tile.j0) * bn,
            density_a=float(occ_at.mean()) if occ_at.size else 0.0,
            density_b=float(occ_bt.mean()) if occ_bt.size else 0.0,
            block=tuple(block_shape))
        ctx = SelectionContext(
            shape=shape, block_shape=tuple(block_shape), occ_a=occ_at,
            occ_b=occ_bt, fingerprint=f"{fingerprint}/tile{idx}",
            backend=backend, spec=spec, allowed=allowed, tile=tile,
            device=device)
        t_sel = obs.now_ns()
        with obs.span("plan.select_tile", tile=idx,
                      policy=type(policy).__name__):
            choices.append(policy.select_tile(ctx))
        obs.get_registry().histogram("policy.select_tile_s").observe(
            (obs.now_ns() - t_sel) / 1e9)
    return tuple(choices)


@dataclasses.dataclass(frozen=True)
class TiledPlan:
    """Phase-1 output for one SpMSpM that does not fit on chip.

    Mirrors the :class:`repro_torch.api.FlexagonPlan` surface (``apply`` /
    ``__call__`` / ``dataflow`` / ``out_major`` / ``matches`` /
    ``with_backend`` / ``pack_a`` / ``pack_b`` / ``device``) so callers can
    hold either.  ``plans`` are ordinary per-tile ``FlexagonPlan``\\ s —
    padded to one extent where they form a lane; ``tiles`` and
    ``merge_plan`` are the static schedule; the operand bitmaps ride packed
    so traffic reports can re-derive tile slices.
    """

    dataflow: str                            # a dataflow name, or "mixed"
    tiles: Tuple[Tile, ...]
    merge_plan: TileMergePlan
    plans: Tuple[Any, ...]                   # per-tile FlexagonPlans
    shapes: Tuple[int, int, int]
    block_shape: Tuple[int, int, int]
    backend: str
    budget: MemoryBudget
    fingerprint: str
    device: torch.device
    scan_ok: bool                            # OP slabs form one padded lane
    occ_a_packed: Tuple[bytes, Tuple[int, int]]
    occ_b_packed: Tuple[bytes, Tuple[int, int]]
    #: dataflow executed by each tile; ``(dataflow,) * n_tiles`` for
    #: single-dataflow plans, the policy's per-tile choices for "mixed"
    tile_dataflows: Tuple[str, ...] = ()
    #: mixed groups: ((dataflow, tile_indices), ...) per group whose
    #: sub-plans were padded to one shape (as the JAX package's lanes)
    scan_group_meta: Tuple[Tuple[str, Tuple[int, ...]], ...] = ()

    def __post_init__(self):
        if not self.tile_dataflows:
            object.__setattr__(self, "tile_dataflows",
                               (self.dataflow,) * len(self.tiles))

    # -- phase-1 byproducts ----------------------------------------------
    @property
    def n_tiles(self) -> int:
        return len(self.tiles)

    @property
    def is_mixed(self) -> bool:
        return self.dataflow == "mixed"

    @property
    def tile_histogram(self) -> Dict[str, int]:
        """How many tiles run each dataflow (the "mixed" telemetry view)."""
        return dict(Counter(self.tile_dataflows))

    @property
    def groups(self) -> Dict[str, Tuple[int, ...]]:
        """Tile indices per dataflow, in execution order."""
        out: Dict[str, List[int]] = {}
        for i, d in enumerate(self.tile_dataflows):
            out.setdefault(d, []).append(i)
        return {d: tuple(v) for d, v in out.items()}

    @property
    def out_major(self) -> str:
        # mixed tiles assemble a dense C from disjoint regions; report the
        # row-major default that every Table 4 transition can ingest
        if self.is_mixed:
            return "csr"
        return df.OUTPUT_MAJOR[self.dataflow]

    @property
    def formats(self):
        # packing is a storage convenience for tiled plans (apply densifies
        # before slicing), so mixed plans default to row-major block storage
        if self.is_mixed:
            return (SparseFormat.BCSR, SparseFormat.BCSR)
        return TABLE3_FORMATS[self.dataflow]

    @property
    def occ_a(self) -> np.ndarray:
        return _unpack_bitmap(self.occ_a_packed)

    @property
    def occ_b(self) -> np.ndarray:
        return _unpack_bitmap(self.occ_b_packed)

    @property
    def estimate(self) -> DataflowEstimate:
        """Aggregate over tiles (re-reads across tiles count once per tile)."""
        ests = [p.estimate for p in self.plans]
        return DataflowEstimate(
            dataflow=self.dataflow,
            flops=sum(e.flops for e in ests),
            bytes_a=sum(e.bytes_a for e in ests),
            bytes_b=sum(e.bytes_b for e in ests),
            bytes_c=sum(e.bytes_c for e in ests),
            bytes_psum=sum(e.bytes_psum for e in ests),
            compute_s=sum(e.compute_s for e in ests),
            memory_s=sum(e.memory_s for e in ests),
        )

    def matches(self, a, b) -> bool:
        """Do these operands carry the planned (whole-operation) pattern?"""
        from ..api import _fingerprint, _pattern_of

        (m, k), occ_a = _pattern_of(a, self.block_shape[:2])
        (_, n), occ_b = _pattern_of(b, self.block_shape[1:])
        return _fingerprint(occ_a, occ_b, (m, k, n),
                            self.block_shape) == self.fingerprint

    def with_backend(self, backend) -> "TiledPlan":
        """Re-target onto another backend.

        Backends that run OP slabs as one lane carry padded slab plans;
        re-targeting to a backend without ``scan_streaming`` (or back)
        re-tiles from the stored bitmaps so each substrate gets the plan
        shape it expects.  Mixed plans always rebuild — with the per-tile
        choices *pinned*, so re-targeting never re-runs the policy.
        """
        be = get_backend(backend)
        kw = dict(occ_a=self.occ_a, occ_b=self.occ_b, shapes=self.shapes,
                  block_shape=self.block_shape, budget=self.budget,
                  backend=be, fingerprint=self.fingerprint,
                  device=self.device)
        if self.is_mixed:
            return plan_tiled(dataflow="mixed",
                              tile_dataflows=self.tile_dataflows, **kw)
        if self.scan_ok != (self.dataflow[:-2] == "op" and be.scan_streaming):
            return plan_tiled(dataflow=self.dataflow, **kw)
        plans = tuple(p.with_backend(be) for p in self.plans)
        if self.scan_ok:
            # re-preparing per plan makes aux non-uniform again; re-pad
            be.uniform_aux(list(plans))
        return dataclasses.replace(self, backend=be.name, plans=plans)

    # -- packing (host-side conveniences, phase-1 style) ------------------
    def _pack(self, x, fmt, block_shape):
        from ..api import SparseOperand

        if isinstance(x, SparseOperand):
            x = x.todense()
        return SparseOperand.from_dense(x, format=fmt,
                                        block_shape=block_shape,
                                        device=self.device)

    def pack_a(self, a):
        """Whole-operand compression in the planned A format.

        Tiles ingest dense slices, so packing is a storage convenience here
        (``apply`` densifies packed operands before slicing)."""
        return self._pack(a, self.formats[0], self.block_shape[:2])

    def pack_b(self, b):
        return self._pack(b, self.formats[1], self.block_shape[1:])

    # -- phase 2 ---------------------------------------------------------
    def _densify(self, x) -> torch.Tensor:
        from ..api import SparseOperand

        if isinstance(x, SparseOperand):
            x = x.todense()
        return torch.as_tensor(x, device=self.device).float()

    def _traffic_attrs(self) -> Dict[str, Any]:
        """Tier-traffic span attributes, computed once per plan.

        Only evaluated when tracing is on (the estimator is host work) and
        memoized on the plan object so repeated traced applies pay a single
        estimation.
        """
        cached = self.__dict__.get("_tier_attrs_cache")
        if cached is None:
            from .traffic import plan_traffic

            t = plan_traffic(self).traffic  # lint: host-ok (trace-gated)
            cached = {"l1_bytes": t.l1_bytes, "l2_bytes": t.l2_bytes,
                      "dram_bytes": t.dram_bytes,
                      "merge_bytes": t.merge_bytes}
            reg = obs.get_registry()
            for tier in ("l1", "l2", "dram"):
                reg.gauge(f"tier.{tier}_bytes").set(cached[f"{tier}_bytes"])
            object.__setattr__(self, "_tier_attrs_cache", cached)
        return cached

    def apply(self, a, b, out_dtype=torch.float32) -> torch.Tensor:
        """Execute C = A @ B tile by tile, with zero host-side plan work."""
        if obs.enabled():
            with obs.span("memory.tiled.apply", dataflow=self.dataflow,
                          tiles=self.n_tiles, **self._traffic_attrs()):
                return self._apply_inner(a, b, out_dtype)
        return self._apply_inner(a, b, out_dtype)

    def _apply_inner(self, a, b, out_dtype=torch.float32) -> torch.Tensor:
        m, k, n = self.shapes
        bm, bk, bn = self.block_shape
        mb = max(t.i1 for t in self.tiles)
        kb = max(t.k1 for t in self.tiles)
        nb = max(t.j1 for t in self.tiles)
        a_d = self._densify(a)
        b_d = self._densify(b)
        a_d = torch.nn.functional.pad(
            a_d, (0, kb * bk - a_d.shape[1], 0, mb * bm - a_d.shape[0]))
        b_d = torch.nn.functional.pad(
            b_d, (0, nb * bn - b_d.shape[1], 0, kb * bk - b_d.shape[0]))

        # OP slabs and mixed tiles are tiles too: a slab's full-M/N region
        # sums into the carry in slab order, a mixed tile's region is
        # disjoint from the others' (add into zeros == set)
        out = torch.zeros((mb * bm, nb * bn), dtype=torch.float32,
                          device=a_d.device)
        for t, plan in zip(self.tiles, self.plans):
            a_s = a_d[t.i0 * bm: t.i1 * bm, t.k0 * bk: t.k1 * bk]
            b_s = b_d[t.k0 * bk: t.k1 * bk, t.j0 * bn: t.j1 * bn]
            out[t.i0 * bm: t.i1 * bm, t.j0 * bn: t.j1 * bn] += \
                plan.apply(a_s, b_s, torch.float32)
        return out[:m, :n].to(out_dtype)

    __call__ = apply


def plan_tiled(*, dataflow: str, occ_a: np.ndarray, occ_b: np.ndarray,
               shapes: Tuple[int, int, int],
               block_shape: Tuple[int, int, int],
               budget: MemoryBudget, backend, fingerprint: str,
               device, spec: DeviceSpec = DeviceSpec(), policy=None,
               tile_dataflows: Optional[Tuple[str, ...]] = None
               ) -> Optional[TiledPlan]:
    """Phase 1 for the out-of-core case.

    Returns ``None`` when the scheduler covers the operation with a single
    budget-fitting tile (the caller then builds an ordinary untiled plan).
    ``dataflow="mixed"`` routes to the heterogeneous planner: ``policy``
    prices each tile (``select_tile``), or ``tile_dataflows`` pins the
    per-tile choices outright (re-targeting, reproducibility).
    """
    device = torch.device(device)
    if dataflow == "mixed":
        return _plan_mixed(occ_a=occ_a, occ_b=occ_b, shapes=shapes,
                           block_shape=block_shape, budget=budget,
                           backend=backend, fingerprint=fingerprint,
                           device=device, spec=spec, policy=policy,
                           tile_dataflows=tile_dataflows)

    with obs.span("plan.schedule", dataflow=dataflow) as _sp:
        tiles, merge_plan = schedule(dataflow, occ_a, occ_b, block_shape,
                                     budget)
        _sp.set(tiles=len(tiles))
    if len(tiles) <= 1:
        return None

    bm, bk, bn = block_shape
    scan_capable = dataflow[:-2] == "op" and backend.scan_streaming

    # pad the bitmap grids out to the tile extents (OP's uniform slabs may
    # run past the logical K grid; the padding is empty fibers)
    mb = max(t.i1 for t in tiles)
    kb = max(t.k1 for t in tiles)
    nb = max(t.j1 for t in tiles)
    occ_a_p = np.zeros((mb, kb), dtype=bool)
    occ_a_p[: occ_a.shape[0], : occ_a.shape[1]] = occ_a
    occ_b_p = np.zeros((kb, nb), dtype=bool)
    occ_b_p[: occ_b.shape[0], : occ_b.shape[1]] = occ_b

    shared_est = None
    if scan_capable:
        # the slab plans form one lane: one fingerprint and one
        # (slab-shaped) estimate, as in the JAX package
        ke = tiles[0].k1 - tiles[0].k0
        shared_est = estimate(
            LayerShape(m=mb * bm, k=ke * bk, n=nb * bn,
                       density_a=float(occ_a.mean()) if occ_a.size else 0.0,
                       density_b=float(occ_b.mean()) if occ_b.size else 0.0,
                       block=tuple(block_shape)), dataflow, spec)

    plans: List[Any] = []
    for idx, tile in enumerate(tiles):
        fp = f"{fingerprint}/opslab" if scan_capable \
            else f"{fingerprint}/t{idx}"
        plans.append(_build_sub_plan(
            dataflow, tile.a_slice(occ_a_p), tile.b_slice(occ_b_p),
            tuple(block_shape), backend, fp, device, spec, est=shared_est))

    scan_ok = False
    if scan_capable:
        oob_row = nb if dataflow.endswith("_n") else mb   # transposed grid
        plans, scan_ok = _pad_lane(plans, oob_row)

    plans = _prepared(plans, backend)
    if scan_ok:
        # backend aux schedules must share extents too
        backend.uniform_aux(plans)

    return TiledPlan(
        dataflow=dataflow, tiles=tuple(tiles), merge_plan=merge_plan,
        plans=tuple(plans), shapes=tuple(shapes),
        block_shape=tuple(block_shape), backend=backend.name, budget=budget,
        fingerprint=fingerprint, device=device, scan_ok=scan_ok,
        occ_a_packed=_pack_bitmap(occ_a), occ_b_packed=_pack_bitmap(occ_b))


def _plan_mixed(*, occ_a: np.ndarray, occ_b: np.ndarray,
                shapes: Tuple[int, int, int],
                block_shape: Tuple[int, int, int], budget: MemoryBudget,
                backend, fingerprint: str, device: torch.device,
                spec: DeviceSpec, policy,
                tile_dataflows: Optional[Tuple[str, ...]]
                ) -> Optional[TiledPlan]:
    """Phase 1 for heterogeneous per-tile dataflows.

    The mixed scheduler tiles the output grid (disjoint C regions, full K
    per tile), the policy's ``select_tile`` picks each tile's dataflow on
    the tile's own occupancy slice, and same-dataflow tiles are grouped into
    lanes: a group whose tiles share one extent is padded to one sub-plan
    shape on scan-capable backends, everything else runs tile by tile.
    Returns ``None`` for a single-tile schedule — there is nothing to mix,
    the caller degenerates to a policy-chosen single-dataflow plan.
    """
    with obs.span("plan.schedule", dataflow="mixed") as _sp:
        tiles, merge_plan = schedule("mixed", occ_a, occ_b, block_shape,
                                     budget)
        _sp.set(tiles=len(tiles))
    if len(tiles) <= 1:
        return None
    if tile_dataflows is None:
        tile_dataflows = mixed_tile_dataflows(
            occ_a, occ_b, block_shape, budget, backend=backend,
            policy=policy, spec=spec, fingerprint=fingerprint, tiles=tiles,
            device=device)
    if len(tile_dataflows) != len(tiles):
        raise ValueError(f"got {len(tile_dataflows)} per-tile dataflows for "
                         f"{len(tiles)} tiles")

    bm, bk, bn = block_shape
    groups: Dict[str, List[int]] = {}
    for idx, d in enumerate(tile_dataflows):
        groups.setdefault(d, []).append(idx)

    plans: List[Any] = [None] * len(tiles)
    scan_group_meta: List[Tuple[str, Tuple[int, ...]]] = []
    for d, idxs in groups.items():
        extents = {(tiles[i].i1 - tiles[i].i0, tiles[i].j1 - tiles[i].j0)
                   for i in idxs}
        lane = backend.scan_streaming and len(idxs) > 1 and len(extents) == 1
        shared_est = None
        if lane:
            # lane sub-plans share one (group-uniform) estimate and one
            # fingerprint, like OP slabs
            t0 = tiles[idxs[0]]
            shared_est = estimate(
                LayerShape(
                    m=(t0.i1 - t0.i0) * bm, k=(t0.k1 - t0.k0) * bk,
                    n=(t0.j1 - t0.j0) * bn,
                    density_a=float(occ_a.mean()) if occ_a.size else 0.0,
                    density_b=float(occ_b.mean()) if occ_b.size else 0.0,
                    block=tuple(block_shape)), d, spec)
        group_plans: List[Any] = []
        for i in idxs:
            tile = tiles[i]
            fp = f"{fingerprint}/mixed/{d}" if lane \
                else f"{fingerprint}/t{i}"
            group_plans.append(_build_sub_plan(
                d, tile.a_slice(occ_a), tile.b_slice(occ_b),
                tuple(block_shape), backend, fp, device, spec,
                est=shared_est))
        if lane:
            t0 = tiles[idxs[0]]
            # N-stationary executors scatter on the transposed grid
            oob = (t0.j1 - t0.j0) if d.endswith("_n") else (t0.i1 - t0.i0)
            group_plans, lane = _pad_lane(group_plans, oob)
        group_plans = _prepared(group_plans, backend)
        if lane:
            # backend aux must share extents across the lane's members
            backend.uniform_aux(group_plans)
            scan_group_meta.append((d, tuple(idxs)))
        for i, p in zip(idxs, group_plans):
            plans[i] = p

    return TiledPlan(
        dataflow="mixed", tiles=tuple(tiles), merge_plan=merge_plan,
        plans=tuple(plans), shapes=tuple(shapes),
        block_shape=tuple(block_shape), backend=backend.name, budget=budget,
        fingerprint=fingerprint, device=device, scan_ok=False,
        occ_a_packed=_pack_bitmap(occ_a), occ_b_packed=_pack_bitmap(occ_b),
        tile_dataflows=tuple(tile_dataflows),
        scan_group_meta=tuple(scan_group_meta))
