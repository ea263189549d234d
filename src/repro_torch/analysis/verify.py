"""``verify_plan`` — structural invariant checks over plans.

The port of ``repro.analysis.verify``, the pre-execution gate of the
analysis layer: given any plan the phase-1 mapper can produce —
:class:`repro_torch.api.FlexagonPlan`, :class:`repro_torch.memory.TiledPlan`,
:class:`repro_torch.dist.ShardedPlan`, :class:`repro_torch.models.moe.MoEPlan`
— re-derive every invariant the executors rely on from the plan's own
stored pattern data and report violations as typed
:class:`PlanDiagnostic`\\ s, with the JAX package's codes and severities:

- **coverage / disjointness** — the tiles (or shards) of a composed plan
  cover every (i, k, j) cell of the padded block grid exactly once, so each
  ``A[i,k]·B[k,j]`` block product is computed once and only once;
- **merge compatibility per family** — disjoint-output families (IP
  C-tiles, Gust row bands, mixed output-grid tiles) must have exactly one
  contribution per output region; OP k-slabs must each span the whole
  output (their partial sums add up);
- **pad validity** — padded sub-plans carry work entries that *must* aim
  out of the local grid (the executors drop them); a pad entry that lands
  in bounds silently corrupts C;
- **format / shape consistency** — layouts match Table 3's formats for the
  plan's dataflow, shapes and block shapes agree across composed sub-plans;
- **backend capability** — a plan whose structure needs ``scan_streaming``
  (padded OP slab lanes) must name a backend that declares it.  The port
  has no ``collective_merge``: a sharded plan's path follows its mesh
  (:attr:`repro_torch.dist.ShardedPlan.path`), so the check is that a
  collective plan lives on the kind of device its mesh's ranks run;
- **cache identity** — the stored fingerprint equals the fingerprint
  recomputed from the plan's own occupancy bitmaps, so a
  :class:`repro_torch.api.PlanCache` key can never disagree with plan
  content.

Backends that declare ``schedule_aux_key`` (``cuda``) also get the static
schedule checker (:mod:`repro_torch.analysis.schedule`) over the stored
schedule and the device tables K1/K2 read.  A plan on a process-group mesh
is verified whole — every shard — on every rank.

All checks are host-side numpy over phase-1 artifacts (the device tables
are read back once), and ``repro_torch.api.PHASE1_COUNTERS`` are
snapshotted and restored so verification is invisible to the
plan-once/execute-many accounting.
"""
from __future__ import annotations

import math
from typing import Any, List, Optional, Tuple

import numpy as np

from ..api import PHASE1_COUNTERS, FlexagonPlan, _fingerprint
from ..backends import get_backend
from ..backends.base import TABLE3_FORMATS, allowed_dataflows
from ..core import dataflows as df
from ..memory.tiled_plan import TiledPlan
from ..memory.tiling import Tile, TileMergePlan
from .diagnostics import (ERROR, INFO, PlanDiagnostic,
                          PlanVerificationError, errors_of)

__all__ = ["verify_plan", "verify_cache"]

_MOE_STRATEGIES = ("einsum", "scatter", "sort")


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _diag(diags: List[PlanDiagnostic], code: str, severity: str,
          message: str, location: str, hint: Optional[str] = None) -> None:
    diags.append(PlanDiagnostic(code=code, severity=severity, message=message,
                                location=location, hint=hint))


# ---------------------------------------------------------------------------
# FlexagonPlan (leaf) checks
# ---------------------------------------------------------------------------


def _scatter_grid(plan: FlexagonPlan) -> Tuple[int, int]:
    """(rows, cols) of the executed scatter grid.

    N-stationary executors run the transposed problem (C = (Bᵀ Aᵀ)ᵀ), so
    their work lists scatter on the (Nb, Mb) grid.
    """
    m, k, n = plan.shapes
    bm, bk, bn = plan.block_shape
    mb, nb = _ceil_div(m, bm), _ceil_div(n, bn)
    return (nb, mb) if plan.dataflow.endswith("_n") else (mb, nb)


def _check_layout(layout, shape, block_shape, fmt, diags, loc) -> None:
    if layout.fmt is not fmt:
        _diag(diags, "format-mismatch", ERROR,
              f"layout format {layout.fmt} does not match Table 3's "
              f"{fmt} for this dataflow", loc,
              hint="rebuild the plan via flexagon_plan; layouts must carry "
                   "the dataflow's planned format")
        return
    if tuple(layout.shape) != tuple(shape):
        _diag(diags, "shape-mismatch", ERROR,
              f"layout shape {tuple(layout.shape)} != planned "
              f"{tuple(shape)}", loc)
        return
    if tuple(layout.block_shape) != tuple(block_shape):
        _diag(diags, "shape-mismatch", ERROR,
              f"layout block_shape {tuple(layout.block_shape)} != planned "
              f"{tuple(block_shape)}", loc)
        return
    rows = np.asarray(layout.rows)
    cols = np.asarray(layout.cols)
    indptr = np.asarray(layout.indptr)
    gr = _ceil_div(shape[0], block_shape[0])
    gc = _ceil_div(shape[1], block_shape[1])
    if rows.shape != cols.shape:
        _diag(diags, "coord-bounds", ERROR,
              f"rows/cols length mismatch: {rows.shape} vs {cols.shape}", loc)
        return
    if rows.size and (rows.min() < 0 or rows.max() >= gr
                      or cols.min() < 0 or cols.max() >= gc):
        _diag(diags, "coord-bounds", ERROR,
              f"block coordinates out of the ({gr}, {gc}) grid", loc)
    if indptr[0] != 0 or np.any(np.diff(indptr) < 0):
        _diag(diags, "indptr-invalid", ERROR,
              "indptr must start at 0 and be non-decreasing", loc)
    elif int(indptr[-1]) > rows.size:
        _diag(diags, "indptr-invalid", ERROR,
              f"indptr[-1]={int(indptr[-1])} exceeds the {rows.size} stored "
              "coordinate slots", loc)
    fibers = gr if layout.fmt.name == "BCSR" else gc
    if indptr.shape[0] != fibers + 1:
        _diag(diags, "indptr-invalid", ERROR,
              f"indptr has {indptr.shape[0]} entries for {fibers} fibers",
              loc)


def _check_stream_plan(plan: FlexagonPlan, diags, loc) -> None:
    sp = plan.index_plan
    rows_g, cols_g = _scatter_grid(plan)
    # in the transposed (N-stationary) execution the leading operand is B
    a_stored = (plan.b_layout if plan.dataflow.endswith("_n")
                else plan.a_layout).rows.shape[0]
    b_stored = (plan.a_layout if plan.dataflow.endswith("_n")
                else plan.b_layout).rows.shape[0]
    ci = np.asarray(sp.ci)
    cj = np.asarray(sp.cj)
    a_slot = np.asarray(sp.a_slot)
    b_slot = np.asarray(sp.b_slot)
    seg = np.asarray(sp.seg_ptr)
    if seg.size == 0 or seg[0] != 0 or np.any(np.diff(seg) < 0):
        _diag(diags, "indptr-invalid", ERROR,
              "StreamPlan.seg_ptr must start at 0 and be non-decreasing",
              f"{loc}.index_plan")
        return
    real = int(seg[-1])
    total = int(ci.shape[0])
    if real > total:
        _diag(diags, "indptr-invalid", ERROR,
              f"seg_ptr[-1]={real} exceeds the {total} stored work entries",
              f"{loc}.index_plan")
        return
    if real:
        if ci[:real].min() < 0 or ci[:real].max() >= rows_g \
                or cj[:real].min() < 0 or cj[:real].max() >= cols_g:
            _diag(diags, "coord-bounds", ERROR,
                  f"real work entries scatter outside the ({rows_g}, "
                  f"{cols_g}) output grid", f"{loc}.index_plan")
        if (a_stored and a_slot[:real].max() >= a_stored) \
                or (b_stored and b_slot[:real].max() >= b_stored) \
                or a_slot[:real].min() < 0 or b_slot[:real].min() < 0:
            _diag(diags, "coord-bounds", ERROR,
                  "work entries gather operand slots beyond the stored "
                  "block count", f"{loc}.index_plan")
    if real < total and ci[real:].min() < rows_g:
        # the whole point of the padding contract: padded entries must
        # scatter out of the grid so JAX drops them
        _diag(diags, "pad-inbounds", ERROR,
              f"{int((ci[real:] < rows_g).sum())} padded work entries "
              f"scatter INSIDE the ({rows_g}, {cols_g}) grid — their psums "
              "would corrupt C", f"{loc}.index_plan",
              hint="lane padding must write to one row past the local "
                   "grid (see repro_torch.memory.tiled_plan._pad_stream)")


def _check_ip_plan(plan: FlexagonPlan, diags, loc) -> None:
    ip = plan.index_plan
    rows_g, cols_g = _scatter_grid(plan)
    pair_a = np.asarray(ip.pair_a)
    pair_b = np.asarray(ip.pair_b)
    npairs = np.asarray(ip.npairs)
    if pair_a.shape != pair_b.shape or npairs.shape != pair_a.shape[:2]:
        _diag(diags, "ip-plan-invalid", ERROR,
              f"pair array shapes disagree: {pair_a.shape} vs "
              f"{pair_b.shape} vs npairs {npairs.shape}",
              f"{loc}.index_plan")
        return
    if pair_a.shape[:2] != (rows_g, cols_g):
        _diag(diags, "ip-plan-invalid", ERROR,
              f"pair grid {pair_a.shape[:2]} != executed output grid "
              f"({rows_g}, {cols_g})", f"{loc}.index_plan")
        return
    if pair_a.shape[2] != ip.max_pairs:
        _diag(diags, "ip-plan-invalid", ERROR,
              f"pair axis {pair_a.shape[2]} != max_pairs {ip.max_pairs}",
              f"{loc}.index_plan")
    if npairs.size and (npairs.min() < 0 or npairs.max() > ip.max_pairs):
        _diag(diags, "ip-plan-invalid", ERROR,
              "npairs out of [0, max_pairs]", f"{loc}.index_plan")
    a_stored = (plan.b_layout if plan.dataflow.endswith("_n")
                else plan.a_layout).rows.shape[0]
    b_stored = (plan.a_layout if plan.dataflow.endswith("_n")
                else plan.b_layout).rows.shape[0]
    if pair_a.size and ((a_stored and pair_a.max() >= a_stored)
                        or (b_stored and pair_b.max() >= b_stored)
                        or pair_a.min() < 0 or pair_b.min() < 0):
        _diag(diags, "coord-bounds", ERROR,
              "intersection pairs gather operand slots beyond the stored "
              "block count", f"{loc}.index_plan")


def _layout_bitmap(layout, shape, block_shape) -> np.ndarray:
    """Occupancy bitmap from a layout's *real* (unpadded) coordinates."""
    gr = _ceil_div(shape[0], block_shape[0])
    gc = _ceil_div(shape[1], block_shape[1])
    occ = np.zeros((gr, gc), dtype=bool)
    real = int(np.asarray(layout.indptr)[-1])
    occ[np.asarray(layout.rows)[:real], np.asarray(layout.cols)[:real]] = True
    return occ


def _check_backend(plan, diags, loc) -> Optional[Any]:
    try:
        return get_backend(plan.backend)
    except (KeyError, ValueError):
        _diag(diags, "backend-unknown", ERROR,
              f"backend {plan.backend!r} is not in the registry", loc,
              hint="register it via repro_torch.backends.register_backend "
                   "before executing this plan")
        return None


def _verify_flexagon(plan: FlexagonPlan, diags, loc, *,
                     toplevel: bool) -> None:
    if plan.dataflow not in df.DATAFLOWS:
        _diag(diags, "unknown-dataflow", ERROR,
              f"dataflow {plan.dataflow!r} is not one of {df.DATAFLOWS}",
              loc)
        return
    m, k, n = plan.shapes
    bm, bk, bn = plan.block_shape
    fmt_a, fmt_b = TABLE3_FORMATS[plan.dataflow]
    _check_layout(plan.a_layout, (m, k), (bm, bk), fmt_a, diags,
                  f"{loc}.a_layout")
    _check_layout(plan.b_layout, (k, n), (bk, bn), fmt_b, diags,
                  f"{loc}.b_layout")
    if errors_of(diags):
        return                       # index-plan checks need sane layouts
    if isinstance(plan.index_plan, df.IPPlan):
        _check_ip_plan(plan, diags, loc)
    elif isinstance(plan.index_plan, df.StreamPlan):
        _check_stream_plan(plan, diags, loc)
    else:
        _diag(diags, "ip-plan-invalid", ERROR,
              f"index plan of unknown type {type(plan.index_plan).__name__}",
              f"{loc}.index_plan")

    be = _check_backend(plan, diags, loc)
    if be is not None:
        # the same capability negotiation the policy path uses: the plan's
        # dataflow must be in allowed_dataflows(backend, block_shape), so a
        # learned/autotuned selection can never commit to a dataflow the
        # backend would refuse at execution time
        allowed = allowed_dataflows(be, tuple(plan.block_shape))
        if plan.dataflow not in allowed:
            _diag(diags, "backend-unsupported", ERROR,
                  f"backend {be.name!r} does not admit {plan.dataflow!r} at "
                  f"block_shape={tuple(plan.block_shape)} "
                  f"(allowed: {allowed})", loc)
        # the static schedule checker: backends that execute from an aux
        # StreamSchedule register via schedule_aux_key; its invariant
        # families are proven over the stored artifact here — so a
        # stale/corrupt/missing schedule (e.g. re-admitted into a PlanCache
        # after with_backend re-targeting without re-preparing) can never
        # reach execution
        aux_key = be.schedule_aux_key
        if aux_key is not None and not errors_of(diags):
            aux = plan.aux
            if not (isinstance(aux, dict) and aux_key in aux):
                _diag(diags, "schedule-missing", ERROR,
                      f"backend {be.name!r} executes from "
                      f"aux[{aux_key!r}] but the plan carries no such "
                      "schedule", loc,
                      hint="backend.prepare builds it at plan time; a "
                           "plan whose aux was dropped or never rebuilt "
                           "after re-targeting must not be admitted to a "
                           "cache")
            else:
                from .schedule import check_schedule
                check_schedule(plan, aux[aux_key], diags, loc=loc)

    if toplevel:
        # cache-key ↔ plan-content agreement: the fingerprint the PlanCache
        # keys this plan by must equal the one recomputed from the plan's
        # own frozen pattern.  (Sub-plans carry derived fingerprints like
        # "<fp>/t3" by design — only top-level plans are cache keys.)
        occ_a = _layout_bitmap(plan.a_layout, (m, k), (bm, bk))
        occ_b = _layout_bitmap(plan.b_layout, (k, n), (bk, bn))
        expect = _fingerprint(occ_a, occ_b, (m, k, n),
                              tuple(plan.block_shape))
        if plan.fingerprint != expect:
            _diag(diags, "fingerprint-mismatch", ERROR,
                  f"stored fingerprint {plan.fingerprint[:12]}… does not "
                  f"match the pattern-derived {expect[:12]}…", loc,
                  hint="the plan's layouts and its cache identity disagree; "
                       "a PlanCache would serve this plan for the wrong "
                       "pattern")


# ---------------------------------------------------------------------------
# Tile / shard composition checks
# ---------------------------------------------------------------------------


def _check_coverage(tiles: Tuple[Tile, ...], grid: Tuple[int, int, int],
                    diags, loc) -> None:
    """Every (i, k, j) block cell covered exactly once."""
    mb, kb, nb = grid
    for idx, t in enumerate(tiles):
        if not (0 <= t.i0 < t.i1 <= mb and 0 <= t.k0 < t.k1 <= kb
                and 0 <= t.j0 < t.j1 <= nb):
            _diag(diags, "tile-bounds", ERROR,
                  f"tile {idx} {t} exceeds the padded ({mb}, {kb}, {nb}) "
                  "block grid", loc)
            return
    counter = np.zeros(grid, dtype=np.int16)
    for t in tiles:
        counter[t.i0:t.i1, t.k0:t.k1, t.j0:t.j1] += 1
    over = int((counter > 1).sum())
    under = int((counter == 0).sum())
    if over:
        _diag(diags, "tile-overlap", ERROR,
              f"{over} block cells are covered by more than one tile — "
              "their products would be accumulated twice", loc,
              hint="tiles must partition the (M, K, N) block grid; check "
                   "the scheduler's half-open ranges")
    if under:
        _diag(diags, "tile-gap", ERROR,
              f"{under} block cells are covered by no tile — their "
              "products would be silently dropped", loc)


def _check_merge(plan: TiledPlan, grid, diags, loc) -> None:
    mb, kb, nb = grid
    expect = TileMergePlan.from_tiles(list(plan.tiles))
    if (tuple(expect.regions) != tuple(plan.merge_plan.regions)
            or tuple(expect.tile_region)
            != tuple(plan.merge_plan.tile_region)):
        _diag(diags, "merge-mismatch", ERROR,
              "stored TileMergePlan disagrees with the one recomputed from "
              "the tiles", f"{loc}.merge_plan")
        return
    base = "mixed" if plan.is_mixed else plan.dataflow[:-2]
    if base in ("ip", "gust", "mixed"):
        if plan.merge_plan.max_contributions > 1:
            _diag(diags, "merge-overlap", ERROR,
                  f"{base} tiles must own disjoint C regions but "
                  f"{plan.merge_plan.max_contributions} tiles merge into "
                  "one region — per-tile outputs are not merge-compatible",
                  f"{loc}.merge_plan",
                  hint="only OP k-slabs may share an output region (their "
                       "psums add up)")
    elif base == "op":
        for idx, t in enumerate(plan.tiles):
            if t.out_region != (0, mb, 0, nb):
                _diag(diags, "merge-span", ERROR,
                      f"OP k-slab {idx} covers output region "
                      f"{t.out_region} instead of the full (0, {mb}, 0, "
                      f"{nb}) — partial sums would merge into the wrong "
                      "cells", f"{loc}.merge_plan")
                break


def _verify_tiled(plan: TiledPlan, diags, loc, *, toplevel: bool) -> None:
    if not plan.tiles:
        _diag(diags, "tile-gap", ERROR, "TiledPlan has no tiles", loc)
        return
    if not plan.is_mixed and plan.dataflow not in df.DATAFLOWS:
        _diag(diags, "unknown-dataflow", ERROR,
              f"dataflow {plan.dataflow!r} is not one of {df.DATAFLOWS} "
              "or 'mixed'", loc)
        return
    if len(plan.plans) != len(plan.tiles):
        _diag(diags, "tile-plans-mismatch", ERROR,
              f"{len(plan.plans)} sub-plans for {len(plan.tiles)} tiles",
              loc)
        return
    grid = (max(t.i1 for t in plan.tiles), max(t.k1 for t in plan.tiles),
            max(t.j1 for t in plan.tiles))
    m, k, n = plan.shapes
    bm, bk, bn = plan.block_shape
    if grid[0] < _ceil_div(m, bm) or grid[1] < _ceil_div(k, bk) \
            or grid[2] < _ceil_div(n, bn):
        _diag(diags, "tile-gap", ERROR,
              f"tile extents {grid} do not reach the logical "
              f"({_ceil_div(m, bm)}, {_ceil_div(k, bk)}, "
              f"{_ceil_div(n, bn)}) block grid", loc)
    _check_coverage(plan.tiles, grid, diags, loc)
    _check_merge(plan, grid, diags, loc)

    # per-tile dataflow bookkeeping
    if len(plan.tile_dataflows) != len(plan.tiles):
        _diag(diags, "tile-dataflows-invalid", ERROR,
              f"{len(plan.tile_dataflows)} tile_dataflows for "
              f"{len(plan.tiles)} tiles", loc)
    else:
        for i, d in enumerate(plan.tile_dataflows):
            if d not in df.DATAFLOWS:
                _diag(diags, "tile-dataflows-invalid", ERROR,
                      f"tile {i} runs unknown dataflow {d!r}", loc)
            elif not plan.is_mixed and d != plan.dataflow:
                _diag(diags, "tile-dataflows-invalid", ERROR,
                      f"non-mixed plan has tile {i} on {d!r} != "
                      f"{plan.dataflow!r}", loc)

    be = _check_backend(plan, diags, loc)
    if be is not None:
        needs_scan = plan.scan_ok or bool(plan.scan_group_meta)
        if needs_scan and not be.scan_streaming:
            _diag(diags, "backend-capability", ERROR,
                  f"plan carries padded slab lanes but backend "
                  f"{be.name!r} does not declare scan_streaming", loc,
                  hint="re-target with plan.with_backend(...) so the plan "
                       "is rebuilt in the unpadded shape this backend "
                       "expects")

    # lanes reference valid, disjoint, same-dataflow tiles
    seen: set = set()
    for d, idxs in plan.scan_group_meta:
        for i in idxs:
            if not (0 <= i < len(plan.tiles)) or i in seen:
                _diag(diags, "scan-lane-invalid", ERROR,
                      f"scan lane {d!r} references tile {i} "
                      "(out of range or already claimed by another lane)",
                      loc)
                break
            seen.add(i)
            if i < len(plan.tile_dataflows) and plan.tile_dataflows[i] != d:
                _diag(diags, "scan-lane-invalid", ERROR,
                      f"scan lane {d!r} includes tile {i} whose dataflow "
                      f"is {plan.tile_dataflows[i]!r}", loc)

    # recurse into sub-plans (consistency across the composition)
    for i, (sub, d) in enumerate(zip(plan.plans,
                                     plan.tile_dataflows
                                     or (plan.dataflow,) * len(plan.plans))):
        sloc = f"{loc}.plans[{i}]"
        if not isinstance(sub, FlexagonPlan):
            _diag(diags, "tile-plans-mismatch", ERROR,
                  f"sub-plan {i} is {type(sub).__name__}, expected "
                  "FlexagonPlan", sloc)
            continue
        if sub.dataflow != d:
            _diag(diags, "tile-dataflows-invalid", ERROR,
                  f"sub-plan {i} executes {sub.dataflow!r} but the "
                  f"schedule says {d!r}", sloc)
            continue
        if tuple(sub.block_shape) != tuple(plan.block_shape):
            _diag(diags, "shape-mismatch", ERROR,
                  f"sub-plan {i} block_shape {tuple(sub.block_shape)} != "
                  f"plan's {tuple(plan.block_shape)}", sloc)
        if sub.backend != plan.backend:
            _diag(diags, "backend-capability", ERROR,
                  f"sub-plan {i} targets backend {sub.backend!r} but the "
                  f"composition targets {plan.backend!r}", sloc)
        _verify_flexagon(sub, diags, sloc, toplevel=False)

    # padded lanes: every member was padded to shared extents
    from .schedule import check_stack_uniform
    if plan.scan_ok and not plan.scan_group_meta:
        check_stack_uniform(list(enumerate(plan.plans)), diags, loc,
                            group="op k-slab lane")
    for d, idxs in plan.scan_group_meta:
        members = [(i, plan.plans[i]) for i in idxs
                   if 0 <= i < len(plan.plans)
                   and isinstance(plan.plans[i], FlexagonPlan)]
        check_stack_uniform(members, diags, loc,
                            group=f"scan lane {d!r}")

    if toplevel:
        expect = _fingerprint(plan.occ_a, plan.occ_b, tuple(plan.shapes),
                              tuple(plan.block_shape))
        if plan.fingerprint != expect:
            _diag(diags, "fingerprint-mismatch", ERROR,
                  f"stored fingerprint {plan.fingerprint[:12]}… does not "
                  f"match the bitmap-derived {expect[:12]}…", loc)


def _verify_sharded(plan, diags, loc, *, toplevel: bool) -> None:
    from ..dist.partition import mesh_device_count

    if plan.axis not in ("m", "k", "n"):
        _diag(diags, "shard-axis-invalid", ERROR,
              f"partition axis {plan.axis!r} must be 'm', 'k' or 'n'", loc)
        return
    if not plan.is_mixed and plan.dataflow not in df.DATAFLOWS:
        _diag(diags, "unknown-dataflow", ERROR,
              f"dataflow {plan.dataflow!r} is not one of {df.DATAFLOWS} "
              "or 'mixed'", loc)
        return
    if not (plan.n_shards == len(plan.tiles) == len(plan.plans)):
        _diag(diags, "shard-count-mismatch", ERROR,
              f"n_shards={plan.n_shards} but {len(plan.tiles)} tiles / "
              f"{len(plan.plans)} sub-plans", loc)
        return
    grid = tuple(plan.padded_grid)
    _check_coverage(plan.tiles, grid, diags, loc)
    mb, kb, nb = grid
    if plan.axis == "k":
        for idx, t in enumerate(plan.tiles):
            if t.out_region != (0, mb, 0, nb):
                _diag(diags, "merge-span", ERROR,
                      f"k-slab shard {idx} covers {t.out_region} instead "
                      f"of the full (0, {mb}, 0, {nb}) output — the psum "
                      "merge would mix misaligned partials", loc)
                break
    else:
        if TileMergePlan.from_tiles(list(plan.tiles)).max_contributions > 1:
            _diag(diags, "merge-overlap", ERROR,
                  f"axis={plan.axis!r} shards must own disjoint output "
                  "regions", loc)

    # the port's path follows the mesh alone (no collective_merge flag):
    # on the collective path each rank runs its own shard on the mesh's
    # device, so the plan must live on that kind of device
    _check_backend(plan, diags, loc)
    if plan.path == "collective" \
            and plan.device.type != plan.mesh.device_type:
        _diag(diags, "backend-capability", ERROR,
              f"plan lives on {plan.device} but its collective path runs "
              f"each shard on a rank of a {plan.mesh.device_type!r} mesh",
              loc, hint="plan with device=None so the plan follows the "
                        "mesh's ranks")
    if plan.mesh is not None \
            and mesh_device_count(plan.mesh) < plan.n_shards:
        _diag(diags, "mesh-undersized", INFO,
              f"mesh has {mesh_device_count(plan.mesh)} devices for "
              f"{plan.n_shards} shards; apply takes the serial path",
              loc)

    for i, sub in enumerate(plan.plans):
        sloc = f"{loc}.plans[{i}]"
        if isinstance(sub, TiledPlan):
            _verify_tiled(sub, diags, sloc, toplevel=False)
        elif isinstance(sub, FlexagonPlan):
            if not plan.is_mixed and sub.dataflow != plan.dataflow:
                _diag(diags, "tile-dataflows-invalid", ERROR,
                      f"shard {i} executes {sub.dataflow!r} but the "
                      f"partition is for {plan.dataflow!r}", sloc)
                continue
            _verify_flexagon(sub, diags, sloc, toplevel=False)
        else:
            _diag(diags, "tile-plans-mismatch", ERROR,
                  f"shard sub-plan {i} is {type(sub).__name__}", sloc)
        if hasattr(sub, "backend") and sub.backend != plan.backend:
            _diag(diags, "backend-capability", ERROR,
                  f"shard {i} targets backend {sub.backend!r} but the "
                  f"composition targets {plan.backend!r}", sloc)

    if plan.shard_ok:
        # padded shard members were padded to shared extents
        from .schedule import check_stack_uniform
        members = [(i, sub) for i, sub in enumerate(plan.plans)
                   if isinstance(sub, FlexagonPlan)]
        check_stack_uniform(members, diags, loc, group="shard stack")

    if toplevel:
        expect = _fingerprint(plan.occ_a, plan.occ_b, tuple(plan.shapes),
                              tuple(plan.block_shape))
        if plan.fingerprint != expect:
            _diag(diags, "fingerprint-mismatch", ERROR,
                  f"stored fingerprint {plan.fingerprint[:12]}… does not "
                  f"match the bitmap-derived {expect[:12]}…", loc)


def _verify_moe(plan, diags, loc) -> None:
    if plan.strategy not in _MOE_STRATEGIES:
        _diag(diags, "moe-strategy-invalid", ERROR,
              f"MoE strategy {plan.strategy!r} is not one of "
              f"{_MOE_STRATEGIES}", loc,
              hint="plan_moe resolves 'auto' before building the MoEPlan; "
                   "an unresolved or unknown strategy would fall through "
                   "every dispatch branch")
    if not isinstance(plan.tokens, int) or plan.tokens < 1 \
            or not math.isfinite(plan.tokens):
        _diag(diags, "moe-tokens-invalid", ERROR,
              f"MoEPlan.tokens must be a positive int, got "
              f"{plan.tokens!r}", loc)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def verify_plan(plan: Any, *, raise_on_error: bool = False
                ) -> List[PlanDiagnostic]:
    """Structural invariant checks over one plan.

    Accepts any plan the phase-1 mapper produces (``FlexagonPlan``,
    ``TiledPlan``, ``ShardedPlan``, ``MoEPlan``) and returns the list of
    :class:`PlanDiagnostic` findings (empty for a clean plan).  With
    ``raise_on_error=True``, error-severity findings raise
    :class:`PlanVerificationError` — the pre-execution gate behaviour
    behind ``flexagon_plan(..., verify=True)``.  Verifying builds
    nothing: ``PHASE1_COUNTERS`` read the same afterwards.
    """
    from ..dist.sharded_plan import ShardedPlan   # lazy: dist imports api
    from ..models.moe import MoEPlan              # lazy: models imports api

    snapshot = dict(PHASE1_COUNTERS)
    diags: List[PlanDiagnostic] = []
    try:
        if isinstance(plan, ShardedPlan):
            _verify_sharded(plan, diags, "plan", toplevel=True)
        elif isinstance(plan, TiledPlan):
            _verify_tiled(plan, diags, "plan", toplevel=True)
        elif isinstance(plan, FlexagonPlan):
            _verify_flexagon(plan, diags, "plan", toplevel=True)
        elif isinstance(plan, MoEPlan):
            _verify_moe(plan, diags, "plan")
        else:
            diags.append(PlanDiagnostic(
                code="unknown-plan-type", severity=ERROR,
                message=f"cannot verify a {type(plan).__name__}",
                location="plan"))
    finally:
        # verification must be invisible to phase-1 accounting
        for key, value in snapshot.items():
            PHASE1_COUNTERS[key] = value
    if raise_on_error and errors_of(diags):
        raise PlanVerificationError(diags)
    return diags


def verify_cache(cache, *, raise_on_error: bool = False
                 ) -> List[PlanDiagnostic]:
    """Cache-key ↔ plan-content agreement over a whole ``PlanCache``.

    For every cached entry, checks that the key's fingerprint and backend
    name match the stored plan's, that mixed keys' per-tile choices match
    the plan's ``tile_dataflows``, and runs :func:`verify_plan` on the plan
    itself.

    Because :func:`verify_plan` now includes the static schedule checker,
    this re-verifies the *current content* of every entry — including
    plans re-admitted into the LRU after ``with_backend`` re-targeting,
    whose aux schedules were previously never looked at again after the
    original insertion (a stale or foreign schedule was served silently).
    """
    diags: List[PlanDiagnostic] = []
    for key, plan in cache._plans.items():
        fingerprint, dataflow, backend_name = key[0], key[1], key[2]
        loc = f"cache[{fingerprint[:12]}…]"
        if getattr(plan, "fingerprint", None) != fingerprint:
            _diag(diags, "cache-key-mismatch", ERROR,
                  "cache key fingerprint differs from the stored plan's",
                  loc)
        if getattr(plan, "backend", None) != backend_name:
            _diag(diags, "cache-key-mismatch", ERROR,
                  f"cache key names backend {backend_name!r} but the plan "
                  f"targets {getattr(plan, 'backend', None)!r}", loc)
        if dataflow not in ("auto", "mixed") \
                and getattr(plan, "dataflow", None) != dataflow:
            _diag(diags, "cache-key-mismatch", ERROR,
                  f"cache key pins dataflow {dataflow!r} but the plan "
                  f"executes {getattr(plan, 'dataflow', None)!r}", loc)
        policy_key = key[3]
        if isinstance(policy_key, tuple) and policy_key \
                and policy_key[0] == "mixed-tiles" \
                and isinstance(plan, TiledPlan) \
                and tuple(policy_key[1:]) != tuple(plan.tile_dataflows):
            _diag(diags, "cache-key-mismatch", ERROR,
                  "mixed cache key's per-tile choices differ from the "
                  "plan's tile_dataflows", loc)
        for d in verify_plan(plan):
            diags.append(PlanDiagnostic(code=d.code, severity=d.severity,
                                        message=d.message,
                                        location=f"{loc}.{d.location}",
                                        hint=d.hint))
    if raise_on_error and errors_of(diags):
        raise PlanVerificationError(diags)
    return diags
