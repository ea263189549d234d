"""Static verification of :class:`repro_torch.kernels.StreamSchedule`.

The port of ``repro.analysis.schedule``.  The ``cuda`` backend lowers every
dataflow, tile and shard to one flat :class:`StreamSchedule` work list,
byte-equal to the JAX package's.  The paper's MRN (§4) is simultaneously a
reducer and a merger, and the kernels only compute the right C if the
schedule keeps the MRN's ordering and exclusivity discipline.  On the card
a violated schedule is *silent corruption* (a run flushed twice
double-writes a tile; a pad entry aimed inside the grid adds garbage), so
this module proves the reference's invariant families **without executing
the schedule**, over the schedule's self-description contract
(``kind``/``real_w``/``real_r``/``oob``, see ``kernels/stream.py``):

- **structure** (``schedule-structure``) — array extents agree, the run
  boundary flags on the real prefix are exactly the ``run_id`` change
  points (the accumulator reset/flush discipline);
- **bounds** (``schedule-bounds``) — every gather slot, run id, and real
  destination lies inside the operand/output extents;
- **race-freedom** (``schedule-race``) — real runs partition the output:
  each is started and flushed exactly once and no two real runs write the
  same C block;
- **padding** (``schedule-pad``) — pad work entries only touch pad runs,
  real entries never do, and every pad run targets exactly the designated
  out-of-bounds row (one past the execution-orientation grid) that the
  kernels drop;
- **coverage** (``schedule-coverage``) — the real work multiset equals the
  plan's effectual pair set ``{(A slot, B slot, dest)}`` re-derived from
  the stored index plan;
- **determinism** (``schedule-determinism``) — the schedule is byte for
  byte the canonical re-derivation from the plan, so fp32 accumulation
  order is a pure function of the plan.

The reference's last family audits Pallas ``BlockSpec`` index maps, which
have no Hopper counterpart.  In its place, **device tables**
(``device-schedule``, :func:`check_device_schedule`) audit what K1 and K2
actually read: the :class:`repro_torch.kernels.DeviceSchedule` that
``prepare`` uploaded.  Its segment table, K1's chunk and split tables and
K2's :class:`ColumnTable` must be what the port's own builders
(``chunk_table``, ``column_table``) derive from the schedule, each chunk
inside one segment and no longer than ``chunk``, one column segment per
touched (run, column-block) tile in work-list order with pad runs left
out, and the host bounds ``max_a_slot``/``max_b_slot``/``max_cj`` (which
the wrappers check before every launch) the true maxima, inside the
operand extents.

Everything here is host-side numpy over phase-1 artifacts, plus one read
of the device tables back to the host (outside any ``apply``), and is
wired into ``verify_plan`` for every plan whose backend declares
``schedule_aux_key``.
"""
from __future__ import annotations

import hashlib
from collections import Counter, OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core import dataflows as df
from .diagnostics import ERROR, PlanDiagnostic

__all__ = ["check_schedule", "check_device_schedule", "check_stack_uniform",
           "main"]


def _diag(diags, code, message, location, hint=None, severity=ERROR):
    diags.append(PlanDiagnostic(code=code, severity=severity,
                                message=message, location=location,
                                hint=hint))


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _exec_grid(plan) -> Tuple[int, int]:
    """(rows, cols) of the execution-orientation scatter grid.

    N-stationary dataflows execute the transposed problem, so their
    schedules scatter on the (Nb, Mb) grid.
    """
    m, k, n = plan.shapes
    bm, bk, bn = plan.block_shape
    mb, nb = _ceil_div(m, bm), _ceil_div(n, bn)
    return (nb, mb) if plan.dataflow.endswith("_n") else (mb, nb)


def _stored_counts(plan) -> Tuple[int, int]:
    """Stored block counts of the (leading, trailing) gathered operands."""
    swap = plan.dataflow.endswith("_n")
    a_stored = (plan.b_layout if swap else plan.a_layout).rows.shape[0]
    b_stored = (plan.a_layout if swap else plan.b_layout).rows.shape[0]
    return int(a_stored), int(b_stored)


def _expected_pairs(plan) -> Optional[np.ndarray]:
    """The plan's effectual set as (4, P) rows (a, b, dest_i, dest_j)."""
    ip = plan.index_plan
    if isinstance(ip, df.IPPlan):
        pair_a = np.asarray(ip.pair_a)
        pair_b = np.asarray(ip.pair_b)
        npairs = np.asarray(ip.npairs)
        mask = np.arange(pair_a.shape[2])[None, None, :] < npairs[..., None]
        ri, rj = np.nonzero(npairs)
        counts = npairs[ri, rj]
        return np.stack([pair_a[mask], pair_b[mask],
                         np.repeat(ri, counts), np.repeat(rj, counts)]
                        ).astype(np.int64)
    if isinstance(ip, df.StreamPlan):
        real = int(np.asarray(ip.seg_ptr)[-1])
        return np.stack([np.asarray(ip.a_slot)[:real],
                         np.asarray(ip.b_slot)[:real],
                         np.asarray(ip.ci)[:real],
                         np.asarray(ip.cj)[:real]]).astype(np.int64)
    return None


def _sort_rows(rows: np.ndarray) -> np.ndarray:
    return rows[:, np.lexsort(rows[::-1])]


#: pure-function memo: (plan fingerprint, dataflow, schedule content hash)
#: -> frozen (code, severity, message, hint) rows.  The checker is a pure
#: function of plan + schedule *content*, so identical content re-verified
#: (bench steady state, serving re-admission audits) is a cache hit; any
#: mutation of the schedule bytes, or a foreign schedule under a victim
#: plan's fingerprint, changes the key and re-runs the full check.
_MEMO: "OrderedDict[tuple, tuple]" = OrderedDict()
_MEMO_CAP = 512
_SCHED_FIELDS = ("a_slot", "b_slot", "cj", "is_first", "is_last", "run_id",
                 "run_ci", "run_cj", "real_w", "real_r", "oob")


def _memo_key(plan, sched):
    h = hashlib.blake2b(digest_size=16)
    for f in _SCHED_FIELDS:
        a = np.ascontiguousarray(getattr(sched, f))
        h.update(a.tobytes())
    return (plan.fingerprint, plan.dataflow, sched.kind,
            int(sched.n_runs), h.hexdigest())


def check_schedule(plan, sched=None, diags: Optional[List[PlanDiagnostic]]
                   = None, *, loc: str = "plan") -> List[PlanDiagnostic]:
    """Prove the invariant families over one plan's schedule.

    ``plan`` is the :class:`repro_torch.api.FlexagonPlan` the schedule belongs
    to (source of grids, layouts, and the index plan the schedule must
    re-derive from); ``sched`` defaults to
    ``plan.aux["stream_schedule"]``.  Appends typed diagnostics to
    ``diags`` and returns it.

    Results are memoized on (fingerprint, schedule bytes) — the planner's
    fingerprint is a content hash of pattern + config, so equal keys mean
    the full check already ran on identical inputs; only the diagnostic
    ``location`` is rebound to the caller's ``loc``.  A plan that also
    carries its uploaded ``device_schedule`` gets the device-table family
    (:func:`check_device_schedule`) after the schedule itself checks clean.
    """
    if diags is None:
        diags = []
    if sched is None:
        sched = plan.aux["stream_schedule"]
    sloc = f"{loc}.aux[stream_schedule]"
    key = _memo_key(plan, sched)
    if key in _MEMO:
        found = [PlanDiagnostic(code=code, severity=severity,
                                message=message, location=sloc, hint=hint)
                 for code, severity, message, hint in _MEMO[key]]
    else:
        found = _check_schedule_impl(plan, sched, sloc)
        _MEMO[key] = tuple((d.code, d.severity, d.message, d.hint)
                           for d in found)
        while len(_MEMO) > _MEMO_CAP:
            _MEMO.popitem(last=False)
    _MEMO.move_to_end(key)
    diags.extend(found)
    # the device tables are checked on every call, outside the memo: they
    # can drift from a schedule whose bytes are unchanged
    ds = plan.aux.get("device_schedule") if isinstance(plan.aux, dict) \
        else None
    if ds is not None and not found:
        check_device_schedule(plan, sched, ds, diags, loc=loc)
    return diags


def _check_schedule_impl(plan, sched, sloc) -> List[PlanDiagnostic]:
    from ..kernels.stream import SCHEDULE_KINDS

    diags: List[PlanDiagnostic] = []
    before = 0

    # ---- structure ------------------------------------------------------
    work = {name: np.asarray(getattr(sched, name))
            for name in ("a_slot", "b_slot", "cj", "is_first", "is_last",
                         "run_id")}
    run_ci = np.asarray(sched.run_ci)
    run_cj = np.asarray(sched.run_cj)
    n_runs = int(sched.n_runs)
    w_total = int(work["a_slot"].size)
    if sched.kind not in SCHEDULE_KINDS:
        _diag(diags, "schedule-structure",
              f"unknown schedule kind {sched.kind!r}", sloc)
        return diags
    base = plan.dataflow[:-2]
    expect_kind = "panel" if base == "gust" else "dest"
    if sched.kind != expect_kind:
        _diag(diags, "schedule-structure",
              f"{plan.dataflow!r} plans feed the {expect_kind!r} kernel "
              f"but the schedule declares kind {sched.kind!r}", sloc)
        return diags
    if any(a.ndim != 1 or int(a.size) != w_total for a in work.values()):
        _diag(diags, "schedule-structure",
              "work arrays disagree on the entry count "
              f"({ {k: v.shape for k, v in work.items()} })", sloc)
        return diags
    if run_ci.shape != (n_runs,) or run_cj.shape != (n_runs,):
        _diag(diags, "schedule-structure",
              f"run arrays {run_ci.shape}/{run_cj.shape} disagree with "
              f"n_runs={n_runs}", sloc)
        return diags
    real_w, real_r, oob = (sched.n_real_work, sched.n_real_runs,
                           sched.oob_row)
    if not (0 <= real_w <= w_total) or not (0 <= real_r <= n_runs):
        _diag(diags, "schedule-structure",
              f"self-description out of range: real_w={real_w} of "
              f"{w_total} entries, real_r={real_r} of {n_runs} runs", sloc)
        return diags
    is_first = work["is_first"]
    is_last = work["is_last"]
    run_id = work["run_id"]
    if w_total and (not ((is_first == 0) | (is_first == 1)).all()
                    or not ((is_last == 0) | (is_last == 1)).all()):
        _diag(diags, "schedule-structure",
              "is_first/is_last must be 0/1 flags", sloc)
        return diags
    if w_total and n_runs == 0:
        _diag(diags, "schedule-structure",
              f"{w_total} work entries but zero runs to flush into", sloc)
        return diags
    # the accumulator discipline on the real prefix: reset exactly at
    # run_id change points, flush exactly before them (pad entries are
    # checked by the padding family — pad_schedule's single-entry pad
    # runs legitimately repeat one run id with is_first=1 each)
    if real_w:
        rid = run_id[:real_w]
        exp_first = np.ones(real_w, bool)
        exp_first[1:] = rid[1:] != rid[:-1]
        exp_last = np.ones(real_w, bool)
        exp_last[:-1] = rid[1:] != rid[:-1]
        bad_f = int((is_first[:real_w].astype(bool) != exp_first).sum())
        bad_l = int((is_last[:real_w].astype(bool) != exp_last).sum())
        if bad_f or bad_l:
            _diag(diags, "schedule-structure",
                  f"run boundary flags disagree with run_id change points "
                  f"on the real prefix ({bad_f} is_first / {bad_l} is_last "
                  "mismatches) — the accumulator would reset or flush "
                  "mid-fiber", sloc)
    if len(diags) > before:
        return diags

    # ---- bounds ---------------------------------------------------------
    rows_g, cols_g = _exec_grid(plan)
    a_stored, b_stored = _stored_counts(plan)
    a_slot, b_slot, cjv = work["a_slot"], work["b_slot"], work["cj"]
    if w_total:
        if a_stored == 0 or b_stored == 0:
            _diag(diags, "schedule-bounds",
                  f"{w_total} work entries gather from an operand with "
                  "zero stored blocks", sloc)
        elif (a_slot.min() < 0 or a_slot.max() >= a_stored
                or b_slot.min() < 0 or b_slot.max() >= b_stored):
            _diag(diags, "schedule-bounds",
                  "work entries (including pads) gather operand slots "
                  f"outside the stored [0, {a_stored})×[0, {b_stored}) "
                  "block stacks — the kernels would gather out of bounds",
                  sloc)
        if run_id.min() < 0 or run_id.max() >= n_runs:
            _diag(diags, "schedule-bounds",
                  f"run_id outside [0, {n_runs}) — the segment table "
                  "would address a nonexistent run", sloc)
    if real_r:
        ci_r = run_ci[:real_r]
        if ci_r.min() < 0 or ci_r.max() >= rows_g:
            _diag(diags, "schedule-bounds",
                  f"real runs scatter rows outside the ({rows_g}, "
                  f"{cols_g}) output grid", sloc)
        if sched.kind == "dest":
            cj_r = run_cj[:real_r]
            if cj_r.min() < 0 or cj_r.max() >= cols_g:
                _diag(diags, "schedule-bounds",
                      f"real runs scatter columns outside the ({rows_g}, "
                      f"{cols_g}) output grid", sloc)
    if sched.kind == "panel" and real_w:
        cj_real = cjv[:real_w]
        if cj_real.min() < 0 or cj_real.max() >= cols_g:
            _diag(diags, "schedule-bounds",
                  f"panel merge offsets cj outside [0, {cols_g}) — psums "
                  "would merge past the row panel", sloc)
    if len(diags) > before:
        return diags

    # ---- race-freedom (over the real prefix) ----------------------------
    rid = run_id[:real_w]
    starts = np.bincount(rid[is_first[:real_w] == 1], minlength=n_runs)
    flushes = np.bincount(rid[is_last[:real_w] == 1], minlength=n_runs)
    if real_r:
        multi_s = int((starts[:real_r] != 1).sum())
        multi_f = int((flushes[:real_r] != 1).sum())
        if multi_s or multi_f:
            _diag(diags, "schedule-race",
                  f"{multi_s} real runs are not started exactly once and "
                  f"{multi_f} not flushed exactly once — a resumed run "
                  "drops psums, a re-flushed or never-written run scatters "
                  "stale or uninitialized tiles into C", sloc,
                  hint="real runs must be contiguous entry segments, one "
                       "reset and one flush each; only pad runs may repeat")
        if sched.kind == "dest":
            dest = run_ci[:real_r].astype(np.int64) * cols_g \
                + run_cj[:real_r]
        else:
            dest = run_ci[:real_r].astype(np.int64)
        dup = int(real_r - np.unique(dest).size)
        if dup:
            _diag(diags, "schedule-race",
                  f"{dup} real run destination(s) are claimed by more than "
                  "one run — last writer wins at the scatter and the other "
                  "fibers' results are lost", sloc,
                  hint="destination-major runs must partition the output "
                       "blocks")
    if len(diags) > before:
        return diags

    # ---- padding soundness ----------------------------------------------
    if real_w and rid.max() >= real_r:
        _diag(diags, "schedule-pad",
              "real work entries merge into pad runs — their products "
              "would be scattered to the dropped row and lost", sloc)
    if real_w < w_total:
        pad_rid = run_id[real_w:]
        if pad_rid.min() < real_r:
            _diag(diags, "schedule-pad",
                  f"{int((pad_rid < real_r).sum())} pad work entries merge "
                  "into REAL runs — their garbage psums would corrupt C",
                  sloc,
                  hint="pad entries must be self-contained no-ops "
                       "targeting pad runs only (see pad_schedule)")
    if real_r < n_runs:
        if oob < 0:
            _diag(diags, "schedule-pad",
                  f"schedule carries {n_runs - real_r} pad runs but "
                  "designates no dropped OOB row (oob=-1)", sloc)
        elif oob < rows_g:
            _diag(diags, "schedule-pad",
                  f"designated pad row {oob} is INSIDE the ({rows_g}, "
                  f"{cols_g}) grid — pad runs would overwrite real output",
                  sloc)
        else:
            pad_ci = run_ci[real_r:]
            off = int((pad_ci != oob).sum())
            if off:
                _diag(diags, "schedule-pad",
                      f"{off} pad run(s) scatter to rows other than the "
                      f"designated dropped row {oob}", sloc,
                      hint="every pad run must target exactly the one row "
                           "past the execution-orientation grid that the "
                           "scatter provably drops")
    elif real_w < w_total:
        _diag(diags, "schedule-pad",
              "schedule has pad work entries but no pad run to absorb "
              "them", sloc)
    if len(diags) > before:
        return diags

    # ---- coverage -------------------------------------------------------
    expected = _expected_pairs(plan)
    if expected is None:
        _diag(diags, "schedule-structure",
              f"cannot re-derive pairs from a "
              f"{type(plan.index_plan).__name__} index plan", sloc)
        return diags
    rid = run_id[:real_w]
    if sched.kind == "dest":
        dest_j = run_cj[rid]
    else:
        dest_j = cjv[:real_w]
    got = np.stack([a_slot[:real_w], b_slot[:real_w], run_ci[rid],
                    dest_j]).astype(np.int64)
    if got.shape != expected.shape \
            or not np.array_equal(_sort_rows(got), _sort_rows(expected)):
        want = Counter(map(tuple, expected.T))
        have = Counter(map(tuple, got.T))
        missing = sum((want - have).values())
        invented = sum((have - want).values())
        _diag(diags, "schedule-coverage",
              f"schedule real work does not match the plan's effectual "
              f"pair set: {expected.shape[1]} pairs expected, "
              f"{got.shape[1]} scheduled ({missing} missing, {invented} "
              "invented or double-counted)", sloc,
              hint="every effectual (A, B) block pair must appear exactly "
                   "once with its destination; rebuild the schedule via "
                   "backend.prepare")
        return diags

    # ---- determinism ----------------------------------------------------
    from ..kernels.stream import (pad_schedule, schedule_from_ip,
                                  schedule_from_stream)

    if isinstance(plan.index_plan, df.IPPlan):
        canon = schedule_from_ip(plan.index_plan)
    else:
        canon = schedule_from_stream(plan.index_plan,
                                     by_dest=sched.kind == "dest")
    if canon.n_work != w_total or canon.n_runs != n_runs:
        try:
            canon = pad_schedule(canon, w_total, n_runs,
                                 oob if oob >= 0 else rows_g)
        except ValueError as e:
            _diag(diags, "schedule-determinism",
                  f"schedule extents (W={w_total}, R={n_runs}) are not a "
                  f"padding of the canonical re-derivation: {e}", sloc)
            return diags
    fields = ("a_slot", "b_slot", "cj", "is_first", "is_last", "run_id",
              "run_ci", "run_cj", "real_w", "real_r", "oob")

    # byte-compare (same dtype contract on both sides, see stream.py) —
    # ~5x cheaper than np.array_equal per field, and this loop dominates
    # the checker's cost on the bench (<10%-of-plan-build budget)
    def _same(f):
        x = np.ascontiguousarray(getattr(sched, f))
        y = np.ascontiguousarray(getattr(canon, f))
        return x.shape == y.shape and x.dtype == y.dtype \
            and x.tobytes() == y.tobytes()

    differ = [f for f in fields if not _same(f)]
    if differ:
        _diag(diags, "schedule-determinism",
              "schedule differs from the canonical re-derivation in "
              f"{differ} — merge (hence fp32 accumulation) order is no "
              "longer a pure function of the plan", sloc,
              hint="schedules must come from schedule_from_ip/"
                   "schedule_from_stream + pad_schedule on the stored "
                   "index plan so numerics reproduce across backends, "
                   "re-tilings, and shard counts")
        return diags

    return diags


# ---------------------------------------------------------------------------
# device tables: what K1 and K2 read
# ---------------------------------------------------------------------------


def _read_back(tables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Every table on the host as int64 numpy, in one device-to-host copy
    (the tables are int32 tensors on one device)."""
    import torch

    names = list(tables)
    flat = torch.cat([tables[k].reshape(-1).to(torch.int32)
                      for k in names]).cpu().numpy().astype(np.int64)
    out, at = {}, 0
    for k in names:
        n = int(tables[k].numel())
        out[k] = flat[at:at + n]
        at += n
    return out


def _chunk_faults(seg_start, t, chunk: int) -> List[str]:
    """What is wrong with one chunk table over the segments ``seg_start``:
    every chunk must lie inside its segment and hold 1..``chunk`` entries,
    and the chunks must cover the work list in order."""
    cs, cseg = t["chunk_start"], t["chunk_seg"]
    if cs.size != cseg.size + 1 or cs[0] != 0 or cs[-1] != seg_start[-1]:
        return [f"chunk_start {cs.size} offsets for {cseg.size} chunks, "
                f"from {cs[:1]} to {cs[-1:]} (want 0 to {seg_start[-1]})"]
    if cseg.size and (cseg.min() < 0 or cseg.max() >= seg_start.size - 1):
        return ["chunk_seg names segments outside the segment table"]
    out = []
    lengths = np.diff(cs)
    if (lengths < 1).any() or (lengths > chunk).any():
        out.append(f"chunk lengths {int(lengths.min(initial=0))}.."
                   f"{int(lengths.max(initial=0))} outside 1..{chunk}")
    if ((cs[:-1] < seg_start[cseg]) | (cs[1:] > seg_start[cseg + 1])).any():
        out.append("a chunk crosses its segment's boundary — the kernel "
                   "would sum entries of two runs into one tile")
    return out


def check_device_schedule(plan, sched=None, ds=None,
                          diags: Optional[List[PlanDiagnostic]] = None, *,
                          loc: str = "plan") -> List[PlanDiagnostic]:
    """Audit the :class:`repro_torch.kernels.DeviceSchedule` K1/K2 read.

    ``sched``/``ds`` default to ``plan.aux["stream_schedule"]`` /
    ``plan.aux["device_schedule"]``; the tables may lie on any device and
    are read back once.  Reports ``device-schedule`` errors when:

    - a table differs from what the port's builders derive from ``sched``
      (the segment table from ``is_first``, K1's ``chunk_table``, K2's
      ``column_table`` and its chunk table), or ``chunk`` differs from
      ``chunk_size(n_work)``;
    - a chunk crosses its segment or holds more than ``chunk`` entries;
    - K2's column table holds a tile twice, misses a touched (run,
      column-block) tile, keeps a pad run, or leaves work-list order;
    - a host bound (``max_a_slot``/``max_b_slot``/``max_cj``) is not the
      true maximum or lies outside the operand extents.
    """
    from ..kernels.stream import chunk_size, chunk_table, column_table

    if diags is None:
        diags = []
    if sched is None:
        sched = plan.aux["stream_schedule"]
    if ds is None:
        ds = plan.aux["device_schedule"]
    dloc = f"{loc}.aux[device_schedule]"
    faults: List[str] = []
    if ds.kind != sched.kind:
        _diag(diags, "device-schedule",
              f"device tables of kind {ds.kind!r} for a {sched.kind!r} "
              "schedule", dloc)
        return diags
    names = ("a_slot", "b_slot", "cj", "seg_start", "seg_ci", "seg_cj",
             "chunk_start", "chunk_seg", "chunk_slot", "split_seg",
             "split_start")
    tables = {k: getattr(ds, k) for k in names}
    if ds.cols is not None:
        tables.update({f"cols.{k}": getattr(ds.cols, k) for k in (
            "a_slot", "b_slot", "col_start", "col_ci", "col_cj",
            "chunk_start", "chunk_seg", "chunk_slot", "split_seg",
            "split_start")})
    got = _read_back(tables)

    # -- re-derivation through the port's own builders ----------------------
    is_first = np.asarray(sched.is_first)
    w = int(is_first.size)
    a_slot = np.asarray(sched.a_slot, np.int64)
    b_slot = np.asarray(sched.b_slot, np.int64)
    cj = np.asarray(sched.cj, np.int64)
    starts = np.flatnonzero(is_first)
    rid = np.asarray(sched.run_id, np.int64)[starts]
    seg_start = np.append(starts, w).astype(np.int64)
    seg_ci = np.asarray(sched.run_ci, np.int64)[rid]
    want = {"a_slot": a_slot, "b_slot": b_slot, "cj": cj,
            "seg_start": seg_start, "seg_ci": seg_ci,
            "seg_cj": np.asarray(sched.run_cj, np.int64)[rid]}
    chunk = chunk_size(w)
    if ds.chunk != chunk:
        faults.append(f"chunk {ds.chunk} != chunk_size({w}) = {chunk}")
    k1 = chunk_table(seg_start, chunk)
    want.update(zip(names[6:], k1))
    rows_g, cols_g = _exec_grid(plan)
    real_seg = seg_ci >= 0
    if sched.oob_row >= 0:
        real_seg &= seg_ci < sched.oob_row
    if sched.kind == "panel":
        if ds.cols is None:
            faults.append("a panel schedule without K2's column table")
        else:
            order, col_start, col_ci, col_cj = column_table(
                seg_start, seg_ci, cj, real_seg)
            want.update({"cols.a_slot": a_slot[order],
                         "cols.b_slot": b_slot[order],
                         "cols.col_start": col_start,
                         "cols.col_ci": col_ci, "cols.col_cj": col_cj})
            want.update(zip((f"cols.{k}" for k in names[6:]),
                            chunk_table(col_start, chunk)))
    differ = [k for k in got if k in want
              and not np.array_equal(got[k], np.asarray(want[k], np.int64))]
    if differ:
        faults.append(f"tables differ from the builders' re-derivation: "
                      f"{differ}")
    n_slots = int(k1[4][-1])
    if ds.n_slots != n_slots:
        faults.append(f"n_slots {ds.n_slots} != {n_slots} split chunks")

    # -- the invariants the kernels rely on ---------------------------------
    if got["seg_start"].size and (np.diff(got["seg_start"]) >= 0).all():
        faults += [f"K1: {f}" for f in _chunk_faults(
            got["seg_start"], got, ds.chunk)]
    if ds.cols is not None and "cols.col_start" in got:
        col = {k[5:]: v for k, v in got.items() if k.startswith("cols.")}
        cstart = col["col_start"]
        if cstart.size and (np.diff(cstart) >= 0).all():
            faults += [f"K2: {f}" for f in _chunk_faults(cstart, col,
                                                         ds.chunk)]
        tiles = col["col_ci"] * max(cols_g, 1) + col["col_cj"]
        if np.unique(tiles).size != tiles.size:
            faults.append("K2: a (row, column-block) tile has more than one "
                          "column segment — two chunks would write it")
        if col["col_ci"].size and (col["col_ci"].min() < 0
                                   or col["col_ci"].max() >= rows_g):
            faults.append(f"K2: a column segment writes a row outside the "
                          f"{rows_g}-row grid (a pad run kept)")
        seg_of = np.repeat(np.arange(seg_start.size - 1), np.diff(seg_start))
        mine = real_seg[seg_of] if w else np.zeros(0, bool)
        touched = np.unique(seg_ci[seg_of[mine]] * max(cols_g, 1) + cj[mine])
        if not np.array_equal(np.unique(tiles), touched):
            faults.append(f"K2: {tiles.size} column segments for "
                          f"{touched.size} touched (run, column-block) tiles")
    bounds = [("max_a_slot", ds.max_a_slot, a_slot),
              ("max_b_slot", ds.max_b_slot, b_slot),
              ("max_cj", ds.max_cj, cj if sched.kind == "panel"
               else want["seg_cj"])]
    a_stored, b_stored = _stored_counts(plan)
    for name, value, arr in bounds:
        top = int(arr.max()) if arr.size else -1
        if value != top:
            faults.append(f"{name}={value} but the tables reach {top}: the "
                          "launch check would pass out-of-range slots")
    for name, value, extent in (("max_a_slot", ds.max_a_slot, a_stored),
                                ("max_b_slot", ds.max_b_slot, b_stored),
                                ("max_cj", ds.max_cj, cols_g)):
        if value >= extent:
            faults.append(f"{name}={value} outside the operand extent "
                          f"{extent}")
    for f in faults:
        _diag(diags, "device-schedule", f, dloc,
              hint="device_schedule(stream_schedule, device) rebuilds "
                   "the tables the kernels read")
    return diags


def check_stack_uniform(members, diags: List[PlanDiagnostic], loc: str,
                        group: str = "lane") -> None:
    """Padded families must share (kind, W, R), as ``uniform_aux`` pads
    them.

    ``members`` are the FlexagonPlans of one padded lane or shard group.
    The JAX package stacks their schedules into one ``lax.scan`` /
    ``shard_map``; the port runs them one by one, but pads them the same
    way (byte-equal phase 1), so a member whose extents drifted is a
    member that ``uniform_aux`` never saw: ``schedule-stack``.
    """
    scheds = [(i, p.aux["stream_schedule"]) for i, p in members
              if isinstance(getattr(p, "aux", None), dict)
              and "stream_schedule" in p.aux]
    if len(scheds) < 2:
        return
    sigs = {(s.kind, s.n_work, int(s.n_runs)) for _, s in scheds}
    if len(sigs) > 1:
        detail = ", ".join(
            f"plans[{i}]=({s.kind}, W={s.n_work}, R={int(s.n_runs)})"
            for i, s in scheds)
        _diag(diags, "schedule-stack",
              f"{group} members' schedules are not shape-uniform: "
              f"{detail}", loc,
              hint="uniform_aux must pad every member of a stacked "
                   "family to shared (W, R) extents before _stack_plans")


# ---------------------------------------------------------------------------
# CLI (`python -m repro_torch.analysis schedule`)
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    """Sweep plan families on a demo pattern and run the full checker."""
    import argparse
    import time

    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis schedule",
        description="build plans across dataflows/families and run the "
                    "static schedule checker on each")
    parser.add_argument("--shape", type=int, nargs=3, default=(64, 48, 80),
                        metavar=("M", "K", "N"))
    parser.add_argument("--block", type=int, nargs=3, default=(16, 16, 16),
                        metavar=("BM", "BK", "BN"))
    parser.add_argument("--density", type=float, default=0.35)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--backend", default="cuda")
    parser.add_argument("--device", default=None,
                        help="where the plans live (default: the card)")
    args = parser.parse_args(argv)

    from .. import MemoryBudget, flexagon_plan
    from ..core import random_sparse_dense
    from .verify import verify_plan

    rng = np.random.default_rng(args.seed)
    m, k, n = args.shape
    bs = tuple(args.block)
    a = random_sparse_dense(rng, (m, k), density=args.density,
                            block_shape=bs[:2])
    b = random_sparse_dense(rng, (k, n), density=args.density,
                            block_shape=bs[1:])

    failures = 0
    t0 = time.perf_counter()  # lint: time-ok (CLI-reported checker cost)
    budget = MemoryBudget(l1_bytes=1024, l2_bytes=2048)
    for dataflow in list(df.DATAFLOWS) + ["mixed"]:
        plan = flexagon_plan(
            a, b, dataflow=dataflow, block_shape=bs, backend=args.backend,
            device=args.device, verify=False,
            memory_budget=budget if dataflow == "mixed" else None)
        diags = verify_plan(plan)
        errs = [d for d in diags if d.is_error]
        failures += len(errs)
        status = "FAIL" if errs else "ok"
        print(f"  {dataflow:<8} {type(plan).__name__:<14} "
              f"{len(diags)} diagnostic(s)  {status}")
        for d in errs:
            print(f"    {d}")
    elapsed = time.perf_counter() - t0  # lint: time-ok (CLI-reported cost)
    print(f"schedule checker sweep: {elapsed * 1e3:.1f} ms, "
          f"{failures} error(s)")
    return 1 if failures else 0


if __name__ == "__main__":      # pragma: no cover
    raise SystemExit(main())
