"""The port's schedule checker against the JAX package's.

``repro_torch.analysis.schedule`` proves the reference's invariant
families over the port's ``StreamSchedule`` (byte-equal to JAX's), so each
mutation case of ``tests/test_schedule_checker.py`` is applied to a JAX
``pallas`` plan and to the port's ``cuda`` plan of the same pattern, and
both verifiers must report the same codes.  The reference's index-map
audit has no Hopper counterpart; in its place the ``device-schedule``
family audits the :class:`DeviceSchedule` the kernels read, clean on every
planner-emitted table and failing on each table corrupted one way.
Property tests set ``deadline=None``.  Everything runs on the CPU.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import DistPartition as JaxPartition
from repro import flexagon_plan as jax_flexagon_plan
from repro.analysis import verify_plan as jax_verify_plan
from repro.core import random_sparse_dense
from repro.kernels.stream import pad_schedule as jax_pad_schedule

from repro_torch import DistPartition, MemoryBudget, PlanCache, flexagon_plan
from repro_torch.analysis import (check_device_schedule, check_schedule,
                                  errors_of, verify_cache, verify_plan)
from repro_torch.core import dataflows as df
from repro_torch.kernels.stream import device_schedule, pad_schedule

BS = (16, 16, 16)


def _operands(seed=0, shape=(64, 48, 80), da=0.35, db=0.45):
    rng = np.random.default_rng(seed)
    m, k, n = shape
    a = random_sparse_dense(rng, (m, k), density=da, block_shape=BS[:2])
    b = random_sparse_dense(rng, (k, n), density=db, block_shape=BS[1:])
    return a, b


def _codes(diags):
    return {d.code for d in diags}


@functools.lru_cache(maxsize=None)
def _base_plans(dataflow="op_m"):
    """(JAX pallas plan, port cuda plan) of one pattern, never mutated in
    place: dense enough that runs merge several pairs."""
    a, b = _operands(seed=3, da=0.8, db=0.8)
    jplan = jax_flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                              backend="pallas", verify=False)
    tplan = flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                          backend="cuda", device="cpu", verify=False)
    return jplan, tplan


def _with_schedule(plan, sched, device=False):
    """``plan`` carrying ``sched``; with ``device`` also the port's device
    tables (as ``uniform_aux`` re-uploads them)."""
    aux = {**plan.aux, "stream_schedule": sched}
    if device and "device_schedule" in aux:
        aux["device_schedule"] = device_schedule(sched, "cpu")
    return dataclasses.replace(plan, aux=aux)


def _mutate(sched, **arrays):
    return dataclasses.replace(
        sched, **{k: np.asarray(v) for k, v in arrays.items()})


def _both(mutation):
    """Apply ``mutation(plan, sched) -> plan`` to both base plans and
    return (JAX codes, port codes)."""
    jplan, tplan = _base_plans()
    jbad = mutation(jplan, jplan.aux["stream_schedule"])
    tbad = mutation(tplan, tplan.aux["stream_schedule"])
    return _codes(jax_verify_plan(jbad)), _codes(verify_plan(tbad))


def test_base_schedules_are_byte_equal():
    jplan, tplan = _base_plans()
    js, ts = jplan.aux["stream_schedule"], tplan.aux["stream_schedule"]
    for f in ("a_slot", "b_slot", "cj", "is_first", "is_last", "run_id",
              "run_ci", "run_cj", "real_w", "real_r", "oob"):
        assert np.asarray(getattr(ts, f)).tobytes() \
            == np.asarray(getattr(js, f)).tobytes(), f
    assert verify_plan(tplan) == [] and jax_verify_plan(jplan) == []


# ---------------------------------------------------------------------------
# mutations: each family rejects its violated schedule, as in JAX
# ---------------------------------------------------------------------------


def _flags_cleared(plan, s):
    flags = np.asarray(s.is_first).copy()
    flags[0] = 0
    return _with_schedule(plan, _mutate(s, is_first=flags))


def _slot_out_of_stack(plan, s):
    slots = np.asarray(s.a_slot).copy()
    slots[0] = plan.a_layout.rows.shape[0] + 5
    return _with_schedule(plan, _mutate(s, a_slot=slots))


def _run_outside_grid(plan, s):
    ci = np.asarray(s.run_ci).copy()
    ci[0] = -(-plan.shapes[0] // BS[0]) + 3
    return _with_schedule(plan, _mutate(s, run_ci=ci))


def _duplicate_destination(plan, s):
    ci, cj = np.asarray(s.run_ci).copy(), np.asarray(s.run_cj).copy()
    ci[1], cj[1] = ci[0], cj[0]
    return _with_schedule(plan, _mutate(s, run_ci=ci, run_cj=cj))


def _retargeted_pair(plan, s):
    stored = plan.a_layout.rows.shape[0]
    slots = np.asarray(s.a_slot).copy()
    slots[0] = (slots[0] + 1) % stored
    return _with_schedule(plan, _mutate(s, a_slot=slots))


def _reordered_merge(plan, s):
    rid = np.asarray(s.run_id)
    a_slot, b_slot = np.asarray(s.a_slot).copy(), np.asarray(s.b_slot).copy()
    idx = next(i for i in range(1, s.n_real_work) if rid[i] == rid[i - 1]
               and (a_slot[i] != a_slot[i - 1] or b_slot[i] != b_slot[i - 1]))
    a_slot[idx - 1], a_slot[idx] = a_slot[idx], a_slot[idx - 1]
    b_slot[idx - 1], b_slot[idx] = b_slot[idx], b_slot[idx - 1]
    return _with_schedule(plan, _mutate(s, a_slot=a_slot, b_slot=b_slot))


def _pad_run_inside(plan, s):
    oob = -(-plan.shapes[0] // BS[0])
    pad = jax_pad_schedule if type(s).__module__.startswith("repro.") \
        else pad_schedule
    padded = pad(s, s.n_work + 3, int(s.n_runs) + 1, oob)
    ci = np.asarray(padded.run_ci).copy()
    ci[-1] = 0
    return _with_schedule(plan, _mutate(padded, run_ci=ci))


def _schedule_missing(plan, s):
    return dataclasses.replace(plan, aux={
        k: v for k, v in plan.aux.items() if k != "stream_schedule"})


MUTATIONS = {
    "schedule-structure": _flags_cleared,
    "schedule-bounds": _slot_out_of_stack,
    "schedule-bounds/run": _run_outside_grid,
    "schedule-race": _duplicate_destination,
    "schedule-coverage": _retargeted_pair,
    "schedule-determinism": _reordered_merge,
    "schedule-pad": _pad_run_inside,
    "schedule-missing": _schedule_missing,
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutation_matches_jax(name):
    jcodes, tcodes = _both(MUTATIONS[name])
    assert tcodes == jcodes, (jcodes, tcodes)
    assert name.split("/")[0] in tcodes
    if name == "schedule-determinism":
        assert tcodes == {"schedule-determinism"}


def test_padded_schedule_passes_whole_checker():
    """A canonically padded schedule (what ``uniform_aux`` emits), with its
    device tables re-uploaded, passes every family, device tables
    included."""
    _, plan = _base_plans()
    s = plan.aux["stream_schedule"]
    padded = pad_schedule(s, s.n_work + 3, int(s.n_runs) + 1,
                          -(-plan.shapes[0] // BS[0]))
    assert verify_plan(_with_schedule(plan, padded, device=True)) == []
    # the stale (unpadded) device tables beside a padded schedule are not
    assert "device-schedule" in _codes(verify_plan(
        _with_schedule(plan, padded)))


def test_stack_uniformity_on_sharded_plan():
    a, b = _operands(seed=5, shape=(128, 48, 64))
    codes = []
    for fp, part, kw in ((jax_flexagon_plan, JaxPartition, {}),
                         (flexagon_plan, DistPartition, {"device": "cpu"})):
        plan = fp(a, b, dataflow="op_m", block_shape=BS,
                  backend="pallas" if fp is jax_flexagon_plan else "cuda",
                  verify=False, partition=part(shards=2), **kw)
        assert plan.shard_ok and len(plan.plans) == 2
        member = plan.plans[1]
        s = member.aux["stream_schedule"]
        pad = jax_pad_schedule if fp is jax_flexagon_plan else pad_schedule
        oob = s.oob_row if s.oob_row >= 0 \
            else -(-member.shapes[0] // BS[0])
        grown = pad(s, s.n_work + 3, int(s.n_runs) + 1, oob)
        bad = dataclasses.replace(
            plan, plans=(plan.plans[0],
                         _with_schedule(member, grown, device=True)))
        codes.append(_codes((jax_verify_plan if fp is jax_flexagon_plan
                             else verify_plan)(bad)))
    assert codes[1] == codes[0] and "schedule-stack" in codes[1]


def test_verify_cache_catches_retargeted_readmission():
    """A cached plan re-admitted with another pattern's schedule (and its
    device tables) is caught by ``verify_cache``."""
    cache = PlanCache()
    a, b = _operands(seed=0)
    plan = cache.get(a, b, dataflow="op_m", block_shape=BS, backend="cuda",
                     device="cpu", verify=False)
    key = next(iter(cache._plans))
    a2, b2 = _operands(seed=9, shape=(48, 64, 48), da=0.2, db=0.3)
    other = flexagon_plan(a2, b2, dataflow="op_m", block_shape=BS,
                          backend="cuda", device="cpu", verify=False)
    cache._plans[key] = dataclasses.replace(plan, aux=dict(other.aux))
    codes = _codes(verify_cache(cache))
    assert codes & {"schedule-coverage", "schedule-determinism",
                    "schedule-bounds"}, codes


# ---------------------------------------------------------------------------
# property tests: the checker accepts every planner-emitted schedule
# ---------------------------------------------------------------------------


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 10_000),
       m=st.sampled_from((32, 48, 64)),
       k=st.sampled_from((32, 48, 64)),
       n=st.sampled_from((32, 48, 64)),
       da=st.floats(0.1, 0.6),
       db=st.floats(0.1, 0.6))
def test_checker_accepts_all_dataflows(seed, m, k, n, da, db):
    """Random sparsity x {six dataflows, mixed}: zero diagnostics."""
    a, b = _operands(seed=seed, shape=(m, k, n), da=da, db=db)
    budget = MemoryBudget(l1_bytes=1024, l2_bytes=2048)
    for dataflow in list(df.DATAFLOWS) + ["mixed"]:
        plan = flexagon_plan(
            a, b, dataflow=dataflow, block_shape=BS, backend="cuda",
            device="cpu", verify=False,
            memory_budget=budget if dataflow == "mixed" else None)
        diags = verify_plan(plan)
        assert not errors_of(diags), (dataflow, [str(d) for d in diags])


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 10_000), da=st.floats(0.15, 0.5),
       db=st.floats(0.15, 0.5))
def test_checker_accepts_sharded_stacks(seed, da, db):
    """Random sparsity x {1, 2, 8 shards}: zero errors, stacks uniform."""
    a, b = _operands(seed=seed, shape=(128, 48, 64), da=da, db=db)
    for shards in (1, 2, 8):
        plan = flexagon_plan(
            a, b, dataflow="op_m", block_shape=BS, backend="cuda",
            device="cpu", verify=False,
            partition=DistPartition(shards=shards) if shards > 1 else None)
        diags = verify_plan(plan)
        assert not errors_of(diags), (shards, [str(d) for d in diags])


@pytest.mark.parametrize("dataflow", df.DATAFLOWS)
def test_check_schedule_agrees_with_jax(dataflow):
    """The same schedule through both checkers: the same (empty) result,
    and the port's device tables clean."""
    from repro.analysis.schedule import check_schedule as jax_check

    a, b = _operands(seed=11, shape=(64, 128, 80), da=0.6, db=0.6)
    jplan = jax_flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                              backend="pallas", verify=False)
    tplan = flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                          backend="cuda", device="cpu", verify=False)
    assert check_schedule(tplan) == [] and jax_check(jplan) == []
    assert check_device_schedule(tplan) == []


# ---------------------------------------------------------------------------
# the device-schedule family: each table corrupted one way
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _split_plan(dataflow):
    """A plan whose runs (K1) or column segments (K2) are longer than one
    chunk, so its tables carry split segments and workspace slots."""
    a, b = _operands(seed=2, shape=(64, 256, 80), da=0.9, db=0.9)
    plan = flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                         backend="cuda", device="cpu", verify=False)
    ds = plan.aux["device_schedule"]
    tables = ds.cols if dataflow.startswith("gust") else ds
    assert tables.n_split > 0
    return plan


def _bump(t, i=0, by=1):
    t = t.clone()
    t[i] += by
    return t


def _ds_mutations(ds):
    """name -> a corrupted copy of ``ds`` (K1's tables and the bounds)."""
    swap = ds.chunk_slot.clone()
    split = torch.nonzero(swap >= 0).flatten()
    swap[split[0]], swap[split[1]] = swap[split[1]].item(), \
        swap[split[0]].item()
    single = ds.chunk_slot.clone()
    single[split[0]] = -1                 # a split chunk written straight
    r = dataclasses.replace
    return {
        "a_slot": r(ds, a_slot=_bump(ds.a_slot)),
        "seg_start": r(ds, seg_start=_bump(ds.seg_start, 1)),
        "seg_ci": r(ds, seg_ci=_bump(ds.seg_ci)),
        "chunk_start": r(ds, chunk_start=_bump(ds.chunk_start, 1)),
        "chunk_seg": r(ds, chunk_seg=_bump(ds.chunk_seg, 0)),
        "chunk_slot order": r(ds, chunk_slot=swap),
        "chunk_slot single": r(ds, chunk_slot=single),
        "split_seg": r(ds, split_seg=_bump(ds.split_seg)),
        "split_start": r(ds, split_start=_bump(ds.split_start, 1)),
        "n_slots": r(ds, n_slots=ds.n_slots + 1),
        "chunk": r(ds, chunk=ds.chunk + 1),
        "max_a_slot": r(ds, max_a_slot=ds.max_a_slot - 1),
        "max_b_slot": r(ds, max_b_slot=10_000),
        "max_cj": r(ds, max_cj=ds.max_cj + 1),
    }


def _cols_mutations(ds):
    """name -> ``ds`` with K2's column table corrupted one way."""
    cols = ds.cols
    r = dataclasses.replace
    dup_ci, dup_cj = cols.col_ci.clone(), cols.col_cj.clone()
    dup_ci[1], dup_cj[1] = dup_ci[0].item(), dup_cj[0].item()
    order = cols.a_slot.clone()
    seg = int(torch.nonzero(cols.col_start[1:] - cols.col_start[:-1]
                            > 1).flatten()[0])
    at = int(cols.col_start[seg])
    order[at], order[at + 1] = order[at + 1].item(), order[at].item()
    pad_row = cols.col_ci.clone()
    pad_row[0] = 10_000
    return {name: r(ds, cols=c) for name, c in {
        "cols duplicate tile": r(cols, col_ci=dup_ci, col_cj=dup_cj),
        "cols work-list order": r(cols, a_slot=order),
        "cols pad run kept": r(cols, col_ci=pad_row),
        "cols dropped segment": r(cols, col_start=cols.col_start[:-1],
                                  col_ci=cols.col_ci[:-1],
                                  col_cj=cols.col_cj[:-1]),
        "cols chunk_seg": r(cols, chunk_seg=_bump(cols.chunk_seg)),
        "cols split_start": r(cols, split_start=_bump(cols.split_start, 1)),
    }.items()}


@pytest.mark.parametrize("dataflow", ["op_m", "ip_n"])
def test_device_schedule_catches_each_k1_table(dataflow):
    plan = _split_plan(dataflow)
    assert check_device_schedule(plan) == []
    for name, bad in _ds_mutations(plan.aux["device_schedule"]).items():
        diags = check_device_schedule(plan, ds=bad)
        assert _codes(diags) == {"device-schedule"}, name
        assert all(d.is_error for d in diags)


@pytest.mark.parametrize("dataflow", ["gust_m", "gust_n"])
def test_device_schedule_catches_each_k2_table(dataflow):
    plan = _split_plan(dataflow)
    assert check_device_schedule(plan) == []
    ds = plan.aux["device_schedule"]
    for name, bad in {**_ds_mutations(ds), **_cols_mutations(ds)}.items():
        assert _codes(check_device_schedule(plan, ds=bad)) \
            == {"device-schedule"}, name
    assert _codes(check_device_schedule(plan, ds=dataclasses.replace(
        ds, cols=None))) == {"device-schedule"}


def test_device_tables_are_checked_on_every_verify():
    """The schedule checks are memoized on the schedule's bytes; the
    device tables are not, so tables corrupted after a clean verify of an
    unchanged schedule are still caught."""
    plan = _split_plan("op_m")
    assert verify_plan(plan) == []
    ds = plan.aux["device_schedule"]
    bad = dataclasses.replace(plan, aux={
        **plan.aux, "device_schedule": dataclasses.replace(
            ds, chunk_seg=_bump(ds.chunk_seg))})
    assert _codes(verify_plan(bad)) == {"device-schedule"}


def test_lint_schedule_call_rule(tmp_path):
    """Raw StreamSchedule/DeviceSchedule outside kernels/ fails lint; the
    same construct inside kernels/ (and outside repro_torch/) is allowed."""
    from repro_torch.analysis import lint_paths

    pkg = tmp_path / "repro_torch"
    (pkg / "kernels").mkdir(parents=True)
    bad = pkg / "helper.py"
    bad.write_text("s = StreamSchedule(a, b, c, d, e, f, g, h, 4)\n"
                   "d = DeviceSchedule(s)\n")
    ok = pkg / "kernels" / "fused.py"
    ok.write_text("s = StreamSchedule(a, b, c, d, e, f, g, h, 4)\n")
    assert [d.code for d in lint_paths([str(bad)])] == ["schedule-call"] * 2
    assert lint_paths([str(ok)]) == []
