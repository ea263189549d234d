"""The port's memory layer (budgets, tile schedulers, traffic pricing,
``TiledPlan``, mixed plans) against the JAX package's ``repro.memory``.

Phase 1 is byte-equal: tiles, ``TileMergePlan``, per-tile dataflows, every
sub-plan's layouts and (padded) index plans, and on the ``cuda`` backend
every sub-plan's ``StreamSchedule`` against the JAX ``pallas`` backend's.
Phase 2 (``TiledPlan.apply`` on the CPU, the kernels' plain versions) is
held to the JAX ``reference`` backend's tiled apply with ``rtol = atol =
1e-4`` and to ``a @ b`` with ``1e-3``, the tolerances of
``tests/test_memory.py``.  Also: the reference executor drops the pad
entries of a padded plan, a tiled apply does no phase-1 work and uploads
nothing, and the traffic model's numbers equal the JAX package's.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import MemoryBudget as JaxBudget
from repro import PlanCache as JaxPlanCache
from repro import flexagon_plan as jax_flexagon_plan
from repro import get_backend as jax_get_backend
from repro import memory as jax_memory
from repro.core.formats import block_occupancy, random_sparse_dense
from repro.core.selector import LayerShape as JaxLayerShape
from repro.core.selector import TPUSpec
from repro.core.selector import plan_network as jax_plan_network

import repro_torch.api as api
from repro_torch import (PAPER_BUDGET, MemoryBudget, PlanCache,
                         SparseOperand, TiledPlan, compress_ffn,
                         flexagon_plan, get_backend, sparse_ffn_apply)
from repro_torch import memory
from repro_torch.backends.policies import (HeuristicPolicy, SelectionContext,
                                           SimulatorPolicy)
from repro_torch.core import dataflows as df
from repro_torch.core.selector import DeviceSpec, LayerShape, plan_network
from repro_torch.memory.tiled_plan import _pad_stream

BS = (8, 8, 8)
TOL = dict(rtol=1e-4, atol=1e-4)       # against JAX's tiled apply
DENSE_TOL = dict(rtol=1e-3, atol=1e-3)  # against a @ b
#: the roofline under the JAX package's TPUSpec numbers, so that the
#: heuristic's picks can be held to the JAX package's
TPU_NUMBERS = DeviceSpec(**dataclasses.asdict(TPUSpec()))

#: (l1, l2) bytes: small enough that the default case tiles on every
#: dataflow / fewer tiles / more tiles / one tile
SMALL, TINY, HUGE = (4096, 8192), (1024, 2048), (1 << 30, 1 << 30)
#: budgets for the heterogeneous mixed case: 2 / 4 / dozens of tiles
TWO, FOUR, MANY = (20000, 40000), (10000, 40000), (5000, 20000)


@pytest.fixture(autouse=True)
def _no_verify(monkeypatch):
    # the port has no plan verifier yet (ROADMAP item 10): verify=True and
    # REPRO_VERIFY=1 raise, so these tests plan with verification off
    monkeypatch.setenv("REPRO_VERIFY", "0")


def _budgets(tiers):
    return MemoryBudget(*tiers), JaxBudget(*tiers)


def _case(seed=0, m=48, k=64, n=40, da=0.5, db=0.6):
    rng = np.random.default_rng(seed)
    a = random_sparse_dense(rng, (m, k), density=da, block_shape=BS[:2])
    b = random_sparse_dense(rng, (k, n), density=db, block_shape=BS[1:])
    return a, b


def _hetero_case(seed=3, m=96, k=96, n=96):
    """Dense band + uniform-sparse remainder in A, near-dense B (the case
    of ``tests/test_mixed.py``)."""
    rng = np.random.default_rng(seed)
    a = np.zeros((m, k), np.float32)
    a[: m // 2] = rng.standard_normal((m // 2, k))
    a[m // 2:] = random_sparse_dense(rng, (m - m // 2, k), density=0.5,
                                     block_shape=BS[:2])
    b = random_sparse_dense(rng, (k, n), density=0.9, block_shape=BS[1:])
    return a, b


def _t(x):
    return torch.as_tensor(x)


def _plans(a, b, dataflow, tiers, backend="reference", fmt=None, **kw):
    """(port plan, JAX plan) for the same arguments; ``cuda`` is held to
    the JAX ``pallas`` backend, ``reference`` to ``reference``."""
    mine, ref = _budgets(tiers)
    a_in = a if fmt is None else SparseOperand.from_dense(
        a, fmt, BS[:2], device="cpu")
    tp = flexagon_plan(a_in, b, dataflow=dataflow, block_shape=BS,
                       backend=backend, device="cpu", memory_budget=mine,
                       spec=kw.pop("spec", TPU_NUMBERS), **kw)
    jp = jax_flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                           backend="pallas" if backend == "cuda"
                           else backend, memory_budget=ref, **kw)
    return tp, jp


def _eq(x, y, what):
    x, y = np.asarray(x), np.asarray(y)
    assert x.dtype == y.dtype and np.array_equal(x, y), what


def _same_sub_plan(tp, jp):
    assert (tp.dataflow, tp.shapes, tp.block_shape, tp.fingerprint) == \
        (jp.dataflow, tuple(jp.shapes), tuple(jp.block_shape),
         jp.fingerprint)
    for side in ("a_layout", "b_layout"):
        tl, jl = getattr(tp, side), getattr(jp, side)
        for f in ("rows", "cols", "indptr"):
            _eq(getattr(tl, f), getattr(jl, f), f"{side}.{f}")
        assert (tl.shape, tl.block_shape, tl.fmt.name) == \
            (tuple(jl.shape), tuple(jl.block_shape), jl.fmt.name)
    ti, ji = tp.index_plan, jp.index_plan
    assert type(ti).__name__ == type(ji).__name__
    for f in ("pair_a", "pair_b", "npairs", "a_slot", "b_slot", "ci", "cj",
              "seg_ptr"):
        if hasattr(ji, f):
            _eq(getattr(ti, f), getattr(ji, f), f"index_plan.{f}")
    for f in ("max_pairs", "order"):
        if hasattr(ji, f):
            assert getattr(ti, f) == getattr(ji, f)
    ts, js = tp.aux.get("stream_schedule"), (jp.aux or {}).get(
        "stream_schedule")
    assert (ts is None) == (js is None)
    if ts is not None:
        for f in ("a_slot", "b_slot", "cj", "is_first", "is_last", "run_id",
                  "run_ci", "run_cj", "real_w", "real_r", "oob"):
            _eq(getattr(ts, f), getattr(js, f), f"schedule.{f}")
        assert (ts.n_runs, ts.kind) == (js.n_runs, js.kind)
        assert ("dense" in tp.aux) == ("dense" in jp.aux)


def _same_tiled_plan(tp, jp):
    assert isinstance(tp, TiledPlan) and isinstance(jp, jax_memory.TiledPlan)
    assert [dataclasses.astuple(t) for t in tp.tiles] == \
        [dataclasses.astuple(t) for t in jp.tiles]
    assert dataclasses.astuple(tp.merge_plan) == \
        dataclasses.astuple(jp.merge_plan)
    assert tp.tile_dataflows == tuple(jp.tile_dataflows)
    assert tp.scan_ok == jp.scan_ok
    assert tp.scan_group_meta == tuple(jp.scan_group_meta)
    assert tp.fingerprint == jp.fingerprint
    _eq(tp.occ_a, jp.occ_a, "occ_a")
    _eq(tp.occ_b, jp.occ_b, "occ_b")
    assert len(tp.plans) == len(jp.plans)
    for t_sub, j_sub in zip(tp.plans, jp.plans):
        _same_sub_plan(t_sub, j_sub)


# -- budgets and schedulers ---------------------------------------------------


def test_budget_views_equal():
    assert dataclasses.astuple(PAPER_BUDGET) == \
        dataclasses.astuple(jax_memory.PAPER_BUDGET)
    with pytest.raises(ValueError, match="positive"):
        MemoryBudget(l1_bytes=0)
    assert dataclasses.astuple(MemoryBudget(*SMALL).scaled(2.0)) == \
        dataclasses.astuple(JaxBudget(*SMALL).scaled(2.0))


@pytest.mark.parametrize("tiers", [SMALL, TINY, HUGE])
@pytest.mark.parametrize("dataflow", df.DATAFLOWS + ("mixed",))
def test_schedules_equal(dataflow, tiers):
    a, b = _case(seed=1)
    occ_a, occ_b = block_occupancy(a, BS[:2]), block_occupancy(b, BS[1:])
    mine, ref = _budgets(tiers)
    tiles, merge = memory.schedule(dataflow, occ_a, occ_b, BS, mine)
    j_tiles, j_merge = jax_memory.schedule(dataflow, occ_a, occ_b, BS, ref)
    assert [dataclasses.astuple(t) for t in tiles] == \
        [dataclasses.astuple(t) for t in j_tiles]
    assert dataclasses.astuple(merge) == dataclasses.astuple(j_merge)


# -- tiled plans: phase 1 byte-equal, phase 2 within tolerance ----------------


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("fmt", ["bcsr", "bcsc"])
@pytest.mark.parametrize("dataflow", df.DATAFLOWS)
def test_tiled_plans_equal_and_outputs_match(dataflow, fmt, backend):
    a, b = _case(seed=3)
    tp, jp = _plans(a, b, dataflow, SMALL, backend=backend, fmt=fmt)
    _same_tiled_plan(tp, jp)
    assert tp.n_tiles >= 2 and tp.out_major == df.OUTPUT_MAJOR[dataflow]
    ref = np.asarray(jax_flexagon_plan(
        a, b, dataflow=dataflow, block_shape=BS,
        memory_budget=JaxBudget(*SMALL)).apply(a, b))
    a_op = SparseOperand.from_dense(a, fmt, BS[:2], device="cpu")
    out = tp.apply(a_op, _t(b)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, a @ b, **DENSE_TOL)
    untiled = flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                            backend=backend, device="cpu")
    np.testing.assert_allclose(out, untiled.apply(a, b).numpy(), **TOL)


@pytest.mark.parametrize("dataflow", ["op_m", "op_n"])
def test_padded_op_slab_plans_equal(dataflow):
    """OP k-slabs form one lane: sub-plans padded to one extent, pad
    entries aimed one past the (transposed, for _n) grid, on both
    backends."""
    a, b = _case(seed=2)
    for backend in ("reference", "cuda"):
        tp, jp = _plans(a, b, dataflow, TINY, backend=backend)
        _same_tiled_plan(tp, jp)
        assert tp.scan_ok and tp.n_tiles >= 2
        extents = {p.index_plan.a_slot.shape for p in tp.plans}
        assert len(extents) == 1
        assert any(int(p.index_plan.seg_ptr[-1]) < p.index_plan.a_slot.size
                   for p in tp.plans), "no slab was padded"
        np.testing.assert_allclose(tp.apply(_t(a), _t(b)).numpy(), a @ b,
                                   **DENSE_TOL)


@pytest.mark.parametrize("tiers,lo,hi", [
    (HUGE, 1, 1), ((3500, 16384), 2, 4), (TINY, 4, 1_000)])
def test_budget_forces_one_two_many_tiles(tiers, lo, hi):
    a, b = _case(seed=4)
    for backend in ("reference", "cuda"):
        tp, jp = _plans(a, b, "gust_m", tiers, backend=backend)
        n = tp.n_tiles if isinstance(tp, TiledPlan) else 1
        assert lo <= n <= hi
        if n > 1:
            _same_tiled_plan(tp, jp)
        else:
            assert not isinstance(jp, jax_memory.TiledPlan)
            _same_sub_plan(tp, jp)
        np.testing.assert_allclose(tp.apply(a, b).numpy(), a @ b,
                                   **DENSE_TOL)


def test_op_lane_handles_non_divisible_k_grid():
    a, b = _case(seed=20, m=32, k=40, n=32, da=0.9, db=0.9)
    for backend in ("reference", "cuda"):
        tp, jp = _plans(a, b, "op_m", (3000, 3000), backend=backend)
        _same_tiled_plan(tp, jp)
        assert len({t.k1 - t.k0 for t in tp.tiles}) == 1 and tp.scan_ok
        np.testing.assert_allclose(tp.apply(a, b).numpy(),
                                   np.asarray(jp.apply(a, b)), **TOL)


@settings(max_examples=6, deadline=None)
@given(st.sampled_from(df.DATAFLOWS),
       st.floats(min_value=0.15, max_value=0.9),
       st.floats(min_value=0.15, max_value=0.9),
       st.sampled_from([1024, 4096, 16384]),
       st.sampled_from(["reference", "cuda"]))
def test_tiled_parity_property(dataflow, da, db, l1, backend):
    """Held to the dense oracle (ROADMAP queue 3)."""
    a, b = _case(seed=int(da * 1e4) + int(db * 1e3), m=32, k=40, n=24,
                 da=da, db=db)
    plan = flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                         backend=backend, device="cpu",
                         memory_budget=MemoryBudget(l1, 2 * l1))
    np.testing.assert_allclose(plan.apply(a, b).numpy(), a @ b,
                               **DENSE_TOL)
    a2, b2 = a * -1.5, b * 0.5
    np.testing.assert_allclose(plan.apply(a2, b2).numpy(), a2 @ b2,
                               **DENSE_TOL)


# -- the padded executor (the JAX scatter drops pad entries) ------------------


@pytest.mark.parametrize("dataflow", ["op_m", "gust_m", "op_n", "gust_n"])
def test_padded_stream_plan_matches_unpadded(dataflow):
    """Pad entries aim one row past the grid (``_pad_stream``): the torch
    executor must drop them, as JAX's scatter does."""
    a, b = _case(seed=5)
    plan = flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                         backend="reference", device="cpu")
    m, _, n = plan.shapes
    oob = -(-n // BS[2]) if dataflow.endswith("_n") else -(-m // BS[0])
    ip = plan.index_plan
    padded = _pad_stream(ip, int(ip.a_slot.size) + 7, oob)
    assert padded.a_slot.size == ip.a_slot.size + 7
    a_c, b_c = plan.pack_a(a).unwrap(), plan.pack_b(b).unwrap()
    run = getattr(df, dataflow)
    want = run(a_c, b_c, ip)
    got = run(a_c, b_c, padded)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), a @ b, **TOL)


# -- mixed plans --------------------------------------------------------------


def test_mixed_requires_budget():
    a, b = _hetero_case()
    with pytest.raises(ValueError, match="memory_budget"):
        flexagon_plan(a, b, dataflow="mixed", block_shape=BS, device="cpu")


@pytest.mark.parametrize("policy", ["heuristic", "simulator"])
@pytest.mark.parametrize("fmt", ["bcsr", "bcsc"])
@pytest.mark.parametrize("tiers,lo", [(HUGE, 1), (TWO, 2), (MANY, 5)])
def test_mixed_plans_equal_and_outputs_match(tiers, lo, fmt, policy):
    a, b = _hetero_case()
    for backend in ("reference", "cuda"):
        tp, jp = _plans(a, b, "mixed", tiers, backend=backend, fmt=fmt,
                        policy=policy)
        if lo == 1:
            assert not isinstance(tp, TiledPlan)
            _same_sub_plan(tp, jp)
        else:
            _same_tiled_plan(tp, jp)
            assert tp.dataflow == "mixed" and tp.n_tiles >= lo
        ref = np.asarray(jax_flexagon_plan(
            a, b, dataflow="mixed", block_shape=BS, policy=policy,
            memory_budget=JaxBudget(*tiers)).apply(a, b))
        out = tp.apply(_t(a), _t(b)).numpy()
        np.testing.assert_allclose(out, ref, **TOL)
        np.testing.assert_allclose(out, a @ b, **DENSE_TOL)
        a2, b2 = a * -0.5, b * 2.0
        np.testing.assert_allclose(tp.apply(a2, b2).numpy(), a2 @ b2,
                                   **DENSE_TOL)


def test_mixed_lanes_and_retarget_pin_choices():
    a, b = _hetero_case()
    plan = flexagon_plan(a, b, dataflow="mixed", block_shape=BS,
                         device="cpu", spec=TPU_NUMBERS,
                         memory_budget=MemoryBudget(*MANY))
    lanes = dict((d, len(i)) for d, i in plan.scan_group_meta)
    assert any(v > 1 for v in lanes.values())
    ref = plan.apply(a, b)
    on_cuda = plan.with_backend("cuda")
    assert on_cuda.backend == "cuda"
    assert on_cuda.tile_dataflows == plan.tile_dataflows
    assert dict((d, len(i)) for d, i in on_cuda.scan_group_meta) == lanes
    torch.testing.assert_close(on_cuda.apply(a, b), ref, **TOL)
    back = on_cuda.with_backend("reference")
    torch.testing.assert_close(back.apply(a, b), ref, **TOL)


def test_op_tiled_retargets_between_backends():
    a, b = _case(seed=7)
    plan = flexagon_plan(a, b, dataflow="op_m", block_shape=BS,
                         device="cpu", memory_budget=MemoryBudget(*SMALL))
    assert plan.scan_ok
    ref = plan.apply(a, b)
    on_cuda = plan.with_backend("cuda")
    assert on_cuda.backend == "cuda" and on_cuda.scan_ok
    assert all("stream_schedule" in p.aux for p in on_cuda.plans)
    assert len({p.aux["stream_schedule"].n_work for p in on_cuda.plans}) == 1
    torch.testing.assert_close(on_cuda.apply(a, b), ref, **TOL)
    torch.testing.assert_close(
        on_cuda.with_backend("reference").apply(a, b), ref, **TOL)


class _PinEachTile(api.SelectionPolicy):
    """Per-tile pin with a deliberately unique cache_key."""

    name = "pin-each-tile"

    def __init__(self, dataflow):
        self.pinned = dataflow

    @property
    def cache_key(self):
        return f"pin-each-tile:{id(self)}"

    def select(self, ctx):
        return self.pinned if self.pinned in ctx.allowed else ctx.allowed[0]


def test_plan_cache_keys_mixed_by_tile_choices():
    a, b = _hetero_case()
    four = MemoryBudget(*FOUR)
    kw = dict(dataflow="mixed", block_shape=BS, device="cpu",
              memory_budget=four)
    cache = PlanCache(spec=TPU_NUMBERS)
    p1 = cache.get(a, b, **kw)
    assert cache.get(a * 3.0, b, **kw) is p1 and cache.hits == 1
    jp = JaxPlanCache().get(a, b, dataflow="mixed", block_shape=BS,
                            memory_budget=JaxBudget(*FOUR))
    assert p1.tile_dataflows == tuple(jp.tile_dataflows)
    q1 = cache.get(a, b, policy=_PinEachTile("gust_m"), **kw)
    q2 = cache.get(a, b, policy=_PinEachTile("gust_m"), **kw)
    assert q2 is q1
    q3 = cache.get(a, b, policy=_PinEachTile("ip_m"), **kw)
    assert q3 is not q1 and q1.tile_dataflows != q3.tile_dataflows
    # budgeted and unbudgeted plans are distinct entries
    assert cache.get(a, b, block_shape=BS, device="cpu") is not \
        cache.get(a, b, block_shape=BS, device="cpu",
                  memory_budget=MemoryBudget(*HUGE))


# -- phase 2 does no phase-1 work ---------------------------------------------


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_tiled_apply_does_no_phase1_work_and_no_upload(backend, monkeypatch):
    a, b = _case(seed=5)
    plans = [flexagon_plan(a, b, dataflow=d, block_shape=BS, device="cpu",
                           backend=backend, memory_budget=MemoryBudget(*SMALL))
             for d in df.DATAFLOWS]
    h, g = _hetero_case()
    mixed = flexagon_plan(h, g, dataflow="mixed", block_shape=BS,
                          device="cpu", backend=backend,
                          memory_budget=MemoryBudget(*MANY))
    assert all(isinstance(p, TiledPlan) for p in plans + [mixed])
    cases = [(p, _t(a), _t(b), a @ b) for p in plans] + \
        [(mixed, _t(h), _t(g), h @ g)]

    def _forbidden(name):
        def fn(*args, **kwargs):
            raise AssertionError(f"{name} called during TiledPlan.apply")
        return fn

    for name in ("build_ip_plan", "build_op_plan", "build_gust_plan"):
        monkeypatch.setattr(df, name, _forbidden(name))
    monkeypatch.setattr(api.CompressionLayout, "from_bitmap",
                        _forbidden("CompressionLayout.from_bitmap"))
    before = dict(api.PHASE1_COUNTERS)
    uploads = []
    real_as_tensor = torch.as_tensor

    def counting_as_tensor(x, *args, **kwargs):
        if isinstance(x, np.ndarray):
            uploads.append(x.shape)
        return real_as_tensor(x, *args, **kwargs)

    monkeypatch.setattr(torch, "as_tensor", counting_as_tensor)
    for plan, ta, tb, want in cases:
        for _ in range(2):
            np.testing.assert_allclose(plan.apply(ta, tb).numpy(), want,
                                       **DENSE_TOL)
    assert api.PHASE1_COUNTERS == before
    assert uploads == [], "a tiled apply copied host arrays to the device"


# -- traffic pricing ----------------------------------------------------------


@pytest.mark.parametrize("dataflow", ["op_m", "gust_n", "mixed"])
def test_simulator_report_of_tiled_plans_equal(dataflow):
    a, b = _hetero_case() if dataflow == "mixed" else _case(seed=9)
    tiers = TWO if dataflow == "mixed" else SMALL
    tp, jp = _plans(a, b, dataflow, tiers, backend="simulator",
                    policy="simulator")
    _same_tiled_plan(tp, jp)
    rep = get_backend("simulator").report(tp)
    jrep = jax_get_backend("simulator").report(jp)
    assert isinstance(rep, memory.TiledSimReport)
    assert dataclasses.astuple(rep.traffic) == \
        dataclasses.astuple(jrep.traffic)
    assert [dataclasses.astuple(r) for r in rep.per_tile] == \
        [dataclasses.astuple(r) for r in jrep.per_tile]
    assert rep.dataflow_histogram == jrep.dataflow_histogram
    assert {d: dataclasses.astuple(t) for d, t in rep.per_group.items()} == \
        {d: dataclasses.astuple(t) for d, t in jrep.per_group.items()}
    np.testing.assert_allclose(tp.apply(a, b).numpy(), a @ b, **DENSE_TOL)


@pytest.mark.parametrize("dataflow", df.DATAFLOWS + ("mixed",))
def test_traffic_and_estimates_equal(dataflow):
    a, b = _hetero_case() if dataflow == "mixed" else _case(seed=10)
    occ_a, occ_b = block_occupancy(a, BS[:2]), block_occupancy(b, BS[1:])
    tiers = TWO if dataflow == "mixed" else SMALL
    mine, ref = _budgets(tiers)
    assert dataclasses.astuple(memory.tiled_traffic(
        dataflow, occ_a, occ_b, BS, mine)) == dataclasses.astuple(
        jax_memory.tiled_traffic(dataflow, occ_a, occ_b, BS, ref))
    dims = (a.shape[0], a.shape[1], b.shape[1], float(occ_a.mean()),
            float(occ_b.mean()))
    got = memory.tiled_estimate(LayerShape(*dims, BS), dataflow, mine,
                                TPU_NUMBERS, occ_a=occ_a, occ_b=occ_b)
    want = jax_memory.tiled_estimate(JaxLayerShape(*dims, BS), dataflow,
                                     ref, TPUSpec(), occ_a=occ_a,
                                     occ_b=occ_b)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    if dataflow == "mixed":
        assert memory.mixed_tile_choices(occ_a, occ_b, BS, mine) == \
            jax_memory.mixed_tile_choices(occ_a, occ_b, BS, ref)
    _eq(memory.synthetic_occupancy((7, 9), 0.3),
        jax_memory.synthetic_occupancy((7, 9), 0.3), "synthetic")


def test_sharded_pricing_under_a_budget_matches_jax():
    """The policies' sharded pricing under a budget (which raised until the
    distribution slice) prices each dataflow as the JAX package does, and
    the budgeted sharded plan tiles inside its shards."""
    from repro import dist as jax_dist
    from repro.backends.policies import HeuristicPolicy as JaxHeuristic
    from repro.backends.policies import SelectionContext as JaxContext
    from repro.backends.policies import SimulatorPolicy as JaxSimulator
    from repro.launch.mesh import make_virtual_mesh as jax_mesh

    from repro_torch.dist import DistPartition, ShardedPlan
    from repro_torch.launch.mesh import make_virtual_mesh

    a, b = _case(seed=10)
    occ_a, occ_b = block_occupancy(a, BS[:2]), block_occupancy(b, BS[1:])
    shape = LayerShape(48, 64, 40, 0.5, 0.6, BS)
    jshape = JaxLayerShape(48, 64, 40, 0.5, 0.6, BS)
    mine, ref = _budgets(TINY)
    for kw, jkw in (
            ({"mesh": make_virtual_mesh(4, "cpu")}, {"mesh": jax_mesh(4)}),
            ({"partition": DistPartition(axis="k", shards=2)},
             {"partition": jax_dist.DistPartition(axis="k", shards=2)})):
        ctx = SelectionContext(
            shape=shape, block_shape=BS, occ_a=occ_a, occ_b=occ_b,
            fingerprint="sharded", backend=get_backend("reference"),
            spec=TPU_NUMBERS, allowed=df.DATAFLOWS, memory_budget=mine,
            device="cpu", **kw)
        jctx = JaxContext(
            shape=jshape, block_shape=BS, occ_a=occ_a, occ_b=occ_b,
            fingerprint="sharded", backend=jax_get_backend("reference"),
            spec=TPUSpec(), allowed=df.DATAFLOWS, memory_budget=ref, **jkw)
        assert ctx.n_shards == jctx.n_shards > 1
        assert SimulatorPolicy().price(ctx) == JaxSimulator().price(jctx)
        assert HeuristicPolicy().select(ctx) == JaxHeuristic().select(jctx)
        plan = flexagon_plan(a, b, block_shape=BS, device="cpu",
                             memory_budget=mine, spec=TPU_NUMBERS, **kw)
        assert isinstance(plan, ShardedPlan)
        assert any(isinstance(p, TiledPlan) for p in plan.plans)
        np.testing.assert_allclose(plan.apply(a, b).numpy(), a @ b,
                                   **DENSE_TOL)
    assert {"sharded_traffic", "sharded_plan_traffic",
            "sharded_estimate"} <= set(memory.__all__)


def test_plan_network_threads_budget_as_jax():
    dims = [(64, 512, 512, 1.0, 0.4), (64, 512, 256, 1.0, 0.6)]
    seq = plan_network([LayerShape(*d, BS) for d in dims], TPU_NUMBERS,
                       memory_budget=MemoryBudget(*SMALL))
    jseq = jax_plan_network([JaxLayerShape(*d, BS) for d in dims],
                            TPUSpec(), memory_budget=JaxBudget(*SMALL))
    assert seq == jseq and all(d in df.DATAFLOWS for d in seq)


def test_compress_ffn_with_budget():
    rng = np.random.default_rng(15)
    d, f = 32, 48
    ws = {name: {"w": torch.as_tensor(
        rng.standard_normal(shape).astype(np.float32))}
        for name, shape in (("w_gate", (d, f)), ("w_up", (d, f)),
                            ("w_down", (f, d)))}
    ws["block_mask"] = torch.as_tensor(
        (rng.random((d // 8, f // 8)) > 0.4).astype(np.float32))
    comp = compress_ffn(ws, tokens=16, block=8, backend="cuda",
                        device="cpu", memory_budget=MemoryBudget(*TINY))
    entry = comp.specialize(16)
    assert isinstance(entry.plan_in, TiledPlan)
    x = torch.as_tensor(rng.standard_normal((2, 8, d)).astype(np.float32))
    mask = ws["block_mask"].numpy()
    full = np.kron(mask, np.ones((8, 8), np.float32))
    wg, wu = ws["w_gate"]["w"].numpy() * full, ws["w_up"]["w"].numpy() * full
    wd = ws["w_down"]["w"].numpy() * full.T
    x2 = x.reshape(-1, d).numpy().astype(np.float64)
    g = x2 @ wg
    want = ((g / (1 + np.exp(-g))) * (x2 @ wu)) @ wd
    np.testing.assert_allclose(sparse_ffn_apply(comp, x).reshape(-1, d)
                               .numpy(), want, **DENSE_TOL)
