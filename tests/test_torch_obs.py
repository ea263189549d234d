"""repro_torch.obs at the plan API: the span tree of ``FlexagonPlan.apply``
(K1, K2, N-stationary, the dense escape, a tiled plan), the off path, the
dataflow counters, phase 1's stage histograms, ``annotate``, and spans on
the ``torch.profiler`` trace's clock (CPU)."""
import json
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from repro_torch import MemoryBudget, flexagon_plan, obs
from repro_torch.obs import trace as trace_mod

BS = (8, 8, 8)


def _block_sparse(rng, shape, density):
    occ = rng.random((shape[0] // 8, shape[1] // 8)) < density
    occ.flat[0] = True
    mask = torch.as_tensor(occ).repeat_interleave(8, 0).repeat_interleave(8, 1)
    return torch.randn(shape, generator=torch.Generator().manual_seed(
        int(rng.integers(1 << 30)))) * mask


def _case(seed=0, m=32, k=48, n=40, da=0.4, db=0.5):
    rng = np.random.default_rng(seed)
    return _block_sparse(rng, (m, k), da), _block_sparse(rng, (k, n), db)


@pytest.fixture
def tracing():
    """Tracing on, a clean tracer; environment-driven again after."""
    tracer = obs.get_tracer()
    tracer.clear()
    obs.enable()
    yield tracer
    trace_mod._reset_override()
    tracer.clear()


@pytest.fixture
def no_tracing():
    obs.disable()
    yield obs.get_tracer()
    trace_mod._reset_override()


def _tree(spans):
    """{name: parent name} of one apply's spans (unique names)."""
    by_sid = {s.sid: s for s in spans}
    return {s.name: by_sid[s.parent].name if s.parent in by_sid else None
            for s in spans}


@pytest.mark.parametrize("dataflow,route,children", [
    ("ip_m", "k1", ["plan.apply.dispatch", "plan.apply.launch"]),
    ("gust_m", "k2", ["plan.apply.dispatch", "plan.apply.launch"]),
    ("ip_n", "k1", ["plan.apply.ingest", "plan.apply.dispatch",
                    "plan.apply.launch"]),
    ("op_n", "k1", ["plan.apply.ingest", "plan.apply.dispatch",
                    "plan.apply.launch"]),
])
def test_apply_span_tree(tracing, dataflow, route, children):
    a, b = _case()
    plan = flexagon_plan(a, b, dataflow=dataflow, block_shape=BS,
                         backend="cuda", device="cpu")
    packed = plan.pack_a(a)
    tracing.clear()
    out = plan.apply(packed, b)
    torch.testing.assert_close(out, a @ b, rtol=1e-4, atol=1e-4)
    spans = tracing.spans()
    assert [s.name for s in spans] == children + ["plan.apply"]
    tree = _tree(spans)
    assert tree.pop("plan.apply") is None
    assert set(tree.values()) == {"plan.apply"}
    root = spans[-1]
    # A came packed; the kernels read an M-stationary plan's dense B in
    # place, and an N-stationary plan gathers it
    in_place = dataflow.endswith("_m")
    assert root.attrs == {"dataflow": dataflow, "route": route,
                          "b_ingest": "in_place" if in_place else "gather"}
    assert [s.attrs for s in spans if s.name == "plan.apply.ingest"] == \
        ([] if in_place else [{"operand": "b"}])
    assert all(s.tid == threading.get_native_id() for s in spans)
    inner = [s for s in spans if s is not root]
    assert all(root.t0_ns <= s.t0_ns and s.t0_ns + s.dur_ns
               <= root.t0_ns + root.dur_ns for s in inner)


def test_dense_escape_span_tree_and_counter(tracing):
    """The escape's span tree; its applies are counted by ``route``."""
    a, b = _case(seed=2, da=0.95, db=0.95)
    plan = flexagon_plan(a, b, dataflow="ip_m", block_shape=BS,
                         backend="cuda", device="cpu")
    assert "dense" in plan.aux
    tracing.clear()
    out = plan.apply(a, b)
    torch.testing.assert_close(out, a @ b, rtol=1e-4, atol=1e-4)
    spans = tracing.spans()
    assert [s.name for s in spans] == [
        "plan.apply.ingest", "plan.apply.ingest",
        "plan.apply.escape.densify", "plan.apply.escape.gemm", "plan.apply"]
    assert [s.attrs.get("operand") for s in spans[:2]] == ["a", "b"]
    assert spans[-1].attrs == {"dataflow": "ip_m", "route": "escape",
                               "b_ingest": "gather"}
    assert set(_tree(spans).values()) == {None, "plan.apply"}
    # the kernel path routes elsewhere
    plan.apply(a, b)
    sparse = flexagon_plan(*_case(), dataflow="ip_m", block_shape=BS,
                           backend="cuda", device="cpu")
    sparse.apply(*_case())
    routes = [s.attrs["route"] for s in tracing.spans()
              if s.name == "plan.apply"]
    assert routes == ["escape", "escape", "k1"]


def test_reference_backend_routes_by_name(tracing):
    a, b = _case()
    plan = flexagon_plan(a, b, dataflow="op_m", block_shape=BS,
                         backend="reference", device="cpu")
    tracing.clear()
    plan.apply(a, b)
    spans = tracing.spans()
    assert [s.name for s in spans] == ["plan.apply.ingest",
                                       "plan.apply.ingest", "plan.apply"]
    assert spans[-1].attrs == {"dataflow": "op_m", "route": "reference",
                               "b_ingest": "gather"}


def test_tiled_apply_nests_plan_apply(tracing):
    a, b = _case(seed=3, m=64, k=64, n=64, da=0.5, db=0.5)
    plan = flexagon_plan(a, b, dataflow="ip_m", block_shape=BS,
                         backend="cuda", device="cpu",
                         memory_budget=MemoryBudget(4096, 8192))
    tracing.clear()
    out = plan.apply(a, b)
    torch.testing.assert_close(out, a @ b, rtol=1e-4, atol=1e-4)
    spans = tracing.spans()
    tiled = [s for s in spans if s.name == "memory.tiled.apply"]
    applies = [s for s in spans if s.name == "plan.apply"]
    assert len(tiled) == 1 and len(applies) == plan.n_tiles > 1
    assert {s.parent for s in applies} == {tiled[0].sid}


def test_apply_off_records_and_retains_nothing(no_tracing):
    a, b = _case()
    plan = flexagon_plan(a, b, dataflow="ip_m", block_shape=BS,
                         backend="cuda", device="cpu")
    packed = plan.pack_a(a)
    before = len(no_tracing)

    def burst():
        for _ in range(50):
            plan.apply(packed, b)

    burst()  # warm any lazy interning
    tracemalloc.start()
    s0 = tracemalloc.take_snapshot()
    burst()
    s1 = tracemalloc.take_snapshot()
    tracemalloc.stop()
    retained = sum(d.size_diff for d in s1.compare_to(s0, "filename")
                   if "obs" in (d.traceback[0].filename or ""))
    assert retained == 0
    assert len(no_tracing) == before


def test_annotate_sets_the_innermost_open_span(tracing):
    obs.annotate(lost=True)         # no span open: nothing to set
    with obs.span("outer", route="reference"):
        with obs.span("inner"):
            pass
        obs.annotate(route="k1")
    inner, outer = tracing.spans()
    assert (inner.attrs, outer.attrs) == ({}, {"route": "k1"})
    assert inner.parent == outer.sid
    obs.disable()
    with obs.span("off"):
        obs.annotate(route="k2")
    assert len(tracing) == 2


def test_dataflow_counters_count_built_plans():
    reg = obs.get_registry()
    a, b = _case(seed=4)
    before = {d: reg.value(f"plan.dataflow.{d}") for d in ("ip_m", "gust_n")}
    for d in ("ip_m", "gust_n", "ip_m"):
        flexagon_plan(a, b, dataflow=d, block_shape=BS, backend="cuda",
                      device="cpu")
    assert reg.value("plan.dataflow.ip_m") == before["ip_m"] + 2
    assert reg.value("plan.dataflow.gust_n") == before["gust_n"] + 1


def test_stage_histograms_account_for_the_build():
    """plan.pattern_s + policy.select_s + plan.tables_s + plan.prepare_s
    come within 10% of plan.build_s on a build whose stages dominate."""
    reg = obs.get_registry()
    names = ("plan.pattern_s", "policy.select_s", "plan.tables_s",
             "plan.prepare_s", "plan.build_s")
    a, b = _case(seed=5, m=512, k=512, n=1024, da=0.4, db=0.6)

    def sums():
        return {n: reg.histogram(n).sum for n in names}

    flexagon_plan(a, b, block_shape=BS, backend="cuda", device="cpu",
                  verify=False)
    before = sums()
    for _ in range(2):
        flexagon_plan(a, b, block_shape=BS, backend="cuda", device="cpu",
                      verify=False)
    got = {n: v - before[n] for n, v in sums().items()}
    stages = sum(got[n] for n in names[:-1])
    assert all(got[n] > 0 for n in names)
    assert 0.9 * got["plan.build_s"] <= stages <= got["plan.build_s"]


def test_spans_join_a_profiler_trace_on_its_clock(tmp_path, tracing):
    """An obs span around a record_function lands around it on the
    profiler trace's axis, on the same thread row."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("outer"):
            for _ in range(3):
                x = x @ x
            with record_function("marker"):
                x = x @ x
            for _ in range(3):
                x = x @ x
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace["baseTimeNanoseconds"])
    marker = [e for e in trace["traceEvents"] if e.get("name") == "marker"]
    assert len(marker) == 1
    marker = marker[0]
    chrome = obs.get_tracer().to_chrome(base_ns=base)["traceEvents"]
    outer = [e for e in chrome if e["name"] == "outer"][0]
    assert outer["tid"] == marker["tid"]
    slack = 500.0        # us: the clock pair's read and the export's rounding
    assert outer["ts"] - slack <= marker["ts"]
    assert marker["ts"] + marker["dur"] <= outer["ts"] + outer["dur"] + slack
    # without base_ns the monotonic clock, 1e12 us and more away
    plain = obs.spans_to_chrome(obs.get_tracer().spans())["traceEvents"]
    assert abs(plain[0]["ts"] - marker["ts"]) > 1e6


def test_clock_pair_maps_monotonic_onto_unix():
    import time

    obs.enable()
    try:
        unix, mono = obs.clock_pair()
        assert abs((obs.now_ns() - mono + unix) - time.time_ns()) < 5e6
    finally:
        trace_mod._reset_override()
