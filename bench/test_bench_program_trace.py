"""CPU tests of the join of device operations to the program's spans
(``bench/program_trace.py``) on synthetic traces, and of the readers that
read it."""
from types import SimpleNamespace

import pytest

from bench import harness, program_trace as pt

SPEC = harness.load_spec()
TID = 7


def _trace():
    """One step on one thread: apply [0, 100) holding ingest [5, 30),
    dispatch [30, 40) and launch [40, 90); a launch at 105, after the
    apply; ops on the device, one with no launch row (a profiler's own
    memset).  Times in us."""
    spans = [(0.0, 100.0, "plan.apply", TID), (5.0, 30.0, "plan.apply.ingest",
                                                TID),
             (30.0, 40.0, "plan.apply.dispatch", TID),
             (40.0, 90.0, "plan.apply.launch", TID)]
    launches = {1: (10.0, 14.0, TID),        # B's gather
                2: (33.0, 35.0, TID),        # an fp32 copy
                3: (45.0, 47.0, TID),        # the zeroed output
                4: (50.0, 54.0, TID),        # K1
                5: (105.0, 107.0, TID),      # outside every span
                6: (12.0, 13.0, TID + 1)}    # another thread's
    ops = [("index_elementwise_kernel", 20.0, 60.0, 1),
           ("elementwise_kernel", 60.0, 70.0, 2),
           ("Memset", 70.0, 72.0, 3),
           ("stream_dest_kernel", 72.0, 172.0, 4),
           ("vectorized_elementwise_kernel", 200.0, 210.0, 5),
           ("Memset", 230.0, 231.0, 9)]
    return ops, launches, spans


def test_innermost_span_by_thread():
    ops, launches, spans = _trace()
    owner = pt.innermost(launches, spans)
    assert owner == {1: "plan.apply.ingest", 2: "plan.apply.dispatch",
                     3: "plan.apply.launch", 4: "plan.apply.launch"}


def test_innermost_pops_closed_siblings():
    spans = [(0.0, 10.0, "a", 1), (2.0, 4.0, "b", 1), (5.0, 8.0, "c", 1),
             (20.0, 30.0, "d", 1)]
    launches = {1: (3.0, 3.5, 1), 2: (4.5, 4.6, 1), 3: (6.0, 6.1, 1),
                4: (15.0, 15.1, 1), 5: (25.0, 25.1, 1)}
    assert pt.innermost(launches, spans) == {1: "b", 2: "a", 3: "c",
                                             5: "d"}


def test_spans_match_the_launching_thread():
    """Launch rows whose thread the trace wrote in another encoding are
    renamed to the spans' thread: the thread behind most device ops."""
    ops, launches, spans = _trace()
    encoded = {c: (s, e, -1227222272 if t == TID else t)
               for c, (s, e, t) in launches.items()}
    assert pt.innermost(encoded, spans) == {}
    renamed = pt.on_thread(ops, encoded, TID)
    assert renamed == launches
    assert pt.innermost(renamed, spans) == pt.innermost(launches, spans)


def test_device_time_by_span():
    ops, launches, spans = _trace()
    owner = pt.innermost(launches, spans)
    got = pt.by_owner(ops, launches, owner)
    assert got == pytest.approx({
        ("plan.apply.ingest", "index_elementwise_kernel"): 40e-6,
        ("plan.apply.dispatch", "elementwise_kernel"): 10e-6,
        ("plan.apply.launch", "Memset"): 2e-6,
        ("plan.apply.launch", "stream_dest_kernel"): 100e-6,
        ("unattributed", "vectorized_elementwise_kernel"): 10e-6,
        ("unattributed", "Memset"): 1e-6})


def test_gaps_named_by_what_the_host_did():
    """The gap before op 5 (launched at 105-107, before the device went idle
    at 172) is not the host's: it was queued.  Op 9 has no launch row."""
    ops, launches, spans = _trace()
    owner = pt.innermost(launches, spans)
    assert pt.idle_gaps(ops, launches, owner) == pytest.approx([
        ("queued after stream_dest_kernel", 28e-6, False),
        ("queued after vectorized_elementwise_kernel", 20e-6, False)])
    # the host launches op 5 only at 195-205: late, inside no span
    launches[5] = (195.0, 205.0, TID)
    assert pt.idle_gaps(ops, launches, owner)[0] == pytest.approx(
        ("host late in unattributed", 28e-6, True))
    # ... or inside the launch span
    spans = spans + [(190.0, 210.0, "plan.apply.launch", TID)]
    owner = pt.innermost(launches, spans)
    assert pt.idle_gaps(ops, launches, owner)[0][0] == \
        "host late in plan.apply.launch"


def test_host_idle_share():
    ops, launches, _ = _trace()
    assert pt.host_idle_share(ops, launches) == 0.0
    launches[5] = (195.0, 205.0, TID)
    # 28 us of host-late gap in a window of 211 us
    assert pt.host_idle_share(ops, launches) == pytest.approx(
        100 * 28 / 211)


def test_kept_drops_the_first_steps_or_refuses():
    ops = [("k", float(i), i + 0.5, i) for i in range(10)]
    assert pt.kept(ops, steps=3, skip=2) == ops[4:]
    assert pt.kept(ops[:9], steps=3, skip=2) is None
    assert pt.kept([], steps=1) is None


def _records(base_ns):
    """obs span records of ``_trace``'s spans, on the trace's axis once
    mapped through ``base_ns``, and their apply's attributes."""
    from repro_torch import obs
    from repro_torch.obs import SpanRecord

    unix, mono = obs.clock_pair()
    _, _, spans = _trace()
    out = []
    for sid, (s, e, name, tid) in enumerate(spans, 1):
        t0 = int(s * 1e3) - unix + mono + base_ns
        out.append(SpanRecord(name, t0, int((e - s) * 1e3), tid, sid,
                              None if sid == 1 else 1,
                              {"route": "k1", "b_ingest": "in_place"}
                              if sid == 1 else {}))
    return out


def test_summarize_reads_the_program_spans():
    ops, launches, _ = _trace()
    base = 1_790_000_000 * 10 ** 9
    got = pt.summarize(ops, launches, _records(base), base, steps=1,
                       applies_per_step=1)
    assert got["apply_us"] == pytest.approx(100.0)
    assert got["routes"] == {"k1": 1}
    assert got["b_ingest"] == {"in_place": 1}
    assert got["ingest_ms"] == pytest.approx(0.040)
    # the fp32 copy and the zeroed output, not K1
    assert got["dispatch_ms"] == pytest.approx(0.012)
    assert got["escape_ms"] == 0.0
    assert got["k1_ms"] == pytest.approx(0.100)
    assert got["stream_outside_launch"] == 0
    assert got["unattributed_s"] == pytest.approx(11e-6)
    assert got["device_s"] == pytest.approx(163e-6)
    assert got["device_ops"][0] == pytest.approx(
        ["plan.apply.launch/stream_dest_kernel", 100e-6])
    assert dict(got["idle_gaps"]) == pytest.approx({
        "queued after stream_dest_kernel": 28e-6,
        "queued after vectorized_elementwise_kernel": 20e-6})
    # a program with no plan.apply span gives nothing; a trace whose
    # launches joined no span is a join that did not hold
    assert pt.summarize(ops, launches, [], base, 1, 1) is None
    elsewhere = {c: (s, e, TID + 5) for c, (s, e, _) in launches.items()}
    lost = pt.summarize(ops, elsewhere, _records(base), base, 1, 1)
    assert lost["unattributed_s"] == lost["device_s"]
    assert pt.join_fault(lost) == \
        "1 K1/K2 kernels outside plan.apply.launch"


def test_read_trace_takes_device_ops_and_launch_rows():
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "void stream_dest_kernel<2>(W)",
         "ts": 10.0, "dur": 5.0, "args": {"correlation": 3}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 2.0, "dur": 1.0, "tid": 11, "args": {"correlation": 3}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel",
         "ts": 4.0, "dur": 1.0, "tid": 11, "args": {"correlation": 4}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1.0,
         "dur": 9.0, "tid": 11, "args": {}},
        {"ph": "f", "cat": "ac2g", "id": 3, "ts": 10.0}]}
    ops, launches = pt.read_trace(trace)
    assert ops == [("stream_dest_kernel", 10.0, 15.0, 3)]
    assert launches == {3: (2.0, 3.0, 11), 4: (4.0, 5.0, 11)}


def _ctx(**kw):
    base = dict(apply_s=0.5, applies=3600, trace={"steps": 16},
                program_trace={"host_idle_share": 0.2, "program": {
                    "apply_us": 150.0, "ingest_ms": 7.5, "dispatch_ms": 2.0,
                    "escape_ms": 9.0}})
    base.update(kw)
    return SimpleNamespace(**base)


def test_new_metric_readers():
    read = {m["name"]: harness.reader_of(m["name"])
            for m in SPEC["per_layer"]}
    ctx = _ctx()
    assert read["apply_us"](ctx) == 150.0
    assert read["ingest_ms_per_step"](ctx) == 7.5
    assert read["dispatch_ms_per_step"](ctx) == 2.0
    assert read["escape_ms_per_step"](ctx) == 9.0
    assert read["host_idle_share"](ctx) == 0.2
    # a program without the spans: only the launch rows' reading
    bare = _ctx(program_trace={"host_idle_share": 0.1, "program": None})
    assert read["apply_us"](bare) is None
    assert read["host_idle_share"](bare) == 0.1
    # no trace (off the card, or a trace that lost operations): nothing
    none = SimpleNamespace(trace=None)
    for name in ("apply_us", "ingest_ms_per_step", "host_idle_share"):
        assert read[name](none) is None


def test_plan_stage_readers_sum_the_histograms():
    import numpy as np
    import torch

    from repro_torch import flexagon_plan, obs

    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal((32, 48)), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((48, 40)), dtype=torch.float32)
    flexagon_plan(a, b, block_shape=(8, 8, 8), backend="cuda", device="cpu",
                  verify=False)
    reg = obs.get_registry()
    for metric, hist in (("plan_pattern_s", "plan.pattern_s"),
                         ("plan_select_s", "policy.select_s"),
                         ("plan_tables_s", "plan.tables_s"),
                         ("plan_prepare_s", "plan.prepare_s")):
        got = harness.reader_of(metric)(SimpleNamespace())
        assert got == reg.get(hist).sum and got > 0


def test_a_failing_second_span_is_printed_not_raised(capsys):
    """A reader must not end the run: a failure inside the extra spans
    prints its traceback and gives no reading."""

    class Broken:
        traffic = {"trace_steps": 2}

        def steps(self, **kw):
            raise RuntimeError("no device")

        def launches(self):
            raise RuntimeError("no device")

    ctx = SimpleNamespace(trace={"steps": 2}, run=Broken())
    assert harness.reader_of("apply_us")(ctx) is None
    assert "RuntimeError: no device" in capsys.readouterr().err
    # once per run: the second reader reads the kept answer
    assert harness.reader_of("host_idle_share")(ctx) is None
    assert capsys.readouterr().err == ""


def test_new_metrics_are_declared():
    per = {m["name"]: m for m in SPEC["per_layer"]}
    both = ["distilbert.b64", "resnet50.b128"]
    for name, source, moves in (
            ("plan_pattern_s", "program_counter", "setup_s"),
            ("plan_select_s", "program_counter", "setup_s"),
            ("plan_tables_s", "program_counter", "setup_s"),
            ("plan_prepare_s", "program_counter", "setup_s"),
            ("apply_us", "program_span", "samples_per_s"),
            ("ingest_ms_per_step", "program_span", "samples_per_s"),
            ("dispatch_ms_per_step", "program_span", "samples_per_s"),
            ("host_idle_share", "device_trace", "samples_per_s")):
        assert (per[name]["source"], per[name]["moves"],
                per[name]["workloads"]) == (source, moves, both)
    assert per["escape_ms_per_step"]["workloads"] == ["distilbert.b64"]
    # appended after the accepted ones
    assert [m["name"] for m in SPEC["per_layer"]][:8] == [
        "plan_s", "apply_host_us", "launches_per_step", "k1_ms_per_step",
        "k2_ms_per_step", "spmm_roofline", "step_mfu", "idle_share"]


class _FakeRun:
    """A run of one apply a step whose K1 launch lies inside the program's
    ``plan.apply.launch`` span; ``profile`` below makes its trace."""

    traffic = {"trace_steps": 2}
    layers = ["L0"]

    def __init__(self):
        self.launched, self.times = 0, []
        self.apply_s, self.applies = 0.0, 0

    def launches(self):
        return self.launched

    def steps(self, count):
        from repro_torch import obs

        for _ in range(count):
            with obs.span("plan.apply", dataflow="ip_m", route="k1",
                          b_ingest="in_place"):
                with obs.span("plan.apply.launch"):
                    self.times.append(obs.now_ns())
            self.launched += 1
            self.apply_s += 1e-4
            self.applies += 1


def _fake_profile(run, lose_first, shift_us=0.0, stray_us=0.0):
    """A device-only trace of the steps ``fn`` runs: a launch row (its
    thread in another encoding) at each launch, ``shift_us`` later than
    the program's clock puts it, and a K1 kernel 5 us after it; the first
    trace taken loses a kernel where ``lose_first``.  ``stray_us``: each
    step also runs a copy of that length that no launch row launched."""
    from repro_torch import obs

    calls = []

    def profile(fn):
        run.times.clear()
        fn()
        unix, mono = obs.clock_pair()
        base = unix - 10 ** 9
        events = []
        for i, t in enumerate(run.times):
            ts = (t + unix - mono - base) / 1e3 + shift_us
            if stray_us:
                events.append({"ph": "X", "cat": "gpu_memcpy", "ts": ts + 8,
                               "dur": stray_us, "name": "Memcpy DtoD",
                               "args": {"correlation": 10 ** 6 + i}})
            events.append({"ph": "X", "cat": "cuda_runtime", "ts": ts,
                           "dur": 1.0, "tid": 123, "args": {
                               "correlation": i}})
            if not (lose_first and not calls and i == 0):
                events.append({"ph": "X", "cat": "kernel", "ts": ts + 5,
                               "dur": 2.0, "name": "stream_dest_kernel",
                               "args": {"correlation": i}})
        calls.append(len(events))
        return {"traceEvents": events, "baseTimeNanoseconds": base}

    return profile


@pytest.mark.parametrize("lose_first", [False, True])
def test_extra_spans_end_to_end(monkeypatch, capsys, lose_first):
    """The two extra spans on a fake run, handed over on ``ctx.run``: the
    program's spans join its launches, the breakdown is named by span and
    left on ``ctx.breakdown``, and a span that lost operations is taken
    again."""
    run_ = _FakeRun()
    monkeypatch.setattr(pt, "profile", _fake_profile(run_, lose_first))
    ctx = SimpleNamespace(
        trace={"steps": 2, "ops": {"stream_dest_kernel": 4e-6},
               "window_s": 1e-3, "device_ops": [], "idle_gaps": []},
        apply_s=1e-3, applies=10, run=run_)
    got = pt.of(ctx)
    err = capsys.readouterr().err
    assert ("span 1 of 3 (tracing off) lost operations" in err) == lose_first
    assert got["host_idle_share"] == 0.0
    p = got["program"]
    assert p["routes"] == {"k1": 1.0}
    assert p["k1_ms"] == pytest.approx(0.002)
    assert p["unattributed_s"] == 0 and p["stream_outside_launch"] == 0
    [[name, seconds]] = ctx.breakdown["device_ops"]
    assert name == "plan.apply.launch/stream_dest_kernel"
    assert seconds == pytest.approx(4e-6)
    assert ctx.trace["device_ops"] == []
    assert ("program trace: applies a step by route {'k1': 1.0}, by "
            "b_ingest {'in_place': 1.0}") in err
    assert harness.reader_of("apply_us")(ctx) == p["apply_us"] > 0


@pytest.mark.parametrize("fault,kw", [
    ("2 K1/K2 kernels outside plan.apply.launch", {"shift_us": 1e7}),
    ("unattributed", {"stray_us": 0.02}),
])
def test_a_join_that_lost_attribution_is_no_reading(monkeypatch, capsys,
                                                    fault, kw):
    """A clock pair that moves every launch out of the spans (10 s), or
    device time that no span launched beyond the limit (1% here): the
    program's metrics read nothing and the breakdown stays the harness's,
    while ``host_idle_share`` (no spans needed) still reads."""
    run_ = _FakeRun()
    monkeypatch.setattr(pt, "profile", _fake_profile(run_, False, **kw))
    ctx = SimpleNamespace(
        trace={"steps": 2, "ops": {"stream_dest_kernel": 4e-6},
               "window_s": 1e-3, "device_ops": [], "idle_gaps": []},
        apply_s=1e-3, applies=10, run=run_)
    got = pt.of(ctx)
    err = capsys.readouterr().err
    assert "program trace: the join did not hold (" + fault in err
    assert got["program"] is None and got["host_idle_share"] is not None
    assert not hasattr(ctx, "breakdown")
    for name in ("apply_us", "ingest_ms_per_step", "dispatch_ms_per_step",
                 "escape_ms_per_step"):
        assert harness.reader_of(name)(ctx) is None
    assert harness.reader_of("host_idle_share")(ctx) == got[
        "host_idle_share"]


def test_join_fault_limits():
    held = {"stream_outside_launch": 0, "unattributed_s": 0.005,
            "device_s": 1.0}
    assert pt.join_fault(held) is None
    assert pt.join_fault(dict(held, unattributed_s=0.0051)).startswith(
        "unattributed")
    assert pt.join_fault(dict(held, stream_outside_launch=2)).startswith(
        "2 K1/K2")
