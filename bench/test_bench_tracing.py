"""CPU tests of the join in ``bench/tracing.py``, which every driver's
readers share: the same synthetic traces as
``bench/test_bench_program_trace.py``, read through ``bench.tracing``
itself, give the same owners and times; and no file of the benchmark
walks the interpreter's frames to find what it reads."""
import ast
from pathlib import Path

import pytest

from bench import program_trace as pt, tracing
from bench.test_bench_program_trace import TID, _trace

HERE = Path(__file__).resolve().parent
MOVED = ("read_trace", "on_thread", "innermost", "spans_on_trace",
         "by_owner", "idle_gaps", "host_idle_share", "profile",
         "UNATTRIBUTED")


@pytest.mark.parametrize("name", MOVED)
def test_the_plan_reader_uses_the_general_join(name):
    assert getattr(pt, name) is getattr(tracing, name)


def test_owners_by_innermost_span():
    ops, launches, spans = _trace()
    assert tracing.innermost(launches, spans) == {
        1: "plan.apply.ingest", 2: "plan.apply.dispatch",
        3: "plan.apply.launch", 4: "plan.apply.launch"}
    encoded = {c: (s, e, -1227222272 if t == TID else t)
               for c, (s, e, t) in launches.items()}
    assert tracing.innermost(encoded, spans) == {}
    assert tracing.on_thread(ops, encoded, TID) == launches


def test_device_time_and_gaps_by_owner():
    ops, launches, spans = _trace()
    owner = tracing.innermost(launches, spans)
    assert tracing.by_owner(ops, launches, owner) == pytest.approx({
        ("plan.apply.ingest", "index_elementwise_kernel"): 40e-6,
        ("plan.apply.dispatch", "elementwise_kernel"): 10e-6,
        ("plan.apply.launch", "Memset"): 2e-6,
        ("plan.apply.launch", "stream_dest_kernel"): 100e-6,
        (tracing.UNATTRIBUTED, "vectorized_elementwise_kernel"): 10e-6,
        (tracing.UNATTRIBUTED, "Memset"): 1e-6})
    assert tracing.idle_gaps(ops, launches, owner) == pytest.approx([
        ("queued after stream_dest_kernel", 28e-6, False),
        ("queued after vectorized_elementwise_kernel", 20e-6, False)])
    assert tracing.host_idle_share(ops, launches) == 0.0
    launches[5] = (195.0, 205.0, TID)
    assert tracing.idle_gaps(ops, launches, owner)[0] == pytest.approx(
        ("host late in unattributed", 28e-6, True))
    assert tracing.host_idle_share(ops, launches) == pytest.approx(
        100 * 28 / 211)


def test_join_fault_takes_the_readers_rule():
    """The unattributed share is the general check; which span owns what
    is the reader's rule, handed in."""
    held = {"unattributed_s": 0.005, "device_s": 1.0}
    assert tracing.join_fault(held) is None
    assert tracing.join_fault(dict(held, unattributed_s=0.0051)) == (
        "unattributed 0.0051 s of 1.0 s device time")

    def backward_rule(p):
        n = p.get("outside", 0)
        return f"{n} products outside model.backward" if n else None

    assert tracing.join_fault(held, backward_rule) is None
    assert tracing.join_fault(dict(held, outside=3), backward_rule) == (
        "3 products outside model.backward")
    assert tracing.join_fault(dict(held, unattributed_s=0.5),
                              backward_rule).startswith("unattributed")
    # the plan API's rule is one such rule, kept with the plan reader
    assert pt.join_fault(dict(held, stream_outside_launch=1)) == (
        "1 K1/K2 kernels outside plan.apply.launch")
    assert pt.plan_rule(dict(held, stream_outside_launch=0)) is None


def test_profile_steps_keeps_the_device_operations(monkeypatch):
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "void stream_dest_kernel<2>(W)",
         "ts": 10.0, "dur": 5.0, "args": {"correlation": 3}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
         "ts": 16.0, "dur": 1.0, "args": {}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 2.0, "dur": 1.0, "tid": 11, "args": {"correlation": 3}}]}
    monkeypatch.setattr(tracing, "profile", lambda fn: trace)
    assert tracing.profile_steps(None) == [
        ("stream_dest_kernel", 10.0, 15.0), ("Memset", 16.0, 17.0)]


#: what walks the interpreter's frames: attributes, and functions of
#: ``sys`` and ``inspect``
FRAME_ATTRS = {"f_back", "f_locals", "f_globals", "_getframe"}
FRAME_FUNCS = {"currentframe", "stack", "getouterframes", "_getframe"}


def _walks_frames(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            if node.attr in FRAME_ATTRS:
                yield node.lineno
            elif (node.attr in FRAME_FUNCS and isinstance(node.value, ast.Name)
                  and node.value.id in ("inspect", "sys")):
                yield node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module in (
                "inspect", "sys"):
            if any(a.name in FRAME_FUNCS for a in node.names):
                yield node.lineno


def test_no_file_walks_interpreter_frames():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        assert list(_walks_frames(ast.parse(path.read_text()))) == [], path
    # the scan finds what it looks for
    assert list(_walks_frames(ast.parse(
        "import sys\nf = sys._getframe(1).f_back\n"))) == [2, 2]
