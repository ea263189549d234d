"""The training step's spans on the device trace: the reader that the
``lm_train`` driver's program-span metrics share.

The join is ``bench/tracing.py``'s: each device operation is joined to the
call that launched it through the ``correlation`` the profiler gives both.
This file adds the training step's rule of who owns that call
(:func:`owners`), for a step whose backward runs on autograd's own thread:

- a call inside a span of the program (``repro_torch.obs``) is owned by the
  innermost one open on its thread: the step's spans on the thread that
  steps, the recomputed layer's spans (``checkpoint``) and
  ``moe.experts.backward`` on autograd's;
- a call that autograd's thread makes inside a backward node (the
  profiler's ``autograd::engine::evaluate_function: ...``) with no span of
  its own open is owned by the span in which the node's forward operation
  ran: the node's ``Sequence number`` and ``Fwd thread id`` name that
  operation, and its start on the stepping thread names the span;
- any other call of the backward is owned by ``train.backward``.

Which thread a span or call belongs to is told by time, not by the
trace's thread ids (a trace of the device writes its launch rows' thread
in an encoding of its own): the stepping thread's calls fall outside the
backward's nodes, autograd's inside them.  A join in which a K3 or K3w
kernel is owned by another span than ``moe.experts`` and
``moe.experts.backward``, or more than ``tracing.UNATTRIBUTED_SHARE`` of
the device time by no span, is no reading (:func:`train_rule`,
``tracing.join_fault``).

:func:`of` takes, once per traced run, one more span of the cell's steps
after the harness's own (which gives ``host_idle_share`` from its launch
rows): tracing on (``obs.enable()``, a cleared tracer), the host's
operators recorded, from which come device time by owner and the result
line's breakdown (``<span>/<op>``, ``host late in <span>``, ``queued after
<op>``).  Times in a Chrome trace are microseconds.
"""
from __future__ import annotations

import bisect
import gc
import sys
import threading
import traceback
from collections import Counter

from bench import tracing
from bench.tracing import (UNATTRIBUTED, by_owner, idle_gaps, innermost,
                           read_trace, spans_on_trace)

#: K3's and K3w's kernels
K3_KERNELS = ("gmm_mma_kernel", "gmm_fma_kernel", "gmm_reduce_kernel")
K3W_KERNELS = ("wgrad_tma_kernel", "wgrad_mma_kernel", "wgrad_fma_kernel")
#: the spans that may own K3's and K3w's kernels
EXPERT_SPANS = ("moe.experts", "moe.experts.backward")
#: the prefix of a backward node's operator in the profiler's trace
NODE = "autograd::engine::evaluate_function"
#: steps traced before the kept ones, the kept steps of the tracing-on
#: span, and spans taken at most where one loses operations
WARM, TRACED, TRIES = 1, 1, 3


def backward_nodes(trace):
    """The backward's nodes as (start, end, sequence number, forward
    thread id), by start."""
    out = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and str(e.get("name", "")).startswith(NODE):
            args = e.get("args") or {}
            start = float(e["ts"])
            out.append((start, start + float(e.get("dur", 0.0)),
                        args.get("Sequence number"),
                        args.get("Fwd thread id")))
    return sorted(out)


def forward_ops(trace, windows):
    """Sequence number -> starts of the forward operators that carry it,
    on the trace thread with the most of them inside ``windows`` ((start,
    end) of the stepping thread's forward spans)."""
    rows = []
    for e in trace.get("traceEvents", []):
        args = e.get("args") or {}
        if e.get("ph") == "X" and e.get("cat") == "cpu_op" \
                and "Sequence number" in args \
                and not str(e.get("name", "")).startswith(NODE):
            rows.append((float(e["ts"]), e.get("tid"),
                         args["Sequence number"]))
    inside = Counter(tid for t, tid, _ in rows
                     if any(s <= t <= e for s, e in windows))
    if not inside:
        return {}
    main = inside.most_common(1)[0][0]
    out = {}
    for t, tid, seq in rows:
        if tid == main:
            out.setdefault(seq, []).append(t)
    for starts in out.values():
        starts.sort()
    return out


def _at(times, spans, tid):
    """Key -> name of the innermost of ``spans`` (all on thread ``tid``)
    open at each time of ``times`` (key -> time)."""
    return innermost({k: (t, t, tid) for k, t in times.items()}, spans)


def _node_at(nodes, starts, t):
    """The index of the backward node open at ``t``, or None (one thread
    runs the nodes, one after another: ``starts`` their starts)."""
    i = bisect.bisect_right(starts, t) - 1
    return i if i >= 0 and nodes[i][1] >= t else None


def owners(launches, spans, main_tid, nodes, fwd):
    """Correlation -> owner of each launch call (module docstring).

    ``launches``: correlation -> (start, end, tid) on the trace's axis;
    ``spans``: (start, end, name, tid) on the same axis, ``tid`` the
    program's (native) thread ids, ``main_tid`` the stepping thread's;
    ``nodes``: :func:`backward_nodes`; ``fwd``: :func:`forward_ops`."""
    main = [s for s in spans if s[3] == main_tid]
    starts = {c: v[0] for c, v in launches.items()}
    on_main = _at(starts, main, main_tid)
    on_side = {}
    for tid in {s[3] for s in spans} - {main_tid}:
        on_side.update(_at(starts, [s for s in spans if s[3] == tid], tid))
    counts = Counter(n[3] for n in nodes if n[3] is not None)
    linked_tid = counts.most_common(1)[0][0] if counts else None
    # the forward operation each backward node names, and its span
    fwd_at = {}
    for i, (start, _, seq, ftid) in enumerate(nodes):
        if ftid != linked_tid or seq not in fwd:
            continue
        earlier = [t for t in fwd[seq] if t <= start]
        if earlier:
            fwd_at[i] = earlier[-1]
    span_of = _at(fwd_at, main, main_tid)
    node_starts = [n[0] for n in nodes]
    out = {}
    for c, t in starts.items():
        if c in on_side:
            out[c] = on_side[c]
            continue
        node = _node_at(nodes, node_starts, t)
        if node is None:
            if c in on_main:
                out[c] = on_main[c]
            continue
        out[c] = span_of.get(node, "train.backward")
    return out


def summarize(ops, launches, owner, steps):
    """Device milliseconds a step by owning span, the rule's counts and
    the breakdown, from the kept steps' operations."""
    times = by_owner(ops, launches, owner)
    gaps = Counter()
    for name, s, _ in idle_gaps(ops, launches, owner):
        gaps[name] += s
    per_span = Counter()
    for (who, _), v in times.items():
        per_span[who] += v / steps * 1e3
    top = Counter({f"{w}/{n}": v for (w, n), v in times.items()})
    return {
        "span_ms": dict(per_span),
        "experts_outside": sum(
            1 for name, _, _, corr in ops
            if name in K3_KERNELS + K3W_KERNELS
            and owner.get(corr) not in EXPERT_SPANS),
        "unattributed_s": sum(v for (w, _), v in times.items()
                              if w == UNATTRIBUTED),
        "device_s": sum(times.values()),
        "window_ms": (max(o[2] for o in ops) - min(o[1] for o in ops))
        / steps / 1e3,
        "device_ops": [[n, s] for n, s in top.most_common(10)],
        "idle_gaps": [[n, s] for n, s in gaps.most_common(10)],
    }


def train_rule(p):
    """The training step's rule of the join: every K3 and K3w kernel
    owned by ``moe.experts`` or ``moe.experts.backward``; why ``p`` broke
    it, or None."""
    if p["experts_outside"]:
        return (f"{p['experts_outside']} K3/K3w kernels outside "
                f"{' and '.join(EXPERT_SPANS)}")
    return None


def profile_host(fn):
    """Run ``fn()`` under the profiler with the device and the host's
    operators recorded; returns the Chrome trace as a dict."""
    import json
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


def kept(ops, steps, skip=WARM):
    """The last ``steps`` of ``skip + steps`` steps' operations, by start;
    None where they do not divide into equal shares."""
    total = skip + steps
    if not ops or len(ops) % total:
        return None
    per = len(ops) // total
    return sorted(ops, key=lambda o: o[1])[skip * per:]


def _traced(run):
    """``WARM + TRACED`` steps under :func:`profile_host`, tracing on: the
    operations, the launch rows, the trace and the spans (on the trace's
    axis), or None where every try lost K3/K3w kernels or spans."""
    from repro_torch import obs

    tracer = obs.get_tracer()
    for attempt in range(1, TRIES + 1):
        tracer.clear()
        before = run.launches()
        obs.enable()
        try:
            trace = profile_host(lambda: run.steps(count=WARM + TRACED))
        finally:
            obs.disable()
        launched = run.launches() - before
        ops, launches = read_trace(trace)
        seen = sum(1 for o in ops if o[0] in K3_KERNELS[:2] + K3W_KERNELS)
        if seen == launched and launches and not tracer.dropped:
            spans = spans_on_trace(tracer.spans(), int(
                trace.get("baseTimeNanoseconds", 0)))
            return {"ops": ops, "launches": launches, "trace": trace,
                    "spans": spans}
        print(f"train trace: span {attempt} of {TRIES} lost operations: "
              f"{seen} K3/K3w kernels of {launched}, {len(ops)} operations, "
              f"{len(launches)} launch rows, {tracer.dropped} spans dropped",
              file=sys.stderr)
    return None


def in_steps(ops, launches, spans, tid, count):
    """The operations launched inside the last ``count`` ``train.step``
    spans of thread ``tid`` (a step's backward, on autograd's thread, lies
    inside its span too)."""
    steps = sorted(s for s in spans if s[2] == "train.step" and s[3] == tid)
    if len(steps) < count:
        return []
    lo, hi = steps[-count][0], steps[-1][1]
    return [o for o in ops
            if o[3] in launches and lo <= launches[o[3]][0] <= hi]


def _measure(run):
    on = _traced(run)
    if on is None:
        return None
    trace, spans = on["trace"], on["spans"]
    main_tid = threading.get_native_id()
    ops = in_steps(on["ops"], on["launches"], spans, main_tid, TRACED)
    if not ops:
        return None
    windows = [(s[0], s[1]) for s in spans
               if s[2] == "train.forward" and s[3] == main_tid]
    nodes = backward_nodes(trace)
    owner = owners(on["launches"], spans, main_tid, nodes,
                   forward_ops(trace, windows))
    p = summarize(ops, on["launches"], owner, TRACED)
    p["nodes"] = len(nodes)
    fault = tracing.join_fault(p, train_rule)
    if fault:
        print(f"train trace: the join did not hold ({fault}): no program "
              f"metrics", file=sys.stderr)
        return None
    return p


def _report(ctx, p):
    """The result line's breakdown, left on ``ctx.breakdown``, and two
    lines on standard error."""
    ctx.breakdown = {"device_ops": p["device_ops"],
                     "idle_gaps": p["idle_gaps"]}
    spans = {k: round(v, 3) for k, v in sorted(
        p["span_ms"].items(), key=lambda kv: -kv[1])}
    off = ctx.trace["window_s"] / ctx.trace["steps"] * 1e3
    for line in (
            f"train trace: device ms a step by span {spans}",
            f"train trace: unattributed {p['unattributed_s']!r} s of "
            f"{p['device_s']!r} s device time; {p['nodes']} backward nodes; "
            f"tracing on (host operators recorded) {p['window_ms']!r} ms a "
            f"step against {off!r} off"):
        print(line, file=sys.stderr)


def of(ctx):
    """What the tracing-on span of the run on ``ctx.run`` read, taken once
    per run and kept on ``ctx``; None off the card, where the harness's
    traced span was no reading, where a span lost operations or where the
    join did not hold.  A failure is printed, never raised."""
    if hasattr(ctx, "train_trace"):
        return ctx.train_trace
    ctx.train_trace = None
    run = getattr(ctx, "run", None) if ctx.trace else None
    if run is None:
        return None
    gc.collect()
    gc.freeze()
    try:
        ctx.train_trace = _measure(run)
        if ctx.train_trace:
            _report(ctx, ctx.train_trace)
    except Exception:       # noqa: BLE001 — a reader must not end the run
        traceback.print_exc(file=sys.stderr)
        ctx.train_trace = None
    finally:
        gc.unfreeze()
    return ctx.train_trace


def span_ms(ctx, names):
    """Device ms a step owned by the spans ``names``, or None."""
    got = of(ctx)
    if not got:
        return None
    return sum(got["span_ms"].get(n, 0.0) for n in names)
