"""The program's own spans on the device trace.

Each device operation is joined to the CUDA runtime (or driver) call that
launched it, through the ``correlation`` the profiler gives both, and that
call to the innermost program span (``repro_torch.obs``) open on its
thread at that time: the operation's ``owner``.  Spans come onto the
profiler trace's clock through ``obs.spans_to_chrome(spans, base_ns=...)``.

:func:`of` takes, once per traced run, two more spans of the cell's steps
after the harness's own device-only one (which it leaves as it is):

- tracing off, the device and the launch calls recorded: which idle gaps
  the host caused (``host_idle_share``);
- tracing on (``obs.enable()``, a cleared tracer): device time by owner,
  the mean ``plan.apply`` span, and the result line's breakdown named by
  owner (``<span>/<op>``) and by what the host was doing in each gap;
  nothing of it where the join lost attribution (:func:`join_fault`).

Times in a Chrome trace are microseconds.
"""
from __future__ import annotations

import gc
import json
import os
import sys
import tempfile
import threading
import traceback
from collections import Counter

from bench.tracing import DEVICE_CATS, short_name

#: trace categories of the host calls that launch device work
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: K1's and K2's kernels
STREAM_KERNELS = ("stream_dest_kernel", "stream_reduce_kernel",
                  "stream_panel_kernel", "stream_panel_reduce_kernel")
K1_KERNELS = STREAM_KERNELS[:2]
#: the owner of an operation no program span launched
UNATTRIBUTED = "unattributed"
#: steps traced before the kept ones, as ``Run.trace`` does
WARM = 4
#: the largest share of device time no program span may own in a join that
#: is a reading
UNATTRIBUTED_SHARE = 0.005


def profile(fn):
    """Run ``fn()`` under the profiler with the device recorded (which
    records the launch calls too, without the host's operators); returns
    the Chrome trace as a dict."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


def _corr(e):
    c = (e.get("args") or {}).get("correlation")
    return None if c is None else int(c)


def read_trace(trace):
    """(device operations as (name, start, end, correlation), launch calls
    by correlation as (start, end, tid)) of a Chrome trace."""
    ops, launches = [], {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start = float(e["ts"])
        end = start + float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            ops.append((short_name(str(e.get("name", ""))), start, end,
                        _corr(e)))
        elif e.get("cat") in LAUNCH_CATS and _corr(e) is not None:
            launches[_corr(e)] = (start, end, e.get("tid"))
    return ops, launches


def on_thread(ops, launches, tid):
    """``launches`` with the thread behind most of ``ops`` renamed
    ``tid``: spans are matched by time on the launching thread, since a
    device-only trace writes a launch row's thread in an encoding of its
    own (not the native id the spans carry)."""
    tids = Counter(launches[o[3]][2] for o in ops if o[3] in launches)
    if not tids:
        return launches
    launcher = tids.most_common(1)[0][0]
    return {c: (s, e, tid if t == launcher else t)
            for c, (s, e, t) in launches.items()}


def kept(ops, steps, skip=WARM):
    """The last ``steps`` of ``skip + steps`` steps' operations, by start;
    None where they do not divide into equal shares (a trace that lost
    operations), as ``tracing.reduce`` rules."""
    total = skip + steps
    if not ops or len(ops) % total:
        return None
    per = len(ops) // total
    return sorted(ops, key=lambda o: o[1])[skip * per:]


def innermost(launches, spans):
    """Correlation -> name of the innermost span, of ``spans`` as (start,
    end, name, tid), open on the launching thread when the call began."""
    by_tid = {}
    for s in spans:
        by_tid.setdefault(s[3], []).append(s)
    owner = {}
    for tid, group in by_tid.items():
        group.sort(key=lambda s: (s[0], -s[1]))
        calls = sorted((start, corr) for corr, (start, _, t)
                       in launches.items() if t == tid)
        stack, i = [], 0
        for t, corr in calls:
            while i < len(group) and group[i][0] <= t:
                while stack and stack[-1][1] <= group[i][0]:
                    stack.pop()
                stack.append(group[i])
                i += 1
            while stack and stack[-1][1] <= t:
                stack.pop()
            if stack:
                owner[corr] = stack[-1][2]
    return owner


def spans_on_trace(spans, base_ns):
    """obs span records as (start, end, name, tid) on the trace's axis."""
    from repro_torch import obs

    return [(e["ts"], e["ts"] + e["dur"], e["name"], e["tid"])
            for e in obs.spans_to_chrome(spans, base_ns=base_ns)[
                "traceEvents"]]


def _merged(ops):
    out = []
    for _, s, e, _ in sorted(ops, key=lambda o: o[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_gaps(ops, launches, owner=None):
    """Each idle gap of ``ops`` as (name, seconds, host_late).

    The host was late where the operation after the gap was launched (its
    launch call returned) after the gap began: ``host late in <owner of
    that operation>``.  Otherwise the operation was queued and waited on
    the device: ``queued after <the operation before the gap>``.
    """
    owner = owner or {}
    busy = _merged(ops)
    starts = {}
    for o in sorted(ops, key=lambda o: (o[1], o[2])):
        starts.setdefault(o[1], o)
    ends = sorted((o[2], o[0]) for o in ops)
    out, j = [], 0
    for (_, g0), (g1, _) in zip(busy, busy[1:]):
        while j + 1 < len(ends) and ends[j + 1][0] <= g0:
            j += 1
        name, _, _, corr = starts[g1]
        launch = launches.get(corr)
        if launch is not None and launch[1] > g0:
            out.append((f"host late in {owner.get(corr, UNATTRIBUTED)}",
                        (g1 - g0) / 1e6, True))
        else:
            out.append((f"queued after {ends[j][1]}", (g1 - g0) / 1e6,
                        False))
    return out


def host_idle_share(ops, launches):
    """Share (%) of the window of ``ops`` in gaps where the host was late."""
    window = max(o[2] for o in ops) - min(o[1] for o in ops)
    late = sum(s for _, s, is_late in idle_gaps(ops, launches) if is_late)
    return 100.0 * late * 1e6 / window if window > 0 else None


def by_owner(ops, launches, owner):
    """Device seconds by (owner, operation)."""
    out = Counter()
    for name, s, e, corr in ops:
        who = owner.get(corr, UNATTRIBUTED) if corr in launches \
            else UNATTRIBUTED
        out[(who, name)] += (e - s) / 1e6
    return out


def _top(counter, top=10):
    return [[n, s] for n, s in counter.most_common(top)]


def summarize(ops, launches, spans, base_ns, steps, applies_per_step):
    """What the tracing-on span read: device seconds by owner, the kept
    ``plan.apply`` spans and the breakdown; None where the program
    opened no ``plan.apply`` span."""
    applies = sorted((s for s in spans if s.name == "plan.apply"),
                     key=lambda s: s.t0_ns)
    if not applies or len(applies) < steps * applies_per_step:
        return None
    applies = applies[len(applies) - steps * applies_per_step:]
    owner = innermost(launches, spans_on_trace(spans, base_ns))
    times = by_owner(ops, launches, owner)
    gaps = Counter()
    for name, s, _ in idle_gaps(ops, launches, owner):
        gaps[name] += s

    def ms(pred):
        return sum(v for (who, n), v in times.items()
                   if pred(who, n)) / steps * 1e3

    total = sum(times.values())
    return {
        "apply_us": sum(s.dur_ns for s in applies) / len(applies) / 1e3,
        "routes": {r: n / steps for r, n in
                   Counter(s.attrs.get("route") for s in applies).items()},
        "ingest_ms": ms(lambda w, n: w == "plan.apply.ingest"),
        "dispatch_ms": ms(lambda w, n: w in ("plan.apply.dispatch",
                                             "plan.apply.launch")
                          and n not in STREAM_KERNELS),
        "escape_ms": ms(lambda w, n: w.startswith("plan.apply.escape.")),
        "k1_ms": ms(lambda w, n: n in K1_KERNELS),
        "stream_outside_launch": sum(
            1 for name, _, _, corr in ops if name in STREAM_KERNELS
            and owner.get(corr) != "plan.apply.launch"),
        "unattributed_s": sum(v for (w, _), v in times.items()
                              if w == UNATTRIBUTED),
        "device_s": total,
        "window_ms": (max(o[2] for o in ops) - min(o[1] for o in ops))
        / steps / 1e3,
        "device_ops": _top(Counter({f"{w}/{n}": v
                                    for (w, n), v in times.items()})),
        "idle_gaps": _top(gaps),
    }


def join_fault(p):
    """Why the join ``summarize`` gave is no reading, or None where it
    held: every K1/K2 kernel owned by ``plan.apply.launch``, and at most
    ``UNATTRIBUTED_SHARE`` of the device time owned by no span.  A clock
    or thread that moves launches out of their spans fails it."""
    if p["stream_outside_launch"]:
        return (f"{p['stream_outside_launch']} K1/K2 kernels outside "
                f"plan.apply.launch")
    if p["unattributed_s"] > UNATTRIBUTED_SHARE * p["device_s"]:
        return (f"unattributed {p['unattributed_s']!r} s of "
                f"{p['device_s']!r} s device time")
    return None


def _run_of_harness():
    """The cell's ``Run``: the harness hands the readers what the window
    counted, not the run, so this finds it among the callers' locals
    (``harness.run``'s ``run_``)."""
    frame = sys._getframe(1)
    while frame is not None:
        run = frame.f_locals.get("run_")
        if run is not None and hasattr(run, "steps"):
            return run
        frame = frame.f_back
    return None


#: spans taken at most, where one loses operations (seen once in 24)
TRIES = 3


def _traced_steps(run, count, traced=False):
    """``WARM + count`` steps under the profiler, tracing on where
    ``traced`` (a cleared tracer): a dict of the kept steps' operations
    (``ops``), the launch rows, the trace, the spans and the host clock's
    mean apply with the profiler on (``apply_us``).  Taken again, up to
    ``TRIES`` times, where the trace lost operations (K1/K2 kernels
    missing, or operations that do not divide into the steps); None where
    every try did."""
    from repro_torch import obs

    tracer = obs.get_tracer()
    for attempt in range(1, TRIES + 1):
        tracer.clear()
        before = run.launches()
        run.apply_s, run.applies = 0.0, 0
        obs.enable(traced)
        try:
            trace = profile(lambda: run.steps(count=WARM + count))
        finally:
            obs.disable()
        launched = run.launches() - before
        ops, launches = read_trace(trace)
        seen = sum(1 for o in ops if o[0] in ("stream_dest_kernel",
                                              "stream_panel_kernel"))
        steps = kept(ops, count)
        if seen == launched and steps is not None and launches \
                and not tracer.dropped:
            return {"ops": steps, "launches": launches, "trace": trace,
                    "spans": tracer.spans() if traced else [],
                    "apply_us": run.apply_s / run.applies * 1e6}
        print(f"program trace: span {attempt} of {TRIES} (tracing "
              f"{'on' if traced else 'off'}) lost operations: {seen} K1/K2 "
              f"kernels of {launched}, {len(ops)} operations, "
              f"{len(launches)} launch rows, {tracer.dropped} spans dropped",
              file=sys.stderr)
    return None


def _measure(run):
    count = run.traffic["trace_steps"]
    off = _traced_steps(run, count)
    if off is None:
        return None
    out = {"host_idle_share": host_idle_share(off["ops"], off["launches"]),
           "apply_host_us_profiled": [off["apply_us"], None],
           "program": None}
    on = _traced_steps(run, count, traced=True)
    if on is None:
        return out
    out["apply_host_us_profiled"][1] = on["apply_us"]
    launches = on_thread(on["ops"], on["launches"], threading.get_native_id())
    p = summarize(on["ops"], launches, on["spans"],
                  int(on["trace"].get("baseTimeNanoseconds", 0)), count,
                  len(run.layers))
    fault = join_fault(p) if p else None
    if fault:
        print(f"program trace: the join did not hold ({fault}): no program "
              f"metrics", file=sys.stderr)
        p = None
    out["program"] = p
    return out


def _report(ctx, got):
    """The result line's breakdown from the tracing-on span, and three
    lines on standard error."""
    from repro_torch import obs

    p = got["program"]
    ctx.trace["device_ops"] = p["device_ops"]
    ctx.trace["idle_gaps"] = p["idle_gaps"]
    reg = obs.get_registry()
    picks = {n[len("plan.dataflow."):]: reg.value(n) for n in reg.names()
             if n.startswith("plan.dataflow.")}
    k1_off = sum(ctx.trace["ops"].get(n, 0.0) for n in K1_KERNELS) \
        / ctx.trace["steps"] * 1e3
    host_us = ctx.apply_s / ctx.applies * 1e6 if ctx.applies else None
    off_us, on_us = got["apply_host_us_profiled"]
    lines = [
        f"program trace: applies a step by route {p['routes']}; plans by "
        f"dataflow {picks}",
        f"program trace: unattributed {p['unattributed_s']!r} s of "
        f"{p['device_s']!r} s device time; K1/K2 kernels outside "
        f"plan.apply.launch {p['stream_outside_launch']}; K1 "
        f"{p['k1_ms']!r} ms a step against {k1_off!r} untraced",
        f"program trace: tracing on, {p['window_ms']!r} ms a step against "
        f"{ctx.trace['window_s'] / ctx.trace['steps'] * 1e3!r} off; "
        f"apply_us {p['apply_us']!r} against apply_host_us {host_us!r}; "
        f"an apply on the host clock under the profiler {off_us!r} us "
        f"tracing off, {on_us!r} on",
    ]
    for line in lines:
        print(line, file=sys.stderr)


def of(ctx):
    """What the two extra spans read, taken once per run and kept on
    ``ctx``: ``host_idle_share``, and under ``program`` what the program's
    spans gave (None for a program without them, or where the join did
    not hold: :func:`join_fault`).  None off the card,
    where the harness's traced span was no reading, or where a span lost
    operations.  A failure is printed, never raised: a reader returns
    nothing rather than end the run."""
    if hasattr(ctx, "program_trace"):
        return ctx.program_trace
    ctx.program_trace = None
    run = _run_of_harness() if ctx.trace else None
    if run is None:
        return None
    # what set-up made is kept out of the collector's full passes, as in
    # the harness's window and traced span
    gc.collect()
    gc.freeze()
    try:
        ctx.program_trace = _measure(run)
        if ctx.program_trace and ctx.program_trace["program"]:
            _report(ctx, ctx.program_trace)
    except Exception:       # noqa: BLE001 — a reader must not end the run
        traceback.print_exc(file=sys.stderr)
        ctx.program_trace = None
    finally:
        gc.unfreeze()
    return ctx.program_trace


def program(ctx, key):
    """``key`` of what the program's spans gave, or None."""
    got = of(ctx)
    return got["program"][key] if got and got["program"] else None
