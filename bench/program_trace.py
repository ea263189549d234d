"""The plan API's spans on the device trace: the reader that the
``plan.apply`` metrics share.

The join itself is ``bench/tracing.py``'s: each device operation is owned
by the innermost program span (``repro_torch.obs``) open on the thread
that launched it.  This file adds the plan API's rule of the join (every
K1/K2 kernel owned by ``plan.apply.launch``: :func:`plan_rule`) and what
the metrics read from it.  Spans come onto the profiler trace's clock
through ``obs.spans_to_chrome(spans, base_ns=...)``.

:func:`of` takes, once per traced run, two more spans of the cell's steps
after the harness's own device-only one (which it leaves as it is):

- tracing off, the device and the launch calls recorded: which idle gaps
  the host caused (``host_idle_share``);
- tracing on (``obs.enable()``, a cleared tracer): device time by owner,
  the mean ``plan.apply`` span, and the result line's breakdown named by
  owner (``<span>/<op>``) and by what the host was doing in each gap;
  nothing of it where the join lost attribution (:func:`join_fault`).

It finds the run on ``ctx.run`` and leaves the breakdown on
``ctx.breakdown``, which the harness writes into the result line.

Times in a Chrome trace are microseconds.
"""
from __future__ import annotations

import gc
import sys
import threading
import traceback
from collections import Counter

from bench import tracing
from bench.tracing import (UNATTRIBUTED, by_owner, host_idle_share,
                           idle_gaps, innermost, on_thread, profile,
                           read_trace, spans_on_trace)

#: K1's and K2's kernels
STREAM_KERNELS = ("stream_dest_kernel", "stream_reduce_kernel",
                  "stream_panel_kernel", "stream_panel_reduce_kernel")
K1_KERNELS = STREAM_KERNELS[:2]
#: steps traced before the kept ones, as ``Run.trace`` does
WARM = 4


def kept(ops, steps, skip=WARM):
    """The last ``steps`` of ``skip + steps`` steps' operations, by start;
    None where they do not divide into equal shares (a trace that lost
    operations), as ``tracing.reduce`` rules."""
    total = skip + steps
    if not ops or len(ops) % total:
        return None
    per = len(ops) // total
    return sorted(ops, key=lambda o: o[1])[skip * per:]


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
        "b_ingest": {r: n / steps for r, n in Counter(
            s.attrs.get("b_ingest") for s in applies).items()},
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


def plan_rule(p):
    """The plan API's rule of the join: every K1/K2 kernel owned by
    ``plan.apply.launch``; why ``p`` broke it, or None."""
    if p["stream_outside_launch"]:
        return (f"{p['stream_outside_launch']} K1/K2 kernels outside "
                f"plan.apply.launch")
    return None


def join_fault(p):
    """Why the join ``summarize`` gave is no reading, or None where it
    held: ``bench/tracing.py``'s check under :func:`plan_rule`."""
    return tracing.join_fault(p, plan_rule)


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
    """The result line's breakdown from the tracing-on span, left on
    ``ctx.breakdown``, and three lines on standard error."""
    from repro_torch import obs

    p = got["program"]
    ctx.breakdown = {"device_ops": p["device_ops"],
                     "idle_gaps": p["idle_gaps"]}
    reg = obs.get_registry()
    picks = {n[len("plan.dataflow."):]: reg.value(n) for n in reg.names()
             if n.startswith("plan.dataflow.")}
    k1_off = sum(ctx.trace["ops"].get(n, 0.0) for n in K1_KERNELS) \
        / ctx.trace["steps"] * 1e3
    host_us = ctx.apply_s / ctx.applies * 1e6 if ctx.applies else None
    off_us, on_us = got["apply_host_us_profiled"]
    lines = [
        f"program trace: applies a step by route {p['routes']}, by "
        f"b_ingest {p['b_ingest']}; plans by dataflow {picks}",
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
    """What the two extra spans of the run on ``ctx.run`` read, taken
    once per run and kept on ``ctx``: ``host_idle_share``, and under
    ``program`` what the program's spans gave (None for a program without
    them, or where the join did not hold: :func:`join_fault`).  None off
    the card, where the harness's traced span was no reading, or where a
    span lost operations.  A failure is printed, never raised: a reader
    returns nothing rather than end the run."""
    if hasattr(ctx, "program_trace"):
        return ctx.program_trace
    ctx.program_trace = None
    run = getattr(ctx, "run", None) if ctx.trace else None
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
