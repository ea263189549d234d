"""From a profiler trace to what the per-layer readers read.

``profile_steps`` runs a callable under ``torch.profiler`` with the device
alone recorded and reads back its Chrome trace; ``reduce`` turns the
device's operations into seconds by operation, the device's busy time,
the traced window and the device's idle gaps.  Times in a Chrome trace
are microseconds.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import Counter

#: trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")


def short_name(name):
    """A device operation's short name: no return type, namespace,
    template or argument list (``stream_dest_kernel``, ``Memset``)."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("<")[0].split("(")[0].split("::")[-1].strip()


def profile_steps(fn):
    """Run ``fn()`` under the profiler, the device alone recorded (no host
    ops, so no host overhead); returns the device's operations as a list
    of (name, start_us, end_us)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    events = trace.get("traceEvents", trace) if isinstance(trace, dict) \
        else trace
    device = []
    for e in events:
        if (e.get("ph") == "X" and "dur" in e
                and e.get("cat") in DEVICE_CATS):
            start = float(e["ts"])
            device.append((short_name(str(e.get("name", ""))), start,
                           start + float(e["dur"])))
    return device


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _busy(intervals, start, end):
    merged = _merge((max(s, start), min(e, end)) for s, e in intervals
                    if e > start and s < end)
    return merged, sum(e - s for s, e in merged)


def reduce(device, steps, skip=0, top=10):
    """Seconds by device operation, busy and window seconds, and idle gaps
    over the last ``steps`` of ``skip + steps`` traced steps (the
    profiler's start lands in the first ones).

    Every step issues the same device operations, so the first ``skip``
    steps' share of them is dropped and the window runs from the first
    operation kept to the last.  None where the operations do not divide
    into ``skip + steps`` equal shares: the trace lost some, and is no
    reading.  ``idle_by_step`` is each kept step's idle seconds, from its
    first operation to the next step's; an idle gap is named by the
    operation that ran before it, gaps of one name summed.
    """
    total = skip + steps
    if not device or len(device) % total:
        return None
    per = len(device) // total
    device = sorted(device, key=lambda d: d[1])[skip * per:]
    start, end = device[0][1], max(e for _, _, e in device)
    ops = Counter()
    for name, s, e in device:
        ops[name] += (e - s) / 1e6
    spans = [(s, e) for _, s, e in device]
    busy, busy_us = _busy(spans, start, end)
    firsts = [device[i][1] for i in range(0, len(device), per)] + [end]
    idle_by_step = [(t1 - t0 - _busy(spans, t0, t1)[1]) / 1e6
                    for t0, t1 in zip(firsts, firsts[1:])]
    by_end = sorted((e, n) for n, _, e in device)
    ends = [e for e, _ in by_end]
    gaps = Counter()
    for (_, g0), (g1, _) in zip(busy, busy[1:]):
        before = by_end[bisect.bisect_right(ends, g0) - 1][1]
        gaps["after " + before] += (g1 - g0) / 1e6
    return {
        "steps": steps,
        "window_s": (end - start) / 1e6,
        "busy_s": busy_us / 1e6,
        "ops": dict(ops),
        "device_s": sum(ops.values()),
        "device_ops": [[n, s] for n, s in ops.most_common(top)],
        "idle_gaps": [[n, s] for n, s in gaps.most_common(top)],
        "idle_by_step": idle_by_step,
    }
