"""From a profiler trace to what the per-layer readers read.

``profile`` runs a callable under ``torch.profiler`` with the device
alone recorded (which records the calls that launch device work too,
without the host's operators) and reads back its Chrome trace;
``profile_steps`` gives its device operations and ``reduce`` turns them
into seconds by operation, the device's busy time, the traced window and
the device's idle gaps.

The join, for every driver: :func:`read_trace` takes the device
operations and the launch calls of a trace; each operation is joined to
the call that launched it through the ``correlation`` the profiler gives
both, and that call to the innermost program span open on its thread at
that time (:func:`innermost`): the operation's ``owner``.  Which span has
to own which operations is each reader's own rule, handed to
:func:`join_fault`.  Times in a Chrome trace are microseconds.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import Counter

#: trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
#: trace categories of the host calls that launch device work
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: the owner of an operation no program span launched
UNATTRIBUTED = "unattributed"
#: the largest share of device time no program span may own in a join that
#: is a reading
UNATTRIBUTED_SHARE = 0.005


def short_name(name):
    """A device operation's short name: no return type, namespace,
    template or argument list (``stream_dest_kernel``, ``Memset``)."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("<")[0].split("(")[0].split("::")[-1].strip()


def profile(fn):
    """Run ``fn()`` under the profiler with the device recorded (which
    records the launch calls too, without the host's operators, so no
    host overhead); returns the Chrome trace as a dict."""
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


def profile_steps(fn):
    """The device's operations of ``fn()`` under :func:`profile`, as a
    list of (name, start_us, end_us)."""
    ops, _ = read_trace(profile(fn))
    return [(name, start, end) for name, start, end, _ in ops]


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


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
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
    busy = _merge((o[1], o[2]) for o in ops)
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


def join_fault(p, rule=None):
    """Why the join that ``p`` sums up is no reading, or None where it
    held.

    ``p`` holds the device seconds owned by no span (``unattributed_s``)
    and in all (``device_s``).  ``rule`` is the reader's own rule of which
    span owns what: ``rule(p)`` returns why the join broke it, or None.
    Besides, at most ``UNATTRIBUTED_SHARE`` of the device time may be owned
    by no span.  A clock or thread that moves launches out of their spans
    fails one or the other.
    """
    fault = rule(p) if rule else None
    if fault:
        return fault
    if p["unattributed_s"] > UNATTRIBUTED_SHARE * p["device_s"]:
        return (f"unattributed {p['unattributed_s']!r} s of "
                f"{p['device_s']!r} s device time")
    return None


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
