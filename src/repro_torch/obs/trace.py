"""Lightweight span tracing — the timeline half of ``repro_torch.obs``.

One process-global :class:`Tracer` holds a thread-safe ring buffer of
completed spans.  Instrumentation sites call :func:`span` (a context
manager) or decorate with :func:`traced`; spans nest through a per-thread
stack, so exports reconstruct the call tree without any global ordering
assumptions, and code below a span can attach attributes to it
(:func:`annotate`).  Clocks are monotonic (``time.perf_counter_ns``) —
wall-clock drift cannot reorder a trace.

The whole layer is **off by default**: unless ``REPRO_TRACE`` is truthy (read
once per process) or :func:`enable` was called, :func:`span` returns a
shared no-op context manager — no record, no ring-buffer write, no retained
allocation — so instrumented hot paths (``plan.apply``, the serve decode
loop) cost a global read when nobody is watching.

Exports:

- :meth:`Tracer.save` — newline-delimited JSON, one span per line (the
  native capture format; cheap to append, trivially concatenable);
- :meth:`Tracer.to_chrome` / :meth:`Tracer.save_chrome` — Chrome-trace /
  Perfetto JSON (``{"traceEvents": [...]}``, complete ``ph: "X"`` events)
  that loads directly in https://ui.perfetto.dev;
- :func:`summarize` — a human per-span-name latency table (count, total,
  mean, p50, p99, max).

Spans join a ``torch.profiler`` trace on its own clock: :func:`enable`
samples one (Unix ns, ``perf_counter_ns``) pair (:func:`clock_pair`), and
``spans_to_chrome(spans, base_ns=...)`` writes each span's ``ts`` as Unix
time less ``base_ns`` — the profiler trace's ``baseTimeNanoseconds`` — so
the program's spans merge into any Chrome trace the profiler exports.
Spans carry the thread's native id (``threading.get_native_id()``), the
``tid`` of the profiler's host rows where it records the host; a trace of
the device alone writes its launch rows' thread in an encoding of its own,
so a reader matches spans there by time on the launching thread.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "SpanRecord",
    "Tracer",
    "get_tracer",
    "span",
    "traced",
    "enabled",
    "enable",
    "disable",
    "annotate",
    "now_ns",
    "clock_pair",
    "summarize",
    "read_spans",
]

#: the monotonic clock every obs site uses (exported so instrumented code
#: never calls ``time.*`` directly — the obs-time lint rule enforces this)
now_ns = time.perf_counter_ns

_TRUE = frozenset(("1", "true", "yes", "on"))

#: is span capture on?  Set by :func:`enable` / :func:`disable` (which win
#: over ``REPRO_TRACE``); ``None`` until ``REPRO_TRACE`` is read.  Read
#: once: the lookup costs microseconds, and the check sits on hot paths
#: (``FlexagonPlan.apply``); :func:`_reset_override` reads it anew
_ON: Optional[bool] = None


def enabled() -> bool:
    """Is span capture on?  (``REPRO_TRACE`` truthy, or :func:`enable`.)"""
    on = _ON
    return _read_env() if on is None else on


def _read_env() -> bool:
    global _ON
    raw = os.environ.get("REPRO_TRACE")
    _ON = raw is not None and raw.strip().lower() in _TRUE
    return _ON


def enable(flag: bool = True) -> None:
    """Force tracing on/off for this process (wins over ``REPRO_TRACE``);
    turning it on samples the clock pair anew (:func:`clock_pair`)."""
    global _ON, _CLOCK_PAIR
    _ON = bool(flag)
    if flag:
        _CLOCK_PAIR = _sample_clock_pair()


def disable() -> None:
    enable(False)


def _reset_override() -> None:
    """Return to environment-driven behaviour, ``REPRO_TRACE`` read anew
    (test hygiene)."""
    global _ON
    _ON = None


def _sample_clock_pair() -> Tuple[int, int]:
    """(Unix ns, ``now_ns()``) read together: the Unix reading between two
    monotonic ones, paired with their midpoint."""
    before = now_ns()
    unix = time.time_ns()
    return unix, (before + now_ns()) // 2


#: the (Unix ns, monotonic ns) pair spans are mapped onto Unix time by;
#: sampled by :func:`enable`, or on first use where ``REPRO_TRACE`` did it
_CLOCK_PAIR: Optional[Tuple[int, int]] = None


def clock_pair() -> Tuple[int, int]:
    """The (Unix ns, ``now_ns()``) pair of this tracing session: a span
    that starts at ``t0_ns`` started at Unix ``t0_ns - pair[1] + pair[0]``,
    the clock ``torch.profiler`` stamps its trace with."""
    global _CLOCK_PAIR
    if _CLOCK_PAIR is None:
        _CLOCK_PAIR = _sample_clock_pair()
    return _CLOCK_PAIR


class SpanRecord:
    """One completed span (immutable once recorded)."""

    __slots__ = ("name", "t0_ns", "dur_ns", "tid", "sid", "parent", "attrs")

    def __init__(self, name: str, t0_ns: int, dur_ns: int, tid: int,
                 sid: int, parent: Optional[int],
                 attrs: Optional[Dict[str, Any]]):
        self.name = name
        self.t0_ns = t0_ns
        self.dur_ns = dur_ns
        self.tid = tid
        self.sid = sid
        self.parent = parent
        self.attrs = attrs or {}

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "t0_ns": self.t0_ns,
                "dur_ns": self.dur_ns, "tid": self.tid, "sid": self.sid,
                "parent": self.parent, "attrs": _json_safe(self.attrs)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SpanRecord":
        return cls(d["name"], int(d["t0_ns"]), int(d["dur_ns"]),
                   int(d.get("tid", 0)), int(d.get("sid", 0)),
                   d.get("parent"), d.get("attrs") or {})

    def __repr__(self) -> str:
        return (f"SpanRecord({self.name!r}, dur={self.dur_ns / 1e3:.1f}us, "
                f"sid={self.sid}, parent={self.parent})")


def _json_safe(obj: Any) -> Any:
    """Attrs must serialize; anything exotic degrades to ``str``."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return str(obj)


class Tracer:
    """Thread-safe bounded span buffer + exporters.

    ``capacity`` bounds memory: the buffer is a ring, the oldest spans fall
    off first (``dropped`` counts them).  Appends take a lock — span record
    construction happens outside it, so the critical section is two list
    ops.
    """

    def __init__(self, capacity: int = 65536):
        self.capacity = capacity
        self._spans: "deque[SpanRecord]" = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self.recorded = 0

    # -- capture ---------------------------------------------------------
    def new_id(self) -> int:
        """A fresh span id (manual span assembly, e.g. serve requests)."""
        return next(self._ids)

    def _stack(self) -> List["_Span"]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = []
            self._local.stack = stack
        return stack

    def _thread_id(self) -> int:
        """This thread's native id, read once per thread (a system call,
        which can cost microseconds)."""
        tid = getattr(self._local, "tid", None)
        if tid is None:
            tid = self._local.tid = threading.get_native_id()
        return tid

    def current_span(self) -> Optional[int]:
        """sid of the innermost open span on this thread, if any."""
        stack = self._stack()
        return stack[-1].sid if stack else None

    def record(self, name: str, t0_ns: int, dur_ns: int, *,
               sid: Optional[int] = None, parent: Optional[int] = None,
               tid: Optional[int] = None,
               attrs: Optional[Dict[str, Any]] = None) -> SpanRecord:
        """Append one completed span (manual API; ``span()`` calls this)."""
        rec = SpanRecord(name, int(t0_ns), int(dur_ns),
                         tid if tid is not None else self._thread_id(),
                         sid if sid is not None else self.new_id(),
                         parent, attrs)
        with self._lock:
            self._spans.append(rec)
            self.recorded += 1
        return rec

    # -- views -----------------------------------------------------------
    def spans(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._spans)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self.recorded - len(self._spans)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.recorded = 0

    # -- exporters -------------------------------------------------------
    def to_chrome(self, spans: Optional[Iterable[SpanRecord]] = None,
                  base_ns: Optional[int] = None) -> Dict[str, Any]:
        """Chrome-trace / Perfetto JSON (complete ``ph: "X"`` events); see
        :func:`spans_to_chrome` for ``base_ns``."""
        return spans_to_chrome(self.spans() if spans is None else spans,
                               base_ns=base_ns)

    def save(self, path: str) -> int:
        """Native capture format: one span per line, JSON.  Returns count."""
        spans = self.spans()
        with open(path, "w", encoding="utf-8") as fh:
            for rec in spans:
                fh.write(json.dumps(rec.to_dict()) + "\n")
        return len(spans)

    def save_chrome(self, path: str) -> int:
        spans = self.spans()
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(spans_to_chrome(spans), fh, indent=1)
        return len(spans)

    def summarize(self) -> str:
        return summarize(self.spans())


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-global tracer every :func:`span` records into."""
    return _TRACER


class _NoopSpan:
    """Shared disabled-mode span: enter/exit/set are all no-ops."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        pass


_NOOP = _NoopSpan()


class _Span:
    """Live span context manager (only built when tracing is enabled)."""

    __slots__ = ("name", "attrs", "t0", "sid", "parent")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs

    def set(self, **attrs: Any) -> None:
        """Attach attributes mid-span (e.g. a result computed inside)."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        tr = _TRACER
        stack = tr._stack()
        self.parent = stack[-1].sid if stack else None
        self.sid = tr.new_id()
        stack.append(self)
        self.t0 = now_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = now_ns() - self.t0
        tr = _TRACER
        stack = tr._stack()
        # exception-safe unwind: pop our span even if inner code corrupted
        # the stack (never raise from __exit__)
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            del stack[stack.index(self):]
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        tr.record(self.name, self.t0, dur, sid=self.sid,
                  parent=self.parent, attrs=self.attrs)
        return False


def span(name: str, **attrs: Any):
    """``with span("plan.phase1", dataflow=...):`` — time a region.

    Returns the shared no-op when tracing is disabled, so call sites never
    branch themselves.
    """
    on = _ON        # enabled(), inlined: this is the off path's whole cost
    if not (on if on is not None else _read_env()):
        return _NOOP
    return _Span(name, attrs)


def annotate(**attrs: Any) -> None:
    """Attach ``attrs`` to the innermost span open on this thread: a
    decision taken below the code that opened it (``plan.apply``'s
    ``route``, set by the backend).  A no-op with tracing off or no span
    open."""
    if not _ON:     # no span is open before REPRO_TRACE was read
        return
    stack = _TRACER._stack()
    if stack:
        stack[-1].attrs.update(attrs)


def traced(name: Optional[str] = None, **attrs: Any):
    """Decorator form: ``@traced("tune.fit")`` or bare ``@traced()``."""
    import functools

    def deco(fn):
        label = name or f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__qualname__}"

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any):
            if not enabled():
                return fn(*args, **kwargs)
            with _Span(label, dict(attrs)):
                return fn(*args, **kwargs)

        return wrapper

    return deco


# ---------------------------------------------------------------------------
# Export / summarize helpers (shared by Tracer and its callers)
# ---------------------------------------------------------------------------


def spans_to_chrome(spans: Iterable[SpanRecord],
                    base_ns: Optional[int] = None) -> Dict[str, Any]:
    """Chrome-trace JSON object: every span becomes one complete event.

    ``ts`` is the monotonic clock in microseconds; with ``base_ns`` it is
    Unix time less ``base_ns`` (a ``torch.profiler`` trace's
    ``baseTimeNanoseconds``), the axis of that trace, through
    :func:`clock_pair`.
    """
    pid = os.getpid()
    shift = 0
    if base_ns is not None:
        unix, mono = clock_pair()
        shift = unix - mono - int(base_ns)
    events = []
    for rec in spans:
        args = dict(_json_safe(rec.attrs))
        args["sid"] = rec.sid
        if rec.parent is not None:
            args["parent"] = rec.parent
        events.append({
            "name": rec.name,
            "cat": rec.name.split(".", 1)[0],
            "ph": "X",
            "ts": (rec.t0_ns + shift) / 1e3,        # microseconds
            "dur": rec.dur_ns / 1e3,
            "pid": pid,
            "tid": rec.tid,
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def read_spans(path: str) -> List[SpanRecord]:
    """Load a native (JSONL) trace file back into span records."""
    out: List[SpanRecord] = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(SpanRecord.from_dict(json.loads(line)))
    return out


def _percentile(sorted_vals: List[float], pct: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    rank = max(0, min(len(sorted_vals) - 1,
                      int(round(pct / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[rank]


def summarize(spans: Iterable[SpanRecord]) -> str:
    """Per-name latency table: count, total, mean, p50, p99, max."""
    by_name: Dict[str, List[float]] = {}
    for rec in spans:
        by_name.setdefault(rec.name, []).append(rec.dur_ns / 1e3)  # us
    header = (f"{'span':32s} {'count':>7s} {'total_ms':>10s} "
              f"{'mean_us':>10s} {'p50_us':>10s} {'p99_us':>10s} "
              f"{'max_us':>10s}")
    lines = [header, "-" * len(header)]
    for name in sorted(by_name, key=lambda n: -sum(by_name[n])):
        durs = sorted(by_name[name])
        total = sum(durs)
        lines.append(
            f"{name:32s} {len(durs):7d} {total / 1e3:10.3f} "
            f"{total / len(durs):10.1f} {_percentile(durs, 50):10.1f} "
            f"{_percentile(durs, 99):10.1f} {durs[-1]:10.1f}")
    if len(lines) == 2:
        lines.append("(no spans captured — is REPRO_TRACE enabled?)")
    return "\n".join(lines)
