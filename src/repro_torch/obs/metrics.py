"""Process metrics — counters, gauges, histograms behind one registry.

Every subsystem that used to grow its own ad-hoc stats dict (`ServeEngine`,
`AutotunePolicy`, `PlanCache`, bench rows) now increments named instruments
in a :class:`MetricsRegistry`.  Names are dotted and namespaced by
subsystem:

====================  =======================================================
namespace             examples
====================  =======================================================
``plan.*``            ``plan.builds``, ``plan.build_s`` and its stages
                      ``plan.pattern_s``, ``plan.tables_s``, ``plan.prepare_s``
                      (histograms; ``policy.select_s`` is the fourth)
``plan.dataflow.*``   ``plan.dataflow.ip_m``, ... (plans built, by dataflow)
``cache.*``           ``cache.hits``, ``cache.misses``, ``cache.evictions``
``policy.*``          ``policy.select_s``, ``policy.select_tile_s``,
                      ``policy.measurements``, ``policy.learned_fallbacks``
``serve.*``           ``serve.prefills``, ``serve.latency.decode_step_s``
``dist.*``            ``dist.ici_bytes``, ``dist.collectives``
``tier.*``            ``tier.l1_bytes``, ``tier.l2_bytes``, ``tier.dram_bytes``
====================  =======================================================

Instruments are created on first touch (``registry.counter(name).inc()``)
and are thread-safe.  ``REPRO_METRICS=0`` turns every instrument into a
shared no-op so instrumented code needs no branches.

Histograms use fixed log-spaced buckets (4 per decade, spanning 1e-6..1e2
by default — microseconds to minutes when recording seconds).  Percentiles
(p50/p90/p99) are read from the cumulative bucket counts, so a reported
quantile is exact to within one bucket ratio (~1.78x); tests pin this
against numpy.  ``sum``/``count``/``min``/``max`` are exact.

The process-global registry is :func:`get_registry`; components that need
isolation (one ``MetricsRegistry`` per ``ServeEngine``) construct their
own.
"""
from __future__ import annotations

import json
import math
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "metrics_enabled",
    "default_buckets",
]

_TRUE = frozenset(("1", "true", "yes", "on"))
_FALSE = frozenset(("0", "false", "no", "off"))


def metrics_enabled() -> bool:
    """``REPRO_METRICS`` knob — metrics default **on** (cheap, counters)."""
    raw = os.environ.get("REPRO_METRICS")
    if raw is None:
        return True
    return raw.strip().lower() not in _FALSE


def default_buckets(lo: float = 1e-6, hi: float = 1e2,
                    per_decade: int = 4) -> Tuple[float, ...]:
    """Log-spaced bucket upper bounds covering [lo, hi]."""
    n = int(round(math.log10(hi / lo) * per_decade)) + 1
    return tuple(lo * 10 ** (i / per_decade) for i in range(n))


class Counter:
    """Monotonic float counter."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "counter", "value": self._value}


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "gauge", "value": self._value}


class Histogram:
    """Fixed-bucket histogram with quantile estimates.

    ``buckets`` are upper bounds (ascending); observations above the last
    bound land in a +inf overflow bucket.  Quantiles report the upper bound
    of the bucket containing the target rank — exact to one bucket ratio.
    """

    __slots__ = ("name", "buckets", "_counts", "_sum", "_count",
                 "_min", "_max", "_lock")

    def __init__(self, name: str, buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.buckets = tuple(buckets) if buckets else default_buckets()
        self._counts = [0] * (len(self.buckets) + 1)  # +1 = overflow
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        idx = self._bucket_index(value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    def _bucket_index(self, value: float) -> int:
        # binary search over static bounds (no allocation)
        lo, hi = 0, len(self.buckets)
        while lo < hi:
            mid = (lo + hi) // 2
            if value <= self.buckets[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-quantile observation."""
        with self._lock:
            total = self._count
            if total == 0:
                return 0.0
            rank = q * total
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if cum >= rank:
                    if i < len(self.buckets):
                        return self.buckets[i]
                    return self._max  # overflow bucket: best bound we have
            return self._max

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            count = self._count
            out = {
                "type": "histogram",
                "count": count,
                "sum": self._sum,
                "min": self._min if count else 0.0,
                "max": self._max if count else 0.0,
                "mean": (self._sum / count) if count else 0.0,
            }
        out["p50"] = self.quantile(0.50)
        out["p90"] = self.quantile(0.90)
        out["p99"] = self.quantile(0.99)
        return out


class _NoopInstrument:
    """Stand-in when ``REPRO_METRICS=0``: accepts every method, does nothing."""

    __slots__ = ()
    name = "<disabled>"
    value = 0.0
    count = 0
    sum = 0.0

    def inc(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def quantile(self, q: float) -> float:
        return 0.0

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "noop"}


_NOOP_INSTRUMENT = _NoopInstrument()


class MetricsRegistry:
    """Name → instrument map; instruments are created on first touch.

    A name is permanently bound to its first-requested type — asking for
    ``counter("x")`` after ``gauge("x")`` raises, catching schema drift at
    the call site instead of corrupting exports.
    """

    def __init__(self):
        self._instruments: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, **kwargs):
        if not metrics_enabled():
            return _NOOP_INSTRUMENT
        inst = self._instruments.get(name)
        if inst is not None:
            if not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
            return inst
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, **kwargs)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        return self._get(name, Histogram, buckets=buckets)

    def get(self, name: str) -> Optional[Any]:
        """Look up an existing instrument (None if never touched)."""
        return self._instruments.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._instruments)

    def snapshot(self, prefix: str = "") -> Dict[str, Dict[str, Any]]:
        """Deep, point-in-time copy: ``{name: {type, value/percentiles}}``."""
        with self._lock:
            items = [(n, i) for n, i in self._instruments.items()
                     if n.startswith(prefix)]
        return {name: inst.snapshot() for name, inst in sorted(items)}

    def to_json(self, prefix: str = "") -> str:
        return json.dumps(self.snapshot(prefix), indent=1, sort_keys=True)

    def value(self, name: str, default: float = 0.0) -> float:
        """Scalar convenience: counter/gauge value, histogram count."""
        inst = self._instruments.get(name)
        if inst is None:
            return default
        if isinstance(inst, Histogram):
            return float(inst.count)
        return float(inst.value)

    def reset(self) -> None:
        """Drop every instrument (tests / fresh engine lifecycles)."""
        with self._lock:
            self._instruments.clear()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry (plan/cache/policy/tier namespaces)."""
    return _REGISTRY
