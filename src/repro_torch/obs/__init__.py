"""repro_torch.obs — unified tracing + metrics for the whole port.

Two halves, one import:

- :mod:`repro_torch.obs.trace` — nested span timelines (``span("plan.phase1")``),
  ring-buffered, exported as Chrome-trace/Perfetto JSON.  Off unless
  ``REPRO_TRACE`` is truthy; disabled spans are a shared no-op.
- :mod:`repro_torch.obs.metrics` — process-global :class:`MetricsRegistry` of
  counters / gauges / histograms replacing the per-subsystem stats dicts.
  On unless ``REPRO_METRICS=0``.

This package imports only the stdlib, so any repro_torch module can depend
on it without cycles.  Spans export onto ``torch.profiler``'s clock
(``spans_to_chrome(spans, base_ns=...)``), so they merge into its traces.
"""
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_buckets,
    get_registry,
    metrics_enabled,
)
from repro_torch.obs.trace import (
    SpanRecord,
    Tracer,
    annotate,
    clock_pair,
    enable,
    enabled,
    disable,
    get_tracer,
    now_ns,
    read_spans,
    span,
    spans_to_chrome,
    summarize,
    traced,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "SpanRecord",
    "Tracer",
    "annotate",
    "clock_pair",
    "default_buckets",
    "disable",
    "enable",
    "enabled",
    "get_registry",
    "get_tracer",
    "metrics_enabled",
    "now_ns",
    "read_spans",
    "span",
    "spans_to_chrome",
    "summarize",
    "traced",
]
