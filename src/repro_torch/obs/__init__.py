"""Observability: pluggable trace and metric sinks.

Counterpart of :mod:`repro.obs`, with the same public surface: see
:mod:`repro_torch.obs.trace` for the core (spans, counters, gauges,
events; a single branch when no sink is registered),
:mod:`repro_torch.obs.export` for Chrome-trace output,
:mod:`repro_torch.obs.metrics` for derived stats and
:mod:`repro_torch.obs.validate` for the trace-event schema check
(``python -m repro_torch.obs.validate out.json``).
"""

from repro_torch.obs.export import ChromeTraceSink, chrome_trace, write_chrome_trace
from repro_torch.obs.metrics import (
    StatsLineSink,
    counter_total,
    dispatch_table,
    percentile,
    request_stats_from_events,
    summarize_spans,
)
from repro_torch.obs.trace import (
    NULL_SPAN,
    NullSink,
    PointRecord,
    RingSink,
    Sink,
    SpanRecord,
    active,
    clear_sinks,
    counter,
    counter_value,
    counters_snapshot,
    current_depth,
    disabled,
    event,
    gauge,
    gauge_value,
    gauges_snapshot,
    register_sink,
    reset_metrics,
    sinks,
    span,
    unregister_sink,
)
from repro_torch.obs.validate import TraceFormatError, validate_chrome

__all__ = [
    "ChromeTraceSink",
    "NULL_SPAN",
    "NullSink",
    "PointRecord",
    "RingSink",
    "Sink",
    "SpanRecord",
    "StatsLineSink",
    "TraceFormatError",
    "active",
    "chrome_trace",
    "clear_sinks",
    "counter",
    "counter_total",
    "counter_value",
    "counters_snapshot",
    "current_depth",
    "disabled",
    "dispatch_table",
    "event",
    "gauge",
    "gauge_value",
    "gauges_snapshot",
    "percentile",
    "register_sink",
    "request_stats_from_events",
    "reset_metrics",
    "sinks",
    "span",
    "summarize_spans",
    "unregister_sink",
    "validate_chrome",
    "write_chrome_trace",
]
