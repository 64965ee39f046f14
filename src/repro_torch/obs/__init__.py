"""Observability for the SliceMoE serving stack (port of ``repro.obs``;
stdlib only).

* :mod:`repro_torch.obs.timeline` — charge-path event tracing and
  Chrome-trace/Perfetto export (attach with
  ``engine.attach_tracer(TimelineTracer())``);
* :mod:`repro_torch.obs.metrics` — counter/gauge/histogram registry with
  JSONL time series + Prometheus text exposition, sampled per decode
  step via ``scheduler.attach_metrics(MetricsRegistry())``;
* :mod:`repro_torch.obs.report` — stall/overlap/waste analysis of an
  exported trace (CLI: ``scripts/torch_trace_report.py``);
* :mod:`repro_torch.obs.spans` — host wall-clock spans of the serving
  path, one record per scheduler step, each also a ``torch.profiler``
  range while a profiler is active (imports torch, so it is not
  re-exported here; docs/torch_spans.md).

See docs/observability.md for the trace schema, span model and
metrics catalog.
"""

from repro_torch.obs.timeline import (TimelineTracer, TraceEvent,
                                      chrome_trace, events_equal,
                                      export_chrome_trace, first_divergence)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, MetricsSampler)
from repro_torch.obs.report import (format_trace_report, load_trace,
                                    trace_report)

__all__ = [
    "TimelineTracer", "TraceEvent", "chrome_trace", "export_chrome_trace",
    "events_equal", "first_divergence",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "MetricsSampler",
    "trace_report", "format_trace_report", "load_trace",
]
