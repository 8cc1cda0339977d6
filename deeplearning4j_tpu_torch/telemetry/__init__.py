"""Counterpart of ``deeplearning4j_tpu/telemetry``: so far the in-step
metrics (``metrics``), the host registry of counters, gauges and
histograms (``registry``) and span tracing with its crash flight recorder
(``trace``). The step log, sessions, runtime profiling, history, alerts,
federation and Prometheus export come with ROADMAP item 21a."""

from deeplearning4j_tpu_torch.telemetry.metrics import (
    global_norm,
    train_step_metrics,
    update_metrics,
)
from deeplearning4j_tpu_torch.telemetry.registry import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    flat_record,
)
from deeplearning4j_tpu_torch.telemetry.trace import (
    Span,
    Tracer,
    current_trace_context,
    format_traceparent,
    get_tracer,
    maybe_span,
    parse_traceparent,
    set_tracer,
)

__all__ = [
    "Counter",
    "DEFAULT_BUCKETS",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "Tracer",
    "current_trace_context",
    "default_registry",
    "flat_record",
    "format_traceparent",
    "get_tracer",
    "global_norm",
    "maybe_span",
    "parse_traceparent",
    "set_tracer",
    "train_step_metrics",
    "update_metrics",
]
