"""Counterpart of ``deeplearning4j_tpu/telemetry``: so far the in-step
metrics (``metrics``), the host registry of counters, gauges and
histograms (``registry``), span tracing with its crash flight recorder
(``trace``) and the tracker-federated cluster view (``federation``). The
step log, sessions, runtime profiling, history and alerts come with
ROADMAP item 21a, Prometheus export and the UI routes with item 21c."""

from deeplearning4j_tpu_torch.telemetry.metrics import (
    global_norm,
    train_step_metrics,
    update_metrics,
)
from deeplearning4j_tpu_torch.telemetry.federation import (
    ClusterAggregator,
    MetricsPusher,
    merge_snapshots,
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
    "ClusterAggregator",
    "Counter",
    "DEFAULT_BUCKETS",
    "Gauge",
    "Histogram",
    "MetricsPusher",
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
    "merge_snapshots",
    "parse_traceparent",
    "set_tracer",
    "train_step_metrics",
    "update_metrics",
]
