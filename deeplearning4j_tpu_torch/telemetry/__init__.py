"""Counterpart of ``deeplearning4j_tpu/telemetry``: the in-step metrics
(``metrics``), the host registry of counters, gauges and histograms
(``registry``), the JSONL step log (``step_log``), the Prometheus text
exposition (``prometheus``), span tracing with its crash flight recorder
(``trace``), the tracker-federated cluster view (``federation``), and
the watch layer: a bounded metrics history (``history``) and the alert
engine over it (``alerts``), armed together as a ``Watchtower``.
Sessions, runtime profiling and compile-time profiles come with ROADMAP
item 21a-ii, the UI routes with item 21c."""

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
from deeplearning4j_tpu_torch.telemetry.alerts import (
    AlertEngine,
    AlertRule,
    Watchtower,
    arm_watchtower,
    default_rules,
    get_engine,
    set_engine,
)
from deeplearning4j_tpu_torch.telemetry.history import (
    MetricsHistory,
    get_history,
    read_spill,
    replay_spill,
    set_history,
)
from deeplearning4j_tpu_torch.telemetry.prometheus import (
    CONTENT_TYPE as PROMETHEUS_CONTENT_TYPE,
    render_prometheus,
    render_snapshot,
    sanitize_name,
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
from deeplearning4j_tpu_torch.telemetry.step_log import (
    StepLogWriter,
    read_step_log,
    summarize_step_log,
)

__all__ = [
    "AlertEngine",
    "AlertRule",
    "ClusterAggregator",
    "Counter",
    "DEFAULT_BUCKETS",
    "Gauge",
    "Histogram",
    "MetricsHistory",
    "MetricsPusher",
    "MetricsRegistry",
    "PROMETHEUS_CONTENT_TYPE",
    "Span",
    "StepLogWriter",
    "Tracer",
    "Watchtower",
    "arm_watchtower",
    "current_trace_context",
    "default_registry",
    "default_rules",
    "flat_record",
    "format_traceparent",
    "get_engine",
    "get_history",
    "get_tracer",
    "global_norm",
    "maybe_span",
    "merge_snapshots",
    "parse_traceparent",
    "read_spill",
    "read_step_log",
    "render_prometheus",
    "render_snapshot",
    "replay_spill",
    "sanitize_name",
    "set_engine",
    "set_history",
    "set_tracer",
    "summarize_step_log",
    "train_step_metrics",
    "update_metrics",
]
