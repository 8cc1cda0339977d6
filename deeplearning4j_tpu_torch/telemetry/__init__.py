"""Counterpart of ``deeplearning4j_tpu/telemetry``: the in-step metrics
(``metrics``), the host registry of counters, gauges and histograms
(``registry``), the JSONL step log (``step_log``), the Prometheus text
exposition (``prometheus``), span tracing with its crash flight recorder
(``trace``), the tracker-federated cluster view (``federation``), and
the watch layer: a bounded metrics history (``history``) and the alert
engine over it (``alerts``), armed together as a ``Watchtower``; and the
profiling layer: ``TrainTelemetry`` (``session``, one host transfer a
window of in-step metrics), the step profile (``xprofile``: the FLOPs,
bytes, memory and collectives of one real call, with the kernels'
analytic costs) and the runtime profiler (``runprof``: measured phase
timings, ``runprof_*`` gauges and N-step sessions, armed by ``runprof=``
or ``DL4J_TPU_RUNPROF``). ``ui.UiServer`` serves them over HTTP."""

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
from deeplearning4j_tpu_torch.telemetry.session import (
    DEFAULT_INTERVAL,
    TrainTelemetry,
)
from deeplearning4j_tpu_torch.telemetry.step_log import (
    StepLogWriter,
    read_step_log,
    summarize_step_log,
)
from deeplearning4j_tpu_torch.telemetry.runprof import (
    RunProfiledStep,
    RunProfiler,
    StepTiming,
    chrome_trace_events,
    default_runprof,
    find_sessions,
    get_runprof,
    load_session,
    maybe_runprof,
    resolve_runprof,
    set_runprof,
    summarize_session,
)
from deeplearning4j_tpu_torch.telemetry.xprofile import (
    MemoryWatermarkSampler,
    ProfiledStep,
    ProfileStore,
    StepProfile,
    attribute,
    default_profile_store,
    profile_compiled,
    profile_lowered,
)

__all__ = [
    "AlertEngine",
    "AlertRule",
    "ClusterAggregator",
    "Counter",
    "DEFAULT_BUCKETS",
    "DEFAULT_INTERVAL",
    "Gauge",
    "Histogram",
    "MemoryWatermarkSampler",
    "MetricsHistory",
    "MetricsPusher",
    "MetricsRegistry",
    "PROMETHEUS_CONTENT_TYPE",
    "ProfileStore",
    "ProfiledStep",
    "RunProfiledStep",
    "RunProfiler",
    "Span",
    "StepLogWriter",
    "StepProfile",
    "StepTiming",
    "Tracer",
    "TrainTelemetry",
    "Watchtower",
    "arm_watchtower",
    "attribute",
    "chrome_trace_events",
    "current_trace_context",
    "default_profile_store",
    "default_registry",
    "default_rules",
    "default_runprof",
    "find_sessions",
    "flat_record",
    "format_traceparent",
    "get_engine",
    "get_history",
    "get_runprof",
    "get_tracer",
    "global_norm",
    "load_session",
    "maybe_runprof",
    "maybe_span",
    "merge_snapshots",
    "parse_traceparent",
    "profile_compiled",
    "profile_lowered",
    "read_spill",
    "read_step_log",
    "render_prometheus",
    "render_snapshot",
    "replay_spill",
    "resolve_runprof",
    "sanitize_name",
    "set_engine",
    "set_history",
    "set_runprof",
    "set_tracer",
    "summarize_session",
    "summarize_step_log",
    "train_step_metrics",
    "update_metrics",
]
