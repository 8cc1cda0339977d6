"""Counterpart of ``deeplearning4j_tpu/telemetry/registry.py``: the host-side
metrics registry (counters, gauges, histograms with labels) the decode
engine writes its ``serve_*`` metrics into.

Semantics follow the Prometheus client model:

- ``Counter``: monotonically increasing float (negative increments are
  rejected).
- ``Gauge``: a float that can go anywhere (``set``/``inc``).
- ``Histogram``: cumulative bucket counts over fixed ``le`` upper bounds
  plus ``sum``/``count`` (an implicit ``+Inf`` bucket always exists), and
  per bucket the latest trace exemplar: ``observe(value, exemplar=)``
  attaches a trace id (by default the calling thread's current span's,
  when the process tracer of ``telemetry/trace.py`` has one open).

Instruments are identified by (name, labels) and are get-or-create. Every
instrument guards its state with its own ``threading.Lock``; the registry's
get-or-create maps are guarded by one ``threading.RLock`` and instrument
methods never take it, so there is no lock-ordering cycle. The registry's
RLock is the ``telemetry.registry`` lockwatch seam
(``utils.lockwatch.make_rlock``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.utils.lockwatch import make_rlock

# per-iteration wall-clock style measurements land in milliseconds
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0,
)

LabelDict = Optional[Dict[str, str]]


def _current_trace_id() -> Optional[str]:
    """The calling thread's current span's trace id, or None when tracing
    is off or no span is open. Imported lazily: trace.py takes
    default_registry from here."""
    from deeplearning4j_tpu_torch.telemetry import trace as _trace

    tracer = _trace.get_tracer()
    if tracer is None:
        return None
    sp = tracer.current_span()
    return sp.trace_id if sp is not None else None


def _label_key(labels: LabelDict) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, by: float = 1.0) -> None:
        if by < 0:
            raise ValueError(f"counter increment must be >= 0, got {by}")
        with self._lock:
            self._value += by

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, by: float = 1.0) -> None:
        with self._lock:
            self._value += by

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self._lock = threading.Lock()
        self.bounds = bs
        self._counts = [0] * (len(bs) + 1)  # last slot = +Inf
        self._sum = 0.0
        self._count = 0
        # per-bucket latest {trace_id, value, ts}: empty unless a trace id
        # was captured, so snapshots are unchanged when tracing is off
        self._exemplars: Dict[int, Dict] = {}

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        """Record one observation. ``exemplar`` attaches a trace id to the
        observation's bucket (latest wins per bucket); with
        ``exemplar=None`` the calling thread's current span (the process
        tracer's) is captured when one is open, and nothing is stored
        otherwise."""
        value = float(value)
        if exemplar is None:
            exemplar = _current_trace_id()
        with self._lock:
            self._sum += value
            self._count += 1
            for i, b in enumerate(self.bounds):
                if value <= b:
                    idx = i
                    break
            else:
                idx = len(self.bounds)
            self._counts[idx] += 1
            if exemplar is not None:
                self._exemplars[idx] = {"trace_id": str(exemplar),
                                        "value": value, "ts": time.time()}

    def _exemplar_rows(self) -> List[Dict]:
        # called under self._lock
        bounds = list(self.bounds) + [float("inf")]
        return [{"le": bounds[i], **dict(self._exemplars[i])}
                for i in sorted(self._exemplars)]

    def exemplars(self) -> List[Dict]:
        """Recorded exemplars, one per bucket that has one: ``{"le",
        "trace_id", "value", "ts"}`` sorted by bucket bound."""
        with self._lock:
            return self._exemplar_rows()

    def snapshot(self) -> Dict:
        """Cumulative bucket counts (Prometheus ``le`` semantics) +
        sum/count, and an ``exemplars`` list only when exemplars were
        captured."""
        with self._lock:
            cum, acc = [], 0
            for i, b in enumerate(self.bounds):
                acc += self._counts[i]
                cum.append({"le": b, "count": acc})
            cum.append({"le": float("inf"), "count": acc + self._counts[-1]})
            out = {"buckets": cum, "sum": self._sum, "count": self._count}
            if self._exemplars:
                out["exemplars"] = self._exemplar_rows()
            return out

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (bucket upper bound that covers it)."""
        snap = self.snapshot()
        total = snap["count"]
        if total == 0:
            return 0.0
        rank = q / 100.0 * total
        for b in snap["buckets"]:
            if b["count"] >= rank:
                return b["le"]
        return snap["buckets"][-1]["le"]


class MetricsRegistry:
    """Get-or-create instrument store keyed by (name, sorted labels)."""

    def __init__(self) -> None:
        self._lock = make_rlock("telemetry.registry")  # lockwatch seam
        self._counters: Dict[Tuple, Counter] = {}
        self._gauges: Dict[Tuple, Gauge] = {}
        self._histograms: Dict[Tuple, Histogram] = {}

    def counter(self, name: str, labels: LabelDict = None) -> Counter:
        key = (name, _label_key(labels))
        with self._lock:
            if key not in self._counters:
                self._counters[key] = Counter()
            return self._counters[key]

    def gauge(self, name: str, labels: LabelDict = None) -> Gauge:
        key = (name, _label_key(labels))
        with self._lock:
            if key not in self._gauges:
                self._gauges[key] = Gauge()
            return self._gauges[key]

    def histogram(self, name: str, labels: LabelDict = None,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        key = (name, _label_key(labels))
        with self._lock:
            if key not in self._histograms:
                self._histograms[key] = Histogram(buckets)
            return self._histograms[key]

    def snapshot(self) -> Dict:
        """JSON-ready view of every instrument."""

        def rows(store, value_of) -> List[Dict]:
            return [
                {"name": name, "labels": dict(label_key),
                 **value_of(inst)}
                for (name, label_key), inst in sorted(store.items())
            ]

        with self._lock:
            return {
                "counters": rows(self._counters,
                                 lambda c: {"value": c.value}),
                "gauges": rows(self._gauges, lambda g: {"value": g.value}),
                "histograms": rows(self._histograms,
                                   lambda h: h.snapshot()),
            }


def flat_record(registry: MetricsRegistry,
                prefixes: Sequence[str] = ()) -> Dict[str, float]:
    """Flatten a registry snapshot into a ``{name: value}`` dict: counters
    sum across label sets, gauges last-write, histograms contribute
    ``<name>_count`` / ``<name>_sum``. ``prefixes`` restricts to names
    starting with any of them (empty = everything)."""
    snap = registry.snapshot()

    def keep(name: str) -> bool:
        return not prefixes or any(name.startswith(p) for p in prefixes)

    out: Dict[str, float] = {}
    for row in snap["counters"]:
        if keep(row["name"]):
            out[row["name"]] = out.get(row["name"], 0.0) + row["value"]
    for row in snap["gauges"]:
        if keep(row["name"]):
            out[row["name"]] = row["value"]
    for row in snap["histograms"]:
        if keep(row["name"]):
            out[f"{row['name']}_count"] = (
                out.get(f"{row['name']}_count", 0.0) + row["count"])
            out[f"{row['name']}_sum"] = (
                out.get(f"{row['name']}_sum", 0.0) + row["sum"])
    return out


# process-wide default registry (explicit registries compose fine)
_default: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default
