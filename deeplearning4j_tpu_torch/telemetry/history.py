"""Counterpart of ``deeplearning4j_tpu/telemetry/history.py``: the bounded
metrics time-series history, the *watch* layer's memory.

The registry answers "what is the value NOW"; every alerting
question is about *change* — is the skip counter still climbing, did the
queue depth grow for 30 seconds, what was p99 over the last minute. This
module snapshots a :class:`~deeplearning4j_tpu_torch.telemetry.registry.
MetricsRegistry` on a cadence into per-series ring buffers and answers
exactly those range/rate/delta questions, so telemetry/alerts.py can be a
pure rule evaluator with no storage of its own.

Storage model:

- one **sample** = one ``registry.snapshot()`` + a wall-clock timestamp;
  every instrument in the registry contributes one point per sample to
  its series ``(kind, name, sorted-labels)``;
- counters/gauges store ``(ts, value)``; histograms store the full
  cumulative bucket snapshot per sample, which is what makes **windowed
  percentiles** possible: the bucket-count *delta* between the window's
  edges is a histogram of only the observations inside the window
  (:meth:`MetricsHistory.histogram_window` /
  :meth:`MetricsHistory.percentile_over` — an all-time percentile would
  never resolve, say, a latency regression that started two minutes ago);
- every series is a bounded ``deque(maxlen=window)`` — memory is
  O(series x window), independent of run length.

Spill (crash-readable, write-ahead): with ``spill_path`` set, every
sample is appended to a line-buffered JSONL file BEFORE it lands in the
in-memory rings — the same posture as the flight recorder, so a
``kill -9`` leaves every completed sample on disk for
``tools/alert_report.py`` (:func:`read_spill` / :func:`replay_spill`).

Query semantics (shared by every rule kind in telemetry/alerts.py):

- ``labels=None`` matches EVERY label set of the name and sums values
  per sample — right for counters (total rate across label sets) and for
  additive gauges like queue depth; pass explicit labels to pin one
  series;
- :meth:`rate` is the per-second increase from the oldest to the newest
  point inside ``window_s``; a counter reset (negative delta) restarts
  the window at the reset point rather than reporting a negative rate;
- :meth:`delta` is the signed value change over the window (gauges);
- :meth:`last_point` / series timestamps back absence/staleness rules.

Threading: the background sampler (``start()``/``stop()``) keeps its
state under a plain ``threading.Lock`` (the lock-order watchdog is
ROADMAP item 21d), the thread handle swapped under the lock and joined
outside it with a timeout, stop idempotent, start-after-stop supported —
and the spill file handle is opened in the constructor, never under the
lock. Zero-cost unconfigured: nothing samples until a ``MetricsHistory``
is built, and the module-level ``get_history()`` seam is one attribute
read.

Knobs (host-side, blessed ``DL4J_TPU_*`` namespace; read by
:func:`configure` for unset arguments):

- ``DL4J_TPU_HISTORY_INTERVAL_S``: sampler cadence (default 1.0).
- ``DL4J_TPU_HISTORY_WINDOW``: ring size in samples (default 512).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple


SCHEMA = "dl4j-tpu-history-v1"

_ENV_INTERVAL = "DL4J_TPU_HISTORY_INTERVAL_S"
_ENV_WINDOW = "DL4J_TPU_HISTORY_WINDOW"

DEFAULT_INTERVAL_S = 1.0
DEFAULT_WINDOW = 512

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsHistory:
    """Ring-buffered time series over one registry (module docstring)."""

    def __init__(self, registry=None, window: int = DEFAULT_WINDOW,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 spill_path: Optional[str] = None):
        if registry is None:
            from deeplearning4j_tpu_torch.telemetry.registry import default_registry

            registry = default_registry()
        self.registry = registry
        self.window = max(2, int(window))
        self.interval_s = float(interval_s)
        self.spill_path = spill_path
        self._fh = None
        if spill_path is not None:
            parent = os.path.dirname(os.path.abspath(spill_path))
            os.makedirs(parent, exist_ok=True)
            # opened OUTSIDE the lock (no blocking call under it);
            # line-buffered so each sample is one durable line
            self._fh = open(spill_path, "a", buffering=1)
        self._lock = threading.Lock()
        # (kind, name, label_key) -> deque[(ts, value-or-hist-snapshot)]
        self._series: Dict[Tuple[str, str, LabelKey], deque] = {}
        self._samples = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ sampling ----
    def sample_once(self, now: Optional[float] = None) -> float:
        """Take one registry snapshot into the rings (and the spill,
        write-ahead). Returns the sample timestamp."""
        ts = time.time() if now is None else float(now)
        snap = self.registry.snapshot()
        with self._lock:
            fh = self._fh
            seq = self._samples
        rec = {"schema": SCHEMA, "ts": ts, "seq": seq, "snapshot": snap}
        if fh is not None:
            try:
                fh.write(json.dumps(rec) + "\n")
            except (OSError, ValueError):
                pass
        with self._lock:
            self._ingest(ts, snap)
            self._samples += 1
            n_series = len(self._series)
        self.registry.counter("history_samples_total").inc()
        self.registry.gauge("history_series").set(float(n_series))
        self.registry.gauge("history_last_sample_unix").set(ts)
        return ts

    def _ingest(self, ts: float, snap: Dict) -> None:
        for kind, rows in (("counter", snap.get("counters", ())),
                           ("gauge", snap.get("gauges", ()))):
            for row in rows:
                key = (kind, row["name"], _label_key(row["labels"]))
                ring = self._series.get(key)
                if ring is None:
                    ring = self._series[key] = deque(maxlen=self.window)
                ring.append((ts, float(row["value"])))
        for row in snap.get("histograms", ()):
            key = ("histogram", row["name"], _label_key(row["labels"]))
            ring = self._series.get(key)
            if ring is None:
                ring = self._series[key] = deque(maxlen=self.window)
            ring.append((ts, {"buckets": [dict(b) for b in row["buckets"]],
                              "sum": row["sum"], "count": row["count"]}))

    # ----------------------------------------------------- sampler thread ----
    def start(self) -> None:
        """Run ``sample_once`` every ``interval_s`` on a background
        thread (first sample immediately — an alert engine attached right
        after start sees a baseline point, not an empty ring)."""
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="metrics-history")
            self._thread.start()

    def _loop(self) -> None:
        self.sample_once()
        while not self._stop.wait(self.interval_s):
            self.sample_once()

    def stop(self) -> None:
        # handle swap under the lock, join outside (concurrent stop()s race-free, and the join never holds the lock
        # the sampling loop needs)
        with self._lock:
            thread, self._thread = self._thread, None
        self._stop.set()
        if thread is not None:
            thread.join(timeout=10)

    def close(self) -> None:
        self.stop()
        # handle swap under the lock (the sampler thread writes through
        # self._fh), close outside it
        with self._lock:
            fh, self._fh = self._fh, None
        if fh is not None:
            fh.close()

    def __enter__(self) -> "MetricsHistory":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ queries ----
    def _matching(self, kind: str, name: str, labels: Optional[Dict]
                  ) -> List[deque]:
        want = None if labels is None else _label_key(labels)
        out = []
        for (k, n, lk), ring in self._series.items():
            if k == kind and n == name and (want is None or lk == want):
                out.append(ring)
        return out

    def series_index(self) -> List[Dict]:
        """One row per stored series (the ``/api/history`` listing)."""
        with self._lock:
            rows = []
            for (kind, name, lk), ring in sorted(self._series.items()):
                last_ts, last_v = ring[-1]
                rows.append({
                    "kind": kind, "name": name, "labels": dict(lk),
                    "points": len(ring), "last_ts": last_ts,
                    "last_value": (last_v if kind != "histogram"
                                   else last_v["count"]),
                })
            return rows

    def points(self, name: str, labels: Optional[Dict] = None,
               window_s: Optional[float] = None,
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        """Scalar points ``[(ts, value), ...]`` for counters/gauges.
        ``labels=None`` sums every label set of the name per sample
        timestamp (module docstring); ``window_s`` keeps only points
        newer than ``now - window_s``."""
        now = time.time() if now is None else float(now)
        cut = None if window_s is None else now - float(window_s)
        with self._lock:
            rings = (self._matching("counter", name, labels)
                     or self._matching("gauge", name, labels))
            merged: Dict[float, float] = {}
            for ring in rings:
                for ts, v in ring:
                    if cut is not None and ts < cut:
                        continue
                    merged[ts] = merged.get(ts, 0.0) + v
        return sorted(merged.items())

    def last_point(self, name: str, labels: Optional[Dict] = None
                   ) -> Optional[Tuple[float, float]]:
        pts = self.points(name, labels)
        return pts[-1] if pts else None

    def last_points_by_label(self, name: str
                             ) -> List[Tuple[Dict, float, float]]:
        """Per-label-set latest scalar point ``(labels, ts, value)`` —
        what a labeled staleness rule iterates (one verdict per worker)."""
        out = []
        with self._lock:
            for (kind, n, lk), ring in sorted(self._series.items()):
                if n != name or kind == "histogram" or not ring:
                    continue
                ts, v = ring[-1]
                out.append((dict(lk), ts, v))
        return out

    def rate(self, name: str, labels: Optional[Dict] = None,
             window_s: float = 60.0, now: Optional[float] = None
             ) -> Optional[float]:
        """Per-second increase over the window (counter semantics). A
        reset (negative step between adjacent samples) restarts the
        measurement at the reset point. None with fewer than two points."""
        pts = self.points(name, labels, window_s=window_s, now=now)
        if len(pts) < 2:
            return None
        # walk from the oldest point, restarting after any reset
        start = 0
        for i in range(1, len(pts)):
            if pts[i][1] < pts[i - 1][1]:
                start = i
        (t0, v0), (t1, v1) = pts[start], pts[-1]
        if t1 <= t0:
            return None
        return (v1 - v0) / (t1 - t0)

    def delta(self, name: str, labels: Optional[Dict] = None,
              window_s: float = 60.0, now: Optional[float] = None
              ) -> Optional[float]:
        """Signed value change over the window (gauge semantics: queue
        growth is a positive delta). None with fewer than two points."""
        pts = self.points(name, labels, window_s=window_s, now=now)
        if len(pts) < 2:
            return None
        return pts[-1][1] - pts[0][1]

    # --------------------------------------------------------- histograms ----
    def _hist_points(self, name: str, labels: Optional[Dict]
                     ) -> List[Tuple[float, Dict]]:
        with self._lock:
            rings = self._matching("histogram", name, labels)
            if not rings:
                return []
            if len(rings) == 1:
                return list(rings[0])
            # multiple label sets: merge per-ts (cumulative counts add)
            by_ts: Dict[float, List[Dict]] = {}
            for ring in rings:
                for ts, snap in ring:
                    by_ts.setdefault(ts, []).append(snap)
        out = []
        for ts in sorted(by_ts):
            snaps = by_ts[ts]
            bounds = sorted({b["le"] for s in snaps for b in s["buckets"]})
            merged = {
                "buckets": [{"le": b, "count": sum(_cum_at(s, b)
                                                   for s in snaps)}
                            for b in bounds],
                "sum": sum(s["sum"] for s in snaps),
                "count": sum(s["count"] for s in snaps),
            }
            out.append((ts, merged))
        return out

    def histogram_window(self, name: str, labels: Optional[Dict] = None,
                         window_s: float = 60.0,
                         now: Optional[float] = None) -> Optional[Dict]:
        """The bucket-count DELTA between the window's edge samples — a
        cumulative-bucket histogram of only the observations that landed
        inside the window. None without two samples to difference."""
        now = time.time() if now is None else float(now)
        pts = self._hist_points(name, labels)
        pts = [(ts, s) for ts, s in pts if ts >= now - float(window_s)]
        if len(pts) < 2:
            return None
        (t0, s0), (t1, s1) = pts[0], pts[-1]
        if s1["count"] < s0["count"]:  # restart: the window spans a reset
            s0 = {"buckets": [{"le": b["le"], "count": 0}
                              for b in s1["buckets"]], "sum": 0.0,
                  "count": 0}
        buckets = [{"le": b["le"],
                    "count": b["count"] - _cum_at(s0, b["le"])}
                   for b in s1["buckets"]]
        return {"buckets": buckets, "sum": s1["sum"] - s0["sum"],
                "count": s1["count"] - s0["count"],
                "from_ts": t0, "to_ts": t1}

    def percentile_over(self, name: str, q: float,
                        labels: Optional[Dict] = None,
                        window_s: float = 60.0,
                        now: Optional[float] = None) -> Optional[float]:
        """Approximate q-th percentile of the observations inside the
        window (bucket upper bound covering the rank, same estimator as
        Histogram.percentile — but WINDOWED). None when the window holds
        no observations."""
        win = self.histogram_window(name, labels, window_s, now=now)
        if win is None or win["count"] <= 0:
            return None
        rank = q / 100.0 * win["count"]
        for b in win["buckets"]:
            if b["count"] >= rank:
                return b["le"]
        return win["buckets"][-1]["le"] if win["buckets"] else None

    def fraction_over(self, name: str, bound: float,
                      labels: Optional[Dict] = None,
                      window_s: float = 60.0,
                      now: Optional[float] = None) -> Optional[float]:
        """Fraction of windowed observations strictly above ``bound``
        (the burn-rate numerator). Exact when ``bound`` is a bucket
        bound; otherwise a documented lower bound (counts at the largest
        bucket bound <= ``bound`` are treated as within SLO). None when
        the window holds no observations."""
        win = self.histogram_window(name, labels, window_s, now=now)
        if win is None or win["count"] <= 0:
            return None
        good = 0
        for b in win["buckets"]:
            if b["le"] <= bound:
                good = b["count"]
            else:
                break
        return (win["count"] - good) / win["count"]

    # ----------------------------------------------------------- plumbing ----
    def metrics_record(self) -> Dict[str, float]:
        """The history's own ``history_*`` health metrics as a flat
        step-log record (same contract as the serve/federation/lockwatch
        emitters, so tools/telemetry_report.py renders them)."""
        from deeplearning4j_tpu_torch.telemetry.registry import flat_record

        return flat_record(self.registry, prefixes=("history_",))

    def snapshot(self, name: Optional[str] = None,
                 window_s: Optional[float] = None) -> Dict:
        """The ``/api/history`` payload: the series index, plus the
        scalar points of ``name`` when given."""
        with self._lock:
            samples = self._samples
        out: Dict = {"schema": SCHEMA, "samples": samples,
                     "window": self.window, "interval_s": self.interval_s,
                     "series": self.series_index()}
        if name is not None:
            out["name"] = name
            out["points"] = [[ts, v] for ts, v in
                             self.points(name, window_s=window_s)]
        return out


def _cum_at(snap: Dict, bound: float) -> int:
    """Cumulative count of ``snap`` at ``bound`` (0 below its first
    bucket) — shared by the per-ts merge and the window differencing."""
    best = 0
    for b in snap["buckets"]:
        if b["le"] <= bound:
            best = b["count"]
        else:
            break
    return best


# -------------------------------------------------------------- spill IO ----

def read_spill(path: str) -> List[Dict]:
    """Parse a history spill back into sample records. Tolerates a
    truncated final line (the writer died mid-sample — by the write-ahead
    contract every earlier sample is complete); any other malformed line
    raises ``ValueError`` naming it."""
    out: List[Dict] = []
    with open(path) as fh:
        lines = fh.read().splitlines()
    for lineno, line in enumerate(lines, start=1):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as exc:
            if lineno == len(lines):
                break  # killed mid-write: the torn tail line is expected
            raise ValueError(
                f"history spill {path} is corrupt at line {lineno}: "
                f"{exc}") from exc
        if isinstance(rec, dict) and rec.get("schema") == SCHEMA:
            out.append(rec)
    return out


def replay_spill(path: str, window: int = DEFAULT_WINDOW
                 ) -> "MetricsHistory":
    """Rebuild a queryable history from a spill file — how
    tools/alert_report.py re-answers range/rate questions after the
    watched process is gone."""
    from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

    hist = MetricsHistory(registry=MetricsRegistry(), window=window)
    for rec in read_spill(path):
        with hist._lock:
            hist._ingest(float(rec["ts"]), rec.get("snapshot") or {})
            hist._samples += 1
    return hist


# ------------------------------------------------ process-global history ----
# The ambient seam, mirroring trace.get_tracer(): instrumentation-free —
# the UI server and alert engine read it per call, so history is a
# per-process switch, not a constructor parameter everywhere.

_history: Optional[MetricsHistory] = None
_history_lock = threading.Lock()


def get_history() -> Optional[MetricsHistory]:
    return _history


def set_history(history: Optional[MetricsHistory]
                ) -> Optional[MetricsHistory]:
    """Install (or clear, with None) the process history; returns the
    previous one so tests can restore it."""
    global _history
    with _history_lock:
        prev, _history = _history, history
    return prev


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def configure(registry=None, spill_path: Optional[str] = None,
              interval_s: Optional[float] = None,
              window: Optional[int] = None,
              start: bool = True) -> MetricsHistory:
    """Build a history (env knobs fill unset arguments), install it as
    the process history, and (by default) start the sampler."""
    if interval_s is None:
        interval_s = _env_float(_ENV_INTERVAL, DEFAULT_INTERVAL_S)
    if window is None:
        window = int(_env_float(_ENV_WINDOW, DEFAULT_WINDOW))
    hist = MetricsHistory(registry=registry, window=window,
                          interval_s=interval_s, spill_path=spill_path)
    if start:
        hist.start()
    set_history(hist)
    return hist
