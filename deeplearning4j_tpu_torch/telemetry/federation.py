"""Counterpart of ``deeplearning4j_tpu/telemetry/federation.py``: the
tracker-federated cluster metrics.

Every telemetry registry is process-local by design, yet a serving fleet
needs *cross-replica* signals: a router dispatching on queue depth, a
record of which weight version each replica serves. This module
federates the per-process registries through the StateTracker's KV map
into one cluster view:

- **push side** (:class:`MetricsPusher`): each process periodically
  serializes its registry snapshot as a versioned JSON payload
  (``{"schema": "dl4j-tpu-fedmetrics-v1", "process", "pid", "ts",
  "seq", "snapshot"}``) and writes it to the tracker's KV map under
  ``federation.metrics.<process>`` (``put_kv``: last-write-wins per key,
  so a retry after an ambiguous transport failure is safe). JSON rather
  than pickled objects keeps the payload wire-inspectable and lets a
  JAX aggregator read a port pusher's rows and the other way round (the
  ``schema`` field gates merges).
- **aggregate side** (:class:`ClusterAggregator`): one ``kv_snapshot``
  RPC reads every process's latest payload; :func:`merge_snapshots`
  folds them into a registry-snapshot-shaped cluster view: **counters
  sum** across processes (same name + labels), **gauges stay
  per-process** (a ``process`` label is added: averaging a queue-depth
  gauge across replicas would destroy exactly the signal the router
  needs), **histograms bucket-merge** (per-``le`` cumulative counts
  added; identical bucket bounds merge exactly, and a bound one process
  lacks uses its count at the largest bound <= it, a documented lower
  bound, never an invented observation).
- **staleness**: each payload carries the pusher's wall-clock ``ts``; a
  process whose last push is older than ``stale_after_s`` is marked
  ``stale``; its last-known data stays in the merge (the honest read:
  "this is what it looked like when we last heard from it"), the flag
  says how much to trust it.
- **alerts** (:meth:`ClusterAggregator.collect_alerts`): reads the alert
  rows each ``telemetry/alerts.AlertEngine`` publishes under
  ``federation.alerts.<process>`` (the engine's schema and KV prefix).

Both halves report their own health under ``federation_*`` in their
local registries (pushes, push failures, collects, process/stale-process
gauges). :meth:`ClusterAggregator.prometheus_snapshot` builds the
cluster snapshot that ``telemetry/prometheus.render_snapshot`` renders;
the UI's ``/api/cluster`` and ``/metrics?scope=cluster`` routes come with
ROADMAP item 21c. The pusher's lock is a plain ``threading.Lock``
(the lock-order watchdog comes with item 21d).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.telemetry.alerts import (
    ALERT_KV_PREFIX,
    SCHEMA as ALERT_SCHEMA,
)

log = logging.getLogger(__name__)

SCHEMA = "dl4j-tpu-fedmetrics-v1"
KV_PREFIX = "federation.metrics."


# ------------------------------------------------------------- push side ----

class MetricsPusher:
    """Periodically push one registry's snapshot to the tracker.

    ``tracker`` is anything with ``put_kv`` (the in-memory tracker, the
    embedded server handle, or a StateTrackerClient across processes).
    ``start()`` runs the cadence on a background thread; ``push_once()``
    is the synchronous unit (tests and shutdown flushes call it
    directly). Transport faults are absorbed: a failed push counts
    ``federation_push_failures_total`` and the next interval retries —
    a flapping tracker degrades freshness, never the pushing process.
    """

    def __init__(self, tracker, process: str, registry=None,
                 interval_s: float = 1.0):
        if registry is None:
            from deeplearning4j_tpu_torch.telemetry.registry import (
                default_registry,
            )

            registry = default_registry()
        self._tracker = tracker
        self.process = str(process)
        self.registry = registry
        self.interval_s = float(interval_s)
        self._lock = threading.Lock()
        self._seq = 0
        self._fail_streak = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def payload(self) -> Dict[str, Any]:
        """The next versioned push payload (seq is consumed)."""
        with self._lock:
            seq = self._seq
            self._seq += 1
        return {"schema": SCHEMA, "process": self.process,
                "pid": os.getpid(), "ts": time.time(), "seq": seq,
                "snapshot": self.registry.snapshot()}

    def push_once(self) -> bool:
        """One snapshot push; True on success. The RPC runs outside the
        pusher lock (the lock only guards the seq counter)."""
        payload = self.payload()
        try:
            self._tracker.put_kv(KV_PREFIX + self.process,
                                 json.dumps(payload))
        except (ConnectionError, OSError) as exc:
            # absorbed: freshness degrades, the pushing process survives —
            # but say so once per outage (the counter alone is invisible
            # until someone scrapes it), not once per interval
            self.registry.counter("federation_push_failures_total").inc()
            self.registry.gauge("federation_last_push_error").set(1.0)
            self._fail_streak += 1
            if self._fail_streak == 1:
                log.warning("federation push for %s failing (tracker "
                            "unreachable): %r", self.process, exc)
            return False
        if self._fail_streak:
            log.info("federation push for %s recovered after %d "
                     "failure(s)", self.process, self._fail_streak)
            self._fail_streak = 0
        self.registry.counter("federation_pushes_total").inc()
        self.registry.gauge("federation_last_push_unix").set(payload["ts"])
        self.registry.gauge("federation_last_push_error").set(0.0)
        return True

    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"federation-pusher-{self.process}")
            self._thread.start()

    def _loop(self) -> None:
        # first push immediately: an aggregator should see a fresh
        # process within one collect, not one interval later
        self.push_once()
        while not self._stop.wait(self.interval_s):
            self.push_once()

    def stop(self, final_push: bool = True) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
        self._stop.set()
        if thread is not None:
            thread.join(timeout=10)
        if final_push:
            self.push_once()  # the last state lands even mid-interval

    def __enter__(self) -> "MetricsPusher":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


# ------------------------------------------------------------ merge core ----

def _label_key(labels: Dict) -> Tuple:
    return tuple(sorted((str(k), str(v))
                 for k, v in (labels or {}).items()))


def _merge_histograms(snaps: List[Dict]) -> Dict:
    """Bucket-merge: cumulative counts added per ``le`` over the union of
    bounds. A source lacking a bound contributes its cumulative count at
    the largest of its own bounds ≤ that bound (0 below its first) — a
    lower bound on the true value, exact when bounds are identical (the
    repo-wide DEFAULT_BUCKETS case)."""
    bounds = sorted({b["le"] for s in snaps for b in s["buckets"]})

    def cum_at(snap: Dict, bound: float) -> int:
        best = 0
        for b in snap["buckets"]:
            if b["le"] <= bound:
                best = b["count"]
            else:
                break
        return best

    return {
        "buckets": [{"le": b, "count": sum(cum_at(s, b) for s in snaps)}
                    for b in bounds],
        "sum": sum(s["sum"] for s in snaps),
        "count": sum(s["count"] for s in snaps),
    }


def merge_snapshots(named: Sequence[Tuple[str, Dict]]) -> Dict:
    """Fold ``(process, registry.snapshot())`` pairs into one
    registry-snapshot-shaped cluster view (module docstring semantics:
    counter sum / gauge per-process / histogram bucket-merge)."""
    counters: Dict[Tuple, Dict] = {}
    gauges: List[Dict] = []
    histograms: Dict[Tuple, Dict] = {}
    for process, snap in named:
        for row in snap.get("counters", []):
            key = (row["name"], _label_key(row["labels"]))
            if key not in counters:
                counters[key] = {"name": row["name"],
                                 "labels": dict(row["labels"]),
                                 "value": 0.0}
            counters[key]["value"] += row["value"]
        for row in snap.get("gauges", []):
            gauges.append({"name": row["name"],
                           "labels": dict(row["labels"],
                                          process=str(process)),
                           "value": row["value"]})
        for row in snap.get("histograms", []):
            key = (row["name"], _label_key(row["labels"]))
            histograms.setdefault(key, {"name": row["name"],
                                        "labels": dict(row["labels"]),
                                        "snaps": []})
            histograms[key]["snaps"].append(row)
    return {
        "counters": [counters[k] for k in sorted(counters)],
        "gauges": sorted(gauges, key=lambda r: (r["name"],
                                                sorted(r["labels"].items()))),
        "histograms": [
            {"name": h["name"], "labels": h["labels"],
             **_merge_histograms(h["snaps"])}
            for _, h in sorted(histograms.items(), key=lambda kv: kv[0])
        ],
    }


# -------------------------------------------------------- aggregate side ----

class ClusterAggregator:
    """Read every process's pushed payload and build the cluster view.

    ``collect()`` is the ``/api/cluster`` handler's body: one
    ``kv_snapshot`` read, schema-gated parse, staleness marking, merge.
    Unparseable or wrong-schema payloads are skipped and counted
    (``federation_bad_payloads_total``) — one broken pusher must never
    blank the whole cluster view."""

    def __init__(self, tracker, stale_after_s: float = 10.0,
                 registry=None):
        if registry is None:
            from deeplearning4j_tpu_torch.telemetry.registry import (
                default_registry,
            )

            registry = default_registry()
        self._tracker = tracker
        self.stale_after_s = float(stale_after_s)
        self.registry = registry

    def collect(self) -> Dict[str, Any]:
        now = time.time()
        try:
            raw = self._tracker.kv_snapshot(KV_PREFIX)
        except (ConnectionError, OSError) as exc:
            self.registry.counter("federation_collect_failures_total").inc()
            return {"schema": SCHEMA, "ts": now, "error": str(exc),
                    "stale_after_s": self.stale_after_s,
                    "processes": [], "merged": merge_snapshots([])}
        processes: List[Dict] = []
        named: List[Tuple[str, Dict]] = []
        for key in sorted(raw):
            try:
                payload = json.loads(raw[key])
            except (TypeError, ValueError):
                self.registry.counter("federation_bad_payloads_total").inc()
                continue
            if (not isinstance(payload, dict)
                    or payload.get("schema") != SCHEMA):
                self.registry.counter("federation_bad_payloads_total").inc()
                continue
            age = now - float(payload.get("ts", 0.0))
            stale = age > self.stale_after_s
            processes.append({
                "process": payload.get("process", key[len(KV_PREFIX):]),
                "pid": payload.get("pid"), "seq": payload.get("seq"),
                "ts": payload.get("ts"), "age_s": round(age, 3),
                "stale": stale,
            })
            named.append((processes[-1]["process"],
                          payload.get("snapshot") or {}))
        self.registry.counter("federation_collects_total").inc()
        self.registry.gauge("federation_processes").set(
            float(len(processes)))
        self.registry.gauge("federation_stale_processes").set(
            float(sum(p["stale"] for p in processes)))
        return {"schema": SCHEMA, "ts": now,
                "stale_after_s": self.stale_after_s,
                "processes": processes,
                "merged": merge_snapshots(named)}

    def prometheus_snapshot(self) -> Dict[str, Any]:
        """The cluster view as a registry-snapshot-shaped dict ready for
        ``telemetry/prometheus.render_snapshot``: the merged instruments
        plus per-process ``federation_process_up`` (1 fresh / 0 stale)
        and ``federation_process_age_seconds`` gauges (how ``/metrics
        ?scope=cluster`` marks a lapsed pusher)."""
        view = self.collect()
        snap = view["merged"]
        # family-grouped (Prometheus wants a family's samples contiguous)
        for p in view["processes"]:
            snap["gauges"].append({"name": "federation_process_up",
                                   "labels": {"process": str(p["process"])},
                                   "value": 0.0 if p["stale"] else 1.0})
        for p in view["processes"]:
            snap["gauges"].append({
                "name": "federation_process_age_seconds",
                "labels": {"process": str(p["process"])},
                "value": p["age_s"]})
        return snap

    def metrics_record(self) -> Dict[str, float]:
        """The aggregator's own ``federation_*`` health metrics as a flat
        step-log record (same contract as DecodeEngine.metrics_record)."""
        from deeplearning4j_tpu_torch.telemetry.registry import flat_record

        return flat_record(self.registry, prefixes=("federation_",))

    # ------------------------------------------------------ cluster alerts ----
    def collect_alerts(self) -> Dict[str, Any]:
        """The cluster-wide alert view: one ``kv_snapshot`` read of every
        process's published alert payload (an alert engine publishes
        under ``federation.alerts.<process>``), schema-gated
        and staleness-marked exactly like the metric payloads. Alerts
        keep their per-process identity (a ``process`` field per row —
        summing verdicts would destroy the routing signal); ``firing``
        is the cluster-wide count of currently-firing rules — the single
        number a router or hot-swap gate dispatches on."""
        now = time.time()
        try:
            raw = self._tracker.kv_snapshot(ALERT_KV_PREFIX)
        except (ConnectionError, OSError) as exc:
            self.registry.counter("federation_collect_failures_total").inc()
            return {"schema": ALERT_SCHEMA, "ts": now, "error": str(exc),
                    "stale_after_s": self.stale_after_s,
                    "processes": [], "alerts": [], "firing": 0}
        processes: List[Dict] = []
        alerts: List[Dict] = []
        for key in sorted(raw):
            try:
                payload = json.loads(raw[key])
            except (TypeError, ValueError):
                self.registry.counter("federation_bad_payloads_total").inc()
                continue
            if (not isinstance(payload, dict)
                    or payload.get("schema") != ALERT_SCHEMA):
                self.registry.counter("federation_bad_payloads_total").inc()
                continue
            process = payload.get("process",
                                  key[len(ALERT_KV_PREFIX):])
            age = now - float(payload.get("ts", 0.0))
            stale = age > self.stale_after_s
            processes.append({"process": process,
                              "pid": payload.get("pid"),
                              "seq": payload.get("seq"),
                              "ts": payload.get("ts"),
                              "age_s": round(age, 3), "stale": stale})
            for row in payload.get("alerts") or []:
                if isinstance(row, dict):
                    alerts.append(dict(row, process=process, stale=stale))
        alerts.sort(key=lambda a: (a.get("state") != "firing",
                                   str(a.get("severity")),
                                   str(a.get("rule"))))
        firing = sum(a.get("state") == "firing" for a in alerts)
        self.registry.gauge("federation_cluster_alerts_firing").set(
            float(firing))
        return {"schema": ALERT_SCHEMA, "ts": now,
                "stale_after_s": self.stale_after_s,
                "processes": processes, "alerts": alerts,
                "firing": firing}
