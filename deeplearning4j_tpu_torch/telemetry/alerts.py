"""Counterpart of ``deeplearning4j_tpu/telemetry/alerts.py``: declarative
alert rules over the metrics history, the verdict layer.

The registry, traces and federation record everything, but a record is
read after the fact: a diverging run or a p99 SLO burn is only visible to
a human reading a report. A router or a hot swap needs a
machine-readable health verdict; this engine produces it.

Rule kinds, all evaluated over :class:`~deeplearning4j_tpu_torch.telemetry.
history.MetricsHistory` queries (no storage of its own):

- ``threshold`` — the latest sampled value compared against
  ``threshold`` with ``op`` (``>``, ``>=``, ``<``, ``<=``);
- ``rate`` — the per-second increase over ``window_s``
  (``history.rate``: counter semantics, reset-safe) compared against
  ``threshold``; gauges work too (``serve_queue_depth`` growth uses the
  signed ``delta``/``window_s`` — set ``use_delta=True``);
- ``absence`` — heartbeat-timestamp staleness: the metric's value is a
  unix timestamp (the ``*_unix`` convention, e.g.
  ``elastic_worker_heartbeat_unix{worker=…}``); the rule fires when
  ``now - value > stale_s`` for ANY labeled series with a positive value
  (non-positive = the source deliberately retired that series, e.g. a
  buried worker). A missing metric is ``inactive`` unless
  ``fire_on_missing``;
- ``burn_rate`` — SLO burn over a latency histogram: with objective
  "fraction ``slo_target`` of requests complete within ``slo_ms``", the
  error budget is ``1 - slo_target`` and the burn rate is
  ``fraction_over(slo_ms) / budget`` across ``window_s`` (windowed
  bucket-delta, so an old latency regime can't mask a fresh burn). Fires
  when the burn exceeds ``threshold`` (1.0 = exactly eating budget at
  the sustainable pace; 2.0 = budget gone in half the SLO window).

Hysteresis (``for_s``): a true condition moves the rule
``inactive → pending``; only after staying true for ``for_s`` seconds
does it become ``firing`` (``for_s=0`` fires immediately). A false
condition resolves: ``firing → resolved`` (kept visible with its
timestamps; a later true condition re-enters through ``pending``),
``pending → inactive`` (a blip never fires).

A **firing transition** does three things (the contract):

1. bumps the registry — ``alerts_firing{rule,severity}`` gauge to 1
   (back to 0 on resolve) and ``alerts_transitions_total{rule,to}``;
2. dumps flight-recorder forensics through the process tracer
   (``reason=alert:<rule>`` with the rule's value/context — the open
   spans and counters AT the moment the rule fired);
3. publishes the alert state into the tracker KV
   (``federation.alerts.<process>``, last-write-wins, schema-gated) so
   :class:`~deeplearning4j_tpu_torch.telemetry.federation.ClusterAggregator.
   collect_alerts` merges a cluster-wide alert view — the master sees a
   worker's divergence, the router-to-be sees a replica's death.

Trace exemplars: for histogram-backed rules (``burn_rate``), the alert
state carries the recent exemplar trace ids above ``slo_ms`` from the
live registry histogram — ``/api/alerts`` links a firing latency rule
straight to offending traces, and ``tools/trace_report.py``
(``find_trace``) resolves them to real spans.

Threading mirrors history's sampler: a plain ``threading.Lock`` (the
lock-order watchdog is ROADMAP item 21d), handle-swap stop, join outside
the lock, idempotent and restartable. Zero-cost unconfigured — no
engine, no evaluation.

Knobs (host-side, blessed ``DL4J_TPU_*`` namespace):

- ``DL4J_TPU_ALERTS_INTERVAL_S``: evaluator cadence (default 1.0).
- ``DL4J_TPU_SERVE_SLO_MS``: the default pack's serve-latency SLO bound
  (default 250.0 — a DEFAULT_BUCKETS bound, so the burn fraction is
  exact).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


log = logging.getLogger(__name__)

SCHEMA = "dl4j-tpu-alerts-v1"
ALERT_KV_PREFIX = "federation.alerts."

_ENV_INTERVAL = "DL4J_TPU_ALERTS_INTERVAL_S"
_ENV_SERVE_SLO = "DL4J_TPU_SERVE_SLO_MS"

KINDS = ("threshold", "rate", "absence", "burn_rate")
SEVERITIES = ("info", "warning", "critical")
_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative rule (kinds + fields in the module docstring)."""

    name: str
    kind: str
    metric: str
    threshold: float = 0.0
    op: str = ">"
    window_s: float = 60.0
    for_s: float = 0.0
    severity: str = "warning"
    labels: Optional[Dict[str, str]] = None
    use_delta: bool = False          # rate kind: signed gauge delta/s
    stale_s: float = 10.0            # absence kind
    fire_on_missing: bool = False    # absence kind
    slo_ms: Optional[float] = None   # burn_rate kind: latency objective
    slo_target: float = 0.99         # burn_rate kind: goodput objective
    description: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown rule kind {self.kind!r} "
                             f"(one of {KINDS})")
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r} "
                             f"(one of {SEVERITIES})")
        if self.op not in _OPS:
            raise ValueError(f"unknown op {self.op!r} (one of "
                             f"{sorted(_OPS)})")
        if self.kind == "burn_rate":
            if self.slo_ms is None:
                raise ValueError(f"burn_rate rule {self.name!r} needs "
                                 "slo_ms")
            if not (0.0 < self.slo_target < 1.0):
                raise ValueError(f"slo_target must be in (0, 1), got "
                                 f"{self.slo_target}")


# ------------------------------------------------------------- conditions ----

def _evaluate_condition(rule: AlertRule, history, now: float
                        ) -> Tuple[bool, Optional[float], Dict]:
    """(active, measured value, context) for one rule against the
    history. No data → (False, None, …): a rule never fires on a metric
    its subsystem hasn't produced (except absence with fire_on_missing)."""
    if rule.kind == "threshold":
        pt = history.last_point(rule.metric, rule.labels)
        if pt is None:
            return False, None, {"reason": "no_data"}
        value = pt[1]
        return _OPS[rule.op](value, rule.threshold), value, {}
    if rule.kind == "rate":
        if rule.use_delta:
            d = history.delta(rule.metric, rule.labels,
                              window_s=rule.window_s, now=now)
            value = None if d is None else d / rule.window_s
        else:
            value = history.rate(rule.metric, rule.labels,
                                 window_s=rule.window_s, now=now)
        if value is None:
            return False, None, {"reason": "no_data"}
        return _OPS[rule.op](value, rule.threshold), value, {}
    if rule.kind == "absence":
        series = history.last_points_by_label(rule.metric)
        series = [(lbl, ts, v) for lbl, ts, v in series
                  if rule.labels is None
                  or all(lbl.get(k) == v2
                         for k, v2 in rule.labels.items())]
        if not series:
            if rule.fire_on_missing:
                return True, None, {"reason": "missing"}
            return False, None, {"reason": "no_data"}
        stale = [(lbl, now - v) for lbl, _ts, v in series
                 if v > 0 and now - v > rule.stale_s]
        if not stale:
            return False, 0.0, {}
        worst = max(age for _, age in stale)
        return True, worst, {"stale_series": [
            {"labels": lbl, "age_s": round(age, 3)} for lbl, age in stale]}
    # burn_rate
    frac = history.fraction_over(rule.metric, float(rule.slo_ms),
                                 rule.labels, window_s=rule.window_s,
                                 now=now)
    if frac is None:
        return False, None, {"reason": "no_data"}
    budget = 1.0 - rule.slo_target
    burn = frac / budget
    return burn > rule.threshold, burn, {
        "bad_fraction": round(frac, 6), "slo_ms": rule.slo_ms,
        "slo_target": rule.slo_target}


# ------------------------------------------------------------ state model ----

INACTIVE, PENDING, FIRING, RESOLVED = ("inactive", "pending", "firing",
                                       "resolved")


class _RuleState:
    __slots__ = ("rule", "state", "since", "pending_since", "fired_at",
                 "resolved_at", "value", "context", "fire_count")

    def __init__(self, rule: AlertRule):
        self.rule = rule
        self.state = INACTIVE
        self.since: Optional[float] = None
        self.pending_since: Optional[float] = None
        self.fired_at: Optional[float] = None
        self.resolved_at: Optional[float] = None
        self.value: Optional[float] = None
        self.context: Dict = {}
        self.fire_count = 0

    def to_dict(self) -> Dict:
        r = self.rule
        return {
            "rule": r.name, "kind": r.kind, "metric": r.metric,
            "severity": r.severity, "state": self.state,
            "value": self.value, "threshold": r.threshold,
            "for_s": r.for_s, "window_s": r.window_s,
            "since": self.since, "fired_at": self.fired_at,
            "resolved_at": self.resolved_at, "fire_count": self.fire_count,
            "description": r.description, "context": dict(self.context),
        }


class AlertEngine:
    """Evaluate a rule pack over a history on demand or on a cadence
    (module docstring). ``tracker`` is anything with ``put_kv`` (the
    in-memory tracker, the embedded server handle, or a
    StateTrackerClient) — None disables publishing; ``log_path`` appends
    every transition as a JSONL line (line-buffered, the write-ahead
    posture) for ``tools/alert_report.py``."""

    def __init__(self, history, rules: Optional[Sequence[AlertRule]] = None,
                 registry=None, tracker=None, process: str = "proc",
                 interval_s: float = 1.0, log_path: Optional[str] = None):
        if registry is None:
            from deeplearning4j_tpu_torch.telemetry.registry import default_registry

            registry = default_registry()
        self.history = history
        self.registry = registry
        self.tracker = tracker
        self.process = str(process)
        self.interval_s = float(interval_s)
        self.rules: List[AlertRule] = list(
            rules if rules is not None else default_rules())
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {sorted(names)}")
        self._fh = None
        if log_path is not None:
            parent = os.path.dirname(os.path.abspath(log_path))
            os.makedirs(parent, exist_ok=True)
            # opened here, never under the lock (blocking-under-lock)
            self._fh = open(log_path, "a", buffering=1)
        self.log_path = log_path
        self._lock = threading.Lock()
        self._states: Dict[str, _RuleState] = {
            r.name: _RuleState(r) for r in self.rules}
        self._seq = 0
        self._publish_fail_streak = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.registry.gauge("alerts_rules").set(float(len(self.rules)))
        for r in self.rules:
            # the firing gauge exists (at 0) from engine construction, so
            # the cluster view / report can tell "quiet" from "unwatched"
            self.registry.gauge("alerts_firing",
                               {"rule": r.name,
                                "severity": r.severity}).set(0.0)
            # pre-arm the watched instruments (get-or-create at zero):
            # a counter born AFTER the first history sample would hide
            # its birth increment from every rate window — creating the
            # baseline at engine construction makes "the subsystem's
            # first event ever" alertable. Labeled rules skip this
            # (their series appear per label set, e.g. per worker).
            if r.labels is None:
                if r.kind == "burn_rate":
                    self.registry.histogram(r.metric)
                elif r.kind == "threshold" or (r.kind == "rate"
                                               and r.use_delta):
                    # EXCEPT where the pre-armed default (0.0) would
                    # itself satisfy the rule (op "<" on a ratio gauge,
                    # e.g. serve_prefix_cache_hit_rate): creating the
                    # instrument would turn "subsystem never ran" into
                    # a page — those gauges stay unborn until their
                    # subsystem emits a real value, and no-data stays
                    # inactive.
                    if not (r.kind == "threshold"
                            and _OPS[r.op](0.0, r.threshold)):
                        self.registry.gauge(r.metric)
                elif r.kind == "rate":
                    self.registry.counter(r.metric)

    # ---------------------------------------------------------- evaluation ----
    def evaluate_once(self, now: Optional[float] = None,
                      publish: bool = True) -> List[Dict]:
        """One pass over every rule: evaluate conditions, advance the
        state machines, run firing/resolve side effects, publish the
        snapshot to the tracker KV. Returns the state dicts."""
        now = time.time() if now is None else float(now)
        transitions: List[Dict] = []
        with self._lock:
            for st in self._states.values():
                active, value, ctx = _evaluate_condition(
                    st.rule, self.history, now)
                st.value = value
                st.context = ctx
                prev = st.state
                if active:
                    if st.state in (INACTIVE, RESOLVED):
                        st.pending_since = now
                        st.state = PENDING
                        st.since = now
                    if (st.state == PENDING
                            and now - st.pending_since >= st.rule.for_s):
                        st.state = FIRING
                        st.since = now
                        st.fired_at = now
                        st.fire_count += 1
                else:
                    if st.state == PENDING:
                        st.state = INACTIVE
                        st.since = now
                    elif st.state == FIRING:
                        st.state = RESOLVED
                        st.since = now
                        st.resolved_at = now
                if st.state != prev:
                    transitions.append({"ts": now, "rule": st.rule.name,
                                        "from": prev, "to": st.state,
                                        "value": value,
                                        "severity": st.rule.severity,
                                        "context": dict(ctx)})
            states = [st.to_dict() for st in self._states.values()]
        self.registry.counter("alerts_evaluations_total").inc()
        for tr in transitions:
            self._on_transition(tr)
        if publish:
            self.publish(states, now=now)  # no-op without a tracker
        return states

    def _on_transition(self, tr: Dict) -> None:
        rule = tr["rule"]
        sev = tr["severity"]
        self.registry.counter("alerts_transitions_total",
                              {"rule": rule, "to": tr["to"]}).inc()
        if tr["to"] == FIRING:
            self.registry.gauge("alerts_firing",
                               {"rule": rule, "severity": sev}).set(1.0)
            # forensics: the flight recorder snapshot AT the firing
            # moment (open spans, counters, device memory) — never
            # rate-limited, reason names the rule
            from deeplearning4j_tpu_torch.telemetry import trace as _trace

            tracer = _trace.get_tracer()
            if tracer is not None:
                tracer.dump(f"alert:{rule}", extra={
                    "rule": rule, "severity": sev, "value": tr["value"],
                    "context": tr["context"], "process": self.process})
        elif tr["from"] == FIRING:
            self.registry.gauge("alerts_firing",
                               {"rule": rule, "severity": sev}).set(0.0)
        with self._lock:
            fh = self._fh
        if fh is not None:
            try:
                fh.write(json.dumps({"schema": SCHEMA, **tr}) + "\n")
            except (OSError, ValueError):
                pass

    # ------------------------------------------------------------- surface ----
    def states(self, now: Optional[float] = None) -> List[Dict]:
        """Current state dicts (NO evaluation — the /api/alerts read
        path; histogram-backed rules get their offending exemplar trace
        ids attached here, read fresh from the live registry)."""
        with self._lock:
            out = [st.to_dict() for st in self._states.values()]
        for d in out:
            rule = self._rule(d["rule"])
            if rule is not None and rule.kind == "burn_rate":
                d["exemplars"] = self.offending_exemplars(rule)
        return out

    def _rule(self, name: str) -> Optional[AlertRule]:
        for r in self.rules:
            if r.name == name:
                return r
        return None

    def offending_exemplars(self, rule: AlertRule) -> List[Dict]:
        """Exemplars above the rule's SLO bound from every live registry
        histogram matching the rule's metric — the trace ids of recent
        requests that actually blew the objective (metrics→trace
        correlation; resolved to spans by tools/trace_report.find_trace)."""
        if rule.slo_ms is None:
            return []
        out: List[Dict] = []
        snap = self.registry.snapshot()
        for row in snap.get("histograms", []):
            if row["name"] != rule.metric:
                continue
            if rule.labels is not None and any(
                    row["labels"].get(k) != v
                    for k, v in rule.labels.items()):
                continue
            for ex in row.get("exemplars", []):
                if ex["value"] > float(rule.slo_ms):
                    out.append(dict(ex, labels=dict(row["labels"])))
        out.sort(key=lambda e: e["ts"], reverse=True)
        return out

    def firing(self) -> List[Dict]:
        return [d for d in self.states() if d["state"] == FIRING]

    # -------------------------------------------------------------- publish ----
    def payload(self, states: Optional[List[Dict]] = None,
                now: Optional[float] = None) -> Dict[str, Any]:
        with self._lock:
            seq = self._seq
            self._seq += 1
        return {"schema": SCHEMA, "process": self.process,
                "pid": os.getpid(),
                "ts": time.time() if now is None else float(now),
                "seq": seq,
                "alerts": states if states is not None else self.states()}

    def publish(self, states: Optional[List[Dict]] = None,
                now: Optional[float] = None) -> bool:
        """Push the alert snapshot into the tracker KV (last-write-wins
        per process, retry-safe). Absorbed transport faults count
        ``alerts_publish_failures_total`` — a flapping tracker degrades
        cluster visibility, never the watched process."""
        if self.tracker is None:
            return False
        payload = self.payload(states, now=now)
        try:
            self.tracker.put_kv(ALERT_KV_PREFIX + self.process,
                                json.dumps(payload))
        except (ConnectionError, OSError) as exc:
            self.registry.counter("alerts_publish_failures_total").inc()
            self._publish_fail_streak += 1
            if self._publish_fail_streak == 1:
                # once per outage, not once per interval: an unpublished
                # alert stream is a blind fleet and nobody would know
                log.warning("alert publish for %s failing (tracker "
                            "unreachable): %r", self.process, exc)
            return False
        if self._publish_fail_streak:
            log.info("alert publish for %s recovered after %d failure(s)",
                     self.process, self._publish_fail_streak)
            self._publish_fail_streak = 0
        self.registry.counter("alerts_publishes_total").inc()
        return True

    # ------------------------------------------------------------- threading ----
    def start(self) -> None:
        """Evaluate every ``interval_s`` on a background thread."""
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="alert-engine")
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.evaluate_once()

    def stop(self) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
        self._stop.set()
        if thread is not None:
            thread.join(timeout=10)

    def close(self) -> None:
        self.stop()
        # handle swap under the lock (the evaluator thread writes through
        # self._fh in _on_transition), close outside it
        with self._lock:
            fh, self._fh = self._fh, None
        if fh is not None:
            fh.close()

    def metrics_record(self) -> Dict[str, float]:
        """The engine's own ``alerts_*`` health metrics as a flat
        step-log record (the serve/federation/lockwatch contract)."""
        from deeplearning4j_tpu_torch.telemetry.registry import flat_record

        return flat_record(self.registry, prefixes=("alerts_",))


# ------------------------------------------------------- default rule pack ----

def _serve_slo_ms() -> float:
    raw = os.environ.get(_ENV_SERVE_SLO)
    try:
        return float(raw) if raw else 250.0
    except ValueError:
        return 250.0


def default_rules() -> List[AlertRule]:
    """The rule pack wired to this repo's live paths (every metric below
    is emitted by shipping code; the tests/test_alerts.py meta-test pins
    a firing + non-firing fixture for EVERY rule here):

    - ``nonfinite_step_rate`` — guardrails: the in-graph guard is
      skipping non-finite steps (``guard_skipped_steps_total`` moves).
    - ``worker_divergence`` — elastic quarantine: the master
      excluded a worker whose contribution carried NaN/Inf.
    - ``worker_heartbeat_stale`` — elastic membership: a worker's
      ``elastic_worker_heartbeat_unix{worker=…}`` timestamp lapsed
      (buried workers retire their series to a non-positive sentinel).
    - ``tracker_reconnect_storm`` — transport: the control plane
      is reconnecting faster than occasional blips explain.
    - ``serve_queue_growth`` — serving: sustained queue-depth
      growth means offered load exceeds decode capacity.
    - ``serve_latency_slo_burn`` — serving SLO: the p-latency objective
      (``slo_target`` of requests within ``slo_ms``) is burning budget
      at ≥ 2x the sustainable pace over the window.
    - ``lockwatch_contention_spike`` — host concurrency: watched
      locks are contending far above the ambient rate.
    - ``cluster_stale_process`` — federation: an aggregator sees
      a pusher whose snapshots lapsed (the cluster-level heartbeat).
    - ``serve_cache_hit_rate_low`` — serving fast path: the
      prefix page cache is enabled but barely hitting — either traffic
      shares no prefixes (turn it off) or capacity is churning hot
      chains out. The gauge is born on the first lookup, so an engine
      without the cache (or without traffic) stays inactive.
    - ``serve_spec_accept_collapse`` — serving fast path:
      the draft LM's proposals stopped matching the flagship —
      speculation is burning k draft steps per verify for ~nothing
      (stale draft after a weight swap, or a draft too weak for the
      traffic). The gauge is born after the engine's warmup floor of
      verify steps, so startup noise can't page.
    - ``step_time_regression`` — runtime profiler:
      rate-of-change on the measured step-time gauge
      (``runprof_step_ms``, signed delta/s) — sustained growth means
      creeping retraces, a straggler, or thermal throttling. Sized so
      a gauge BIRTH (0 → one real step time) cannot fire: the birth
      jump leaves the delta window after ``window_s`` seconds, and
      ``for_s > window_s`` means only growth that OUTLASTS the window
      — i.e. step time still climbing — pages.
    - ``mfu_collapse`` — runtime profiler: measured MFU
      (xprofile FLOPs / fenced device seconds) collapsed below 1%
      sustained. Op ``<``, so the gauge stays UNBORN until a profiled
      runprof step emits a real value (the pre-arm trap below) — a
      process that never measures MFU stays inactive.
    - ``input_wait_high`` — runtime profiler: the
      input-wait hook reports the step spending >30% of its cycle
      starved for host data — the input-starvation signal.
    - ``fleet_replica_down`` — serving fleet: a fleet
      replica's ``fleet_replica_heartbeat_unix{replica=…}`` timestamp
      lapsed on the router — the replica died or wedged. Buried
      replicas retire their series to the -1.0 sentinel (the death was
      handled: in-flight work requeued, cold start dispatched), so
      only UNHANDLED staleness pages.
    - ``fleet_queue_imbalance`` — serving fleet: the
      max/mean replica queue-depth ratio the router publishes shows
      one replica hoarding load — session affinity gone pathological
      or a replica decoding far below fleet speed. Gauge is born on
      the first membership sweep with a nonzero mean depth.
    - ``tune_cache_stale`` — autotuner: a cache lookup saw
      entries stored under a knob-space version other than the live
      ``tune.space`` version — those winners silently resolve to the
      DEFAULT config until re-searched, so the speedup they promised
      is gone. The ``tune_cache_stale_entries`` gauge is born on the
      first lookup; 0 while every entry is current.
    """
    return [
        AlertRule(
            name="nonfinite_step_rate", kind="rate",
            metric="guard_skipped_steps_total", threshold=0.0, op=">",
            window_s=60.0, for_s=0.0, severity="critical",
            description="guardrails are skipping non-finite steps "
                        "(NaN/Inf loss or grads)"),
        AlertRule(
            name="worker_divergence", kind="rate",
            metric="elastic_workers_quarantined_total", threshold=0.0,
            op=">", window_s=120.0, for_s=0.0, severity="critical",
            description="the elastic master quarantined a worker whose "
                        "contribution carried non-finite params"),
        AlertRule(
            name="worker_heartbeat_stale", kind="absence",
            metric="elastic_worker_heartbeat_unix", stale_s=10.0,
            for_s=0.0, severity="warning",
            description="a live elastic worker's heartbeat timestamp "
                        "stopped advancing"),
        AlertRule(
            name="tracker_reconnect_storm", kind="rate",
            metric="tracker_reconnects_total", threshold=0.5, op=">",
            window_s=30.0, for_s=5.0, severity="warning",
            description="the tracker client is reconnecting >0.5/s "
                        "sustained — flapping control plane"),
        AlertRule(
            name="serve_queue_growth", kind="rate", use_delta=True,
            metric="serve_queue_depth", threshold=0.5, op=">",
            window_s=30.0, for_s=5.0, severity="warning",
            description="serve queue depth growing >0.5 requests/s "
                        "sustained — offered load exceeds capacity"),
        AlertRule(
            name="serve_latency_slo_burn", kind="burn_rate",
            metric="serve_request_ms", slo_ms=_serve_slo_ms(),
            slo_target=0.99, threshold=2.0, window_s=60.0, for_s=0.0,
            severity="critical",
            description="serve request latency is burning the "
                        "99%-within-SLO error budget at >2x the "
                        "sustainable pace"),
        AlertRule(
            name="lockwatch_contention_spike", kind="rate",
            metric="lockwatch_contended_total", threshold=50.0, op=">",
            window_s=30.0, for_s=5.0, severity="warning",
            description="watched control-plane locks contending >50/s "
                        "sustained"),
        AlertRule(
            name="cluster_stale_process", kind="threshold",
            metric="federation_stale_processes", threshold=0.0, op=">",
            for_s=0.0, severity="warning",
            description="a federated process's metric pushes lapsed "
                        "(cluster-level heartbeat)"),
        AlertRule(
            name="serve_cache_hit_rate_low", kind="threshold",
            metric="serve_prefix_cache_hit_rate", threshold=0.1,
            op="<", for_s=60.0, severity="warning",
            description="the serve prefix page cache is hitting on "
                        "<10% of lookups sustained — no prefix "
                        "sharing in traffic, or hot chains are being "
                        "evicted"),
        AlertRule(
            name="serve_spec_accept_collapse", kind="threshold",
            metric="serve_spec_accept_rate", threshold=0.1,
            op="<", for_s=60.0, severity="warning",
            description="speculative-decode draft acceptance "
                        "collapsed below 10% — draft proposals no "
                        "longer track the flagship, verify dispatches "
                        "are wasted"),
        AlertRule(
            name="step_time_regression", kind="rate", use_delta=True,
            metric="runprof_step_ms", threshold=5.0, op=">",
            window_s=30.0, for_s=45.0, severity="warning",
            description="measured step time growing >5 ms/s sustained "
                        "past the delta window — creeping retraces, a "
                        "straggler, or throttling (a one-off jump "
                        "resolves when it leaves the window)"),
        AlertRule(
            name="mfu_collapse", kind="threshold",
            metric="runprof_measured_mfu", threshold=0.01,
            op="<", for_s=120.0, severity="warning",
            description="measured MFU (xprofile FLOPs / fenced device "
                        "seconds) below 1% sustained — the step is "
                        "running but the accelerator is idle"),
        AlertRule(
            name="input_wait_high", kind="threshold",
            metric="runprof_input_wait_fraction", threshold=0.3,
            op=">", for_s=60.0, severity="warning",
            description="steps spend >30% of their cycle waiting on "
                        "host input — the data pipeline is starving "
                        "the device"),
        AlertRule(
            name="fleet_replica_down", kind="absence",
            metric="fleet_replica_heartbeat_unix", stale_s=5.0,
            for_s=0.0, severity="critical",
            description="a fleet replica's heartbeat stopped advancing "
                        "and the router has not yet buried it — "
                        "requests routed there are stalling"),
        AlertRule(
            name="fleet_queue_imbalance", kind="threshold",
            metric="fleet_queue_imbalance_ratio", threshold=3.0,
            op=">", for_s=10.0, severity="warning",
            description="max/mean fleet replica queue depth above 3x "
                        "sustained — routing is piling work onto one "
                        "replica"),
        AlertRule(
            name="tune_cache_stale", kind="threshold",
            metric="tune_cache_stale_entries", threshold=0.0, op=">",
            for_s=0.0, severity="warning",
            description="tuning-cache entries were searched under a "
                        "different knob-space version than the live "
                        "one (tune/space.py) — those winners resolve "
                        "to defaults until re-tuned (run python -m "
                        "deeplearning4j_tpu.tune --store)"),
    ]


# ------------------------------------------------------------- watchtower ----

class Watchtower:
    """History sampler + alert engine as one arm/disarm unit — the shape
    the elastic master (``ElasticMaster(watch=True)``), the worker CLI
    (``--watch-dir``), and the bench twin all use."""

    def __init__(self, history, engine: AlertEngine,
                 owned_tracker=None):
        self.history = history
        self.engine = engine
        self._owned_tracker = owned_tracker

    def start(self) -> None:
        self.history.start()
        self.engine.start()

    def tick(self) -> List[Dict]:
        """One synchronous sample + evaluate + publish — the
        deterministic unit tests and shutdown flushes call."""
        self.history.sample_once()
        return self.engine.evaluate_once()

    def stop(self) -> None:
        self.engine.close()
        self.history.close()
        if self._owned_tracker is not None:
            try:
                self._owned_tracker.close()
            except (ConnectionError, OSError):
                pass
            self._owned_tracker = None

    def __enter__(self) -> "Watchtower":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def arm_watchtower(registry=None, tracker=None,
                   tracker_address: Optional[str] = None,
                   process: str = "proc",
                   rules: Optional[Sequence[AlertRule]] = None,
                   out_dir: Optional[str] = None,
                   interval_s: Optional[float] = None,
                   start: bool = True) -> Watchtower:
    """Build + start a watchtower over ``registry``: a history sampler,
    an engine on ``rules`` (default pack when None), spill + alert logs
    under ``out_dir`` (``history_<process>.jsonl`` /
    ``alerts_<process>.jsonl`` — what tools/alert_report.py reads), and
    publishing through ``tracker`` (or a fresh StateTrackerClient to
    ``tracker_address`` — its own connection, so alert pushes never ride
    or stall a training loop's RPC slot)."""
    from deeplearning4j_tpu_torch.telemetry.history import (
        _ENV_INTERVAL as _ENV_HIST_INTERVAL,
        DEFAULT_INTERVAL_S,
        MetricsHistory,
        _env_float,
    )

    if interval_s is None:
        interval_s = _env_float(
            _ENV_INTERVAL, _env_float(_ENV_HIST_INTERVAL,
                                      DEFAULT_INTERVAL_S))
    owned = None
    if tracker is None and tracker_address is not None:
        from deeplearning4j_tpu_torch.scaleout.remote_tracker import (
            StateTrackerClient,
        )

        tracker = owned = StateTrackerClient(tracker_address)
    safe = "".join(c if (c.isalnum() or c in "-_.") else "_"
                   for c in str(process))
    spill = (os.path.join(out_dir, f"history_{safe}.jsonl")
             if out_dir else None)
    alog = (os.path.join(out_dir, f"alerts_{safe}.jsonl")
            if out_dir else None)
    history = MetricsHistory(registry=registry, interval_s=interval_s,
                             spill_path=spill)
    engine = AlertEngine(history, rules=rules, registry=registry,
                         tracker=tracker, process=process,
                         interval_s=interval_s, log_path=alog)
    tower = Watchtower(history, engine, owned_tracker=owned)
    if start:
        tower.start()
    return tower


# ------------------------------------------------ process-global engine ----

_engine: Optional[AlertEngine] = None
_engine_lock = threading.Lock()


def get_engine() -> Optional[AlertEngine]:
    return _engine


def set_engine(engine: Optional[AlertEngine]) -> Optional[AlertEngine]:
    """Install (or clear) the process alert engine; returns the previous
    one so tests can restore it (the UiServer /api/alerts fallback)."""
    global _engine
    with _engine_lock:
        prev, _engine = _engine, engine
    return prev
