"""The port's alert engine (deeplearning4j_tpu_torch/telemetry/alerts.py)
and its wiring held against the JAX package's: tests/test_alerts.py
through the port. In order:

- the rule-pack fixtures and the meta-test: EVERY rule of
  ``default_rules()`` fires on one fixture and stays quiet on another
  (the pack equals JAX's, field for field);
- the hysteresis state machine (inactive → pending → firing → resolved);
- the firing side effects: ``alerts_firing``/``alerts_transitions_total``,
  the ``alert:<rule>`` flight dump, the tracker-KV publish (read by JAX's
  aggregator too) and the transitions JSONL;
- the cluster view over the port's real TCP tracker;
- trace exemplars, the serve-latency ones resolving to real port spans;
- thread lifecycle at a stable thread count, and ``tools/alert_report.py``
  on the port's ``history_*.jsonl`` and ``alerts_*.jsonl``;
- the end-to-end pin: a ``nan_at_step``-poisoned port elastic worker is
  quarantined, the master watchtower's ``worker_divergence`` fires, and
  ``ClusterAggregator.collect_alerts()`` shows it over the TCP tracker.

JAX's ``TestAlertUi`` (``/api/alerts``, ``/api/history``) waits for the
UI routes, ROADMAP item 21c.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import json
import subprocess
import sys
import threading
import time

import pytest

from deeplearning4j_tpu_torch.scaleout.statetracker import InMemoryStateTracker
from deeplearning4j_tpu_torch.telemetry import trace as trace_mod
from deeplearning4j_tpu_torch.telemetry.alerts import (
    ALERT_KV_PREFIX,
    SCHEMA,
    AlertEngine,
    AlertRule,
    Watchtower,
    arm_watchtower,
    default_rules,
    get_engine,
    set_engine,
)
from deeplearning4j_tpu_torch.telemetry.federation import ClusterAggregator
from deeplearning4j_tpu_torch.telemetry.history import MetricsHistory
from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_000_000.0


def _hist():
    reg = MetricsRegistry()
    return MetricsHistory(registry=reg), reg


def _two_sample_counter(name, v0, v1, dt=10.0):
    """History with a counter moving v0 → v1 across two samples."""
    h, reg = _hist()
    c = reg.counter(name)
    c.inc(v0)
    h.sample_once(now=T0)
    c.inc(v1 - v0)
    h.sample_once(now=T0 + dt)
    return h, T0 + dt


def _two_sample_gauge(name, v0, v1, dt=10.0):
    h, reg = _hist()
    g = reg.gauge(name)
    g.set(v0)
    h.sample_once(now=T0)
    g.set(v1)
    h.sample_once(now=T0 + dt)
    return h, T0 + dt


def _latency_history(values):
    h, reg = _hist()
    reg.histogram("serve_request_ms")  # born before the first sample
    h.sample_once(now=T0)
    for v in values:
        reg.histogram("serve_request_ms").observe(v)
    h.sample_once(now=T0 + 10.0)
    return h, T0 + 10.0


def _heartbeat_history(age_s):
    h, reg = _hist()
    reg.gauge("elastic_worker_heartbeat_unix",
              {"worker": "w1"}).set(T0 - age_s)
    h.sample_once(now=T0)
    return h, T0


def _fleet_heartbeat_history(age_s):
    h, reg = _hist()
    reg.gauge("fleet_replica_heartbeat_unix",
              {"replica": "r1"}).set(T0 - age_s)
    h.sample_once(now=T0)
    return h, T0


def _climbing_gauge(name, slope_per_s, until_s=60.0, dt=5.0):
    """History with a gauge climbing ``slope_per_s`` from T0 to
    T0+until_s, sampled every ``dt``; now = T0+10. Samples extend PAST
    the returned now because step_time_regression's ``for_s`` (45)
    outlasts its delta window (30) — ``_drive``'s second evaluation at
    now+for_s reads a window the growth must still be filling (exactly
    the sustained-growth shape the rule is sized for)."""
    h, reg = _hist()
    g = reg.gauge(name)
    t = 0.0
    while t <= until_s:
        g.set(slope_per_s * t)
        h.sample_once(now=T0 + t)
        t += dt
    return h, T0 + 10.0


# Every default rule's (firing, non-firing) history builders, each
# returning (history, now). The meta-test below pins this dict against
# the live pack, so a new rule cannot ship without both fixtures.
RULE_FIXTURES = {
    "nonfinite_step_rate": (
        lambda: _two_sample_counter("guard_skipped_steps_total", 0, 3),
        lambda: _two_sample_counter("guard_skipped_steps_total", 0, 0),
    ),
    "worker_divergence": (
        lambda: _two_sample_counter("elastic_workers_quarantined_total",
                                    0, 1),
        lambda: _two_sample_counter("elastic_workers_quarantined_total",
                                    0, 0),
    ),
    "worker_heartbeat_stale": (
        lambda: _heartbeat_history(30.0),
        lambda: _heartbeat_history(1.0),
    ),
    "tracker_reconnect_storm": (
        lambda: _two_sample_counter("tracker_reconnects_total", 0, 30),
        lambda: _two_sample_counter("tracker_reconnects_total", 0, 1,
                                    dt=30.0),
    ),
    "serve_queue_growth": (
        lambda: _two_sample_gauge("serve_queue_depth", 0, 30),
        lambda: _two_sample_gauge("serve_queue_depth", 5, 5),
    ),
    "serve_latency_slo_burn": (
        lambda: _latency_history([900.0] * 10),
        lambda: _latency_history([10.0] * 100),
    ),
    "lockwatch_contention_spike": (
        lambda: _two_sample_counter("lockwatch_contended_total", 0, 2000),
        lambda: _two_sample_counter("lockwatch_contended_total", 0, 10),
    ),
    "cluster_stale_process": (
        lambda: _two_sample_gauge("federation_stale_processes", 1, 1),
        lambda: _two_sample_gauge("federation_stale_processes", 0, 0),
    ),
    "serve_cache_hit_rate_low": (
        lambda: _two_sample_gauge("serve_prefix_cache_hit_rate",
                                  0.02, 0.02),
        lambda: _two_sample_gauge("serve_prefix_cache_hit_rate",
                                  0.8, 0.8),
    ),
    "serve_spec_accept_collapse": (
        lambda: _two_sample_gauge("serve_spec_accept_rate", 0.01, 0.01),
        lambda: _two_sample_gauge("serve_spec_accept_rate", 0.6, 0.6),
    ),
    # the runtime profiler's rules. step_time_regression fires only on growth
    # that outlasts its 30s delta window (20 ms/s sustained for 60s);
    # quiet = a flat measured step time. The threshold gauges fire on a
    # collapsed MFU / high input-wait fraction, quiet on healthy values.
    "step_time_regression": (
        lambda: _climbing_gauge("runprof_step_ms", 20.0),
        lambda: _two_sample_gauge("runprof_step_ms", 120.0, 120.0),
    ),
    "mfu_collapse": (
        lambda: _two_sample_gauge("runprof_measured_mfu", 0.001, 0.001),
        lambda: _two_sample_gauge("runprof_measured_mfu", 0.3, 0.3),
    ),
    "input_wait_high": (
        lambda: _two_sample_gauge("runprof_input_wait_fraction",
                                  0.6, 0.6),
        lambda: _two_sample_gauge("runprof_input_wait_fraction",
                                  0.05, 0.05),
    ),
    # the fleet's rules: a replica heartbeat gauge 30s stale fires
    # the absence rule (1s fresh stays quiet); a router-published
    # max/mean queue-depth ratio of 8 fires imbalance (balanced ~1 is
    # quiet).
    "fleet_replica_down": (
        lambda: _fleet_heartbeat_history(30.0),
        lambda: _fleet_heartbeat_history(1.0),
    ),
    "fleet_queue_imbalance": (
        lambda: _two_sample_gauge("fleet_queue_imbalance_ratio",
                                  8.0, 8.0),
        lambda: _two_sample_gauge("fleet_queue_imbalance_ratio",
                                  1.0, 1.0),
    ),
    # the autotuner: a tuning-cache lookup counted entries searched under a
    # stale knob-space version (they resolve to defaults — the tuned
    # speedup is silently gone). 0 stale entries stays quiet.
    "tune_cache_stale": (
        lambda: _two_sample_gauge("tune_cache_stale_entries", 1.0, 1.0),
        lambda: _two_sample_gauge("tune_cache_stale_entries", 0.0, 0.0),
    ),
}


def _drive(rule: AlertRule, history, now: float) -> str:
    """Evaluate through the hysteresis window; the state after for_s."""
    eng = AlertEngine(history, rules=[rule], registry=MetricsRegistry())
    eng.evaluate_once(now=now, publish=False)
    states = eng.evaluate_once(now=now + rule.for_s + 0.001,
                               publish=False)
    return states[0]["state"]


class TestDefaultRulePack:
    def test_meta_every_default_rule_has_fixtures(self):
        """The rule-fixture discipline: the fixture dict covers the
        live pack EXACTLY (an unpinned new rule, or a stale fixture for a
        removed rule, both fail here)."""
        assert set(RULE_FIXTURES) == {r.name for r in default_rules()}
        for name, fx in RULE_FIXTURES.items():
            assert len(fx) == 2, f"{name} needs (firing, quiet) fixtures"

    @pytest.mark.parametrize("rule", default_rules(),
                             ids=lambda r: r.name)
    def test_firing_fixture_fires(self, rule):
        history, now = RULE_FIXTURES[rule.name][0]()
        assert _drive(rule, history, now) == "firing"

    @pytest.mark.parametrize("rule", default_rules(),
                             ids=lambda r: r.name)
    def test_quiet_fixture_stays_quiet(self, rule):
        history, now = RULE_FIXTURES[rule.name][1]()
        assert _drive(rule, history, now) in ("inactive", "pending")
        # and specifically never fired
        eng = AlertEngine(history, rules=[rule],
                          registry=MetricsRegistry())
        states = eng.evaluate_once(now=now + rule.for_s + 1.0,
                                   publish=False)
        assert states[0]["fire_count"] == 0

    def test_buried_worker_sentinel_not_stale(self):
        """A buried/quarantined worker's heartbeat series is retired to a
        non-positive sentinel — already handled, must NOT keep firing."""
        h, reg = _hist()
        reg.gauge("elastic_worker_heartbeat_unix",
                  {"worker": "w1"}).set(-1.0)
        h.sample_once(now=T0)
        rule = [r for r in default_rules()
                if r.name == "worker_heartbeat_stale"][0]
        assert _drive(rule, h, T0) == "inactive"

    def test_buried_fleet_replica_sentinel_not_stale(self):
        """Same sentinel discipline for the fleet: burying a replica
        retires its heartbeat series to -1.0 (death handled — work
        requeued, cold start dispatched), so fleet_replica_down stops
        firing."""
        h, reg = _hist()
        reg.gauge("fleet_replica_heartbeat_unix",
                  {"replica": "r1"}).set(-1.0)
        h.sample_once(now=T0)
        rule = [r for r in default_rules()
                if r.name == "fleet_replica_down"][0]
        assert _drive(rule, h, T0) == "inactive"

    def test_no_data_never_fires(self):
        """A rule over a metric its subsystem never produced stays
        inactive — arming the pack on a process without serve/elastic
        must not page anyone."""
        h, _ = _hist()
        h.sample_once(now=T0)
        eng = AlertEngine(h, registry=MetricsRegistry())
        for st in eng.evaluate_once(now=T0, publish=False):
            assert st["state"] == "inactive", st

    def test_low_op_rules_not_prearmed_into_firing(self):
        """The pre-arm trap the ratio rules must dodge: with
        engine and history SHARING one registry (the arm_watchtower
        wiring), pre-arming a "<"-op gauge at 0.0 would make every idle
        process page hit-rate-low/accept-collapse. Those gauges must
        stay unborn until their subsystem emits, and the rules
        inactive."""
        reg = MetricsRegistry()
        h = MetricsHistory(registry=reg)
        eng = AlertEngine(h, registry=reg)
        h.sample_once(now=T0)
        eng.evaluate_once(now=T0, publish=False)
        h.sample_once(now=T0 + 120.0)
        for st in eng.evaluate_once(now=T0 + 120.0, publish=False):
            if st["rule"] in ("serve_cache_hit_rate_low",
                              "serve_spec_accept_collapse",
                              "mfu_collapse"):
                assert st["state"] == "inactive", st

    def test_step_time_one_off_jump_never_fires(self):
        """The birth/step-change shape step_time_regression is sized
        against (for_s > window_s): a single jump — a gauge born at a
        real value, or one slow step — satisfies the delta rule only
        while the jump is inside the 30s window; the 45s hysteresis
        outlasts it, so only SUSTAINED growth pages."""
        h, reg = _hist()
        g = reg.gauge("runprof_step_ms")
        g.set(20.0)
        h.sample_once(now=T0)
        g.set(220.0)  # one-off jump, then flat
        for t in range(10, 121, 10):
            h.sample_once(now=T0 + t)
        rule = [r for r in default_rules()
                if r.name == "step_time_regression"][0]
        assert _drive(rule, h, T0 + 10.0) in ("inactive", "pending")
        eng = AlertEngine(h, rules=[rule], registry=MetricsRegistry())
        for t in (10.0, 30.0, 60.0, 90.0, 120.0):
            states = eng.evaluate_once(now=T0 + t, publish=False)
        assert states[0]["fire_count"] == 0


class TestRuleValidation:
    def test_unknown_kind_rejected(self):
        with pytest.raises(ValueError, match="kind"):
            AlertRule(name="x", kind="vibes", metric="m")

    def test_burn_rate_requires_slo(self):
        with pytest.raises(ValueError, match="slo_ms"):
            AlertRule(name="x", kind="burn_rate", metric="m")

    def test_duplicate_rule_names_rejected(self):
        h, _ = _hist()
        r = AlertRule(name="dup", kind="threshold", metric="m")
        with pytest.raises(ValueError, match="duplicate"):
            AlertEngine(h, rules=[r, r], registry=MetricsRegistry())


class TestHysteresis:
    def _rule(self, for_s=5.0):
        return AlertRule(name="r", kind="threshold", metric="g",
                         threshold=1.0, op=">", for_s=for_s,
                         severity="warning")

    def _engine(self, for_s=5.0):
        reg = MetricsRegistry()
        h = MetricsHistory(registry=reg)
        eng = AlertEngine(h, rules=[self._rule(for_s)],
                          registry=MetricsRegistry())
        return reg, h, eng

    def _set(self, reg, h, value, now):
        reg.gauge("g").set(value)
        h.sample_once(now=now)

    def test_pending_then_firing_then_resolved(self):
        reg, h, eng = self._engine(for_s=5.0)
        self._set(reg, h, 9.0, T0)
        assert eng.evaluate_once(now=T0, publish=False)[0]["state"] \
            == "pending"
        # still true but inside for_s: stays pending
        assert eng.evaluate_once(now=T0 + 3, publish=False)[0]["state"] \
            == "pending"
        st = eng.evaluate_once(now=T0 + 5.1, publish=False)[0]
        assert st["state"] == "firing" and st["fire_count"] == 1
        # condition clears → resolved (visible, with resolved_at)
        self._set(reg, h, 0.0, T0 + 6)
        st = eng.evaluate_once(now=T0 + 6, publish=False)[0]
        assert st["state"] == "resolved"
        assert st["resolved_at"] == T0 + 6

    def test_blip_never_fires(self):
        reg, h, eng = self._engine(for_s=5.0)
        self._set(reg, h, 9.0, T0)
        eng.evaluate_once(now=T0, publish=False)
        self._set(reg, h, 0.0, T0 + 1)
        st = eng.evaluate_once(now=T0 + 1, publish=False)[0]
        assert st["state"] == "inactive" and st["fire_count"] == 0

    def test_refire_after_resolved_goes_through_pending(self):
        reg, h, eng = self._engine(for_s=5.0)
        self._set(reg, h, 9.0, T0)
        eng.evaluate_once(now=T0, publish=False)
        eng.evaluate_once(now=T0 + 5.1, publish=False)
        self._set(reg, h, 0.0, T0 + 6)
        eng.evaluate_once(now=T0 + 6, publish=False)
        self._set(reg, h, 9.0, T0 + 7)
        st = eng.evaluate_once(now=T0 + 7, publish=False)[0]
        assert st["state"] == "pending"
        st = eng.evaluate_once(now=T0 + 12.1, publish=False)[0]
        assert st["state"] == "firing" and st["fire_count"] == 2

    def test_for_s_zero_fires_immediately(self):
        reg, h, eng = self._engine(for_s=0.0)
        self._set(reg, h, 9.0, T0)
        assert eng.evaluate_once(now=T0, publish=False)[0]["state"] \
            == "firing"


class TestFiringSideEffects:
    def _firing_setup(self, tmp_path, tracker=None):
        h, now = RULE_FIXTURES["nonfinite_step_rate"][0]()
        reg = MetricsRegistry()
        eng = AlertEngine(
            h, rules=[r for r in default_rules()
                      if r.name == "nonfinite_step_rate"],
            registry=reg, tracker=tracker, process="p0",
            log_path=str(tmp_path / "alerts_p0.jsonl"))
        return h, now, reg, eng

    def test_registry_bumps_and_transitions_log(self, tmp_path):
        h, now, reg, eng = self._firing_setup(tmp_path)
        labels = {"rule": "nonfinite_step_rate", "severity": "critical"}
        assert reg.gauge("alerts_firing", labels).value == 0.0
        eng.evaluate_once(now=now, publish=False)
        assert reg.gauge("alerts_firing", labels).value == 1.0
        assert reg.counter("alerts_transitions_total",
                           {"rule": "nonfinite_step_rate",
                            "to": "firing"}).value >= 1.0
        rec = eng.metrics_record()
        assert rec["alerts_evaluations_total"] >= 1.0
        assert rec["alerts_rules"] == 1.0
        # resolve drops the gauge back to 0
        h.sample_once(now=now + 120.0)  # the window drains → rate None
        eng.evaluate_once(now=now + 120.0, publish=False)
        assert reg.gauge("alerts_firing", labels).value == 0.0
        eng.close()
        lines = [json.loads(l) for l in
                 open(tmp_path / "alerts_p0.jsonl")]
        # for_s=0: one evaluation takes the rule straight to firing, so
        # the logged transition is inactive -> firing (pending is only a
        # logged state when a hysteresis window is configured)
        assert [(r["from"], r["to"]) for r in lines] == [
            ("inactive", "firing"), ("firing", "resolved")]
        assert all(r["schema"] == SCHEMA for r in lines)

    def test_flight_dump_on_firing(self, tmp_path):
        prev = trace_mod.set_tracer(trace_mod.Tracer(
            "alerts-test", trace_dir=str(tmp_path / "trace"),
            registry=MetricsRegistry()))
        try:
            h, now, reg, eng = self._firing_setup(tmp_path)
            eng.evaluate_once(now=now, publish=False)
        finally:
            trace_mod.set_tracer(prev)
        dump = json.load(open(tmp_path / "trace" /
                              "flightrec_alerts-test.json"))
        assert dump["reason"] == "alert:nonfinite_step_rate"
        assert dump["extra"]["severity"] == "critical"
        assert dump["extra"]["value"] > 0

    def test_publish_to_tracker_kv(self, tmp_path):
        tracker = InMemoryStateTracker()
        h, now, reg, eng = self._firing_setup(tmp_path, tracker=tracker)
        eng.evaluate_once(now=now)
        payload = json.loads(tracker.get_kv(ALERT_KV_PREFIX + "p0"))
        assert payload["schema"] == SCHEMA
        assert payload["process"] == "p0"
        states = {a["rule"]: a["state"] for a in payload["alerts"]}
        assert states["nonfinite_step_rate"] == "firing"
        assert reg.counter("alerts_publishes_total").value >= 1.0

    def test_publish_failure_absorbed(self, tmp_path):
        class DeadTracker:
            def put_kv(self, key, value):
                raise ConnectionError("down")

        h, now, reg, eng = self._firing_setup(tmp_path,
                                              tracker=DeadTracker())
        eng.evaluate_once(now=now)  # must not raise
        assert reg.counter("alerts_publish_failures_total").value >= 1.0


class TestClusterAlertView:
    def test_two_processes_over_real_tcp_tracker(self):
        from deeplearning4j_tpu_torch.scaleout.remote_tracker import (
            StateTrackerClient,
            StateTrackerServer,
        )

        with StateTrackerServer() as server:
            c1 = StateTrackerClient(server.address)
            c2 = StateTrackerClient(server.address)
            h1, now = RULE_FIXTURES["worker_divergence"][0]()
            h2, _ = RULE_FIXTURES["worker_divergence"][1]()
            e1 = AlertEngine(h1, registry=MetricsRegistry(), tracker=c1,
                             process="master")
            e2 = AlertEngine(h2, registry=MetricsRegistry(), tracker=c2,
                             process="worker-1")
            e1.evaluate_once(now=now)
            e2.evaluate_once(now=now)
            agg = ClusterAggregator(server.tracker, stale_after_s=60.0,
                                    registry=MetricsRegistry())
            view = agg.collect_alerts()
            assert view["schema"] == SCHEMA
            assert sorted(p["process"] for p in view["processes"]) == \
                ["master", "worker-1"]
            by = {(a["process"], a["rule"]): a["state"]
                  for a in view["alerts"]}
            assert by[("master", "worker_divergence")] == "firing"
            assert by[("worker-1", "worker_divergence")] == "inactive"
            assert view["firing"] == 1
            # firing rows sort first (the router reads the top)
            assert view["alerts"][0]["state"] == "firing"
            assert agg.registry.gauge(
                "federation_cluster_alerts_firing").value == 1.0
            c1.close(), c2.close()

    def test_bad_payloads_skipped(self):
        tracker = InMemoryStateTracker()
        tracker.put_kv(ALERT_KV_PREFIX + "junk", "{nope")
        tracker.put_kv(ALERT_KV_PREFIX + "wrong",
                       json.dumps({"schema": "v999"}))
        agg = ClusterAggregator(tracker, registry=MetricsRegistry())
        view = agg.collect_alerts()
        assert view["processes"] == [] and view["alerts"] == []
        assert agg.registry.counter(
            "federation_bad_payloads_total").value == 2.0

    def test_stale_publisher_marked(self):
        tracker = InMemoryStateTracker()
        h, now = RULE_FIXTURES["worker_divergence"][0]()
        eng = AlertEngine(h, registry=MetricsRegistry(), tracker=tracker,
                          process="old")
        eng.evaluate_once(now=now)
        agg = ClusterAggregator(tracker, stale_after_s=0.0,
                                registry=MetricsRegistry())
        time.sleep(0.01)
        view = agg.collect_alerts()
        assert view["processes"][0]["stale"] is True
        # stale ≠ dropped: the last-known verdict stays visible
        assert any(a["rule"] == "worker_divergence"
                   and a["state"] == "firing" and a["stale"]
                   for a in view["alerts"])


class TestTraceExemplars:
    def test_histogram_captures_current_span(self, tmp_path):
        reg = MetricsRegistry()
        tracer = trace_mod.Tracer("ex", trace_dir=str(tmp_path),
                                  registry=MetricsRegistry())
        prev = trace_mod.set_tracer(tracer)
        try:
            with tracer.span("op") as sp:
                reg.histogram("h").observe(42.0)
            want = sp.trace_id
        finally:
            trace_mod.set_tracer(prev)
            tracer.close()
        ex = reg.histogram("h").exemplars()
        assert len(ex) == 1 and ex[0]["trace_id"] == want
        assert ex[0]["value"] == 42.0

    def test_no_tracer_no_exemplars_and_snapshot_shape_unchanged(self):
        reg = MetricsRegistry()
        reg.histogram("h").observe(1.0)
        snap = reg.histogram("h").snapshot()
        assert "exemplars" not in snap
        from deeplearning4j_tpu_torch.telemetry.prometheus import (
            render_prometheus,
        )

        assert "#" not in render_prometheus(reg).replace("# TYPE", "")

    def test_prometheus_renders_openmetrics_exemplar(self):
        reg = MetricsRegistry()
        reg.histogram("lat_ms").observe(3.0, exemplar="aa" * 16)
        from deeplearning4j_tpu_torch.telemetry.prometheus import (
            render_prometheus,
        )

        text = render_prometheus(reg)
        line = [l for l in text.splitlines()
                if l.startswith('lat_ms_bucket{le="5"')][0]
        assert f'# {{trace_id="{"aa" * 16}"}} 3' in line

    def test_serve_latency_exemplars_resolve_to_real_spans(self, tmp_path):
        """Trace ids from a firing serve-latency
        rule resolve to real spans through tools/trace_report.py — the
        metrics→trace correlation loop closed end to end on a REAL
        traced engine."""
        from deeplearning4j_tpu_torch.models.transformer_lm import (
            init_lm_params,
        )
        from deeplearning4j_tpu_torch.serve import DecodeEngine
        from tools.trace_report import find_trace, load_trace_dir

        reg = MetricsRegistry()
        trace_dir = str(tmp_path / "trace")
        tracer = trace_mod.Tracer("serve", trace_dir=trace_dir,
                                  registry=MetricsRegistry())
        prev = trace_mod.set_tracer(tracer)
        try:
            params = init_lm_params(torch.Generator().manual_seed(0), 31,
                                    8, 2, 2, 16, n_layers=1, device="cpu")
            eng = DecodeEngine(params, 2, n_slots=2, max_len=64,
                               serve_dtype=None, registry=reg, device="cpu")
            reg.histogram("serve_request_ms")  # baseline precedes sample
            history = MetricsHistory(registry=reg)
            history.sample_once(now=T0)
            for _ in range(3):
                eng.generate([1, 2, 3], max_new_tokens=32)
            history.sample_once(now=T0 + 10.0)
        finally:
            trace_mod.set_tracer(prev)
            tracer.close()
        # a 1ms SLO bound every CPU request blows → the burn rule fires
        rule = AlertRule(name="serve_latency_slo_burn", kind="burn_rate",
                         metric="serve_request_ms", slo_ms=1.0,
                         slo_target=0.99, threshold=2.0, window_s=60.0,
                         severity="critical")
        alert_engine = AlertEngine(history, rules=[rule], registry=reg)
        alert_engine.evaluate_once(now=T0 + 10.0, publish=False)
        states = alert_engine.states()
        assert states[0]["state"] == "firing"
        exemplars = states[0]["exemplars"]
        assert exemplars, "firing latency rule must carry exemplars"
        spans = load_trace_dir(trace_dir)
        for ex in exemplars:
            trace_spans = find_trace(spans, ex["trace_id"])
            assert trace_spans, f"exemplar {ex['trace_id']} has no spans"
            names = {sp["name"] for sp in trace_spans.values()}
            assert "serve.request" in names
        # and the CLI resolves one too (the human path)
        out = subprocess.run(
            [sys.executable, os.path.join(REPO, "tools",
                                          "trace_report.py"),
             trace_dir, "--trace-id", exemplars[0]["trace_id"]],
            capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, out.stderr
        assert "serve.request" in out.stdout


class TestThreadLifecycle:
    def test_engine_evaluator_stable_under_repeated_start_stop(self):
        h, _ = _hist()
        before = threading.active_count()
        eng = AlertEngine(h, registry=MetricsRegistry(),
                          interval_s=0.005)
        for _ in range(4):
            eng.start()
            eng.start()  # idempotent
            time.sleep(0.02)
            eng.stop()
            eng.stop()  # idempotent
            assert threading.active_count() == before
        eng.close()
        assert threading.active_count() == before

    def test_watchtower_arm_stop_joins_everything(self, tmp_path):
        before = threading.active_count()
        tower = arm_watchtower(registry=MetricsRegistry(),
                               tracker=InMemoryStateTracker(),
                               process="t", out_dir=str(tmp_path),
                               interval_s=0.01)
        assert isinstance(tower, Watchtower)
        time.sleep(0.05)
        tower.tick()
        tower.stop()
        assert threading.active_count() == before
        assert os.path.isfile(tmp_path / "history_t.jsonl")
        assert os.path.isfile(tmp_path / "alerts_t.jsonl")

    def test_process_global_engine_seam(self):
        prev = set_engine(None)
        try:
            assert get_engine() is None
            h, _ = _hist()
            eng = AlertEngine(h, registry=MetricsRegistry())
            assert set_engine(eng) is None
            assert get_engine() is eng
        finally:
            set_engine(prev)


# ------------------------------------------------------ alert_report CLI ----

class TestAlertReport:
    def _run(self, *args):
        return subprocess.run(
            [sys.executable,
             os.path.join(REPO, "tools", "alert_report.py"), *args],
            capture_output=True, text=True, timeout=60)

    def _watch_dir(self, tmp_path):
        reg = MetricsRegistry()
        tower = arm_watchtower(registry=reg,
                               process="demo",
                               out_dir=str(tmp_path), start=False)
        reg.counter("guard_skipped_steps_total").inc(0)
        tower.history.sample_once(now=T0)
        reg.counter("guard_skipped_steps_total").inc(3)
        tower.history.sample_once(now=T0 + 10.0)
        tower.engine.evaluate_once(now=T0 + 10.0)
        tower.stop()
        return str(tmp_path)

    def test_renders_timeline_and_history(self, tmp_path):
        d = self._watch_dir(tmp_path)
        out = self._run(d)
        assert out.returncode == 0, out.stderr
        assert "nonfinite_step_rate" in out.stdout
        assert "inactive -> firing" in out.stdout
        assert "!! demo/nonfinite_step_rate: firing" in out.stdout
        assert "history [demo]" in out.stdout
        assert "guard_skipped_steps_total" in out.stdout

    def test_json_mode(self, tmp_path):
        d = self._watch_dir(tmp_path)
        out = self._run(d, "--json")
        assert out.returncode == 0, out.stderr
        rep = json.loads(out.stdout)
        assert any(t["to"] == "firing" for t in rep["transitions"])
        assert rep["verdicts"][0]["rule"] == "nonfinite_step_rate"
        assert rep["histories"][0]["samples"] == 2

    def test_missing_dir_exit_2(self, tmp_path):
        out = self._run(str(tmp_path / "nope"))
        assert out.returncode == 2

    def test_empty_dir_exit_3(self, tmp_path):
        out = self._run(str(tmp_path))
        assert out.returncode == 3
        assert "no alert transitions" in out.stderr


# -------------------------------------------- end-to-end elastic pin ----

def test_alert_pin_poisoned_worker_cluster_visible(tmp_path):
    """The end-to-end pin: the guardrails
    ``nan_at_step`` injection poisons an elastic worker → the master
    quarantines it → the master watchtower's ``worker_divergence``
    rule fires → the flight recorder dumps ``reason=alert:...``
    forensics, the transition lands in the alerts JSONL, and the alert is
    cluster-visible through a ClusterAggregator reading over the REAL
    TCP tracker."""
    from deeplearning4j_tpu_torch.scaleout.elastic import (
        ElasticMaster,
        ElasticWorker,
        SyntheticRegressionModel,
    )
    from deeplearning4j_tpu_torch.scaleout.remote_tracker import (
        StateTrackerClient,
    )

    def model(**kw):
        d = dict(d_in=4, d_hidden=8, batch=8, lr=0.05, mesh_devices=1,
                 device="cpu")
        d.update(kw)
        return SyntheticRegressionModel(**d)

    blob = f"file://{tmp_path / 'blob'}"
    trace_dir = str(tmp_path / "trace")
    watch_dir = str(tmp_path / "watch")
    prev = trace_mod.set_tracer(trace_mod.Tracer(
        "master", trace_dir=trace_dir, registry=MetricsRegistry(),
        min_checkpoint_interval_s=3600.0))
    try:
        master = ElasticMaster(
            model(), blob, sync_every=2, min_workers=1,
            worker_timeout_s=30.0, register_timeout_s=60,
            round_timeout_s=90, registry=MetricsRegistry(),
            watch=True, watch_dir=watch_dir)
        clean = ElasticWorker(master.address, blob, model(),
                              worker_id="clean", worker_seed=1,
                              sync_every=2, round_timeout_s=90)
        poison = ElasticWorker(master.address, blob,
                               model(nan_at_step=2, nan_worker_seed=2),
                               worker_id="poison", worker_seed=2,
                               sync_every=2, round_timeout_s=90)
        threads = [threading.Thread(target=w.run, daemon=True)
                   for w in (clean, poison)]
        for t in threads:
            t.start()
        try:
            master.wait_for_workers(2)
            master.train(rounds=3)
            # deterministic final verdict (the background evaluator may
            # already have fired; tick() is idempotent on state)
            states = {s["rule"]: s for s in master.watchtower.tick()}
            assert states["worker_divergence"]["state"] == "firing", \
                states["worker_divergence"]
            assert states["worker_divergence"]["severity"] == "critical"
            # cluster-visible over the REAL TCP tracker, while the
            # master's embedded server is still up
            client = StateTrackerClient(master.address)
            try:
                agg = ClusterAggregator(client, stale_after_s=3600.0,
                                        registry=MetricsRegistry())
                view = agg.collect_alerts()
            finally:
                client.close()
            by = {(a["process"], a["rule"]): a["state"]
                  for a in view["alerts"]}
            assert by[("master", "worker_divergence")] == "firing"
            assert view["firing"] >= 1
        finally:
            master.shutdown()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        trace_mod.set_tracer(prev)
    # forensics: the firing transition dumped through the flight
    # recorder with the alert reason...
    dump = json.load(open(os.path.join(trace_dir,
                                       "flightrec_master.json")))
    assert dump["reason"].startswith("alert:"), dump["reason"]
    assert dump["extra"]["rule"] in (
        "worker_divergence", "worker_heartbeat_stale")
    # ...and the alerts JSONL pins worker_divergence specifically
    log = [json.loads(l) for l in
           open(os.path.join(watch_dir, "alerts_master.jsonl"))]
    assert any(r["rule"] == "worker_divergence" and r["to"] == "firing"
               for r in log), log
    # the history spill survived too (alert_report's raw material)
    assert os.path.isfile(os.path.join(watch_dir,
                                       "history_master.jsonl"))


# ------------------------------------------------------- across packages ----

def test_default_pack_equals_jax_field_for_field():
    """The port's rule pack is JAX's: the same rules in the same order
    with every field equal, and the same schema and KV prefix."""
    import dataclasses

    from deeplearning4j_tpu.telemetry import alerts as jalerts

    mine = [dataclasses.asdict(r) for r in default_rules()]
    theirs = [dataclasses.asdict(r) for r in jalerts.default_rules()]
    assert mine == theirs
    assert (SCHEMA, ALERT_KV_PREFIX) == (jalerts.SCHEMA,
                                         jalerts.ALERT_KV_PREFIX)


def test_jax_aggregator_reads_port_alert_rows():
    """A port engine's published payload merges in JAX's
    ``ClusterAggregator`` and a JAX engine's in the port's."""
    from deeplearning4j_tpu.telemetry.alerts import AlertEngine as JEngine
    from deeplearning4j_tpu.telemetry.federation import (
        ClusterAggregator as JAgg,
    )
    from deeplearning4j_tpu.telemetry.history import MetricsHistory as JH
    from deeplearning4j_tpu.telemetry.registry import MetricsRegistry as JReg

    tracker = InMemoryStateTracker()
    h, now = RULE_FIXTURES["worker_divergence"][0]()
    AlertEngine(h, registry=MetricsRegistry(), tracker=tracker,
                process="port").evaluate_once(now=now)
    jreg = JReg()
    jh = JH(registry=jreg)
    jreg.counter("elastic_workers_quarantined_total").inc(0)
    jh.sample_once(now=T0)
    jreg.counter("elastic_workers_quarantined_total").inc(1)
    jh.sample_once(now=T0 + 10.0)
    JEngine(jh, registry=JReg(), tracker=tracker,
            process="jax").evaluate_once(now=T0 + 10.0)
    for agg in (JAgg(tracker, stale_after_s=3600.0, registry=JReg()),
                ClusterAggregator(tracker, stale_after_s=3600.0,
                                  registry=MetricsRegistry())):
        view = agg.collect_alerts()
        by = {(a["process"], a["rule"]): a["state"]
              for a in view["alerts"]}
        assert by[("port", "worker_divergence")] == "firing"
        assert by[("jax", "worker_divergence")] == "firing"
        assert view["firing"] == 2
