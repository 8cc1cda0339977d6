"""The port's serving fleet (deeplearning4j_tpu_torch: serve/router.py,
serve/fleet.py, run_open_loop(sessions=), the ``fleet`` CLI) held against
the JAX package's: tests/test_fleet.py through the port (its
``test_uiserver_fleet_surface`` is in tests/test_torch_ui.py), plus

- an in-process port fleet on JAX's params (``interop.lm_params_from_numpy``)
  giving JAX's ``DecodeEngine`` greedy tokens at f32;
- a JAX ``FleetRouter`` serving through port ``FleetReplica``s over TCP,
  tokens equal to JAX's engine;
- ``pick_replica`` equal to JAX's on random views;
- the chaos pin with two ``--device cpu`` subprocess replicas: SIGKILL
  one mid-stream, every request finishes token-identical to the port's
  engine, the victim's heartbeat gauge reads -1.0, ``requeued_total`` is
  at least 1, and the replacement ``rC`` (started through the CLI driver)
  joins; as in JAX's test, ``fleet_replica_down`` fires between the kill
  and the burial and resolves after it, and the survivor ``rB`` runs
  with ``--watch``: its watchtower's alert rows reach the tracker.

Subprocess replicas write to a file (a pipe nobody drains can block a
child), wait with timeouts and are killed in a ``finally``. Heartbeat
windows are JAX's or wider, and no test holds a wall-time budget.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import json
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest

from _torch_lm_init import lm_params_np
from deeplearning4j_tpu.scaleout import remote_tracker as jrt
from deeplearning4j_tpu.serve import router as jrouter
from deeplearning4j_tpu.serve.engine import DecodeEngine as JaxEngine
from deeplearning4j_tpu.telemetry.registry import \
    MetricsRegistry as JaxRegistry
from deeplearning4j_tpu_torch.interop import lm_params_from_numpy
from deeplearning4j_tpu_torch.scaleout.remote_tracker import (
    StateTrackerClient,
    StateTrackerServer,
)
from deeplearning4j_tpu_torch.scaleout.statetracker import \
    InMemoryStateTracker
from deeplearning4j_tpu_torch.serve import (
    DecodeEngine,
    FleetReplica,
    FleetRouter,
    pick_replica,
    run_open_loop,
)
from deeplearning4j_tpu_torch.serve.fleet import synthetic_params
from deeplearning4j_tpu_torch.serve.router import (
    HB_PREFIX,
    INFO_PREFIX,
    LOAD_PREFIX,
    PROG_PREFIX,
    REQ_PREFIX,
)
from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, D, H, E, DFF, L = 61, 16, 2, 4, 32, 2
MAXLEN = 32
SYNTH = f"{V},{D},{H},{E},{DFF},{L}"
PROC_TIMEOUT_S = 120


@pytest.fixture(scope="module")
def np_params():
    return lm_params_np(0, V, D, H, E, DFF, L)


@pytest.fixture(scope="module")
def params(np_params):
    return lm_params_from_numpy(np_params, "cpu")


def _prompts(n, seed=1, lo=3, hi=9):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, V, rng.randint(lo, hi))))
            for _ in range(n)]


def _engine(params, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", MAXLEN)
    kw.setdefault("serve_dtype", None)  # exact f32: oracle parity
    kw.setdefault("registry", MetricsRegistry())
    return DecodeEngine(params, H, device="cpu", **kw)


def _jax_generate(np_params, prompts, max_new):
    """JAX's engine, one request at a time (the oracle of test_fleet.py)."""
    import jax.numpy as jnp

    eng = JaxEngine(jax.tree_util.tree_map(jnp.asarray, np_params), H,
                    n_slots=2, max_len=MAXLEN, serve_dtype=None,
                    registry=JaxRegistry())
    return [eng.generate(p, max_new_tokens=max_new) for p in prompts]


# ------------------------------------------ pick_replica policy (pure) ----

def _view(rid, state="alive", outstanding=0, queue_depth=0, active_slots=0):
    return {"replica_id": rid, "state": state, "outstanding": outstanding,
            "queue_depth": queue_depth, "active_slots": active_slots}


class TestPickReplica:
    def test_least_loaded_wins(self):
        views = [_view("r1", outstanding=3), _view("r2", queue_depth=1)]
        assert pick_replica(views) == "r2"

    def test_load_sums_outstanding_queue_and_slots(self):
        views = [_view("r1", outstanding=1, queue_depth=1, active_slots=1),
                 _view("r2", queue_depth=2)]
        assert pick_replica(views) == "r2"

    def test_tie_break_is_deterministic_and_order_independent(self):
        a = [_view("r2"), _view("r1"), _view("r3")]
        b = [_view("r3"), _view("r2"), _view("r1")]
        for _ in range(5):
            assert pick_replica(a) == "r1"
            assert pick_replica(b) == "r1"

    def test_stale_and_dead_excluded_even_at_zero_load(self):
        views = [_view("r1", state="stale"), _view("r2", state="dead"),
                 _view("r3", outstanding=10)]
        assert pick_replica(views) == "r3"

    def test_nothing_alive_returns_none(self):
        assert pick_replica([]) is None
        assert pick_replica([_view("r1", state="stale")]) is None

    def test_pinned_live_session_beats_load(self):
        views = [_view("r1", outstanding=10), _view("r2")]
        assert pick_replica(views, session="s", affinity={"s": "r1"}) == "r1"

    def test_pin_to_non_alive_replica_falls_back_to_least_loaded(self):
        views = [_view("r1", state="stale"), _view("r2", outstanding=1),
                 _view("r3")]
        assert pick_replica(views, session="s", affinity={"s": "r1"}) == "r3"

    def test_equals_jax_on_random_views(self):
        rng = np.random.RandomState(0)
        states = ("alive", "alive", "stale", "dead")
        for _ in range(200):
            views = [_view(f"r{i}", state=states[rng.randint(4)],
                           outstanding=int(rng.randint(3)),
                           queue_depth=int(rng.randint(3)),
                           active_slots=int(rng.randint(3)))
                     for i in range(int(rng.randint(0, 5)))]
            affinity = {"s": f"r{rng.randint(5)}"}
            for session in (None, "s", "t"):
                assert pick_replica(views, session, affinity) == \
                    jrouter.pick_replica(views, session, affinity)

    def test_key_layout_equals_jax(self):
        assert (HB_PREFIX, INFO_PREFIX, LOAD_PREFIX, PROG_PREFIX,
                REQ_PREFIX) == (jrouter.HB_PREFIX, jrouter.INFO_PREFIX,
                                jrouter.LOAD_PREFIX, jrouter.PROG_PREFIX,
                                jrouter.REQ_PREFIX)


# ----------------------------- router over a scripted tracker (no engines) ----

class _Scripted:
    """Drives the tracker as a FleetReplica would, under test control:
    heartbeats only when told, dispatch rows claimed and progress rows
    emitted on demand."""

    def __init__(self, tracker, rid):
        self.tracker = tracker
        self.rid = rid

    def register(self):
        self.tracker.add_worker(self.rid)
        self.beat()
        self.publish_load()

    def beat(self):
        self.tracker.increment(HB_PREFIX + self.rid, 1.0)

    def publish_load(self, queue_depth=0, active_slots=0, slots=2):
        self.tracker.put_kv(LOAD_PREFIX + self.rid, json.dumps({
            "replica_id": self.rid, "queue_depth": queue_depth,
            "active_slots": active_slots, "slots": slots,
            "weight_version": "scripted"}))

    def claim(self):
        rows = self.tracker.kv_snapshot(f"{REQ_PREFIX}{self.rid}.")
        out = {}
        for key in sorted(rows):
            spec = json.loads(rows[key])
            out[spec["rid"]] = spec
        return out

    def emit(self, req_rid, attempt, tokens, done=False, finish_reason=None):
        self.tracker.put_kv(PROG_PREFIX + req_rid, json.dumps({
            "attempt": attempt, "tokens": list(tokens), "done": done,
            "finish_reason": finish_reason, "replica": self.rid}))


def _router(tracker, **kw):
    kw.setdefault("registry", MetricsRegistry())
    kw.setdefault("poll_s", 0.001)
    return FleetRouter(tracker, **kw)


def _step_until(router, cond, beat=(), timeout_s=30.0, msg="condition"):
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting: {msg}"
        for rep in beat:
            rep.beat()
        router.step()


def _state(router, rid):
    rows = {r["replica_id"]: r for r in router.fleet_snapshot()["replicas"]}
    return rows.get(rid, {}).get("state")


class TestScriptedMembership:
    def test_stale_replica_gets_zero_dispatches_then_recovers(self):
        tracker = InMemoryStateTracker()
        r1, r2 = _Scripted(tracker, "r1"), _Scripted(tracker, "r2")
        r1.register()
        r2.register()
        router = _router(tracker, stale_after_s=0.08, dead_after_s=30.0)
        router.step()
        assert _state(router, "r1") == "alive"
        _step_until(router, lambda: _state(router, "r1") == "stale",
                    beat=(r2,), msg="r1 stale")
        assert router.fleet_snapshot()["failed_replicas"] == []
        for _ in range(4):
            router.submit([1, 2, 3])
        r2.beat()
        router.step()
        snap = {r["replica_id"]: r for r in router.fleet_snapshot()["replicas"]}
        assert snap["r2"]["dispatches"] == 4
        assert snap["r1"]["dispatches"] == 0
        r1.beat()
        _step_until(router, lambda: _state(router, "r1") == "alive",
                    beat=(r2,), msg="r1 recovered")
        assert router.fleet_snapshot()["failed_replicas"] == []

    def test_affinity_survives_stale_rejoin(self):
        tracker = InMemoryStateTracker()
        r1, r2 = _Scripted(tracker, "r1"), _Scripted(tracker, "r2")
        r1.register()
        r2.register()
        router = _router(tracker, stale_after_s=0.08, dead_after_s=30.0)
        router.step()
        req = router.submit([1, 2, 3], max_new_tokens=2, session="s")
        router.step()
        assert req.replica == "r1"  # tie-break
        assert router.fleet_snapshot()["affinity"] == {"s": "r1"}
        r1.emit(req.rid, 1, [4, 5], done=True)
        _step_until(router, lambda: req.t_done is not None,
                    beat=(r1, r2), msg="req done")
        _step_until(router, lambda: _state(router, "r1") == "stale",
                    beat=(r2,), msg="r1 stale")
        r1.beat()
        _step_until(router, lambda: _state(router, "r1") == "alive",
                    beat=(r2,), msg="r1 rejoined")
        assert router.fleet_snapshot()["affinity"] == {"s": "r1"}
        r1.publish_load(queue_depth=5)
        r1.beat()
        r2.beat()
        req2 = router.submit([1, 2, 3], session="s")
        router.step()
        assert req2.replica == "r1"
        req3 = router.submit([1, 2, 3], session="t")
        r1.beat()
        r2.beat()
        router.step()
        assert req3.replica == "r2"

    def test_death_requeues_carried_tokens_and_decrements_budget(self):
        tracker = InMemoryStateTracker()
        r1, r2 = _Scripted(tracker, "r1"), _Scripted(tracker, "r2")
        r1.register()
        r2.register()
        reg = MetricsRegistry()
        router = _router(tracker, registry=reg, stale_after_s=0.05,
                         dead_after_s=0.12)
        router.step()
        prompt = [1, 2, 3, 4]
        req = router.submit(prompt, max_new_tokens=8, session="s")
        router.step()
        assert req.replica == "r1"
        spec = r1.claim()[req.rid]
        assert (spec["attempt"], spec["prompt"], spec["max_new"]) == (
            1, prompt, 8)
        r1.emit(req.rid, 1, [11, 12, 13])
        _step_until(router, lambda: req.generated == [11, 12, 13],
                    beat=(r1, r2), msg="partial progress")
        _step_until(router,
                    lambda: "r1" in router.fleet_snapshot()[
                        "failed_replicas"],
                    beat=(r2,), msg="r1 buried")
        assert req.requeues == 1 and req.t_requeue is not None
        assert reg.gauge("fleet_replica_heartbeat_unix",
                         {"replica": "r1"}).value == -1.0
        assert reg.counter("fleet_replicas_failed_total").value == 1
        r2.beat()
        router.step()
        spec2 = r2.claim()[req.rid]
        assert spec2["attempt"] == 2
        assert spec2["prompt"] == prompt + [11, 12, 13]  # retained stream
        assert spec2["max_new"] == 5                     # budget shrunk
        assert router.fleet_snapshot()["affinity"] == {"s": "r2"}
        # a late row from the buried attempt is inert
        r1.emit(req.rid, 1, [11, 12, 13, 99, 98], done=True)
        r2.beat()
        router.step()
        assert req.t_done is None and req.generated == [11, 12, 13]
        r2.emit(req.rid, 2, [14, 15, 16, 17, 18], done=True)
        _step_until(router, lambda: req.t_done is not None,
                    beat=(r2,), msg="continuation done")
        assert req.generated == [11, 12, 13, 14, 15, 16, 17, 18]
        assert req.t_first_after_requeue >= req.t_requeue
        snap = router.fleet_snapshot()
        assert snap["requeued_total"] == 1 and snap["completed_total"] == 1


# ------------------------------ in-process fleet (real replica loops) ----

def _fleet(params, tracker, rids, **router_kw):
    reps = []
    for rid in rids:
        rep = FleetReplica(_engine(params), tracker, rid, heartbeat_s=0.05,
                           poll_s=0.005, publish_s=0.1)
        rep.start()
        reps.append(rep)
    router_kw.setdefault("stale_after_s", 1.0)
    router_kw.setdefault("dead_after_s", 5.0)
    router_kw.setdefault("poll_s", 0.005)
    return reps, _router(tracker, **router_kw)


def test_fleet_generates_jax_tokens_with_affinity(params, np_params):
    """Two in-process replicas on JAX's params, routed greedy f32 output
    equal to JAX's engine; each session rides one replica."""
    tracker = InMemoryStateTracker()
    reps, router = _fleet(params, tracker, ("r1", "r2"))
    try:
        prompts = _prompts(6, seed=3)
        sessions = [f"s{i % 2}" for i in range(6)]
        reqs = [router.submit(p, max_new_tokens=6, session=s)
                for p, s in zip(prompts, sessions)]
        router.run_until_idle(timeout_s=120.0)
        want = _jax_generate(np_params, prompts, 6)
        for r, w in zip(reqs, want):
            assert r.generated == w
            assert r.finish_reason == "max_new_tokens"
        for s in ("s0", "s1"):
            assert len({r.replica for r, ss in zip(reqs, sessions)
                        if ss == s}) == 1
        snap = router.fleet_snapshot()
        assert snap["alive"] == 2 and set(snap["affinity"]) == {"s0", "s1"}
        assert snap["completed_total"] == 6 and snap["requeued_total"] == 0
    finally:
        for rep in reps:
            rep.stop()


def test_open_loop_with_sessions_drives_the_fleet(params):
    """``run_open_loop(router, ..., sessions=)``: every request finishes
    token-identical to one engine's, each session on one replica, and a
    sessions list of the wrong length is refused."""
    tracker = InMemoryStateTracker()
    reps, router = _fleet(params, tracker, ("r1", "r2"))
    try:
        prompts = _prompts(8, seed=5)
        sessions = ["a", "b", None, "a", "b", None, "a", None]
        seen = []
        submit = router.submit

        def recording(*args, **kwargs):
            seen.append((submit(*args, **kwargs), kwargs.get("session")))
            return seen[-1][0]

        router.submit = recording
        rep = run_open_loop(router, prompts, rate_rps=200.0,
                            max_new_tokens=5, sessions=sessions)
        assert rep.completed == 8 and rep.tokens_out == 40
        oracle = _engine(params)
        for (req, session), p in zip(seen, prompts):
            assert req.generated == oracle.generate(p, max_new_tokens=5)
        assert [s for _, s in seen] == sessions
        for s in ("a", "b"):
            assert len({r.replica for r, ss in seen if ss == s}) == 1
        with pytest.raises(ValueError, match="sessions"):
            run_open_loop(router, prompts, 200.0, sessions=["a"])
    finally:
        for rep in reps:
            rep.stop()


def test_fleet_start_stop_leaves_thread_count_stable(params):
    tracker = InMemoryStateTracker()
    engine = _engine(params)
    before = threading.active_count()
    for _ in range(3):
        rep = FleetReplica(engine, tracker, "r1", heartbeat_s=0.02,
                           poll_s=0.005, publish_s=0.05)
        router = _router(tracker, stale_after_s=0.5, dead_after_s=2.0,
                         poll_s=0.005)
        rep.start()
        router.start()
        time.sleep(0.05)
        router.stop()
        rep.stop()
    assert threading.active_count() == before


def test_replica_publishes_info_load_and_federated_metrics(params):
    """The rows a JAX router or aggregator reads: the info row, the load
    row and the federation payload, with JAX's fields."""
    from deeplearning4j_tpu_torch.telemetry.federation import (
        KV_PREFIX,
        SCHEMA,
    )

    tracker = InMemoryStateTracker()
    rep = FleetReplica(_engine(params, weight_version="w7"), tracker, "r1",
                       heartbeat_s=0.05, poll_s=0.005, publish_s=0.05)
    rep.start()
    try:
        info = json.loads(tracker.get_kv(INFO_PREFIX + "r1"))
        assert {k: info[k] for k in ("replica_id", "slots", "max_len",
                                     "weight_version")} == {
            "replica_id": "r1", "slots": 2, "max_len": MAXLEN,
            "weight_version": "w7"}
        load = json.loads(tracker.get_kv(LOAD_PREFIX + "r1"))
        assert set(load) == {"replica_id", "ts", "queue_depth",
                             "active_slots", "slots", "weight_version",
                             "tokens_total", "requests_total",
                             "prefix_hit_rate", "alerts_firing"}
        fed = json.loads(tracker.get_kv(KV_PREFIX + "r1"))
        assert fed["schema"] == SCHEMA and fed["process"] == "r1"
        assert tracker.count(HB_PREFIX + "r1") >= 1
        assert tracker.workers() == ["r1"]
    finally:
        rep.stop()
    assert tracker.workers() == []


def test_replica_rejects_an_oversized_prompt_with_a_terminal_row(params):
    tracker = InMemoryStateTracker()
    reps, router = _fleet(params, tracker, ("r1",))
    try:
        req = router.submit(list(range(MAXLEN + 4)), max_new_tokens=2)
        router.run_until_idle(timeout_s=60.0)
        assert req.finish_reason.startswith("rejected: ")
        assert req.generated == []
    finally:
        for rep in reps:
            rep.stop()


def test_jax_router_serves_through_port_replicas_over_tcp(params,
                                                          np_params):
    """Port replicas (each with its own two TCP clients) behind a port
    server, driven by JAX's FleetRouter through JAX's client: the tokens
    equal JAX's engine."""
    prompts = _prompts(5, seed=7)
    with StateTrackerServer() as server:
        reps = []
        try:
            for rid in ("p1", "p2"):
                rep = FleetReplica(_engine(params), server.address, rid,
                                   heartbeat_s=0.05, poll_s=0.005,
                                   publish_s=0.1)
                rep.start()
                reps.append(rep)
            client = jrt.StateTrackerClient(server.address,
                                            registry=JaxRegistry())
            try:
                router = jrouter.FleetRouter(
                    client, registry=JaxRegistry(), stale_after_s=1.0,
                    dead_after_s=5.0, poll_s=0.005)
                reqs = [router.submit(p, max_new_tokens=6,
                                      session=f"s{i % 2}")
                        for i, p in enumerate(prompts)]
                router.run_until_idle(timeout_s=120.0)
                snap = router.fleet_snapshot()
            finally:
                client.close()
        finally:
            for rep in reps:
                rep.stop()
    want = _jax_generate(np_params, prompts, 6)
    assert [r.generated for r in reqs] == want
    assert snap["alive"] == 2 and snap["requeued_total"] == 0
    assert {r.replica for r in reqs} == {"p1", "p2"}


def test_from_live_params_builds_a_replica(params):
    tracker = InMemoryStateTracker()
    rep = FleetReplica.from_live_params(
        params, H, tracker, "live", device="cpu",
        engine_kwargs={"n_slots": 2, "max_len": MAXLEN, "serve_dtype": None,
                       "registry": MetricsRegistry()},
        heartbeat_s=0.05)
    assert rep.engine.device.type == "cpu"
    assert rep.engine.weight_version == "live-params"
    assert rep.engine.generate([1, 2, 3], max_new_tokens=4) == \
        _engine(params).generate([1, 2, 3], max_new_tokens=4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            FleetReplica.from_live_params(params, H, tracker, "x")


# ------------------------------------------------------- the process ----

def test_replica_main_refuses_watch_and_a_missing_card():
    """``--watch`` parses (the watchtower is armed after the engine is
    built, so the run reaches replica_main's own checks first); one
    model source is required; ``--device`` defaults to cuda."""
    from deeplearning4j_tpu_torch.serve.fleet import replica_main

    base = ["--replica", "--tracker", "127.0.0.1:1", "--synthetic", SYNTH]
    with pytest.raises(SystemExit, match="exactly one"):
        replica_main(base + ["--device", "cpu", "--watch", "--checkpoint",
                             "x"])
    with pytest.raises(SystemExit, match="exactly one"):
        replica_main(base + ["--checkpoint", "x", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            replica_main(base)  # --device defaults to cuda


def test_synthetic_params_are_seeded_on_the_cpu():
    a, h = synthetic_params(SYNTH, 3)
    b, _ = synthetic_params(SYNTH, 3)
    c, _ = synthetic_params(SYNTH, 4)
    assert h == H and a["embed"].device.type == "cpu"
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])
    with pytest.raises(SystemExit, match="6 ints"):
        synthetic_params("1,2,3", 0)


def test_jax_cli_fleet_rejects_leading_options_the_port_forwards():
    """JAX's ``driver fleet --replica ...`` fails in argparse (REMAINDER
    drops options that lead it); the port's driver forwards them to
    replica_main, which reaches its own checks."""
    from deeplearning4j_tpu.cli import driver as jdriver

    from deeplearning4j_tpu_torch.cli import driver

    argv = ["fleet", "--replica", "--tracker", "127.0.0.1:1",
            "--synthetic", SYNTH, "--device", "cpu", "--watch",
            "--checkpoint", "x"]
    with pytest.raises(SystemExit) as ei:
        jdriver.main(argv[:-5])
    assert ei.value.code == 2
    with pytest.raises(SystemExit, match="exactly one"):
        driver.main(argv)


def _spawn_replica(address, rid, log_dir, cli=False, watch=False):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    entry = (["deeplearning4j_tpu_torch.cli.driver", "fleet"] if cli
             else ["deeplearning4j_tpu_torch.serve.fleet"])
    out = open(os.path.join(log_dir, f"{rid}.log"), "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", *entry,
         "--replica", "--tracker", address, "--replica-id", rid,
         "--synthetic", SYNTH, "--seed", "0", "--serve-dtype", "none",
         "--slots", "2", "--max-len", str(MAXLEN), "--device", "cpu",
         "--heartbeat-s", "0.05", "--poll-s", "0.005", "--publish-s", "0.1",
         *(["--watch"] if watch else [])],
        stdout=out, stderr=subprocess.STDOUT, text=True, cwd=REPO, env=env)
    proc.log = out
    return proc


def _wait_ready(proc, rid, timeout_s=PROC_TIMEOUT_S):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        proc.log.seek(0)
        text = proc.log.read()
        if f"FLEET_REPLICA_READY {rid}" in text:
            return
        assert proc.poll() is None, text[-2000:]
        time.sleep(0.05)
    raise AssertionError(f"replica {rid} did not become ready")


def _stop_all(procs):
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)
        proc.log.close()


def test_chaos_kill9_mid_stream_completes_token_identical(tmp_path):
    """Two subprocess replicas over the TCP tracker, SIGKILL one
    mid-stream: every request completes token-identical to one engine on
    the same seeded synthetic params, the victim is buried (-1.0 gauge,
    failed_replicas), its requests requeued, and the replacement started
    by ``cold_start`` through the CLI driver joins the membership. A
    watch over the router's registry fires ``fleet_replica_down`` between
    the kill and the burial and resolves once the sentinel retires the
    series; ``rB``'s ``--watch`` publishes its alert rows."""
    import dataclasses

    from deeplearning4j_tpu_torch.telemetry.alerts import (
        AlertEngine,
        default_rules,
    )
    from deeplearning4j_tpu_torch.telemetry.federation import (
        ClusterAggregator,
    )
    from deeplearning4j_tpu_torch.telemetry.history import MetricsHistory

    prompts = _prompts(6, seed=11)
    max_new = 12
    sparams, h = synthetic_params(SYNTH, 0)
    oracle = DecodeEngine(sparams, h, n_slots=2, max_len=MAXLEN,
                          serve_dtype=None, device="cpu",
                          registry=MetricsRegistry())
    expected = [oracle.generate(p, max_new_tokens=max_new) for p in prompts]
    procs = {}
    spawned = []
    with StateTrackerServer() as tsrv:
        addr = tsrv.address
        client = StateTrackerClient(addr)
        try:
            for rid in ("rA", "rB"):
                procs[rid] = _spawn_replica(addr, rid, str(tmp_path),
                                            watch=rid == "rB")
            for rid, proc in procs.items():
                _wait_ready(proc, rid)

            def cold_start(_failed_rid):
                procs["rC"] = _spawn_replica(addr, "rC", str(tmp_path),
                                             cli=True)
                spawned.append(procs["rC"])

            reg = MetricsRegistry()
            router = _router(client, registry=reg, stale_after_s=0.3,
                             dead_after_s=1.0, poll_s=0.01,
                             cold_start=cold_start)
            rule = dataclasses.replace(
                [r for r in default_rules()
                 if r.name == "fleet_replica_down"][0], stale_s=0.4)
            hist = MetricsHistory(registry=reg)
            alerts = AlertEngine(hist, rules=[rule],
                                 registry=MetricsRegistry())
            down_fired = False
            _step_until(router,
                        lambda: router.fleet_snapshot()["alive"] >= 2,
                        timeout_s=60.0, msg="both replicas alive")
            reqs = [router.submit(p, max_new_tokens=max_new)
                    for p in prompts]
            killed = False
            deadline = time.monotonic() + 180.0
            while router.has_work():
                assert time.monotonic() < deadline, "chaos did not drain"
                router.step()
                hist.sample_once()
                if any(st["state"] == "firing"
                       for st in alerts.evaluate_once()):
                    down_fired = True
                if not killed and any(
                        r.t_done is None and r.replica == "rA"
                        and len(r.generated) >= 1 for r in reqs):
                    os.kill(procs["rA"].pid, signal.SIGKILL)
                    killed = True
            assert killed, "victim was never mid-stream"
            for req, exp in zip(reqs, expected):
                assert req.t_done is not None
                assert req.generated == exp
                assert req.finish_reason == "max_new_tokens"
            snap = router.fleet_snapshot()
            assert snap["failed_replicas"] == ["rA"]
            assert snap["requeued_total"] >= 1
            assert reg.gauge("fleet_replica_heartbeat_unix",
                             {"replica": "rA"}).value == -1.0
            assert reg.counter("fleet_requeued_total").value == \
                snap["requeued_total"]
            assert down_fired, "fleet_replica_down never fired"
            hist.sample_once()
            final = {st["rule"]: st["state"]
                     for st in alerts.evaluate_once()}
            assert final["fleet_replica_down"] != "firing"
            view = ClusterAggregator(client, stale_after_s=3600.0,
                                     registry=MetricsRegistry()
                                     ).collect_alerts()
            assert "rB" in [p["process"] for p in view["processes"]]
            assert any(a["process"] == "rB" for a in view["alerts"])
            assert spawned, "cold_start never ran"
            _step_until(
                router,
                lambda: any(r["replica_id"] == "rC" and r["state"] == "alive"
                            for r in router.fleet_snapshot()["replicas"]),
                timeout_s=PROC_TIMEOUT_S, msg="replacement rC alive")
            # the replacement serves, and finish() ends both survivors
            req = router.submit(prompts[0], max_new_tokens=4)
            router.run_until_idle(timeout_s=60.0)
            assert req.generated == expected[0][:4]
            client.finish()
            for rid in ("rB", "rC"):
                assert procs[rid].wait(timeout=60) == 0, rid
            assert procs["rA"].wait(timeout=30) == -signal.SIGKILL
        finally:
            client.close()
            _stop_all(procs)
