"""The port's ``utils.lockwatch`` held to the JAX package's tests
(mirroring ``tests/test_lockwatch.py``): the seam, the lock-order graph
that raises before it blocks, the condition hand-off, the ``lockwatch_*``
metrics through the port's registry, the watchdog's dump through the
port's flight recorder, and the thread-lifecycle audit of the port's
servers and loops. Then the port's side: its 18 seams carry the JAX
package's role names, and armed, the serving engine, the tracker, the
registry, the tracer and the async checkpointer feed the metrics.

The ``lockwatch`` fixture lives here (``tests/conftest.py``'s is JAX's).
No test waits on a watchdog for more than 1 s."""

import json
import os
import re
import threading
import time
from pathlib import Path

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import numpy as np
import pytest

from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry
from deeplearning4j_tpu_torch.utils import lockwatch as lw

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def lockwatch():
    """The port's lockwatch armed for the test (raise on a cycle, a 20 s
    watchdog); disarmed and reset after."""
    lw.reset()
    lw.enable(raise_on_cycle=True, watchdog_s=20.0)
    try:
        yield lw
    finally:
        lw.disable()
        lw.reset()


# ---------------------------------------------------------------- seam ----

def test_seam_hands_out_plain_primitives_when_off():
    assert not lw.enabled()
    assert type(lw.make_lock("off.lock")) is type(threading.Lock())
    assert type(lw.make_rlock("off.rlock")) is type(threading.RLock())
    assert isinstance(lw.make_condition(name="off.cond"),
                      threading.Condition)


def test_seam_hands_out_watched_primitives_when_armed(lockwatch):
    assert isinstance(lw.make_lock("on.lock"), lw.WatchedLock)
    assert isinstance(lw.make_rlock("on.rlock"), lw.WatchedRLock)


def test_env_var_arms_at_creation(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_LOCKWATCH", "1")
    try:
        assert isinstance(lw.make_lock("env.lock"), lw.WatchedLock)
        assert lw.enabled()
    finally:
        lw.disable()
        lw.reset()


def test_env_knobs_set_watchdog_and_raise(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_LOCKWATCH_WATCHDOG_S", "7.5")
    monkeypatch.setenv("DL4J_TPU_LOCKWATCH_RAISE", "0")
    try:
        lw.enable()
        assert lw._state.watchdog_s == 7.5
        assert lw._state.raise_on_cycle is False
    finally:
        lw.disable()
        lw.reset()


def test_disable_quiesces_existing_wrappers(lockwatch):
    lock = lw.make_lock("quiesce.lock")
    with lock:
        pass
    before = lw.summary()["locks"]["quiesce.lock"]["acquires"]
    lw.disable()
    with lock:
        pass
    lw.enable()
    assert lw.summary()["locks"]["quiesce.lock"]["acquires"] == before


# --------------------------------------------------------- order graph ----

def test_cycle_raises_before_deadlocking(lockwatch):
    a, b = lw.make_lock("order.a"), lw.make_lock("order.b")
    with a:
        with b:
            pass
    errs = []

    def reversed_order():
        try:
            with b:
                with a:
                    pass
        except lw.LockOrderViolation as exc:
            errs.append(exc)

    t = threading.Thread(target=reversed_order)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert len(errs) == 1 and "order.a" in str(errs[0])
    assert lw.summary()["cycles"] == 1
    assert lw.graph_snapshot()["order.a"] == ["order.b"]


def test_consistent_order_never_flags(lockwatch):
    a, b = lw.make_lock("ok.a"), lw.make_lock("ok.b")
    for _ in range(5):
        with a:
            with b:
                pass
    assert lw.summary()["cycles"] == 0


def test_cycle_counted_not_raised_when_disarmed():
    lw.reset()
    lw.enable(raise_on_cycle=False)
    try:
        a, b = lw.make_lock("soft.a"), lw.make_lock("soft.b")
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        assert lw.summary()["cycles"] == 1
        assert lw.metrics_record()["lockwatch_cycles"] == 1.0
    finally:
        lw.disable()
        lw.reset()


def test_rlock_reentry_is_not_an_edge(lockwatch):
    r = lw.make_rlock("re.lock")
    with r:
        with r:
            pass
    assert "re.lock" not in lw.graph_snapshot()
    assert lw.summary()["locks"]["re.lock"]["acquires"] == 1


def test_condition_wait_hands_off_watched_lock(lockwatch):
    cond = lw.make_condition(lw.make_rlock("cv.lock"), name="cv.lock")
    items, got = [], []

    def consumer():
        with cond:
            while not items:
                cond.wait(0.05)
            got.append(items[0])

    t = threading.Thread(target=consumer)
    t.start()
    time.sleep(0.05)
    with cond:
        items.append(1)
        cond.notify_all()
    t.join(timeout=10)
    assert got == [1] and not t.is_alive()
    assert lw.summary()["cycles"] == 0


# ------------------------------------------------ metrics and watchdog ----

def test_metrics_flow_through_registry():
    reg = MetricsRegistry()
    lw.reset()
    lw.enable(registry=reg)
    try:
        lock = lw.make_lock("met.lock")
        hold, release = threading.Event(), threading.Event()

        def holder():
            with lock:
                hold.set()
                release.wait(5)

        t = threading.Thread(target=holder)
        t.start()
        assert hold.wait(5)
        done = []

        def contender():
            with lock:
                done.append(1)

        t2 = threading.Thread(target=contender)
        t2.start()
        time.sleep(0.05)
        release.set()
        t.join(timeout=10)
        t2.join(timeout=10)
        assert done == [1] and not t.is_alive() and not t2.is_alive()
        labels = {"lock": "met.lock"}
        assert reg.counter("lockwatch_acquires_total", labels).value >= 2
        assert reg.counter("lockwatch_contended_total", labels).value >= 1
        assert reg.histogram("lockwatch_wait_ms", labels).count >= 2
        assert reg.histogram("lockwatch_hold_ms", labels).count >= 2
        rec = lw.metrics_record()
        assert rec["lockwatch_met_lock_acquires"] >= 2
        assert rec["lockwatch_met_lock_contended"] >= 1
        assert rec["lockwatch_met_lock_hold_ms_max"] > 0
    finally:
        lw.disable()
        lw.reset()


def test_timed_acquire_honors_timeout(lockwatch):
    lock = lw.make_lock("timeout.lock")
    release = threading.Event()

    def holder():
        with lock:
            release.wait(5)

    t = threading.Thread(target=holder)
    t.start()
    time.sleep(0.05)
    t0 = time.perf_counter()
    assert lock.acquire(timeout=0.2) is False
    assert time.perf_counter() - t0 < 2.0
    release.set()
    t.join(timeout=10)
    assert not t.is_alive()


def test_watchdog_dumps_thread_stacks_through_flight_recorder(tmp_path):
    from deeplearning4j_tpu_torch.telemetry import trace as tr

    lw.reset()
    lw.enable(watchdog_s=0.2)
    tracer = tr.Tracer("lockwatch-test", trace_dir=str(tmp_path),
                       registry=MetricsRegistry())
    prev = tr.set_tracer(tracer)
    try:
        lock = lw.make_lock("stuck.lock")
        release = threading.Event()

        def holder():
            with lock:
                release.wait(5)

        t = threading.Thread(target=holder, name="the-holder")
        t.start()
        time.sleep(0.05)
        assert lock.acquire(timeout=0.6) is False
        release.set()
        t.join(timeout=10)
        assert not t.is_alive()
        assert lw.summary()["watchdog_dumps"] == 1
        payload = json.load(open(tmp_path / "flightrec_lockwatch-test.json"))
        assert payload["reason"] == "lockwatch_blocked"
        assert payload["extra"]["lockwatch"]["lock"] == "stuck.lock"
        assert any("the-holder" in k
                   for k in payload["extra"]["thread_stacks"])
    finally:
        tr.set_tracer(prev)
        lw.disable()
        lw.reset()


# ------------------------------------------------- the port's 18 seams ----

_SEAM = re.compile(r'make_(lock|rlock|condition)\((?:self\._lock, )?'
                   r'(?:name=)?"([^"]+)"')


def _seams(pkg: str) -> list:
    found = []
    for path in sorted((ROOT / pkg).rglob("*.py")):
        if path.name == "lockwatch.py":
            continue
        rel = path.relative_to(ROOT / pkg).as_posix()
        for kind, name in _SEAM.findall(path.read_text()):
            found.append((rel, kind, name))
    return sorted(found)


def test_the_ports_seams_are_jaxs_role_names():
    """Every JAX seam (file, primitive, role) has its port counterpart:
    18 sites in 15 files."""
    jax_seams = _seams("deeplearning4j_tpu")
    assert len(jax_seams) == 18
    assert len({rel for rel, _, _ in jax_seams}) == 15
    assert _seams("deeplearning4j_tpu_torch") == jax_seams


def test_armed_port_components_feed_the_metrics(tmp_path):
    """Armed before they are built, the serving engine, the tracker
    server and client, a registry, a tracer and the async checkpointer
    take watched locks, and their acquires reach ``lockwatch_*``."""
    from deeplearning4j_tpu_torch.models.transformer_lm import \
        init_lm_params
    from deeplearning4j_tpu_torch.scaleout.ckpt import AsyncCheckpointer, \
        Checkpointer
    from deeplearning4j_tpu_torch.scaleout.remote_tracker import (
        StateTrackerClient, StateTrackerServer)
    from deeplearning4j_tpu_torch.serve.engine import DecodeEngine
    from deeplearning4j_tpu_torch.telemetry import trace as tr

    sink = MetricsRegistry()
    lw.reset()
    lw.enable(registry=sink)
    try:
        reg = MetricsRegistry()
        params = init_lm_params(torch.Generator().manual_seed(0), 31, 8, 2,
                                2, 16, n_layers=1, device="cpu")
        engine = DecodeEngine(params, 2, n_slots=2, max_len=16,
                              serve_dtype=None, registry=reg, device="cpu")
        engine.start()
        try:
            assert len(engine.generate([1, 2, 3], max_new_tokens=2)) == 2
        finally:
            engine.stop()
        server = StateTrackerServer()
        client = StateTrackerClient(server.address, registry=reg)
        client.add_worker("w")
        client.close()
        server.shutdown()
        tracer = tr.Tracer("lw", trace_dir=str(tmp_path), registry=reg)
        with tracer.span("s"):
            pass
        with AsyncCheckpointer(Checkpointer(str(tmp_path / "ck"),
                                            registry=reg)) as ck:
            ck.save(1, {"w": np.ones(3, np.float32)})
        locks = lw.summary()["locks"]
        for role in ("serve.engine", "tracker.state", "tracker.client",
                     "telemetry.registry", "telemetry.trace",
                     "ckpt.async.error"):
            assert locks.get(role, {}).get("acquires", 0) > 0, (role, locks)
            assert sink.counter("lockwatch_acquires_total",
                                {"lock": role}).value > 0
        assert lw.summary()["cycles"] == 0
    finally:
        lw.disable()
        lw.reset()


# ------------------------------------------- thread-lifecycle audit ----

def _stable_thread_count(fn, cycles=3):
    """Run fn() (open and close one subsystem) repeatedly; the thread
    count after each cycle returns to the baseline."""
    fn()
    baseline = threading.active_count()
    for _ in range(cycles):
        fn()
        deadline = time.time() + 5
        while threading.active_count() > baseline and time.time() < deadline:
            time.sleep(0.01)
        assert threading.active_count() <= baseline, (
            f"thread leak: {threading.active_count()} > {baseline} "
            f"({[t.name for t in threading.enumerate()]})")


def test_ui_server_close_joins_its_thread():
    from deeplearning4j_tpu_torch.ui.server import UiServer

    def cycle():
        srv = UiServer()
        srv.start(port=0)
        srv.stop()

    _stable_thread_count(cycle)


def test_tracker_server_shutdown_joins_its_thread():
    from deeplearning4j_tpu_torch.scaleout.remote_tracker import (
        StateTrackerClient, StateTrackerServer)

    def cycle():
        server = StateTrackerServer()
        client = StateTrackerClient(server.address,
                                    registry=MetricsRegistry())
        client.add_worker("w")
        client.close()
        server.shutdown()

    _stable_thread_count(cycle)


def test_memory_watermark_sampler_stop_joins():
    from deeplearning4j_tpu_torch.telemetry.xprofile import \
        MemoryWatermarkSampler

    def cycle():
        with MemoryWatermarkSampler(registry=MetricsRegistry(),
                                    interval_s=0.01):
            time.sleep(0.03)

    _stable_thread_count(cycle)


def test_async_checkpointer_close_joins(tmp_path):
    from deeplearning4j_tpu_torch.scaleout.ckpt import AsyncCheckpointer, \
        Checkpointer

    idx = [0]

    def cycle():
        idx[0] += 1
        with AsyncCheckpointer(Checkpointer(str(tmp_path / f"ck{idx[0]}"),
                                            registry=MetricsRegistry())):
            pass

    _stable_thread_count(cycle)


def test_engine_stop_is_idempotent_and_joins():
    from deeplearning4j_tpu_torch.models.transformer_lm import \
        init_lm_params
    from deeplearning4j_tpu_torch.serve.engine import DecodeEngine

    params = init_lm_params(torch.Generator().manual_seed(0), 31, 8, 2, 2,
                            16, n_layers=1, device="cpu")
    engine = DecodeEngine(params, 2, n_slots=2, max_len=16, serve_dtype=None,
                          registry=MetricsRegistry(), device="cpu")

    def cycle():
        engine.start()
        engine.generate([1, 2, 3], max_new_tokens=2)
        engine.stop()
        engine.stop()

    _stable_thread_count(cycle)
