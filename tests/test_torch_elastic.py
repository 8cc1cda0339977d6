"""The port's elastic parameter-averaging training
(deeplearning4j_tpu_torch/scaleout/elastic.py) held against the JAX
package's: tests/test_elastic.py through the port, plus parity with JAX.

Multi-process runs spawn REAL worker processes through the port's worker
CLI (``--device cpu``, ``_torch_dist_helpers:elastic_toy_model``: torch
and the port only) and compare the master's final params with the port's
``simulate_elastic`` (1e-6). Parity runs inject JAX's draws at the port's
two draw points (``init_params`` and ``_batch_for``) and hold
``run_steps``, ``simulate_elastic`` and ``eval_loss`` to 1e-5 of each
leaf's max; ``average_trees`` is bitwise JAX's; blobs load both ways; one
mixed cluster runs a JAX worker process against a port master (1e-6).

As in JAX's file, one kill smoke and the fault cases stay in tier-1 and
the wider matrix (kill after contributing, rejoin, staleness run-ahead,
cut frame mid-run) is ``slow``. Every subprocess wait has a timeout. The
lock-order watchdog's assertions (JAX's ``lockwatch`` fixture) wait for
ROADMAP item 21d.
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

import numpy as np
import pytest

import _dist_helpers
import _torch_dist_helpers
from deeplearning4j_tpu_torch._device import tree_leaves
from deeplearning4j_tpu_torch.optimize.updaters import OptimizerConfig
from deeplearning4j_tpu_torch.scaleout.elastic import (
    VERSION_KEY,
    ElasticMaster,
    ElasticTrainingError,
    ElasticWorker,
    SyntheticRegressionModel,
    _contrib_key,
    average_trees,
    simulate_elastic,
    tree_from_bytes,
    tree_to_bytes,
)
from deeplearning4j_tpu_torch.scaleout.remote_tracker import (
    StateTrackerClient,
    StateTrackerServer,
    TrackerUnavailable,
)
from deeplearning4j_tpu_torch.telemetry import trace as trace_mod
from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
if REPO not in sys.path:
    sys.path.insert(0, REPO)  # tools.trace_report import below

from tools.trace_report import build_timeline, load_trace_dir  # noqa: E402

SYNC = 3
TOY = dict(d_in=4, d_hidden=8, batch=8, lr=0.05)
REL = 1e-5  # port vs JAX: of each leaf's max


def _model(**kw):
    kw.setdefault("device", "cpu")
    return _torch_dist_helpers.elastic_toy_model(**kw)


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = (
        f"{REPO}{os.pathsep}{TESTS}{os.pathsep}" + env.get("PYTHONPATH", ""))
    return env


def _spawn_worker(address, blob_uri, worker_id, seed, sync_every=SYNC,
                  extra=()):
    cmd = [sys.executable, "-m", "deeplearning4j_tpu_torch.scaleout.elastic",
           "--connect", address, "--blob", blob_uri,
           "--model", "_torch_dist_helpers:elastic_toy_model",
           "--device", "cpu",
           "--worker-id", worker_id, "--worker-seed", str(seed),
           "--sync-every", str(sync_every), "--round-timeout-s", "90",
           *extra]
    return subprocess.Popen(cmd, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(procs, master, timeout=120):
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout))
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate())
    finally:
        master.shutdown()
    return outs


def _leaves(tree):
    return [np.asarray(tree[k]) for k in sorted(tree)]


def _assert_tree_close(a, b, atol, what):
    for la, lb in zip(_leaves(a), _leaves(b)):
        err = float(np.max(np.abs(la - lb)))
        assert err <= atol, f"{what}: leaf diff {err}"


def _assert_rel(got, want, what, rel=REL):
    """Each leaf within ``rel`` of the reference leaf's max."""
    assert sorted(got) == sorted(want)
    for k in sorted(want):
        g = got[k].detach().cpu().numpy() if isinstance(
            got[k], torch.Tensor) else np.asarray(got[k])
        w = np.asarray(want[k])
        err = float(np.max(np.abs(g - w)))
        assert err <= rel * max(float(np.max(np.abs(w))), 1e-30), \
            f"{what}: leaf {k} off by {err}"


def _bits_equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def _worker_summary(out: str, worker_id: str) -> dict:
    lines = [ln for ln in out.splitlines()
             if ln.startswith("ELASTIC_WORKER_DONE")]
    assert lines, f"no completion line from {worker_id}: {out[-500:]}"
    return json.loads(lines[-1].split(None, 1)[1])


def _threads(workers):
    ts = [threading.Thread(target=w.run, daemon=True) for w in workers]
    for t in ts:
        t.start()
    return ts


# ---------------------------------------------------- kill -9 mid-round ----

def test_elastic_kill_recover_smoke(tmp_path):
    """One of two REAL worker processes hard-exits mid-round (before
    publishing: its delta is unsynced), the master deregisters it on
    heartbeat staleness and commits every round on the survivor set.
    Final params match the survivor-set oracle to 1e-6 and
    ``workers_failed`` is 1. The forensics: the victim's write-ahead
    flight dump, its UNCLOSED round-0 spans, and a trace_report timeline
    over the port's span files of all three processes."""
    blob = f"file://{tmp_path / 'blob'}"
    trace_dir = str(tmp_path / "trace")
    prev = trace_mod.set_tracer(trace_mod.Tracer(
        "master", trace_dir=trace_dir, registry=MetricsRegistry()))
    try:
        master = ElasticMaster(_model(), blob, sync_every=SYNC,
                               min_workers=1, worker_timeout_s=2.0,
                               register_timeout_s=120, round_timeout_s=120)
        procs = [
            _spawn_worker(master.address, blob, "survivor", seed=1,
                          extra=["--trace-dir", trace_dir]),
            _spawn_worker(master.address, blob, "victim", seed=2,
                          extra=["--crash-at-round", "0",
                                 "--crash-after-steps", "1",
                                 "--trace-dir", trace_dir]),
        ]
        try:
            master.wait_for_workers(2)  # both registered before the kill
            final = master.train(rounds=3)
        finally:
            outs = _finish(procs, master)
    finally:
        trace_mod.set_tracer(prev)
    assert procs[1].returncode == 23, outs[1][1][-500:]  # the os._exit mark
    assert master.tracker.count("workers_failed") == 1
    assert "victim" not in master.tracker.workers()
    assert int(master.tracker.count(VERSION_KEY)) == 3
    ref, _ = simulate_elastic(_model(), [1], sync_every=SYNC, rounds=3)
    _assert_tree_close(final, ref, 1e-6, "survivor-set parity")
    assert procs[0].returncode == 0, outs[0][1][-500:]
    assert _worker_summary(outs[0][0], "survivor")["step"] == 3 * SYNC

    for proc_name in ("master", "survivor", "victim"):
        assert os.path.exists(
            os.path.join(trace_dir, f"spans_{proc_name}.jsonl")), proc_name
    victim_dump = os.path.join(trace_dir, "flightrec_victim.json")
    assert os.path.exists(victim_dump)
    assert json.load(open(victim_dump))["reason"] == "checkpoint"
    spans = load_trace_dir(trace_dir)
    victim_open = [sp for sp in spans.values()
                   if sp.get("process") == "victim"
                   and sp.get("status") == "open"]
    assert any(sp["name"] == "worker.round" for sp in victim_open), (
        f"got {[s['name'] for s in victim_open]}")
    timeline = build_timeline(spans)
    committed = [r for r in timeline["rounds"]
                 if r["status"] == "committed"]
    assert [r["round"] for r in committed] == [0, 1, 2]
    r0 = committed[0]
    assert [a["worker"] for a in r0["contributors"]] == ["survivor"]
    assert "victim:worker.round" in r0["open_spans"]
    assert r0["straggler"] == "survivor"
    master_rounds = {sp["span_id"] for sp in spans.values()
                     if sp["name"] == "elastic.round"}
    worker_rounds = [sp for sp in spans.values()
                     if sp["name"] == "worker.round"
                     and sp.get("process") == "survivor"]
    assert worker_rounds and all(
        sp.get("parent_id") in master_rounds for sp in worker_rounds)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "trace_report.py"),
         trace_dir, "--chrome", str(tmp_path / "chrome.json")],
        capture_output=True, text=True, timeout=60, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "victim:worker.round" in out.stdout
    chrome = json.load(open(tmp_path / "chrome.json"))
    assert len(chrome["traceEvents"]) > 10


@pytest.mark.slow
def test_elastic_kill_after_contributing_keeps_synced_work(tmp_path):
    """A worker that dies in round 1 loses ONLY its unsynced round-1
    delta; its round-0 contribution stays in the average."""
    blob = f"file://{tmp_path / 'blob'}"
    master = ElasticMaster(_model(), blob, sync_every=SYNC, min_workers=1,
                           worker_timeout_s=2.0, register_timeout_s=120,
                           round_timeout_s=120)
    procs = [
        _spawn_worker(master.address, blob, "survivor", seed=1),
        _spawn_worker(master.address, blob, "victim", seed=2,
                      extra=["--crash-at-round", "1",
                             "--crash-after-steps", "2"]),
    ]
    try:
        master.wait_for_workers(2)
        final = master.train(rounds=4)
    finally:
        outs = _finish(procs, master)
    assert procs[1].returncode == 23, outs[1][1][-500:]
    assert master.tracker.count("workers_failed") == 1
    ref, _ = simulate_elastic(
        _model(), [1, 2], sync_every=SYNC, rounds=4,
        schedule={0: [0, 1], 1: [0], 2: [0], 3: [0]})
    _assert_tree_close(final, ref, 1e-6, "synced-work-kept parity")


# ------------------------------------------------------------- rejoin ----

@pytest.mark.slow
def test_elastic_rejoin_readmitted_at_current_step(tmp_path):
    """A replacement worker that connects mid-run pulls the current
    params and step and is admitted from the current round; phase 2
    cannot commit a round without it."""
    blob = f"file://{tmp_path / 'blob'}"
    master = ElasticMaster(_model(), blob, sync_every=SYNC, min_workers=1,
                           worker_timeout_s=2.0, register_timeout_s=120,
                           round_timeout_s=120)
    procs = [
        _spawn_worker(master.address, blob, "original", seed=1),
        _spawn_worker(master.address, blob, "victim", seed=2,
                      extra=["--crash-at-round", "1"]),
    ]
    try:
        master.wait_for_workers(2)
        master.train(rounds=3, finish=False)  # phase 1: victim dies here
        assert master.tracker.count("workers_failed") == 1
        procs.append(_spawn_worker(master.address, blob, "replacement",
                                   seed=3))
        deadline = time.monotonic() + 90
        while "replacement" not in master.tracker.workers():
            assert time.monotonic() < deadline, "replacement never joined"
            time.sleep(0.05)
        master.train(rounds=3)  # phase 2: barriers now REQUIRE it
    finally:
        outs = _finish(procs, master)
    assert int(master.tracker.count(VERSION_KEY)) == 6
    summary = _worker_summary(outs[-1][0], "replacement")
    admit = int(master.tracker.count("admit.replacement"))
    assert admit == 3, admit
    assert summary["round"] >= admit
    assert summary["step"] == summary["round"] * SYNC
    assert master.tracker.count("elastic.joined") >= 1
    assert procs[-1].returncode == 0, outs[-1][1][-500:]
    for rnd in range(3, 6):
        assert master.tracker.count(f"contrib.{rnd}.replacement") > 0, rnd


# -------------------------------------------------- staleness run-ahead ----

@pytest.mark.slow
def test_elastic_staleness_runs_ahead_of_commits(tmp_path):
    """With ``max_staleness=2`` a worker publishes up to two rounds ahead
    of a master that commits nothing, then parks; then the run
    completes."""
    blob = f"file://{tmp_path / 'blob'}"
    master = ElasticMaster(_model(), blob, sync_every=2, min_workers=1,
                           worker_timeout_s=30.0, register_timeout_s=60,
                           round_timeout_s=90)
    worker = ElasticWorker(master.address, blob, _model(),
                           worker_id="stale", worker_seed=5, sync_every=2,
                           max_staleness=2, round_timeout_s=90)
    t = threading.Thread(target=worker.run, daemon=True)
    t.start()
    try:
        master.wait_for_workers(1)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if all(master.blob.try_get(_contrib_key(r, "stale")) is not None
                   for r in range(3)):
                break
            time.sleep(0.05)
        for r in range(3):
            assert master.blob.try_get(_contrib_key(r, "stale")) is not None
        time.sleep(0.5)
        assert master.blob.try_get(_contrib_key(3, "stale")) is None
        final = master.train(rounds=4)
        assert final is not None
    finally:
        master.shutdown()
    t.join(timeout=60)
    assert not t.is_alive(), "stale worker failed to finish"


# ------------------------------------------------------ numerical faults ----

def test_elastic_guarded_worker_skips_nan_batch(tmp_path):
    """A guarded worker hit by a NaN batch SKIPS the step (params carried,
    publish finite) and the run commits every round with parity against
    the oracle running the same guarded model."""

    def model():
        return SyntheticRegressionModel(**TOY, mesh_devices=1, guard=True,
                                        nan_at_step=3, nan_worker_seed=2,
                                        device="cpu")

    blob = f"file://{tmp_path / 'blob'}"
    master = ElasticMaster(model(), blob, sync_every=2, min_workers=2,
                           worker_timeout_s=30.0, register_timeout_s=60,
                           round_timeout_s=90)
    workers = [
        ElasticWorker(master.address, blob, model(), worker_id=f"w{s}",
                      worker_seed=s, sync_every=2, round_timeout_s=90)
        for s in (1, 2)
    ]
    threads = _threads(workers)
    try:
        master.wait_for_workers(2)
        final = master.train(rounds=3)
    finally:
        master.shutdown()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert workers[1].model.skipped_steps == 1
    assert workers[0].model.skipped_steps == 0
    assert master.tracker.count("workers_quarantined") == 0
    assert int(master.tracker.count(VERSION_KEY)) == 3
    ref, _ = simulate_elastic(model(), [1, 2], sync_every=2, rounds=3)
    _assert_tree_close(final, ref, 1e-6, "guarded-skip parity")


def test_elastic_quarantine_poisoned_contribution(tmp_path):
    """An UNGUARDED worker publishes a NaN-poisoned contribution: the
    master quarantines it BEFORE averaging (survivor parity 1e-6), the
    barrier stops waiting for it, and the forensic trail lands: the
    counter, the barrier span's ``nonfinite`` event, and a flight dump
    naming the poisoned leaves."""
    from deeplearning4j_tpu_torch.optimize.guardrails import tree_all_finite

    def model(**kw):
        return SyntheticRegressionModel(**TOY, mesh_devices=1,
                                        device="cpu", **kw)

    blob = f"file://{tmp_path / 'blob'}"
    trace_dir = str(tmp_path / "trace")
    # a long checkpoint interval keeps the round-commit write-ahead dumps
    # from overwriting the quarantine's "nonfinite" dump
    prev = trace_mod.set_tracer(trace_mod.Tracer(
        "master", trace_dir=trace_dir, registry=MetricsRegistry(),
        min_checkpoint_interval_s=3600.0))
    try:
        master = ElasticMaster(model(), blob, sync_every=2, min_workers=1,
                               worker_timeout_s=30.0, register_timeout_s=60,
                               round_timeout_s=90)
        clean = ElasticWorker(master.address, blob, model(),
                              worker_id="clean", worker_seed=1,
                              sync_every=2, round_timeout_s=90)
        poison = ElasticWorker(master.address, blob,
                               model(nan_at_step=2, nan_worker_seed=2),
                               worker_id="poison", worker_seed=2,
                               sync_every=2, round_timeout_s=90)
        threads = _threads((clean, poison))
        try:
            master.wait_for_workers(2)
            final = master.train(rounds=3)
        finally:
            master.shutdown()
        for t in threads:
            t.join(timeout=60)
    finally:
        trace_mod.set_tracer(prev)
    assert master.tracker.count("workers_quarantined") == 1
    assert "poison" in master._quarantined
    assert "poison" not in master.tracker.workers()
    assert int(master.tracker.count(VERSION_KEY)) == 3
    ref, _ = simulate_elastic(model(), [1, 2], sync_every=2, rounds=3,
                              schedule={0: [0, 1], 1: [0], 2: [0]})
    _assert_tree_close(final, ref, 1e-6, "quarantine survivor parity")
    assert tree_all_finite(final)
    spans = load_trace_dir(trace_dir)
    events = [ev for sp in spans.values()
              if sp["name"] == "elastic.barrier"
              for ev in sp.get("events", [])
              if ev.get("name") == "nonfinite"]
    assert any(ev.get("worker") == "poison" for ev in events), events
    dump = json.load(open(os.path.join(trace_dir,
                                       "flightrec_master.json")))
    assert dump["reason"] == "nonfinite"
    assert dump["extra"]["worker"] == "poison"
    assert dump["extra"]["poisoned_leaves"], dump["extra"]


# ----------------------------------------------------- min_workers halt ----

def test_elastic_min_workers_halts_below_quorum(tmp_path):
    """With ``min_workers=2`` the loss of one of two workers is a loud
    ElasticTrainingError; the master's flight recorder dumps on it and
    the failed barrier span records the burial."""
    blob = f"file://{tmp_path / 'blob'}"
    trace_dir = str(tmp_path / "trace")
    prev = trace_mod.set_tracer(trace_mod.Tracer(
        "master", trace_dir=trace_dir, registry=MetricsRegistry()))
    try:
        master = ElasticMaster(_model(), blob, sync_every=SYNC,
                               min_workers=2, worker_timeout_s=1.5,
                               register_timeout_s=120, round_timeout_s=60)
        procs = [
            _spawn_worker(master.address, blob, "w0", seed=1),
            _spawn_worker(master.address, blob, "crash", seed=2,
                          extra=["--crash-at-round", "0"]),
        ]
        try:
            master.wait_for_workers(2)
            with pytest.raises(ElasticTrainingError, match="min_workers"):
                master.train(rounds=4)
        finally:
            _finish(procs, master)
    finally:
        trace_mod.set_tracer(prev)
    assert master.tracker.count("workers_failed") == 1
    dump_path = os.path.join(trace_dir, "flightrec_master.json")
    assert os.path.exists(dump_path)
    dump = json.load(open(dump_path))
    assert dump["reason"] == "ElasticTrainingError"
    assert "min_workers" in dump["error"]
    spans = load_trace_dir(trace_dir)
    barriers = [sp for sp in spans.values()
                if sp["name"] == "elastic.barrier"]
    assert any(sp.get("status") == "error" for sp in barriers)
    assert any(ev.get("name") == "buried" and ev.get("worker") == "crash"
               for sp in barriers for ev in sp.get("events", []))


def test_master_crash_mid_merge_leaves_flight_dump(tmp_path):
    """A coordinator stuck in the port's ``merge_save`` barrier (one of
    two part manifests missing) is SIGTERMed: the crash hook dumps the
    flight recorder with the OPEN ``ckpt.merge_save`` span, trace_report
    reconstructs the partial merge, and nothing was committed."""
    import signal

    root = str(tmp_path / "ckpt")
    trace_dir = str(tmp_path / "trace")
    child_code = (
        "import sys\n"
        "import torch\n"
        "from deeplearning4j_tpu_torch.telemetry import trace as tr\n"
        "from deeplearning4j_tpu_torch.scaleout.ckpt import Checkpointer\n"
        "root, trace_dir = sys.argv[1], sys.argv[2]\n"
        "tr.configure('merge-master', trace_dir)\n"
        "ck = Checkpointer(root)\n"
        "ck.save_process(1, {'w': torch.arange(8.0)}, process_index=0)\n"
        "ck.merge_save(1, n_processes=2, timeout_s=120)\n"  # blocks
    )
    proc = subprocess.Popen(
        [sys.executable, "-c", child_code, root, trace_dir],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        span_file = os.path.join(trace_dir, "spans_merge-master.jsonl")
        deadline = time.monotonic() + 60
        while True:
            if os.path.exists(span_file) and \
                    "ckpt.merge_save" in open(span_file).read():
                break
            assert time.monotonic() < deadline, "merge span never started"
            assert proc.poll() is None, proc.communicate()[1][-800:]
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
    dump_path = os.path.join(trace_dir, "flightrec_merge-master.json")
    assert os.path.exists(dump_path)
    dump = json.load(open(dump_path))
    assert dump["reason"] == "SIGTERM"
    assert any(sp["name"] == "ckpt.merge_save" and sp.get("open")
               for sp in dump["open"])
    spans = load_trace_dir(trace_dir)
    merge = [sp for sp in spans.values()
             if sp["name"] == "ckpt.merge_save"][0]
    assert merge["status"] == "open"
    assert merge["attrs"]["n_processes"] == 2
    from deeplearning4j_tpu_torch.scaleout.ckpt import Checkpointer

    assert Checkpointer(root).latest_step() is None


# ------------------------------------------------------------ transport ----

def test_tracker_blackhole_times_out_as_unavailable():
    with StateTrackerServer() as server:
        with _dist_helpers.FaultyTrackerProxy(server.address,
                                              blackhole=True) as proxy:
            client = StateTrackerClient(proxy.address,
                                        request_timeout_s=0.3, retries=1,
                                        backoff_s=0.01,
                                        registry=MetricsRegistry())
            t0 = time.monotonic()
            with pytest.raises(TrackerUnavailable):
                client.workers()
            assert time.monotonic() - t0 < 5.0  # bounded, not forever
            client.close()


def test_tracker_reconnects_through_cut_frame():
    reg = MetricsRegistry()
    with StateTrackerServer() as server:
        with _dist_helpers.FaultyTrackerProxy(
                server.address, cut_response_after=2) as proxy:
            client = StateTrackerClient(proxy.address, request_timeout_s=5,
                                        retries=3, backoff_s=0.01,
                                        registry=reg)
            client.add_worker("w0")                 # exchange 1
            assert client.workers() == ["w0"]       # exchange 2
            assert client.workers() == ["w0"]       # cut → reconnect + retry
            assert proxy.cuts == 1
            assert reg.counter("tracker_reconnects_total").value >= 1
            assert reg.counter("tracker_retries_total").value >= 1
            client.close()


def test_tracker_delay_within_timeout_is_just_latency():
    with StateTrackerServer() as server:
        with _dist_helpers.FaultyTrackerProxy(server.address,
                                              delay_s=0.05) as proxy:
            client = StateTrackerClient(proxy.address, request_timeout_s=2,
                                        registry=MetricsRegistry())
            client.increment("k", 2.0)
            assert client.count("k") == 2.0
            client.close()


def test_tracker_non_idempotent_fails_fast_without_retry():
    reg = MetricsRegistry()
    server = StateTrackerServer()
    client = StateTrackerClient(server.address, request_timeout_s=0.5,
                                retries=2, backoff_s=0.01, registry=reg)
    server.shutdown()
    client._drop_socket()
    with pytest.raises(TrackerUnavailable):
        client.increment("jobs_done")
    assert reg.counter("tracker_retries_total").value == 0
    with pytest.raises(TrackerUnavailable):
        client.workers()
    assert reg.counter("tracker_retries_total").value >= 1
    client.close()


@pytest.mark.slow
def test_elastic_worker_survives_tracker_frame_cut(tmp_path):
    blob = f"file://{tmp_path / 'blob'}"
    master = ElasticMaster(_model(), blob, sync_every=SYNC, min_workers=1,
                           worker_timeout_s=30.0, register_timeout_s=60,
                           round_timeout_s=90)
    with _dist_helpers.FaultyTrackerProxy(master.address,
                                          cut_response_after=10) as proxy:
        worker = ElasticWorker(proxy.address, blob, _model(),
                               worker_id="wobbly", worker_seed=4,
                               sync_every=SYNC, round_timeout_s=90)
        t = threading.Thread(target=worker.run, daemon=True)
        t.start()
        try:
            master.wait_for_workers(1)
            final = master.train(rounds=4)
        finally:
            master.shutdown()
        t.join(timeout=60)
        assert not t.is_alive()
        assert proxy.cuts == 1
    ref, _ = simulate_elastic(_model(), [4], sync_every=SYNC, rounds=4)
    _assert_tree_close(final, ref, 1e-6, "parity through frame cut")


# -------------------------------------------------- checkpoint the run ----

def test_elastic_master_checkpoints_and_resumes(tmp_path):
    """The master snapshots averaged params through the async ckpt
    subsystem and a FRESH master resumes at the committed version, bit
    for bit."""
    from deeplearning4j_tpu_torch.scaleout.ckpt import (
        AsyncCheckpointer,
        Checkpointer,
    )

    blob = f"file://{tmp_path / 'blob'}"
    reg = MetricsRegistry()
    ck = AsyncCheckpointer(Checkpointer(str(tmp_path / "ckpt"), keep_last=3,
                                        registry=reg))
    master = ElasticMaster(_model(), blob, sync_every=SYNC, min_workers=1,
                           worker_timeout_s=30.0, register_timeout_s=60,
                           round_timeout_s=90, checkpointer=ck,
                           checkpoint_every=2)
    worker = ElasticWorker(master.address, blob, _model(), worker_id="w",
                           worker_seed=9, sync_every=SYNC, round_timeout_s=90)
    t = threading.Thread(target=worker.run, daemon=True)
    t.start()
    try:
        master.wait_for_workers(1)
        final = master.train(rounds=4)
    finally:
        master.shutdown()  # flushes pending async saves
    t.join(timeout=60)
    assert reg.counter("ckpt_async_saves_total").value >= 2
    assert reg.counter("ckpt_async_failures_total").value == 0

    blob2 = f"file://{tmp_path / 'blob2'}"
    master2 = ElasticMaster(_model(), blob2, sync_every=SYNC,
                            checkpointer=Checkpointer(
                                str(tmp_path / "ckpt"), registry=reg))
    try:
        assert master2.resume() == 4
        assert _bits_equal(master2.params(), final)
    finally:
        master2.shutdown()


# ------------------------------------------------------- parity with JAX ----

def _jax_model(**kw):
    from deeplearning4j_tpu.scaleout.elastic import (
        SyntheticRegressionModel as JModel,
    )

    d = dict(TOY, mesh_devices=1)
    d.update(kw)
    return JModel(**d)


def _inject(tm, jm):
    """JAX's init and batch stream at the port model's two draw points."""
    init = {k: np.asarray(v) for k, v in jm.init_params().items()}
    tm.init_params = lambda: {k: torch.from_numpy(v.copy())
                              for k, v in init.items()}
    tm._batch_for = jm._batch_for
    return tm


def _pair(**kw):
    jkw = {k: v for k, v in kw.items() if k != "optimizer"}
    opt = kw.get("optimizer")
    if isinstance(opt, OptimizerConfig):
        from deeplearning4j_tpu.optimize.updaters import (
            OptimizerConfig as JOpt,
        )

        jkw["optimizer"] = JOpt(name=opt.name,
                                update_sharding=opt.update_sharding)
    elif opt is not None:
        jkw["optimizer"] = opt
    jm = _jax_model(**jkw)
    tkw = dict(TOY, mesh_devices=jkw.get("mesh_devices", 1), device="cpu")
    tkw.update({k: v for k, v in kw.items() if k not in (
        "nan_at_step", "nan_worker_seed")})
    return _inject(SyntheticRegressionModel(**tkw), jm), jm


VARIANTS = {
    "sgd": dict(),
    "guard_clip": dict(guard=True, clip_norm=0.05),
    "guard_nan_skip": dict(guard=True, nan_at_step=3),
    "adam": dict(lr=1e-3, optimizer=OptimizerConfig(
        name="adam", update_sharding="replicated")),
    "adam_sharded": dict(lr=1e-3, mesh_devices=2, optimizer=OptimizerConfig(
        name="adam", update_sharding="sharded")),
    "guarded_adam": dict(lr=1e-3, guard=True, nan_at_step=3,
                         optimizer=OptimizerConfig(
                             name="adam", update_sharding="replicated")),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_run_steps_matches_jax(variant):
    """Two ``run_steps`` calls (3 steps, then 3 more: the moments carry
    across calls) from JAX's init on JAX's batches, params within 1e-5 of
    each leaf's max and losses 1e-5 relative; a ``nan_at_step`` batch is
    skipped on both sides with the port's params (and moments) bitwise
    unchanged over the step."""
    tm, jm = _pair(**VARIANTS[variant])
    tp, jp = tm.init_params(), jm.init_params()
    for start in (0, 3):
        if variant in ("guard_nan_skip", "guarded_adam") and start == 3:
            before = {k: v.copy() for k, v in tp.items()}
            # both moments and the step count
            state_before = [x.clone() for x in
                            tree_leaves(tm._opt_state or {})]
            tp, _ = tm.run_steps(tp, 3, 1, worker_seed=1)  # the NaN step
            jp, _ = jm.run_steps(jp, 3, 1, worker_seed=1)
            assert _bits_equal(tp, before)
            state_after = tree_leaves(tm._opt_state or {})
            assert len(state_before) == len(state_after)
            assert all(torch.equal(a, b)
                       for a, b in zip(state_before, state_after))
            tp, tl = tm.run_steps(tp, 4, 2, worker_seed=1)
            jp, jl = jm.run_steps(jp, 4, 2, worker_seed=1)
        else:
            tp, tl = tm.run_steps(tp, start, 3, worker_seed=1)
            jp, jl = jm.run_steps(jp, start, 3, worker_seed=1)
        _assert_rel(tp, jp, f"{variant} params after step {start + 3}")
        assert abs(tl - jl) <= REL * abs(jl), (variant, tl, jl)
    assert tm.skipped_steps == jm.skipped_steps
    if tm._opt_state is not None:
        jstate = jm._opt_state
        if variant == "adam_sharded":
            # ZeRO rows: the one-rank port row against JAX's gathered rows
            for k in tp:
                tm_m = tm._opt_state["m"][k].reshape(-1).numpy()
                jm_m = np.asarray(jstate["m"][k]).reshape(-1)[:tm_m.size]
                _assert_rel({k: tm_m}, {k: jm_m}, "sharded m")
        else:
            _assert_rel(tm._opt_state["m"],
                        {k: np.asarray(v) for k, v in jstate["m"].items()},
                        f"{variant} m")
            _assert_rel(tm._opt_state["v"],
                        {k: np.asarray(v) for k, v in jstate["v"].items()},
                        f"{variant} v")


def test_port_draws_are_a_function_of_seed_worker_and_step():
    """The port's own draws: equal across instances (and so processes),
    different across seeds, workers and steps; the knobs poison one
    element of one step."""
    a = SyntheticRegressionModel(**TOY, device="cpu")
    b = SyntheticRegressionModel(**TOY, device="cpu")
    c = SyntheticRegressionModel(**TOY, seed=1, device="cpu")
    assert _bits_equal(a.init_params(), b.init_params())
    assert not _bits_equal(a.init_params(), c.init_params())
    xa, ya = a._batch_for(3, 5)
    xb, yb = b._batch_for(3, 5)
    assert np.array_equal(xa, xb) and np.array_equal(ya, yb)
    assert not np.array_equal(xa, a._batch_for(4, 5)[0])
    assert not np.array_equal(xa, a._batch_for(3, 6)[0])
    assert xa.dtype == np.float32 and xa.shape == (8, 4)
    p = SyntheticRegressionModel(**TOY, nan_at_step=5, nan_worker_seed=3,
                                 device="cpu")
    assert int(np.isnan(p._batch_for(3, 5)[0]).sum()) == 1
    assert not np.isnan(p._batch_for(2, 5)[0]).any()
    # the profile= and runprof= seams (item 21a-ii) arm without raising
    # and change no number (tests/test_torch_runprof.py runs them)
    for kw in ({"profile": True}, {"runprof": False}):
        armed = SyntheticRegressionModel(**TOY, device="cpu", **kw)
        assert armed.step_profile is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SyntheticRegressionModel()


def test_simulate_elastic_with_kill_schedule_matches_jax():
    from deeplearning4j_tpu.scaleout.elastic import (
        simulate_elastic as jsim,
    )

    schedule = {0: [0, 1], 1: [0], 2: [0, 1]}
    tm, jm = _pair()
    tp, tl = simulate_elastic(tm, [1, 2], sync_every=SYNC, rounds=3,
                              schedule=schedule)
    jp, jl = jsim(jm, [1, 2], sync_every=SYNC, rounds=3, schedule=schedule)
    _assert_rel(tp, jp, "simulate_elastic")
    np.testing.assert_allclose(tl, jl, rtol=REL)


def test_average_trees_bitwise_equal_to_jax():
    from deeplearning4j_tpu.scaleout.elastic import (
        average_trees as javg,
    )

    rng = np.random.default_rng(0)
    trees = [{"w1": rng.standard_normal((4, 8)).astype(np.float32),
              "b1": rng.standard_normal(8).astype(np.float32),
              "w2": rng.standard_normal((8, 1)).astype(np.float32)}
             for _ in range(3)]
    weights = [3.0, 3.0, 2.0]
    got = average_trees(trees, weights)
    want = javg(trees, weights)
    for k in trees[0]:
        assert got[k].dtype == np.float32
        assert np.array_equal(got[k], np.asarray(want[k])), k
    # tensors average the same way
    got_t = average_trees([{k: torch.from_numpy(v) for k, v in t.items()}
                           for t in trees], weights)
    assert _bits_equal(got_t, got)
    with pytest.raises(ValueError, match="zero"):
        average_trees([], [])


def test_eval_loss_matches_jax():
    tm, jm = _pair()
    p = {k: np.asarray(v) for k, v in jm.init_params().items()}
    assert abs(tm.eval_loss(p) - jm.eval_loss(p)) <= REL * jm.eval_loss(p)


def test_blobs_load_both_ways():
    from deeplearning4j_tpu.scaleout.elastic import (
        tree_from_bytes as jfrom,
        tree_to_bytes as jto,
    )

    tm, jm = _pair()
    tp = tm.init_params()
    tree, meta = jfrom(tree_to_bytes(tp, {"round": 2}), jm.init_params())
    assert meta == {"round": 2}
    assert _bits_equal({k: np.asarray(v) for k, v in tree.items()},
                       {k: v.numpy() for k, v in tp.items()})
    tree, meta = tree_from_bytes(jto(jm.init_params(), {"step": 6}), tp)
    assert meta == {"step": 6}
    assert _bits_equal(tree, {k: v.numpy() for k, v in tp.items()})
    with pytest.raises(ValueError, match="mismatch"):
        tree_from_bytes(tree_to_bytes({"w1": tp["w1"]}), tp)


def test_mixed_cluster_port_master_jax_worker(tmp_path):
    """A port master (JAX's init injected) averages the rounds of one JAX
    worker process: after 2 rounds its params equal JAX's
    ``simulate_elastic`` for that worker within 1e-6."""
    from deeplearning4j_tpu.scaleout.elastic import (
        simulate_elastic as jsim,
    )

    tm, jm = _pair()
    blob = f"file://{tmp_path / 'blob'}"
    master = ElasticMaster(tm, blob, sync_every=SYNC, min_workers=1,
                           worker_timeout_s=30.0, register_timeout_s=120,
                           round_timeout_s=120)
    cmd = [sys.executable, "-m", "deeplearning4j_tpu.scaleout.elastic",
           "--connect", master.address, "--blob", blob,
           "--model", "_dist_helpers:elastic_toy_model",
           "--kwargs-json", json.dumps({"mesh_devices": 1}),
           "--worker-id", "jax-w", "--worker-seed", "7",
           "--sync-every", str(SYNC), "--round-timeout-s", "90"]
    proc = subprocess.Popen(cmd, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        master.wait_for_workers(1)
        final = master.train(rounds=2)
    finally:
        outs = _finish([proc], master)
    assert proc.returncode == 0, outs[0][1][-800:]
    ref, _ = jsim(jm, [7], sync_every=SYNC, rounds=2)
    _assert_tree_close(final, {k: np.asarray(v) for k, v in ref.items()},
                       1e-6, "mixed cluster")


# ---------------------------------------- the optimizer and live params ----

def test_elastic_adam_trains_and_is_deterministic():
    def run():
        model = SyntheticRegressionModel(
            **dict(TOY, lr=0.02), mesh_devices=2, device="cpu",
            optimizer=OptimizerConfig(name="adam", lr=1e-2,
                                      update_sharding="sharded"))
        p, loss = model.run_steps(model.init_params(), 0, 12, worker_seed=0)
        return p, loss, model.eval_loss(p)

    p1, l1, e1 = run()
    p2, l2, e2 = run()
    assert l1 == l2 and e1 == e2
    assert _bits_equal(p1, p2)
    sgd = SyntheticRegressionModel(**dict(TOY, lr=0.02), device="cpu")
    assert e1 < sgd.eval_loss(sgd.init_params())  # actually learned


def test_elastic_guarded_adam_skip_carries_moments():
    model = SyntheticRegressionModel(**dict(TOY, lr=0.01), mesh_devices=1,
                                     guard=True, nan_at_step=2,
                                     optimizer="adam", device="cpu")
    p0, _ = model.run_steps(model.init_params(), 0, 2, worker_seed=0)
    m_before = {k: v.clone() for k, v in model._opt_state["m"].items()}
    count_before = int(model._opt_state["count"])
    p1, _ = model.run_steps(p0, 2, 1, worker_seed=0)  # the NaN step
    assert model.skipped_steps == 1
    assert _bits_equal(p0, p1)
    assert all(torch.equal(m_before[k], model._opt_state["m"][k])
               for k in m_before)
    assert int(model._opt_state["count"]) == count_before


def test_elastic_run_steps_device_params_match_host_params():
    """Params already tensors on the model's device are used as they are;
    host arrays are moved once: the same trajectory, bitwise."""
    model = SyntheticRegressionModel(d_in=8, d_hidden=16, batch=16,
                                     device="cpu")
    p0 = model.init_params()
    host = {k: v.numpy().copy() for k, v in p0.items()}
    p_host, l_host = model.run_steps(host, 0, 3, worker_seed=1)
    p_dev, l_dev = model.run_steps(p0, 0, 3, worker_seed=1)
    assert l_host == l_dev
    assert _bits_equal(p_host, p_dev)


def test_step_replay_reproduces_a_port_bundle(tmp_path):
    """``tools/step_replay.py --factory deeplearning4j_tpu_torch.scaleout.
    elastic:synthetic_replay`` re-executes a port bundle's non-finite
    step."""
    from deeplearning4j_tpu_torch.optimize.guardrails import (
        dump_replay_bundle,
    )

    model = SyntheticRegressionModel(**TOY, mesh_devices=1, guard=True,
                                     nan_at_step=2, device="cpu")
    p, _ = model.run_steps(model.init_params(), 0, 2, worker_seed=0)
    x, y = model._batch_for(0, 2)
    path = dump_replay_bundle(
        str(tmp_path), 2, {"params": p, "batch": {"x": x, "y": y}}, {})
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "step_replay.py"),
         path, "--factory",
         "deeplearning4j_tpu_torch.scaleout.elastic:synthetic_replay",
         "--kwargs-json", json.dumps(dict(TOY, device="cpu")),
         "--expect-nonfinite", "--json"],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=_env())
    assert out.returncode == 0, out.stderr[-800:]
    rep = json.loads(out.stdout)
    assert rep["reproduced"] is True
    assert rep["result"]["loss"] == "nan"
    assert any(e["nonfinite"] for e in rep["forensics"])
