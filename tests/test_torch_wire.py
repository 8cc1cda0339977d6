"""The port's wire (deeplearning4j_tpu_torch: utils/netwatch.py,
scaleout/remote_tracker.py, distributed_runner.py, provision.py,
telemetry/federation.py) held against the JAX package's:
tests/test_netwatch.py, test_distributed_runner.py, test_provision.py
(without its slow multihost case) and test_federation.py (without its UI
and Prometheus cases, which wait for ROADMAP item 21c) through the port,
plus

- the frames across packages: a JAX ``StateTrackerClient`` against a
  port ``StateTrackerServer`` and the other way round, for membership,
  counters, KV rows, ``finish``/``is_done`` and a server-side error
  (a ``Job`` pickles by its package's class path, so jobs stay within
  one package);
- every provisioning command line equal to JAX's, string for string;
- ``merge_snapshots`` equal to JAX's on the same snapshots, and a JAX
  ``ClusterAggregator`` reading port pushers' rows over a port server.

Worker processes run ``python -m
deeplearning4j_tpu_torch.scaleout.distributed_runner --device cpu`` with
the factories of tests/_torch_dist_helpers.py; their output goes to a
file (a pipe nobody drains can block a chatty child), every wait has a
timeout and every process is killed in a ``finally``.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import json
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu.scaleout import remote_tracker as jrt
from deeplearning4j_tpu.scaleout import provision as jprov
from deeplearning4j_tpu.telemetry import federation as jfed
from deeplearning4j_tpu.telemetry.registry import \
    MetricsRegistry as JaxRegistry
from deeplearning4j_tpu_torch.scaleout import provision as tprov
from deeplearning4j_tpu_torch.scaleout.aggregator import \
    ParameterAveragingAggregator
from deeplearning4j_tpu_torch.scaleout.distributed_runner import (
    DistributedMaster,
    _host,
)
from deeplearning4j_tpu_torch.scaleout.job import (
    CollectionJobIterator,
    DataSetJobIterator,
    Job,
)
from deeplearning4j_tpu_torch.scaleout.remote_tracker import (
    _IDEMPOTENT,
    StateTrackerClient,
    StateTrackerServer,
    TrackerUnavailable,
)
from deeplearning4j_tpu_torch.scaleout.statetracker import \
    InMemoryStateTracker
from deeplearning4j_tpu_torch.scaleout.workrouter import (
    HogWildWorkRouter,
    IterativeReduceWorkRouter,
)
from deeplearning4j_tpu_torch.telemetry.federation import (
    ALERT_KV_PREFIX,
    KV_PREFIX,
    SCHEMA,
    ClusterAggregator,
    MetricsPusher,
    merge_snapshots,
)
from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry
from deeplearning4j_tpu_torch.utils import netwatch as nw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
PROC_TIMEOUT_S = 120


# ------------------------------------------------------------ netwatch ----

@pytest.fixture
def netwatch():
    nw.reset()
    nw.enable(default_timeout_s=0.5, watchdog_s=0.15,
              registry=MetricsRegistry())
    yield nw
    nw.disable()
    nw.reset()


def test_seam_hands_out_plain_socket_when_off():
    assert not nw.enabled()
    sock = nw.make_socket("off.ep")
    try:
        assert type(sock) is socket.socket
    finally:
        sock.close()


def test_wrap_is_identity_when_off():
    a, b = socket.socketpair()
    try:
        assert nw.wrap_socket(a, "off.ep") is a
    finally:
        a.close()
        b.close()


def test_seam_hands_out_watched_socket_when_armed(netwatch):
    sock = nw.make_socket("on.ep")
    try:
        assert isinstance(sock, nw.WatchedSocket)
    finally:
        sock.close()


def test_wrap_adopts_and_is_idempotent(netwatch):
    a, b = socket.socketpair()
    try:
        w = nw.wrap_socket(a, "wrap.ep")
        assert isinstance(w, nw.WatchedSocket)
        assert nw.wrap_socket(w, "wrap.ep") is w
    finally:
        a.close()
        b.close()


def test_env_var_arms_at_creation(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_NETWATCH", "1")
    try:
        sock = nw.make_socket("env.ep")
        try:
            assert isinstance(sock, nw.WatchedSocket)
            assert nw.enabled()
        finally:
            sock.close()
    finally:
        nw.disable()
        nw.reset()


def test_default_timeout_enforced_on_unset_socket(netwatch):
    a, b = socket.socketpair()
    w = nw.wrap_socket(a, "tracker.client")
    try:
        assert w.gettimeout() == 0.5  # enforced process default
        t0 = time.perf_counter()
        with pytest.raises(socket.timeout):
            w.recv(16)
        assert time.perf_counter() - t0 > 0.3
    finally:
        a.close()
        b.close()


def test_owner_timeout_wins_over_default(netwatch):
    a, b = socket.socketpair()
    w = nw.wrap_socket(a, "tracker.client")
    try:
        w.settimeout(0.1)
        assert w.gettimeout() == 0.1
        with pytest.raises(socket.timeout):
            w.recv(16)
    finally:
        a.close()
        b.close()


def test_data_flows_through_watched_pair(netwatch):
    a, b = socket.socketpair()
    wa = nw.wrap_socket(a, "pair.a")
    wb = nw.wrap_socket(b, "pair.b")
    try:
        wa.sendall(b"ping")
        assert wb.recv(16) == b"ping"
    finally:
        a.close()
        b.close()


def test_accept_wraps_returned_connection(netwatch):
    srv = nw.make_socket("srv.listener", socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    cli = socket.create_connection(srv.getsockname(), timeout=5)
    try:
        conn, _addr = srv.accept()
        assert isinstance(conn, nw.WatchedSocket)
        cli.sendall(b"hi")
        assert conn.recv(16) == b"hi"
        conn.close()
    finally:
        cli.close()
        srv.close()


def test_disable_quiesces_existing_wrappers(netwatch):
    a, b = socket.socketpair()
    w = nw.wrap_socket(a, "quiesce.ep")
    try:
        b.sendall(b"x")
        assert w.recv(1) == b"x"
        before = nw.summary()["endpoints"]["quiesce.ep"]["ops"]
        nw.disable()
        assert w.gettimeout() is None  # enforcement off with the watch
        b.sendall(b"y")
        assert w.recv(1) == b"y"  # still a working socket, no recording
        nw.enable(default_timeout_s=0.5, watchdog_s=0.15)
        assert nw.summary()["endpoints"]["quiesce.ep"]["ops"] == before
    finally:
        a.close()
        b.close()


def test_timeout_and_policy_counters_flow_through_registry():
    reg = MetricsRegistry()
    nw.reset()
    nw.enable(default_timeout_s=0.1, watchdog_s=5.0, registry=reg)
    try:
        a, b = socket.socketpair()
        w = nw.wrap_socket(a, "tracker.client")
        try:
            with pytest.raises(socket.timeout):
                w.recv(16)
        finally:
            a.close()
            b.close()
        nw.record_retry("tracker.client")
        nw.record_reconnect("tracker.client")
        labels = {"endpoint": "tracker.client"}
        assert reg.counter("netwatch_timeouts_total", labels).value == 1
        assert reg.counter("netwatch_retries_total", labels).value == 1
        assert reg.counter("netwatch_reconnects_total", labels).value == 1
        rec = nw.metrics_record()
        assert rec["netwatch_tracker_client_timeouts"] == 1
        assert rec["netwatch_tracker_client_retries"] == 1
        assert rec["netwatch_tracker_client_reconnects"] == 1
        assert rec["netwatch_tracker_client_wait_ms_max"] > 0
    finally:
        nw.disable()
        nw.reset()


def test_policy_hooks_are_noops_unarmed():
    nw.reset()
    assert not nw.enabled()
    nw.record_retry("never.ep")
    nw.record_reconnect("never.ep")
    assert nw.summary()["endpoints"] == {}


def test_stall_dumps_thread_stacks_through_flight_recorder(tmp_path):
    from deeplearning4j_tpu_torch.telemetry import trace as tr

    nw.reset()
    nw.enable(default_timeout_s=0.6, watchdog_s=0.15)
    tracer = tr.Tracer("netwatch-test", trace_dir=str(tmp_path),
                       registry=MetricsRegistry())
    prev = tr.set_tracer(tracer)
    try:
        a, b = socket.socketpair()
        w = nw.wrap_socket(a, "stuck.ep")
        got = []

        def reader():
            try:
                w.recv(16)
            except socket.timeout as exc:
                got.append(exc)

        t = threading.Thread(target=reader, name="the-reader")
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        a.close()
        b.close()
        assert len(got) == 1  # stall still times out after the dump
        assert nw.summary()["stall_dumps"] == 1  # one artifact per call
        dump_path = os.path.join(str(tmp_path),
                                 "flightrec_netwatch-test.json")
        payload = json.load(open(dump_path))
        assert payload["reason"] == "netwatch_stall"
        extra = payload["extra"]
        assert extra["netwatch"]["endpoint"] == "stuck.ep"
        assert extra["netwatch"]["op"] == "recv"
        assert any("the-reader" in k for k in extra["thread_stacks"])
    finally:
        tr.set_tracer(prev)
        tracer.close()
        nw.disable()
        nw.reset()


def test_tracker_client_reconnects_and_retries_under_the_watch():
    """A dropped client socket: the next idempotent call reconnects, and
    the reconnect lands in the client's registry and netwatch's."""
    reg = MetricsRegistry()
    nw.reset()
    nw.enable(default_timeout_s=5.0, watchdog_s=5.0, registry=reg)
    try:
        with StateTrackerServer() as server:
            client = StateTrackerClient(server.address, registry=reg)
            assert isinstance(client._sock, nw.WatchedSocket)
            client.add_worker("w0")
            client._drop_socket()
            assert client.workers() == ["w0"]
            assert reg.counter("tracker_reconnects_total").value == 1
            assert nw.summary()["endpoints"]["tracker.client"][
                "reconnects"] == 1
            client.close()
    finally:
        nw.disable()
        nw.reset()


# ------------------------------------------------------- remote tracker ----

def test_remote_tracker_contract_roundtrip():
    with StateTrackerServer() as server:
        client = StateTrackerClient(server.address)
        client.add_worker("w0")
        assert server.tracker.workers() == ["w0"]  # embedded side sees it
        job = Job(np.arange(3), "w0")
        job.result = np.ones(3)
        client.add_job(job)
        got = client.job_for("w0")
        np.testing.assert_array_equal(got.result, np.ones(3))
        client.increment("n", 2.5)
        assert client.count("n") == 2.5
        client.set_current(np.full(4, 7.0))
        np.testing.assert_array_equal(client.get_current(), np.full(4, 7.0))
        client.add_replicate("w0")
        assert client.needs_replicate("w0")
        client.done_replicating("w0")
        assert not client.needs_replicate("w0")
        client.set_best_loss(0.5)
        assert client.best_loss() == 0.5
        assert not client.is_early_stop()
        client.early_stop()
        assert client.is_early_stop()
        client.close()


def test_remote_clear_updates_never_drops_newer_snapshot():
    """Clearing an old snapshot keeps an update published after the
    snapshot was taken (the versioned compare-and-delete)."""
    with StateTrackerServer() as server:
        client = StateTrackerClient(server.address)
        j1 = Job("a", "w0")
        j1.result = np.asarray([1.0])
        client.add_update("w0", j1)
        snap = client.updates()
        j2 = Job("b", "w0")
        j2.result = np.asarray([2.0])
        client.add_update("w0", j2)
        client.clear_updates(snap)
        survivors = client.updates()
        assert "w0" in survivors, "newer unseen update was dropped"
        assert float(survivors["w0"].result[0]) == 2.0
        client.clear_updates(survivors)
        assert client.updates() == {}
        # a dict the client did not hand out clears nothing
        client.add_update("w0", j1)
        client.clear_updates({"w0": j1})
        assert "w0" in client.updates()
        client.close()


def test_dead_client_cannot_pin_handler_thread():
    """A client that connects and goes silent does not hold its handler
    thread forever: the handler socket's timeout bounds the recv."""
    server = StateTrackerServer(handler_timeout_s=0.3)
    try:
        baseline = threading.active_count()
        raw = socket.create_connection((server.host, server.port),
                                       timeout=5)
        raw.sendall(b"\x00")  # partial frame header, then silence
        deadline = time.time() + 5
        grew = False
        while time.time() < deadline:
            if threading.active_count() > baseline:
                grew = True
                break
            time.sleep(0.01)
        assert grew, "handler thread never started"
        deadline = time.time() + 10
        while threading.active_count() > baseline and time.time() < deadline:
            time.sleep(0.02)
        assert threading.active_count() <= baseline, (
            [t.name for t in threading.enumerate()])
        raw.close()
        client = StateTrackerClient(server.address)
        client.add_worker("alive")
        assert client.workers() == ["alive"]
        client.close()
    finally:
        server.shutdown()


def test_unclassified_rpc_method_is_rejected():
    with StateTrackerServer() as server:
        client = StateTrackerClient(server.address)
        try:
            with pytest.raises(ValueError, match="idempotency"):
                client._call("definitely_not_classified")
        finally:
            client.close()


def test_classification_and_defaults_equal_jax():
    """The retry policy's method sets, the frame header and the
    loopback default bind are JAX's."""
    from deeplearning4j_tpu_torch.scaleout import remote_tracker as trt

    assert trt._IDEMPOTENT == jrt._IDEMPOTENT
    assert trt._NONIDEMPOTENT == jrt._NONIDEMPOTENT
    assert trt._UNTRACED_POLLS == jrt._UNTRACED_POLLS
    assert (trt._HDR.format, trt._MAX_FRAME) == (jrt._HDR.format,
                                                 jrt._MAX_FRAME)
    with StateTrackerServer() as server:
        assert server.host == "127.0.0.1"


def test_unreachable_tracker_raises_tracker_unavailable():
    """A server that went away: idempotent calls retry, then surface
    TrackerUnavailable (a ConnectionError), counted as a failure."""
    server = StateTrackerServer()
    reg = MetricsRegistry()
    client = StateTrackerClient(server.address, retries=2, backoff_s=0.01,
                                registry=reg)
    server.shutdown()
    client._drop_socket()
    try:
        with pytest.raises(TrackerUnavailable):
            client.workers()
        assert reg.counter("tracker_retries_total").value == 2
        assert reg.counter("tracker_failures_total").value == 1
        with pytest.raises(ConnectionError):
            client.increment("x")  # non-idempotent: one attempt
        assert reg.counter("tracker_retries_total").value == 2
    finally:
        client.close()


def test_host_moves_job_tensors_to_the_cpu():
    job = Job({"x": torch.ones(2), "y": [torch.zeros(1), 3]}, "w0")
    job.result = (torch.arange(3.0), np.ones(2))
    out = _host(job)
    assert out is job
    assert job.work["x"].device.type == "cpu" and job.work["y"][1] == 3
    assert isinstance(job.result, tuple) and job.result[1].shape == (2,)


# ----------------------------------------------- the frames across packages ----

def _drive_membership_counters_kv(client, embedded):
    client.add_worker("w0")
    client.add_worker("w1")
    assert client.workers() == ["w0", "w1"]
    assert embedded.workers() == ["w0", "w1"]
    client.remove_worker("w1")
    assert client.workers() == ["w0"]
    client.increment("hb.w0")
    client.increment("hb.w0", 2.5)
    assert client.count("hb.w0") == 3.5
    assert client.counters_snapshot("hb.") == {"hb.w0": 3.5}
    row = json.dumps({"replica_id": "w0", "queue_depth": 2})
    client.put_kv("fleet.load.w0", row)
    client.put_kv("fleet.load.w0", row)  # last write wins
    client.put_kv("other.key", "x")
    assert client.get_kv("fleet.load.w0") == row
    assert client.get_kv("missing", "dflt") == "dflt"
    assert client.kv_snapshot("fleet.load.") == {"fleet.load.w0": row}
    assert embedded.get_kv("other.key") == "x"
    client.set_best_loss(0.25)
    assert client.best_loss() == 0.25
    assert not client.is_done()
    client.finish()
    assert client.is_done() and embedded.is_done()
    # a server-side error crosses as the exception it is
    with pytest.raises(TypeError):
        client._call("count")  # missing argument, raised by the server


def test_jax_client_against_port_server():
    with StateTrackerServer() as server:
        client = jrt.StateTrackerClient(server.address,
                                        registry=JaxRegistry())
        try:
            _drive_membership_counters_kv(client, server.tracker)
        finally:
            client.close()


def test_port_client_against_jax_server():
    with jrt.StateTrackerServer() as server:
        client = StateTrackerClient(server.address)
        try:
            _drive_membership_counters_kv(client, server.tracker)
        finally:
            client.close()


def test_frames_are_byte_identical_across_packages():
    """The same (method, args, kwargs) request frame from either
    package's ``_send_frame``, byte for byte."""
    from deeplearning4j_tpu_torch.scaleout import remote_tracker as trt

    frames = []
    for send in (jrt._send_frame, trt._send_frame):
        a, b = socket.socketpair()
        try:
            send(a, ("put_kv", ("fleet.load.r1", '{"q": 1}'), {}))
            a.close()
            buf = b""
            while True:
                chunk = b.recv(4096)
                if not chunk:
                    break
                buf += chunk
            frames.append(buf)
        finally:
            b.close()
    assert frames[0] == frames[1]


# ---------------------------------------------- worker processes (CPU) ----

def _spawn_worker(address, performer, log_dir, kwargs=None, worker_id=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = (
        f"{REPO}{os.pathsep}{TESTS}{os.pathsep}" + env.get("PYTHONPATH", ""))
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m",
           "deeplearning4j_tpu_torch.scaleout.distributed_runner",
           "--connect", address, "--performer", performer,
           "--device", "cpu"]
    if kwargs:
        cmd += ["--kwargs-json", json.dumps(kwargs)]
    if worker_id:
        cmd += ["--worker-id", worker_id]
    out = open(os.path.join(log_dir, f"{worker_id or 'worker'}.log"), "w+")
    proc = subprocess.Popen(cmd, env=env, stdout=out,
                            stderr=subprocess.STDOUT, text=True)
    proc.log = out
    return proc


def _finish(procs, master, timeout=PROC_TIMEOUT_S):
    """Wait for every worker (killed past ``timeout``), stop the master,
    and return each worker's output."""
    outs = []
    try:
        for p in procs:
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
            p.log.seek(0)
            outs.append(p.log.read()[-2000:])
            p.log.close()
        master.shutdown()
    return outs


def _iris_conf_json():
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration

    return (NeuralNetConfiguration.Builder()
            .n_in(4).n_out(8).activation_function("tanh")
            .lr(0.1).momentum(0.9).num_iterations(25).seed(42)
            .list(2)
            .override(1, layer_type="OUTPUT", n_in=8, n_out=3,
                      activation_function="softmax", loss_function="MCXENT")
            .pretrain(False).backward(True)
            .build()
            .to_json())


@pytest.mark.parametrize("router_cls", [IterativeReduceWorkRouter,
                                        HogWildWorkRouter])
def test_two_process_training_converges(router_cls, tmp_path):
    """Iris training across two worker PROCESSES under both routers: the
    master aggregates parameter averages published over TCP and the final
    model classifies Iris."""
    from deeplearning4j_tpu_torch.datasets.impl import IrisDataSetIterator
    from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf_json = _iris_conf_json()
    master = DistributedMaster(
        job_iterator=DataSetJobIterator(IrisDataSetIterator(30, 150)),
        min_workers=2, max_rounds=6, register_timeout_s=PROC_TIMEOUT_S)
    master.router = router_cls(master.tracker, ParameterAveragingAggregator())
    procs = [_spawn_worker(master.address, "_torch_dist_helpers:iris_performer",
                           str(tmp_path), {"conf_json": conf_json},
                           worker_id=f"w{i}")
             for i in range(2)]
    try:
        params = master.train()
    finally:
        outs = _finish(procs, master)
    assert params is not None, outs
    assert master.tracker.count("aggregations") >= 1
    assert master.tracker.count("jobs_done") >= 5
    for i in range(2):
        assert master.tracker.count(f"rounds.w{i}") >= 1, (i, outs)
    for p in procs:
        assert p.returncode == 0, outs
    net = MultiLayerNetwork.from_json(conf_json, device="cpu")
    net.init()
    net.set_params(params)
    ds = IrisDataSetIterator(150, 150).next()
    ev = Evaluation()
    ev.eval(ds.get_labels(), net.output(ds.get_feature_matrix()))
    assert ev.accuracy() > 0.6, ev.accuracy()


def test_early_stopping_trips_across_processes(tmp_path):
    """The in-process runner's EarlyStopping stops a cross-process run:
    non-improving scores over TCP trip tracker.early_stop() before the
    job iterator drains, and the workers exit on the flag."""
    from deeplearning4j_tpu_torch.scaleout.runner import EarlyStopping

    items = [7.0] * 400
    master = DistributedMaster(
        job_iterator=CollectionJobIterator(items),
        min_workers=2, max_rounds=200, register_timeout_s=PROC_TIMEOUT_S,
        early_stopping=EarlyStopping(patience=2))
    master.router = HogWildWorkRouter(master.tracker,
                                      ParameterAveragingAggregator())
    procs = [_spawn_worker(master.address,
                           "_torch_dist_helpers:averaging_performer",
                           str(tmp_path), worker_id=f"w{i}")
             for i in range(2)]
    try:
        params = master.train()
    finally:
        outs = _finish(procs, master)
    assert master.tracker.is_early_stop(), outs
    assert master.tracker.count("jobs_done") < len(items)
    assert params is not None
    for p in procs:
        assert p.returncode == 0, (p.returncode, outs)


def test_worker_process_crash_is_recovered(tmp_path):
    """One worker hard-crashes (os._exit mid-perform): the master's
    heartbeat watchdog requeues its job onto the survivor and the run
    completes every job."""
    master = DistributedMaster(
        job_iterator=CollectionJobIterator([1, 2, 3, 4, 5, 6]),
        min_workers=2, max_rounds=6, worker_timeout_s=3.0,
        register_timeout_s=PROC_TIMEOUT_S)
    master.router = HogWildWorkRouter(master.tracker,
                                      ParameterAveragingAggregator())
    procs = [
        _spawn_worker(master.address, "_torch_dist_helpers:crashing_performer",
                      str(tmp_path), worker_id="crasher"),
        _spawn_worker(master.address,
                      "_torch_dist_helpers:averaging_performer",
                      str(tmp_path), worker_id="survivor"),
    ]
    try:
        params = master.train()
    finally:
        outs = _finish(procs, master)
    assert params is not None
    assert master.tracker.count("workers_failed") == 1
    assert master.tracker.count("jobs_done") >= 6, outs
    assert master.tracker.count("rounds.survivor") >= 6
    assert procs[0].returncode == 17  # the os._exit marker
    assert "crasher" not in master.tracker.workers()


def test_worker_cli_device_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: --device cuda is valid here")
    from deeplearning4j_tpu_torch.scaleout.distributed_runner import \
        worker_main

    with pytest.raises(RuntimeError, match="CUDA"):
        worker_main(["--connect", "127.0.0.1:1", "--performer",
                     "_torch_dist_helpers:averaging_performer"])


# --------------------------------------------------------- provisioning ----

class RecordingRunner:
    def __init__(self, code: int = 0, out: str = "ok"):
        self.calls = []
        self.code = code
        self.out = out

    def __call__(self, argv):
        self.calls.append(list(argv))
        return self.code, self.out


def test_create_command():
    spec = tprov.TpuPodSpec(name="pod1", accelerator_type="v5litepod-8",
                            zone="us-east5-b", project="proj",
                            labels={"team": "ml", "env": "dev"})
    cmd = tprov.TpuPodCreator(spec).create_command()
    assert cmd[:5] == ["gcloud", "compute", "tpus", "tpu-vm", "create"]
    assert "pod1" in cmd and "--zone=us-east5-b" in cmd
    assert "--project=proj" in cmd
    assert "--accelerator-type=v5litepod-8" in cmd
    assert "--labels=env=dev,team=ml" in cmd


def test_lifecycle_through_runner():
    rec = RecordingRunner()
    creator = tprov.TpuPodCreator(tprov.TpuPodSpec(name="p"), runner=rec)
    creator.create()
    creator.destroy()
    assert rec.calls[0][4] == "create"
    assert rec.calls[1][4] == "delete" and "--quiet" in rec.calls[1]


def test_run_remote_command():
    rec = RecordingRunner()
    tprov.HostProvisioner("pod", worker=3, runner=rec).run_remote_command(
        "ls /tmp")
    argv = rec.calls[0]
    assert "ssh" in argv and "--worker=3" in argv
    assert "--command=ls /tmp" in argv


def test_upload_and_run():
    rec = RecordingRunner()
    tprov.HostProvisioner("pod", runner=rec).upload_and_run(
        "/local/setup.sh", "/srv")
    assert "scp" in rec.calls[0] and "pod:/srv" in rec.calls[0]
    assert any("bash setup.sh" in a for a in rec.calls[1])


def test_upload_failure_short_circuits():
    rec = RecordingRunner(code=1, out="denied")
    code, _ = tprov.HostProvisioner("pod", runner=rec).upload_and_run("s.sh")
    assert code == 1 and len(rec.calls) == 1


def test_exec_provisions_and_launches_every_host():
    rec = RecordingRunner()
    setup = tprov.ClusterSetup(tprov.TpuPodSpec(name="pod", num_hosts=4),
                               ["python", "train.py", "--conf", "c.json"],
                               runner=rec)
    results = setup.exec("/local/setup.sh", coordinator_host="10.0.0.2")
    assert len(results) == 8
    launches = [c for c in rec.calls
                if any("DL4J_PROCESS_ID" in a for a in c)]
    assert len(launches) == 4
    cmd0 = next(a for a in launches[0] if "DL4J_PROCESS_ID" in a)
    assert "DL4J_COORDINATOR=10.0.0.2:8476" in cmd0
    assert "DL4J_NUM_PROCESSES=4" in cmd0
    assert "python train.py --conf c.json" in cmd0


def test_distinct_process_ids():
    rec = RecordingRunner()
    tprov.ClusterSetup(tprov.TpuPodSpec(num_hosts=2), ["run"],
                       runner=rec).exec("s.sh")
    ids = set()
    for call in rec.calls:
        for a in call:
            if "DL4J_PROCESS_ID=" in a:
                ids.add(a.split("DL4J_PROCESS_ID=")[1].split()[0])
    assert ids == {"0", "1"}


def test_tilde_root_dir_not_quoted():
    rec = RecordingRunner()
    tprov.HostProvisioner("pod", runner=rec).upload_and_run("/local/s.sh")
    cmd = next(a for a in rec.calls[1] if a.startswith("--command="))
    assert "cd ~ &&" in cmd and "'~'" not in cmd


def test_exec_aborts_when_provisioning_fails():
    rec = RecordingRunner(code=1, out="boom")
    setup = tprov.ClusterSetup(tprov.TpuPodSpec(num_hosts=2), ["run"],
                               runner=rec)
    with pytest.raises(RuntimeError, match="provisioning failed"):
        setup.exec("s.sh")
    assert not any("DL4J_PROCESS_ID" in a for c in rec.calls for a in c)


def _provision_lines(prov):
    """Every command line ``prov`` generates, in one list."""
    rec = RecordingRunner()
    spec = prov.TpuPodSpec(name="pod-x", accelerator_type="v5litepod-16",
                           zone="europe-west4-a", project="p-1",
                           runtime_version="rt", num_hosts=3,
                           labels={"b": "2", "a": "1"})
    creator = prov.TpuPodCreator(spec, runner=rec)
    lines = [creator.create_command(), creator.delete_command(),
             creator.describe_command()]
    creator.create()
    creator.destroy()
    for root in ("~", "~/work dir", "/srv/x y"):
        prov.HostProvisioner("pod-x", worker=2, zone="z", project="p",
                             runner=rec).upload_and_run("/s/set up.sh", root)
    setup = prov.ClusterSetup(spec, ["python", "-m", "train", "--a b"],
                              coordinator_port=9999, runner=rec)
    lines += [[setup.launch_command(i, "10.1.2.3")] for i in range(3)]
    setup.exec("/s/setup.sh", coordinator_host="h")
    return lines + sorted(rec.calls)


def test_command_lines_equal_jax():
    assert _provision_lines(tprov) == _provision_lines(jprov)


def test_launch_command_env_is_what_multihost_reads(monkeypatch):
    """The launch line's env, put in the environment, is what the port's
    ``multihost.initialize`` reads (coordinator, world size, rank)."""
    from deeplearning4j_tpu_torch.parallel import multihost

    line = tprov.ClusterSetup(tprov.TpuPodSpec(num_hosts=2), ["run"],
                              coordinator_port=7777).launch_command(
        1, "127.0.0.1")
    env = dict(kv.split("=", 1) for kv in line.split()[:3])
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = {}
    monkeypatch.setattr(multihost, "_initialized", False)
    monkeypatch.setattr(
        multihost.dist, "init_process_group",
        lambda backend, init_method, world_size, rank:
        seen.update(backend=backend, init=init_method, world=world_size,
                    rank=rank))
    try:
        multihost.initialize(device="cpu")
    finally:
        monkeypatch.setattr(multihost, "_initialized", False)
    assert seen == {"backend": "gloo", "init": "tcp://127.0.0.1:7777",
                    "world": 2, "rank": 1}


# ------------------------------------------------------------ federation ----

def _registry(n_reqs: int, queue_depth: float, obs) -> MetricsRegistry:
    reg = MetricsRegistry()
    reg.counter("serve_requests_total").inc(n_reqs)
    reg.counter("serve_completed_total", {"reason": "eos"}).inc(n_reqs)
    reg.gauge("serve_queue_depth").set(queue_depth)
    for v in obs:
        reg.histogram("serve_request_ms").observe(v)
    return reg


def test_counters_sum_per_name_and_labels():
    a, b = _registry(3, 0, []), _registry(4, 0, [])
    b.counter("serve_requests_total").inc(10)
    merged = merge_snapshots([("a", a.snapshot()), ("b", b.snapshot())])
    rows = {(r["name"], tuple(sorted(r["labels"].items()))): r["value"]
            for r in merged["counters"]}
    assert rows[("serve_requests_total", ())] == 17.0
    assert rows[("serve_completed_total", (("reason", "eos"),))] == 7.0


def test_gauges_stay_per_process():
    a, b = _registry(0, 2.0, []), _registry(0, 7.0, [])
    merged = merge_snapshots([("a", a.snapshot()), ("b", b.snapshot())])
    rows = {(r["name"], r["labels"].get("process")): r["value"]
            for r in merged["gauges"]}
    assert rows[("serve_queue_depth", "a")] == 2.0
    assert rows[("serve_queue_depth", "b")] == 7.0


def test_histograms_bucket_merge_exact_on_identical_bounds():
    a = _registry(0, 0, [3.0, 40.0])
    b = _registry(0, 0, [700.0])
    merged = merge_snapshots([("a", a.snapshot()), ("b", b.snapshot())])
    h = [r for r in merged["histograms"] if r["name"] == "serve_request_ms"][0]
    assert h["count"] == 3 and h["sum"] == 743.0
    by_le = {x["le"]: x["count"] for x in h["buckets"]}
    assert by_le[5.0] == 1 and by_le[50.0] == 2
    assert by_le[1000.0] == 3 and by_le[float("inf")] == 3


def test_histogram_union_bounds_lower_bound_semantics():
    a, b = MetricsRegistry(), MetricsRegistry()
    ha = a.histogram("m", buckets=(10.0, 100.0))
    hb = b.histogram("m", buckets=(50.0,))
    ha.observe(5.0), ha.observe(60.0)
    hb.observe(20.0)
    merged = merge_snapshots([("a", a.snapshot()), ("b", b.snapshot())])
    h = merged["histograms"][0]
    by_le = {x["le"]: x["count"] for x in h["buckets"]}
    assert by_le[10.0] == 1 and by_le[50.0] == 2 and by_le[100.0] == 3
    assert h["count"] == 3 and h["sum"] == 85.0


def test_empty_merge():
    assert merge_snapshots([]) == {"counters": [], "gauges": [],
                                   "histograms": []}


def test_merge_equals_jax_merge():
    a = _registry(3, 2.0, [3.0, 40.0])
    b = _registry(4, 7.0, [700.0])
    a.histogram("m", buckets=(10.0, 100.0)).observe(60.0)
    b.histogram("m", buckets=(50.0,)).observe(20.0)
    named = [("a", a.snapshot()), ("b", b.snapshot())]
    assert merge_snapshots(named) == jfed.merge_snapshots(named)
    assert (SCHEMA, KV_PREFIX) == (jfed.SCHEMA, jfed.KV_PREFIX)


def test_two_live_pushed_registries_merge_and_staleness():
    with StateTrackerServer() as server:
        c1 = StateTrackerClient(server.address)
        c2 = StateTrackerClient(server.address)
        r1 = _registry(3, 2.0, [3.0])
        r2 = _registry(4, 7.0, [700.0])
        p1 = MetricsPusher(c1, "replica-0", registry=r1)
        p2 = MetricsPusher(c2, "replica-1", registry=r2)
        assert p1.push_once() and p2.push_once()
        agg = ClusterAggregator(server.tracker, stale_after_s=0.3,
                                registry=MetricsRegistry())
        view = agg.collect()
        assert view["schema"] == SCHEMA
        procs = {p["process"]: p for p in view["processes"]}
        assert sorted(procs) == ["replica-0", "replica-1"]
        assert not any(p["stale"] for p in procs.values())
        counters = {r["name"]: r["value"] for r in view["merged"]["counters"]
                    if not r["labels"]}
        assert counters["serve_requests_total"] == 7.0
        assert p1.push_once()
        counters2 = {r["name"]: r["value"]
                     for r in agg.collect()["merged"]["counters"]
                     if not r["labels"]}
        assert counters2["federation_pushes_total"] == 1.0
        h = [r for r in view["merged"]["histograms"]
             if r["name"] == "serve_request_ms"][0]
        assert h["count"] == 2 and h["sum"] == 703.0
        time.sleep(0.35)
        p2.push_once()
        view = agg.collect()
        procs = {p["process"]: p for p in view["processes"]}
        assert procs["replica-0"]["stale"] is True
        assert procs["replica-1"]["stale"] is False
        counters = {r["name"]: r["value"] for r in view["merged"]["counters"]
                    if not r["labels"]}
        assert counters["serve_requests_total"] == 7.0
        assert agg.registry.gauge("federation_stale_processes").value == 1.0
        rec = agg.metrics_record()
        assert rec["federation_collects_total"] == 3.0
        assert rec["federation_processes"] == 2.0
        snap = agg.prometheus_snapshot()
        up = {g["labels"]["process"]: g["value"] for g in snap["gauges"]
              if g["name"] == "federation_process_up"}
        assert up == {"replica-0": 0.0, "replica-1": 1.0}
        c1.close(), c2.close()


def test_jax_aggregator_reads_port_pushers_over_a_port_server():
    with StateTrackerServer() as server:
        client = StateTrackerClient(server.address)
        MetricsPusher(client, "port-0",
                      registry=_registry(3, 2.0, [3.0])).push_once()
        MetricsPusher(client, "port-1",
                      registry=_registry(4, 7.0, [700.0])).push_once()
        jclient = jrt.StateTrackerClient(server.address,
                                         registry=JaxRegistry())
        try:
            jview = jfed.ClusterAggregator(
                jclient, registry=JaxRegistry()).collect()
            tview = ClusterAggregator(client,
                                      registry=MetricsRegistry()).collect()
        finally:
            jclient.close()
            client.close()
    assert [p["process"] for p in jview["processes"]] == ["port-0", "port-1"]
    assert jview["merged"] == tview["merged"]


def test_pusher_background_thread_cadence_and_clean_stop():
    tracker = InMemoryStateTracker()
    reg = MetricsRegistry()
    reg.counter("serve_tokens_total").inc(5)
    before = threading.active_count()
    pusher = MetricsPusher(tracker, "bg", registry=reg, interval_s=0.02)
    with pusher:
        deadline = time.time() + 5.0
        while (reg.counter("federation_pushes_total").value < 3
               and time.time() < deadline):
            time.sleep(0.01)
    assert reg.counter("federation_pushes_total").value >= 3
    assert threading.active_count() == before
    payload = json.loads(tracker.get_kv(KV_PREFIX + "bg"))
    assert payload["schema"] == SCHEMA and payload["process"] == "bg"
    assert payload["seq"] >= 2
    counters = {r["name"]: r["value"]
                for r in payload["snapshot"]["counters"]}
    assert counters["serve_tokens_total"] == 5.0
    pusher.stop()
    pusher.start()
    pusher.stop()
    assert threading.active_count() == before


def test_push_failure_absorbed_and_counted():
    class DeadTracker:
        def put_kv(self, key, value):
            raise ConnectionError("tracker down")

    reg = MetricsRegistry()
    pusher = MetricsPusher(DeadTracker(), "sad", registry=reg)
    assert pusher.push_once() is False
    assert reg.counter("federation_push_failures_total").value == 1.0
    assert reg.gauge("federation_last_push_error").value == 1.0


def test_bad_payloads_skipped_and_counted():
    tracker = InMemoryStateTracker()
    tracker.put_kv(KV_PREFIX + "broken", "{not json")
    tracker.put_kv(KV_PREFIX + "wrong-schema",
                   json.dumps({"schema": "v999", "ts": time.time()}))
    MetricsPusher(tracker, "good", registry=_registry(1, 0, [])).push_once()
    agg = ClusterAggregator(tracker, registry=MetricsRegistry())
    view = agg.collect()
    assert [p["process"] for p in view["processes"]] == ["good"]
    assert agg.registry.counter("federation_bad_payloads_total").value == 2.0


def test_kv_store_over_the_wire():
    assert {"put_kv", "get_kv", "kv_snapshot"} <= _IDEMPOTENT
    with StateTrackerServer() as server:
        client = StateTrackerClient(server.address)
        client.put_kv("a.x", "1")
        client.put_kv("a.x", "2")
        client.put_kv("a.y", "3")
        client.put_kv("b.z", "4")
        assert client.get_kv("a.x") == "2"
        assert client.get_kv("missing") is None
        assert client.get_kv("missing", "dflt") == "dflt"
        assert client.kv_snapshot("a.") == {"a.x": "2", "a.y": "3"}
        assert sorted(client.kv_snapshot()) == ["a.x", "a.y", "b.z"]
        client.close()


def test_collect_alerts_reads_the_published_rows():
    """The alert rows' schema and prefix are JAX's; firing rows count,
    stale and bad payloads are marked and skipped as the metric rows."""
    from deeplearning4j_tpu.telemetry import alerts as jalerts

    from deeplearning4j_tpu_torch.telemetry.federation import ALERT_SCHEMA

    assert (ALERT_SCHEMA, ALERT_KV_PREFIX) == (jalerts.SCHEMA,
                                               jalerts.ALERT_KV_PREFIX)
    tracker = InMemoryStateTracker()
    now = time.time()
    tracker.put_kv(ALERT_KV_PREFIX + "r1", json.dumps({
        "schema": ALERT_SCHEMA, "process": "r1", "pid": 1, "seq": 0,
        "ts": now, "alerts": [
            {"rule": "slo", "state": "firing", "severity": "critical"},
            {"rule": "down", "state": "ok", "severity": "warning"}]}))
    tracker.put_kv(ALERT_KV_PREFIX + "r2", json.dumps({
        "schema": ALERT_SCHEMA, "process": "r2", "ts": now - 60.0,
        "alerts": [{"rule": "slo", "state": "firing",
                    "severity": "critical"}]}))
    tracker.put_kv(ALERT_KV_PREFIX + "bad", "{nope")
    agg = ClusterAggregator(tracker, stale_after_s=10.0,
                            registry=MetricsRegistry())
    view = agg.collect_alerts()
    assert view["schema"] == ALERT_SCHEMA and view["firing"] == 2
    assert {p["process"]: p["stale"] for p in view["processes"]} == {
        "r1": False, "r2": True}
    assert view["alerts"][0]["state"] == "firing"
    assert agg.registry.counter("federation_bad_payloads_total").value == 1
    assert agg.registry.gauge("federation_cluster_alerts_firing").value == 2
