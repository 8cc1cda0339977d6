"""The port's in-process scaleout plane (deeplearning4j_tpu_torch/scaleout/,
utils/counter.py) held against the JAX package's: tests/test_scaleout.py,
test_iterative_reduce.py and test_nlp_scaleout.py through the port, at
their sizes or smaller, plus

- single-file checkpoints written by either package loading in the other,
  with equal member names;
- the blob adapters over mem:// and file://;
- a synchronous ``LocalDistributedRunner`` run against JAX's from the same
  initial params (put in through ``update()``), within ``REL``;
- ``Word2VecWorkPerformer`` and ``GloveWorkPerformer`` jobs against JAX's,
  with JAX's negatives put in (tests/_torch_nlp_draws.py);
- ``ops._kernels.count_launch`` under 8 threads.

Asynchronous (HogWild) runs are held to behaviour — they finish, workers
make unequal progress, early stopping trips — not to parity. Every
thread-driven run goes through ``_in_time``, so a hang fails in
``TIMEOUT_S`` instead of holding the suite.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import threading
import time

import jax
import numpy as np
import pytest

from _torch_nlp_draws import inject_jax_draws
from deeplearning4j_tpu.ops.pallas_kernels import set_fused_dense
from deeplearning4j_tpu_torch.datasets.impl import IrisDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import _kernels
from deeplearning4j_tpu_torch.scaleout import (
    EarlyStopping,
    InMemoryStateTracker,
    LocalDistributedRunner,
)
from deeplearning4j_tpu_torch.scaleout import blobstore as tbs
from deeplearning4j_tpu_torch.scaleout import checkpoint as tckpt
from deeplearning4j_tpu_torch.scaleout import nlp_perform as tnlp
from deeplearning4j_tpu_torch.scaleout.aggregator import \
    ParameterAveragingAggregator
from deeplearning4j_tpu_torch.scaleout.iterative_reduce import (
    ComputableMaster,
    ComputableWorker,
    IterativeReduceRunner,
    ParameterAveragingMaster,
    run_iterative_reduce,
)
from deeplearning4j_tpu_torch.scaleout.job import (
    CollectionJobIterator,
    DataSetJobIterator,
    Job,
)
from deeplearning4j_tpu_torch.scaleout.model_saver import (
    FileModelSaver,
    ParamsOnlySaver,
)
from deeplearning4j_tpu_torch.scaleout.perform import (
    MultiLayerNetworkWorkPerformer,
    WorkerPerformer,
)
from deeplearning4j_tpu_torch.scaleout.workrouter import (
    HogWildWorkRouter,
    IterativeReduceWorkRouter,
)

CPU = "cpu"
REL = 1e-5          # f32 params, of the vector's largest magnitude
TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _jax_fused_dense():
    # the tests' 8 fake devices turn JAX's fused dense off; the port
    # differentiates through the activation's output, as the fused path
    set_fused_dense(True)
    try:
        yield
    finally:
        set_fused_dense(None)


def _in_time(fn, timeout=TIMEOUT_S):
    """``fn()`` in a daemon thread, failing if it runs past ``timeout``
    seconds; returns its value or raises its exception."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # re-raised in the test's thread
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"still running after {timeout} s"
    if "error" in box:
        raise box["error"]
    return box.get("value")


def iris_conf_json(builder=NeuralNetConfiguration, num_iterations=20):
    return (
        builder.Builder()
        .n_in(4).n_out(8).activation_function("tanh")
        .lr(0.1).momentum(0.9).num_iterations(num_iterations).seed(42)
        .list(2)
        .override(1, layer_type="OUTPUT", n_in=8, n_out=3,
                  activation_function="softmax", loss_function="MCXENT")
        .pretrain(False).backward(True)
        .build()
        .to_json()
    )


def _accuracy(conf_json, flat):
    net = MultiLayerNetwork.from_json(conf_json, device=CPU).init()
    net.set_params(flat)
    full = IrisDataSetIterator(150, 150).next()
    return (net.predict(full.features) == full.labels.argmax(-1)).mean()


# ------------------------------------------- contracts (test_scaleout) ----

def test_aggregator_averages():
    agg = ParameterAveragingAggregator()
    j1, j2 = Job(None), Job(None)
    j1.result = np.array([1.0, 2.0])
    j2.result = np.array([3.0, 4.0])
    agg.accumulate(j1)
    agg.accumulate(j2)
    np.testing.assert_allclose(agg.aggregate(), [2.0, 3.0])
    agg.reset()
    assert agg.aggregate() is None


def test_state_tracker_round_trip():
    t = InMemoryStateTracker()
    t.add_worker("w0")
    t.add_worker("w1")
    assert t.workers() == ["w0", "w1"]
    job = Job("work", "w0")
    t.add_job(job)
    assert t.job_for("w0") is job and t.has_pending_jobs()
    t.add_update("w0", job)
    assert "w0" in t.updates()
    t.set_current(np.zeros(3))
    t.add_replicate("w1")
    assert t.needs_replicate("w1") and not t.needs_replicate("w0")
    t.increment("n")
    assert t.count("n") == 1.0
    t.put_kv("a.x", 1)
    assert t.get_kv("a.x") == 1 and t.kv_snapshot("a.") == {"a.x": 1}
    assert t.counters_snapshot("n") == {"n": 1.0}
    t.finish()
    assert t.is_done()


def test_tracker_clear_updates_keeps_newer_snapshots():
    t = InMemoryStateTracker()
    old, new = Job(1, "w0"), Job(2, "w0")
    t.add_update("w0", old)
    snap = t.updates()
    t.add_update("w0", new)     # published after the snapshot
    t.clear_updates(snap)
    assert t.updates() == {"w0": new}


def test_tracker_lock_is_a_plain_rlock():
    t = InMemoryStateTracker()
    assert type(t._lock) is type(threading.RLock())


def test_routers_policy():
    t = InMemoryStateTracker()
    agg = ParameterAveragingAggregator()
    t.add_worker("w0")
    t.add_worker("w1")
    sync = IterativeReduceWorkRouter(t, agg)
    hog = HogWildWorkRouter(t, agg)
    assert not sync.send_work()
    assert hog.send_work() and hog.asynchronous and not sync.asynchronous
    j = Job("x", "w0")
    j.result = np.ones(2)
    t.add_update("w0", j)
    assert not sync.send_work()
    j2 = Job("x", "w1")
    j2.result = np.ones(2) * 3
    t.add_update("w1", j2)
    assert sync.send_work()
    sync.update()
    np.testing.assert_allclose(t.get_current(), [2.0, 2.0])
    assert t.needs_replicate("w0") and t.needs_replicate("w1")
    assert t.updates() == {}


def test_collection_and_dataset_job_iterators():
    it = CollectionJobIterator([1, 2, 3])
    seen = []
    while it.has_next():
        seen.append(it.next("w").work)
    assert seen == [1, 2, 3]
    it.reset()
    assert it.has_next()
    dit = DataSetJobIterator(IrisDataSetIterator(50, 150))
    jobs = []
    while dit.has_next():
        jobs.append(dit.next("w0"))
    assert len(jobs) == 3 and jobs[0].worker_id == "w0"
    assert jobs[0].work.features.shape == (50, 4)


def test_parallelization_map():
    from deeplearning4j_tpu_torch.scaleout.parallelization import (
        iterate,
        run_in_parallel,
    )

    assert iterate([1, 2, 3], lambda x: x * 2) == [2, 4, 6]
    assert run_in_parallel([lambda: 1, lambda: 2]) == [1, 2]


def test_counter_and_counter_map_equal_jax():
    from deeplearning4j_tpu.utils.counter import Counter as JCounter
    from deeplearning4j_tpu.utils.counter import CounterMap as JCounterMap
    from deeplearning4j_tpu_torch.utils import Counter, CounterMap

    outs = []
    for C, M in ((JCounter, JCounterMap), (Counter, CounterMap)):
        c = C()
        for k, v in (("a", 1), ("b", 3), ("a", 2), ("c", 0.5)):
            c.increment_count(k, v)
        row = [c.arg_max(), c.max_count(), c.total_count(), c.sorted_keys(),
               repr(c), len(c)]
        c.normalize()
        row.append(sorted(c.items()))
        m = M()
        m.increment_count("x", "y", 2)
        m.set_count("x", "z", 1)
        m.increment_count("w", "y")
        row += [m.get_count("x", "y"), m.total_count(), m.total_size(),
                sorted(m.key_set()), "x" in m, m.get_count("q", "y")]
        outs.append(row)
    assert outs[0] == outs[1]
    with pytest.raises(ValueError):
        Counter().arg_max()


def test_registry_round_trip_and_key_checks(tmp_path):
    from deeplearning4j_tpu_torch.scaleout.registry import \
        ConfigurationRegistry

    reg = ConfigurationRegistry(str(tmp_path))
    reg.register("ns", "a", {"x": 1})
    assert reg.retrieve("ns", "a") == {"x": 1}
    assert reg.list_ids("ns") == ["a"]
    assert reg.delete("ns", "a") and reg.retrieve("ns", "a") is None
    for bad in ("", ".", ".."):
        with pytest.raises(ValueError):
            reg.register("ns", bad, {})
    # separators are flattened, never followed out of the root
    path = reg.register("ns", "../../escape", {"y": 2})
    assert os.path.realpath(path).startswith(os.path.realpath(tmp_path))


def test_model_savers_round_trip(tmp_path):
    net = MultiLayerNetwork.from_json(iris_conf_json(), device=CPU).init()
    fs = FileModelSaver(str(tmp_path / "m"), device=CPU)
    assert not fs.exists()
    fs.save(net)
    assert fs.exists()
    assert torch.equal(fs.load().params(), net.params())
    ps = ParamsOnlySaver(str(tmp_path / "p"))
    ps.save(net)
    np.testing.assert_array_equal(ps.load(), net.params().numpy())


# ------------------------------------------------------ runner, sync ----

def test_local_distributed_training_converges():
    conf_json = iris_conf_json(num_iterations=15)
    it = IrisDataSetIterator(25, 150)  # 6 mini-batch jobs
    runner = LocalDistributedRunner(
        performer_factory=lambda: MultiLayerNetworkWorkPerformer(
            conf_json, device=CPU),
        job_iterator=DataSetJobIterator(it),
        num_workers=4,
    )
    final_params = _in_time(runner.train)
    assert final_params is not None
    assert runner.tracker.count("jobs_done") == 6
    assert _accuracy(conf_json, final_params) > 0.6


def test_sync_runner_matches_jax_from_the_same_params():
    """Four workers over six Iris jobs, every performer starting from
    JAX's initial params (put in through ``update()``): the averaged
    params equal the JAX runner's."""
    from deeplearning4j_tpu.datasets.impl import \
        IrisDataSetIterator as JIris
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JB
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.scaleout import LocalDistributedRunner as JRunner
    from deeplearning4j_tpu.scaleout.job import DataSetJobIterator as JJobs
    from deeplearning4j_tpu.scaleout.perform import \
        MultiLayerNetworkWorkPerformer as JPerformer

    conf_json = iris_conf_json(JB, num_iterations=5)
    init = np.asarray(JNet.from_json(conf_json).init().params())

    def factory(make):
        def build():
            performer = make()
            performer.update(init)
            return performer
        return build

    jrunner = JRunner(factory(lambda: JPerformer(conf_json)),
                      JJobs(JIris(25, 150)), num_workers=4)
    want = np.asarray(jrunner.train())
    trunner = LocalDistributedRunner(
        factory(lambda: MultiLayerNetworkWorkPerformer(conf_json,
                                                       device=CPU)),
        DataSetJobIterator(IrisDataSetIterator(25, 150)), num_workers=4)
    got = _in_time(trunner.train)
    assert trunner.tracker.count("aggregations") == \
        jrunner.tracker.count("aggregations")
    assert not np.allclose(want, init)
    np.testing.assert_allclose(got, want, atol=REL * np.abs(want).max(),
                               rtol=0)


def test_performer_reports_score_and_installs_master_params():
    performer = MultiLayerNetworkWorkPerformer(iris_conf_json(num_iterations=5),
                                               device=CPU)
    job = Job(IrisDataSetIterator(30, 30).next(), "w0")
    performer.perform(job)
    assert job.score is not None and np.isfinite(job.score)
    assert isinstance(job.result, np.ndarray)
    performer.update(np.zeros_like(job.result))
    performer.perform(job)
    with pytest.raises(TypeError):
        performer.perform(Job("not a dataset"))


# ----------------------------------------------------- runner, async ----

class PacedPerformer(WorkerPerformer):
    def __init__(self, delay_s):
        self.delay_s = delay_s

    def perform(self, job):
        time.sleep(self.delay_s)
        job.result = np.asarray([float(job.work)])

    def update(self, *args):
        pass


def _hogwild(factory, jobs, num_workers=2, **kw):
    tracker = kw.pop("tracker", None) or InMemoryStateTracker()
    return LocalDistributedRunner(
        performer_factory=factory,
        job_iterator=CollectionJobIterator(jobs),
        num_workers=num_workers, tracker=tracker,
        router=HogWildWorkRouter(tracker, ParameterAveragingAggregator()),
        **kw)


def test_hogwild_router_runs():
    conf_json = iris_conf_json(num_iterations=5)
    tracker = InMemoryStateTracker()
    runner = LocalDistributedRunner(
        performer_factory=lambda: MultiLayerNetworkWorkPerformer(
            conf_json, device=CPU),
        job_iterator=DataSetJobIterator(IrisDataSetIterator(50, 150)),
        num_workers=2, tracker=tracker,
        router=HogWildWorkRouter(tracker, ParameterAveragingAggregator()))
    assert _in_time(runner.train) is not None
    assert tracker.count("jobs_done") == 3


def test_hogwild_async_workers_make_unequal_progress():
    delays = iter([0.05, 0.001])  # worker-0 is 50x slower than worker-1
    runner = _hogwild(lambda: PacedPerformer(next(delays)), list(range(24)))
    _in_time(runner.train)
    t = runner.tracker
    assert t.count("jobs_done") == 24
    slow, fast = t.count("rounds.worker-0"), t.count("rounds.worker-1")
    assert fast >= 3 * max(slow, 1), (slow, fast)
    assert t.count("aggregations") >= 2


def test_hogwild_async_training_falls_in_score():
    """A HogWild run on Iris finishes and its reported loss falls."""
    conf_json = iris_conf_json(num_iterations=10)
    scores = []

    class Recording(MultiLayerNetworkWorkPerformer):
        def perform(self, job):
            super().perform(job)
            scores.append(job.score)

    tracker = InMemoryStateTracker()
    it = IrisDataSetIterator(25, 150)
    runner = LocalDistributedRunner(
        performer_factory=lambda: Recording(conf_json, device=CPU),
        job_iterator=DataSetJobIterator(it), num_workers=2, tracker=tracker,
        router=HogWildWorkRouter(tracker, ParameterAveragingAggregator()),
        max_rounds=6)
    final = _in_time(runner.train)
    assert tracker.count("jobs_done") == 6 and final is not None
    assert np.mean(scores[-2:]) < np.mean(scores[:2])
    assert _accuracy(conf_json, final) > 0.6


class FlakyPerformer(WorkerPerformer):
    def __init__(self, idx, fail_ids):
        self.idx = idx
        self.fail_ids = fail_ids

    def perform(self, job):
        if self.idx in self.fail_ids:
            raise RuntimeError(f"worker {self.idx} crashed")
        job.result = np.asarray([float(job.work)])

    def update(self, *args):
        pass


def _flaky_runner(fail_ids, fault_tolerant=True, num_workers=3, jobs=6):
    counter = iter(range(100))
    return LocalDistributedRunner(
        performer_factory=lambda: FlakyPerformer(next(counter), fail_ids),
        job_iterator=CollectionJobIterator(list(range(jobs))),
        num_workers=num_workers, fault_tolerant=fault_tolerant)


class TestFaultTolerance:
    def test_failed_worker_job_rerouted(self):
        runner = _flaky_runner({1})
        _in_time(runner.train)
        assert runner.tracker.count("jobs_done") == 6
        assert runner.tracker.count("worker_failures") == 1
        assert len(runner.tracker.workers()) == 2

    def test_not_fault_tolerant_raises(self):
        with pytest.raises(RuntimeError, match="crashed"):
            _in_time(_flaky_runner({1}, fault_tolerant=False).train)

    def test_all_workers_failed_raises(self):
        with pytest.raises(RuntimeError, match="all workers failed"):
            _in_time(_flaky_runner({0, 1}, num_workers=2).train)

    def test_job_timing_counter(self):
        runner = _flaky_runner(set())
        _in_time(runner.train)
        assert runner.tracker.count("job_ms_total") > 0

    def test_two_workers_fail_same_round_no_job_lost(self):
        runner = _flaky_runner({0, 1}, num_workers=3)
        _in_time(runner.train)
        assert runner.tracker.count("jobs_done") == 6
        assert runner.tracker.count("worker_failures") == 2


class StuckPerformer(WorkerPerformer):
    def perform(self, job):
        time.sleep(0.005)
        job.result = np.asarray([1.0])
        job.score = 5.0  # no improvement, ever

    def update(self, *args):
        pass


class TestEarlyStopping:
    def _stuck_runner(self, n_jobs=12, patience=2, router=None,
                      tracker=None):
        tracker = tracker or InMemoryStateTracker()
        return LocalDistributedRunner(
            performer_factory=StuckPerformer,
            job_iterator=CollectionJobIterator(list(range(n_jobs))),
            num_workers=2, tracker=tracker, router=router,
            early_stopping=EarlyStopping(patience=patience))

    def test_sync_stops_without_improvement(self):
        runner = self._stuck_runner()
        _in_time(runner.train)
        t = runner.tracker
        assert t.is_early_stop() and t.count("early_stopped") == 1
        assert t.count("jobs_done") < 12 and t.best_loss() == 5.0

    def test_async_stops_without_improvement(self):
        tracker = InMemoryStateTracker()
        runner = self._stuck_runner(
            n_jobs=200, tracker=tracker,
            router=HogWildWorkRouter(tracker, ParameterAveragingAggregator()))
        _in_time(runner.train)
        assert tracker.is_early_stop()
        assert tracker.count("jobs_done") < 200

    def test_externally_set_flag_halts_sync_run(self):
        runner = self._stuck_runner(patience=10_000)
        runner.tracker.early_stop()
        _in_time(runner.train)
        assert runner.tracker.count("jobs_done") == 0

    def test_improving_run_does_not_stop(self):
        class Improving(WorkerPerformer):
            def __init__(self):
                self.loss = 10.0

            def perform(self, job):
                job.result = np.asarray([1.0])
                self.loss *= 0.9
                job.score = self.loss

            def update(self, *args):
                pass

        runner = LocalDistributedRunner(
            performer_factory=Improving,
            job_iterator=CollectionJobIterator(list(range(8))),
            num_workers=2, early_stopping=EarlyStopping(patience=2))
        _in_time(runner.train)
        assert not runner.tracker.is_early_stop()
        assert runner.tracker.count("jobs_done") == 8

    def test_patience_must_be_positive(self):
        with pytest.raises(ValueError):
            EarlyStopping(patience=0)

    def test_async_crashed_worker_does_not_block_early_stopping(self):
        class CrashOrStuck(StuckPerformer):
            def __init__(self, idx):
                self.idx = idx

            def perform(self, job):
                if self.idx == 0:
                    raise RuntimeError("boom")
                super().perform(job)

        counter = iter(range(10))
        tracker = InMemoryStateTracker()
        runner = _hogwild(lambda: CrashOrStuck(next(counter)),
                          list(range(300)), tracker=tracker,
                          fault_tolerant=True,
                          early_stopping=EarlyStopping(patience=2))
        _in_time(runner.train)
        assert tracker.count("worker_failures") == 1
        assert tracker.is_early_stop()
        assert tracker.count("jobs_done") < 300

    def test_async_model_saver_gets_the_final_params(self):
        class Saver:
            """The runner hands its saver the averaged flat vector."""
            def __init__(self):
                self.saved = []

            def save(self, model):
                self.saved.append(np.array(model))

        saver = Saver()
        runner = _hogwild(lambda: PacedPerformer(0.001), list(range(8)),
                          model_saver=saver)
        final = _in_time(runner.train)
        np.testing.assert_array_equal(saver.saved[-1], final)


# ---------------------------------------- iterative reduce (IRUnit) ----

class _CountingWorker(ComputableWorker):
    def __init__(self, value, steps):
        self.value = value
        self.steps = steps
        self.received = []

    def compute(self):
        if self.steps <= 0:
            return None
        self.steps -= 1
        return np.array([self.value], dtype=np.float64)

    def update(self, master_update):
        self.received.append(float(master_update[0]))


class TestIterativeReduce:
    def test_superstep_loop_and_barrier(self):
        workers = [_CountingWorker(v, steps=2) for v in (1.0, 3.0)]
        runner = IterativeReduceRunner(ParameterAveragingMaster(), workers)
        final = _in_time(runner.run)
        assert runner.supersteps_run == 2
        assert final[0] == pytest.approx(2.0)
        assert workers[0].received == [2.0, 2.0]

    def test_stops_when_all_workers_done(self):
        workers = [_CountingWorker(1.0, steps=1),
                   _CountingWorker(2.0, steps=3)]
        runner = IterativeReduceRunner(ParameterAveragingMaster(), workers,
                                       max_supersteps=10)
        _in_time(runner.run)
        assert runner.supersteps_run == 3

    def test_worker_error_aborts(self):
        class Bad(ComputableWorker):
            def compute(self):
                raise RuntimeError("container failed")

            def update(self, mu):
                pass

        runner = IterativeReduceRunner(ParameterAveragingMaster(), [Bad()])
        with pytest.raises(RuntimeError, match="container failed"):
            _in_time(runner.run)

    def test_requires_workers(self):
        with pytest.raises(ValueError):
            IterativeReduceRunner(ParameterAveragingMaster(), [])

    def test_master_complete_called(self):
        calls = []

        class M(ComputableMaster):
            def compute(self, ups, mu):
                return ups[0]

            def complete(self):
                calls.append(True)

        _in_time(IterativeReduceRunner(M(), [_CountingWorker(1.0, 1)]).run)
        assert calls == [True]

    def test_converges_on_iris(self):
        from deeplearning4j_tpu_torch.datasets.fetchers import iris_data

        x, y = iris_data()
        rng = np.random.RandomState(0)
        perm = rng.permutation(len(x))
        x, y = x[perm].astype(np.float32), y[perm]
        onehot = np.eye(3, dtype=np.float32)[y]
        conf = (NeuralNetConfiguration.Builder()
                .n_in(4).n_out(8).activation_function("tanh").lr(0.1)
                .momentum(0.9).use_ada_grad(True).num_iterations(20).seed(42)
                .weight_init("VI").list(2)
                .override(0, layer_type="DENSE")
                .override(1, layer_type="OUTPUT", n_in=8, n_out=3,
                          activation_function="softmax",
                          loss_function="MCXENT")
                .pretrain(False).backward(True).build())
        net, runner = _in_time(lambda: run_iterative_reduce(
            conf, x, onehot, n_workers=3, supersteps=4, device=CPU))
        assert runner.supersteps_run == 4
        assert (net.predict(x) == y).mean() > 0.9


# ------------------------------------------------------- checkpoints ----

def _ckpt_conf(builder=NeuralNetConfiguration, dropout=0.0, seed=42):
    b = (builder.Builder()
         .n_in(4).n_out(8).activation_function("tanh").lr(0.1)
         .momentum(0.9).use_ada_grad(True).num_iterations(10).seed(seed)
         .weight_init("VI"))
    if dropout:
        b = b.dropout(dropout)
    return (b.list(2)
            .override(0, layer_type="DENSE")
            .override(1, layer_type="OUTPUT", n_in=8, n_out=3,
                      activation_function="softmax", loss_function="MCXENT")
            .pretrain(False).backward(True).build())


def _xy(seed=0, n=12):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 4).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]


class TestFullStateCheckpoint:
    def test_resume_is_bit_exact(self, tmp_path):
        from deeplearning4j_tpu_torch.datasets.fetchers import iris_data

        x, y = iris_data()
        x = x.astype(np.float32)
        onehot = np.eye(3, dtype=np.float32)[y]
        net_a = MultiLayerNetwork(_ckpt_conf(), device=CPU).init()
        net_a.fit(x, onehot)
        path = tckpt.save_checkpoint(str(tmp_path / "ckpt"), net_a)
        net_a.fit(x, onehot)
        net_b, it = tckpt.load_checkpoint(path, device=CPU)
        assert it == 10 and net_b._iteration == 10
        net_b.fit(x, onehot)
        assert torch.equal(net_a.params(), net_b.params())

    def test_checkpoint_restores_updater_state(self, tmp_path):
        from deeplearning4j_tpu_torch._device import tree_leaves

        x, y = _xy()
        net = MultiLayerNetwork(_ckpt_conf(), device=CPU).init()
        net.fit(x, y)
        path = tckpt.save_checkpoint(str(tmp_path / "c2"), net)
        net2, _ = tckpt.load_checkpoint(path, device=CPU)
        a, b = tree_leaves(net._train_state), tree_leaves(net2._train_state)
        assert len(a) == len(b) > 0
        assert all(torch.equal(u, v) for u, v in zip(a, b))

    def test_rng_stream_resumes_for_stochastic_conf(self, tmp_path):
        x, y = _xy(n=16)
        conf = _ckpt_conf(dropout=0.3, seed=11)
        net_a = MultiLayerNetwork(conf, device=CPU).init()
        net_a.fit(x, y)
        path = tckpt.save_checkpoint(str(tmp_path / "rng"), net_a)
        net_a.fit(x, y)
        net_b, _ = tckpt.load_checkpoint(path, device=CPU)
        net_b.fit(x, y)
        assert torch.equal(net_a.params(), net_b.params())

    def test_crash_mid_save_preserves_old_checkpoint(self, tmp_path,
                                                     monkeypatch):
        x, y = _xy(3)
        net = MultiLayerNetwork(_ckpt_conf(), device=CPU).init()
        net.fit(x, y)
        path = tckpt.save_checkpoint(str(tmp_path / "ck"), net)
        with open(path, "rb") as f:
            good = f.read()
        net.fit(x, y)

        def boom(f, **payload):
            f.write(b"half a checkpoint")
            raise RuntimeError("disk died mid-save")

        monkeypatch.setattr(np, "savez", boom)
        with pytest.raises(RuntimeError, match="disk died"):
            tckpt.save_checkpoint(path, net)
        monkeypatch.undo()
        with open(path, "rb") as f:
            assert f.read() == good
        assert not [p for p in os.listdir(tmp_path) if ".tmp-" in p]
        net2, it = tckpt.load_checkpoint(path, device=CPU)
        assert it == 10 and torch.isfinite(net2.params()).all()

    def test_concurrent_saver_tmp_names_are_unique(self, tmp_path,
                                                   monkeypatch):
        net = MultiLayerNetwork(_ckpt_conf(), device=CPU).init()
        seen = []
        orig = np.savez

        def spy(f, **payload):
            seen.append(f.name)
            return orig(f, **payload)

        monkeypatch.setattr(np, "savez", spy)
        path = str(tmp_path / "ck")
        tckpt.save_checkpoint(path, net)
        tckpt.save_checkpoint(path, net)
        assert len(seen) == 2 and seen[0] != seen[1]
        assert all(".tmp-" in name for name in seen)

    def test_load_rejects_missing_leaf_shape_mismatch_and_lossy_dtype(
            self, tmp_path):
        net = MultiLayerNetwork(_ckpt_conf(), device=CPU).init()
        path = tckpt.save_checkpoint(str(tmp_path / "ck"), net)
        with np.load(path) as z:
            payload = {k: np.asarray(z[k]) for k in z.files}
        key = [k for k in payload if k.startswith("tree::['params']")
               and payload[k].ndim == 2][0]

        def write(name, **change):
            bad = dict(payload, **change)
            for k in [k for k, v in change.items() if v is None]:
                del bad[k]
            p = str(tmp_path / name)
            np.savez(p, **bad)
            return p + ".npz"

        with pytest.raises(ValueError, match="shape"):
            tckpt.load_checkpoint(write("s", **{key: payload[key][:-1]}),
                                  device=CPU)
        with pytest.raises(TypeError, match="narrow"):
            tckpt.load_checkpoint(
                write("d", **{key: payload[key].astype(np.float64)}),
                device=CPU)
        with pytest.raises(KeyError, match="missing leaf"):
            tckpt.load_checkpoint(write("m", **{key: None}), device=CPU)
        net3, _ = tckpt.load_checkpoint(
            write("w", **{key: payload[key].astype(np.float16)}), device=CPU)
        assert torch.isfinite(net3.params()).all()

    @pytest.mark.parametrize("trained", [False, True])
    def test_files_cross_load_between_the_packages(self, tmp_path, trained):
        """A JAX checkpoint loads in the port and a port checkpoint in JAX,
        with the same members, params, updater state and iteration."""
        from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JB
        from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
        from deeplearning4j_tpu.scaleout import checkpoint as jckpt

        x, y = _xy(5)
        jnet = JNet(_ckpt_conf(JB)).init()
        if trained:
            jnet.fit(x, y)
        jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), jnet)
        tnet, it = tckpt.load_checkpoint(jpath, device=CPU)
        assert it == jnet._iteration
        np.testing.assert_array_equal(tnet.params().numpy(),
                                      np.asarray(jnet.params()))
        tpath = tckpt.save_checkpoint(str(tmp_path / "port"), tnet)
        with np.load(jpath) as zj, np.load(tpath) as zt:
            assert sorted(zj.files) == sorted(zt.files)
            for k in zj.files:
                if k != "__rng_key__":
                    np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
        back, it2 = jckpt.load_checkpoint(tpath)
        assert it2 == it
        np.testing.assert_array_equal(np.asarray(back.params()),
                                      np.asarray(jnet.params()))
        if trained:
            for a, b in zip(jax.tree_util.tree_leaves(jnet._train_state),
                            jax.tree_util.tree_leaves(back._train_state)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_keystr_is_jax_keystr(self):
        tree = {"params": ({"W": 1, "b": 2}, {"W": 3}), "state": [{"m": 4}]}
        want = [jax.tree_util.keystr(p) for p, _ in
                jax.tree_util.tree_flatten_with_path(tree)[0]]
        got = [tckpt.keystr(p) for p in tckpt._paths(tree)]
        assert got == want


# ------------------------------------------------------ blob adapters ----

@pytest.mark.parametrize("scheme", ["mem", "file"])
def test_blob_adapters_round_trip(tmp_path, scheme):
    uri = (f"mem://adapters-{tmp_path.name}" if scheme == "mem"
           else f"file://{tmp_path / 'store'}")
    store = tbs.open_store(uri)
    x, y = _xy(7)
    net = MultiLayerNetwork(_ckpt_conf(), device=CPU).init()
    net.fit(x, y)
    saver = tbs.BlobModelSaver(store, "models/net.npz", device=CPU)
    saver.save(net)
    assert saver.exists()
    assert torch.equal(saver.load().params(), net.params())
    key = tbs.save_checkpoint_to_store(store, "ckpt/full.npz", net)
    net2, it = tbs.load_checkpoint_from_store(store, key, device=CPU)
    assert it == 10 and torch.equal(net2.params(), net.params())
    for i in range(3):
        tbs.BlobDataSetIterator.write_batch(store, f"data/{i}.npz",
                                            x[i * 4:(i + 1) * 4],
                                            y[i * 4:(i + 1) * 4])
    it = tbs.BlobDataSetIterator(store, "data/")
    batches = list(it)
    assert len(batches) == 3 and not it.has_next()
    np.testing.assert_array_equal(batches[2].features, x[8:12])
    it.reset()
    net2.fit(it.next())
    with pytest.raises(StopIteration):
        list(it) and it.next()


def test_blob_checkpoint_loads_in_jax():
    from deeplearning4j_tpu.scaleout import blobstore as jbs

    store = tbs.open_store("mem://port-to-jax")
    net = MultiLayerNetwork(_ckpt_conf(), device=CPU).init()
    tbs.save_checkpoint_to_store(store, "c.npz", net)
    jstore = jbs.open_store("mem://port-to-jax-j")
    jstore.put("c.npz", store.get("c.npz"))
    jnet, _ = jbs.load_checkpoint_from_store(jstore, "c.npz")
    np.testing.assert_array_equal(np.asarray(jnet.params()),
                                  net.params().numpy())


# --------------------------------------------------- NLP performers ----

def _toy_corpus(n=100):
    fruit = "apple banana cherry fruit sweet juice"
    tech = "cpu gpu chip silicon compute memory"
    sents = []
    rng = np.random.default_rng(0)
    for _ in range(n):
        sents.append(" ".join(rng.permutation(fruit.split()).tolist()))
        sents.append(" ".join(rng.permutation(tech.split()).tolist()))
    return sents


def _cosine(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def _pairs(w2v, epochs, seed=1):
    rng = np.random.default_rng(seed)
    cs, ts = [], []
    for _ in range(epochs):
        flat, sid = w2v._subsampled_flat(rng)
        c, t = w2v._pairs_from_flat(flat, sid, rng)
        perm = rng.permutation(c.shape[0])
        cs.append(c[perm])
        ts.append(t[perm])
    return np.concatenate(cs), np.concatenate(ts)


def _w2v(mod, **kw):
    return mod.Word2Vec(
        sentence_iterator=mod.CollectionSentenceIterator(_toy_corpus()),
        layer_size=16, window=3, negative=5, sample=0, seed=1, **kw)


def test_word2vec_performer_jobs_match_jax(monkeypatch):
    """Three jobs on one performer of each package from the shared numpy
    tables, with JAX's key splits and negatives put in."""
    import types

    from deeplearning4j_tpu.models import word2vec as jw2v_mod
    from deeplearning4j_tpu.scaleout import nlp_perform as jnlp
    from deeplearning4j_tpu.text.sentence_iterator import \
        CollectionSentenceIterator as JSents
    from deeplearning4j_tpu_torch.models import word2vec as tw2v_mod
    from deeplearning4j_tpu_torch.text.sentence_iterator import \
        CollectionSentenceIterator as TSents

    inject_jax_draws(monkeypatch, tnlp)
    jmod = types.SimpleNamespace(Word2Vec=jw2v_mod.Word2Vec,
                                 CollectionSentenceIterator=JSents)
    tmod = types.SimpleNamespace(Word2Vec=tw2v_mod.Word2Vec,
                                 CollectionSentenceIterator=TSents)
    jw, tw = _w2v(jmod), _w2v(tmod, device=CPU)
    jw.build_vocab()
    tw.build_vocab()
    centers, contexts = _pairs(tw, 1)
    jc, jt = _pairs(jw, 1)
    np.testing.assert_array_equal(centers, jc)
    jp = jnlp.Word2VecWorkPerformer(jw.vocab, layer_size=16, negative=5,
                                    lr=0.1, total_pairs=len(centers), seed=1)
    tp = tnlp.Word2VecWorkPerformer(tw.vocab, layer_size=16, negative=5,
                                    lr=0.1, total_pairs=len(centers), seed=1,
                                    device=CPU)
    for lo in (0, 512, 1024):
        work = (centers[lo:lo + 512], contexts[lo:lo + 512])
        jj, tj = Job(work), Job(work)
        jp.perform(jj)
        tp.perform(tj)
        np.testing.assert_allclose(tj.result, jj.result, atol=1e-6, rtol=0)
    assert tp._pairs_local == jp._pairs_local == 1536
    flat = np.asarray(jj.result) * 0.5
    jp.update(flat)
    tp.update(flat)
    np.testing.assert_array_equal(tp.syn0(), np.asarray(jp.syn0()))


def test_glove_performer_jobs_match_jax():
    from deeplearning4j_tpu.scaleout import nlp_perform as jnlp

    rng = np.random.RandomState(3)
    v, n = 30, 400
    rows, cols = rng.randint(0, v, n), rng.randint(0, v, n)
    vals = rng.rand(n).astype(np.float32) * 20 + 1
    jit_ = jnlp.CoOccurrenceJobIterator(rows, cols, vals, batch_size=128)
    tit = tnlp.CoOccurrenceJobIterator(rows, cols, vals, batch_size=128)
    jp = jnlp.GloveWorkPerformer(v, layer_size=8, lr=0.05, seed=1)
    tp = tnlp.GloveWorkPerformer(v, layer_size=8, lr=0.05, seed=1,
                                 device=CPU)
    np.testing.assert_array_equal(tp.syn0(), np.asarray(jp.syn0()))
    jobs = 0
    while jit_.has_next():
        jj, tj = jit_.next("w"), tit.next("w")
        for a, b in zip(jj.work, tj.work):
            np.testing.assert_array_equal(a, b)
        jp.perform(jj)
        tp.perform(tj)
        np.testing.assert_allclose(tj.result, jj.result, atol=1e-6, rtol=0)
        jobs += 1
    assert jobs == 4 and not tit.has_next()


def test_runner_trains_word2vec_embeddings():
    from deeplearning4j_tpu_torch.models.word2vec import Word2Vec
    from deeplearning4j_tpu_torch.text.sentence_iterator import \
        CollectionSentenceIterator

    w2v = Word2Vec(sentence_iterator=CollectionSentenceIterator(
        _toy_corpus()), layer_size=16, window=3, negative=5, sample=0,
        seed=1, device=CPU)
    w2v.build_vocab()
    centers, contexts = _pairs(w2v, 6)
    tracker = InMemoryStateTracker()
    vocab = w2v.vocab
    runner = LocalDistributedRunner(
        performer_factory=lambda: tnlp.Word2VecWorkPerformer(
            vocab, layer_size=16, negative=5, lr=0.1,
            total_pairs=len(centers), tracker=tracker, seed=1, device=CPU),
        job_iterator=tnlp.SkipGramJobIterator(centers, contexts, 2048),
        num_workers=4, tracker=tracker)
    flat = _in_time(runner.train)
    v, d = vocab.num_words(), 16
    syn0 = flat[: v * d].reshape(v, d)

    def vec(w):
        return syn0[vocab.index_of(w)]

    assert _cosine(vec("apple"), vec("banana")) > \
        _cosine(vec("apple"), vec("gpu"))
    assert tracker.count(tnlp.NUM_PAIRS_SO_FAR) == len(centers)


def test_runner_trains_glove():
    from deeplearning4j_tpu_torch.models.glove import Glove
    from deeplearning4j_tpu_torch.text.sentence_iterator import \
        CollectionSentenceIterator

    g = Glove(sentence_iterator=CollectionSentenceIterator(_toy_corpus()),
              layer_size=16, window=5, iterations=1, seed=1, device=CPU)
    g.build_vocab_and_cooccurrences()
    rows, cols, vals = g.co.to_arrays()
    rng = np.random.default_rng(2)
    order = np.concatenate([rng.permutation(len(rows)) for _ in range(20)])
    runner = LocalDistributedRunner(
        performer_factory=lambda: tnlp.GloveWorkPerformer(
            g.vocab.num_words(), layer_size=16, lr=0.05, seed=1, device=CPU),
        job_iterator=tnlp.CoOccurrenceJobIterator(
            rows[order], cols[order], vals[order], batch_size=4096),
        num_workers=4)
    flat = _in_time(runner.train)
    v, d = g.vocab.num_words(), 16
    w = flat[: v * d].reshape(v, d)

    def vec(word):
        return w[g.vocab.index_of(word)]

    assert _cosine(vec("apple"), vec("banana")) > \
        _cosine(vec("apple"), vec("gpu"))


def test_word_count_performer_and_aggregator():
    perf = tnlp.WordCountWorkPerformer()
    agg = tnlp.WordCountJobAggregator()
    for chunk in (["a b a", "c"], "b b"):
        job = Job(chunk)
        perf.perform(job)
        agg.accumulate(job)
    agg.accumulate(Job(None))
    counts = agg.aggregate()
    assert {k: counts.get_count(k) for k in counts.key_set()} == \
        {"a": 2.0, "b": 3.0, "c": 1.0}


def test_skipgram_job_iterator_slices_the_stream():
    it = tnlp.SkipGramJobIterator(np.arange(10), np.arange(10) + 1, 4)
    sizes = []
    while it.has_next():
        c, t = it.next("w").work
        sizes.append(len(c))
        np.testing.assert_array_equal(t, c + 1)
    assert sizes == [4, 4, 2]
    it.reset()
    assert it.has_next()


# ----------------------------------------------------- launch counts ----

def test_count_launch_is_exact_under_threads():
    name = "fused_dense"
    before = _kernels.LAUNCHES[name]
    per_thread = 20_000

    def hammer():
        for _ in range(per_thread):
            _kernels.count_launch(name)

    threads = [threading.Thread(target=hammer, daemon=True)
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT_S)
    assert not any(t.is_alive() for t in threads)
    assert _kernels.LAUNCHES[name] - before == 8 * per_thread
    _kernels.LAUNCHES[name] = before
