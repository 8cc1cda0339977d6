"""Counterpart of ``deeplearning4j_tpu/scaleout/runner.py``: the local
distributed runtime, master/worker training in one process.

Parity with ref: actor/runner/DeepLearning4jDistributed.java + the
MasterActor/WorkerActor heartbeat protocol (MasterActor.java:106-142,
WorkerActor.java:168-206), replacing Akka actors + Hazelcast with a thread
pool + InMemoryStateTracker — exactly how the reference's own tests run the
cluster (testsupport/BaseTestDistributed.java: everything in one JVM).

Round protocol per heartbeat:
  master: if router.send_work(): aggregate updates (router.update), feed next
          jobs from the JobIterator
  worker: if tracker.needs_replicate(id): pull current params
          (performer.update); take job; performer.perform(job);
          tracker.add_update(id, job)

The workers are threads over one device; each performer keeps its own
network and key stream. On a card prefer parallel/trainer.py (collectives
in the step). This runner is the control-plane-parity path.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Optional

from deeplearning4j_tpu_torch.scaleout.aggregator import ParameterAveragingAggregator
from deeplearning4j_tpu_torch.scaleout.job import JobIterator
from deeplearning4j_tpu_torch.scaleout.model_saver import ModelSaver
from deeplearning4j_tpu_torch.scaleout.perform import WorkerPerformer
from deeplearning4j_tpu_torch.scaleout.statetracker import InMemoryStateTracker
from deeplearning4j_tpu_torch.scaleout.workrouter import IterativeReduceWorkRouter, WorkRouter

log = logging.getLogger(__name__)


class EarlyStopping:
    """Master-side early-stopping policy: stop distributing work after
    ``patience`` aggregation rounds whose mean reported job loss fails to
    improve the tracker's best loss by ``min_delta``.

    The reference exposes earlyStop/bestLoss flags on the StateTracker
    (StateTracker.java / BaseHazelCastStateTracker) but ships no policy
    that trips them; here the master enforces them — and any external
    caller can still trip ``tracker.early_stop()`` directly, which both
    runner paths honor."""

    def __init__(self, patience: int = 3, min_delta: float = 0.0):
        if patience < 1:
            raise ValueError("patience must be >= 1")
        self.patience = patience
        self.min_delta = min_delta


class LocalDistributedRunner:
    def __init__(
        self,
        performer_factory,
        job_iterator: JobIterator,
        num_workers: int = 4,
        router: Optional[WorkRouter] = None,
        tracker: Optional[InMemoryStateTracker] = None,
        model_saver: Optional[ModelSaver] = None,
        max_rounds: int = 10_000,
        fault_tolerant: bool = False,
        heartbeat_s: float = 0.05,
        async_timeout_s: Optional[float] = None,
        early_stopping: Optional[EarlyStopping] = None,
    ):
        """performer_factory() -> WorkerPerformer (one per worker, mirroring
        WorkerPerformerFactory, ref: scaleout/perform/WorkerPerformerFactory)."""
        self.tracker = tracker or InMemoryStateTracker()
        self.router = router or IterativeReduceWorkRouter(
            self.tracker, ParameterAveragingAggregator()
        )
        self.performers = {
            f"worker-{i}": performer_factory() for i in range(num_workers)
        }
        self.job_iterator = job_iterator
        self.model_saver = model_saver
        self.max_rounds = max_rounds
        self.fault_tolerant = fault_tolerant
        self.heartbeat_s = heartbeat_s  # async-mode idle wake interval for
        #                                 failure/deadline checks; aggregation
        #                                 itself is event-driven (the master
        #                                 wakes the moment a worker publishes;
        #                                 ref: MasterActor 1 s tick)
        self.async_timeout_s = async_timeout_s  # optional wall-clock cap for
        #                                         the async path (None = run
        #                                         until the iterator drains,
        #                                         matching the sync path)
        self.early_stopping = early_stopping
        self._no_improve = 0  # evaluation rounds without best-loss progress
        self._es_scores: dict = {}  # worker_id -> latest score this round
        self._requeued: deque = deque()  # jobs orphaned by failed workers
        self._feed_lock = threading.Lock()  # guards iterator+requeued (async)
        self._update_arrived = threading.Event()  # wakes the async master
        self._async_jobs_left = 0  # set by _train_async (max_rounds bound)
        for worker_id in self.performers:
            self.tracker.add_worker(worker_id)

    def _replicate_if_needed(self, worker_id: str) -> None:
        """Pull the latest averaged params when flagged (ref:
        WorkerActor.checkJobAvailable → tracker.getCurrent,
        WorkerActor.java:302-306)."""
        performer: WorkerPerformer = self.performers[worker_id]
        if self.tracker.needs_replicate(worker_id):
            current = self.tracker.get_current()
            if current is not None:
                performer.update(current)
            self.tracker.done_replicating(worker_id)

    def _perform_and_publish(self, worker_id: str, job) -> None:
        """Shared perform→publish protocol for the sync and async paths.

        per-job timing counter (ref: WorkerActor heartbeat ms logging,
        WorkerActor.java:198-202 / YARN WorkerNode StopWatch)."""
        performer: WorkerPerformer = self.performers[worker_id]
        t0 = time.perf_counter()
        performer.perform(job)
        # a heartbeat counter, not a benchmark: perform() ends in the
        # performer's own host read of its result
        self.tracker.increment("job_ms_total",
                               (time.perf_counter() - t0) * 1000.0)
        self.tracker.add_update(worker_id, job)
        self._update_arrived.set()  # wake the async master's heartbeat
        self.tracker.clear_job(worker_id)
        self.tracker.increment("jobs_done")
        self.tracker.increment(f"rounds.{worker_id}")

    def _worker_round(self, worker_id: str) -> None:
        self._replicate_if_needed(worker_id)
        job = self.tracker.job_for(worker_id)
        if job is None:
            return
        self._perform_and_publish(worker_id, job)

    def _check_early_stopping(self, updates) -> None:
        """Update bestLoss from the round's reported scores and trip the
        tracker's early-stop flag after `patience` non-improving evaluation
        rounds (ref: tracker earlyStop/bestLoss semantics). Called with the
        SAME updates snapshot the aggregation consumes, so no score slips
        between two separate tracker reads.

        One evaluation round = a fresh score from EVERY live worker
        (latest-wins per worker): the async master's heartbeat can tick
        with only a fast worker's update pending, and judging patience on
        that worker's noisy loss while a slower peer is mid-job (and
        improving) would trip spuriously — including during startup, before
        the slow worker's first job completes. Consequence: a worker whose
        performer never reports scores (or that silently crashed and has
        not yet been deregistered) disables the policy rather than letting
        it trip on partial evidence; the external tracker.early_stop() flag
        still halts everything immediately."""
        if self.early_stopping is None or self.tracker.is_early_stop():
            return
        for worker_id, j in updates.items():
            if j.score is not None:
                self._es_scores[worker_id] = j.score
        expected = set(self.performers)
        # prune deregistered workers: a dead worker's stale score must not
        # enter a later round's mean
        self._es_scores = {w: s for w, s in self._es_scores.items()
                           if w in expected}
        if not expected or not expected.issubset(self._es_scores):
            return
        loss = sum(self._es_scores.values()) / len(self._es_scores)
        self._es_scores.clear()
        if loss < self.tracker.best_loss() - self.early_stopping.min_delta:
            self.tracker.set_best_loss(loss)
            self._no_improve = 0
        else:
            self._no_improve += 1
            if self._no_improve >= self.early_stopping.patience:
                log.info("early stopping: %d rounds without improvement",
                         self._no_improve)
                self.tracker.early_stop()
                self.tracker.increment("early_stopped")

    def _handle_worker_failure(self, worker_id: str, exc: BaseException) -> None:
        """Dead-worker recovery (ref: MasterActor stale-job GC + tracker
        recentlyCleared re-route, MasterActor.java:115-142): the worker is
        deregistered and its in-flight job requeued for a surviving worker."""
        log.warning("worker %s failed: %s — rerouting its job", worker_id, exc)
        job = self.tracker.job_for(worker_id)
        self.tracker.clear_job(worker_id)
        self.tracker.remove_worker(worker_id)
        self.performers.pop(worker_id, None)
        self.tracker.increment("worker_failures")
        if job is not None:
            # queue for reassignment: assigning directly could clobber a
            # survivor's own in-flight job slot
            self._requeued.append(job)

    def train(self):
        """Run until the JobIterator is exhausted; returns the final
        averaged flat param vector (tracker current).

        Synchronous routers (IterativeReduce) barrier every round; an
        ``asynchronous`` router (HogWild) runs the barrier-free path."""
        if self.router.asynchronous:
            return self._train_async()
        workers = list(self.performers)
        with ThreadPoolExecutor(max_workers=len(workers)) as pool:
            rounds = 0
            while rounds < self.max_rounds:
                if self.tracker.is_early_stop():
                    log.info("sync train: early-stop flag set — stopping")
                    break
                rounds += 1
                # master: feed one job per IDLE worker — orphaned jobs from
                # failed workers first, then fresh ones from the iterator
                fed = False
                for worker_id in workers:
                    if self.tracker.job_for(worker_id) is not None:
                        continue
                    if self._requeued:
                        job = self._requeued.popleft()
                        job.worker_id = worker_id
                        self.tracker.add_job(job)
                        fed = True
                    elif self.job_iterator.has_next():
                        self.tracker.add_job(self.job_iterator.next(worker_id))
                        fed = True
                if (not fed and not self.tracker.has_pending_jobs()
                        and not self._requeued):
                    break
                # workers: one heartbeat each (parallel)
                futures = {w: pool.submit(self._worker_round, w)
                           for w in workers}
                wait(futures.values())
                for w, f in futures.items():
                    exc = f.exception()
                    if exc is None:
                        continue
                    if not self.fault_tolerant:
                        raise exc
                    self._handle_worker_failure(w, exc)
                    workers = list(self.performers)
                    if not workers:
                        raise RuntimeError(
                            "all workers failed"
                        ) from exc
                # master: aggregate when router policy allows (one snapshot
                # feeds both the early-stop check and the aggregation)
                if self.router.send_work():
                    snapshot = self.tracker.updates()
                    self._check_early_stopping(snapshot)
                    self.router.update(snapshot)
                    self.tracker.increment("aggregations")
                    if self.model_saver is not None:
                        current = self.tracker.get_current()
                        if current is not None:
                            self.model_saver.save(current)
            # final aggregation of any straggler updates
            if self.tracker.updates():
                self.router.update()
        self.tracker.finish()
        return self.tracker.get_current()

    # ------------------------------------------------------------------
    # asynchronous (Hogwild) execution — no per-round barrier
    # ------------------------------------------------------------------

    def _next_job(self, worker_id: str):
        """Hand the calling worker its next job (requeued orphans first),
        or None when the iterator is exhausted or the total-job bound
        (max_rounds × initial worker count — the async analogue of the sync
        path's per-round cap) is reached. Lock serializes only the hand-off,
        never the work."""
        with self._feed_lock:
            if self._requeued:
                job = self._requeued.popleft()
                job.worker_id = worker_id
                return job
            if self._async_jobs_left <= 0:
                return None
            if self.job_iterator.has_next():
                self._async_jobs_left -= 1
                return self.job_iterator.next(worker_id)
            return None

    def _worker_loop(self, worker_id: str, stop: threading.Event) -> None:
        """Continuous pull→perform→publish loop (ref: WorkerActor.java:168-206
        heartbeat, minus the barrier: the worker never waits for peers or for
        the master's aggregation)."""
        while not stop.is_set() and not self.tracker.is_early_stop():
            self._replicate_if_needed(worker_id)
            job = self._next_job(worker_id)
            if job is None:
                return
            self.tracker.add_job(job)
            self._perform_and_publish(worker_id, job)

    def _train_async(self):
        """Barrier-free Hogwild execution (ref: HogWildWorkRouter.java +
        MasterActor heartbeat): every worker loops at its own pace; the
        master aggregates whatever updates exist on each heartbeat tick, so
        fast workers fold in many more rounds than slow ones and nobody
        ever waits.

        ``async_timeout_s`` is a GRACEFUL stop: past the deadline no new
        jobs are handed out and the run ends once in-flight performs return
        — a wedged perform() still blocks (exactly as it would block the
        sync path's barrier); Python threads cannot be killed."""
        stop = threading.Event()
        workers = list(self.performers)
        self._async_jobs_left = self.max_rounds * max(len(workers), 1)
        deadline = (time.monotonic() + self.async_timeout_s
                    if self.async_timeout_s is not None else None)
        with ThreadPoolExecutor(max_workers=len(workers)) as pool:
            futures = {w: pool.submit(self._worker_loop, w, stop)
                       for w in workers}
            last_save = 0.0
            try:
                while any(not f.done() for f in futures.values()):
                    # event-driven heartbeat: wake when a worker publishes
                    # (set in _perform_and_publish) instead of busy-polling —
                    # a 2 ms sleep loop costs ~500 GIL wakeups/s that starve
                    # perform() on a 1-core host. heartbeat_s only bounds
                    # failure detection / deadline checks when no updates
                    # flow; aggregation latency does not depend on it.
                    self._update_arrived.wait(timeout=self.heartbeat_s)
                    # clear BEFORE snapshotting: an add_update racing this
                    # line either lands in the snapshot or re-sets the event
                    self._update_arrived.clear()
                    # deregister crashed workers NOW, not after the loop:
                    # a dead worker left in self.performers would block the
                    # early-stopping coverage rule for the whole run (ref
                    # posture: MasterActor's heartbeat clears dead workers'
                    # jobs continuously, MasterActor.java:115-142)
                    for w, f in list(futures.items()):
                        if f.done() and f.exception() is not None:
                            if not self.fault_tolerant:
                                raise f.exception()
                            self._handle_worker_failure(w, f.exception())
                            del futures[w]
                    # master heartbeat: aggregate whatever has arrived (one
                    # snapshot feeds the early-stop check AND the
                    # aggregation, so no score slips between two reads)
                    snapshot = self.tracker.updates()
                    if self.router.send_work() and snapshot:
                        self._check_early_stopping(snapshot)
                        self.router.update(snapshot)
                        self.tracker.increment("aggregations")
                        # save at most once per second (ref: MasterActor's
                        # 1 s tick / ModelSavingActor per MoreWorkMessage) —
                        # the aggregation heartbeat can be far hotter than
                        # any model serialization should be
                        now = time.monotonic()
                        if (self.model_saver is not None
                                and now - last_save >= 1.0):
                            current = self.tracker.get_current()
                            if current is not None:
                                self.model_saver.save(current)
                                last_save = now
                    if deadline is not None and time.monotonic() > deadline:
                        log.warning("async train: async_timeout_s hit, "
                                    "stopping with jobs unfinished")
                        with self._feed_lock:
                            # no fresh jobs after the deadline — the drain
                            # below may still reroute already-issued orphans
                            self._async_jobs_left = 0
                        break
            finally:
                stop.set()
            # failures that raced the loop's last tick
            for w, f in futures.items():
                exc = f.exception()
                if exc is None:
                    continue
                if not self.fault_tolerant:
                    raise exc
                self._handle_worker_failure(w, exc)
            if not self.performers:
                raise RuntimeError("all workers failed")
            # drain jobs orphaned by failed workers on the survivors
            # (repeat in case a survivor fails mid-drain); an early stop
            # abandons orphans deliberately — the run is over, and drain
            # workers would exit immediately anyway (hang otherwise)
            while self._requeued and not self.tracker.is_early_stop():
                if not self.performers:
                    raise RuntimeError("all workers failed")
                stop2 = threading.Event()
                futures = {w: pool.submit(self._worker_loop, w, stop2)
                           for w in list(self.performers)}
                wait(futures.values())
                for w, f in futures.items():
                    exc = f.exception()
                    if exc is not None:
                        if not self.fault_tolerant:
                            raise exc
                        self._handle_worker_failure(w, exc)
        # final aggregation of straggler updates + final model save (the
        # 1 s throttle above may have skipped the last in-loop save)
        if self.tracker.updates():
            self.router.update()
            self.tracker.increment("aggregations")
        if self.model_saver is not None:
            current = self.tracker.get_current()
            if current is not None:
                self.model_saver.save(current)
        self.tracker.finish()
        return self.tracker.get_current()
