"""Counterpart of ``deeplearning4j_tpu/scaleout/distributed_runner.py``:
multi-process master/worker training over the remote StateTracker.

Parity with ref: actor/runner/DeepLearning4jDistributed.java boots a
master actor + worker actors on separate JVMs joined through the Hazelcast
tracker; here ``DistributedMaster`` embeds ``StateTrackerServer`` and each
``DistributedWorker`` (separate OS process, see ``worker_main``) connects a
``StateTrackerClient``. The round protocol, routers, aggregators and
early-stopping policy are the SAME objects the in-process
LocalDistributedRunner uses; the tracker is the only seam, exactly the
reference's design (MasterActor.java:106-142, WorkerActor.java:168-206).

Payloads on the wire are host data, as in the JAX package: numpy arrays or
CPU tensors. A CUDA tensor inside a ``Job`` would pickle as CUDA storage
and fail on a receiver without a card, so the master moves each job's work
and the worker each job's work and result to the host before they go on
the wire (``_host``). A performer computes on its own device: the worker
CLI takes ``--device`` (CUDA unless ``cpu``) and hands it to the performer
factory.

Fault model (ref posture: MasterActor clears dead workers' jobs on its
heartbeat): every worker runs a daemon heartbeat thread bumping the
``hb.<worker-id>`` counter; the master requeues the jobs of any worker
whose heartbeat goes stale for ``worker_timeout_s`` and deregisters it:
a worker process crash (or kill -9) costs its in-flight job one reroute,
never the run.
"""

from __future__ import annotations

import argparse
import importlib
import json
import logging
import threading
import time
import uuid
from collections import deque
from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch._device import resolve_device, tree_map
from deeplearning4j_tpu_torch.scaleout.aggregator import \
    ParameterAveragingAggregator
from deeplearning4j_tpu_torch.scaleout.job import Job, JobIterator
from deeplearning4j_tpu_torch.scaleout.model_saver import ModelSaver
from deeplearning4j_tpu_torch.scaleout.perform import WorkerPerformer
from deeplearning4j_tpu_torch.scaleout.remote_tracker import (
    StateTrackerClient,
    StateTrackerServer,
)
from deeplearning4j_tpu_torch.scaleout.runner import EarlyStopping
from deeplearning4j_tpu_torch.scaleout.workrouter import (
    IterativeReduceWorkRouter,
    WorkRouter,
)

log = logging.getLogger(__name__)


def _host(job: Job) -> Job:
    """Move every tensor in the job's work and result (through dicts,
    tuples and lists) to the CPU, in place, so the job pickles without a
    card on either side."""
    def cpu(_, x):
        return x.detach().cpu() if isinstance(x, torch.Tensor) else x

    job.work = tree_map(cpu, job.work)
    job.result = tree_map(cpu, job.result)
    return job


class DistributedWorker:
    """Worker-process loop: register → poll job → perform → publish.

    (ref: WorkerActor heartbeat pull/perform/publish, minus Akka.)"""

    def __init__(self, address: str, performer: WorkerPerformer,
                 worker_id: Optional[str] = None, poll_s: float = 0.02,
                 heartbeat_s: float = 0.25):
        self.address = address
        self.tracker = StateTrackerClient(address)
        self.worker_id = worker_id or f"worker-{uuid.uuid4().hex[:8]}"
        self.performer = performer
        self.poll_s = poll_s
        self.heartbeat_s = heartbeat_s

    def _heartbeat_loop(self, stop: threading.Event) -> None:
        # separate client connection: the main loop holds the RPC lock for
        # the whole perform() round-trip, and a stalled heartbeat is
        # exactly what the master interprets as death
        hb = StateTrackerClient(self.address)
        try:
            while not stop.is_set():
                hb.increment(f"hb.{self.worker_id}")
                stop.wait(self.heartbeat_s)
        except (ConnectionError, OSError) as exc:
            # master gone; main loop will notice too — but a silent dead
            # heartbeat is indistinguishable from a healthy idle one
            log.warning("worker %s heartbeat loop died: %r",
                        self.worker_id, exc)
            return
        finally:
            hb.close()

    def run(self) -> None:
        t = self.tracker
        t.add_worker(self.worker_id)
        stop = threading.Event()
        hb_thread = threading.Thread(target=self._heartbeat_loop,
                                     args=(stop,), daemon=True)
        hb_thread.start()
        try:
            while not (t.is_done() or t.is_early_stop()):
                if t.needs_replicate(self.worker_id):
                    current = t.get_current()
                    if current is not None:
                        self.performer.update(current)
                    t.done_replicating(self.worker_id)
                job = t.job_for(self.worker_id)
                if job is None:
                    time.sleep(self.poll_s)
                    continue
                t0 = time.perf_counter()
                self.performer.perform(job)
                # a counter, not a measurement: perform() ends in the
                # performer's own read of its result to the host
                t.increment("job_ms_total",
                            (time.perf_counter() - t0) * 1000.0)
                t.add_update(self.worker_id, _host(job))
                t.clear_job(self.worker_id)
                t.increment("jobs_done")
                t.increment(f"rounds.{self.worker_id}")
        finally:
            stop.set()
            hb_thread.join(timeout=10)  # deterministic shutdown: the loop
            self.tracker.close()        # wakes from stop.wait immediately


class DistributedMaster:
    """Master-process loop around an embedded StateTrackerServer: feeds
    jobs, aggregates per the router's policy, recovers worker failures,
    enforces early stopping. ``train()`` returns the aggregated params."""

    def __init__(
        self,
        job_iterator: JobIterator,
        router: Optional[WorkRouter] = None,
        server: Optional[StateTrackerServer] = None,
        min_workers: int = 1,
        max_rounds: int = 10_000,
        worker_timeout_s: float = 15.0,
        register_timeout_s: float = 60.0,
        model_saver: Optional[ModelSaver] = None,
        early_stopping: Optional[EarlyStopping] = None,
        tick_s: float = 0.02,
    ):
        self.server = server or StateTrackerServer()
        self.tracker = self.server.tracker  # embedded: zero-IPC master side
        self.router = router or IterativeReduceWorkRouter(
            self.tracker, ParameterAveragingAggregator())
        self.job_iterator = job_iterator
        self.min_workers = min_workers
        self.max_rounds = max_rounds
        self.worker_timeout_s = worker_timeout_s
        self.register_timeout_s = register_timeout_s
        self.model_saver = model_saver
        self.early_stopping = early_stopping
        self.tick_s = tick_s
        self._requeued: deque = deque()
        self._jobs_left = 0
        self._hb_seen: Dict[str, tuple] = {}  # wid -> (count, wallclock)
        self._no_improve = 0
        self._es_scores: Dict[str, float] = {}

    @property
    def address(self) -> str:
        return self.server.address

    # ---- fault detection ----
    def _dead_workers(self) -> list:
        now = time.monotonic()
        dead = []
        for wid in self.tracker.workers():
            count = self.tracker.count(f"hb.{wid}")
            seen = self._hb_seen.get(wid)
            if seen is None or seen[0] != count:
                self._hb_seen[wid] = (count, now)
            elif now - seen[1] > self.worker_timeout_s:
                dead.append(wid)
        return dead

    def _bury(self, wid: str) -> None:
        job = self.tracker.job_for(wid)
        if job is not None:
            self._requeued.append(job)
            self.tracker.clear_job(wid)
        self.tracker.remove_worker(wid)
        self._hb_seen.pop(wid, None)
        self._es_scores.pop(wid, None)
        self.tracker.increment("workers_failed")
        log.warning("worker %s heartbeat stale >%ss: job requeued, "
                    "deregistered", wid, self.worker_timeout_s)

    # ---- early stopping (same policy as LocalDistributedRunner) ----
    def _check_early_stopping(self, snapshot) -> None:
        if self.early_stopping is None:
            return
        for wid, job in snapshot.items():
            if job.score is not None:
                self._es_scores[wid] = float(job.score)
        live = set(self.tracker.workers())
        if not live or not live.issubset(self._es_scores.keys()):
            return  # full-coverage rule: every live worker must have scored
        mean = sum(self._es_scores[w] for w in live) / len(live)
        self._es_scores = {}
        best = self.tracker.best_loss()
        if mean < best - self.early_stopping.min_delta:
            self.tracker.set_best_loss(mean)
            self._no_improve = 0
        else:
            self._no_improve += 1
            if self._no_improve >= self.early_stopping.patience:
                self.tracker.early_stop()

    # ---- job feeding ----
    def _feed_idle_workers(self) -> None:
        for wid in self.tracker.workers():
            if self.tracker.job_for(wid) is not None:
                continue
            if self._requeued:
                job = self._requeued.popleft()
                job.worker_id = wid
            elif self._jobs_left > 0 and self.job_iterator.has_next():
                self._jobs_left -= 1
                job = self.job_iterator.next(wid)
            else:
                continue
            self.tracker.add_job(_host(job))

    def _wait_for_workers(self) -> None:
        deadline = time.monotonic() + self.register_timeout_s
        while len(self.tracker.workers()) < self.min_workers:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{len(self.tracker.workers())}/{self.min_workers} "
                    f"workers registered within {self.register_timeout_s}s")
            time.sleep(0.05)

    def train(self):
        self._wait_for_workers()
        self._jobs_left = self.max_rounds * max(
            len(self.tracker.workers()), 1)
        last_save = 0.0
        try:
            while not self.tracker.is_early_stop():
                for wid in self._dead_workers():
                    self._bury(wid)
                if not self.tracker.workers():
                    raise RuntimeError("all workers failed")
                self._feed_idle_workers()
                snapshot = self.tracker.updates()
                if snapshot and self.router.send_work():
                    self._check_early_stopping(snapshot)
                    self.router.update(snapshot)
                    self.tracker.increment("aggregations")
                    now = time.monotonic()
                    if (self.model_saver is not None
                            and now - last_save >= 1.0):
                        current = self.tracker.get_current()
                        if current is not None:
                            self.model_saver.save(current)
                            last_save = now
                drained = (not self._requeued
                           and (self._jobs_left <= 0
                                or not self.job_iterator.has_next()))
                if drained and not self.tracker.has_pending_jobs():
                    # workers publish BEFORE clearing their job, so with
                    # nothing pending no further update can ever arrive —
                    # a sync router's barrier can no longer be met and
                    # waiting on updates() would livelock; the straggler
                    # flush below aggregates whatever remains
                    break
                time.sleep(self.tick_s)
            # stragglers published after the last aggregation
            if self.tracker.updates():
                self.router.update()
                self.tracker.increment("aggregations")
            if self.model_saver is not None:
                current = self.tracker.get_current()
                if current is not None:
                    self.model_saver.save(current)
        finally:
            self.tracker.finish()  # releases every worker's poll loop
        return self.tracker.get_current()

    def shutdown(self) -> None:
        self.server.shutdown()


def _resolve_performer(spec: str, kwargs: dict) -> WorkerPerformer:
    """"pkg.module:callable" -> callable(**kwargs) -> WorkerPerformer."""
    module_name, _, attr = spec.partition(":")
    factory = getattr(importlib.import_module(module_name), attr)
    return factory(**kwargs)


def worker_main(argv=None) -> None:
    """CLI worker entry: ``python -m
    deeplearning4j_tpu_torch.scaleout.distributed_runner --connect
    HOST:PORT --performer pkg.mod:factory [--kwargs-json '{...}']
    [--worker-id ID] [--device {cuda,cpu}]`` (the analogue of launching
    the reference's WorkerNode JVM). The factory is called with the JSON
    kwargs and ``device=``, the resolved ``--device`` (CUDA unless
    ``cpu``; raises when CUDA is asked for and absent)."""
    p = argparse.ArgumentParser(description="distributed training worker")
    p.add_argument("--connect", required=True, help="master tracker host:port")
    p.add_argument("--performer", required=True,
                   help="pkg.module:factory for the WorkerPerformer")
    p.add_argument("--kwargs-json", default="{}",
                   help="JSON kwargs for the performer factory")
    p.add_argument("--worker-id", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the performer's device (default cuda)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    performer = _resolve_performer(
        args.performer, dict(json.loads(args.kwargs_json), device=device))
    DistributedWorker(args.connect, performer,
                      worker_id=args.worker_id).run()


if __name__ == "__main__":
    worker_main()
