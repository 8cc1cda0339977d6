"""Counterpart of ``deeplearning4j_tpu/scaleout/statetracker.py``, copied (no framework
in it).

StateTracker — the cluster-state API.

Parity with ref: scaleout/api/statetracker/StateTracker.java (workers, jobs,
updates, replication flags, counters, current best params, done/earlyStop)
and its Hazelcast implementation BaseHazelCastStateTracker.java:78-100.

The in-memory implementation is thread-safe (the reference's tests run the
whole cluster in one JVM against embedded Hazelcast; same play here — one
process, many threads, shared tracker). Its lock is the
``tracker.state`` lockwatch seam (``utils.lockwatch.make_rlock``).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.scaleout.job import Job
from deeplearning4j_tpu_torch.utils.lockwatch import make_rlock


class StateTracker:
    """Abstract API (ref: StateTracker.java)."""

    # workers
    def add_worker(self, worker_id: str) -> None: raise NotImplementedError
    def remove_worker(self, worker_id: str) -> None: raise NotImplementedError
    def workers(self) -> List[str]: raise NotImplementedError
    # jobs
    def add_job(self, job: Job) -> None: raise NotImplementedError
    def job_for(self, worker_id: str) -> Optional[Job]: raise NotImplementedError
    def clear_job(self, worker_id: str) -> None: raise NotImplementedError
    # updates
    def add_update(self, worker_id: str, job: Job) -> None: raise NotImplementedError
    def updates(self) -> Dict[str, Job]: raise NotImplementedError
    def clear_updates(self, expected: Optional[Dict[str, Job]] = None) -> None:
        """Clear updates. With ``expected`` (a prior updates() snapshot),
        remove ONLY entries still identical to the snapshot — an update a
        worker published after the snapshot survives for the next
        aggregation round (barrier-free Hogwild would otherwise lose it)."""
        raise NotImplementedError
    # current (averaged) result
    def set_current(self, result: Any) -> None: raise NotImplementedError
    def get_current(self) -> Any: raise NotImplementedError
    # replication
    def add_replicate(self, worker_id: str) -> None: raise NotImplementedError
    def needs_replicate(self, worker_id: str) -> bool: raise NotImplementedError
    def done_replicating(self, worker_id: str) -> None: raise NotImplementedError
    # generic KV blobs (the Hazelcast-map shape — last-write-wins
    # per key; telemetry federation pushes per-process registry snapshots
    # through these, exactly how the elastic membership rides the counters)
    def put_kv(self, key: str, value: Any) -> None: raise NotImplementedError
    def get_kv(self, key: str, default: Any = None) -> Any: raise NotImplementedError
    def kv_snapshot(self, prefix: str = "") -> Dict[str, Any]: raise NotImplementedError
    # counters / lifecycle
    def increment(self, key: str, by: float = 1.0) -> None: raise NotImplementedError
    def count(self, key: str) -> float: raise NotImplementedError
    def finish(self) -> None: raise NotImplementedError
    def is_done(self) -> bool: raise NotImplementedError
    def has_pending_jobs(self) -> bool: raise NotImplementedError
    # early stopping / best model (ref: tracker earlyStop/bestLoss) — the
    # runner calls these unconditionally, so they are part of the contract
    def set_best_loss(self, loss: float) -> None: raise NotImplementedError
    def best_loss(self) -> float: raise NotImplementedError
    def early_stop(self) -> None: raise NotImplementedError
    def is_early_stop(self) -> bool: raise NotImplementedError


class InMemoryStateTracker(StateTracker):
    """Thread-safe single-process tracker (the embedded-Hazelcast analogue).

    ``metrics_registry`` (a telemetry.MetricsRegistry) mirrors every
    ``increment`` into a registry counter of the same key, so scaleout
    workers' job_ms_total / jobs_done / rounds.* counters surface on the
    same Prometheus endpoint as the training metrics (dotted keys are
    sanitized at render time)."""

    def __init__(self, metrics_registry=None):
        self._registry = metrics_registry
        self._lock = make_rlock("tracker.state")  # lockwatch seam
        self._workers: List[str] = []
        self._jobs: Dict[str, Job] = {}
        self._updates: Dict[str, Job] = {}
        self._current: Any = None
        self._kv: Dict[str, Any] = {}
        self._replicate: set = set()
        self._counters: Dict[str, float] = defaultdict(float)
        self._done = False
        self._early_stop = False
        self._best_loss = float("inf")

    # ---- workers ----
    def add_worker(self, worker_id: str) -> None:
        with self._lock:
            if worker_id not in self._workers:
                self._workers.append(worker_id)

    def remove_worker(self, worker_id: str) -> None:
        with self._lock:
            if worker_id in self._workers:
                self._workers.remove(worker_id)

    def workers(self) -> List[str]:
        with self._lock:
            return list(self._workers)

    # ---- jobs ----
    def add_job(self, job: Job) -> None:
        with self._lock:
            self._jobs[job.worker_id] = job

    def job_for(self, worker_id: str) -> Optional[Job]:
        with self._lock:
            return self._jobs.get(worker_id)

    def clear_job(self, worker_id: str) -> None:
        with self._lock:
            self._jobs.pop(worker_id, None)

    def has_pending_jobs(self) -> bool:
        with self._lock:
            return bool(self._jobs)

    # ---- updates ----
    def add_update(self, worker_id: str, job: Job) -> None:
        with self._lock:
            self._updates[worker_id] = job

    def updates(self) -> Dict[str, Job]:
        with self._lock:
            return dict(self._updates)

    def clear_updates(self, expected: Optional[Dict[str, Job]] = None) -> None:
        with self._lock:
            if expected is None:
                self._updates.clear()
                return
            for worker_id, job in expected.items():
                if self._updates.get(worker_id) is job:
                    del self._updates[worker_id]

    # ---- current result ----
    def set_current(self, result: Any) -> None:
        with self._lock:
            self._current = result

    def get_current(self) -> Any:
        with self._lock:
            return self._current

    # ---- replication ----
    def add_replicate(self, worker_id: str) -> None:
        with self._lock:
            self._replicate.add(worker_id)

    def needs_replicate(self, worker_id: str) -> bool:
        with self._lock:
            return worker_id in self._replicate

    def done_replicating(self, worker_id: str) -> None:
        with self._lock:
            self._replicate.discard(worker_id)

    # ---- generic KV blobs ----
    def put_kv(self, key: str, value: Any) -> None:
        with self._lock:
            self._kv[str(key)] = value

    def get_kv(self, key: str, default: Any = None) -> Any:
        with self._lock:
            return self._kv.get(str(key), default)

    def kv_snapshot(self, prefix: str = "") -> Dict[str, Any]:
        """All KV entries under ``prefix`` in one read — the federation
        aggregator pays one RPC per collect, not one per process."""
        with self._lock:
            return {k: v for k, v in self._kv.items()
                    if k.startswith(prefix)}

    # ---- counters / lifecycle ----
    def increment(self, key: str, by: float = 1.0) -> None:
        with self._lock:
            self._counters[key] += by
        if self._registry is not None and by >= 0:
            self._registry.counter(key).inc(by)

    def count(self, key: str) -> float:
        with self._lock:
            return self._counters[key]

    def counters_snapshot(self, prefix: str = "") -> Dict[str, float]:
        """All counters under ``prefix`` in one read — a remote poller
        (elastic workers watching ``elastic.*``) pays one RPC instead of
        one per key."""
        with self._lock:
            return {k: v for k, v in self._counters.items()
                    if k.startswith(prefix)}

    def finish(self) -> None:
        with self._lock:
            self._done = True

    def is_done(self) -> bool:
        with self._lock:
            return self._done

    # ---- early stopping / best model (ref: tracker earlyStop/bestLoss) ----
    def set_best_loss(self, loss: float) -> None:
        with self._lock:
            self._best_loss = loss

    def best_loss(self) -> float:
        with self._lock:
            return self._best_loss

    def early_stop(self) -> None:
        with self._lock:
            self._early_stop = True

    def is_early_stop(self) -> bool:
        with self._lock:
            return self._early_stop
