"""Counterpart of ``deeplearning4j_tpu/scaleout/job.py``, copied (no framework
in it).

Job — a unit of distributable work.

Parity with ref: scaleout/job/Job.java:26-29 — (work, result, workerId).
"""

from __future__ import annotations

from typing import Any, Optional


class Job:
    def __init__(self, work: Any, worker_id: str = "", pending: bool = True):
        self.work = work
        self.result: Any = None
        self.worker_id = worker_id
        self.pending = pending
        #: training loss the performer observed for this job (None when the
        #: performer doesn't report one) — feeds the master's bestLoss /
        #: early-stop tracking (ref: StateTracker earlyStop/bestLoss)
        self.score: Optional[float] = None

    def __repr__(self) -> str:
        return f"Job(worker_id={self.worker_id!r}, done={self.result is not None})"


class JobIterator:
    """ref: scaleout/job/JobIterator.java — hands out Jobs per worker."""

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self, worker_id: str = "") -> Job:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class DataSetJobIterator(JobIterator):
    """Wraps a DataSetIterator; each Job's work is one DataSet mini-batch."""

    def __init__(self, it):
        self._it = it

    def has_next(self) -> bool:
        return self._it.has_next()

    def next(self, worker_id: str = "") -> Job:
        return Job(self._it.next(), worker_id)

    def reset(self) -> None:
        self._it.reset()


class CollectionJobIterator(JobIterator):
    """ref: scaleout/job/collection/CollectionJobIterator.java."""

    def __init__(self, items):
        self._items = list(items)
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._items)

    def next(self, worker_id: str = "") -> Job:
        job = Job(self._items[self._pos], worker_id)
        self._pos += 1
        return job

    def reset(self) -> None:
        self._pos = 0
