"""Counterpart of ``deeplearning4j_tpu/scaleout/workrouter.py``, copied (no framework
in it).

Work routers — sync vs async aggregation policy.

Parity with ref: scaleout/api/workrouter/BaseWorkRouter.java:47-62 (update():
aggregate saved updates → setCurrent → mark replicates) and the Akka routers:
IterativeReduceWorkRouter (send work only when every worker has reported —
synchronous parameter averaging) and HogWildWorkRouter (always send — async).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.scaleout.aggregator import JobAggregator
from deeplearning4j_tpu_torch.scaleout.statetracker import StateTracker


class WorkRouter:
    #: True when workers run barrier-free and the master aggregates on its
    #: own cadence (ref: HogWildWorkRouter — MasterActor's heartbeat calls
    #: sendWork() every tick regardless of worker progress).
    asynchronous = False

    def __init__(self, tracker: StateTracker, aggregator: JobAggregator):
        self.tracker = tracker
        self.aggregator = aggregator

    def send_work(self) -> bool:
        """Whether the master may hand out the next round of jobs."""
        raise NotImplementedError

    def update(self, updates=None) -> None:
        """Aggregate worker updates into the tracker's current params and
        flag every worker for replication (ref: BaseWorkRouter.update).

        ``updates``: an existing tracker.updates() snapshot to aggregate
        (so a caller inspecting the round — e.g. early stopping — and the
        aggregation see the SAME jobs); taken fresh when omitted.

        Only the snapshotted updates are cleared: an update published
        between updates() and clear_updates() stays for the next round.
        Note the tracker keeps ONE slot per worker holding its latest FULL
        param snapshot (ref: LocalFileUpdateSaver keyed by worker id) — a
        newer snapshot from the same worker supersedes an un-aggregated
        older one (it embeds that training), and the identity check here
        guarantees a newer-unseen snapshot is never deleted unaggregated."""
        if updates is None:
            updates = self.tracker.updates()
        for job in updates.values():
            self.aggregator.accumulate(job)
        result = self.aggregator.aggregate()
        if result is not None:
            self.tracker.set_current(result)
        for worker_id in self.tracker.workers():
            self.tracker.add_replicate(worker_id)
        self.tracker.clear_updates(updates)
        if hasattr(self.aggregator, "reset"):
            self.aggregator.reset()


class IterativeReduceWorkRouter(WorkRouter):
    """Synchronous: wait for all workers (ref: IterativeReduceWorkRouter.java)."""

    def send_work(self) -> bool:
        workers = self.tracker.workers()
        return bool(workers) and len(self.tracker.updates()) >= len(workers)


class HogWildWorkRouter(WorkRouter):
    """Asynchronous: always route (ref: HogWildWorkRouter.java). With
    ``asynchronous=True`` the runner drops its per-round barrier entirely —
    workers pull/perform/publish continuously at their own pace (ref:
    WorkerActor.java:168-206) while the master aggregates whatever updates
    exist on each heartbeat."""

    asynchronous = True

    def send_work(self) -> bool:
        return True
