"""Counterpart of ``deeplearning4j_tpu/scaleout/iterative_reduce.py``: the
IterativeReduce superstep runtime (YARN-runtime parity).

Parity with ref hadoop-yarn cdh4 module: the ComputableMaster /
ComputableWorker SPI (iterativereduce/runtime/Computable{Master,Worker}.java),
the superstep loop of ApplicationWorkerService.run (:203-280 — compute →
send update → barrier → receive master update), and the in-process IRUnit
simulator (iterativereduce/irunit/IRUnitDriver.java) that runs one master +
N workers in a single process over file splits.

The control plane is threads + a barrier in one process (the
reference's Avro-RPC master↔worker exchange is host-side Java
serialization; here workers already share an address space). The default
model implementations run their per-worker fit on the device (CUDA unless
``device="cpu"``; on the card each dense layer runs the fused-dense
kernel, K1); cross-worker averaging of flat param vectors happens
host-side exactly like the reference's Master.compute — the collective
path lives in parallel/trainer.py. A worker's net draws its initial params
with torch: a run held against the JAX package puts JAX's params in
through ``update()`` first.
"""

from __future__ import annotations

import threading
from typing import Any, Generic, List, Optional, Sequence, TypeVar

import numpy as np

T = TypeVar("T")


class ComputableMaster(Generic[T]):
    """ref: ComputableMaster.java — compute() merges worker updates."""

    def compute(self, worker_updates: Sequence[T], master_update: Optional[T]) -> T:
        raise NotImplementedError

    def complete(self) -> None:
        """Called once after the final superstep (ref writes final state)."""


class ComputableWorker(Generic[T]):
    """ref: ComputableWorker.java — compute() one batch, update() receives
    the master's merged state."""

    def compute(self) -> Optional[T]:
        """One superstep of local work; None signals this worker is done."""
        raise NotImplementedError

    def update(self, master_update: T) -> None:
        raise NotImplementedError


class IterativeReduceRunner(Generic[T]):
    """In-process superstep driver (ref IRUnitDriver): all workers compute,
    barrier, master merges, update fan-out — until every worker reports done
    or max_supersteps is hit."""

    def __init__(self, master: ComputableMaster[T],
                 workers: Sequence[ComputableWorker[T]],
                 max_supersteps: int = 1000):
        if not workers:
            raise ValueError("need at least one worker")
        self.master = master
        self.workers = list(workers)
        self.max_supersteps = max_supersteps
        self.supersteps_run = 0
        self.master_update: Optional[T] = None

    def run(self) -> Optional[T]:
        n = len(self.workers)
        for _ in range(self.max_supersteps):
            updates: List[Optional[T]] = [None] * n
            errors: List[BaseException] = []

            def work(idx: int) -> None:
                try:
                    updates[idx] = self.workers[idx].compute()
                except BaseException as e:  # surfaced after the join barrier
                    errors.append(e)

            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()  # ══ superstep barrier (ref waiting() poll loop)
            if errors:
                # ref: AM tallies worker errors and aborts nonzero
                # (ApplicationMasterService.java:163-189)
                raise errors[0]
            live = [u for u in updates if u is not None]
            if not live:
                break
            self.supersteps_run += 1
            self.master_update = self.master.compute(live, self.master_update)
            for w in self.workers:
                w.update(self.master_update)
        self.master.complete()
        return self.master_update


# ------------------------- default MultiLayerNetwork master/worker impls ----

class ParameterAveragingMaster(ComputableMaster[np.ndarray]):
    """ref impl/multilayer/Master.java: average flat param vectors."""

    def compute(self, worker_updates, master_update=None) -> np.ndarray:
        return np.mean([np.asarray(u) for u in worker_updates], axis=0)


class NetworkWorker(ComputableWorker[np.ndarray]):
    """ref impl/multilayer/WorkerNode.java: fit one local batch per
    superstep, emit the resulting flat params; absorb averaged params."""

    def __init__(self, conf, features: np.ndarray, labels: np.ndarray,
                 supersteps: int = 1, device=None):
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        self.net = MultiLayerNetwork(conf, device=device).init()
        self.features = features
        self.labels = labels
        self.remaining = supersteps

    def compute(self) -> Optional[np.ndarray]:
        if self.remaining <= 0:
            return None
        self.remaining -= 1
        self.net.fit(self.features, self.labels)
        return self.net.params().detach().cpu().numpy()

    def update(self, master_update: np.ndarray) -> None:
        self.net.set_params(master_update)


def run_iterative_reduce(conf, features: np.ndarray, labels: np.ndarray,
                         n_workers: int = 2, supersteps: int = 3,
                         device=None):
    """Convenience IRUnit-style entry: split data row-wise over workers
    (ref TextInputFormat splits), run the superstep loop, return a network
    holding the final averaged params."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    splits_x = np.array_split(features, n_workers)
    splits_y = np.array_split(labels, n_workers)
    workers = [
        NetworkWorker(conf, sx, sy, supersteps=supersteps, device=device)
        for sx, sy in zip(splits_x, splits_y)
    ]
    runner = IterativeReduceRunner(ParameterAveragingMaster(), workers)
    final = runner.run()
    net = MultiLayerNetwork(conf, device=device).init()
    if final is not None:
        net.set_params(final)
    return net, runner
