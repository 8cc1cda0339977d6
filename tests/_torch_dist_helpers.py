"""Importable performer factories for the port's distributed-runner worker
processes (``python -m deeplearning4j_tpu_torch.scaleout.distributed_runner
--performer _torch_dist_helpers:<factory>``), the counterparts of
tests/_dist_helpers.py's. The worker CLI calls each factory with its JSON
kwargs and ``device=``; these import torch and the port only."""

import os
import time

import numpy as np

from deeplearning4j_tpu_torch.scaleout.job import Job
from deeplearning4j_tpu_torch.scaleout.perform import (
    MultiLayerNetworkWorkPerformer,
    WorkerPerformer,
)


def iris_performer(conf_json: str, device=None
                   ) -> MultiLayerNetworkWorkPerformer:
    return MultiLayerNetworkWorkPerformer(conf_json, device=device)


class AveragingPerformer(WorkerPerformer):
    """Toy performer: result = work + current/10: cheap, deterministic,
    and parameter-coupled enough to prove replication round-trips."""

    def __init__(self, delay_s: float = 0.0):
        self.delay_s = delay_s
        self._current = 0.0

    def perform(self, job: Job) -> None:
        if self.delay_s:
            time.sleep(self.delay_s)
        job.result = np.asarray([float(job.work) + self._current / 10.0])
        job.score = abs(float(job.work))

    def update(self, *args) -> None:
        if args:
            self._current = float(np.asarray(args[0]).reshape(-1)[0])


def averaging_performer(delay_s: float = 0.0, device=None
                        ) -> AveragingPerformer:
    return AveragingPerformer(delay_s)


class CrashAfterOnePerformer(AveragingPerformer):
    """Performs exactly one job, then kills its own PROCESS without
    cleanup (os._exit: no atexit, no socket close), the hard-crash case
    the master's heartbeat fault detection must recover from."""

    def perform(self, job: Job) -> None:
        super().perform(job)
        # publish nothing: the crash must cost the cluster this job
        os._exit(17)


def crashing_performer(device=None) -> CrashAfterOnePerformer:
    return CrashAfterOnePerformer()
