"""Importable factories for the port's worker processes, the counterparts
of tests/_dist_helpers.py's: performers for ``python -m
deeplearning4j_tpu_torch.scaleout.distributed_runner --performer
_torch_dist_helpers:<factory>`` and the elastic toy model for ``python -m
deeplearning4j_tpu_torch.scaleout.elastic --model
_torch_dist_helpers:elastic_toy_model``. Each worker CLI calls its factory
with its JSON kwargs and ``device=``; these import torch and the port
only (the framework-free ``FaultyTrackerProxy`` stays in
tests/_dist_helpers.py, used from the test process)."""

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


# ------------------------------------------------------------- elastic ----

def elastic_toy_model(**kwargs):
    """Small deterministic ElasticModel for multi-process elastic tests,
    with the JAX helper's tiny defaults; kwargs (``device=`` included)
    override them."""
    from deeplearning4j_tpu_torch.scaleout.elastic import (
        SyntheticRegressionModel,
    )

    defaults = dict(d_in=4, d_hidden=8, batch=8, lr=0.05, seed=0,
                    mesh_devices=2)
    defaults.update(kwargs)
    return SyntheticRegressionModel(**defaults)
