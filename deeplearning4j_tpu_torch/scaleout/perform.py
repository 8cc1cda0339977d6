"""Counterpart of ``deeplearning4j_tpu/scaleout/perform.py``: the
WorkerPerformer, worker-side compute.

Parity with ref: scaleout/perform/WorkerPerformer.java {perform(Job),
update(Object...)} and the Akka BaseMultiLayerNetworkWorkPerformer (fromJson
conf → net.setParameters(current) → net.fit(DataSet) → result = params).

Each job fits a fresh ``MultiLayerNetwork`` on the performer's device
(CUDA unless ``device="cpu"``); on the card every dense layer runs the
fused-dense kernel (K1). A fresh net draws its initial params with torch,
not JAX, so a run that must match the JAX package puts the master params
in through ``update()`` before the first job. Each net keeps its own key
stream: no generator is shared between the runner's worker threads.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch._device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.scaleout.job import Job


class WorkerPerformer:
    def perform(self, job: Job) -> None:
        raise NotImplementedError

    def update(self, *args) -> None:
        raise NotImplementedError


class MultiLayerNetworkWorkPerformer(WorkerPerformer):
    """Fit a network on the job's DataSet; result = flat params as a host
    array (ref: perform/BaseMultiLayerNetworkWorkPerformer.java)."""

    def __init__(self, conf_json: str, device: DeviceLike = None):
        self.conf_json = conf_json
        self.device = resolve_device(device)
        self._params: Optional[np.ndarray] = None

    def perform(self, job: Job) -> None:
        net = MultiLayerNetwork.from_json(self.conf_json, device=self.device)
        net.init()
        if self._params is not None:
            net.set_params(self._params)
        data = job.work
        if not isinstance(data, DataSet):
            raise TypeError(f"expected DataSet work, got {type(data)}")
        # capture the last training-iteration loss through the listener
        # chain — the master's bestLoss / early-stop signal (ref: tracker
        # bestLoss updates) at zero extra compute (no post-fit forward)
        last_score: list = []
        net.listeners.append(
            lambda _net, _it, s: last_score.append(float(s)))
        net.fit(data)
        job.result = net.params().detach().cpu().numpy()
        job.score = last_score[-1] if last_score else None

    def update(self, *args) -> None:
        """Receive the averaged master params (ref: performer.update)."""
        if args:
            self._params = np.asarray(args[0])
