"""Counterpart of ``deeplearning4j_tpu/scaleout/model_saver.py``: the
ModelSaver SPI, checkpointing the aggregated model.

Parity with ref: actor/core/ModelSaver / DefaultModelSaver (java serialization
to file, saved by ModelSavingActor on every aggregation round). Format here is
the framework checkpoint (conf JSON + flat params npz), the same one
MultiLayerNetwork.save/load uses, so a file of either package loads in the
other.
"""

from __future__ import annotations

import os

import numpy as np

from deeplearning4j_tpu_torch._device import DeviceLike


class ModelSaver:
    def save(self, model) -> None:
        raise NotImplementedError

    def load(self):
        raise NotImplementedError


class FileModelSaver(ModelSaver):
    """ref: actor/core/DefaultModelSaver.java. ``load`` rebuilds the net on
    ``device`` (CUDA unless ``device="cpu"``)."""

    def __init__(self, path: str = "nn-model.npz", device: DeviceLike = None):
        self.path = path if path.endswith(".npz") else path + ".npz"
        self.device = device

    def save(self, model) -> None:
        model.save(self.path)

    def load(self):
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        return MultiLayerNetwork.load(self.path, device=self.device)

    def exists(self) -> bool:
        return os.path.exists(self.path)


class ParamsOnlySaver(ModelSaver):
    """Save just the flat parameter vector (ref: CLI Train writes params
    binary via Nd4j.write, cli/subcommands/Train.java)."""

    def __init__(self, path: str):
        self.path = path

    def save(self, model) -> None:
        np.save(self.path if self.path.endswith(".npy") else self.path + ".npy",
                model.params().detach().cpu().numpy())

    def load(self):
        p = self.path if self.path.endswith(".npy") else self.path + ".npy"
        return np.load(p)
