"""Counterpart of ``deeplearning4j_tpu/nn/multilayer.py``: the network
container.

API parity with ref: nn/multilayer/MultiLayerNetwork.java:63 —
init/fit/feedForward/output/predict/score/params/setParams/merge/clone,
JSON conf round-trip, and save/load of (conf JSON + flat param vector) in
the JAX package's ``.npz`` layout, so a checkpoint written by either
package loads in the other.

The network lives on one device: CUDA unless ``device="cpu"``. Everything
runs through the functional core in ``nn/functional.py``; this class owns
state (params tree, updater state, keys) and the host-side loops. Greedy
pretraining, finetuning and listeners wait for the solvers and listeners
of ROADMAP slice 5 and raise ``NotImplementedError`` until then.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import DeviceLike, resolve_device, \
    tree_map, tree_zip_map
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator, \
    ListDataSetIterator
from deeplearning4j_tpu_torch.nn import functional as F
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.gradient import flatten_params, num_params, \
    unflatten_params
from deeplearning4j_tpu_torch.ops.rng import KeySequence

DataLike = Union[DataSet, DataSetIterator]

_SOLVERS_SLICE = ("ROADMAP slice 5, item 14 (solvers and listeners) with "
                  "item 13 (pretraining layers)")


def _as_iterator(data, labels=None,
                 batch_size: Optional[int] = None) -> DataSetIterator:
    if isinstance(data, DataSetIterator):
        return data
    if isinstance(data, DataSet):
        ds = data
    else:
        ds = DataSet(np.asarray(data),
                     None if labels is None else np.asarray(labels))
    return ListDataSetIterator(ds, batch_size or ds.num_examples())


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration, params=None,
                 device: DeviceLike = None):
        if isinstance(conf, str):
            conf = MultiLayerConfiguration.from_json(conf)
        self.conf = conf
        self.device = resolve_device(device)
        self._params = (None if params is None else
                        tree_map(lambda _, p: p.to(self.device), params))
        self._train_state = None
        self._train_step = None
        self._iteration = 0
        self._keys = KeySequence(conf.conf(0).seed if conf.n_layers else 123)
        self.listeners: List = []

    # ---- lifecycle ----
    def init(self) -> "MultiLayerNetwork":
        """Build params from confs (ref: MultiLayerNetwork.init :330-422)."""
        if self._params is None:
            self._params = F.init_params(self.conf, self._keys.next(),
                                         self.device)
        return self

    @property
    def params_tree(self):
        if self._params is None:
            self.init()
        return self._params

    def set_listeners(self, listeners: Sequence) -> None:
        if listeners:
            raise NotImplementedError(
                f"iteration listeners are not ported yet: they come with "
                f"{_SOLVERS_SLICE}")
        self.listeners = []

    # ---- flat parameter vector API (ref: params/setParams :744-835) ----
    def params(self) -> torch.Tensor:
        return flatten_params(self.params_tree)

    def set_params(self, flat) -> None:
        self._params = unflatten_params(self.params_tree,
                                        torch.as_tensor(flat))

    def num_params(self) -> int:
        return num_params(self.params_tree)

    # ---- inference ----
    def _input(self, x) -> torch.Tensor:
        return F.to_device(x, self.device)

    def feed_forward(self, x) -> List[torch.Tensor]:
        with torch.no_grad():
            return F.feed_forward(self.conf, self.params_tree,
                                  self._input(x))

    def output(self, x) -> torch.Tensor:
        with torch.no_grad():
            return F.output(self.conf, self.params_tree, self._input(x))

    def predict(self, x) -> np.ndarray:
        """Argmax class per example (ref: MultiLayerNetwork.predict
        :1094)."""
        return self.output(x).argmax(-1).cpu().numpy()

    def label_probabilities(self, x) -> torch.Tensor:
        return self.output(x)

    def score(self, data: DataLike, labels=None) -> float:
        if data is None:
            raise ValueError(
                "score() requires a DataSet/iterator (features+labels)")
        it = _as_iterator(data, labels)
        total, n = 0.0, 0
        with torch.no_grad():
            for batch in it:
                b = batch.num_examples()
                total += float(F.score(self.conf, self.params_tree,
                                       self._input(batch.features),
                                       self._input(batch.labels))) * b
                n += b
        return total / max(n, 1)

    # ---- training ----
    def fit(self, data: DataLike, labels=None,
            batch_size: Optional[int] = None) -> None:
        """Backprop over every batch, ``num_iterations`` steps each (ref:
        MultiLayerNetwork.fit :936-956). A conf with ``pretrain=True``
        needs the pretrain and finetune phases, which are not ported
        yet."""
        if self.conf.pretrain:
            raise NotImplementedError(
                f"fit() on a conf with pretrain=True runs pretrain() and "
                f"finetune(), which come with {_SOLVERS_SLICE}")
        it = _as_iterator(data, labels, batch_size)
        if self.conf.backward:
            it.reset()
            for batch in it:
                self._do_backward(batch.features, batch.labels)

    def _ensure_train_step(self):
        if self._train_step is None:
            self._train_step = F.make_train_step(self.conf)
        if self._train_state is None:
            self._train_state = F.init_train_state(self.conf,
                                                   self.params_tree)

    def _do_backward(self, features, labels) -> None:
        """numIterations train steps on one batch
        (ref: MultiLayerNetwork.doBackWard :959-1010)."""
        if labels is None:
            raise ValueError(
                "No labels found (supervised fit requires labels)")
        self._ensure_train_step()
        x, y = self._input(features), self._input(labels)
        params, state = self.params_tree, self._train_state
        for _ in range(self.conf.conf(0).num_iterations):
            params, state, _ = self._train_step(
                params, state, self._iteration, x, y, self._keys.next())
            self._iteration += 1
        self._params, self._train_state = params, state

    def fit_epochs(self, data: DataLike, num_epochs: int = 1, labels=None,
                   batch_size: Optional[int] = None) -> None:
        """Epoch-style supervised training, one step per batch;
        numIterations-per-batch semantics remain available via fit()."""
        self._ensure_train_step()
        it = _as_iterator(data, labels, batch_size)
        params, state = self.params_tree, self._train_state
        for _ in range(num_epochs):
            it.reset()
            for batch in it:
                params, state, _ = self._train_step(
                    params, state, self._iteration,
                    self._input(batch.features), self._input(batch.labels),
                    self._keys.next())
                self._iteration += 1
        self._params, self._train_state = params, state

    def pretrain(self, data: DataLike, labels=None) -> None:
        """Greedy layerwise unsupervised pretraining
        (ref: MultiLayerNetwork.pretrain :150-191)."""
        raise NotImplementedError(f"pretrain() comes with {_SOLVERS_SLICE}")

    def finetune(self, data: DataLike, labels=None) -> None:
        """Train the OUTPUT head on top-of-stack activations
        (ref: MultiLayerNetwork.finetune :1033-1084)."""
        raise NotImplementedError(f"finetune() comes with {_SOLVERS_SLICE}")

    # ---- distributed parity ----
    def merge(self, other: "MultiLayerNetwork", batch_size: int) -> None:
        """Parameter-averaging hook (ref: MultiLayerNetwork.merge :1358,
        BaseLayer.merge :354: params += other.params / batchSize)."""
        if other.conf.n_layers != self.conf.n_layers:
            raise ValueError(
                "Unable to merge networks that are not of equal length")
        self._params = tree_zip_map(lambda p, o: p + o / batch_size,
                                    self.params_tree, other.params_tree)

    def clone(self) -> "MultiLayerNetwork":
        return MultiLayerNetwork(self.conf, params=self.params_tree,
                                 device=self.device)

    # ---- persistence (conf JSON + flat params, ref ctor :99) ----
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(
            path if path.endswith(".npz") else path + ".npz",
            params=self.params().detach().cpu().numpy(),
            conf=np.frombuffer(self.conf.to_json().encode(), dtype=np.uint8),
        )

    @classmethod
    def load(cls, path: str,
             device: DeviceLike = None) -> "MultiLayerNetwork":
        if not path.endswith(".npz") and os.path.exists(path + ".npz"):
            path = path + ".npz"
        with np.load(path) as z:
            conf = MultiLayerConfiguration.from_json(bytes(z["conf"]).decode())
            net = cls(conf, device=device)
            net.init()
            net.set_params(z["params"])
        return net

    # ---- JSON conf parity helpers ----
    def to_json(self) -> str:
        return self.conf.to_json()

    @classmethod
    def from_json(cls, s: str,
                  device: DeviceLike = None) -> "MultiLayerNetwork":
        return cls(MultiLayerConfiguration.from_json(s), device=device)
