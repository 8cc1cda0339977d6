"""Counterpart of ``deeplearning4j_tpu/nn/layers/autoencoder.py``: the
denoising autoencoder (ref:
nn/layers/feedforward/autoencoder/AutoEncoder.java:64-96).

encode = act(x·W + b), decode = act(h·Wᵀ + vb) (tied weights); the input
is corrupted by masking noise at ``conf.corruption_level``. The pretrain
objective is the conf's loss (default RECONSTRUCTION_CROSSENTROPY),
differentiated by autograd. The mask is drawn by ``get_corrupted_input``
from a torch generator: the stream is not JAX's, so parity tests inject
JAX's mask there.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers.dense import _bernoulli
from deeplearning4j_tpu_torch.nn.params import BIAS_KEY, VISIBLE_BIAS_KEY, \
    WEIGHT_KEY
from deeplearning4j_tpu_torch.ops.activations import activation
from deeplearning4j_tpu_torch.ops.losses import loss


def get_corrupted_input(key: int, x: torch.Tensor,
                        corruption_level: float) -> torch.Tensor:
    """Masking noise: zero each input element w.p. corruption_level
    (ref: AutoEncoder.java getCorruptedInput)."""
    keep = _bernoulli(key, 1.0 - corruption_level, x)
    return x * keep.to(x.dtype)


def encode(conf: NeuralNetConfiguration, params: Dict[str, torch.Tensor],
           x: torch.Tensor) -> torch.Tensor:
    act = activation(conf.activation_function)
    return act(x @ params[WEIGHT_KEY] + params[BIAS_KEY])


def decode(conf: NeuralNetConfiguration, params: Dict[str, torch.Tensor],
           h: torch.Tensor) -> torch.Tensor:
    act = activation(conf.activation_function)
    return act(h @ params[WEIGHT_KEY].T + params[VISIBLE_BIAS_KEY])


def forward(conf: NeuralNetConfiguration, params: Dict[str, torch.Tensor],
            x: torch.Tensor, *, train: bool = False,
            key: Optional[int] = None) -> torch.Tensor:
    return encode(conf, params, x)


def pretrain_loss(conf: NeuralNetConfiguration,
                  params: Dict[str, torch.Tensor], x: torch.Tensor,
                  key: int) -> torch.Tensor:
    corrupted = get_corrupted_input(key, x, conf.corruption_level)
    h = encode(conf, params, corrupted)
    recon = decode(conf, params, h)
    total = loss(conf.loss_function, x, recon)
    if conf.apply_sparsity and conf.sparsity > 0:
        # activation-sparsity penalty (ref: BasePretrainNetwork
        # applySparsity), an L1 penalty on the mean hidden activation
        total = total + conf.sparsity * h.abs().mean()
    return total
