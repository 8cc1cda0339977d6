"""Counterpart of ``deeplearning4j_tpu/nn/layers/dense.py``: the dense
(fully-connected) layer.

Parity with the reference's BaseLayer: preOutput = x·W + b
(ref: nn/layers/BaseLayer.java:272-281), activation via the registry
(ref: BaseLayer.java:294), inverted-dropout masking during training
(ref: BaseLayer.java:333 applyDropOutIfNecessary). The forward goes through
``ops.pallas_kernels.fused_dense`` (kernel K1 on the card) under the JAX
layer's conditions: 2-D input, no drop-connect in training, an activation
K1 fuses, and ``use_fused_dense()``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.params import BIAS_KEY, WEIGHT_KEY
from deeplearning4j_tpu_torch.ops.activations import activation
from deeplearning4j_tpu_torch.ops.pallas_kernels import (
    _FUSABLE,
    fused_dense,
    use_fused_dense,
)
from deeplearning4j_tpu_torch.ops.rng import generator, split

_DROP_CONNECT_KEEP = 0.5  # ref BaseLayer drop-connect keeps weights w.p. 0.5


def _bernoulli(key: int, p: float, like: torch.Tensor) -> torch.Tensor:
    """A mask shaped like ``like``, True with probability ``p``
    (``jax.random.bernoulli``: a uniform draw below ``p``)."""
    u = torch.rand(like.shape, generator=generator(key, like.device),
                   device=like.device)
    return u < p


def pre_output(conf: NeuralNetConfiguration,
               params: Dict[str, torch.Tensor], x: torch.Tensor, *,
               train: bool = False, key: Optional[int] = None,
               drop_connect: bool = False) -> torch.Tensor:
    w = params[WEIGHT_KEY]
    if drop_connect and train and key is not None:
        # inverted drop-connect on the weight matrix (ref: BaseLayer.preOutput
        # conf.isUseDropConnect branch)
        mask = _bernoulli(key, _DROP_CONNECT_KEEP, w)
        w = torch.where(mask, w / _DROP_CONNECT_KEEP, 0.0)
    return x @ w + params[BIAS_KEY]


def apply_dropout(x: torch.Tensor, rate: float, train: bool,
                  key: Optional[int]) -> torch.Tensor:
    if not train or rate <= 0.0 or key is None:
        return x
    keep = 1.0 - rate
    return torch.where(_bernoulli(key, keep, x), x / keep, 0.0)


def forward(conf: NeuralNetConfiguration, params: Dict[str, torch.Tensor],
            x: torch.Tensor, *, train: bool = False,
            key: Optional[int] = None,
            drop_connect: bool = False) -> torch.Tensor:
    kdrop = kdc = None
    if key is not None:
        kdrop, kdc = split(key)
    x = apply_dropout(x, conf.dropout, train, kdrop)
    # fused matmul+bias+activation kernel when enabled; the masked
    # (drop-connect) pre_output variant keeps the unfused route
    if (x.dim() == 2  # the fused kernel + its backward are (batch, features)
            and not (drop_connect and train)
            and conf.activation_function in _FUSABLE
            and use_fused_dense()):
        return fused_dense(x, params[WEIGHT_KEY], params[BIAS_KEY],
                           conf.activation_function)
    pre = pre_output(conf, params, x, train=train, key=kdc,
                     drop_connect=drop_connect)
    return activation(conf.activation_function)(pre)
