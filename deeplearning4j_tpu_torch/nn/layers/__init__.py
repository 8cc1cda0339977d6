"""Counterpart of ``deeplearning4j_tpu/nn/layers/__init__.py``: layers as
pure functions over (conf, params, input), dispatched by ``LayerType``.

``forward`` is the single activate entry point; training differentiates the
composed forwards with autograd.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch.nn.api import LayerType
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    attention,
    autoencoder,
    convolution,
    dense,
    lstm,
    output,
    rbm,
    recursive_autoencoder,
    subsampling,
)

_FORWARD = {
    LayerType.DENSE: dense.forward,
    LayerType.OUTPUT: output.forward,
    LayerType.RBM: rbm.forward,
    LayerType.AUTOENCODER: autoencoder.forward,
    LayerType.RECURSIVE_AUTOENCODER: recursive_autoencoder.forward,
    LayerType.CONVOLUTION: convolution.forward,
    LayerType.SUBSAMPLING: subsampling.forward,
    LayerType.LSTM: lstm.forward,
    LayerType.ATTENTION: attention.forward,
}

_TAKES_DROP_CONNECT = {LayerType.DENSE, LayerType.OUTPUT}


def forward(conf: NeuralNetConfiguration, params: Dict[str, torch.Tensor],
            x: torch.Tensor, *, train: bool = False,
            key: Optional[int] = None,
            drop_connect: bool = False) -> torch.Tensor:
    """Layer.activate (ref: nn/api/Layer.java:37)."""
    fn = _FORWARD.get(conf.layer_type)
    if fn is None:
        raise ValueError(f"No forward for layer type {conf.layer_type}")
    if conf.layer_type in _TAKES_DROP_CONNECT:
        return fn(conf, params, x, train=train, key=key,
                  drop_connect=drop_connect)
    return fn(conf, params, x, train=train, key=key)
