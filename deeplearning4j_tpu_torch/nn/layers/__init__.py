"""Counterpart of ``deeplearning4j_tpu/nn/layers/__init__.py``: layers as
pure functions over (conf, params, input), dispatched by ``LayerType``.

``forward`` is the single activate entry point; training differentiates the
composed forwards with autograd. DENSE, OUTPUT, LSTM and ATTENTION are
ported; the other layer types come with their slices and raise
``NotImplementedError`` naming it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch.nn.api import LayerType
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import attention, dense, lstm, \
    output
from deeplearning4j_tpu_torch.nn.params import UNPORTED_LAYERS, unported

_FORWARD = {
    LayerType.DENSE: dense.forward,
    LayerType.OUTPUT: output.forward,
    LayerType.LSTM: lstm.forward,
    LayerType.ATTENTION: attention.forward,
}


def forward(conf: NeuralNetConfiguration, params: Dict[str, torch.Tensor],
            x: torch.Tensor, *, train: bool = False,
            key: Optional[int] = None,
            drop_connect: bool = False) -> torch.Tensor:
    """Layer.activate (ref: nn/api/Layer.java:37)."""
    fn = _FORWARD.get(conf.layer_type)
    if fn is None:
        if conf.layer_type in UNPORTED_LAYERS:
            raise unported(conf.layer_type, "forward")
        raise ValueError(f"No forward for layer type {conf.layer_type}")
    return fn(conf, params, x, train=train, key=key,
              drop_connect=drop_connect)
