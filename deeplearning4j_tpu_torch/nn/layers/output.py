"""Counterpart of ``deeplearning4j_tpu/nn/layers/output.py``: the output
(classification/regression) layer (ref: nn/layers/OutputLayer.java).

The loss is differentiated by autograd; for the softmax+MCXENT /
sigmoid+XENT pairs the fused log-softmax path is used. The head's product
is ``pre_output``, a plain product (``torch.matmul``), as in the JAX
layer; logits and labels are lifted to f32 before the loss.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers.dense import apply_dropout, pre_output
from deeplearning4j_tpu_torch.ops.activations import activation
from deeplearning4j_tpu_torch.ops.losses import (
    FUSABLE,
    finalize_loss,
    per_example_loss,
    per_example_loss_from_logits,
)
from deeplearning4j_tpu_torch.ops.rng import split


def forward(conf: NeuralNetConfiguration, params: Dict[str, torch.Tensor],
            x: torch.Tensor, *, train: bool = False,
            key: Optional[int] = None,
            drop_connect: bool = False) -> torch.Tensor:
    kdrop = kdc = None
    if key is not None:
        kdrop, kdc = split(key)
    x = apply_dropout(x, conf.dropout, train, kdrop)
    pre = pre_output(conf, params, x, train=train, key=kdc,
                     drop_connect=drop_connect)
    return activation(conf.activation_function)(pre)


def output_loss(conf: NeuralNetConfiguration,
                params: Dict[str, torch.Tensor], x: torch.Tensor,
                labels: torch.Tensor, *, train: bool = False,
                key: Optional[int] = None,
                drop_connect: bool = False) -> torch.Tensor:
    """Scalar training loss for the head (ref: OutputLayer.score())."""
    per = output_per_example_loss(conf, params, x, labels, train=train,
                                  key=key, drop_connect=drop_connect)
    return finalize_loss(conf.loss_function, per.mean())


def output_per_example_loss(conf: NeuralNetConfiguration,
                            params: Dict[str, torch.Tensor],
                            x: torch.Tensor, labels: torch.Tensor, *,
                            train: bool = False, key: Optional[int] = None,
                            drop_connect: bool = False) -> torch.Tensor:
    """Per-example pre-reduction losses, shape (batch,); the scalar loss is
    ``ops.losses.finalize_loss(conf.loss_function, mean)``."""
    return logits_per_example_loss(
        conf, output_logits(conf, params, x, train=train, key=key,
                            drop_connect=drop_connect), labels)


def output_logits(conf: NeuralNetConfiguration,
                  params: Dict[str, torch.Tensor], x: torch.Tensor, *,
                  train: bool = False, key: Optional[int] = None,
                  drop_connect: bool = False) -> torch.Tensor:
    """The head's logits: its dropout, then ``pre_output``."""
    kdrop = kdc = None
    if key is not None:
        kdrop, kdc = split(key)
    x = apply_dropout(x, conf.dropout, train, kdrop)
    return pre_output(conf, params, x, train=train, key=kdc,
                      drop_connect=drop_connect)


def logits_per_example_loss(conf: NeuralNetConfiguration,
                            logits: torch.Tensor,
                            labels: torch.Tensor) -> torch.Tensor:
    """The head's per-example losses from its logits, in f32: the fused
    log-softmax/log-sigmoid path for the ``FUSABLE`` pairs, else the
    activation then the loss."""
    logits = logits.to(torch.float32)
    labels = labels.to(torch.float32)
    if (conf.activation_function, conf.loss_function) in FUSABLE:
        return per_example_loss_from_logits(conf.loss_function, labels,
                                            logits)
    out = activation(conf.activation_function)(logits)
    return per_example_loss(conf.loss_function, labels, out)
