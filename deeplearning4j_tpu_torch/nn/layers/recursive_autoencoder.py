"""Counterpart of ``deeplearning4j_tpu/nn/layers/recursive_autoencoder.py``:
the recursive autoencoder (ref:
nn/layers/feedforward/recursive/RecursiveAutoEncoder.java).

The input's rows are folded left to right: at each step the next row and
the running parent are concatenated, encoded with
c = f([xᵢ; parent]·W + b), decoded back with Wᵀ, and the reconstruction
errors accumulate into the pretrain loss. The fold is a host loop over
the rows where the JAX package runs one ``lax.scan``; autograd
differentiates the chain.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.params import BIAS_KEY, VISIBLE_BIAS_KEY, \
    WEIGHT_KEY
from deeplearning4j_tpu_torch.ops.activations import activation

Tensor = torch.Tensor


def _fold(conf: NeuralNetConfiguration, params: Dict[str, Tensor],
          x: Tensor) -> Tuple[Tensor, Tensor]:
    """Fold the rows; returns (final parent (H,), per-step losses (N-1,)).

    W: (in + hidden, hidden) combines [xᵢ; parent] → hidden; decode uses
    Wᵀ. The first parent is x₀ projected through the x-block of W.
    """
    act = activation(conf.activation_function)
    w, b = params[WEIGHT_KEY], params[BIAS_KEY]
    vb = params[VISIBLE_BIAS_KEY]
    n_in = x.shape[1]

    parent = act(x[0] @ w[:n_in] + b)
    losses = []
    for xi in x[1:]:
        joint = torch.cat([xi, parent])            # (in + hidden,)
        parent = act(joint @ w + b)                # (hidden,)
        recon = act(parent @ w.T + vb)             # (in + hidden,)
        losses.append(((recon - joint) ** 2).sum())
    if not losses:
        return parent, x.new_zeros((0,))
    return parent, torch.stack(losses)


def pretrain_loss(conf: NeuralNetConfiguration, params: Dict[str, Tensor],
                  x: Tensor, key: Optional[int]) -> Tensor:
    """Mean reconstruction error of the fold (the reference scores the
    summed reconstruction error across combine steps)."""
    _, losses = _fold(conf, params, x)
    return losses.mean() if losses.shape[0] else x.new_zeros(())


def forward(conf: NeuralNetConfiguration, params: Dict[str, Tensor],
            x: Tensor, *, train: bool = False,
            key: Optional[int] = None) -> Tensor:
    """Feed-forward view: each row encoded alone through the x-block, so
    the layer composes in a stack as the reference's does."""
    act = activation(conf.activation_function)
    n_in = x.shape[1]
    return act(x @ params[WEIGHT_KEY][:n_in] + params[BIAS_KEY])


def encode_sequence(conf: NeuralNetConfiguration, params: Dict[str, Tensor],
                    x) -> Tensor:
    """Final parent vector of the whole sequence (the tree-root
    embedding)."""
    parent, _ = _fold(conf, params, torch.as_tensor(x))
    return parent
