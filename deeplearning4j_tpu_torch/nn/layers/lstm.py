"""Counterpart of ``deeplearning4j_tpu/nn/layers/lstm.py``: the LSTM layer
(Karpathy-style fused-gate char-LSTM).

Parity with ref: nn/layers/recurrent/LSTM.java:54-160 — a single recurrent
matrix maps [1 | x_t | h_{t-1}] to the fused i,f,o,g gate buffer ("iFog"),
cell update c_t = f⊙c_{t-1} + i⊙g, h_t = o⊙tanh(c_t), then a decoder
projection to the output. Input layout: (batch, time, n_in).

The JAX ``lax.scan`` over time is a Python loop here: one (B, 1+n_in+H) x
(1+n_in+H, 4H) product and one cell (``ops.pallas_kernels.lstm_gates``,
kernel K2 on the card) per timestep; autograd unrolls the loop for the
backward, where each timestep's cell is one launch of kernel K2b (the
cell's backward). K2b reads the h grads from ``torch.stack``'s backward
as the row views they are, and the last timestep's missing c grad as
zero, so the cell adds no copy or zero-fill to the backward.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.params import (
    DECODER_BIAS_KEY,
    DECODER_WEIGHT_KEY,
    RECURRENT_WEIGHT_KEY,
)
from deeplearning4j_tpu_torch.ops.pallas_kernels import lstm_gates


def hidden_sequence(conf: NeuralNetConfiguration,
                    params: Dict[str, torch.Tensor],
                    x: torch.Tensor) -> torch.Tensor:
    """Run the recurrence; returns h for every timestep: (batch, time,
    hidden)."""
    if x.dim() == 2:  # single sequence (time, n_in) → add batch axis
        x = x[None]
    w = params[RECURRENT_WEIGHT_KEY]
    batch, steps = x.shape[0], x.shape[1]
    hidden = conf.n_out
    ones = torch.ones((batch, 1), dtype=x.dtype, device=x.device)
    h = c = torch.zeros((batch, hidden), dtype=x.dtype, device=x.device)
    hs = []
    for t in range(steps):
        h_in = torch.cat([ones, x[:, t], h], dim=-1)
        gates = h_in @ w
        c, h = lstm_gates(gates, c)
        hs.append(h)
    if not hs:
        return x.new_zeros((batch, 0, hidden))
    return torch.stack(hs, dim=1)


def forward(conf: NeuralNetConfiguration, params: Dict[str, torch.Tensor],
            x: torch.Tensor, *, train: bool = False,
            key: Optional[int] = None,
            drop_connect: bool = False) -> torch.Tensor:
    """Decoded output per timestep (ref: LSTM.activate decoder
    projection)."""
    hs = hidden_sequence(conf, params, x)
    return hs @ params[DECODER_WEIGHT_KEY] + params[DECODER_BIAS_KEY]
