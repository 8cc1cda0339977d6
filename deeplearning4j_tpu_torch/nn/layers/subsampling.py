"""Counterpart of ``deeplearning4j_tpu/nn/layers/subsampling.py``: the
subsampling (pooling) layer (ref:
nn/layers/convolution/subsampling/SubsamplingLayer.java:114-155).

Downsampling by ``conf.stride`` with window = stride, VALID (a remainder
row or column is dropped, as ``lax.reduce_window`` drops it), by
``conf.convolution_type``: MAX, SUM, AVG (the sum over the window's area)
or NONE (identity). SUM is computed as a sum, so a bf16 input rounds once,
as the JAX package's ``reduce_window`` add does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as torch_f

from deeplearning4j_tpu_torch.nn.api import ConvolutionType
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration


def _window_sum(x: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """Sum over non-overlapping (sh, sw) windows, remainder dropped."""
    b, c, h, w = x.shape
    ho, wo = h // sh, w // sw
    x = x[:, :, :ho * sh, :wo * sw]
    return x.reshape(b, c, ho, sh, wo, sw).sum(dim=(3, 5))


def forward(conf: NeuralNetConfiguration, params: Dict[str, torch.Tensor],
            x: torch.Tensor, *, train: bool = False,
            key: Optional[int] = None) -> torch.Tensor:
    if conf.convolution_type == ConvolutionType.NONE:
        return x
    sh, sw = conf.stride[-2], conf.stride[-1]
    if conf.convolution_type == ConvolutionType.MAX:
        return torch_f.max_pool2d(x, (sh, sw), (sh, sw))
    summed = _window_sum(x, sh, sw)
    if conf.convolution_type == ConvolutionType.SUM:
        return summed
    if conf.convolution_type == ConvolutionType.AVG:
        return summed / float(sh * sw)
    raise ValueError(f"Unhandled pooling type {conf.convolution_type}")
