"""Counterpart of ``deeplearning4j_tpu/nn/layers/preprocessor.py``: input
pre-processors between layers (ref: nn/conf/preprocessor/), registered by
string name so MultiLayerConfiguration JSON round-trips.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

Fn = Callable[[torch.Tensor], torch.Tensor]

_REGISTRY: Dict[str, Fn] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


@register("zero_mean")
def zero_mean(x: torch.Tensor) -> torch.Tensor:
    return x - x.mean(0, keepdim=True)


@register("zero_mean_unit_variance")
def zero_mean_unit_variance(x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(0, keepdim=True)
    sd = x.std(0, correction=0, keepdim=True)  # jnp.std: population std
    return (x - mu) / (sd + 1e-6)


@register("unit_variance")
def unit_variance(x: torch.Tensor) -> torch.Tensor:
    return x / (x.std(0, correction=0, keepdim=True) + 1e-6)


@register("ff_to_conv")
def ff_to_conv(x: torch.Tensor) -> torch.Tensor:
    """(batch, d) → (batch, 1, s, s) assuming square single-channel images."""
    side = int(math.isqrt(x.shape[-1]))
    return x.reshape(x.shape[0], 1, side, side)


@register("conv_to_ff")
def conv_to_ff(x: torch.Tensor) -> torch.Tensor:
    """(batch, c, h, w) → (batch, c*h*w)."""
    return x.reshape(x.shape[0], -1)


def preprocessor(name: str) -> Fn:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"Unknown preprocessor '{name}'. Known: "
                         f"{sorted(_REGISTRY)}") from None
