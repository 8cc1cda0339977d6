"""Counterpart of ``deeplearning4j_tpu/ops/activations.py``: the activation
registry, named by the strings the reference configs use ("sigmoid",
"tanh", "relu", "softmax", ...) so JSON configs round-trip between the two
packages.

Each function rounds per op in the input's dtype, as its jax.nn/jnp
counterpart does; ``softmax`` follows ``jax.nn.softmax``'s op order (see
its docstring).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

Fn = Callable[[torch.Tensor], torch.Tensor]

_REGISTRY: Dict[str, Fn] = {}


def register(name: str):
    def deco(fn: Fn) -> Fn:
        _REGISTRY[name] = fn
        return fn

    return deco


@register("sigmoid")
def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


@register("tanh")
def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


@register("relu")
def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


@register("leakyrelu")
def leakyrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.01)


@register("hardtanh")
def hardtanh(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, -1.0, 1.0)


@register("softplus")
def softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0); F.softplus switches to x above 20
    return torch.logaddexp(x, torch.zeros_like(x))


@register("softsign")
def softsign(x: torch.Tensor) -> torch.Tensor:
    return x / (1 + x.abs())


@register("linear")
@register("identity")
def identity(x: torch.Tensor) -> torch.Tensor:
    return x


@register("exp")
def exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x)


@register("softmax")
def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis in ``jax.nn.softmax``'s op order: max,
    subtract, exp, sum, divide, each rounding to x's dtype. At bf16 this
    agrees with JAX where ``torch.softmax`` (f32 inside, one rounding at
    the end) lands a bf16 step away on many entries; at f32 the two are
    the same math."""
    unnormalized = torch.exp(x - x.amax(-1, keepdim=True))
    return unnormalized / unnormalized.sum(-1, keepdim=True)


@register("cube")
def cube(x: torch.Tensor) -> torch.Tensor:
    return x * x * x


def activation(name: str) -> Fn:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown activation '{name}'. Known: {sorted(_REGISTRY)}"
        ) from None


def activation_names() -> list[str]:
    return sorted(_REGISTRY)


def derivative(name: str, activated: torch.Tensor) -> torch.Tensor:
    """Derivative expressed in terms of the *activated* output (the
    reference's derivative transform ops, e.g. sigmoid' = y*(1-y)); the
    fused dense layer's backward uses it."""
    if name == "sigmoid":
        return activated * (1.0 - activated)
    if name == "tanh":
        return 1.0 - activated**2
    if name == "relu":
        return (activated > 0).to(activated.dtype)
    if name in ("linear", "identity"):
        return torch.ones_like(activated)
    if name == "softmax":
        # elementwise diagonal approximation, as the reference uses
        return activated * (1.0 - activated)
    if name == "hardtanh":
        return ((activated > -1.0) & (activated < 1.0)).to(activated.dtype)
    if name == "softplus":
        return torch.sigmoid(activated)
    raise ValueError(f"No derivative registered for activation '{name}'")
