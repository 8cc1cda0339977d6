"""Counterpart of ``deeplearning4j_tpu/optimize/stepfunctions.py``: step
functions — how a line-search solver applies (direction, step) to x.

Parity with ref: optimize/stepfunctions/ + nn/conf/stepfunctions/ —
DefaultStepFunction (x += step·d), NegativeDefaultStepFunction (x −= step·d),
GradientStepFunction (x += d), NegativeGradientStepFunction (x −= d).
The negative variants flip descent into ascent for maximization objectives;
the gradient variants ignore the line-search step size (raw gradient step).

The conf's ``step_function`` field selects by name (the conf checks the name
when it is built); the solvers that apply them come with a later slice.
Each is a pure function of (x, direction, step) over tensors."""

from __future__ import annotations

from typing import Callable, Dict

import torch

Array = torch.Tensor
StepFn = Callable[[Array, Array, Array], Array]


def _default(x: Array, direction: Array, step) -> Array:
    return x + step * direction


def _negative_default(x: Array, direction: Array, step) -> Array:
    return x - step * direction


def _gradient(x: Array, direction: Array, step) -> Array:
    return x + direction


def _negative_gradient(x: Array, direction: Array, step) -> Array:
    return x - direction


_REGISTRY: Dict[str, StepFn] = {
    "default": _default,
    "negative_default": _negative_default,
    "gradient": _gradient,
    "negative_gradient": _negative_gradient,
}


def step_function(name: str) -> StepFn:
    key = str(name).lower()
    if key not in _REGISTRY:
        raise ValueError(
            f"Unknown step function {name!r}. Known: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[key]


def step_function_names() -> list:
    return sorted(_REGISTRY)
