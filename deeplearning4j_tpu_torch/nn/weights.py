"""Counterpart of ``deeplearning4j_tpu/nn/weights.py``: weight
initialization schemes (ref: nn/weights/WeightInit.java:25-38,
nn/weights/WeightInitUtil.java:78-100):

- NORMALIZED: U(0,1) - 0.5, divided by fan-in
- UNIFORM:    U(-1/fanIn, 1/fanIn)
- VI:         U(-r, r) with r = sqrt(6)/sqrt(sum(shape)+1)
- SIZE:       U(-s, s) with s = sqrt(6/(fanIn+fanOut))
- DISTRIBUTION: sample from a configured distribution
- ZERO:       zeros

Draws come from an explicit ``torch.Generator``: pass one, or a key
(``ops.rng``) that becomes one on ``device``. The numbers differ from the
JAX package's (threefry); the distributions are the same.
"""

from __future__ import annotations

import enum
import math
from typing import Optional, Sequence, Tuple, Union

import torch

from deeplearning4j_tpu_torch._device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.ops.rng import generator

KeyLike = Union[int, torch.Generator]


class WeightInit(str, enum.Enum):
    DISTRIBUTION = "DISTRIBUTION"
    NORMALIZED = "NORMALIZED"
    SIZE = "SIZE"
    UNIFORM = "UNIFORM"
    VI = "VI"
    ZERO = "ZERO"

    @classmethod
    def coerce(cls, v) -> "WeightInit":
        return v if isinstance(v, cls) else cls(str(v).upper())


# A configured distribution is ("normal", mean, std) or ("uniform", lo, hi) —
# the serializable analogue of the reference's nn/conf/distribution classes.
Distribution = Tuple[str, float, float]


def _generator(key: KeyLike, device: torch.device) -> torch.Generator:
    return key if isinstance(key, torch.Generator) else generator(key, device)


def _uniform(gen, shape, lo: float, hi: float, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device).uniform_(
        lo, hi, generator=gen)


def sample_distribution(key: KeyLike, dist: Distribution,
                        shape: Sequence[int], device: DeviceLike = None,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    dev = resolve_device(device)
    kind, a, b = dist
    gen = _generator(key, dev)
    if kind == "normal":
        return a + b * torch.randn(tuple(shape), generator=gen, device=dev,
                                   dtype=dtype)
    if kind == "uniform":
        return _uniform(gen, tuple(shape), a, b, dtype, dev)
    raise ValueError(f"Unknown distribution kind '{kind}'")


def init_weights(key: KeyLike, shape: Sequence[int],
                 scheme: "WeightInit | str",
                 dist: Optional[Distribution] = None,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None) -> torch.Tensor:
    """A weight of ``shape`` on ``device`` (CUDA unless ``device="cpu"``)
    drawn by ``scheme``."""
    dev = resolve_device(device)
    scheme = WeightInit.coerce(scheme)
    shape = tuple(int(s) for s in shape)
    fan_in = shape[0]
    if scheme == WeightInit.ZERO:
        return torch.zeros(shape, dtype=dtype, device=dev)
    gen = _generator(key, dev)
    if scheme == WeightInit.NORMALIZED:
        return (_uniform(gen, shape, 0.0, 1.0, dtype, dev) - 0.5) / fan_in
    if scheme == WeightInit.UNIFORM:
        a = 1.0 / fan_in
        return _uniform(gen, shape, -a, a, dtype, dev)
    if scheme == WeightInit.VI:
        r = math.sqrt(6.0) / math.sqrt(sum(shape) + 1.0)
        return _uniform(gen, shape, -r, r, dtype, dev)
    if scheme == WeightInit.SIZE:
        fan_out = shape[1] if len(shape) > 1 else shape[0]
        s = math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, -s, s, dtype, dev)
    if scheme == WeightInit.DISTRIBUTION:
        if dist is None:
            dist = ("normal", 0.0, 0.01)
        return sample_distribution(gen, dist, shape, dev).to(dtype)
    raise ValueError(f"Unhandled weight init {scheme}")
