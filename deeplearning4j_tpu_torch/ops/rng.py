"""Counterpart of ``deeplearning4j_tpu/ops/rng.py``: the key discipline.

A key is a plain Python int. ``split`` and ``fold_in`` derive new keys on
the host (SplitMix64 mixing), so threading keys through a train step costs
no device work and never waits for the card; ``generator`` turns a key
into the explicit ``torch.Generator`` a random draw takes, on the device
of the tensor being drawn. The streams are torch's Philox/MT, not JAX's
threefry: the two packages never draw the same numbers from one seed, so
parity tests inject parameters and masks from the JAX side.
"""

from __future__ import annotations

from typing import List

import torch

_M64 = (1 << 64) - 1


def _mix(z: int) -> int:
    """SplitMix64's finalizer: a bijection of 64-bit ints that scatters
    neighbouring inputs."""
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def split(key: int, num: int = 2) -> List[int]:
    """``num`` independent keys from ``key`` (``jax.random.split``)."""
    base = _mix(int(key) & _M64)
    return [_mix(base ^ _mix(i + 1)) for i in range(num)]


def fold_in(key: int, data: int) -> int:
    """A key derived from ``key`` and an integer (``jax.random.fold_in``)."""
    return _mix(_mix(int(key) & _M64) ^ _mix((int(data) & _M64) ^ 0x5DEECE66D))


def generator(key: int, device) -> torch.Generator:
    """The explicit ``torch.Generator`` seeded by ``key`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key) & ((1 << 63) - 1))
    return gen


class KeySequence:
    """Host-side key dispenser for the stateful facade
    (MultiLayerNetwork); functional code threads keys explicitly."""

    def __init__(self, seed: int = 123):
        self._key = int(seed)

    def next(self) -> int:
        self._key, sub = split(self._key)
        return sub

    def fold(self, data: int) -> int:
        return fold_in(self._key, data)
