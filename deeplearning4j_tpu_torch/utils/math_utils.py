"""Counterpart of ``deeplearning4j_tpu/utils/math_utils.py``
(a copy: host code).

Math helpers (ref util/MathUtils.java, 1,293 LoC — the subset with
callers: entropy/information gain for feature analysis, normalization,
clamping, RNG convenience)."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))


def clamp(value: float, lo: float, hi: float) -> float:
    return max(lo, min(hi, value))


def rounded(value: float, decimals: int = 2) -> float:
    return float(np.round(value, decimals))


def sum_of_squares(values) -> float:
    v = np.asarray(values, np.float64)
    return float((v * v).sum())


def normalize_to_range(values, lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    """Min-max rescale into [lo, hi] (ref MathUtils.normalize)."""
    v = np.asarray(values, np.float64)
    vmin, vmax = v.min(), v.max()
    if vmax == vmin:
        return np.full_like(v, lo)
    return lo + (v - vmin) * (hi - lo) / (vmax - vmin)


def entropy(probabilities) -> float:
    """Shannon entropy in nats of a discrete distribution."""
    p = np.asarray(probabilities, np.float64)
    p = p[p > 0]
    return float(-(p * np.log(p)).sum())


def information_gain(parent_counts: Sequence[float],
                     child_counts: Sequence[Sequence[float]]) -> float:
    """Entropy(parent) − Σ weight·Entropy(child) over a candidate split."""
    parent = np.asarray(parent_counts, np.float64)
    total = parent.sum()
    if total == 0:
        return 0.0
    gain = entropy(parent / total)
    for child in child_counts:
        c = np.asarray(child, np.float64)
        if c.sum() == 0:
            continue
        gain -= (c.sum() / total) * entropy(c / c.sum())
    return float(gain)


def uniform(rng: np.random.Generator, lo: float, hi: float) -> float:
    return float(rng.uniform(lo, hi))
