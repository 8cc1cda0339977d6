"""Counterpart of ``deeplearning4j_tpu/utils/sloppy_math.py``
(a copy: host code).

Numerically-careful log-space helpers.

Parity with ref: berkeley/SloppyMath.java — logAdd (scalar/array, with the
LOGTOLERANCE early-out), logNormalize, isDangerous/isVeryDangerous,
relativeDifference, isDiscreteProb, lambert. The trivial max/min overloads
are Python built-ins and are not duplicated.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence

import numpy as np

LOG_TOLERANCE = 30.0  # ref: SloppyMath.LOGTOLERANCE


def log_add(lx: float, ly: float) -> float:
    """log(exp(lx) + exp(ly)) without overflow (ref: SloppyMath.logAdd)."""
    lo, hi = (lx, ly) if lx <= ly else (ly, lx)
    if hi == float("-inf"):
        return hi
    if hi - lo > LOG_TOLERANCE:
        return hi
    return hi + math.log1p(math.exp(lo - hi))


def log_add_all(log_v: Sequence[float]) -> float:
    """log-sum-exp of an array (ref: SloppyMath.logAdd(double[]))."""
    arr = np.asarray(log_v, dtype=np.float64)
    if arr.size == 0:
        return float("-inf")
    hi = float(np.max(arr))
    if not np.isfinite(hi):
        return hi
    return hi + float(np.log(np.sum(np.exp(arr - hi))))


def log_normalize(log_v) -> np.ndarray:
    """Shift log-probs so they sum to 1 in real space
    (ref: SloppyMath.logNormalize)."""
    arr = np.asarray(log_v, dtype=np.float64)
    return arr - log_add_all(arr)


def is_dangerous(d: float) -> bool:
    """NaN, inf, or exactly zero (ref: SloppyMath.isDangerous)."""
    return math.isnan(d) or math.isinf(d) or d == 0.0


def is_very_dangerous(d: float) -> bool:
    return math.isnan(d) or math.isinf(d)


def relative_difference(a: float, b: float) -> float:
    """|a-b| / max(|a|,|b|) (ref: SloppyMath.relativeDifferance [sic])."""
    denom = max(abs(a), abs(b))
    return abs(a - b) / denom if denom else 0.0


def is_discrete_prob(d: float, tol: float = 1e-7) -> bool:
    return -tol <= d <= 1.0 + tol


def lambert(v: float, u: float, iters: int = 50) -> float:
    """Solve w·e^w = v·e^u for w by Newton iteration
    (ref: SloppyMath.lambert)."""
    target = v * math.exp(u)
    w = 1.0 if target >= 0 else -1.0
    for _ in range(iters):
        ew = math.exp(w)
        f = w * ew - target
        fp = ew * (1.0 + w)
        if fp == 0:
            break
        w_new = w - f / fp
        if abs(w_new - w) < 1e-12:
            return w_new
        w = w_new
    return w
