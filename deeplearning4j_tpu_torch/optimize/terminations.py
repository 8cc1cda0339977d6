"""Counterpart of ``deeplearning4j_tpu/optimize/terminations.py``: the
termination conditions of the solver loop (ref: optimize/terminations/):
EpsTermination (relative score change), Norm2Termination (gradient norm),
ZeroDirection (vanishing search direction).
"""

from __future__ import annotations


class EpsTermination:
    def __init__(self, eps: float = 1e-4, tolerance: float = 1e-5):
        self.eps = eps
        self.tolerance = tolerance

    def terminate(self, cost: float, old_cost: float,
                  grad_norm: float) -> bool:
        if old_cost == 0.0:
            return abs(cost) < self.tolerance
        return abs(cost - old_cost) / max(abs(old_cost), 1e-12) < self.eps


class Norm2Termination:
    def __init__(self, gradient_tolerance: float = 1e-6):
        self.gradient_tolerance = gradient_tolerance

    def terminate(self, cost: float, old_cost: float,
                  grad_norm: float) -> bool:
        return grad_norm < self.gradient_tolerance


class ZeroDirection:
    def terminate(self, cost: float, old_cost: float,
                  grad_norm: float) -> bool:
        return grad_norm == 0.0
