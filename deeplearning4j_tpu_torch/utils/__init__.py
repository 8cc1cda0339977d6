"""Counterpart of ``deeplearning4j_tpu/utils``: the same exports (the
counters, ``DiskBasedQueue``, ``MovingWindowMatrix``, ``Viterbi`` and the
math helpers, all host code). ``lockwatch``, ``retrace_guard``,
``profiling``, ``netwatch``, ``sloppy_math`` and ``string_grid`` are
imported as modules, as in JAX."""

from deeplearning4j_tpu_torch.utils.counter import Counter, CounterMap
from deeplearning4j_tpu_torch.utils.disk_queue import DiskBasedQueue
from deeplearning4j_tpu_torch.utils.math_utils import (
    clamp,
    entropy,
    information_gain,
    normalize_to_range,
    rounded,
    sigmoid,
    sum_of_squares,
    uniform,
)
from deeplearning4j_tpu_torch.utils.moving_window import MovingWindowMatrix
from deeplearning4j_tpu_torch.utils.viterbi import Viterbi

__all__ = [
    "Counter",
    "CounterMap",
    "DiskBasedQueue",
    "MovingWindowMatrix",
    "Viterbi",
    "clamp",
    "entropy",
    "information_gain",
    "normalize_to_range",
    "rounded",
    "sigmoid",
    "sum_of_squares",
    "uniform",
]
