"""Counterpart of ``deeplearning4j_tpu/utils``: so far the counters
(``Counter``, ``CounterMap``), ``MovingWindowMatrix``, and the
``profiling`` module (device traces, annotations, memory stats; imported
as a module, as in JAX). The rest of the utilities come with ROADMAP item
21d."""

from deeplearning4j_tpu_torch.utils.counter import Counter, CounterMap
from deeplearning4j_tpu_torch.utils.moving_window import MovingWindowMatrix

__all__ = ["Counter", "CounterMap", "MovingWindowMatrix"]
