"""Counterpart of ``deeplearning4j_tpu/utils``: so far
``MovingWindowMatrix``. The counters come with ROADMAP item 19, the rest
of the utilities with item 21d."""

from deeplearning4j_tpu_torch.utils.moving_window import MovingWindowMatrix

__all__ = ["MovingWindowMatrix"]
