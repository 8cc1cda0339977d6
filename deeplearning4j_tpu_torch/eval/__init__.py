"""Counterpart of ``deeplearning4j_tpu/eval``: classifier evaluation."""

from deeplearning4j_tpu_torch.eval.evaluation import (  # noqa: F401
    ConfusionMatrix,
    Evaluation,
)
