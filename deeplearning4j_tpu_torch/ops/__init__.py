"""Counterpart of ``deeplearning4j_tpu/ops``: the tensor-op substrate, with
named registries for activations and losses (the reference's string-keyed
transform-op registry), and the hand-written kernels' wrappers."""

from deeplearning4j_tpu_torch.ops.activations import activation, activation_names  # noqa: F401
from deeplearning4j_tpu_torch.ops.losses import LossFunction, loss  # noqa: F401
