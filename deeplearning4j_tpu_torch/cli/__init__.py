"""Counterpart of ``deeplearning4j_tpu/cli``: the command-line interface,
train / test / predict (``python -m deeplearning4j_tpu_torch.cli.driver``
or the ``dl4j-tpu-torch`` script)."""

from deeplearning4j_tpu_torch.cli.driver import main

__all__ = ["main"]
