"""Counterpart of ``deeplearning4j_tpu/scaleout``: so far the checkpoint
format (``scaleout.ckpt``) and the blob store (``scaleout.blobstore``). The
distributed runners, the state tracker and the job contracts come with
ROADMAP item 19."""

from deeplearning4j_tpu_torch.scaleout.ckpt import (  # noqa: F401
    Checkpointer,
    CheckpointIterationListener,
)
