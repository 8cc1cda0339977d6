"""Counterpart of ``deeplearning4j_tpu/scaleout``: distributed-training
contracts and the in-process runtime.

Parity with the reference's deeplearning4j-scaleout tree: transport-agnostic
contracts (Job, WorkerPerformer, JobAggregator, StateTracker, WorkRouter)
plus a local in-process runtime that replaces the Akka/Hazelcast stacks
(``runner.LocalDistributedRunner``, ``iterative_reduce``), the NLP
performers, single-file checkpoints (``checkpoint``), the checkpoint
format (``ckpt``) and the blob store with its adapters (``blobstore``).

The data plane of a card's training is in the step's collectives
(parallel/trainer.py); this package keeps the reference's control plane,
in process and over the wire: the remote tracker (``remote_tracker``,
byte-compatible with the JAX package's frames), the master and its
worker processes (``distributed_runner``) and the provisioning command
lines (``provision``).
"""

from deeplearning4j_tpu_torch.scaleout.job import Job  # noqa: F401
from deeplearning4j_tpu_torch.scaleout.statetracker import \
    InMemoryStateTracker  # noqa: F401
from deeplearning4j_tpu_torch.scaleout.runner import (  # noqa: F401
    EarlyStopping,
    LocalDistributedRunner,
)
from deeplearning4j_tpu_torch.scaleout.ckpt import (  # noqa: F401
    Checkpointer,
    CheckpointIterationListener,
)
