"""Counterpart of ``deeplearning4j_tpu/scaleout/ckpt``: atomic, resumable
checkpoints in the JAX package's format, onto one device.

- ``sharded_io.save_sharded`` — every leaf of a tree is written as one
  chunk into ``shard_00000.npz``; a JSON ``MANIFEST`` (tree paths, global
  shapes, dtypes, per-chunk CRCs) commits LAST via atomic rename — a
  checkpoint without a committed manifest is invisible to every reader.
- ``reshard.restore_sharded`` — restores any checkpoint of the format,
  including one the JAX package saved sharded over a mesh, onto one device:
  each leaf is assembled from its covering chunks via the manifest offsets.
- ``checkpointer.Checkpointer`` — save, retention GC, ``latest_step()`` /
  ``restore()`` resume entry points, ``save_net``/``restore_net`` of a
  ``MultiLayerNetwork``'s training state (``net_state``), and telemetry in
  the port's registry; ``CheckpointIterationListener`` saves through the
  listener chain.

A checkpoint written by either package restores in the other. The live
redistribution plans and the async writer come with later slices
(ROADMAP Queue 1).
"""

from deeplearning4j_tpu_torch.scaleout.ckpt.manifest import (  # noqa: F401
    MANIFEST_NAME,
    Manifest,
    read_manifest,
    step_dir_name,
)
from deeplearning4j_tpu_torch.scaleout.ckpt.sharded_io import (  # noqa: F401
    merge_process_manifests,
    save_process_shards,
    save_sharded,
)
from deeplearning4j_tpu_torch.scaleout.ckpt.reshard import (  # noqa: F401
    CorruptShardError,
    latest_step,
    latest_step_dir,
    restore_sharded,
    template_from_manifest,
    verify_checksums,
)
from deeplearning4j_tpu_torch.scaleout.ckpt.checkpointer import (  # noqa: F401
    Checkpointer,
    CheckpointIterationListener,
)
from deeplearning4j_tpu_torch.scaleout.ckpt.net_state import (  # noqa: F401
    capture_net_state,
    net_state_template,
    rebuild_net,
    restore_net_state,
)
