"""Counterpart of ``deeplearning4j_tpu/scaleout/ckpt``: atomic, resumable
checkpoints in the JAX package's format, over a mesh of ranks or on one
device.

- ``sharded_io.save_sharded`` — each leaf's unique chunks (one chunk per
  leaf without a mesh) written into per-rank npz files; a JSON
  ``MANIFEST`` (tree paths, global shapes, dtypes, specs, mesh topology,
  per-chunk CRCs) commits LAST via atomic rename — a checkpoint without a
  committed manifest is invisible to every reader. ``save_process_shards``
  and ``merge_process_manifests`` are its multi-process twin: every rank
  writes the chunks it owns, the coordinator checks coverage and commits.
- ``reshard.restore_sharded`` — restores any checkpoint of the format,
  including one the JAX package saved sharded over a mesh: each leaf, or
  with ``shardings=`` this rank's chunk of it, is assembled from its
  covering chunks via the manifest offsets.
- ``redistribution`` — the live twin: a tree already on the ranks moves
  to another layout as an explicit program of collective steps.
- ``async_ckpt.AsyncCheckpointer`` — saves on a writer thread, the
  device-to-host copies started at ``save()``.
- ``checkpointer.Checkpointer`` — save, retention GC, ``latest_step()`` /
  ``restore()`` resume entry points, ``save_net``/``restore_net`` of a
  ``MultiLayerNetwork``'s training state (``net_state``), and telemetry in
  the port's registry; ``CheckpointIterationListener`` saves through the
  listener chain.

A checkpoint written by either package restores in the other.
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
from deeplearning4j_tpu_torch.scaleout.ckpt.redistribution import (  # noqa: F401
    Placement,
    RedistributionPlan,
    apply_plan,
    placements,
    plan_cross_mesh,
    plan_redistribution,
    redistribute,
    redistribute_tree,
)
from deeplearning4j_tpu_torch.scaleout.ckpt.checkpointer import (  # noqa: F401
    Checkpointer,
    CheckpointIterationListener,
    replicated_shardings,
)
from deeplearning4j_tpu_torch.scaleout.ckpt.async_ckpt import (  # noqa: F401
    AsyncCheckpointer,
)
from deeplearning4j_tpu_torch.scaleout.ckpt.net_state import (  # noqa: F401
    capture_net_state,
    net_state_template,
    rebuild_net,
    restore_net_state,
)
