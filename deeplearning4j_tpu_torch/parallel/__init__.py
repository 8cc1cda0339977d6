"""Counterpart of ``deeplearning4j_tpu/parallel``: the mesh over
``torch.distributed`` ranks, multi-process initialization, sharding specs,
the data-parallel ``ParameterAveragingTrainer``, and the composed axes:
ring and Ulysses attention, expert-parallel MoE (``moe_apply`` and its impl
seam) and the GPipe pipeline."""

from deeplearning4j_tpu_torch.parallel.mesh import data_parallel_mesh, mesh_2d  # noqa: F401
from deeplearning4j_tpu_torch.parallel.moe import (  # noqa: F401
    get_moe_impl,
    moe_apply,
    resolve_moe_impl,
    set_moe_impl,
)
from deeplearning4j_tpu_torch.parallel.trainer import ParameterAveragingTrainer  # noqa: F401
