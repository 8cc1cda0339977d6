"""Counterpart of ``deeplearning4j_tpu/parallel``: the mesh over
``torch.distributed`` ranks, multi-process initialization, sharding specs
and the data-parallel ``ParameterAveragingTrainer``. Expert parallelism's
exports (``moe_apply`` and its impl seam) come with ROADMAP item 20."""

from deeplearning4j_tpu_torch.parallel.mesh import data_parallel_mesh, mesh_2d  # noqa: F401
from deeplearning4j_tpu_torch.parallel.trainer import ParameterAveragingTrainer  # noqa: F401
