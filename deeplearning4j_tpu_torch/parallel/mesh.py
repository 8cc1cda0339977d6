"""Counterpart of ``deeplearning4j_tpu/parallel/mesh.py``: the device mesh
over ``torch.distributed`` ranks.

The JAX package runs one controller over a mesh of devices. Here, as is
PyTorch's idiom, there is one process per device: a mesh's devices are the
ranks of the default process group, one device per rank — ``cuda:<local
rank>`` under NCCL, the CPU under gloo. With no group initialised a mesh
has one rank and its collectives are the identity; a group of one rank
runs them through the backend.

Axis names used throughout the framework:
- "data"  — data parallelism (the reference's only axis)
- "model" — tensor parallelism (ROADMAP item 20)

The mesh's collectives (``all_reduce``, ``all_gather``) count the calls they
make to ``torch.distributed`` in ``COLLECTIVES``, as the kernel wrappers
count launches in ``ops._kernels.LAUNCHES``: a run can show that a
synchronous step made exactly one all-reduce.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

COLLECTIVES: Dict[str, int] = {"all_reduce": 0, "all_gather": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def _group_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _group_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _rank_device() -> Optional[torch.device]:
    """This rank's device: ``cuda:<local rank>`` under NCCL, the CPU under
    gloo, None with no group (the caller's device then stands)."""
    if not dist.is_initialized():
        return None
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class Mesh:
    """Named axes over the ranks of the default process group.

    ``shape`` maps axis name to size (``jax.sharding.Mesh.shape``),
    ``size`` is their product, ``rank`` this process's rank and ``device``
    its device (None with no group). ``coords`` is this rank's index on
    each axis, ranks laid out row-major over the axes."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int]):
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = {a: int(s)
                                      for a, s in zip(self.axis_names, sizes)}
        size = 1
        for s in self.shape.values():
            size *= s
        world = _group_size()
        if size != world:
            raise ValueError(
                f"a mesh of shape {tuple(self.shape.values())} needs {size} "
                f"ranks, and the process group has world size {world}: a "
                "mesh spans every rank of the group, one device each")
        self.size = size
        # with a group, even of one rank, collectives go to it
        self.grouped = dist.is_initialized()
        self.rank = _group_rank()
        self.device = _rank_device()
        coords, rem = {}, self.rank
        for a in reversed(self.axis_names):
            coords[a] = rem % self.shape[a]
            rem //= self.shape[a]
        self.coords = {a: coords[a] for a in self.axis_names}

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over every rank, in place (``lax.psum`` over the whole
        mesh); the identity with no process group."""
        if self.grouped:
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
            COLLECTIVES["all_reduce"] += 1
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked along dim 0 in rank order
        (``lax.all_gather(..., tiled=True)``); ``t`` itself with no
        process group."""
        if not self.grouped:
            return t
        out = t.new_empty((self.size * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t.contiguous())
        COLLECTIVES["all_gather"] += 1
        return out

    def barrier(self) -> None:
        if self.grouped:
            dist.barrier()


def flat_all_reduce(mesh: Mesh, tensors: list) -> list:
    """Sum every tensor of ``tensors`` over the ranks in ONE all-reduce of
    their concatenation, returned in their own shapes and dtypes. The
    buffer takes the widest floating dtype among them (f32 at least), so
    an f64 network's sums keep their precision."""
    dtype = torch.float32
    for t in tensors:
        dtype = torch.promote_types(dtype, t.dtype)
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    mesh.all_reduce(flat)
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[at:at + n].reshape(t.shape).to(t.dtype))
        at += n
    return out


def data_parallel_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over every rank of the process group: pure DP.
    ``n_devices`` must equal the group's world size (1 with no group)."""
    n = _group_size() if n_devices is None else int(n_devices)
    return Mesh((DATA_AXIS,), (n,))


def mesh_2d(dp: int, tp: int) -> Mesh:
    """dp×tp mesh: batch over "data", hidden dims over "model"."""
    return Mesh((DATA_AXIS, MODEL_AXIS), (dp, tp))


def local_device_count() -> int:
    """Devices this host offers the mesh: its CUDA cards, else 1 (the
    CPU)."""
    return max(torch.cuda.device_count(), 1)
