"""Counterpart of ``deeplearning4j_tpu/parallel/multihost.py``: wiring
processes into one ``torch.distributed`` process group.

The JAX package joins hosts into one multi-controller program through
``jax.distributed.initialize``. Here every process drives one device and
joins the default process group: NCCL when the process's device is CUDA,
gloo when it is the CPU. Nothing on a machine announces a cluster, so the
coordinator's address, the number of processes and this process's rank are
given, or read from the same environment variables as the JAX package.

Usage in each process:

    from deeplearning4j_tpu_torch.parallel import multihost
    multihost.initialize(coordinator="host0:9901", num_processes=4,
                         process_id=RANK)
    mesh = multihost.global_mesh(("data",))
    # parallel/trainer.py works unchanged over this mesh
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch._device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.parallel.mesh import Mesh

_initialized = False


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: DeviceLike = None) -> None:
    """Join this process to the process group over ``tcp://<coordinator>``.

    All-None arguments read DL4J_COORDINATOR (or JAX_COORDINATOR_ADDRESS)
    / DL4J_NUM_PROCESSES / DL4J_PROCESS_ID. A no-op when no coordinator is
    configured (a single-process run). ``device`` picks the backend:
    CUDA (the default; raises without a card) joins over NCCL on card
    ``process_id % device_count``, ``"cpu"`` over gloo.
    """
    global _initialized
    if _initialized:
        return
    if coordinator is None:
        coordinator = os.environ.get(
            "DL4J_COORDINATOR", os.environ.get("JAX_COORDINATOR_ADDRESS")
        )
        if num_processes is None and "DL4J_NUM_PROCESSES" in os.environ:
            num_processes = int(os.environ["DL4J_NUM_PROCESSES"])
        if process_id is None and "DL4J_PROCESS_ID" in os.environ:
            process_id = int(os.environ["DL4J_PROCESS_ID"])
    if coordinator is None:
        # a single process — nothing to coordinate
        _initialized = True
        return
    if num_processes is None or process_id is None:
        raise ValueError(
            "a coordinator address requires num_processes and process_id "
            "(or DL4J_NUM_PROCESSES / DL4J_PROCESS_ID in the environment)"
        )
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    _initialized = True


def shutdown() -> None:
    """Leave the process group (call in a ``finally``, so a failing rank
    cannot leave the others waiting)."""
    global _initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def process_info() -> Tuple[int, int]:
    """(process_index, process_count)."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def global_mesh(axis_names: Sequence[str] = ("data",),
                axis_sizes: Optional[Sequence[int]] = None) -> Mesh:
    """Mesh over every rank of the group.

    Default: one data axis spanning everything. With axis_sizes, lay the
    ranks out over the named axes (the product must equal the world
    size)."""
    n = process_info()[1]
    if axis_sizes is None:
        if len(axis_names) != 1:
            raise ValueError("axis_sizes required for a multi-axis mesh")
        return Mesh(tuple(axis_names), (n,))
    sizes = tuple(int(s) for s in axis_sizes)
    total = 1
    for s in sizes:
        total *= s
    if total != n:
        raise ValueError(f"axis sizes {sizes} do not cover {n} devices")
    return Mesh(tuple(axis_names), sizes)


def is_coordinator() -> bool:
    """True on exactly one process — gate host-side side effects
    (checkpoint writes, logging) on it."""
    return process_info()[0] == 0
