"""Counterpart of ``deeplearning4j_tpu/scaleout/ckpt/sharded_io.py``: the
single-device checkpoint writer.

Every leaf of the state tree is one chunk, written into
``shard_00000.npz`` under its ``jax.tree_util.keystr`` path, in JAX's
leaf order (dict keys sorted, sequences in order, ``None`` an empty
subtree). The manifest — paths, shapes, dtypes, per-chunk CRC32s — commits
LAST via atomic rename (see manifest.py), so a crash mid-save leaves
nothing a reader sees. The files are those the JAX package writes for the
same tree on one device, member for member: a ``bfloat16`` leaf goes out
as 2-byte void records (npy descr ``'<V2'``, which ``ml_dtypes`` arrays
get from ``np.savez``) named ``"bfloat16"`` in the manifest.

The multi-process writer (``save_process_shards``,
``merge_process_manifests``) and saves of state sharded over a mesh come
with ROADMAP slice 8; a state replicated over the data-parallel ranks
saves from one rank, with the mesh recorded in the manifest.
"""

from __future__ import annotations

import os
import zipfile
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.scaleout.ckpt.manifest import (
    Chunk,
    LeafEntry,
    Manifest,
    step_dir_name,
    write_manifest,
)
from deeplearning4j_tpu_torch.scaleout.ckpt.reshard import dtype_name, \
    keystr

_MULTI_WRITER_SLICE = ("ROADMAP slice 8 (the write side of scaleout/ckpt "
                       "across processes and meshes)")
# how a bfloat16 leaf's bits sit in the npz: 2-byte void records
_BF16_BITS = np.dtype("V2")
# the shard file of device 0, the one device a save here covers
_SHARD_FILE = "shard_00000.npz"


def _leaves_with_path(tree, path: tuple = ()) -> List[Tuple[tuple, object]]:
    """``(path, leaf)`` in ``jax.tree_util.tree_flatten_with_path`` order:
    dict keys sorted, sequences in order, ``None`` an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [pl for i, v in enumerate(tree)
                for pl in _leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def _host_leaf(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a contiguous host array and its manifest dtype name;
    ``bfloat16`` as its bits in 2-byte void records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy().view(_BF16_BITS)
            return bits, "bfloat16"
        return t.numpy(), dtype_name(t)
    arr = np.ascontiguousarray(np.asarray(leaf))
    if arr.dtype.name == "bfloat16":  # an ml_dtypes array
        return arr.view(_BF16_BITS), "bfloat16"
    return arr, str(arr.dtype)


def _savez(f, payload: Dict[str, np.ndarray]) -> None:
    """``np.savez`` (stored, zip64 members ``<key>.npy``), writing void
    records of bfloat16 bits under the descr ``'<V2'`` as ``np.savez``
    writes an ``ml_dtypes.bfloat16`` array."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in payload.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if arr.dtype == _BF16_BITS:
                    np.lib.format.write_array_header_1_0(
                        fid, {"descr": "<V2", "fortran_order": False,
                              "shape": arr.shape})
                    fid.write(arr.tobytes())
                else:
                    np.lib.format.write_array(fid, arr, allow_pickle=False)


def save_sharded(root: str, step: int, state, meta: Optional[Dict] = None,
                 mesh=None) -> str:
    """Write ``state`` (a tree of tensors or arrays, on any device) as the
    checkpoint for ``step`` under ``root``; returns the committed step
    directory. Every leaf is one chunk in ``shard_00000.npz``; the manifest
    commits last. ``mesh`` (parallel/mesh.py), for a state replicated
    over its ranks, is recorded in the manifest as the JAX package
    records its mesh; a sharded state is not: its saves come with
    ROADMAP slice 8, and any other mesh raises."""
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh

    if mesh is not None and not isinstance(mesh, Mesh):
        raise NotImplementedError(
            f"saves sharded over a mesh come with {_MULTI_WRITER_SLICE}")
    step_dir = os.path.join(root, step_dir_name(step))
    os.makedirs(step_dir, exist_ok=True)

    payload: Dict[str, np.ndarray] = {}
    entries: List[LeafEntry] = []
    for path, leaf in _leaves_with_path(state):
        key = keystr(path)
        arr, dtype = _host_leaf(leaf)
        shape = tuple(int(d) for d in arr.shape)
        payload[key] = arr
        chunk = Chunk(file=_SHARD_FILE, key=key, start=(0,) * arr.ndim,
                      shape=shape, crc32=zlib.crc32(arr.tobytes()))
        entries.append(LeafEntry(path=key, shape=shape, dtype=dtype,
                                 spec=None, chunks=(chunk,)))

    with open(os.path.join(step_dir, _SHARD_FILE), "wb") as f:
        _savez(f, payload)
        f.flush()
        os.fsync(f.fileno())

    topology = None if mesh is None else {
        "axis_names": [str(a) for a in mesh.axis_names],
        "shape": [int(mesh.shape[a]) for a in mesh.axis_names]}
    manifest = Manifest(step=int(step), leaves=tuple(entries),
                        mesh=topology, meta=dict(meta or {}))
    write_manifest(step_dir, manifest)
    return step_dir


def save_process_shards(root: str, step: int, state,
                        process_index: Optional[int] = None) -> str:
    """One host's half of a multi-host save (not ported yet)."""
    raise NotImplementedError(
        f"save_process_shards comes with {_MULTI_WRITER_SLICE}")


def merge_process_manifests(root: str, step: int, n_processes: int,
                            **kwargs) -> str:
    """The coordinator's manifest merge barrier (not ported yet)."""
    raise NotImplementedError(
        f"merge_process_manifests comes with {_MULTI_WRITER_SLICE}")
