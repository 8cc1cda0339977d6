"""Counterpart of ``deeplearning4j_tpu/scaleout/ckpt/sharded_io.py``: the
checkpoint writers.

Every leaf of the state tree is written in JAX's leaf order (dict keys
sorted, sequences in order, ``None`` an empty subtree) under its
``jax.tree_util.keystr`` path; the manifest — paths, shapes, dtypes, specs,
mesh topology, per-chunk CRC32s — commits LAST via atomic rename (see
manifest.py), so a crash mid-save leaves nothing a reader sees. A
``bfloat16`` leaf goes out as 2-byte void records (npy descr ``'<V2'``,
which ``ml_dtypes`` arrays get from ``np.savez``) named ``"bfloat16"`` in
the manifest.

A port tensor carries no sharding, so a save over a mesh takes each leaf's
spec from the spec tree the caller passes (``parallel.sharding``'s tuples:
``param_shardings`` expanded by ``layer_specs``/``state_specs``, or
``lm_param_shardings``). Each leaf is then split into its UNIQUE chunks
(replicas deduplicated) and each chunk goes to the lowest rank that holds
it, into that rank's ``shard_<rank>.npz``: the files, chunk ``start``s,
specs and topology JAX writes for the same state on a mesh of the same
shape, rank r's chunks where device r's are.

- ``save_sharded`` takes the WHOLE state (one process; with no mesh every
  leaf is one chunk in ``shard_00000.npz``);
- ``save_process_shards`` takes this rank's LOCAL state (its chunks, as
  ``apply_shardings``/``shard_lm_params`` placed them) and writes only
  the chunks it owns plus a part manifest; ``merge_process_manifests``
  (the coordinator) waits for every part, checks that the chunks tile
  every leaf, and commits the one manifest last.
"""

from __future__ import annotations

import os
import time
import zipfile
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.scaleout.ckpt.manifest import (
    Chunk,
    LeafEntry,
    Manifest,
    list_part_manifests,
    part_manifest_path,
    read_part_manifest,
    serialize_spec,
    step_dir_name,
    write_manifest,
    write_part_manifest,
)
from deeplearning4j_tpu_torch.scaleout.ckpt.reshard import dtype_name, \
    keystr

# how a bfloat16 leaf's bits sit in the npz: 2-byte void records
_BF16_BITS = np.dtype("V2")


def _shard_file_name(rank: int) -> str:
    return f"shard_{rank:05d}.npz"


def _leaves_with_path(tree, specs=None) -> List[Tuple[tuple, object, tuple]]:
    """``(path, leaf, spec)`` in ``jax.tree_util.tree_flatten_with_path``
    order, ``None`` an empty subtree; each leaf's spec from
    ``parallel.sharding.spec_leaves`` (none named: ``()``)."""
    from deeplearning4j_tpu_torch._device import tree_leaves, tree_paths
    from deeplearning4j_tpu_torch.parallel.sharding import spec_leaves

    return [(path, leaf, tuple(spec or ())) for path, leaf, spec in zip(
        tree_paths(tree), tree_leaves(tree), spec_leaves(specs, tree))
        if leaf is not None]


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


def _mesh_size(mesh) -> int:
    size = 1
    for a in mesh.axis_names:
        size *= int(mesh.shape[a])
    return size


def _topology(mesh) -> Optional[Dict]:
    if mesh is None:
        return None
    return {"axis_names": [str(a) for a in mesh.axis_names],
            "shape": [int(mesh.shape[a]) for a in mesh.axis_names]}


def _global_chunks(arr: np.ndarray, spec, mesh) -> List[Tuple]:
    """(owner rank, start, chunk) per UNIQUE rectangle of a whole leaf
    under ``spec`` on ``mesh``, the lowest rank holding a rectangle its
    owner, sorted by start (JAX's ``_leaf_chunks``)."""
    from deeplearning4j_tpu_torch.parallel.sharding import local_region, \
        rank_coords

    if mesh is None or spec is None:
        return [(0, (0,) * arr.ndim, arr)]
    by_start: Dict[tuple, Tuple] = {}
    for rank in range(_mesh_size(mesh)):
        starts, sizes = local_region(arr.shape, spec, mesh.shape,
                                     rank_coords(mesh, rank))
        if starts not in by_start:
            by_start[starts] = (rank, sizes)
    out = []
    for start in sorted(by_start):
        rank, sizes = by_start[start]
        idx = tuple(slice(s, s + n) for s, n in zip(start, sizes))
        out.append((rank, start, np.ascontiguousarray(arr[idx])))
    return out


def _write_files(step_dir: str, per_file: Dict[str, Dict]) -> None:
    for fname, payload in sorted(per_file.items()):
        with open(os.path.join(step_dir, fname), "wb") as f:
            _savez(f, payload)
            f.flush()
            os.fsync(f.fileno())


def _chunk(fname: str, key: str, start, arr: np.ndarray) -> Chunk:
    return Chunk(file=fname, key=key, start=tuple(int(s) for s in start),
                 shape=tuple(int(d) for d in arr.shape),
                 crc32=zlib.crc32(arr.tobytes()))


def save_sharded(root: str, step: int, state, meta: Optional[Dict] = None,
                 mesh=None, specs=None) -> str:
    """Write ``state`` (a tree of WHOLE tensors or arrays, on any device)
    as the checkpoint for ``step`` under ``root``; returns the committed
    step directory. With ``mesh`` and ``specs`` (a spec tree mirroring
    ``state``) each leaf is split into its unique chunks, each in its
    owner rank's file, and the manifest records the specs; with ``mesh``
    alone (a state replicated over the mesh, as the data-parallel
    trainer's) every leaf is one chunk and the manifest records the mesh.
    The manifest commits last."""
    if specs is not None and mesh is None:
        raise ValueError("a save with specs needs the mesh they name")
    step_dir = os.path.join(root, step_dir_name(step))
    os.makedirs(step_dir, exist_ok=True)

    per_file: Dict[str, Dict[str, np.ndarray]] = {}
    entries: List[LeafEntry] = []
    for path, leaf, spec in _leaves_with_path(state, specs):
        key = keystr(path)
        arr, dtype = _host_leaf(leaf)
        chunks = []
        for rank, start, part in _global_chunks(
                arr, spec if specs is not None else None, mesh):
            fname = _shard_file_name(rank)
            per_file.setdefault(fname, {})[key] = part
            chunks.append(_chunk(fname, key, start, part))
        entries.append(LeafEntry(
            path=key, shape=tuple(int(d) for d in arr.shape), dtype=dtype,
            spec=serialize_spec(spec) if specs is not None else None,
            chunks=tuple(chunks)))
    _write_files(step_dir, per_file)
    manifest = Manifest(step=int(step), leaves=tuple(entries),
                        mesh=_topology(mesh), meta=dict(meta or {}))
    write_manifest(step_dir, manifest)
    return step_dir


# ----------------------------------------------------- multi-process writer ----

def save_process_shards(root: str, step: int, state,
                        process_index: Optional[int] = None, *, mesh=None,
                        specs=None) -> str:
    """One rank's half of a multi-process save: write ONLY the chunks this
    rank owns (the lowest rank holding a rectangle writes it, so replicas
    write once across the mesh) plus an atomic part manifest listing
    every leaf with this rank's chunks. ``state`` is this rank's LOCAL
    tree, each leaf its chunk under the spec at its path of ``specs``
    (None: every leaf whole and replicated, owned by rank 0);
    ``process_index`` defaults to the rank on ``mesh``. Nothing here is a
    commit: the step stays invisible until ``merge_process_manifests``
    lands the manifest."""
    from deeplearning4j_tpu_torch.parallel.sharding import global_shape, \
        local_region, spec_axes

    if specs is not None and mesh is None:
        raise ValueError("a save with specs needs the mesh they name")
    if process_index is None:
        process_index = int(mesh.rank) if mesh is not None else 0
    coords = mesh.coords if mesh is not None else {}
    mesh_shape = mesh.shape if mesh is not None else {}
    step_dir = os.path.join(root, step_dir_name(step))
    os.makedirs(step_dir, exist_ok=True)

    per_file: Dict[str, Dict[str, np.ndarray]] = {}
    entries: List[LeafEntry] = []
    fname = _shard_file_name(process_index)
    for path, leaf, spec in _leaves_with_path(state, specs):
        key = keystr(path)
        arr, dtype = _host_leaf(leaf)
        used = {a for e in spec for a in spec_axes(e)}
        shape = global_shape(arr.shape, spec, mesh_shape)
        start, _ = local_region(shape, spec, mesh_shape, coords)
        owner = all(int(coords.get(a, 0)) == 0 for a in coords
                    if a not in used)
        chunks = ()
        if owner:
            per_file.setdefault(fname, {})[key] = arr
            chunks = (_chunk(fname, key, start, arr),)
        entries.append(LeafEntry(
            path=key, shape=tuple(shape), dtype=dtype,
            spec=serialize_spec(spec) if specs is not None else None,
            chunks=chunks))
    _write_files(step_dir, per_file)
    write_part_manifest(step_dir, process_index, step, entries)
    return step_dir


def merge_process_manifests(root: str, step: int, n_processes: int,
                            meta: Optional[Dict] = None, mesh=None,
                            timeout_s: float = 120.0,
                            poll_s: float = 0.05) -> str:
    """The coordinator's merge barrier: wait for all ``n_processes`` part
    manifests, union their chunk lists per leaf, check that the union
    covers every leaf's global shape exactly, THEN commit the one
    manifest atomically (recording ``mesh``'s topology) and remove the
    parts. A coordinator killed before the final rename leaves no
    committed manifest: readers still resume from the previous step."""
    step_dir = os.path.join(root, step_dir_name(step))
    deadline = time.monotonic() + timeout_s
    while True:
        parts = list_part_manifests(step_dir)
        if len(parts) >= int(n_processes):
            break
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"manifest merge barrier: {len(parts)}/{n_processes} part "
                f"manifests present in {step_dir} after {timeout_s}s "
                f"(have processes {[i for i, _ in parts]})")
        time.sleep(poll_s)

    merged: Dict[str, LeafEntry] = {}
    order: List[str] = []
    for _proc, path in parts:
        _idx, got_step, entries = read_part_manifest(path)
        if got_step != int(step):
            raise ValueError(
                f"part manifest {path} is for step {got_step}, merging "
                f"step {step}")
        for entry in entries:
            prev = merged.get(entry.path)
            if prev is None:
                merged[entry.path] = entry
                order.append(entry.path)
                continue
            if prev.shape != entry.shape or prev.dtype != entry.dtype:
                raise ValueError(
                    f"part manifests disagree on leaf {entry.path}: "
                    f"{prev.shape}/{prev.dtype} vs "
                    f"{entry.shape}/{entry.dtype}")
            merged[entry.path] = LeafEntry(
                path=prev.path, shape=prev.shape, dtype=prev.dtype,
                spec=prev.spec if prev.spec is not None else entry.spec,
                chunks=prev.chunks + entry.chunks)

    # coverage check BEFORE the commit: the disjoint chunks must tile each
    # leaf exactly; a missing rank's chunks fail here
    for path in order:
        entry = merged[path]
        want = int(np.prod(entry.shape, dtype=np.int64))
        got = sum(int(np.prod(c.shape, dtype=np.int64))
                  for c in entry.chunks)
        if got != want:
            raise ValueError(
                f"merge barrier: leaf {path} chunks cover {got} of {want} "
                f"elements — a rank's shards are missing; refusing to "
                "commit a checkpoint with holes")

    manifest = Manifest(step=int(step),
                        leaves=tuple(merged[p] for p in order),
                        mesh=_topology(mesh), meta=dict(meta or {}))
    write_manifest(step_dir, manifest)
    for proc, _path in parts:
        part = part_manifest_path(step_dir, proc)
        if os.path.exists(part):
            os.unlink(part)
    return step_dir
