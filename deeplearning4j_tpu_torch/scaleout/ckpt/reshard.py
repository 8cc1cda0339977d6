"""Counterpart of ``deeplearning4j_tpu/scaleout/ckpt/reshard.py``: the read
side of the sharded checkpoint format, onto one device.

A checkpoint saved on any mesh restores here: every leaf, or with
``shardings=`` this rank's chunk of it, is assembled on the host from the
saved chunks that cover it (``assemble_region``, with the same coverage
check as the JAX package), CRC-checked on first touch, and placed on the
target device as a torch tensor. A rank reads only the saved chunks its
target rectangle touches: the rectangle ``parallel.sharding.local_chunk``
(``apply_shardings``, ``shard_lm_params``) would give it, whatever mesh
the save ran on.

Strictness is the JAX package's: a missing leaf, a shape mismatch, a lossy
dtype narrowing or an uncovered region raise.

``bfloat16`` leaves need no ``ml_dtypes``: the JAX package writes them as
2-byte void records (npy descr ``'<V2'``) and names them ``"bfloat16"`` in
the manifest, so the port reads the bits as ``uint16`` and views them as
``torch.bfloat16``.
"""

from __future__ import annotations

import os
import re
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.scaleout.ckpt.manifest import (
    LeafEntry,
    Manifest,
    committed_steps,
    read_manifest,
)

# manifest dtype name -> torch dtype, for every dtype a checkpoint of this
# tree holds
TORCH_DTYPES: Dict[str, torch.dtype] = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
# the lossless widenings of bfloat16 (numpy's "safe" casts under ml_dtypes)
_BF16_SAFE = ("bfloat16", "float32", "float64")


class CorruptShardError(ValueError):
    """A chunk's bytes don't match the manifest CRC. The message names the
    shard file, leaf path, and chunk index so an operator knows exactly
    which file to re-copy (or which step to abandon)."""


def latest_step(root: str) -> Optional[int]:
    """Highest COMMITTED step under root; interrupted (manifest-less)
    directories are ignored."""
    steps = committed_steps(root)
    return steps[-1][0] if steps else None


def latest_step_dir(root: str) -> Optional[str]:
    steps = committed_steps(root)
    return steps[-1][1] if steps else None


def keystr(path: tuple) -> str:
    """A tree path as ``jax.tree_util.keystr`` writes it: ``['key']`` for
    a dict key, ``[i]`` for a sequence index."""
    return "".join(f"[{k!r}]" for k in path)


def dtype_name(leaf) -> str:
    """The manifest name of a tensor's or an array's dtype."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def check_compatible(saved_shape: Tuple[int, ...], saved_dtype: str,
                     template_leaf, path: str) -> str:
    """Strict template check: exact shape, and dtype either identical or a
    SAFE (lossless) cast to the template dtype. Returns the target dtype's
    manifest name.

    float64→float32, int64→int32 etc. are data-losing narrows and raise.
    """
    t_shape = tuple(int(d) for d in np.shape(template_leaf))
    if tuple(saved_shape) != t_shape:
        raise ValueError(
            f"checkpoint leaf {path} has shape {tuple(saved_shape)} but the "
            f"template expects {t_shape} — refusing to broadcast/truncate")
    dst = dtype_name(template_leaf)
    if saved_dtype == dst:
        return dst
    if "bfloat16" in (saved_dtype, dst):
        safe = saved_dtype == "bfloat16" and dst in _BF16_SAFE
    else:
        safe = np.can_cast(np.dtype(saved_dtype), np.dtype(dst),
                           casting="safe")
    if not safe:
        raise TypeError(
            f"checkpoint leaf {path} was saved as {saved_dtype} but the "
            f"template is {dst} — a lossy dtype narrowing; restore into a "
            "matching-dtype template instead")
    return dst


def _storage(dtype: str) -> np.dtype:
    """The numpy dtype that holds a leaf's bits on the host."""
    return np.dtype(np.uint16) if dtype == "bfloat16" else np.dtype(dtype)


class _ChunkStore:
    """Lazy per-file npz handles so a restore only reads the members the
    target region actually covers. With ``verify_crc`` every chunk is
    CRC-checked once, on first read — silent disk corruption becomes a
    load-time ``CorruptShardError``, not late training divergence."""

    def __init__(self, step_dir: str, verify_crc: bool = False):
        self.step_dir = step_dir
        self.verify_crc = verify_crc
        self._files: Dict[str, object] = {}
        self._crc_ok: set = set()

    def get(self, fname: str, key: str) -> np.ndarray:
        z = self._files.get(fname)
        if z is None:
            z = np.load(os.path.join(self.step_dir, fname))
            self._files[fname] = z
        return z[key]

    def get_checked(self, entry: LeafEntry, chunk_index: int) -> np.ndarray:
        """Read one chunk of ``entry``, verifying its CRC on first touch."""
        chunk = entry.chunks[chunk_index]
        data = self.get(chunk.file, chunk.key)
        if self.verify_crc and (chunk.file, chunk.key) not in self._crc_ok:
            crc = zlib.crc32(np.ascontiguousarray(data).tobytes())
            if crc != chunk.crc32:
                raise CorruptShardError(
                    f"checkpoint shard {chunk.file} is corrupt: leaf "
                    f"{entry.path} chunk {chunk_index} (of "
                    f"{len(entry.chunks)}, start {tuple(chunk.start)}) "
                    f"read crc32 {crc} != manifest {chunk.crc32} — re-copy "
                    f"the shard file or restore a different step")
            self._crc_ok.add((chunk.file, chunk.key))
        return data

    def close(self) -> None:
        for z in self._files.values():
            z.close()
        self._files = {}

    def __enter__(self) -> "_ChunkStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _region_of(index, shape) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """An index (tuple of slices, possibly open) → (starts, sizes)."""
    if index is None:
        return (0,) * len(shape), tuple(shape)
    starts, sizes = [], []
    for sl, dim in zip(index, shape):
        start, stop, stride = sl.indices(dim)
        if stride != 1:
            raise ValueError(f"strided restore index {sl} is not supported")
        starts.append(start)
        sizes.append(stop - start)
    return tuple(starts), tuple(sizes)


def assemble_region(entry: LeafEntry, store: _ChunkStore, index,
                    dtype: str) -> np.ndarray:
    """Build the requested index rectangle of one leaf (``index`` None: all
    of it) from the covering saved chunks, as host storage of the saved
    dtype (``uint16`` bits for ``bfloat16``), cast to ``dtype`` where that
    differs. Chunks from a sharding partition the global space, so overlap
    volumes must sum to the region volume — anything less means a
    corrupt/incomplete checkpoint and raises."""
    starts, sizes = _region_of(index, entry.shape)
    src_dtype = _storage(entry.dtype)
    out_dtype = src_dtype if dtype == "bfloat16" else np.dtype(dtype)
    # same-layout fast path: one saved chunk IS the requested region
    for i, chunk in enumerate(entry.chunks):
        if tuple(chunk.start) == starts and tuple(chunk.shape) == tuple(sizes):
            return _host(store.get_checked(entry, i), entry.dtype, out_dtype)
    out = np.empty(sizes, dtype=out_dtype)
    covered = 0
    for i, chunk in enumerate(entry.chunks):
        lo = [max(s, cs) for s, cs in zip(starts, chunk.start)]
        hi = [min(s + n, cs + cn)
              for s, n, cs, cn in zip(starts, sizes, chunk.start, chunk.shape)]
        if any(l >= h for l, h in zip(lo, hi)):
            continue
        data = _host(store.get_checked(entry, i), entry.dtype, out_dtype)
        src = tuple(slice(l - cs, h - cs)
                    for l, h, cs in zip(lo, hi, chunk.start))
        dst = tuple(slice(l - s, h - s) for l, h, s in zip(lo, hi, starts))
        out[dst] = data[src]
        vol = 1
        for l, h in zip(lo, hi):
            vol *= h - l
        covered += vol
    if covered != out.size:
        raise ValueError(
            f"checkpoint leaf {entry.path}: saved chunks cover {covered} of "
            f"{out.size} elements of the requested region — incomplete "
            "checkpoint")
    return out


def _host(data: np.ndarray, saved: str, out_dtype: np.dtype) -> np.ndarray:
    """A stored chunk as a writable host array of ``out_dtype``: bfloat16
    bits (void records) viewed as ``uint16``, widened exactly where the
    target is float32/float64."""
    if saved == "bfloat16":
        bits = np.ascontiguousarray(data).view(np.uint16)
        if out_dtype == np.uint16:
            return np.array(bits, copy=True)
        # bf16 is the top half of an f32: widening is a shift, exact
        wide = (bits.astype(np.uint32) << 16).view(np.float32)
        return wide.astype(out_dtype)
    return np.array(data, dtype=out_dtype, copy=True)


def _to_tensor(arr: np.ndarray, dtype: str,
              device: torch.device) -> torch.Tensor:
    """A host array from ``assemble_region`` as a tensor of ``dtype`` on
    ``device``."""
    t = torch.from_numpy(arr)
    if dtype == "bfloat16":
        t = t.view(torch.int16).view(torch.bfloat16)
    return t.to(device)


def restore_sharded(step_dir: str, template, shardings=None,
                    verify_crc: bool = True, *, device: DeviceLike = None,
                    mesh=None):
    """Restore the tree saved in ``step_dir`` into the structure of
    ``template`` (a tree of dicts, tuples and lists whose leaves carry
    the WHOLE leaves' ``shape`` and ``dtype``: tensors, on any device
    including ``meta``, or numpy arrays). Returns ``(state, manifest)``,
    every leaf a tensor on ``device`` (CUDA unless ``device="cpu"``).

    ``shardings``: a spec tree mirroring ``template`` (``parallel.
    sharding``'s tuples; None or a missing entry: the whole leaf), with
    ``mesh`` (anything with ``shape`` and ``coords``: this rank's place on
    the target mesh). A leaf with a spec is built from this rank's
    rectangle alone, read from the covering saved chunks, whatever mesh
    the save ran on: the chunk ``apply_shardings`` would give the rank.

    Strict by construction: missing leaves, shape mismatches, and lossy
    dtype narrowing raise (see ``check_compatible``); every chunk read is
    CRC-verified (``verify_crc=False`` opts out) so a corrupt shard fails
    the restore with a ``CorruptShardError`` naming the file.
    """
    from deeplearning4j_tpu_torch._device import tree_leaves, tree_paths, \
        tree_unflatten
    from deeplearning4j_tpu_torch.parallel.sharding import local_region, \
        spec_leaves

    if shardings is not None and mesh is None:
        raise ValueError("restore_sharded(shardings=) needs mesh=, the "
                         "rank's place on the mesh the specs name")
    dev = resolve_device(device)
    manifest = read_manifest(step_dir)
    by_path = {entry.path: entry for entry in manifest.leaves}
    leaves = tree_leaves(template)
    specs = spec_leaves(shardings, template) if shardings is not None \
        else [None] * len(leaves)
    out = []
    with _ChunkStore(step_dir, verify_crc=verify_crc) as store:
        for path, t_leaf, spec in zip(tree_paths(template), leaves, specs):
            if t_leaf is None:  # an empty subtree, as in a JAX pytree
                out.append(None)
                continue
            key = keystr(path)
            entry = by_path.get(key)
            if entry is None:
                raise KeyError(f"checkpoint is missing leaf {key}")
            dtype = check_compatible(entry.shape, entry.dtype, t_leaf, key)
            index = None
            if spec:
                starts, sizes = local_region(entry.shape, spec, mesh.shape,
                                             mesh.coords)
                index = tuple(slice(a, a + n) for a, n in zip(starts, sizes))
            out.append(_to_tensor(assemble_region(entry, store, index,
                                                  dtype), dtype, dev))
    return tree_unflatten(template, out), manifest


_KEYSTR_SEG = re.compile(r"\['([^']*)'\]")


def template_from_manifest(manifest: Manifest):
    """Rebuild a template tree from the manifest alone (leaf paths + global
    shapes + dtypes) — template-free restore for consumers that don't hold
    the training-time structure, e.g. the serving engine loading an LM
    checkpoint (``serve.DecodeEngine.from_checkpoint``). Leaves are tensors
    on the ``meta`` device: they carry shape and dtype and hold no memory.
    Supports string-keyed nested dicts, the layout every checkpoint in
    this tree uses; anything else raises rather than guessing."""
    tree: Dict = {}
    for entry in manifest.leaves:
        keys = _KEYSTR_SEG.findall(entry.path)
        if "".join(f"['{k}']" for k in keys) != entry.path or not keys:
            raise ValueError(
                f"manifest leaf path {entry.path!r} is not a string-keyed "
                "dict path — template-free restore supports dict trees "
                "only; restore with an explicit template instead")
        if entry.dtype not in TORCH_DTYPES:
            raise TypeError(f"manifest leaf {entry.path} has dtype "
                            f"{entry.dtype!r}, which the port does not map")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.empty(tuple(entry.shape),
                                     dtype=TORCH_DTYPES[entry.dtype],
                                     device="meta")
    return tree


def verify_checksums(step_dir: str) -> List[str]:
    """Re-read every chunk and compare CRC32 against the manifest. Returns
    a list of human-readable mismatch descriptions (empty = intact)."""
    manifest = read_manifest(step_dir)
    problems: List[str] = []
    with _ChunkStore(step_dir) as store:
        for entry in manifest.leaves:
            for i, chunk in enumerate(entry.chunks):
                where = (f"{entry.path} chunk {i} [{chunk.file}, "
                         f"start {tuple(chunk.start)}]")
                try:
                    data = np.ascontiguousarray(
                        store.get(chunk.file, chunk.key))
                except Exception as e:  # missing file/member counts as corrupt
                    problems.append(f"{where}: unreadable ({e})")
                    continue
                crc = zlib.crc32(data.tobytes())
                if crc != chunk.crc32:
                    problems.append(
                        f"{where}: crc32 {crc} != manifest {chunk.crc32}")
                if tuple(data.shape) != chunk.shape:
                    problems.append(
                        f"{where}: stored shape {tuple(data.shape)} != "
                        f"manifest {chunk.shape}")
    return problems
