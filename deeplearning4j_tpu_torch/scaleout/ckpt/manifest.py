"""Counterpart of ``deeplearning4j_tpu/scaleout/ckpt/manifest.py``, copied
whole (numpy only): the checkpoint manifest, the commit record of a sharded
snapshot. The one change: ``Manifest.total_bytes`` sizes a ``bfloat16`` leaf
without ``ml_dtypes``, which numpy needs to know that name.

A checkpoint directory holds per-shard data files plus ONE ``MANIFEST.json``
written last via unique-tmp + ``os.replace``. The manifest is the atomicity
boundary: readers (``reshard.latest_step``, ``restore_sharded``, the
``ckpt_inspect`` CLI) treat a directory without a committed manifest as
nonexistent, so a writer killed mid-save can never be resumed from.

Schema (``format`` = ``dl4j-tpu-ckpt-v1``)::

    {"format": ..., "step": int,
     "mesh": {"axis_names": [...], "shape": [...]} | null,
     "meta": {...},                      # caller metadata (conf JSON, rng impl)
     "leaves": [{"path": "['params']['blocks']['wq']",
                 "shape": [...], "dtype": "float32",
                 "spec": [null, "expert"] | null,   # save-time PartitionSpec
                 "chunks": [{"file": "shard_00000.npz", "key": <path>,
                             "start": [...], "shape": [...],
                             "crc32": int}]}]}

``spec`` is informational (the save-time layout); restore never needs it —
chunk offsets alone determine how any *target* slice is covered.
"""

from __future__ import annotations

import dataclasses
import json
import os
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

FORMAT = "dl4j-tpu-ckpt-v1"
MANIFEST_NAME = "MANIFEST.json"
_STEP_PREFIX = "step_"


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One saved slice of one leaf: where it lives and what it covers."""

    file: str
    key: str
    start: Tuple[int, ...]
    shape: Tuple[int, ...]
    crc32: int

    def to_dict(self) -> Dict:
        return {"file": self.file, "key": self.key,
                "start": list(self.start), "shape": list(self.shape),
                "crc32": self.crc32}

    @classmethod
    def from_dict(cls, d: Dict) -> "Chunk":
        return cls(file=d["file"], key=d["key"], start=tuple(d["start"]),
                   shape=tuple(d["shape"]), crc32=int(d["crc32"]))


@dataclasses.dataclass(frozen=True)
class LeafEntry:
    path: str
    shape: Tuple[int, ...]
    dtype: str
    spec: Optional[List]
    chunks: Tuple[Chunk, ...]

    def to_dict(self) -> Dict:
        return {"path": self.path, "shape": list(self.shape),
                "dtype": self.dtype, "spec": self.spec,
                "chunks": [c.to_dict() for c in self.chunks]}

    @classmethod
    def from_dict(cls, d: Dict) -> "LeafEntry":
        return cls(path=d["path"], shape=tuple(d["shape"]), dtype=d["dtype"],
                   spec=d.get("spec"),
                   chunks=tuple(Chunk.from_dict(c) for c in d["chunks"]))


@dataclasses.dataclass(frozen=True)
class Manifest:
    step: int
    leaves: Tuple[LeafEntry, ...]
    mesh: Optional[Dict] = None
    meta: Optional[Dict] = None
    format: str = FORMAT

    def leaf(self, path: str) -> Optional[LeafEntry]:
        for entry in self.leaves:
            if entry.path == path:
                return entry
        return None

    @property
    def files(self) -> List[str]:
        seen: List[str] = []
        for entry in self.leaves:
            for chunk in entry.chunks:
                if chunk.file not in seen:
                    seen.append(chunk.file)
        return seen

    @property
    def total_bytes(self) -> int:
        total = 0
        for entry in self.leaves:
            itemsize = dtype_itemsize(entry.dtype)
            for chunk in entry.chunks:
                n = 1
                for dim in chunk.shape:
                    n *= dim
                total += n * itemsize
        return total

    def to_json(self) -> str:
        return json.dumps({
            "format": self.format,
            "step": self.step,
            "mesh": self.mesh,
            "meta": self.meta or {},
            "leaves": [entry.to_dict() for entry in self.leaves],
        }, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "Manifest":
        d = json.loads(text)
        if d.get("format") != FORMAT:
            raise ValueError(
                f"unsupported checkpoint format {d.get('format')!r} "
                f"(expected {FORMAT!r})")
        return cls(step=int(d["step"]),
                   leaves=tuple(LeafEntry.from_dict(e) for e in d["leaves"]),
                   mesh=d.get("mesh"), meta=d.get("meta") or {})


def dtype_itemsize(name: str) -> int:
    """Bytes per element of a manifest dtype name; ``bfloat16`` (2) is not
    a name numpy knows without ``ml_dtypes``."""
    import numpy as np

    return 2 if name == "bfloat16" else np.dtype(name).itemsize


def step_dir_name(step: int) -> str:
    return f"{_STEP_PREFIX}{int(step):010d}"


def parse_step(dirname: str) -> Optional[int]:
    base = os.path.basename(dirname.rstrip("/"))
    if not base.startswith(_STEP_PREFIX):
        return None
    try:
        return int(base[len(_STEP_PREFIX):])
    except ValueError:
        return None


def manifest_path(step_dir: str) -> str:
    return os.path.join(step_dir, MANIFEST_NAME)


def has_manifest(step_dir: str) -> bool:
    return os.path.isfile(manifest_path(step_dir))


def write_manifest(step_dir: str, manifest: Manifest) -> str:
    """Commit the manifest atomically: unique tmp (pid+uuid, so concurrent
    savers can never collide on the tmp name) then ``os.replace``. This is
    the LAST write of a save — the rename is the commit point."""
    final = manifest_path(step_dir)
    tmp = f"{final}.tmp-{os.getpid()}-{uuid.uuid4().hex}"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(manifest.to_json())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return final


def read_manifest(step_dir: str) -> Manifest:
    path = manifest_path(step_dir)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"no committed manifest in {step_dir} — an interrupted save is "
            "not a checkpoint")
    with open(path, "r", encoding="utf-8") as f:
        return Manifest.from_json(f.read())


# ------------------------------------------------- multi-host part files ----
# A multi-host save writes one PART manifest per process ("MANIFEST.part-
# <process>.json", atomic tmp+replace so a reader never sees a torn part),
# each listing every leaf but only the chunks that process owns. The
# coordinator merges the parts into the single committed MANIFEST.json —
# part files are working state, never a commit record: a directory with
# parts but no manifest is still an interrupted save.

_PART_PREFIX = "MANIFEST.part-"


def part_manifest_path(step_dir: str, process_index: int) -> str:
    return os.path.join(step_dir, f"{_PART_PREFIX}{int(process_index):05d}.json")


def write_part_manifest(step_dir: str, process_index: int, step: int,
                        entries: Sequence[LeafEntry]) -> str:
    final = part_manifest_path(step_dir, process_index)
    tmp = f"{final}.tmp-{os.getpid()}-{uuid.uuid4().hex}"
    payload = {"format": FORMAT, "process": int(process_index),
               "step": int(step),
               "leaves": [e.to_dict() for e in entries]}
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return final


def list_part_manifests(step_dir: str) -> List[Tuple[int, str]]:
    """(process_index, path) for every part file present, ascending."""
    out: List[Tuple[int, str]] = []
    if not os.path.isdir(step_dir):
        return out
    for name in sorted(os.listdir(step_dir)):
        if not (name.startswith(_PART_PREFIX) and name.endswith(".json")):
            continue
        try:
            idx = int(name[len(_PART_PREFIX):-len(".json")])
        except ValueError:
            continue
        out.append((idx, os.path.join(step_dir, name)))
    return out


def read_part_manifest(path: str) -> Tuple[int, int, Tuple[LeafEntry, ...]]:
    """→ (process_index, step, leaf entries)."""
    with open(path, "r", encoding="utf-8") as f:
        d = json.load(f)
    if d.get("format") != FORMAT:
        raise ValueError(f"unsupported part-manifest format "
                         f"{d.get('format')!r} in {path}")
    return (int(d["process"]), int(d["step"]),
            tuple(LeafEntry.from_dict(e) for e in d["leaves"]))


def committed_steps(root: str) -> List[Tuple[int, str]]:
    """(step, step_dir) for every COMMITTED checkpoint under root,
    ascending by step. Manifest-less (interrupted) directories are
    invisible here by design."""
    out: List[Tuple[int, str]] = []
    if not os.path.isdir(root):
        return out
    for name in sorted(os.listdir(root)):
        step = parse_step(name)
        step_dir = os.path.join(root, name)
        if step is None or not os.path.isdir(step_dir):
            continue
        if has_manifest(step_dir):
            out.append((step, step_dir))
    return sorted(out)


def uncommitted_dirs(root: str) -> List[Tuple[Optional[int], str]]:
    """step-shaped directories WITHOUT a manifest (interrupted saves)."""
    out: List[Tuple[Optional[int], str]] = []
    if not os.path.isdir(root):
        return out
    for name in sorted(os.listdir(root)):
        step = parse_step(name)
        step_dir = os.path.join(root, name)
        if step is None or not os.path.isdir(step_dir):
            continue
        if not has_manifest(step_dir):
            out.append((step, step_dir))
    return out


def serialize_spec(spec: Optional[Sequence]) -> Optional[List]:
    """PartitionSpec entries → JSON (None | str | [str, ...] per dim)."""
    if spec is None:
        return None
    out: List = []
    for part in spec:
        if part is None:
            out.append(None)
        elif isinstance(part, (tuple, list)):
            out.append([str(p) for p in part])
        else:
            out.append(str(part))
    return out
