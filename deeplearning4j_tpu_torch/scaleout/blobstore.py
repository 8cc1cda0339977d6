"""Counterpart of ``deeplearning4j_tpu/scaleout/blobstore.py``: the
pluggable blob store, the remote-storage seam the CLI's ``--model`` URIs go
through.

Everything above the seam talks to the abstract ``BlobStore``; backends
plug in below it. The local-directory (``file://``) and in-memory
(``mem://``) backends are ported whole. The ``gs://`` backend
(``GCSBlobStore``) and the adapters above the seam (``BlobModelSaver``, the
store checkpoint helpers, ``BlobDataSetIterator``) come with ROADMAP slice
7, item 19; until then they raise and say so.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

_GCS_SLICE = "ROADMAP slice 7, item 19 (the scaleout host plane)"

_KEY_RE = re.compile(r"^[A-Za-z0-9._/\-]+$")


def _check_key(key: str) -> str:
    """Reject traversal and absolute keys (same discipline as the config
    registry, scaleout/registry.py)."""
    if not key or not _KEY_RE.match(key) or key.startswith("/") or ".." in key.split("/"):
        raise ValueError(f"invalid blob key {key!r}")
    return key


class BlobStore:
    """GCS-shaped object store: flat keys, whole-object get/put."""

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def try_get(self, key: str) -> Optional[bytes]:
        """``get`` or None if absent — one call, so a poller can't race a
        concurrent delete between ``exists`` and ``get``. Backends whose
        ``get`` raises ``KeyError``/``FileNotFoundError`` get this for
        free; local puts are atomic renames, so a non-None result is
        always a complete object."""
        try:
            return self.get(key)
        except (KeyError, FileNotFoundError):
            return None

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def list(self, prefix: str = "") -> List[str]:
        raise NotImplementedError


class LocalBlobStore(BlobStore):
    """Objects as files under a root directory (the reference's Hdfs/S3 tests
    run against local filesystems the same way)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, _check_key(key))

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic publish

    def get(self, key: str) -> bytes:
        with open(self._path(key), "rb") as f:
            return f.read()

    def exists(self, key: str) -> bool:
        return os.path.isfile(self._path(key))

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def list(self, prefix: str = "") -> List[str]:
        out = []
        for dirpath, _, files in os.walk(self.root):
            for name in files:
                if name.endswith(".tmp"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, name), self.root)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)


class InMemoryBlobStore(BlobStore):
    def __init__(self):
        self._data: Dict[str, bytes] = {}

    def put(self, key: str, data: bytes) -> None:
        self._data[_check_key(key)] = bytes(data)

    def get(self, key: str) -> bytes:
        return self._data[key]

    def exists(self, key: str) -> bool:
        return key in self._data

    def delete(self, key: str) -> None:
        self._data.pop(key, None)

    def list(self, prefix: str = "") -> List[str]:
        return sorted(k for k in self._data if k.startswith(prefix))


class GCSBlobStore(BlobStore):
    """Google Cloud Storage backend (not ported yet)."""

    def __init__(self, bucket: str, prefix: str = ""):
        raise NotImplementedError(
            f"the gs:// blob store comes with {_GCS_SLICE}; use file:// or "
            "mem:// stores")


# mem:// stores live for the life of the process, keyed by the URI's
# authority/path — so `train --model mem://x/params` followed by
# `test --model mem://x/params` in the same process reads the same bytes
# (a fresh store per open_store call would silently drop every write)
_MEM_STORES: Dict[str, InMemoryBlobStore] = {}


def open_store(uri: str) -> BlobStore:
    """URI scheme → store (parity with the CLI's URI Scheme registry,
    ref: cli/api/schemes/): file:///dir, mem://, gs://bucket/prefix."""
    if uri.startswith("file://"):
        return LocalBlobStore(uri[len("file://"):])
    if uri.startswith("mem://"):
        name = uri[len("mem://"):].strip("/")
        return _MEM_STORES.setdefault(name, InMemoryBlobStore())
    if uri.startswith("gs://"):
        rest = uri[len("gs://"):]
        bucket, _, prefix = rest.partition("/")
        return GCSBlobStore(bucket, prefix)
    # bare paths are local directories
    return LocalBlobStore(uri)


def split_store_uri(path: str) -> tuple:
    """Split ``<scheme>://<base>/<key>`` into (store URI, key) scheme-aware:
    a key directly after the scheme (``mem://params.npz``) yields the
    scheme's root store rather than misparsing into a literal local
    directory named ``mem:`` (a naive rpartition('/') does exactly that)."""
    scheme, sep, rest = path.partition("://")
    if not sep:
        base, _, key = path.rpartition("/")
        # '/key.npz' (absolute root): empty base would resolve against CWD
        if not base and path.startswith("/"):
            base = "/"
        return base, key
    if "/" in rest:
        base, _, key = rest.rpartition("/")
        # file:///key (absolute root) must keep the leading '/': an empty
        # base would make LocalBlobStore resolve the key relative to CWD
        if scheme == "file" and not base and rest.startswith("/"):
            base = "/"
    else:
        base, key = "", rest
    return f"{scheme}://{base}", key


# --------------------------------------------------------------- adapters ----

class BlobModelSaver:
    """ModelSaver over a BlobStore (not ported yet)."""

    def __init__(self, store: BlobStore, key: str = "nn-model.npz"):
        raise NotImplementedError(f"BlobModelSaver comes with {_GCS_SLICE}")


def save_checkpoint_to_store(store: BlobStore, key: str, net,
                             iteration: Optional[int] = None) -> str:
    """Full-state checkpoint through the blob seam (not ported yet)."""
    raise NotImplementedError(
        f"save_checkpoint_to_store comes with {_GCS_SLICE}")


def load_checkpoint_from_store(store: BlobStore, key: str):
    """Full-state checkpoint from the blob seam (not ported yet)."""
    raise NotImplementedError(
        f"load_checkpoint_from_store comes with {_GCS_SLICE}")


class BlobDataSetIterator:
    """DataSet batches from npz blobs under a key prefix (not ported
    yet)."""

    def __init__(self, store: BlobStore, prefix: str = ""):
        raise NotImplementedError(
            f"BlobDataSetIterator comes with {_GCS_SLICE}")
