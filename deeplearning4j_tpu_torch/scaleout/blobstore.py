"""Counterpart of ``deeplearning4j_tpu/scaleout/blobstore.py``: the
pluggable blob store, the remote-storage seam the CLI's ``--model`` URIs go
through.

Everything above the seam talks to the abstract ``BlobStore``; backends
plug in below it: the local-directory (``file://``), in-memory
(``mem://``) and Google Cloud Storage (``gs://``) backends, and the
adapters above the seam (``BlobModelSaver``, the store checkpoint helpers
over ``scaleout/checkpoint.py``, ``BlobDataSetIterator``). The ``gs://``
backend needs the google-cloud-storage package and fails loudly without
it, as the JAX package's does.
"""

from __future__ import annotations

import io
import os
import re
from typing import Dict, List, Optional

import numpy as np

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
    """Google Cloud Storage backend (the analogue of the reference's S3
    module). Requires google-cloud-storage at runtime; without it
    construction fails loudly rather than pretending."""

    def __init__(self, bucket: str, prefix: str = ""):
        try:
            from google.cloud import storage  # type: ignore
        except ImportError as exc:  # pragma: no cover - environment-dependent
            raise RuntimeError(
                "GCSBlobStore requires the google-cloud-storage package; "
                "use file:// or mem:// stores in environments without it"
            ) from exc
        self._bucket = storage.Client().bucket(bucket)  # pragma: no cover
        self.prefix = prefix.strip("/")  # pragma: no cover

    def _name(self, key: str) -> str:  # pragma: no cover
        key = _check_key(key)
        return f"{self.prefix}/{key}" if self.prefix else key

    def put(self, key: str, data: bytes) -> None:  # pragma: no cover
        self._bucket.blob(self._name(key)).upload_from_string(data)

    def get(self, key: str) -> bytes:  # pragma: no cover
        return self._bucket.blob(self._name(key)).download_as_bytes()

    def exists(self, key: str) -> bool:  # pragma: no cover
        return self._bucket.blob(self._name(key)).exists()

    def delete(self, key: str) -> None:  # pragma: no cover
        self._bucket.blob(self._name(key)).delete()

    def list(self, prefix: str = "") -> List[str]:  # pragma: no cover
        if prefix:
            _check_key(prefix)
        # anchor on "<store-prefix>/" so a sibling object sharing the prefix
        # string (e.g. "models-old/x" next to store prefix "models") is
        # neither matched nor mis-sliced
        base = self.prefix + "/" if self.prefix else ""
        names = [b.name for b in self._bucket.list_blobs(prefix=base + prefix)]
        return sorted(n[len(base):] for n in names if n.startswith(base))


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
    """ModelSaver over a BlobStore (ref: S3ModelSaver / HdfsModelSaver):
    the conf JSON + flat params npz of ``MultiLayerNetwork.save``. ``load``
    rebuilds the net on ``device`` (CUDA unless ``device="cpu"``)."""

    def __init__(self, store: BlobStore, key: str = "nn-model.npz",
                 device=None):
        self.store = store
        self.key = key
        self.device = device

    def save(self, model) -> None:
        buf = io.BytesIO()
        np.savez(
            buf,
            params=model.params().detach().cpu().numpy(),
            conf=np.frombuffer(model.conf.to_json().encode(), dtype=np.uint8),
        )
        self.store.put(self.key, buf.getvalue())

    def load(self):
        from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        with np.load(io.BytesIO(self.store.get(self.key))) as z:
            conf = MultiLayerConfiguration.from_json(bytes(z["conf"]).decode())
            net = MultiLayerNetwork(conf, device=self.device).init()
            net.set_params(z["params"])
        return net

    def exists(self) -> bool:
        return self.store.exists(self.key)


def save_checkpoint_to_store(store: BlobStore, key: str, net,
                             iteration: Optional[int] = None) -> str:
    """Full-state checkpoint (params + updater state + iteration + key)
    through the blob seam; same payload as scaleout/checkpoint.py."""
    import tempfile

    from deeplearning4j_tpu_torch.scaleout.checkpoint import save_checkpoint

    with tempfile.TemporaryDirectory() as d:
        path = save_checkpoint(os.path.join(d, "ckpt"), net, iteration)
        with open(path, "rb") as f:
            store.put(key, f.read())
    return key


def load_checkpoint_from_store(store: BlobStore, key: str, device=None):
    """(net, iteration) from a checkpoint blob, the net on ``device`` (CUDA
    unless ``device="cpu"``)."""
    import tempfile

    from deeplearning4j_tpu_torch.scaleout.checkpoint import load_checkpoint

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.npz")
        with open(path, "wb") as f:
            f.write(store.get(key))
        return load_checkpoint(path, device=device)


class BlobDataSetIterator:
    """DataSet batches from serialized npz blobs under a key prefix
    (ref: BaseS3DataSetIterator / BaseHdfsDataSetIterator). Each blob holds
    one batch: arrays ``features`` and ``labels`` (host arrays; the
    network moves them to its device)."""

    def __init__(self, store: BlobStore, prefix: str = ""):
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet

        self._DataSet = DataSet
        self.store = store
        self.keys = store.list(prefix)
        self._pos = 0

    @staticmethod
    def write_batch(store: BlobStore, key: str, features, labels) -> None:
        buf = io.BytesIO()
        np.savez(buf, features=np.asarray(features), labels=np.asarray(labels))
        store.put(key, buf.getvalue())

    def has_next(self) -> bool:
        return self._pos < len(self.keys)

    def next(self, num=None):
        if not self.has_next():
            raise StopIteration
        key = self.keys[self._pos]
        self._pos += 1
        with np.load(io.BytesIO(self.store.get(key))) as z:
            return self._DataSet(z["features"], z["labels"])

    def reset(self) -> None:
        self._pos = 0

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next()
