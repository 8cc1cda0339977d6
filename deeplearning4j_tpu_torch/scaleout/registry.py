"""Counterpart of ``deeplearning4j_tpu/scaleout/registry.py``, copied (no framework
in it).

Configuration registry — service-discovery seam.

Parity with ref deeplearning4j-scaleout-zookeeper
(ZooKeeperConfigurationRegister/Retriever, ZookeeperPathBuilder): the akka
runner publishes the serialized training conf under a well-known path so
workers joining the cluster can retrieve it (DeepLearning4jDistributed.java:258).

Single-controller JAX needs no quorum service; the same contract is an
atomic file store under a shared directory (NFS/GCS-fuse in multi-host
settings). The API mirrors register/retrieve/delete by (namespace, id) path.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Optional


class ConfigurationRegistry:
    def __init__(self, root: Optional[str] = None):
        self.root = root or os.path.join(tempfile.gettempdir(), "dl4j-registry")
        os.makedirs(self.root, exist_ok=True)

    @staticmethod
    def _safe_component(s: str) -> str:
        s = s.replace("/", "_").replace("\\", "_")
        if s in ("", ".", ".."):
            raise ValueError(f"invalid registry path component {s!r}")
        return s

    def _path(self, namespace: str, conf_id: str) -> str:
        safe = [self._safe_component(s) for s in (namespace, conf_id)]
        path = os.path.join(self.root, safe[0], safe[1] + ".json")
        root = os.path.realpath(self.root)
        if not os.path.realpath(path).startswith(root + os.sep):
            raise ValueError("registry path escapes the root")
        return path

    def register(self, namespace: str, conf_id: str, conf: Dict[str, Any]) -> str:
        """Atomically publish a JSON-serializable configuration
        (ref ZooKeeperConfigurationRegister.register)."""
        path = self._path(namespace, conf_id)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(conf, f)
            os.replace(tmp, path)  # atomic on POSIX
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return path

    def retrieve(self, namespace: str, conf_id: str) -> Optional[Dict[str, Any]]:
        path = self._path(namespace, conf_id)
        if not os.path.exists(path):
            return None
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)

    def delete(self, namespace: str, conf_id: str) -> bool:
        path = self._path(namespace, conf_id)
        if os.path.exists(path):
            os.unlink(path)
            return True
        return False

    def list_ids(self, namespace: str) -> List[str]:
        d = os.path.join(self.root, self._safe_component(namespace))
        if not os.path.isdir(d):
            return []
        return sorted(f[:-5] for f in os.listdir(d) if f.endswith(".json"))
