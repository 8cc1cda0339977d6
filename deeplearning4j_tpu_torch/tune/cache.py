"""Counterpart of ``deeplearning4j_tpu/tune/cache.py``: the persistent
tuning cache, in JAX's file schema (``dl4j-tpu-tune-cache-v1``).

One JSON file (default ``TUNE_CACHE.json`` in the working directory,
override via ``DL4J_TPU_TUNE_CACHE``) maps

    (seam, model-shape fingerprint, knob-space version) -> winning config

where the fingerprint hashes the seam's full context dict — model dims,
mesh shape, backend, workload shape — canonically serialized (JAX's
``fingerprint``: the same context gives the same key in both packages),
so a changed ``d_model`` / mesh / backend is a MISS, never a silent
adoption of a config searched under different shapes. The port's
``backend`` is its device type ("cuda" or "cpu", ``tune.seams``), so a
winner JAX searched on its "gpu" backend, over other kernels, is never
adopted on the card; on the CPU both packages write "cpu". Entries whose
stored knob-space version differs from the live ``space_version(seam)``
are skipped at lookup and counted on the ``tune_cache_stale_entries``
gauge (watchtower rule ``tune_cache_stale`` fires on > 0).

Consumers reach the cache through :func:`resolve_tuned`, the precedence
contract of the ``tuned=`` seam on the LM's step factories, the pipeline
step and ``DecodeEngine``:

    explicit dict  >  ``tuned=True``  >  env ``DL4J_TPU_TUNED``  >  off

A corrupted cache file is ignored LOUDLY: one ``logging`` warning naming
the file and the parse error, then default-config behavior (empty cache).
Reads and writes share a lock and writes are atomic (unique tmp +
``os.replace``), so concurrent searchers never tear the file. The locks
are the ``tune.cache`` and ``tune.cache.default`` lockwatch seams
(``utils.lockwatch.make_lock``).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
from typing import Any, Dict, Optional

from deeplearning4j_tpu_torch.utils.lockwatch import make_lock



__all__ = [
    "TuningCache",
    "default_cache_path",
    "fingerprint",
    "resolve_step_tuning",
    "resolve_tuned",
]

log = logging.getLogger(__name__)

_SCHEMA = "dl4j-tpu-tune-cache-v1"
_ENV_CACHE = "DL4J_TPU_TUNE_CACHE"
_ENV_TUNED = "DL4J_TPU_TUNED"


def default_cache_path() -> str:
    """``DL4J_TPU_TUNE_CACHE`` if set, else ``TUNE_CACHE.json`` in cwd."""
    return os.environ.get(_ENV_CACHE) or os.path.join(
        os.getcwd(), "TUNE_CACHE.json")


def _canonical(obj: Any) -> Any:
    """Make a context JSON-stable: tuples->lists, sorted keys via dumps."""
    if isinstance(obj, dict):
        return {str(k): _canonical(v) for k, v in sorted(obj.items())}
    if isinstance(obj, (list, tuple)):
        return [_canonical(v) for v in obj]
    return obj


def fingerprint(context: Dict[str, Any]) -> str:
    """Short stable hash of a seam context (model dims, mesh, backend).

    Any key change — ``d_model``, ``mesh`` shape, ``backend`` — yields a
    different fingerprint, i.e. a cache miss.
    """
    blob = json.dumps(_canonical(context), sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class TuningCache:
    """JSON-backed winner store; thread-safe, atomic, version-checked."""

    def __init__(self, path: Optional[str] = None, registry=None):
        self.path = path or default_cache_path()
        self._lock = make_lock("tune.cache")  # lockwatch seam
        self._registry = registry

    # -- registry ----------------------------------------------------------
    def _gauge(self, name: str, value: float) -> None:
        reg = self._registry
        if reg is None:
            from deeplearning4j_tpu_torch.telemetry.registry import (
                default_registry,
            )
            reg = default_registry()
        reg.gauge(name).set(value)

    # -- file io -----------------------------------------------------------
    def _read(self) -> Dict[str, Any]:
        """Load the cache dict; corrupt/alien files warn once and read empty."""
        try:
            # under the caller's lock: the read-modify-replace cycle is
            # serialized whole, or concurrent store()s would be lost
            with open(self.path, "r", encoding="utf-8") as f:
                data = json.load(f)
        except FileNotFoundError:
            return {"schema": _SCHEMA, "entries": {}}
        except (json.JSONDecodeError, OSError, UnicodeDecodeError) as e:
            log.warning("tune cache %s unreadable (%s); using default "
                        "configs", self.path, e)
            return {"schema": _SCHEMA, "entries": {}}
        if (not isinstance(data, dict)
                or data.get("schema") != _SCHEMA
                or not isinstance(data.get("entries"), dict)):
            log.warning("tune cache %s has unexpected schema %r; using "
                        "default configs", self.path,
                        data.get("schema") if isinstance(data, dict)
                        else type(data).__name__)
            return {"schema": _SCHEMA, "entries": {}}
        return data

    def _write(self, data: Dict[str, Any]) -> None:
        dirname = os.path.dirname(os.path.abspath(self.path))
        fd, tmp = tempfile.mkstemp(prefix=".tune_cache.", dir=dirname)
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(data, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)  # atomic publish
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    @staticmethod
    def _key(seam: str, fp: str) -> str:
        return f"{seam}:{fp}"

    # -- api ---------------------------------------------------------------
    def store(self, seam: str, context: Dict[str, Any], config: Dict[str, Any],
              *, meta: Optional[Dict[str, Any]] = None) -> str:
        """Record ``config`` as the winner for (seam, context); returns key."""
        from deeplearning4j_tpu_torch.tune.space import space_version
        fp = fingerprint(context)
        key = self._key(seam, fp)
        with self._lock:
            data = self._read()
            data["entries"][key] = {
                "seam": seam,
                "fingerprint": fp,
                "space_version": space_version(seam),
                "context": _canonical(context),
                "config": _canonical(config),
                "meta": _canonical(meta or {}),
            }
            self._write(data)
        return key

    def lookup(self, seam: str, context: Dict[str, Any]
               ) -> Optional[Dict[str, Any]]:
        """Winning config for (seam, context) or None.

        Entries stored under a different knob-space version are treated
        as a miss and counted on ``tune_cache_stale_entries``.
        """
        from deeplearning4j_tpu_torch.tune.space import space_version
        key = self._key(seam, fingerprint(context))
        with self._lock:
            data = self._read()
        entry = data["entries"].get(key)
        self._gauge("tune_cache_stale_entries", float(self.stale_count(data)))
        if entry is None:
            return None
        if entry.get("space_version") != space_version(seam):
            log.warning("tune cache entry %s is stale (space_version %r != "
                        "live %r); using default config", key,
                        entry.get("space_version"), space_version(seam))
            return None
        return dict(entry["config"])

    def stale_count(self, data: Optional[Dict[str, Any]] = None) -> int:
        """Number of entries whose knob-space version lags the live one."""
        from deeplearning4j_tpu_torch.tune.space import space_names, space_version
        if data is None:
            with self._lock:
                data = self._read()
        live = {s: space_version(s) for s in space_names()}
        n = 0
        for entry in data["entries"].values():
            seam = entry.get("seam")
            if seam in live and entry.get("space_version") != live[seam]:
                n += 1
        return n

    def entries(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return dict(self._read()["entries"])


_default_cache: Optional[TuningCache] = None
_default_lock = make_lock("tune.cache.default")


def _shared_cache() -> TuningCache:
    global _default_cache
    with _default_lock:
        if (_default_cache is None
                or _default_cache.path != default_cache_path()):
            _default_cache = TuningCache()
        return _default_cache


def resolve_tuned(tuned, seam: str, context: Dict[str, Any],
                  cache: Optional[TuningCache] = None
                  ) -> Optional[Dict[str, Any]]:
    """Resolve the ``tuned=`` seam into a knob config (or None = defaults).

    - dict: adopted as-is (explicit wins over everything),
    - True: consult the cache,
    - False: defaults, no cache read,
    - None: consult the cache only when env ``DL4J_TPU_TUNED`` is truthy.
    """
    if isinstance(tuned, dict):
        return dict(tuned)
    if tuned is False:
        return None
    if tuned is None:
        env = os.environ.get(_ENV_TUNED, "").strip().lower()
        if env in ("", "0", "false", "off"):
            return None
    elif tuned is not True:
        raise TypeError(f"tuned= expects dict/bool/None, got {tuned!r}")
    return (cache or _shared_cache()).lookup(seam, context)


def resolve_step_tuning(tuned, tune_context, seams,
                        cache: Optional[TuningCache] = None
                        ) -> Dict[str, Any]:
    """The step factories' half of the ``tuned=`` seam.

    An explicit dict is adopted as-is. Cache modes (``True`` or the env
    gate) look up every seam in ``seams`` under ``tune_context`` — the
    SAME context dict the search stored its winner under (the
    ``tune.seams`` context builders are the canonical constructors;
    fingerprints are exact, so an improvised context is just a miss).
    ``tuned=True`` without a context is a programming error and raises;
    the env gate without a context quietly resolves to defaults so
    ``DL4J_TPU_TUNED=1`` never breaks callers that predate the seam.
    Returns a (possibly empty) merged knob dict.
    """
    if isinstance(tuned, dict):
        return dict(tuned)
    if tuned is False:
        return {}
    if tune_context is None:
        if tuned is True:
            raise ValueError(
                "tuned=True needs tune_context= (cache keys are "
                "shape-fingerprinted; build one with the "
                "deeplearning4j_tpu_torch.tune.seams context helpers)")
        return {}
    cfg: Dict[str, Any] = {}
    for seam in seams:
        got = resolve_tuned(tuned, seam, tune_context, cache=cache)
        if got:
            cfg.update(got)
    return cfg
