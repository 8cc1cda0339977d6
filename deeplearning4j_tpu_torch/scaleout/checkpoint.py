"""Counterpart of ``deeplearning4j_tpu/scaleout/checkpoint.py``:
single-file training checkpoints over ``scaleout/ckpt/net_state.py``.

The reference checkpoints only conf JSON + flat params (ModelSaver /
MultiLayerNetwork(String conf, INDArray params)). This captures the
complete training state — per-layer params, per-layer updater state, the
key stream's position and the iteration counter — in one self-contained
``.npz``, so training resumes where it stopped.

The members are the JAX package's, byte for byte: every leaf under
``tree::`` + its path in ``jax.tree_util.keystr``'s format
(``tree::['params'][0]['W']``), ``__conf_json__``, ``__iteration__``, the
key as two uint32 words under ``__rng_key__`` (``__rng_impl__`` when a
typed key wrote it) and ``__meta_json__``. A file written by either
package loads in the other; the key words seed package-local streams.

Strictness matches the sharded loader: a missing leaf raises ``KeyError``,
a shape mismatch ``ValueError`` and a lossy dtype narrowing ``TypeError``,
never a silent ``astype``. The tmp file is unique per writer (pid + uuid)
and committed with ``os.replace``, so concurrent savers never clobber each
other's partial writes and a failed save leaves the previous checkpoint at
``path`` intact.
"""

from __future__ import annotations

import json
import os
import uuid
from typing import Any, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import DeviceLike, tree_leaves, \
    tree_unflatten

_CONF_KEY = "__conf_json__"
_META_KEY = "__meta_json__"
_ITER_KEY = "__iteration__"
_RNG_KEY = "__rng_key__"
_RNG_IMPL_KEY = "__rng_impl__"
_TREEDEF_PREFIX = "tree::"


def keystr(path: tuple) -> str:
    """A tree path in ``jax.tree_util.keystr``'s format: ``['key']`` for a
    dict key, ``[i]`` for a sequence index."""
    return "".join(f"[{k!r}]" for k in path)


def _paths(tree, path: tuple = ()) -> list:
    """Every leaf's path, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, path + (i,))]
    return [path]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _flatten_with_paths(tree) -> Dict[str, np.ndarray]:
    return {_TREEDEF_PREFIX + keystr(p): _host(leaf)
            for p, leaf in zip(_paths(tree), tree_leaves(tree))}


def save_checkpoint(path: str, net, iteration: Optional[int] = None) -> str:
    """Write params + updater state + iteration + key + conf. Returns the
    path. Atomic: the payload goes to a unique tmp file first (pid+uuid),
    then ``os.replace`` commits; on any failure the tmp is removed and the
    existing checkpoint is untouched."""
    from deeplearning4j_tpu_torch.scaleout.ckpt.net_state import \
        capture_net_state

    path = path if path.endswith(".npz") else path + ".npz"
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)

    tree, meta = capture_net_state(net, iteration=iteration)
    payload: Dict[str, Any] = _flatten_with_paths({"params": tree["params"]})
    if "state" in tree:
        payload.update(_flatten_with_paths({"state": tree["state"]}))
    payload[_CONF_KEY] = np.frombuffer(meta["conf"].encode(), dtype=np.uint8)
    payload[_ITER_KEY] = np.asarray(meta["iteration"], np.int64)
    if "rng" in tree:
        payload[_RNG_KEY] = np.asarray(tree["rng"])
        if meta.get("rng_impl"):
            payload[_RNG_IMPL_KEY] = np.frombuffer(
                meta["rng_impl"].encode(), dtype=np.uint8)
    extra = {k: v for k, v in meta.items()
             if k not in ("conf", "iteration", "rng_impl")}
    if extra:
        payload[_META_KEY] = np.frombuffer(
            json.dumps(extra).encode(), dtype=np.uint8)

    tmp = f"{path}.tmp-{os.getpid()}-{uuid.uuid4().hex}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_checkpoint(path: str, device: DeviceLike = None):
    """Rebuild the network on ``device`` (CUDA unless ``device="cpu"``)
    with params, updater state, key stream and iteration restored. Returns
    (net, iteration).

    Strict: raises ``KeyError`` on a missing leaf, ``ValueError`` on a
    shape mismatch, and ``TypeError`` on a lossy dtype narrowing (saved
    float64 into a float32 template, etc.) — never a silent ``astype``.
    """
    from deeplearning4j_tpu_torch.nn import functional as F
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.scaleout.ckpt.net_state import \
        restore_net_state
    from deeplearning4j_tpu_torch.scaleout.ckpt.reshard import \
        check_compatible

    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path) as z:
        conf = MultiLayerConfiguration.from_json(bytes(z[_CONF_KEY]).decode())
        net = MultiLayerNetwork(conf, device=device).init()
        iteration = int(z[_ITER_KEY])

        # rebuild templates, then fill leaves by path key — strictly
        params_template = net.params_tree
        state_template = F.init_train_state(conf, params_template)

        def fill(tree, label):
            labelled = {label: tree}
            new_leaves = []
            for p, leaf in zip(_paths(labelled), tree_leaves(labelled)):
                ks = keystr(p)
                key = _TREEDEF_PREFIX + ks
                if key not in z:
                    raise KeyError(f"checkpoint missing leaf {key}")
                saved = np.asarray(z[key])
                dtype = check_compatible(saved.shape, str(saved.dtype),
                                         leaf, ks)
                new_leaves.append(torch.from_numpy(np.ascontiguousarray(
                    saved.astype(dtype, copy=False))).to(net.device))
            return tree_unflatten(labelled, new_leaves)[label]

        tree: Dict[str, Any] = {"params": fill(params_template, "params")}
        has_state = any(k.startswith(_TREEDEF_PREFIX + "['state']")
                        for k in z.files)
        if has_state:
            tree["state"] = fill(state_template, "state")
        meta: Dict[str, Any] = {"conf": conf.to_json(),
                                "iteration": iteration}
        if _RNG_KEY in z.files:
            tree["rng"] = np.asarray(z[_RNG_KEY])
            if _RNG_IMPL_KEY in z.files:
                meta["rng_impl"] = bytes(z[_RNG_IMPL_KEY]).decode()
        if _META_KEY in z.files:
            meta.update(json.loads(bytes(z[_META_KEY]).decode()))
        restore_net_state(net, tree, meta)
    return net, iteration
