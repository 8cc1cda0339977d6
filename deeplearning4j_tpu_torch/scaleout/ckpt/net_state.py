"""Counterpart of ``deeplearning4j_tpu/scaleout/ckpt/net_state.py``: a
``MultiLayerNetwork``'s full training state as a checkpointable tree.

One capture/restore pair for every net-level persistence path
(``CheckpointIterationListener``, ``Checkpointer.save_net`` /
``restore_net``): per-layer params, per-layer updater state, the host key
stream's position, the iteration counter and the conf.

The tree and meta are the JAX package's, so a checkpoint of either
package restores in the other: params and updater state under
``"params"`` and ``"state"``, the conf JSON and the iteration in meta, and
the key under ``"rng"`` as two ``uint32`` words (high, low) with no
``rng_impl``, the layout of a raw JAX key. The port's key is a 64-bit int
(``ops/rng.py``); the words carry it bit for bit. A JAX file's words are
read back into an int, typed keys' too. The streams are package-local:
the same words seed different draws in each package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import tree_map

_M32 = (1 << 32) - 1


def key_to_words(key: int) -> np.ndarray:
    """A 64-bit key as uint32[2] (high word first, the layout of
    ``jax.random.PRNGKey(seed)`` for a seed below 2**32)."""
    key = int(key) & ((1 << 64) - 1)
    return np.array([key >> 32, key & _M32], dtype=np.uint32)


def words_to_key(words) -> int:
    """uint32[2] key data (high word first) as the port's int key."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    w = np.asarray(words).astype(np.uint64).reshape(-1)
    if w.shape != (2,):
        raise ValueError(f"a net-state key is two uint32 words; got shape "
                         f"{np.asarray(words).shape}")
    return (int(w[0]) << 32) | int(w[1])


def capture_net_state(net, iteration: Optional[int] = None
                      ) -> Tuple[Dict, Dict]:
    """(state tree, meta dict) for a MultiLayerNetwork: the tree carries
    params, updater state (when initialized) and the key; meta the conf
    JSON and the iteration counter."""
    tree: Dict = {"params": net.params_tree}
    state = getattr(net, "_train_state", None)
    if state is not None:
        tree["state"] = state
    meta: Dict = {"conf": net.conf.to_json()}
    it = iteration if iteration is not None else getattr(net, "_iteration", 0)
    meta["iteration"] = int(it)
    keys = getattr(net, "_keys", None)
    if keys is not None:
        tree["rng"] = key_to_words(keys._key)
    return tree, meta


def net_state_template(net) -> Dict:
    """The template tree a restore of a net checkpoint needs: the
    structure ``capture_net_state`` produces for this net."""
    tree, _meta = capture_net_state(net)
    return tree


def restore_net_state(net, tree: Dict, meta: Dict):
    """Install a captured state tree into ``net`` (in place; returns
    net)."""
    net._params = tuple(tree["params"])
    if "state" in tree:
        net._train_state = tuple(tree["state"])
    net._iteration = int(meta.get("iteration", 0))
    if "rng" in tree and getattr(net, "_keys", None) is not None:
        net._keys._key = words_to_key(tree["rng"])
    return net


def rebuild_net(tree: Dict, meta: Dict, device=None):
    """A fresh MultiLayerNetwork from a captured checkpoint (conf JSON in
    meta), on ``device`` (CUDA unless ``device="cpu"``): the resume path
    when no live net exists."""
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = MultiLayerConfiguration.from_json(meta["conf"])
    net = MultiLayerNetwork(conf, device=device).init()
    if "state" in tree:
        net._ensure_train_step()
    tree = {k: (tree_map(lambda _, a: torch.as_tensor(a).to(net.device), v)
                if k in ("params", "state") else v)
            for k, v in tree.items()}
    return restore_net_state(net, tree, meta)
