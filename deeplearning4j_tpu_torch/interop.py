"""Weight and state conversion between the JAX package's trees and the
port's.

``lm_params_from_numpy`` takes the tree of ``models/transformer_lm``'s
``init_lm_params`` (or a checkpoint of it) after conversion to numpy
(``jax.tree_util.tree_map(np.asarray, params)``) and returns the port's
tree: the same nested dict, the same keys, the same layouts ((L, ...)
stacked blocks, weights stored (in, out)), as torch tensors. The two
packages then compute the same function.

``mln_params_from_numpy`` does the same for a ``MultiLayerNetwork``'s
params (a tuple of per-layer dicts with the key set of a ported layer
type: DENSE/OUTPUT ``{"W", "b"}``, LSTM ``{"recurrentweights",
"decoderweights", "decoderbias"}``, ATTENTION ``{"ln_g", "ln_b", "wq",
"wk", "wv", "wo", "decoderweights", "decoderbias"}``; weights (n_in,
n_out)), and ``updater_state_from_numpy`` for its updater state (a tuple
of ``{"hist", "v"}`` trees over the same keys).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import DeviceLike, resolve_device, \
    tree_map

_LM_KEYS = ("embed", "blocks", "dec_w", "dec_b")
_BLOCK_KEYS = ("ln_g", "ln_b", "wq", "wk", "wv", "wo", "ln2_g", "ln2_b",
               "router", "experts")
_EXPERT_KEYS = ("w1", "b1", "w2", "b2")
# the parameter keys of each ported layer type (nn/params.py)
_LAYER_KEY_SETS = (
    ("W", "b"),
    ("recurrentweights", "decoderweights", "decoderbias"),
    ("ln_g", "ln_b", "wq", "wk", "wv", "wo", "decoderweights",
     "decoderbias"),
)
_UPDATER_KEYS = ("hist", "v")


def _check_keys(tree: dict, keys: tuple, where: str) -> None:
    if not isinstance(tree, dict) or sorted(tree) != sorted(keys):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"{where} must hold exactly {sorted(keys)}, "
                         f"got {got}")


def _to_tensor(x, device: torch.device,
               dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: widen exactly, narrow in torch
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        # a copy: device arrays converted by np.asarray are read-only
        t = torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def lm_params_from_numpy(tree: dict, device: DeviceLike = None,
                         dtype: Optional[torch.dtype] = None) -> dict:
    """The JAX package's LM params (numpy leaves: ``embed``,
    ``blocks{ln_g, ln_b, wq, wk, wv, wo, ln2_g, ln2_b, router,
    experts{w1, b1, w2, b2}}``, ``dec_w``, ``dec_b``) as the port's tree on
    ``device`` (CUDA unless ``device="cpu"``). ``dtype`` casts every float
    leaf (None keeps the stored dtype). Raises on a tree of another
    shape of keys."""
    dev = resolve_device(device)
    _check_keys(tree, _LM_KEYS, "the LM params tree")
    _check_keys(tree["blocks"], _BLOCK_KEYS, "params['blocks']")
    _check_keys(tree["blocks"]["experts"], _EXPERT_KEYS,
                "params['blocks']['experts']")
    return tree_map(lambda _, x: _to_tensor(x, dev, dtype), tree)


def opt_state_from_numpy(state: dict, device: DeviceLike = None) -> dict:
    """The JAX package's optimizer state (``{"m": tree, "v": tree,
    "count": int scalar}`` with numpy leaves) as the port's, on ``device``
    (CUDA unless ``device="cpu"``); ``count`` becomes an int32 0-dim
    tensor."""
    dev = resolve_device(device)
    _check_keys(state, ("m", "v", "count"), "the optimizer state")
    return {"m": tree_map(lambda _, x: _to_tensor(x, dev, None), state["m"]),
            "v": tree_map(lambda _, x: _to_tensor(x, dev, None), state["v"]),
            "count": torch.tensor(int(np.asarray(state["count"])),
                                  dtype=torch.int32, device=dev)}


def _check_layers(layers, what: str) -> None:
    if not isinstance(layers, (tuple, list)):
        raise ValueError(f"{what} must be a tuple of per-layer dicts, got "
                         f"{type(layers).__name__}")


def _check_layer_keys(layer, where: str) -> None:
    """``layer`` holds exactly the keys of one ported layer type."""
    if isinstance(layer, dict):
        for keys in _LAYER_KEY_SETS:
            if sorted(layer) == sorted(keys):
                return
    got = sorted(layer) if isinstance(layer, dict) else type(layer).__name__
    raise ValueError(f"{where} must hold exactly the keys of one ported "
                     f"layer type, one of "
                     f"{[sorted(k) for k in _LAYER_KEY_SETS]}, got {got}")


def mln_params_from_numpy(params, device: DeviceLike = None,
                          dtype: Optional[torch.dtype] = None) -> tuple:
    """The JAX ``MultiLayerNetwork``'s params (a tuple of per-layer dicts
    with numpy leaves, weights stored (n_in, n_out)) as the port's tuple
    of dicts of tensors, same keys and layouts, on ``device`` (CUDA unless
    ``device="cpu"``). ``dtype`` casts every leaf (None keeps the stored
    dtype). Raises on a layer whose key set is not a ported layer
    type's."""
    dev = resolve_device(device)
    _check_layers(params, "the network params")
    for i, layer in enumerate(params):
        _check_layer_keys(layer, f"params[{i}]")
    return tuple(tree_map(lambda _, x: _to_tensor(x, dev, dtype), layer)
                 for layer in params)


def updater_state_from_numpy(states, device: DeviceLike = None) -> tuple:
    """The JAX network's updater state (a tuple of ``{"hist": layer,
    "v": layer}`` with numpy leaves, ``layer`` over the keys of the
    layer's params) as the port's, on ``device`` (CUDA unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    _check_layers(states, "the updater state")
    for i, st in enumerate(states):
        _check_keys(st, _UPDATER_KEYS, f"states[{i}]")
        _check_layer_keys(st["hist"], f"states[{i}]['hist']")
        _check_keys(st["v"], tuple(st["hist"]), f"states[{i}]['v']")
    return tuple(tree_map(lambda _, x: _to_tensor(x, dev, None), st)
                 for st in states)


def tree_to_numpy(tree):
    """A tree (dicts, tuples, lists) of tensors as the same tree of numpy
    arrays (bf16 widened exactly to float32: numpy has no bfloat16 of its
    own)."""
    def one(_, x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

    return tree_map(one, tree)
