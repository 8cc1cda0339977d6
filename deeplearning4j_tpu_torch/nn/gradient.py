"""Counterpart of ``deeplearning4j_tpu/nn/gradient.py``: the flat
parameter vector (ref: MultiLayerNetwork.java:744-835 pack/unPack).

A gradient is a tree like the params tree (a tuple of per-layer
``{"W", "b"}`` dicts). The flat order is JAX's pytree order: layers in
order, dict keys sorted (``W`` before ``b``), each leaf row-major, so a
vector written by either package loads in the other.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from deeplearning4j_tpu_torch._device import tree_leaves, tree_unflatten

# params for one layer: {"W": ..., "b": ...}; for a network: tuple of those
LayerParams = Dict[str, torch.Tensor]
NetParams = Tuple[LayerParams, ...]


def flatten_params(params) -> torch.Tensor:
    """Pack a params tree into one flat vector (ref: params()/pack)."""
    leaves = tree_leaves(params)
    if not leaves:
        return torch.zeros((0,))
    return torch.cat([leaf.reshape(-1) for leaf in leaves])


def unflatten_params(template, flat: torch.Tensor):
    """Unpack a flat vector into the shape of ``template``, on its leaves'
    devices and dtypes (ref: setParams/unPack)."""
    leaves = tree_leaves(template)
    expected = sum(leaf.numel() for leaf in leaves)
    if flat.dim() != 1 or flat.shape[0] != expected:
        raise ValueError(
            f"Parameter vector of shape {tuple(flat.shape)} does not match "
            f"the network's {expected} parameters"
        )
    out: List[torch.Tensor] = []
    offset = 0
    for leaf in leaves:
        n = leaf.numel()
        # a copy: the new leaves must not alias the caller's vector
        out.append(flat[offset:offset + n].reshape(leaf.shape).to(
            device=leaf.device, dtype=leaf.dtype, copy=True))
        offset += n
    return tree_unflatten(template, out)


def num_params(params) -> int:
    return sum(leaf.numel() for leaf in tree_leaves(params))
