"""Device resolution and nested-dict helpers shared by the port.

Entry points run on CUDA unless the caller asks for the CPU; without a card
they raise instead of carrying on silently on the CPU. Parameter trees are
plain nested dicts of tensors (the JAX package's pytrees, same keys)."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means CUDA; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def tree_map(fn, tree, path: tuple = ()):
    """Apply ``fn(path, leaf)`` over a nested dict of leaves; ``path`` is
    the tuple of keys down to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in sorted-key order (jax.tree_util order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]
