"""Device resolution and tree helpers shared by the port.

Entry points run on CUDA unless the caller asks for the CPU; without a card
they raise instead of carrying on silently on the CPU. Parameter trees are
nested dicts, tuples and lists of tensors (the JAX package's pytrees, same
keys and order)."""

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
    """Apply ``fn(path, leaf)`` over a tree of dicts, tuples and lists;
    ``path`` is the tuple of keys (and sequence indices) down to the
    leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves(tree) -> list:
    """Leaves in jax.tree_util order: dict keys sorted, sequences in
    order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves: list):
    """A tree shaped like ``tree`` holding ``leaves`` in ``tree_leaves``
    order (the inverse of ``tree_leaves``)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has places for")
    return out


def tree_zip_map(fn, tree, *rest):
    """``fn`` over the matching leaves of trees of one shape
    (``jax.tree_util.tree_map(fn, tree, *rest)``)."""
    groups = zip(tree_leaves(tree), *(tree_leaves(r) for r in rest))
    return tree_unflatten(tree, [fn(*xs) for xs in groups])


def commit(old, new, donate: bool):
    """``new`` as a step's result; with ``donate`` it is written into the
    tensors of ``old`` in place, which the step then returns."""
    if not donate:
        return new
    with torch.no_grad():
        for o, n in zip(tree_leaves(old), tree_leaves(new)):
            if o is not n:
                o.copy_(n)
    return old
