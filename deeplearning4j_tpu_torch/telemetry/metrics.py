"""Counterpart of ``deeplearning4j_tpu/telemetry/metrics.py``: in-step
metric computation on nested dicts of tensors.

A metrics dict is a flat dict of f32 0-dim tensors (plus the (E,)
router-load vector) computed from what the train step already has: params,
grads, loss. The functions only READ those tensors, so a metrics-threaded
step computes the same loss and params as its plain twin. The values stay
on the device; the caller fetches them when it wants them.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch._device import tree_leaves

_EPS = 1e-12


def global_norm(tree, shards=None) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf of a nested dict (f32
    accumulate). ``shards`` (``parallel.mesh.LeafShards``) names the mesh
    axes a leaf is split over: its squares then sum over those ranks, so
    the norm is the global tree's, as under GSPMD."""
    if shards is not None:
        return torch.sqrt(shards.sumsq(tree))
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.tensor(0.0)
    total = sum(torch.sum(torch.square(leaf.float())) for leaf in leaves)
    return torch.sqrt(total)


def train_step_metrics(params, grads, lr: float, loss=None,
                       shards=None) -> dict:
    """The standard step-health block: grad global-norm, param global-norm,
    and the update/param ratio (||lr·g|| / ||p|| for SGD); ``shards`` as
    in ``global_norm``."""
    gn = global_norm(grads, shards)
    pn = global_norm(params, shards)
    out = {
        "grad_norm": gn,
        "param_norm": pn,
        "update_ratio": (lr * gn) / (pn + _EPS),
    }
    if loss is not None:
        out["loss"] = loss.detach().to(torch.float32)
    return out


def update_metrics(params, updates, scale=1.0) -> dict:
    """Update/param ratio from an explicit update tree (updates that are not
    lr·g: momentum, adagrad)."""
    un = global_norm(updates) * scale
    pn = global_norm(params)
    return {"param_norm": pn, "update_ratio": un / (pn + _EPS)}
