"""Counterpart of ``deeplearning4j_tpu/optimize/guardrails.py``, the in-step
half: the guard policy, finiteness of loss and grads, global-norm clipping
and the skip-on-nonfinite select.

A guarded step selects the updated params against the incoming ones with
``torch.where(finite, new, old)``, so a batch with a NaN/Inf loss or
gradient costs one step of progress and never the model. The select passes
the chosen operand through bitwise, and below the clip threshold the clip
scale is exactly 1.0: on a clean batch the guarded step computes the same
params as the unguarded one. Every flag stays a device tensor; nothing here
synchronises with the host.

The host watchdog, replay bundles and rollback come with a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch._device import tree_zip_map
from deeplearning4j_tpu_torch.telemetry.metrics import global_norm

_TINY = 1e-30  # clip-scale denominator floor (exact-1.0 scale stays exact)


@dataclass(frozen=True)
class GuardConfig:
    """Guard policy for one train step.

    ``skip_nonfinite``: carry params unchanged through a step whose loss or
    grad global-norm is NaN/Inf. ``clip_norm``: global-norm clip threshold
    applied to the grads before the update (None = no clipping).
    """

    skip_nonfinite: bool = True
    clip_norm: Optional[float] = None

    @classmethod
    def coerce(cls, guard) -> Optional["GuardConfig"]:
        """Normalize the seam argument: None/False → no guard, True → the
        default policy, a GuardConfig → itself."""
        if guard is None or guard is False:
            return None
        if guard is True:
            return cls()
        if isinstance(guard, cls):
            return guard
        raise TypeError(
            f"guard= must be None/False, True, or a GuardConfig; got "
            f"{type(guard).__name__}")


def guard_stats(loss: torch.Tensor, grads, shards=None) -> Tuple:
    """(grad global-norm, finite?): a single NaN/Inf anywhere in the grad
    tree poisons the norm, so one scalar test covers every leaf.
    ``shards`` as in ``telemetry.metrics.global_norm``."""
    gn = global_norm(grads, shards)
    finite = torch.isfinite(loss.float()) & torch.isfinite(gn)
    return gn, finite


def clip_by_global_norm(grads, grad_norm: torch.Tensor,
                        clip_norm: float) -> Tuple:
    """Scale ``grads`` so their global norm is at most ``clip_norm``.
    Returns ``(grads, clipped?)``. Below the threshold the scale is exactly
    1.0."""
    scale = torch.clamp(clip_norm / torch.clamp_min(grad_norm, _TINY),
                        max=1.0)
    clipped = scale < 1.0
    return tree_zip_map(lambda g: g * scale.to(g.dtype), grads), clipped


def guard_select(finite: torch.Tensor, new_tree, old_tree):
    """Per-leaf ``where(finite, new, old)``: the skip-on-nonfinite select.
    The chosen operand passes through bitwise."""
    return tree_zip_map(lambda n, o: torch.where(finite, n, o), new_tree,
                        old_tree)


def guarded_sgd_update(params, grads, loss: torch.Tensor, lr: float,
                       cfg: GuardConfig, shards=None) -> Tuple:
    """The guarded SGD update: ``(new_params, guard_metrics)``.

    Clean batch → ``params - lr * grads``, the same as the unguarded
    update. Non-finite loss or grads → params carried unchanged,
    ``nonfinite`` set. The metrics are f32 device scalars (``nonfinite``,
    ``clipped``, ``guard_grad_norm``). ``shards`` as in
    ``guard_stats``."""
    gn, finite = guard_stats(loss, grads, shards)
    clipped = torch.zeros((), dtype=torch.float32, device=gn.device)
    if cfg.clip_norm is not None:
        grads, was_clipped = clip_by_global_norm(grads, gn, cfg.clip_norm)
        clipped = (was_clipped & finite).to(torch.float32)
    new_params = tree_zip_map(lambda p, g: p - lr * g, params, grads)
    if cfg.skip_nonfinite:
        new_params = guard_select(finite, new_params, params)
    metrics = {
        "nonfinite": (~finite).to(torch.float32),
        "clipped": clipped,
        "guard_grad_norm": gn,
    }
    return new_params, metrics
