"""Counterpart of ``deeplearning4j_tpu/optimize/updater.py``: the gradient
updater (ref: optimize/GradientAdjustment.java:52-125).

Update order per variable:
  1. AdaGrad scaling (g * lr / (sqrt(Σg²) + eps)) if useAdaGrad, else
     g *= lr; the AdaGrad history is reset every resetAdaGradIterations
  2. momentum (with the momentumAfter schedule)
  3. L2 weight decay or L1
  4. optional unit-norm constraint

The JAX package's deliberate divergences from the Java reference are kept:
heavy-ball velocity (the reference's momentum line degenerates to g *= 2),
L1 decay for ``l1 > 0`` (the reference triggers on ``l1 < 0``), and no
final ÷batchSize (losses are already per-example means).

State is a tree parallel to params: ``{"hist": Σg², "v": velocity}``.
``iteration`` is a tensor on the params' device; the schedule and the
AdaGrad reset select with ``torch.where``, so an update never waits for
the card.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from deeplearning4j_tpu_torch._device import tree_leaves, tree_map, \
    tree_zip_map
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration

UpdaterState = Dict[str, Any]

_ADAGRAD_EPS = 1e-6


def init_updater_state(params) -> UpdaterState:
    return {"hist": tree_map(lambda _, p: torch.zeros_like(p), params),
            "v": tree_map(lambda _, p: torch.zeros_like(p), params)}


def _momentum_at(conf: NeuralNetConfiguration, iteration: torch.Tensor):
    """Momentum under the momentumAfter schedule: a Python float without a
    schedule, else an f32 tensor selected on the device."""
    m = conf.momentum
    for it, val in conf.momentum_after:
        m = torch.where(iteration >= it, val, m)
    return m


def apply_updater(conf: NeuralNetConfiguration, iteration: torch.Tensor,
                  grads, params, state: UpdaterState, sumsq=None
                  ) -> Tuple[Any, UpdaterState]:
    """Returns (updates, new_state); the caller applies
    ``params - updates``. ``sumsq(update) -> Σu²`` over the layer's whole
    update replaces the local sum in the unit-norm constraint where the
    layer's leaves are shards of it (``parallel.mesh.LeafShards.sumsq``,
    tensor parallelism)."""
    hist, vel = state["hist"], state["v"]

    if conf.reset_ada_grad_iterations > 0:
        reset = (iteration > 0) & (
            iteration % conf.reset_ada_grad_iterations == 0)
        hist = tree_zip_map(lambda h: torch.where(reset, 0.0, h), hist)

    if conf.use_ada_grad:
        new_hist = tree_zip_map(lambda h, g: h + g * g, hist, grads)
        scaled = tree_zip_map(
            lambda g, h2: g * conf.lr / (torch.sqrt(h2) + _ADAGRAD_EPS),
            grads, new_hist)
    else:
        new_hist = hist
        scaled = tree_zip_map(lambda g: g * conf.lr, grads)

    if conf.momentum > 0 or conf.momentum_after:
        m = _momentum_at(conf, iteration)
        new_vel = tree_zip_map(lambda v, u: m * v + u, vel, scaled)
        update = new_vel
    else:
        new_vel = vel
        update = scaled

    if conf.use_regularization and conf.l2 > 0:
        update = tree_zip_map(lambda u, p: u + p * (conf.l2 * conf.lr),
                              update, params)
    if conf.use_regularization and conf.l1 > 0:
        update = tree_zip_map(lambda u, p: u + torch.sign(p) * conf.l1,
                              update, params)

    if conf.constrain_gradient_to_unit_norm:
        norm = torch.sqrt(sum((u * u).sum() for u in tree_leaves(update))
                          if sumsq is None else sumsq(update))
        update = tree_zip_map(lambda u: u / (norm + 1e-12), update)

    return update, {"hist": new_hist, "v": new_vel}
