"""Counterpart of ``deeplearning4j_tpu/optimize/updaters.py``, the
replicated half: Adam, LAMB, AdaGrad, momentum and SGD as update transforms
on nested dicts of tensors behind the train step's ``optimizer=`` seam.

The state is ``{"m": tree, "v": tree, "count": int32 0-dim tensor}``, the
moments shaped like the params. Scalar constants are rounded to f32 before
use (``np.float32``), as the JAX code's ``jnp.float32`` constants are, so
the two packages compute the same update. A guarded step selects params
AND the whole state against the incoming trees on a non-finite step.

The ZeRO-style sharded update (``ZeroSharding``, the functions' ``zero=``
argument, ``opt_update_shardmap``) comes with the data-parallel slice;
``update_sharding="sharded"`` resolves here but has no single-device step
to run on.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import tree_leaves, tree_unflatten

UPDATE_SHARDING_ENV = "DL4J_TPU_UPDATE_SHARDING"
_MODES = ("replicated", "sharded")

_NAMES = ("sgd", "adam", "lamb", "adagrad", "momentum")
# the legacy GradientAdjustment lineage (updater.py) uses 1e-6
_ADAGRAD_EPS = 1e-6


def resolve_update_sharding(explicit: Optional[str] = None) -> str:
    """``explicit`` > ``DL4J_TPU_UPDATE_SHARDING`` env > ``"replicated"``,
    resolved once at step-build time."""
    for source, val in (("update_sharding=", explicit),
                        (UPDATE_SHARDING_ENV,
                         os.environ.get(UPDATE_SHARDING_ENV))):
        if val:
            if val not in _MODES:
                raise ValueError(
                    f"{source} must be one of {_MODES}, got {val!r}")
            return val
    return "replicated"


@dataclass(frozen=True)
class OptimizerConfig:
    """Optimizer policy for one train step.

    ``name``: ``adam`` | ``lamb`` | ``adagrad`` | ``momentum`` | ``sgd``.
    ``lr=None`` inherits the train step's ``lr``. ``weight_decay`` is
    decoupled (AdamW-style; inside the LAMB trust-ratio numerator).
    ``update_sharding=None`` resolves through the env chain.
    """

    name: str = "adam"
    lr: Optional[float] = None
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9
    update_sharding: Optional[str] = None

    def __post_init__(self):
        if self.name not in _NAMES:
            raise ValueError(
                f"optimizer name must be one of {_NAMES}, got {self.name!r}")

    @classmethod
    def coerce(cls, optimizer) -> Optional["OptimizerConfig"]:
        """None/False → no optimizer (the step keeps its plain-SGD shape),
        a name string → that optimizer's defaults, an OptimizerConfig →
        itself."""
        if optimizer is None or optimizer is False:
            return None
        if isinstance(optimizer, cls):
            return optimizer
        if isinstance(optimizer, str):
            if optimizer == "adagrad":
                return cls(name="adagrad", eps=_ADAGRAD_EPS)
            return cls(name=optimizer)
        raise TypeError(
            "optimizer= must be None/False, a name string "
            f"({'|'.join(_NAMES)}), or an OptimizerConfig; got "
            f"{type(optimizer).__name__}")

    def resolved(self) -> "OptimizerConfig":
        """The config with ``update_sharding`` pinned through the env
        chain."""
        return replace(self,
                       update_sharding=resolve_update_sharding(
                           self.update_sharding))

    @property
    def sharded(self) -> bool:
        return resolve_update_sharding(self.update_sharding) == "sharded"


def _f32(x) -> float:
    """``x`` rounded to f32, as a Python float torch takes exactly."""
    return float(np.float32(x))


def _sumsq(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x))


def _leaf_update(cfg: OptimizerConfig, p, g, m, v, t, lr: float):
    """One leaf's update: ``(update, new_m, new_v, trust)`` where
    ``update`` is what to SUBTRACT from the param (lr, bias correction,
    weight decay and, for LAMB, the trust ratio applied) and ``trust`` is
    LAMB's per-leaf trust ratio (None for the other names)."""
    lr_eff = np.float32(cfg.lr if cfg.lr is not None else lr)
    wd = np.float32(cfg.weight_decay)
    if cfg.name in ("adam", "lamb"):
        b1, b2 = np.float32(cfg.b1), np.float32(cfg.b2)
        new_m = float(b1) * m + float(np.float32(1.0) - b1) * g
        new_v = float(b2) * v + float(np.float32(1.0) - b2) * torch.square(g)
        tf = t.to(torch.float32)
        mhat = new_m / (1.0 - torch.pow(float(b1), tf))
        vhat = new_v / (1.0 - torch.pow(float(b2), tf))
        r = mhat / (torch.sqrt(vhat) + _f32(cfg.eps))
        if wd:
            r = r + float(wd) * p
        if cfg.name == "lamb":
            pn = torch.sqrt(_sumsq(p))
            rn = torch.sqrt(_sumsq(r))
            trust = torch.where((pn > 0.0) & (rn > 0.0), pn / rn,
                                torch.ones_like(pn))
            return float(lr_eff) * trust * r, new_m, new_v, trust
        return float(lr_eff) * r, new_m, new_v, None
    if cfg.name == "adagrad":
        new_v = v + torch.square(g)
        upd = float(lr_eff) * g / (torch.sqrt(new_v) + _f32(cfg.eps))
        if wd:
            upd = upd + float(lr_eff * wd) * p
        return upd, m, new_v, None
    if cfg.name == "momentum":
        # the legacy heavy-ball order: lr scales the gradient BEFORE it
        # enters the velocity
        new_m = _f32(cfg.momentum) * m + float(lr_eff) * g
        upd = new_m
        if wd:
            upd = upd + float(lr_eff * wd) * p
        return upd, new_m, v, None
    # sgd through the seam: stateless, for like-for-like comparisons
    upd = float(lr_eff) * g
    if wd:
        upd = upd + float(lr_eff * wd) * p
    return upd, m, v, None


def opt_update(cfg: OptimizerConfig, params, grads, opt_state, lr: float,
               with_metrics: bool = False):
    """The optimizer transform: ``(new_params, new_opt_state[,
    opt_metrics])``. ``opt_state`` is ``{"m", "v", "count"}`` from
    :func:`init_opt_state`. ``with_metrics`` appends the optimizer-health
    block: moment global norms, the true ‖Δp‖/‖p‖ update ratio and, for
    LAMB, the mean trust ratio."""
    t = opt_state["count"] + 1
    new_p, new_m, new_v, trusts = [], [], [], []
    upd_sq = p_sq = m_sq = v_sq = 0.0
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"])):
        upd, m2, v2, trust = _leaf_update(cfg, p, g, m, v, t, lr)
        new_p.append(p - upd)
        new_m.append(m2)
        new_v.append(v2)
        if with_metrics:
            upd_sq = upd_sq + _sumsq(upd.float())
            p_sq = p_sq + _sumsq(p.float())
            m_sq = m_sq + _sumsq(m2.float())
            v_sq = v_sq + _sumsq(v2.float())
            if trust is not None:
                trusts.append(trust)
    new_params = tree_unflatten(params, new_p)
    new_state = {"m": tree_unflatten(params, new_m),
                 "v": tree_unflatten(params, new_v), "count": t}
    if not with_metrics:
        return new_params, new_state
    metrics = {
        "moment_norm_m": torch.sqrt(m_sq),
        "moment_norm_v": torch.sqrt(v_sq),
        "update_ratio": torch.sqrt(upd_sq) / (torch.sqrt(p_sq) + 1e-12),
    }
    if trusts:
        metrics["lamb_trust_ratio"] = torch.mean(torch.stack(trusts))
    return new_params, new_state, metrics


def guarded_opt_update(params, grads, opt_state, loss, lr: float,
                       cfg: OptimizerConfig, guard,
                       with_metrics: bool = False):
    """The optimizer update with the guardrails: finiteness of loss and
    grad global-norm, optional global-norm clip, and the skip-on-nonfinite
    select over params AND the whole optimizer state (moments and step
    count). Returns ``(new_params, new_opt_state, metrics)``: the guard
    block, plus the optimizer block when ``with_metrics``."""
    from deeplearning4j_tpu_torch.optimize.guardrails import (
        clip_by_global_norm,
        guard_select,
        guard_stats,
    )

    gn, finite = guard_stats(loss, grads)
    clipped = torch.zeros((), dtype=torch.float32, device=gn.device)
    if guard.clip_norm is not None:
        grads, was_clipped = clip_by_global_norm(grads, gn, guard.clip_norm)
        clipped = (was_clipped & finite).to(torch.float32)
    out = opt_update(cfg, params, grads, opt_state, lr,
                     with_metrics=with_metrics)
    new_params, new_state = out[0], out[1]
    opt_metrics = out[2] if with_metrics else {}
    if guard.skip_nonfinite:
        new_params = guard_select(finite, new_params, params)
        new_state = guard_select(finite, new_state, opt_state)
    metrics = {
        **opt_metrics,
        "nonfinite": (~finite).to(torch.float32),
        "clipped": clipped,
        "guard_grad_norm": gn,
    }
    return new_params, new_state, metrics


def init_opt_state(cfg: Optional[OptimizerConfig], params):
    """``{"m", "v", "count"}`` with zero moments shaped, typed and placed
    like their params and an int32 step count on the params' device.
    Stateless names still get zero moments, so the step signature and the
    guard select are shape-uniform."""
    if cfg is None:
        raise ValueError("init_opt_state needs an OptimizerConfig "
                         "(use OptimizerConfig.coerce first)")
    leaves = tree_leaves(params)
    m = tree_unflatten(params, [torch.zeros_like(x) for x in leaves])
    v = tree_unflatten(params, [torch.zeros_like(x) for x in leaves])
    count = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
    return {"m": m, "v": v, "count": count}
