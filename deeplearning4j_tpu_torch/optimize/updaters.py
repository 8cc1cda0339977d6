"""Counterpart of ``deeplearning4j_tpu/optimize/updaters.py``: Adam, LAMB,
AdaGrad, momentum and SGD as update transforms on nested dicts of tensors
behind the train step's ``optimizer=`` seam, and the ZeRO-style update
sharded over the data-parallel ranks.

The state is ``{"m": tree, "v": tree, "count": int32 0-dim tensor}``, the
moments shaped like the params. Scalar constants are rounded to f32 before
use (``np.float32``), as the JAX code's ``jnp.float32`` constants are, so
the two packages compute the same update. A guarded step selects params
AND the whole state against the incoming trees on a non-finite step.

ZeRO mode (``update_sharding="sharded"``, arXiv:2004.13336) runs in the
data-parallel trainer (parallel/trainer.py): each rank stores and updates
only its ``1/dp`` chunk of every moment leaf and the updated params are
all-gathered. A leaf of shape ``S`` lives in the JAX package's layout
``(dp, ceil(prod(S) / dp))`` (flattened and zero-padded); each rank holds
its row of it, ``(1, chunk)``. ``canonical_opt_state`` gathers the param-shaped
layout for a checkpoint, ``partition_opt_state`` takes a rank's rows back
out of it, so an optimizer checkpoint of either package restores in the
other. Single-device steps reject ``"sharded"``: they have no dp axis.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import DeviceLike, keystr, \
    resolve_device, tree_leaves, tree_map, tree_paths, tree_unflatten

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


# ------------------------------------------------------------ ZeRO layout ----

class ZeroSharding:
    """Where the dp-sharded update lives: the mesh (parallel/mesh.py), its
    dp axis, and a per-leaf ``prefix_fn(keystr) -> tuple`` naming the
    mesh axes of the KEPT leading dims (``(None, "expert")`` for the
    flagship's (L, E, ...) expert leaves, ``("pipe",)`` for stage-stacked
    leaves), as in the JAX package. The trailing dims of a leaf are
    flattened, padded to a dp multiple and split over ``axis``; this rank
    holds row ``index``: ``lead + (1, chunk)`` of the ``lead + (n, chunk)``
    layout, ``lead`` its own (already sharded) leading dims."""

    def __init__(self, mesh, axis: str = "data", prefix_fn=None):
        if axis not in mesh.axis_names:
            raise ValueError(
                f"update-sharding axis {axis!r} is not on the mesh "
                f"{mesh.axis_names} — ZeRO mode needs the dp axis")
        self.mesh = mesh
        self.axis = axis
        self.n = int(mesh.shape[axis])
        self.index = int(mesh.coords[axis])
        self.prefix_fn = prefix_fn or (lambda _ks: ())

    def keep(self, path: tuple) -> int:
        """How many leading dims of the leaf at ``path`` are kept."""
        return len(tuple(self.prefix_fn(keystr(path))))

    def layout(self, shape: Tuple[int, ...], keep: int = 0):
        """(chunk, pad) for one leaf of ``shape`` whose first ``keep`` dims
        are kept."""
        if keep >= len(shape) and not (keep == 0 and shape == ()):
            raise ValueError(
                f"ZeRO prefix keeps every dim of a {tuple(shape)} leaf — "
                f"nothing left to shard over {self.axis!r}")
        size = int(np.prod(shape[keep:], dtype=np.int64))
        chunk = -(-size // self.n)
        return chunk, self.n * chunk - size


def _partition(x, n: int, chunk: int, pad: int, keep: int = 0):
    """param-shaped → ``lead + (n, chunk)`` (flatten the dims after the
    first ``keep``, pad with zeros to an ``n`` multiple, fold the shard
    axis out). Host numpy and tensors alike."""
    lead = tuple(x.shape[:keep])
    flat = x.reshape(lead + (-1,))
    if pad:
        if isinstance(x, np.ndarray):
            flat = np.pad(flat, [(0, 0)] * keep + [(0, pad)])
        else:
            flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(lead + (n, chunk))


def _unpartition(y, shape: Tuple[int, ...], keep: int = 0):
    """Inverse of ``_partition`` (drops the zero padding)."""
    lead = tuple(y.shape[:keep])
    size = int(np.prod(shape[keep:], dtype=np.int64))
    return y.reshape(lead + (-1,))[..., :size].reshape(shape)


def _gather_rows(zero: ZeroSharding, row, keep: int):
    """``lead + (1, chunk)`` rows of every rank of the dp axis →
    ``lead + (n, chunk)``."""
    got = zero.mesh.all_gather(row.movedim(keep, 0), zero.axis)
    return got.movedim(0, keep)


def _f32(x) -> float:
    """``x`` rounded to f32, as a Python float torch takes exactly."""
    return float(np.float32(x))


def _sumsq(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x))


def _leaf_update(cfg: OptimizerConfig, p, g, m, v, t, lr: float,
                 sumsq=_sumsq):
    """One leaf's update: ``(update, new_m, new_v, trust)`` where
    ``update`` is what to SUBTRACT from the param (lr, bias correction,
    weight decay and, for LAMB, the trust ratio applied) and ``trust`` is
    LAMB's per-leaf trust ratio (None for the other names). LAMB's norms
    go through ``sumsq(x) -> Σx²``, so a sharded caller sums over the
    ranks."""
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
            pn = torch.sqrt(sumsq(p))
            rn = torch.sqrt(sumsq(r))
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


def _leaf_axes(params, shards) -> list:
    """Each leaf's split axes (``LeafShards``), () for every leaf without
    shards."""
    if shards is None:
        return [()] * len(tree_leaves(params))
    return shards.leaf_axes(params)


def _sumsq_over(shards, axes: tuple):
    """LAMB's per-leaf ``sumsq``: local, or summed over ``axes``."""
    if shards is None or not axes:
        return _sumsq
    return lambda x: shards.mesh.all_reduce(_sumsq(x), axes)


def _sum_parts(shards, parts):
    """Σ of ``(axes, partial)`` pairs over the ranks holding each part."""
    if shards is None:
        return sum(x for _, x in parts)
    return shards.reduce(parts)


def opt_update(cfg: OptimizerConfig, params, grads, opt_state, lr: float,
               with_metrics: bool = False, shards=None):
    """The optimizer transform: ``(new_params, new_opt_state[,
    opt_metrics])``. ``opt_state`` is ``{"m", "v", "count"}`` from
    :func:`init_opt_state`. ``with_metrics`` appends the optimizer-health
    block: moment global norms, the true ‖Δp‖/‖p‖ update ratio and, for
    LAMB, the mean trust ratio. ``shards`` (``parallel.mesh.LeafShards``)
    names the axes a leaf is split over: its norms then sum over those
    ranks (LAMB's per leaf, the metrics' over the tree)."""
    t = opt_state["count"] + 1
    new_p, new_m, new_v, trusts = [], [], [], []
    sq = {"upd": [], "p": [], "m": [], "v": []}
    for axes, p, g, m, v in zip(_leaf_axes(params, shards),
                                tree_leaves(params), tree_leaves(grads),
                                tree_leaves(opt_state["m"]),
                                tree_leaves(opt_state["v"])):
        upd, m2, v2, trust = _leaf_update(cfg, p, g, m, v, t, lr,
                                          _sumsq_over(shards, axes))
        new_p.append(p - upd)
        new_m.append(m2)
        new_v.append(v2)
        if with_metrics:
            for k, x in (("upd", upd), ("p", p), ("m", m2), ("v", v2)):
                sq[k].append((axes, _sumsq(x.float())))
            if trust is not None:
                trusts.append(trust)
    new_params = tree_unflatten(params, new_p)
    new_state = {"m": tree_unflatten(params, new_m),
                 "v": tree_unflatten(params, new_v), "count": t}
    if not with_metrics:
        return new_params, new_state
    upd_sq, p_sq, m_sq, v_sq = (_sum_parts(shards, sq[k])
                                for k in ("upd", "p", "m", "v"))
    metrics = {
        "moment_norm_m": torch.sqrt(m_sq),
        "moment_norm_v": torch.sqrt(v_sq),
        "update_ratio": torch.sqrt(upd_sq) / (torch.sqrt(p_sq) + 1e-12),
    }
    if trusts:
        metrics["lamb_trust_ratio"] = torch.mean(torch.stack(trusts))
    return new_params, new_state, metrics


def opt_update_shardmap(cfg: OptimizerConfig, params, grads, opt_state,
                        lr: float, zero: Optional[ZeroSharding],
                        with_metrics: bool = False, shards=None):
    """The update inside the data-parallel step, where collectives are
    explicit; ``zero`` (None in replicated mode) takes the place of the
    JAX package's axis name and decides each leaf's chunk and padding.
    Replicated mode is :func:`opt_update`. Sharded mode takes this rank's
    row of each (all-reduced) grad and param, updates it against the
    rank's ``(1, chunk)`` moment rows, and all-gathers only the params —
    every leaf's row in one buffer, one ``all_gather`` a step. LAMB's
    norms sum over the ranks (an all-reduce per norm), and the metrics
    block's sums make one more (one per set of axes with ``shards``:
    a ZeRO row is split over the dp axis and its leaf's own axes).
    Kept leading dims (``zero.prefix_fn``) stay in each row."""
    if not cfg.sharded:
        return opt_update(cfg, params, grads, opt_state, lr,
                          with_metrics=with_metrics, shards=shards)
    t = opt_state["count"] + 1
    mesh, n, my = zero.mesh, zero.n, zero.index
    paths = tree_paths(params)

    shapes, rows, new_m, new_v, trusts = [], [], [], [], []
    sq = {"upd": [], "p": [], "m": [], "v": []}
    for path, axes, p, g, m, v in zip(paths, _leaf_axes(params, shards),
                                      tree_leaves(params), tree_leaves(grads),
                                      tree_leaves(opt_state["m"]),
                                      tree_leaves(opt_state["v"])):
        shape = tuple(p.shape)
        keep = zero.keep(path)
        chunk, pad = zero.layout(shape, keep)
        p_row = _partition(p, n, chunk, pad, keep)[..., my:my + 1, :]
        g_row = _partition(g, n, chunk, pad, keep)[..., my:my + 1, :]
        row_axes = axes + (zero.axis,)   # a row splits over dp too
        upd, m2, v2, trust = _leaf_update(
            cfg, p_row, g_row, m, v, t, lr,
            lambda x, a=row_axes: mesh.all_reduce(_sumsq(x), a))
        shapes.append((shape, keep, chunk))
        rows.append((p_row - upd).reshape(1, -1))
        new_m.append(m2)
        new_v.append(v2)
        if with_metrics:
            sq["p"].append((axes, _sumsq(p.float())))
            for k, x in (("upd", upd), ("m", m2), ("v", v2)):
                sq[k].append((row_axes, _sumsq(x.float())))
            if trust is not None:
                trusts.append(trust)
    gathered = mesh.all_gather(torch.cat(rows, dim=1), zero.axis)
    new_p, col = [], 0
    for shape, keep, chunk in shapes:
        lead = shape[:keep]
        width = int(np.prod(lead, dtype=np.int64)) * chunk
        block = gathered[:, col:col + width].reshape((n,) + lead + (chunk,))
        new_p.append(_unpartition(block.movedim(0, keep), shape, keep))
        col += width
    new_params = tree_unflatten(params, new_p)
    new_state = {"m": tree_unflatten(params, new_m),
                 "v": tree_unflatten(params, new_v), "count": t}
    if not with_metrics:
        return new_params, new_state
    p_sq = _sum_parts(shards, sq["p"])
    if shards is None:
        upd_sq, m_sq, v_sq = mesh.all_reduce(torch.stack(
            [sum(x for _, x in sq[k]) for k in ("upd", "m", "v")]),
            zero.axis)
    else:
        upd_sq, m_sq, v_sq = (shards.reduce(sq[k])
                              for k in ("upd", "m", "v"))
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
                       with_metrics: bool = False,
                       zero: Optional[ZeroSharding] = None, shards=None):
    """The optimizer update with the guardrails: finiteness of loss and
    grad global-norm, optional global-norm clip, and the skip-on-nonfinite
    select over params AND the whole optimizer state (moments and step
    count). ``zero`` runs the ZeRO update of :func:`opt_update_shardmap`
    (None: the replicated one). Returns ``(new_params, new_opt_state,
    metrics)``: the guard block, plus the optimizer block when
    ``with_metrics``. ``shards`` as in :func:`opt_update`."""
    from deeplearning4j_tpu_torch.optimize.guardrails import (
        clip_by_global_norm,
        guard_select,
        guard_stats,
    )

    gn, finite = guard_stats(loss, grads, shards)
    clipped = torch.zeros((), dtype=torch.float32, device=gn.device)
    if guard.clip_norm is not None:
        grads, was_clipped = clip_by_global_norm(grads, gn, guard.clip_norm)
        clipped = (was_clipped & finite).to(torch.float32)
    out = opt_update_shardmap(cfg, params, grads, opt_state, lr, zero,
                              with_metrics=with_metrics, shards=shards)
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


def init_opt_state(cfg: Optional[OptimizerConfig], params,
                   zero: Optional[ZeroSharding] = None):
    """``{"m", "v", "count"}`` with zero moments shaped, typed and placed
    like their params (replicated mode) or as this rank's ``(1, chunk)``
    rows of the ZeRO layout (sharded mode), and an int32 step
    count on the params' device. Stateless names still get zero moments,
    so the step signature and the guard select are shape-uniform."""
    if cfg is None:
        raise ValueError("init_opt_state needs an OptimizerConfig "
                         "(use OptimizerConfig.coerce first)")
    leaves = tree_leaves(params)
    count = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
    if zero is None:
        m = tree_unflatten(params, [torch.zeros_like(x) for x in leaves])
        v = tree_unflatten(params, [torch.zeros_like(x) for x in leaves])
        return {"m": m, "v": v, "count": count}

    def one(path, leaf):
        keep = zero.keep(path)
        chunk, _pad = zero.layout(tuple(leaf.shape), keep)
        return leaf.new_zeros(tuple(leaf.shape[:keep]) + (1, chunk))

    return {"m": tree_map(one, params), "v": tree_map(one, params),
            "count": count}


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def canonical_opt_state(opt_state, params_like,
                        zero: Optional[ZeroSharding] = None):
    """The checkpoint boundary: the moments in the PARAM-SHAPED canonical
    layout as host numpy trees, mesh-independent, equal to the JAX
    package's. In sharded mode every rank's rows are all-gathered, so
    every rank must call it; replicated states pass through as host
    arrays."""
    if zero is None:
        return {"m": tree_map(lambda _, x: _host(x), opt_state["m"]),
                "v": tree_map(lambda _, x: _host(x), opt_state["v"]),
                "count": _host(opt_state["count"])}

    def gather(path, leaf):
        shape = tuple(leaf_of(params_like, path).shape)
        keep = zero.keep(path)
        return _unpartition(_host(_gather_rows(zero, leaf, keep)), shape,
                            keep)

    return {"m": tree_map(gather, opt_state["m"]),
            "v": tree_map(gather, opt_state["v"]),
            "count": _host(opt_state["count"])}


def leaf_of(tree, path):
    """Follow a key path (dict keys and sequence indices, as
    ``_device.tree_map`` gives them) into ``tree``."""
    node = tree
    for k in path:
        node = node[k]
    return node


def partition_opt_state(canonical, zero: ZeroSharding,
                        device: DeviceLike = None):
    """Inverse of :func:`canonical_opt_state`: this rank's rows of the
    ZeRO layout, from a param-shaped canonical state (numpy or tensors),
    on the mesh's device (``device`` when the mesh has none: CUDA unless
    ``device="cpu"``)."""
    dev = zero.mesh.device or resolve_device(device)

    def one(path, leaf):
        arr = _host(leaf)
        keep = zero.keep(path)
        chunk, pad = zero.layout(tuple(arr.shape), keep)
        row = _partition(arr, zero.n, chunk, pad, keep)[
            ..., zero.index:zero.index + 1, :]
        return torch.from_numpy(np.ascontiguousarray(row)).to(dev)

    count = int(_host(canonical["count"]))
    return {"m": tree_map(one, canonical["m"]),
            "v": tree_map(one, canonical["v"]),
            "count": torch.tensor(count, dtype=torch.int32, device=dev)}


def opt_state_shardings(param_shardings):
    """Restore-time shardings for a CANONICAL optimizer state: the moment
    trees reshard exactly like their params; the step count stays
    unsharded."""
    return {"m": param_shardings, "v": param_shardings, "count": None}
