"""Counterpart of ``deeplearning4j_tpu/parallel/trainer.py``: data-parallel
training of a ``MultiLayerNetwork`` with parameter averaging, over the
ranks of a ``torch.distributed`` process group.

Parity with the reference's two ParameterAveraging modes
(ref: spark/impl/multilayer/SparkDl4jMultiLayer.java:157-203):

- ``average_each_iteration=True`` — gradients are summed across the ranks
  every step: synchronous DP-SGD with ONE fused all-reduce a step (flat
  grads, the weighted loss sum and the weight sum in one buffer).

- ``average_each_iteration=False`` (reference default, :157-176) — each
  rank runs ``local_iterations`` steps on its own shard with no
  cross-rank traffic, then params, updater state and the last score are
  averaged, weighted by each shard's real rows, in one all-reduce.

Every rank runs the same loop over the same global batches and takes its
own shard: contiguous row blocks in the order of the ranks' "data"
coordinates, as the JAX package's ``P("data")`` splits a batch over its
mesh. On a mesh with other axes too (``mesh_2d``'s "model") the ranks
that differ only there take the same rows and hold identical replicas:
every sum runs over "data" alone, as JAX's ``psum(..., "data")``. Every rank gets the same key
for a step, as JAX's replicated key does, and draws dropout masks from it
over its local shape. A batch that does not divide the ranks is padded by
repeating its last row with weight 0, so it never enters the loss or the
gradient.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import tree_leaves, tree_map, \
    tree_unflatten, tree_zip_map
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator
from deeplearning4j_tpu_torch.nn import functional as F
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops.losses import LossFunction, finalize_loss
from deeplearning4j_tpu_torch.ops.rng import fold_in, split
from deeplearning4j_tpu_torch.optimize.updater import apply_updater
from deeplearning4j_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from deeplearning4j_tpu_torch.parallel.mesh import \
    flat_all_reduce as _flat_all_reduce

def _local_grad_step(conf, params, states, iteration, x, y, w, key,
                     sync_grads: bool, mesh: Mesh,
                     ablate_collectives: bool = False,
                     with_metrics: bool = False, guard=None,
                     optimizer=None, zero=None):
    """One update step over this rank's weighted batch shard.

    ``w`` is a per-row weight (0 for padded rows). The loss is the weighted
    mean of per-example losses; with ``sync_grads`` the normalizer is the
    all-reduced global weight, so the gradient on an uneven (padded)
    global batch is EXACTLY the gradient of the unpadded batch.

    ``ablate_collectives`` (instrumentation only) skips the all-reduce so
    its cost can be measured by subtraction; the math is then per-shard
    and wrong on purpose.
    """
    kdrop = None if key is None else split(key)[0]
    head = conf.conf(conf.n_layers - 1)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        ps = tree_unflatten(params, leaves)
        per = F.network_per_example_loss(conf, ps, x, y, train=True,
                                         key=kdrop)
        lsum = torch.sum(per * w)
        wsum = torch.sum(w)
        if sync_grads:
            # differentiate the UNNORMALIZED shard loss sum, then one
            # fused all-reduce of (grads, loss sum, weight sum), and the
            # chain rule in closed form: the global loss is
            # finalize(Σlsum/Σwsum), so dL/dp = f'(mean)·Σgrads/Σwsum,
            # f' = 1 except RMSE_XENT's sqrt (0.5/score)
            target = lsum
        else:
            target = finalize_loss(head.loss_function,
                                   lsum / torch.clamp_min(wsum, 1e-8))
        grads = list(torch.autograd.grad(target, leaves, allow_unused=True,
                                         materialize_grads=True))
    if sync_grads:
        lsum, wsum = lsum.detach(), wsum.detach()
        if not ablate_collectives:
            *grads, lsum, wsum = _flat_all_reduce(
                mesh, grads + [lsum, wsum], DATA_AXIS)
        wsum = torch.clamp_min(wsum, 1e-8)
        score = finalize_loss(head.loss_function, lsum / wsum)
        if LossFunction.coerce(head.loss_function) == LossFunction.RMSE_XENT:
            chain = 0.5 / score / wsum
        else:
            chain = 1.0 / wsum
        grads = [g * chain for g in grads]
        upd_scale = None
    else:
        score = target.detach()
        # an all-padded shard in local mode: freeze params entirely,
        # or the updater's L1/L2 decay would still drift them
        upd_scale = (wsum > 0).to(torch.float32)
    grads = tree_unflatten(params, grads)
    guard_metrics = {}
    guard_finite = None
    if guard is not None:
        # finiteness of the post-reduce score and grad norm, so every rank
        # takes the same skip decision; optional clip before the updater
        from deeplearning4j_tpu_torch.optimize.guardrails import (
            clip_by_global_norm,
            guard_stats,
        )

        gn, guard_finite = guard_stats(score, grads)
        clipped = torch.zeros((), dtype=torch.float32, device=gn.device)
        if guard.clip_norm is not None:
            grads, was_clipped = clip_by_global_norm(grads, gn,
                                                     guard.clip_norm)
            clipped = (was_clipped & guard_finite).to(torch.float32)
        guard_metrics = {
            "nonfinite": (~guard_finite).to(torch.float32),
            "clipped": clipped,
            "guard_grad_norm": gn,
        }
    from deeplearning4j_tpu_torch.telemetry.metrics import global_norm

    if optimizer is not None:
        # the stateful updater: ``states`` is the {"m","v","count"} state
        # of init_sync_opt_state; in ZeRO mode each rank updates its 1/dp
        # chunk and the params are all-gathered
        from deeplearning4j_tpu_torch.optimize.updaters import \
            opt_update_shardmap

        with torch.no_grad():
            out = opt_update_shardmap(optimizer, params, grads, states,
                                      conf.conf(0).lr, zero,
                                      with_metrics=with_metrics)
        new_params, new_states = out[0], out[1]
        opt_metrics = out[2] if with_metrics else {}
        if guard is not None and guard.skip_nonfinite:
            from deeplearning4j_tpu_torch.optimize.guardrails import \
                guard_select

            new_params = guard_select(guard_finite, new_params, params)
            new_states = guard_select(guard_finite, new_states, states)
        if not with_metrics and guard is not None:
            return new_params, new_states, score, guard_metrics
        if not with_metrics:
            return new_params, new_states, score
        metrics = {
            "loss": score.to(torch.float32),
            "grad_norm": global_norm(grads),
            "param_norm": global_norm(params),
            **opt_metrics,
            **guard_metrics,
        }
        return new_params, new_states, score, metrics
    new_params, new_states, updates = [], [], []
    with torch.no_grad():
        for i in range(conf.n_layers):
            upd, st = apply_updater(conf.conf(i), iteration, grads[i],
                                    params[i], states[i])
            if upd_scale is None:
                new_params.append(tree_zip_map(lambda p, u: p - u,
                                               params[i], upd))
            else:
                new_params.append(tree_zip_map(
                    lambda p, u: p - upd_scale * u, params[i], upd))
            new_states.append(st)
            updates.append(upd)
        new_params, new_states = tuple(new_params), tuple(new_states)
        if guard is not None and guard.skip_nonfinite:
            from deeplearning4j_tpu_torch.optimize.guardrails import \
                guard_select

            # the skip freezes the WHOLE training state: a NaN grad would
            # otherwise still poison the AdaGrad and momentum state
            new_params = guard_select(guard_finite, new_params,
                                      tuple(params))
            new_states = guard_select(guard_finite, new_states,
                                      tuple(states))
    if not with_metrics and guard is not None:
        return new_params, new_states, score, guard_metrics
    if not with_metrics:
        return new_params, new_states, score
    ratio = global_norm(updates) / (global_norm(params) + 1e-12)
    metrics = {
        "loss": score.to(torch.float32),
        "grad_norm": global_norm(grads),
        "param_norm": global_norm(params),
        "update_ratio": ratio if upd_scale is None else ratio * upd_scale,
        **guard_metrics,
    }
    return new_params, new_states, score, metrics


def _shard_rows(a, mesh: Mesh, device: torch.device) -> torch.Tensor:
    """This rank's contiguous block of rows of the global batch ``a``
    (array or tensor, rows a multiple of the "data" axis), on ``device``:
    block i of ``mesh.shape["data"]`` at the rank's "data" coordinate
    i."""
    n = a.shape[0] // mesh.shape[DATA_AXIS]
    r = mesh.coords[DATA_AXIS]
    return F.to_device(a[r * n:(r + 1) * n], device)


def _sharded_inputs(params, mesh, iteration, x, y, w):
    dev = tree_leaves(params)[0].device
    if not isinstance(iteration, torch.Tensor):
        iteration = torch.full((), int(iteration), dtype=torch.int64,
                               device=dev)
    return (dev, iteration, _shard_rows(x, mesh, dev),
            _shard_rows(y, mesh, dev), _shard_rows(w, mesh, dev))


def init_sync_opt_state(optimizer, params, mesh: Mesh):
    """Optimizer state for ``make_sync_train_step(optimizer=...)``: zero
    moments shaped like the params (replicated mode), or this rank's
    ``(1, chunk)`` rows of the ZeRO layout (sharded mode)."""
    from deeplearning4j_tpu_torch.optimize.updaters import (
        OptimizerConfig,
        ZeroSharding,
        init_opt_state,
    )

    cfg = OptimizerConfig.coerce(optimizer)
    if cfg is None:
        raise ValueError("init_sync_opt_state needs an optimizer")
    zero = ZeroSharding(mesh, DATA_AXIS) if cfg.sharded else None
    return init_opt_state(cfg, params, zero)


def make_sync_train_step(conf: MultiLayerConfiguration, mesh: Mesh,
                         ablate_collectives: bool = False,
                         with_metrics: bool = False, guard=None,
                         profile=None, optimizer=None, runprof=None):
    """Per-step averaging: grads all-reduced over "data" every iteration.

    step(params, states, iteration, x, y, w, key) -> (params, states,
    score[, metrics]). ``x``, ``y``, ``w`` are the GLOBAL batch (rows a
    multiple of the "data" axis; ``w`` the per-row weight, 0 = padded row),
    the same on every rank; each rank takes its own rows. ``key`` is an
    ``ops.rng`` int, the same on every rank.

    ``with_metrics=True`` appends the metrics dict (loss, grad_norm,
    param_norm, update_ratio) of the POST-reduce gradient, the same on
    every rank. ``guard=True`` (or a ``GuardConfig``) arms the
    guardrails: a non-finite post-reduce score or grad norm carries params
    AND updater state unchanged on every rank, optional global-norm
    clipping runs before the updater, and the guard block is appended
    (merged into the metrics when ``with_metrics``).

    ``optimizer=`` (a name or ``optimize.updaters.OptimizerConfig``)
    replaces the per-layer updater with the stateful one: ``states`` then
    holds the ``{"m","v","count"}`` state of ``init_sync_opt_state``;
    ``update_sharding="sharded"`` runs the ZeRO update, each rank its
    ``1/dp`` chunk, and all-gathers the params.

    ``profile=`` (True or a label) captures the first call's
    ``StepProfile`` (its grad all-reduce among the collectives);
    ``runprof=`` phase-times every call; both under JAX's label
    ``dp_sync[<data axis size>]``.
    """
    from deeplearning4j_tpu_torch.optimize.guardrails import GuardConfig
    from deeplearning4j_tpu_torch.optimize.updaters import OptimizerConfig
    from deeplearning4j_tpu_torch.telemetry.runprof import maybe_runprof
    from deeplearning4j_tpu_torch.telemetry.xprofile import maybe_profiled

    guard = GuardConfig.coerce(guard)
    opt_cfg = OptimizerConfig.coerce(optimizer)
    if opt_cfg is not None:
        opt_cfg = opt_cfg.resolved()
    zero = None
    if opt_cfg is not None and opt_cfg.sharded:
        from deeplearning4j_tpu_torch.optimize.updaters import ZeroSharding

        zero = ZeroSharding(mesh, DATA_AXIS)

    def step(params, states, iteration, x, y, w, key):
        _, iteration, x, y, w = _sharded_inputs(params, mesh, iteration, x,
                                                y, w)
        return _local_grad_step(conf, params, states, iteration, x, y, w,
                                key, True, mesh, ablate_collectives,
                                with_metrics=with_metrics, guard=guard,
                                optimizer=opt_cfg, zero=zero)

    label = f"dp_sync[{mesh.shape[DATA_AXIS]}]"
    return maybe_runprof(maybe_profiled(step, profile, label), runprof,
                         label)


def make_local_fit_step(conf: MultiLayerConfiguration, mesh: Mesh,
                        local_iterations: int):
    """Per-fit averaging: each rank runs ``local_iterations`` steps on its
    own shard with no cross-rank traffic (the key of step i folded from
    i), then params, updater state and the last score are averaged over
    "data", weighted by each shard's real rows, in one all-reduce."""

    def local_fit(params, states, iteration0, x, y, w, key):
        dev, iteration0, x, y, w = _sharded_inputs(params, mesh, iteration0,
                                                   x, y, w)
        its = torch.arange(local_iterations, device=dev) + iteration0
        score = None
        for i in range(local_iterations):
            step_key = None if key is None else fold_in(key, i)
            params, states, score = _local_grad_step(
                conf, params, states, its[i], x, y, w, step_key, False, mesh)
        # the one aggregation round (the reference's driver-side fold and
        # ÷N): weighted by each shard's row count, so an all-padded shard
        # contributes nothing. Σ(t·w_r) and Σw_r travel in one buffer.
        wsum = torch.sum(w)
        leaves = tree_leaves((params, states)) + [score]
        *summed, wtot = _flat_all_reduce(
            mesh, [t * wsum for t in leaves] + [wsum], DATA_AXIS)
        wtot = torch.clamp_min(wtot, 1e-8)
        avg = [t / wtot for t in summed]
        params, states = tree_unflatten((params, states), avg[:-1])
        return params, states, avg[-1]

    return local_fit


def _pad_rows(a, pad: int):
    """``a`` with its last row repeated ``pad`` times (array or tensor)."""
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a[-1:].expand((pad,) + tuple(a.shape[1:]))])
    a = np.asarray(a)
    return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)


class ParameterAveragingTrainer:
    """Facade mirroring SparkDl4jMultiLayer: wraps a MultiLayerNetwork and a
    mesh, trains data-parallel, leaves averaged params in the network.
    Every rank builds the same network (same conf, same seed) and calls
    ``fit_data_set`` on the same batches.

    ``average_each_iteration`` matches the reference's
    ``org.deeplearning4j.spark.iteration.average`` SparkConf flag.
    """

    def __init__(
        self,
        net: MultiLayerNetwork,
        mesh: Optional[Mesh] = None,
        average_each_iteration: bool = False,
        local_iterations: Optional[int] = None,
        checkpointer=None,
        checkpoint_every: int = 0,
    ):
        from deeplearning4j_tpu_torch.parallel.mesh import data_parallel_mesh

        self.net = net
        self.mesh = mesh if mesh is not None else data_parallel_mesh()
        if (self.mesh.device is not None
                and self.mesh.device.type != net.device.type):
            raise ValueError(
                f"the network lives on {net.device} but this rank's mesh "
                f"device is {self.mesh.device}: build the network on the "
                "rank's device")
        self.average_each_iteration = average_each_iteration
        self.local_iterations = (
            local_iterations
            if local_iterations is not None
            else net.conf.conf(0).num_iterations
        )
        self._sync_step = None
        self._fit_step = None
        self._iteration = 0
        # periodic checkpoints through the exception-safe listener
        # dispatch; with the mesh the coordinator alone writes
        self._ckpt_listener = None
        if checkpointer is not None and checkpoint_every > 0:
            from deeplearning4j_tpu_torch.scaleout.ckpt import (
                CheckpointIterationListener,
            )

            self._ckpt_listener = CheckpointIterationListener(
                checkpointer, save_every=checkpoint_every, mesh=self.mesh)

    def resume(self, checkpointer) -> Optional[int]:
        """Restore net params/updater state/key/iteration from the latest
        committed checkpoint under ``checkpointer`` on every rank (each
        holds a full copy) and continue counting from its step. Returns the
        resumed step, or None when no checkpoint exists yet."""
        from deeplearning4j_tpu_torch.scaleout.ckpt import (
            capture_net_state,
            restore_net_state,
        )

        # the coordinator's saves are committed before any rank reads
        self.mesh.barrier()
        if checkpointer.latest_step() is None:
            return None
        net = self.net
        net._ensure_train_step()
        template, _meta = capture_net_state(net)
        state, step, meta = checkpointer.restore(template, device=net.device)
        restore_net_state(net, state, meta)
        self._iteration = int(meta.get("iteration", step))
        return step

    @property
    def n_devices(self) -> int:
        return int(self.mesh.size)

    def _pad_to_devices(self, x):
        """Pad the batch so it divides the data-axis size (the reference
        repartitions the RDD to the worker count, :164). Padded rows repeat
        the last sample but carry 0 weight in the returned mask, so they
        never enter the loss or gradient."""
        n = x.shape[0]
        d = self.mesh.shape[DATA_AXIS]
        rem = n % d
        if rem == 0:
            return x, np.ones((n,), np.float32)
        pad = d - rem
        w = np.concatenate([np.ones((n,), np.float32),
                            np.zeros((pad,), np.float32)])
        return _pad_rows(x, pad), w

    def _pad_batch(self, batch):
        """(features, labels, weight-mask), all padded to the data-axis size."""
        x, w = self._pad_to_devices(batch.features)
        n = batch.labels.shape[0]
        d = self.mesh.shape[DATA_AXIS]
        y = batch.labels
        if n % d:
            y = _pad_rows(y, d - n % d)
        return x, y, w

    def fit_data_set(self, data: DataSetIterator) -> None:
        """ref: SparkDl4jMultiLayer.fitDataSet(JavaRDD<DataSet>)."""
        net = self.net
        net._ensure_train_step()
        # copies: the facade (or a clone) may still reference the buffers
        params = tree_map(lambda _, a: a.detach().clone(), net.params_tree)
        states = tree_map(lambda _, a: a.detach().clone(), net._train_state)

        from deeplearning4j_tpu_torch.optimize.listeners import (
            close_listeners,
            dispatch_listeners,
        )

        listeners = list(net.listeners)
        if self._ckpt_listener is not None:
            listeners.append(self._ckpt_listener)

        def publish(params, states):
            # listeners (the checkpoint listener's capture_net_state) see
            # the CURRENT training state, not the pre-fit buffers
            net._params = params
            net._train_state = states
            net._iteration = self._iteration

        try:
            if self.average_each_iteration:
                if self._sync_step is None:
                    self._sync_step = make_sync_train_step(net.conf,
                                                           self.mesh)
                step, per_batch = self._sync_step, 1
            else:
                if self._fit_step is None:
                    self._fit_step = make_local_fit_step(
                        net.conf, self.mesh, self.local_iterations)
                step, per_batch = self._fit_step, self.local_iterations
            for batch in data:
                x, y, w = self._pad_batch(batch)
                params, states, score = step(
                    params, states, self._iteration, x, y, w,
                    net._keys.next(),
                )
                self._iteration += per_batch
                publish(params, states)
                dispatch_listeners(listeners, net, self._iteration,
                                   float(score))
        finally:
            # a crash mid-fit must not leave a listener's window open
            close_listeners(listeners)

        net._params = params
        net._train_state = states
