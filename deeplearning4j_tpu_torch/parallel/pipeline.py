"""Counterpart of ``deeplearning4j_tpu/parallel/pipeline.py``: the GPipe
microbatched stage pipeline over the "pipe" axis.

One process per rank: the rank at index s of the "pipe" axis owns stage s
(``shard_stage_params`` gives it: its slice, leading stage axis of size 1,
of the stage-stacked params). Microbatches stream in; at tick t stage s
computes microbatch t − s, and its output goes to stage s + 1 by a
point-to-point send (``Mesh.exchange``): the classic (M + S − 1)-tick
schedule, whose S − 1 bubble ticks compute nothing. ``overlap=True`` swaps
in the double-buffered handoff: each tick FIRST starts sending the previous
tick's output, computes on the buffer received the tick before, then waits,
so a hop takes two ticks (M + 2(S − 1) ticks) and the exchange runs under
the stage's compute. Every (stage, microbatch) input is the strict
schedule's, so outputs and grads are bit-identical.

A ``torch.autograd.Function`` runs the schedule: the forward keeps each
microbatch's stage graph, and the last stage's outputs are broadcast over
the axis (every stage returns them, as the JAX package's psum makes them
replicated); the backward runs the reverse schedule from the last stage's
cotangent (the outputs are replicated, so their one cotangent is not
summed over the stages), sending each microbatch's input grad upstream,
and stage 0's input grads are broadcast back over the axis.

With ``batch_axis`` (dp×pp) each rank takes its rows of every microbatch
and runs the same schedule on them; the train step gathers the outputs
over the rows for the loss and sums the stage grads over ``batch_axis``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from deeplearning4j_tpu_torch._device import (
    tree_leaves,
    tree_map,
    tree_unflatten,
    tree_zip_map,
)
from deeplearning4j_tpu_torch.parallel.mesh import (
    PIPE_AXIS,
    LeafShards,
    flat_all_reduce,
    gather_rows_ad,
)

def _schedule_ticks(n_micro: int, n_stages: int, hop: int) -> int:
    return n_micro + hop * (n_stages - 1)


class _Pipeline(torch.autograd.Function):
    """The tick schedule over the pipe axis (module docstring). Inputs:
    this rank's microbatches (M, mb, ...) and its stage's param leaves."""

    @staticmethod
    def forward(ctx, x_mbs, mesh, axis, stage_fn, template, overlap,
                *leaves):
        n_stages, me = mesh.axis_size(axis), mesh.axis_index(axis)
        n_micro = x_mbs.shape[0]
        hop = 2 if overlap else 1
        x_grad = ctx.needs_input_grad[0]
        params = [p.detach().requires_grad_(p.requires_grad)
                  for p in leaves]
        tree = tree_unflatten(template, params)
        graphs = {}
        out = torch.zeros_like(x_mbs)

        def mb(stage, t):
            # the microbatch stage `stage` computes at tick t, or None
            m = t - hop * stage
            return m if 0 <= m < n_micro else None

        def stage_compute(m, x_in):
            x_in = x_in.detach().requires_grad_(me > 0 or x_grad)
            with torch.enable_grad():
                y = stage_fn(tree, x_in)
            graphs[m] = (x_in, y)
            if me == n_stages - 1:
                out[m] = y.detach()
            return y.detach()

        recv = torch.empty(x_mbs.shape[1:], dtype=x_mbs.dtype,
                           device=x_mbs.device)
        y_prev = None
        for t in range(_schedule_ticks(n_micro, n_stages, hop)):
            m = mb(me, t)
            if overlap:
                # send the previous tick's output while this tick computes
                sends = [y_prev] if me < n_stages - 1 and \
                    mb(me, t - 1) is not None else []
                nxt = torch.empty_like(recv)
                wait = mesh.exchange(axis, sends, [nxt] if me > 0 and mb(
                    me - 1, t - 1) is not None else [])
                y_prev = None if m is None else stage_compute(
                    m, x_mbs[m] if me == 0 else recv)
                wait()
                recv = nxt
            else:
                y = None if m is None else stage_compute(
                    m, x_mbs[m] if me == 0 else recv)
                sends = [y] if me < n_stages - 1 and m is not None else []
                recvs = [recv] if me > 0 and mb(me - 1, t) is not None \
                    else []
                recv = torch.empty_like(recv) if recvs else recv
                mesh.exchange(axis, sends, [recv] if recvs else [])()
        mesh.broadcast(out, axis, n_stages - 1)
        ctx.graphs, ctx.params = graphs, params
        ctx.mesh, ctx.axis, ctx.n_micro = mesh, axis, n_micro
        ctx.x_shape, ctx.x_grad = x_mbs.shape, x_grad
        return out

    @staticmethod
    def backward(ctx, d_out):
        mesh, axis, n_micro = ctx.mesh, ctx.axis, ctx.n_micro
        n_stages, me = mesh.axis_size(axis), mesh.axis_index(axis)
        dx = d_out.new_zeros(ctx.x_shape) if ctx.x_grad else None
        recv = torch.empty(d_out.shape[1:], dtype=d_out.dtype,
                           device=d_out.device)
        for u in range(_schedule_ticks(n_micro, n_stages, 1)):
            # the reverse schedule: stage s takes microbatch M-1-(u-(S-1-s))
            def mb(stage, u=u):
                k = u - (n_stages - 1 - stage)
                return n_micro - 1 - k if 0 <= k < n_micro else None

            m = mb(me)
            dxm = None
            if m is not None:
                x_in, y = ctx.graphs.pop(m)
                g = d_out[m] if me == n_stages - 1 else recv
                torch.autograd.backward(y, g)
                if x_in.requires_grad:
                    dxm = x_in.grad if x_in.grad is not None else \
                        torch.zeros_like(x_in)
                if me == 0 and dx is not None:
                    dx[m] = dxm
            sends = [dxm] if me > 0 and m is not None else []
            recvs = me < n_stages - 1 and mb(me + 1) is not None
            recv = torch.empty_like(recv) if recvs else recv
            mesh.exchange(axis, sends, [recv] if recvs else [], step=-1)()
        if dx is not None:
            mesh.broadcast(dx, axis, 0)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in ctx.params]
        return (dx, None, None, None, None, None, *grads)


def _rows(x: torch.Tensor, mesh, batch_axis: Optional[str], dim: int):
    """This rank's contiguous rows of dim ``dim`` over ``batch_axis``."""
    if batch_axis is None:
        return x
    n, i = mesh.axis_size(batch_axis), mesh.axis_index(batch_axis)
    if x.shape[dim] % n:
        raise ValueError(f"{x.shape[dim]} microbatch rows do not split "
                         f"over the {n} ranks of {batch_axis!r}")
    rows = x.shape[dim] // n
    return x.narrow(dim, i * rows, rows)


def pipeline_apply(stage_params, x_mbs: torch.Tensor, stage_fn: Callable,
                   mesh, axis: str = PIPE_AXIS,
                   batch_axis: Optional[str] = None,
                   overlap: bool = False) -> torch.Tensor:
    """Run microbatches through the stage pipeline.

    stage_params: this rank's stage, leaves with a leading stage axis of
    size 1 (``shard_stage_params``); ``stage_fn(params_slice, x) -> y``
    applies one stage with that axis stripped. x_mbs: the GLOBAL (M, mb,
    ...) microbatches, the same on every rank (only stage 0 reads them).
    Returns (M, mb/dp, ...): this rank's rows over ``batch_axis`` (all of
    them without it) of the pipeline output, on every stage. Every rank
    of the mesh calls it. ``overlap=True`` runs the double-buffered
    handoff (module docstring), bit-identical."""
    leaves = tree_leaves(stage_params)
    for leaf in leaves:
        if leaf.shape[0] != 1:
            raise ValueError(
                f"stage param leading dim {leaf.shape[0]} != 1: pass this "
                f"rank's stage of the {mesh.shape[axis]}-stage stack "
                "(shard_stage_params gives it) — a mismatch would silently "
                "run a different (interleaved-stage) model")
    local = [leaf[0] for leaf in leaves]
    x = _rows(x_mbs, mesh, batch_axis, 1)
    return _Pipeline.apply(x, mesh, axis, stage_fn, stage_params, overlap,
                           *local)


def stack_stage_params(per_stage: list):
    """[{k: tensor}, ...] → {k: (S, ...) tensor} for pipeline_apply."""
    from deeplearning4j_tpu_torch.parallel.sharding import \
        stack_along_leading_axis

    return stack_along_leading_axis(per_stage)


def shard_stage_params(stacked, mesh, axis: str = PIPE_AXIS):
    """This rank's stage of the stacked (S, ...) params: leaves of leading
    dim 1."""
    from deeplearning4j_tpu_torch.parallel.sharding import shard_leading_axis

    return shard_leading_axis(stacked, mesh, axis)


def unstack_stage_params(stacked) -> list:
    """{k: (S, ...) tensor} → [{k: tensor}, ...], the inverse of
    stack_stage_params (views)."""
    n_stages = tree_leaves(stacked)[0].shape[0]
    return [tree_map(lambda _, a, i=i: a[i], stacked)
            for i in range(n_stages)]


def merge_stage_axis(stacked):
    """(S, per, ...) stage-stacked leaves → (S·per, ...): stage i's slice
    becomes layers [i·per, (i+1)·per) of the contiguous stack (this
    rank's stage alone: its ``per`` layers)."""
    return tree_map(
        lambda _, a: a.reshape((a.shape[0] * a.shape[1],)
                               + tuple(a.shape[2:])), stacked)


def pipeline_from_conf(conf, params, mesh, layers=None,
                       axis: str = PIPE_AXIS):
    """Stage a uniform DENSE segment of a MultiLayerConfiguration onto the
    pipe axis: ``(this rank's stage params, stage_fn)`` for
    pipeline_apply / make_pipeline_train_step. ``layers`` defaults to
    every DENSE layer with n_in == n_out; all staged layers must share
    n_in/n_out/activation. The stage runs the layer's ``dense.forward``
    (K1 on the card)."""
    from deeplearning4j_tpu_torch.nn.api import LayerType
    from deeplearning4j_tpu_torch.nn.layers import dense

    if layers is None:
        layers = [i for i in range(conf.n_layers)
                  if conf.conf(i).layer_type == LayerType.DENSE
                  and conf.conf(i).n_in == conf.conf(i).n_out]
    if len(layers) != mesh.shape[axis]:
        raise ValueError(
            f"{len(layers)} uniform dense layers for a {mesh.shape[axis]}-"
            f"device pipe axis — pass layers= explicitly to choose the "
            "staged segment")
    confs = [conf.conf(i) for i in layers]
    for i, c in zip(layers, confs):
        if c.layer_type != LayerType.DENSE:
            raise ValueError(
                f"layer {i} is {c.layer_type}, not DENSE — only uniform "
                "dense segments can be pipelined through pipeline_from_conf")
    c0 = confs[0]
    for c in confs[1:]:
        if (c.n_in, c.n_out, c.activation_function) != (
                c0.n_in, c0.n_out, c0.activation_function):
            raise ValueError("staged layers must be uniform "
                             "(same n_in/n_out/activation)")

    def stage_fn(p, x):
        return dense.forward(c0, p, x)

    stacked = stack_stage_params([params[i] for i in layers])
    return shard_stage_params(stacked, mesh, axis), stage_fn


def heterogeneous_pipeline_from_conf(conf, params, mesh,
                                     axis: str = PIPE_AXIS):
    """Stage an ENTIRE dense/output MultiLayerConfiguration onto the pipe
    axis, one layer per rank, with non-uniform widths: every stage's
    weight embedded in a (dmax, dmax) zero block, biases in (dmax,),
    activations travelling as (mb, dmax); each rank runs its own layer's
    branch on x[:, :n_in] and pads back to dmax, so the padding carries
    exact zeros. Returns ``(this rank's stage params, stage_fn,
    out_width)``."""
    from deeplearning4j_tpu_torch.nn.api import LayerType
    from deeplearning4j_tpu_torch.nn.layers import dense as dense_layer
    from deeplearning4j_tpu_torch.nn.layers import output as output_layer
    from deeplearning4j_tpu_torch.nn.params import BIAS_KEY, WEIGHT_KEY

    n_stages = mesh.shape[axis]
    if conf.n_layers != n_stages:
        raise ValueError(
            f"{conf.n_layers} layers for a {n_stages}-device pipe axis — "
            "heterogeneous staging is one layer per stage")
    confs = [conf.conf(i) for i in range(conf.n_layers)]
    for i, c in enumerate(confs):
        if c.layer_type not in (LayerType.DENSE, LayerType.OUTPUT):
            raise ValueError(
                f"layer {i} is {c.layer_type}; heterogeneous staging "
                "supports DENSE/OUTPUT layers")
    dmax = max(max(c.n_in, c.n_out) for c in confs)

    padded = []
    for c, p in zip(confs, params):
        w = p[WEIGHT_KEY].new_zeros((dmax, dmax))
        w[:c.n_in, :c.n_out] = p[WEIGHT_KEY]
        b = p[BIAS_KEY].new_zeros((dmax,))
        b[:c.n_out] = p[BIAS_KEY]
        padded.append({WEIGHT_KEY: w, BIAS_KEY: b})

    c_me = confs[mesh.axis_index(axis)]
    fwd = (output_layer.forward if c_me.layer_type == LayerType.OUTPUT
           else dense_layer.forward)

    def stage_fn(p, x):
        real = {WEIGHT_KEY: p[WEIGHT_KEY][:c_me.n_in, :c_me.n_out],
                BIAS_KEY: p[BIAS_KEY][:c_me.n_out]}
        y = fwd(c_me, real, x[:, :c_me.n_in])
        return torch.nn.functional.pad(y, (0, dmax - c_me.n_out))

    stacked = shard_stage_params(stack_stage_params(padded), mesh, axis)
    return stacked, stage_fn, confs[-1].n_out


def pp_update_sharding(mesh, axis: str = PIPE_AXIS,
                       batch_axis: str = "data"):
    """ZeRO update-sharding descriptor for stage-stacked params: every
    leaf keeps its leading stage dim and its per-stage remainder shards
    over ``batch_axis`` (the dp rows of a dp×pp mesh)."""
    from deeplearning4j_tpu_torch.optimize.updaters import ZeroSharding

    if batch_axis not in mesh.axis_names:
        raise ValueError(
            f"update_sharding='sharded' needs the {batch_axis!r} axis on "
            f"the mesh (got {mesh.axis_names})")
    return ZeroSharding(mesh, batch_axis, lambda _ks: (axis,))


def init_pp_opt_state(optimizer, stacked, mesh, axis: str = PIPE_AXIS,
                      batch_axis: Optional[str] = None):
    """Optimizer state for ``make_pipeline_train_step(optimizer=...)``:
    moments like this rank's stage params, or their ZeRO rows over
    ``batch_axis`` when the config resolves ``update_sharding="sharded"``."""
    from deeplearning4j_tpu_torch.optimize.updaters import (
        OptimizerConfig,
        init_opt_state,
    )

    cfg = OptimizerConfig.coerce(optimizer)
    if cfg is None:
        raise ValueError("init_pp_opt_state needs an optimizer")
    zero = None
    if cfg.sharded:
        zero = pp_update_sharding(mesh, axis, batch_axis or "data")
    return init_opt_state(cfg, stacked, zero)


def make_pipeline_train_step(stage_fn: Callable, loss_fn: Callable, mesh,
                             axis: str = PIPE_AXIS, lr: float = 0.1,
                             batch_axis: Optional[str] = None,
                             with_metrics: bool = False, guard=None,
                             profile=None, optimizer=None,
                             overlap: bool = False, runprof=None,
                             tuned=None, tune_context=None):
    """Train step over the pipelined stack.

    loss = mean over microbatches of ``loss_fn(y_mb, labels_mb)`` on the
    pipeline output; the backward runs the reverse schedule, so each
    stage's params get exact grads. ``step(stage_params, x_mbs, y_mbs) ->
    (new_params, loss)``, stage_params this rank's stage, x_mbs/y_mbs the
    GLOBAL microbatches. With ``batch_axis`` each rank pipelines its rows,
    the outputs are gathered over the rows so ``loss_fn`` sees whole
    microbatches, and the stage grads are summed over ``batch_axis`` in
    one all-reduce. ``with_metrics`` appends the metrics (per-microbatch
    loss, grad/param norms over every stage); ``guard`` the guardrails;
    ``optimizer=`` the stateful update, ``step(params, opt_state, x_mbs,
    y_mbs) -> (params, opt_state, loss[, metrics])`` with state from
    ``init_pp_opt_state`` (ZeRO over ``batch_axis`` when sharded).
    ``overlap=True`` runs the double-buffered handoff: loss and params
    bit-identical to the strict schedule. ``profile=`` and ``runprof=``
    arm the seams under JAX's label (``pipeline[pipe]``,
    ``pipeline[pipexdata]``, ``+overlap``); the profile records the stage
    handoffs as collective-permutes.

    ``tuned=`` adopts the autotuner's ``pipeline`` seam as JAX's does:
    ``overlap`` (bit-identical, see above) when the ``overlap=`` arg was
    left at its default. The space's ``microbatches`` knob shapes the
    data (x_mbs/y_mbs), so the caller's loader applies it. Explicit dict >
    cache under ``tune_context`` > ``DL4J_TPU_TUNED`` env > off
    (``tune/cache.py``)."""
    from deeplearning4j_tpu_torch.optimize.guardrails import (
        GuardConfig,
        guarded_sgd_update,
    )
    from deeplearning4j_tpu_torch.optimize.updaters import (
        OptimizerConfig,
        guarded_opt_update,
        opt_update_shardmap,
    )
    from deeplearning4j_tpu_torch.telemetry.metrics import train_step_metrics

    from deeplearning4j_tpu_torch.telemetry.runprof import maybe_runprof
    from deeplearning4j_tpu_torch.telemetry.xprofile import maybe_profiled
    from deeplearning4j_tpu_torch.tune.cache import resolve_step_tuning

    tuning = resolve_step_tuning(tuned, tune_context, ("pipeline",))
    if not overlap and "overlap" in tuning:
        overlap = bool(tuning["overlap"])
    guard = GuardConfig.coerce(guard)
    label = (f"pipeline[{axis}" + (f"x{batch_axis}]" if batch_axis else "]")
             + ("+overlap" if overlap else ""))

    def _seam(step):
        return maybe_runprof(maybe_profiled(step, profile, label), runprof,
                             label)

    opt_cfg = OptimizerConfig.coerce(optimizer)
    if opt_cfg is not None:
        opt_cfg = opt_cfg.resolved()
    zero = (pp_update_sharding(mesh, axis, batch_axis or "data")
            if opt_cfg is not None and opt_cfg.sharded else None)
    # each rank holds its stage: norms sum over the pipe axis
    shards = LeafShards(mesh, lambda _path: (axis,))

    def loss_and_grads(params, x_mbs, y_mbs):
        leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
        with torch.enable_grad():
            outs = pipeline_apply(tree_unflatten(params, leaves), x_mbs,
                                  stage_fn, mesh, axis,
                                  batch_axis=batch_axis, overlap=overlap)
            if batch_axis is not None:
                outs = gather_rows_ad(mesh, outs.transpose(0, 1)
                                      .contiguous(), batch_axis
                                      ).transpose(0, 1)
            per = torch.stack([loss_fn(outs[m], y_mbs[m])
                               for m in range(outs.shape[0])])
            loss = per.mean()
            grads = list(torch.autograd.grad(loss, leaves))
        if batch_axis is not None:
            grads = flat_all_reduce(mesh, grads, batch_axis)
        return loss.detach(), per.detach(), tree_unflatten(params, grads)

    def finish(params, grads, loss, per, block):
        if with_metrics:
            block = {**(block or {}),
                     **train_step_metrics(params, grads, lr, loss=loss,
                                          shards=shards)}
            if opt_cfg is not None:
                block.pop("update_ratio", None)
            block["microbatch_loss"] = per
        return block

    if opt_cfg is None:
        def step(params, x_mbs, y_mbs):
            loss, per, grads = loss_and_grads(params, x_mbs, y_mbs)
            with torch.no_grad():
                if guard is None:
                    new = tree_zip_map(lambda p, g: p - lr * g, params,
                                       grads)
                    block = None
                else:
                    new, block = guarded_sgd_update(params, grads, loss, lr,
                                                    guard, shards=shards)
                block = finish(params, grads, loss, per, block)
            return (new, loss) if block is None else (new, loss, block)

        return _seam(step)

    def opt_step(params, opt_state, x_mbs, y_mbs):
        loss, per, grads = loss_and_grads(params, x_mbs, y_mbs)
        with torch.no_grad():
            if guard is None:
                out = opt_update_shardmap(opt_cfg, params, grads, opt_state,
                                          lr, zero, with_metrics=with_metrics,
                                          shards=shards)
            else:
                out = guarded_opt_update(params, grads, opt_state, loss, lr,
                                         opt_cfg, guard,
                                         with_metrics=with_metrics,
                                         zero=zero, shards=shards)
            new, state = out[0], out[1]
            block = finish(params, grads, loss, per,
                           out[2] if len(out) == 3 else None)
        if block is None:
            return new, state, loss
        return new, state, loss, block

    return _seam(opt_step)
