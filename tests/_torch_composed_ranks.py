"""One rank of the composed-parallelism port's multi-process checks (ring
and Ulysses attention, the MoE dispatch, the pipeline, the LM's composed
and pp steps).

Run as ``python tests/_torch_composed_ranks.py RANK WORLD PORT IN OUT``,
started by ``_torch_parallel_ranks.spawn_ranks(..., script=SCRIPT)``: the
rank joins a gloo group on ``127.0.0.1:PORT``, and for every scenario of
``IN`` (a pickle of numpy trees, sorted by name) builds the scenario's
mesh (``inp["mesh"]``: axis names and sizes; every rank builds every mesh
in the same order), runs it through the port and writes the results to
``OUT/rank<RANK>.pkl``. It imports torch and the port only; the test
modules compare the ranks' results with the JAX package's.
"""

from __future__ import annotations

import os
import pickle
import sys
import traceback

import numpy as np
import torch

torch.set_num_threads(1)

from deeplearning4j_tpu_torch.interop import (  # noqa: E402
    lm_params_from_numpy,
    tree_to_numpy,
)
from deeplearning4j_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from deeplearning4j_tpu_torch.parallel import multihost  # noqa: E402

CPU = "cpu"


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_() if grad else t


def _np(x):
    return x.detach().cpu().numpy()


def _rows(a, mesh, axis, dim):
    """This rank's contiguous block of ``a`` along ``dim`` over ``axis``."""
    if axis is None or axis not in mesh.axis_names:
        return a
    n, i = mesh.shape[axis], mesh.coords[axis]
    k = a.shape[dim] // n
    return a.narrow(dim, i * k, k)


def _count(fn):
    """``fn()`` and the collectives it made."""
    pmesh.reset_collectives()
    out = fn()
    return out, dict(pmesh.COLLECTIVES)


# -------------------------------------------------------------- attention ----

def scenario_ring(inp, mesh):
    """ring_attention on this rank's sequence block (and rows over
    ``batch_axis``): its output block and the grads of sum(o²)."""
    from deeplearning4j_tpu_torch.parallel.ring_attention import \
        ring_attention

    axis, batch_axis = inp["axis"], inp.get("batch_axis")
    out = {}
    for name, kw in inp["runs"].items():
        q, k, v = (_t(_np(_rows(_rows(_t(x), mesh, axis, 2), mesh,
                                    batch_axis, 0)), grad=True)
                   for x in inp["qkv"])

        def run():
            o = ring_attention(q, k, v, mesh, axis, batch_axis=batch_axis,
                               **kw)
            return o, torch.autograd.grad((o * o).sum(), (q, k, v))

        (o, grads), coll = _count(run)
        out[name] = {"o": _np(o), "grads": [_np(g) for g in grads],
                     "collectives": coll}
    return out


def scenario_ulysses(inp, mesh):
    from deeplearning4j_tpu_torch.parallel.ring_attention import \
        ulysses_attention

    axis = inp["axis"]
    q, k, v = (_t(_np(_rows(_t(x), mesh, axis, 2)), grad=True)
               for x in inp["qkv"])
    o = ulysses_attention(q, k, v, mesh, axis, **inp["kw"])
    grads = torch.autograd.grad((o * o).sum(), (q, k, v))
    out = {"o": _np(o), "grads": [_np(g) for g in grads]}
    try:
        ulysses_attention(q[:, :3], k[:, :3], v[:, :3], mesh, axis)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def scenario_forward_ring(inp, mesh):
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import attention

    conf = NeuralNetConfiguration(**inp["conf_kw"])
    params = {k: _t(v, grad=True) for k, v in inp["params"].items()}
    x = _rows(_t(inp["x"]), mesh, inp["axis"], 1)
    y = attention.forward_ring(conf, params, x, mesh, inp["axis"])
    keys = sorted(params)
    grads = torch.autograd.grad((y * y).sum(), [params[k] for k in keys])
    # every rank's grads cover its block's loss: sum them for the total
    grads = pmesh.flat_all_reduce(mesh, list(grads))
    return {"y": _np(y), "grads": {k: _np(g) for k, g in zip(keys, grads)}}


# -------------------------------------------------------------------- moe ----

def _expert_fn(params, x):
    """The tests' expert: tanh(x·W + b) for a group of experts."""
    return torch.tanh(x @ params["w"] + params["b"][:, None, :])


def scenario_moe(inp, mesh):
    """moe_apply on this rank's token shard, and the grads of mean((out -
    tgt)²) over the global tokens: router (summed over the token axes)
    and this rank's experts'."""
    from deeplearning4j_tpu_torch.parallel.moe import (
        moe_apply,
        set_moe_impl,
        shard_expert_params,
    )

    token_axes = tuple(inp.get("token_axes", ()))
    out = {}
    for name, kw in inp["runs"].items():
        rw = _t(inp["router"], grad=True)
        stacked = {k: _t(v) for k, v in inp["experts"].items()}
        local = {k: v.clone().requires_grad_() for k, v in
                 shard_expert_params(stacked, mesh).items()}
        x, tgt = _t(inp["x"]), _t(inp["tgt"])
        for a in token_axes:
            x, tgt = _rows(x, mesh, a, 0), _rows(tgt, mesh, a, 0)
        set_moe_impl(kw.get("global_impl"))
        try:
            def run():
                o = moe_apply(rw, local, x, mesh, _expert_fn,
                              inp["capacity"], top_k=kw.get("top_k", 1),
                              token_axes=token_axes, impl=kw.get("impl"))
                loss = ((o - tgt) ** 2).sum() / tgt.numel() / _shards(
                    mesh, token_axes)
                return o, torch.autograd.grad(
                    loss, [rw, local["b"], local["w"]])

            (o, grads), coll = _count(run)
        finally:
            set_moe_impl(None)
        grads = pmesh.flat_all_reduce(mesh, list(grads), token_axes)
        out[name] = {"out": _np(o), "router": _np(grads[0]),
                     "b": _np(grads[1]), "w": _np(grads[2]),
                     "collectives": coll}
    return out


def _shards(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


# --------------------------------------------------------------- pipeline ----

def _stage_fn(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def scenario_pipeline(inp, mesh):
    """pipeline_apply's output rows and the stage grads of mean((out -
    tgt)²), strict and overlapped; then SGD steps of
    make_pipeline_train_step, both schedules."""
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        make_pipeline_train_step,
        pipeline_apply,
        shard_stage_params,
    )

    batch_axis = inp.get("batch_axis")
    x, tgt = _t(inp["x"]), _t(inp["tgt"])
    out = {}
    for overlap in (False, True):
        stage = {k: v.clone().requires_grad_() for k, v in
                 shard_stage_params({k: _t(v) for k, v in
                                     inp["stages"].items()}, mesh).items()}
        y = pipeline_apply(stage, x, _stage_fn, mesh,
                           batch_axis=batch_axis, overlap=overlap)
        # the global mean: each rank's rows' share of it
        loss = ((y - _rows(tgt, mesh, batch_axis, 1)) ** 2).sum() / \
            tgt.numel()
        grads = torch.autograd.grad(loss, [stage["b"], stage["w"]])
        grads = pmesh.flat_all_reduce(mesh, list(grads), batch_axis) \
            if batch_axis else grads
        out[f"apply_{overlap}"] = {"y": _np(y), "b": _np(grads[0]),
                                   "w": _np(grads[1])}
        step = make_pipeline_train_step(
            _stage_fn, lambda a, b: ((a - b) ** 2).mean(), mesh, lr=0.2,
            batch_axis=batch_axis, overlap=overlap,
            with_metrics=inp.get("with_metrics", False))
        params = shard_stage_params({k: _t(v) for k, v in
                                     inp["stages"].items()}, mesh)
        losses, blocks = [], []
        for _ in range(inp["steps"]):
            res = step(params, x, tgt)
            params, loss = res[0], res[1]
            losses.append(float(loss))
            if len(res) == 3:
                blocks.append({k: _np(v) for k, v in res[2].items()})
        out[f"train_{overlap}"] = {"losses": losses, "blocks": blocks,
                                   "params": tree_to_numpy(params)}
    return out


def scenario_pipeline_conf(inp, mesh):
    """pipeline_from_conf's stage on this rank, through pipeline_apply."""
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.interop import mln_params_from_numpy
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        heterogeneous_pipeline_from_conf,
        pipeline_apply,
        pipeline_from_conf,
    )

    conf = MultiLayerConfiguration.from_json(inp["conf"])
    params = mln_params_from_numpy(inp["params"], device=CPU)
    x = _t(inp["x"])
    if inp.get("heterogeneous"):
        stacked, stage_fn, width = heterogeneous_pipeline_from_conf(
            conf, params, mesh)
        x = torch.nn.functional.pad(x, (0, stacked["W"].shape[-1]
                                        - x.shape[-1]))
        y = pipeline_apply(stacked, x, stage_fn, mesh)
        return {"y": _np(y), "width": width}
    stacked, stage_fn = pipeline_from_conf(conf, params, mesh)
    return {"y": _np(pipeline_apply(stacked, x, stage_fn, mesh))}


# --------------------------------------------------------------------- LM ----

def scenario_composed(inp, mesh):
    """Steps of make_composed_train_step from the JAX package's params on
    the global batches: per step the loss, the metrics and the
    collectives; this rank's params (its expert group) at the end."""
    from deeplearning4j_tpu_torch.models import transformer_lm as T
    from deeplearning4j_tpu_torch.optimize.updaters import OptimizerConfig

    opt = inp.get("optimizer")
    opt = None if opt is None else OptimizerConfig(**opt)
    step = T.make_composed_train_step(
        mesh, inp["n_heads"], inp["capacity"], lr=inp["lr"],
        attn_impl=inp.get("attn_impl"), moe_impl=inp.get("moe_impl"),
        with_metrics=inp.get("with_metrics", False), guard=inp.get("guard"),
        optimizer=opt, ring_prefetch=inp.get("ring_prefetch", True),
        device=CPU)
    full = lm_params_from_numpy(inp["params"], CPU)
    specs = T.lm_param_shardings(full, mesh)
    params = T.shard_lm_params(full, mesh, device=CPU)
    state = None if opt is None else T.init_lm_opt_state(opt, params, mesh,
                                                         device=CPU)
    out = {"losses": [], "blocks": [], "collectives": []}
    for tokens, targets in inp["batches"]:
        tk, tg = T.shard_lm_batch(tokens, targets, mesh, device=CPU)
        res, coll = _count(lambda: step(params, tk, tg) if opt is None
                           else step(params, state, tk, tg))
        out["collectives"].append(coll)
        if opt is None:
            params, loss = res[0], res[1]
        else:
            params, state, loss = res[0], res[1], res[2]
        out["losses"].append(float(loss))
        if len(res) == (3 if opt is None else 4):
            out["blocks"].append({k: _np(v) for k, v in res[-1].items()})
    out["params"] = tree_to_numpy(params)
    out["specs"] = specs
    return out


def scenario_pp_lm(inp, mesh):
    """SGD steps of the staged LM through make_pp_loss, both schedules:
    the losses and this rank's stage (and the replicated leaves)."""
    from deeplearning4j_tpu_torch._device import tree_leaves, \
        tree_unflatten
    from deeplearning4j_tpu_torch.models import transformer_lm as T

    out = {}
    for overlap in (False, True):
        params = lm_params_from_numpy(inp["params"], CPU)
        trained, stage_fn = T.lm_params_to_pp_trained(
            params, mesh, inp["n_heads"], mesh.shape["pipe"],
            attn_impl=inp.get("attn_impl"))
        loss_fn = T.make_pp_loss(stage_fn, mesh, "pipe",
                                 batch_axis=inp.get("batch_axis"),
                                 overlap=overlap)
        toks, tgts = _t(inp["toks"]), _t(inp["tgts"])
        losses = []
        for _ in range(inp["steps"]):
            leaves = [x.detach().requires_grad_()
                      for x in tree_leaves(trained)]
            loss = loss_fn(tree_unflatten(trained, leaves), toks, tgts)
            grads = torch.autograd.grad(loss, leaves)
            trained = tree_unflatten(trained, [
                p.detach() - inp["lr"] * g for p, g in zip(leaves, grads)])
            losses.append(float(loss.detach()))
        out[overlap] = {"losses": losses,
                        "params": tree_to_numpy(
                            T.pp_trained_to_lm_params(trained))}
    return out


SCENARIOS = {name[len("scenario_"):]: fn for name, fn in
             list(globals().items()) if name.startswith("scenario_")}


def main(argv) -> int:
    rank, world, port, in_path, out_dir = argv
    rank, world = int(rank), int(world)
    with open(in_path, "rb") as f:
        inputs = pickle.load(f)
    results = {}
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device=CPU)
    try:
        for name in sorted(inputs):
            inp = inputs[name]
            mesh = pmesh.Mesh(*inp["mesh"])
            try:
                results[name] = SCENARIOS[inp["kind"]](inp, mesh)
            except Exception:  # reported per scenario, the rest still run
                results[name] = {"error": traceback.format_exc()}
            mesh.barrier()
    finally:
        multihost.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
