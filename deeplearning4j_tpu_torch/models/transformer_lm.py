"""Counterpart of ``deeplearning4j_tpu/models/transformer_lm.py``: the
single-device serving and training halves of the transformer LM with MoE
FFNs.

``n_layers`` causal decoder blocks (pre-LN multi-head attention + pre-LN
top-k MoE FFN, both with residuals) between an embedding and a vocab
decoder. The parameter tree is a plain nested dict with the JAX package's
keys and layouts: ``params["blocks"]`` leaves carry a leading (n_layers,
...) axis and weights are stored (in, out), so a JAX tree converted with
``interop.lm_params_from_numpy`` computes the same function here.

Serving paths:

- ``lm_prefill``: the full-prompt pass through the attention-core seam
  (``attn_impl``; on a CUDA tensor "flash"/"blockwise" launch the Hopper
  flash-attention kernel), returning every layer's projected K/V to seed a
  slot's cache page.
- ``lm_decode_step``: one token per slot attending over the per-slot KV
  cache with a position mask (plain torch; decode attention was never a
  TPU kernel).
- ``lm_verify_step`` / ``make_verify_step``: the same math for W tokens
  per slot, the speculative verify step of width k+1.
- ``lm_chunk_prefill`` / ``make_chunk_prefill_step``: one slot's W prompt
  tokens written at ``start``..``start + W - 1`` against the cache the
  slot already holds (chunked prefill and the prefix cache's suffix).
- ``draft_truncate_params`` / ``draft_distill_loss``: the speculative
  draft, cut from the flagship or distilled from it.

The cache is a fixed-size paged buffer ``{"k", "v"}`` with leaves of shape
(L, S, H, T_max, Dh). Where JAX returned a new cache, the port writes the
cache tensors IN PLACE (and returns the same dict): the serving engine
always rebinds, and in-place writes save a cache-sized copy per step.
``lax.scan`` over the layer stack becomes a Python loop over layer index.

Training: ``make_single_device_train_step`` builds the flagship's
single-device step (plain SGD, or the ``optimizer=`` seam's stateful
update, with the ``guard=`` and ``with_metrics=`` seams). Gradients come
from ``torch.autograd``; on a CUDA tensor the attention's backward runs on
the flash backward kernels through ``ops.flash_attention.FlashAttention``.

Composed parallelism (``parallel.mesh``, one rank per device over
``torch.distributed``): ``make_composed_train_step`` runs JAX's composed
step on a mesh of any subset of ("data", "sp", "expert"): batch rows over
"data", the sequence over "sp" (``ring_attention`` over the rank's
sequence block), experts over "expert" (``moe_apply``; each rank holds its
G experts). Each rank computes the loss and grads of its token shard
(``shard_lm_batch``; the ranks of one "expert" line hold the same shard
and compute the same), one all-reduce over the token axes carries the
router statistics after the forward, and one flat all-reduce over the
token axes sums the grads. ``lm_param_shardings``, ``shard_lm_params``,
``lm_update_sharding`` and ``init_lm_opt_state(mesh=)`` place the params
and the (ZeRO-sharded) optimizer state. ``make_pp_stages``/``make_pp_loss``
split the stack at layer boundaries into ``parallel.pipeline`` stages over
"pipe". A "model" axis replicates the LM over its ranks, as JAX's
``lm_param_shardings`` does (tensor parallelism of a
``MultiLayerNetwork`` is ``parallel/tensor_parallel.py``).

Every step builder takes ``profile=`` (a ``telemetry.xprofile``
``StepProfile`` of the first call, on ``step.step_profile``) and
``runprof=`` (the runtime profiler's phase timings), composed as
``maybe_runprof(maybe_profiled(step, ...))``; neither changes a number.
``tuned=`` adopts the autotuner's knobs (``tune/``): the blockwise tiles,
which pick K3f's key split on the card, and on the composed step the MoE
dispatch and capacity factor.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch._device import (
    DeviceLike,
    commit,
    resolve_device,
    tree_leaves,
    tree_map,
    tree_unflatten,
    tree_zip_map,
)
from deeplearning4j_tpu_torch.nn.layers.attention import (
    _layernorm,
    _merge_heads,
    _split_heads,
)
from deeplearning4j_tpu_torch.ops.activations import softmax
from deeplearning4j_tpu_torch.ops.flash_attention import (
    attention_core,
    resolve_attention_impl,
)
from deeplearning4j_tpu_torch.optimize.guardrails import (
    GuardConfig,
    guarded_sgd_update,
)
from deeplearning4j_tpu_torch.optimize.updaters import (
    OptimizerConfig,
    guarded_opt_update,
    init_opt_state,
    opt_update_shardmap,
)
from deeplearning4j_tpu_torch.parallel.mesh import (
    LeafShards,
    all_to_all_ad,
    flat_all_reduce,
    gather_rows_ad,
    sum_grads_ad,
)
from deeplearning4j_tpu_torch.parallel.moe import (
    _dropped_routes,
    _routing,
    load_balance_loss,
    moe_apply,
    resolve_moe_impl,
    route_shards,
    router_load_fraction,
)
from deeplearning4j_tpu_torch.parallel.ring_attention import ring_attention
from deeplearning4j_tpu_torch.telemetry.metrics import train_step_metrics

_NEG_INF = -1e30


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)


def _init_block(gen: torch.Generator, d_model: int, n_experts: int,
                d_ff: int) -> dict:
    s_d = 1.0 / (d_model ** 0.5)
    dev = gen.device
    return {
        "ln_g": torch.ones(d_model, device=dev),
        "ln_b": torch.zeros(d_model, device=dev),
        "wq": _normal(gen, (d_model, d_model)) * s_d,
        "wk": _normal(gen, (d_model, d_model)) * s_d,
        "wv": _normal(gen, (d_model, d_model)) * s_d,
        "wo": _normal(gen, (d_model, d_model)) * s_d,
        "ln2_g": torch.ones(d_model, device=dev),
        "ln2_b": torch.zeros(d_model, device=dev),
        "router": _normal(gen, (d_model, n_experts)) * s_d,
        "experts": {
            "w1": _normal(gen, (n_experts, d_model, d_ff)) * s_d,
            "b1": torch.zeros(n_experts, d_ff, device=dev),
            "w2": _normal(gen, (n_experts, d_ff, d_model)) / (d_ff ** 0.5),
            "b2": torch.zeros(n_experts, d_model, device=dev),
        },
    }


def init_lm_params(generator: torch.Generator, vocab: int, d_model: int,
                   n_heads: int, n_experts: int, d_ff: int,
                   n_layers: int = 1, *, device: DeviceLike = None) -> dict:
    """Embedding + ``n_layers`` stacked decoder blocks + vocab decoder, in
    f32, with the JAX package's scales. Draws from ``generator`` on the
    generator's own device, then moves the tree to ``device`` (CUDA unless
    the caller passes ``device="cpu"``). The numbers differ from JAX's
    threefry draws; parity tests convert JAX params with
    ``interop.lm_params_from_numpy`` instead."""
    dev = resolve_device(device)
    if d_model % n_heads:
        raise ValueError(f"d_model {d_model} % n_heads {n_heads} != 0")
    if n_layers < 1:
        raise ValueError(f"n_layers must be >= 1, got {n_layers}")
    s_d = 1.0 / (d_model ** 0.5)
    embed = _normal(generator, (vocab, d_model)) * 0.1
    dec_w = _normal(generator, (d_model, vocab)) * s_d
    blocks = [_init_block(generator, d_model, n_experts, d_ff)
              for _ in range(n_layers)]
    stacked = tree_map(
        lambda path, _: torch.stack([_get(b, path) for b in blocks]),
        blocks[0])
    params = {"embed": embed, "blocks": stacked, "dec_w": dec_w,
              "dec_b": torch.zeros(vocab, device=generator.device)}
    return tree_map(lambda _, x: x.to(dev), params)


def _get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _layer(blocks: dict, i: int) -> dict:
    """Layer ``i``'s params from the stacked (L, ...) block tree."""
    return tree_map(lambda _, x: x[i], blocks)


def lm_n_layers(params: dict) -> int:
    return tree_leaves(params["blocks"])[0].shape[0]


def expert_fn(p: dict, t: torch.Tensor) -> torch.Tensor:
    """Every expert's FFN on the (C, d) tokens: stacked (E, ...) expert
    params give (E, C, d), one batched product per matrix (the JAX
    package vmaps its one-expert function over the expert axis)."""
    return (torch.relu(t @ p["w1"] + p["b1"][:, None, :]) @ p["w2"]
            + p["b2"][:, None, :])


def dense_moe(router_w: torch.Tensor, experts: dict, x: torch.Tensor,
              top_k: int = 2) -> torch.Tensor:
    """Single-device MoE: every expert on every token, gate-combined, no
    capacity drops. ``jax.vmap`` over experts becomes the expert axis of a
    batched product. The one-hot gate matrix is f32 as in JAX (f64 for f64
    inputs), so the combine runs (and returns) in f32."""
    acc = torch.promote_types(x.dtype, torch.float32)
    idx, gates = _routing(x @ router_w, top_k)
    y_all = expert_fn(experts, x)                      # (E, N, d)
    n_experts = router_w.shape[1]
    onehot = F.one_hot(idx, n_experts).to(acc)         # (N, k, E)
    g = torch.sum(gates[..., None] * onehot, dim=1)    # (N, E) f32
    return torch.einsum("ne,end->nd", g, y_all.to(acc))


def _attn_block(params: dict, h: torch.Tensor, n_heads: int,
                attn_core) -> torch.Tensor:
    hn = _layernorm(h, params["ln_g"], params["ln_b"])
    q = _split_heads(hn @ params["wq"], n_heads)
    k = _split_heads(hn @ params["wk"], n_heads)
    v = _split_heads(hn @ params["wv"], n_heads)
    return h + _merge_heads(attn_core(q, k, v)) @ params["wo"]


def _decoder_block(layer_params: dict, h: torch.Tensor, n_heads: int,
                   attn_core, moe_fn) -> tuple:
    """One decoder block on (B, T, d) → (h, moe_in) with moe_in the
    (B·T, d) pre-MoE activations."""
    h = _attn_block(layer_params, h, n_heads, attn_core)
    h2 = _layernorm(h, layer_params["ln2_g"], layer_params["ln2_b"])
    flat = h2.reshape(-1, h2.shape[-1])
    moe_out = moe_fn(layer_params["router"], layer_params["experts"], flat)
    return h + moe_out.reshape(h.shape), flat


def lm_forward(params: dict, tokens: torch.Tensor, n_heads: int, attn_core,
               moe_fn) -> tuple:
    """tokens: (B, T) integer → (logits (B, T, V), moe_in (L, B·T, d)).
    ``attn_core(q, k, v) -> out`` and ``moe_fn(router_w, experts, flat)``
    supply the attention and FFN strategies."""
    h = params["embed"][tokens.long()]
    moe_ins = []
    for i in range(lm_n_layers(params)):
        h, flat = _decoder_block(_layer(params["blocks"], i), h, n_heads,
                                 attn_core, moe_fn)
        moe_ins.append(flat)
    logits = h @ params["dec_w"] + params["dec_b"]
    return logits, torch.stack(moe_ins)


def _task_and_aux(params: dict, tokens: torch.Tensor,
                  targets: torch.Tensor, n_heads: int, attn_core,
                  moe_fn) -> tuple:
    """(task, aux, moe_ins): next-token cross-entropy, the mean over layers
    of the load-balance aux, and the (L, B·T, d) pre-MoE activations."""
    logits, moe_ins = lm_forward(params, tokens, n_heads, attn_core, moe_fn)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    routers = params["blocks"]["router"]
    aux = torch.stack([load_balance_loss(routers[i], moe_ins[i])
                       for i in range(moe_ins.shape[0])]).mean()
    return nll.mean(), aux, moe_ins


def lm_loss(params: dict, tokens: torch.Tensor, targets: torch.Tensor,
            n_heads: int, attn_core, moe_fn,
            aux_weight: float = 1e-2) -> torch.Tensor:
    """Next-token softmax cross-entropy + the Switch load-balance aux
    (averaged over layers, so the weight is depth-independent)."""
    task, aux, _ = _task_and_aux(params, tokens, targets, n_heads,
                                 attn_core, moe_fn)
    return task + aux_weight * aux


def lm_loss_and_metrics(params: dict, tokens: torch.Tensor,
                        targets: torch.Tensor, n_heads: int, attn_core,
                        moe_fn, aux_weight: float = 1e-2,
                        top_k: int = 2) -> tuple:
    """``lm_loss`` with a metrics dict: (loss, metrics). The loss is the
    same op sequence as ``lm_loss``; the metrics only read intermediates:
    the task/aux split and the per-expert router-load fraction (mean over
    layers; sums to 1)."""
    task, aux, moe_ins = _task_and_aux(params, tokens, targets, n_heads,
                                       attn_core, moe_fn)
    loss = task + aux_weight * aux
    routers = params["blocks"]["router"]
    with torch.no_grad():
        load = torch.stack([router_load_fraction(routers[i], moe_ins[i],
                                                 top_k)
                            for i in range(moe_ins.shape[0])]).mean(0)
    metrics = {"task_loss": task.detach(), "aux_loss": aux.detach(),
               "router_load": load}
    return loss, metrics


def selected_attn_impl(seq_len: int, attn_impl: Optional[str] = None,
                       head_dim: Optional[int] = None) -> str:
    """The attention core a step with this sequence length (and head dim,
    where given) will run: per-call arg > global/env override > auto shape
    gate."""
    return attn_impl or resolve_attention_impl(seq_len, head_dim)


def dense_loss_fn(n_heads: int, top_k: int = 2, aux_weight: float = 1e-2,
                  attn_impl: Optional[str] = None,
                  with_metrics: bool = False,
                  attn_blocks: Optional[tuple] = None):
    """Single-device loss (dense MoE; attention through the core seam).
    ``attn_impl=None`` auto-gates by shape: the flash kernels for long T,
    dense for short. ``with_metrics`` swaps in the (loss, metrics) twin.
    ``attn_blocks=(block_q, block_k)`` are the blockwise core's tiles, the
    autotuner's knob: on the card they pick K3f's key split
    (``ops.flash_attention.key_split_for``); the dense and flash cores
    ignore them. Returns ``loss_fn(params, tokens, targets)``."""
    bq, bk = attn_blocks or (None, None)

    def attn_core(q, k, v):
        return attention_core(q, k, v, causal=True, impl=attn_impl,
                              block_q=bq, block_k=bk)

    def moe_fn(rw, ex, x):
        return dense_moe(rw, ex, x, top_k)

    if with_metrics:
        return partial(lm_loss_and_metrics, n_heads=n_heads,
                       attn_core=attn_core, moe_fn=moe_fn,
                       aux_weight=aux_weight, top_k=top_k)
    return partial(lm_loss, n_heads=n_heads, attn_core=attn_core,
                   moe_fn=moe_fn, aux_weight=aux_weight)


def lm_value_and_grad(loss_fn, params: dict, tokens, targets,
                      has_aux: bool = False) -> tuple:
    """``jax.value_and_grad(loss_fn[, has_aux])(params, tokens, targets)``
    by torch.autograd: ``(loss, grads)`` or ``((loss, aux), grads)``, with
    grads a tree shaped like ``params``. Every param leaf is a leaf of the
    graph (a detached alias, so the caller's tensors gain no grad state)."""
    leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
    with torch.enable_grad():
        out = loss_fn(tree_unflatten(params, leaves), tokens, targets)
        loss = out[0] if has_aux else out
        grads = torch.autograd.grad(loss, leaves)
    loss = loss.detach()
    value = (loss, out[1]) if has_aux else loss
    return value, tree_unflatten(params, list(grads))


def init_lm_opt_state(optimizer, params: dict, mesh=None, *,
                      device: DeviceLike = None) -> dict:
    """The optimizer state the optimizer-threaded steps expect: ``{"m",
    "v", "count"}`` with zero moments like the params (replicated mode),
    or this rank's ``(1, chunk)`` rows of the dp-partitioned ZeRO layout
    (sharded mode, ``mesh`` required), on the mesh's device or ``device``
    (CUDA unless ``device="cpu"``)."""
    cfg = OptimizerConfig.coerce(optimizer)
    if cfg is None:
        raise ValueError("init_lm_opt_state needs an optimizer "
                         "(name or OptimizerConfig)")
    zero = None
    if cfg.sharded:
        if mesh is None:
            raise ValueError(
                "update_sharding='sharded' needs a mesh with a dp axis — "
                "single-device steps run the replicated update")
        zero = lm_update_sharding(mesh)
    dev = _mesh_device(mesh, device)
    return init_opt_state(cfg, tree_map(lambda _, x: x.to(dev), params),
                          zero)


def _loss_and_grads(loss_fn, params, tokens, targets, dev,
                    with_metrics: bool) -> tuple:
    """(loss, metrics or None, grads) with the batch moved to ``dev``."""
    value, grads = lm_value_and_grad(
        loss_fn, params, torch.as_tensor(tokens, device=dev),
        torch.as_tensor(targets, device=dev), has_aux=with_metrics)
    loss, metrics = value if with_metrics else (value, None)
    return loss, metrics, grads


def _seam(step, profile, runprof, label: str):
    """``profile=`` then ``runprof=``: the runtime profiler reuses the
    profiled call's FLOPs and collectives."""
    from deeplearning4j_tpu_torch.telemetry.runprof import maybe_runprof
    from deeplearning4j_tpu_torch.telemetry.xprofile import maybe_profiled

    return maybe_runprof(maybe_profiled(step, profile, label), runprof,
                         label)


def _make_sgd_step(loss_fn, lr: float, with_metrics: bool, dev,
                   donate: bool = False, guard=None,
                   loss_and_grads=_loss_and_grads, shards=None,
                   profile=None, profile_label: str = "lm_step",
                   runprof=None):
    """The SGD step: ``step(params, tokens, targets) -> (new_params, loss)``,
    plus the guard block (``guard``) or the metrics dict
    (``with_metrics``, guard block merged in) as a third output.
    ``loss_and_grads`` is ``_loss_and_grads``' contract (the composed
    step passes its own); ``shards`` (``parallel.mesh.LeafShards``) makes
    the norms global where leaves are split over the mesh. ``profile``
    and ``runprof`` arm the seams under ``profile_label``."""
    def step(params, tokens, targets):
        loss, metrics, grads = loss_and_grads(loss_fn, params, tokens,
                                              targets, dev, with_metrics)
        with torch.no_grad():
            if guard is None:
                new_params = tree_zip_map(lambda p, g: p - lr * g, params,
                                          grads)
                block = None
            else:
                new_params, block = guarded_sgd_update(params, grads, loss,
                                                       lr, guard, shards)
            if with_metrics:
                block = {**metrics,
                         **train_step_metrics(params, grads, lr, loss=loss,
                                              shards=shards),
                         **(block or {})}
        new_params = commit(params, new_params, donate)
        if block is None:
            return new_params, loss
        return new_params, loss, block

    return _seam(step, profile, runprof, profile_label)


def _make_opt_step(loss_fn, lr: float, with_metrics: bool,
                   optimizer: OptimizerConfig, dev, donate: bool = False,
                   guard=None, zero=None, loss_and_grads=_loss_and_grads,
                   shards=None, profile=None,
                   profile_label: str = "lm_step", runprof=None):
    """The optimizer-threaded step: ``step(params, opt_state, tokens,
    targets) -> (new_params, new_opt_state, loss[, metrics/guard
    block])``. The loss and grads are the SGD step's; only the update
    differs (``zero``: the ZeRO-sharded update; ``shards`` as in
    ``_make_sgd_step``). With ``donate`` the params and moments are
    updated in place."""
    def step(params, opt_state, tokens, targets):
        loss, metrics, grads = loss_and_grads(loss_fn, params, tokens,
                                              targets, dev, with_metrics)
        with torch.no_grad():
            if guard is None:
                out = opt_update_shardmap(optimizer, params, grads,
                                          opt_state, lr, zero,
                                          with_metrics=with_metrics,
                                          shards=shards)
            else:
                out = guarded_opt_update(params, grads, opt_state, loss, lr,
                                         optimizer, guard,
                                         with_metrics=with_metrics,
                                         zero=zero, shards=shards)
            new_params, new_state = out[0], out[1]
            block = out[2] if len(out) == 3 else None
            if with_metrics:
                # the optimizer block LAST: its true ‖Δp‖/‖p‖ update_ratio
                # overrides the lr·‖g‖ SGD proxy of train_step_metrics
                block = {**metrics,
                         **train_step_metrics(params, grads, lr, loss=loss,
                                              shards=shards),
                         **block}
        new_params = commit(params, new_params, donate)
        new_state = commit(opt_state, new_state, donate)
        if block is None:
            return new_params, new_state, loss
        return new_params, new_state, loss, block

    return _seam(step, profile, runprof, profile_label)


def _tuned_blocks(tuning: dict) -> Optional[tuple]:
    """The adopted ``flash_attention`` knobs as ``attn_blocks``, or None."""
    if "block_q" not in tuning:
        return None
    return int(tuning["block_q"]), int(tuning["block_k"])


def make_single_device_train_step(n_heads: int, lr: float = 0.1,
                                  top_k: int = 2, aux_weight: float = 1e-2,
                                  attn_impl: Optional[str] = None,
                                  with_metrics: bool = False,
                                  donate: bool = False, guard=None,
                                  profile=None, optimizer=None,
                                  runprof=None, tuned=None,
                                  tune_context=None, *,
                                  device: DeviceLike = None):
    """The flagship's single-device train step (the parity oracle with
    ``attn_impl="dense"``; the single-chip training path with the default
    auto core, which sends T >= 1024 through the flash kernels).

    Plain SGD: ``step(params, tokens, targets) -> (params, loss)``. With
    ``guard=`` (True or a ``GuardConfig``) a third output carries the guard
    block; with ``with_metrics`` it carries the metrics dict (guard block
    merged in). With ``optimizer=`` (a name or an ``OptimizerConfig``) the
    step carries the state from ``init_lm_opt_state``:
    ``step(params, opt_state, tokens, targets) -> (params, opt_state,
    loss[, block])``; ``update_sharding="sharded"`` is rejected, as there
    are no replicas to shard the update over.

    ``donate=True`` writes the new params (and moments) into the incoming
    tensors in place and returns them: callers rebind, as they do with
    JAX's donated buffers. The default returns new tensors and leaves the
    inputs untouched. Tokens and targets (tensors or arrays) are moved to
    ``device`` (CUDA unless ``device="cpu"``), where the params must be.

    ``profile=`` (True or a label) captures the first call's
    ``StepProfile`` on ``step.step_profile``; ``runprof=`` (True, a label
    or a ``RunProfiler``) phase-times every call; both under the label
    ``lm_single_device``, as in JAX.

    ``tuned=`` adopts the autotuner's ``flash_attention`` seam
    (``block_q``/``block_k``, the blockwise tiles, which pick K3f's key
    split): an explicit config dict wins, ``True`` consults the tuning
    cache under ``tune_context`` (a ``tune.seams.lm_context`` dict), the
    default ``None`` consults it only when ``DL4J_TPU_TUNED`` is set
    (``tune.cache.resolve_step_tuning``). Every split is within 1e-5 of
    the default (tests/test_torch_tune.py)."""
    from deeplearning4j_tpu_torch.tune.cache import resolve_step_tuning

    tuning = resolve_step_tuning(tuned, tune_context, ("flash_attention",))
    attn_blocks = _tuned_blocks(tuning)
    dev = resolve_device(device)
    loss_fn = dense_loss_fn(n_heads, top_k, aux_weight, attn_impl=attn_impl,
                            with_metrics=with_metrics,
                            attn_blocks=attn_blocks)
    guard_cfg = GuardConfig.coerce(guard)
    opt_cfg = OptimizerConfig.coerce(optimizer)
    seams = {"profile": profile, "runprof": runprof,
             "profile_label": "lm_single_device"}
    if opt_cfg is None:
        return _make_sgd_step(loss_fn, lr, with_metrics, dev, donate=donate,
                              guard=guard_cfg, **seams)
    if opt_cfg.sharded:
        raise ValueError(
            "update_sharding='sharded' needs a dp mesh axis — the "
            "single-device step has no replicas to shard the update over")
    return _make_opt_step(loss_fn, lr, with_metrics, opt_cfg.resolved(), dev,
                          donate=donate, guard=guard_cfg, **seams)


# ------------------------------------------------- composed parallelism ----

DATA_AXIS = "data"
SEQ_AXIS = "sp"
EXPERT_AXIS = "expert"
MODEL_AXIS = "model"
_COMPOSED_AXES = (DATA_AXIS, SEQ_AXIS, EXPERT_AXIS, MODEL_AXIS)


def _check_composed_mesh(mesh) -> None:
    """A mesh the composed step runs: any subset of ("data", "sp",
    "expert", "model"). As in JAX, whose ``lm_param_shardings`` places
    nothing on "model", the params are replicated over "model": each of
    its ranks computes its (data, sp) shard's work, and every sum runs
    over the token axes alone."""
    other = [a for a in mesh.axis_names if a not in _COMPOSED_AXES]
    if other or not mesh.axis_names:
        raise NotImplementedError(
            f"the composed step runs meshes over {_COMPOSED_AXES}, got "
            f"{tuple(mesh.axis_names)}: 'pipe' runs through "
            "make_pp_stages and make_pp_loss")


def _token_axes(mesh) -> tuple:
    """The axes the tokens split over: "data" (rows), "sp" (sequence)."""
    return tuple(a for a in (DATA_AXIS, SEQ_AXIS) if a in mesh.axis_names)


def _token_shards(mesh) -> int:
    n = 1
    for a in _token_axes(mesh):
        n *= int(mesh.shape[a])
    return n


def _mesh_device(mesh, device: DeviceLike) -> torch.device:
    """The rank's device: the mesh's (a process group's rank) when it has
    one, else ``device`` (CUDA unless ``device="cpu"``)."""
    if mesh is not None and getattr(mesh, "device", None) is not None:
        dev = mesh.device
        if device is not None and resolve_device(device).type != dev.type:
            raise ValueError(
                f"this rank's mesh device is {dev}, not {device}: the "
                "process group's backend decides the device")
        return dev
    return resolve_device(device)


def _is_expert_leaf(path: tuple) -> bool:
    return "experts" in path


def lm_param_shardings(params: dict, mesh) -> dict:
    """Per-leaf sharding specs (``parallel/sharding.py``'s tuples, ``()``
    = replicated) for the flagship params on ``mesh``: the experts sit on
    axis 1 of the block leaves, ``(None, "expert")``, when the mesh has an
    "expert" axis; every other leaf is replicated. Raises when the experts
    do not split over the axis, as JAX's does."""
    names = mesh.axis_names
    if EXPERT_AXIS in names:
        n_experts = params["blocks"]["experts"]["w1"].shape[1]
        ep = mesh.shape[EXPERT_AXIS]
        if n_experts % ep:
            raise ValueError(
                f"{n_experts} experts do not shard over the {ep}-device "
                f"{EXPERT_AXIS!r} axis — grouped layout needs "
                "n_experts % axis size == 0")
        espec = (None, EXPERT_AXIS)
    else:
        espec = ()
    return tree_map(lambda path, _: espec if _is_expert_leaf(path) else (),
                    params)


def shard_lm_params(params: dict, mesh, *, device: DeviceLike = None) -> dict:
    """Place the params per ``lm_param_shardings`` on this rank's device:
    replicated leaves whole, expert leaves as this rank's contiguous group
    of G = E / ep experts on axis 1 of the (L, E, ...) block leaves.
    Nothing is broadcast (as in JAX, where ``device_put`` copies the
    caller's values): every rank passes the same params."""
    specs = lm_param_shardings(params, mesh)
    dev = _mesh_device(mesh, device)
    ep = int(mesh.shape.get(EXPERT_AXIS, 1))
    e = int(mesh.coords.get(EXPERT_AXIS, 0))

    def place(path, x):
        x = torch.as_tensor(x)
        if _get(specs, path):
            g = x.shape[1] // ep
            x = x[:, e * g:(e + 1) * g]
        return x.to(dev)

    return tree_map(place, params)


def shard_lm_batch(tokens, targets, mesh, *,
                   device: DeviceLike = None) -> tuple:
    """This rank's block of the global (B, T) ``tokens`` and ``targets``
    (arrays or tensors), on its device: rows ``[r·B/R, (r+1)·B/R)`` over
    "data" and columns ``[s·T/S, (s+1)·T/S)`` over "sp", what
    ``P("data", "sp")`` places on the rank. A dim that does not split
    raises ``ValueError``, as JAX's ``device_put`` does."""
    dev = _mesh_device(mesh, device)
    out = []
    for a in (tokens, targets):
        part = a
        for dim, axis in ((0, DATA_AXIS), (1, SEQ_AXIS)):
            if axis not in mesh.axis_names:
                continue
            n, r = int(mesh.shape[axis]), int(mesh.coords[axis])
            size = part.shape[dim]
            if size % n:
                what = "batch of" if dim == 0 else "sequence of"
                unit = "rows" if dim == 0 else "tokens"
                raise ValueError(
                    f"a {what} {size} {unit} does not split over the {n} "
                    f"ranks of the {axis!r} axis")
            k = size // n
            part = part[r * k:(r + 1) * k] if dim == 0 else \
                part[:, r * k:(r + 1) * k]
        out.append(torch.as_tensor(np.asarray(part) if not isinstance(
            part, torch.Tensor) else part).to(dev))
    return tuple(out)


def lm_update_sharding(mesh):
    """The flagship's ZeRO update-sharding descriptor on ``mesh``
    (optimize/updaters.ZeroSharding): moments shard over the "data" axis;
    expert leaves keep their (layer, expert) prefix, so the dp shard nests
    inside this rank's expert group."""
    from deeplearning4j_tpu_torch.optimize.updaters import ZeroSharding

    names = mesh.axis_names
    if DATA_AXIS not in names:
        raise ValueError(
            f"update_sharding='sharded' needs the {DATA_AXIS!r} axis on "
            f"the mesh (got {names}) — there is no dp axis to shard the "
            "update over")
    if EXPERT_AXIS in names:
        def prefix_fn(ks):
            return (None, EXPERT_AXIS) if "['experts']" in ks else ()
    else:
        def prefix_fn(ks):
            return ()
    return ZeroSharding(mesh, DATA_AXIS, prefix_fn)


def _lm_shards(mesh) -> Optional[LeafShards]:
    """Expert leaves split over "expert" (None: no expert axis)."""
    if EXPERT_AXIS not in mesh.axis_names:
        return None
    return LeafShards(mesh, lambda path: (EXPERT_AXIS,)
                      if _is_expert_leaf(path) else ())


def selected_moe_impl(mesh, n_tokens: int,
                      moe_impl: Optional[str] = None) -> Optional[str]:
    """The MoE dispatch a composed step with this GLOBAL token count will
    run: per-call arg > set_moe_impl/env override > auto divisibility
    gate; None on meshes without an expert axis (dense MoE)."""
    if EXPERT_AXIS not in mesh.axis_names:
        return None
    return resolve_moe_impl(n_tokens,
                            _token_shards(mesh) * mesh.shape[EXPERT_AXIS],
                            moe_impl)


def _router_stats(router_w: torch.Tensor, x: torch.Tensor, top_k: int):
    """One layer's (f, P, load) over this rank's tokens: the top-1
    fractions (no gradient through the argmax), the mean router
    probability (differentiable) and the top-k route fractions."""
    logits = x @ router_w
    n_experts = router_w.shape[1]
    f = F.one_hot(logits.argmax(-1), n_experts).to(
        torch.promote_types(logits.dtype, torch.float32)).mean(0)
    load = router_load_fraction(router_w, x, top_k)
    return f, softmax(logits).mean(0), load


def _to_row_chunks(mesh, x: torch.Tensor, shape: tuple) -> torch.Tensor:
    """This rank's (B_l·T_l, d) tokens, a (rows, sequence block) block of
    its data shard, → the data shard's row-major token stream's chunk at
    this rank's "sp" index: the tokens JAX's GSPMD layout gives the MoE's
    sub-shards. One all-to-all over "sp"."""
    b, t, sp = shape[0], shape[1], mesh.shape[SEQ_AXIS]
    d = x.shape[-1]
    send = x.reshape(sp, b // sp, t, d)
    got = all_to_all_ad(mesh, send, SEQ_AXIS)        # (src, B_l/sp, T_l, d)
    return got.permute(1, 0, 2, 3).reshape(b // sp * sp * t, d)


def _from_row_chunks(mesh, y: torch.Tensor, shape: tuple) -> torch.Tensor:
    """The inverse of ``_to_row_chunks``."""
    b, t, sp = shape[0], shape[1], mesh.shape[SEQ_AXIS]
    d = y.shape[-1]
    send = y.reshape(b // sp, sp, t, d).permute(1, 0, 2, 3)
    got = all_to_all_ad(mesh, send, SEQ_AXIS)        # (src, B_l/sp, T_l, d)
    return got.reshape(b * t, d)


def composed_loss_fn(mesh, n_heads: int, capacity: int = 0, top_k: int = 2,
                     aux_weight: float = 1e-2,
                     attn_impl: Optional[str] = None,
                     moe_impl: Optional[str] = None,
                     with_metrics: bool = False,
                     ring_prefetch: bool = True,
                     attn_blocks: Optional[tuple] = None):
    """The loss of JAX's composed step, computed from this rank's token
    shard: ``loss_fn(params, tokens, targets) -> (loss_r, info)``.
    ``attn_blocks=(block_q, block_k)`` reach the unsharded attention core
    only, as in JAX: the ring's pairs keep K3f's own launch rule.

    "sp" runs the attention as ``ring_attention`` over the rank's sequence
    block (``attn_impl`` forces its per-pair core, ``ring_prefetch`` its
    rotation order); "expert" runs the FFN as ``moe_apply`` over
    ``token_axes`` ("alltoall" | "alltoall_2d" | "replicated" by
    ``moe_impl``, else the auto chain on the global token count), with the
    rank's expert group. With "sp" too, the MoE's tokens first move to the
    layout GSPMD gives JAX's flat token stream (``_to_row_chunks``: each
    "sp" rank takes a contiguous run of whole rows of its data shard, one
    all-to-all each way, which needs the shard's rows to divide over
    "sp"), so capacity drops the same routes as JAX's.

    JAX's load-balance aux is global: its means run over the WHOLE batch.
    Each rank's forward ends with ONE all-reduce over the token axes of
    every layer's top-1 fractions ``f`` and mean router probabilities
    ``P`` (and the task loss, the router load and, with an expert axis,
    the dropped routes), and the rank differentiates the surrogate
    ``loss_r = task_r + w·mean_l E·Σ_e f̄_e·P_e^(r)`` with ``f̄`` the token
    shards' mean fractions (no gradient, like JAX's argmax). The mean over
    token shards of ``loss_r`` is JAX's loss, and so is the mean of its
    gradients. ``info["loss"]`` is the global loss itself; with
    ``with_metrics`` ``info`` also holds the global ``task_loss``,
    ``aux_loss``, ``router_load`` and, with an expert axis,
    ``moe_dropped_frac`` (the capacity overflow share under the resolved
    dispatch's sub-shards)."""
    _check_composed_mesh(mesh)
    names = mesh.axis_names
    tok_axes = _token_axes(mesh)
    n_tok = _token_shards(mesh)
    has_ep = EXPERT_AXIS in names
    relayout = has_ep and SEQ_AXIS in names and mesh.shape[SEQ_AXIS] > 1
    bq, bk = attn_blocks or (None, None)

    def attn_core(q, k, v):
        if SEQ_AXIS in names:
            return ring_attention(
                q, k, v, mesh, SEQ_AXIS, causal=True,
                batch_axis=DATA_AXIS if DATA_AXIS in names else None,
                attn_impl=attn_impl, prefetch=ring_prefetch)
        return attention_core(q, k, v, causal=True, impl=attn_impl,
                              block_q=bq, block_k=bk)

    def loss_fn(params, tokens, targets):
        shape = tuple(tokens.shape)
        n_global = shape[0] * shape[1] * n_tok
        if relayout and shape[0] % mesh.shape[SEQ_AXIS]:
            raise ValueError(
                f"with 'sp' and 'expert' on the mesh the MoE takes whole "
                f"rows: the {shape[0]} rows of a data shard do not divide "
                f"over the {mesh.shape[SEQ_AXIS]} ranks of 'sp'")
        routed = []     # each layer's MoE tokens, in JAX's layout

        def moe_fn(rw, ex, x):
            if not has_ep:
                return dense_moe(rw, ex, x, top_k)
            xj = _to_row_chunks(mesh, x, shape) if relayout else x
            routed.append(xj.detach())
            out = moe_apply(rw, ex, xj, mesh, expert_fn, capacity,
                            top_k=top_k, token_axes=tok_axes, impl=moe_impl)
            return _from_row_chunks(mesh, out, shape) if relayout else out

        logits, moe_ins = lm_forward(params, tokens, n_heads, attn_core,
                                     moe_fn)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
        task = nll.mean()
        routers = params["blocks"]["router"]
        stats = [_router_stats(routers[i], moe_ins[i], top_k)
                 for i in range(moe_ins.shape[0])]
        f = torch.stack([s[0] for s in stats])          # (L, E)
        p_mean = torch.stack([s[1] for s in stats])     # (L, E)
        load = torch.stack([s[2] for s in stats]).mean(0)
        parts = [f, p_mean.detach(), load, task.detach()]
        if has_ep:
            # this token shard's sub-shards under the resolved dispatch
            n_sub = route_shards(mesh, tok_axes, EXPERT_AXIS, n_global,
                                 moe_impl) // n_tok
            parts.append(torch.stack([
                _dropped_routes(routers[i].detach(), xj, capacity, top_k,
                               n_sub) for i, xj in enumerate(routed)]))
        summed = flat_all_reduce(mesh, parts, tok_axes)
        f_bar, p_bar = summed[0] / n_tok, summed[1] / n_tok
        n_experts = f.shape[1]
        aux_r = (n_experts * (f_bar * p_mean).sum(-1)).mean()
        loss_r = task + aux_weight * aux_r
        with torch.no_grad():
            task_g = summed[3] / n_tok
            aux_g = (n_experts * (f_bar * p_bar).sum(-1)).mean()
            info = {"loss": task_g + aux_weight * aux_g}
            if with_metrics:
                info.update(task_loss=task_g, aux_loss=aux_g,
                            router_load=summed[2] / n_tok)
                if has_ep:
                    info["moe_dropped_frac"] = (
                        summed[4] / (n_global * top_k)).mean()
        return loss_r, info

    return loss_fn


def _composed_loss_and_grads(loss_fn, params, tokens, targets, dev,
                             with_metrics: bool, mesh=None) -> tuple:
    """``_loss_and_grads``' contract for ``composed_loss_fn``: this rank's
    surrogate differentiated, then the grads summed over the token axes in
    one flat all-reduce and divided by the number of token shards — the
    global batch's gradient on every rank (expert leaves: this rank's
    experts') — with the global loss and metrics."""
    leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
    with torch.enable_grad():
        loss_r, info = loss_fn(tree_unflatten(params, leaves),
                               torch.as_tensor(tokens, device=dev),
                               torch.as_tensor(targets, device=dev))
        grads = torch.autograd.grad(loss_r, leaves)
    n_tok = _token_shards(mesh)
    grads = [g / n_tok for g in flat_all_reduce(mesh, list(grads),
                                                _token_axes(mesh))]
    loss = info.pop("loss")
    return loss, (info if with_metrics else None), \
        tree_unflatten(params, grads)


def make_composed_train_step(mesh, n_heads: int, capacity: int = 0,
                             lr: float = 0.1, top_k: int = 2,
                             aux_weight: float = 1e-2,
                             attn_impl: Optional[str] = None,
                             moe_impl: Optional[str] = None,
                             with_metrics: bool = False,
                             donate: bool = False, guard=None,
                             profile=None, optimizer=None,
                             ring_prefetch: bool = True, runprof=None,
                             tuned=None, tune_context=None, *,
                             device: DeviceLike = None):
    """JAX's composed train step on a mesh of any subset of ("data", "sp",
    "expert", "model"), over the ranks of the process group (the params
    replicated over "model", as JAX's ``lm_param_shardings`` places
    them).

    ``step(params, tokens, targets) -> (new_params, loss)`` with SGD, or
    ``step(params, opt_state, tokens, targets) -> (new_params,
    new_opt_state, loss)`` with ``optimizer=`` (state from
    ``init_lm_opt_state``; ``update_sharding="sharded"`` runs the ZeRO
    update over "data", each rank its ``1/dp`` chunk, and all-gathers the
    params). ``tokens``/``targets`` are this rank's block, as
    ``shard_lm_batch`` returns it; ``params`` are this rank's
    (``shard_lm_params``: its expert group with an "expert" axis). The
    outputs match ``make_single_device_train_step``'s, and the loss, the
    metrics (``with_metrics``: the global task/aux split, router load,
    ``moe_dropped_frac`` and the norms of the reduced grads over every
    expert) and the guard's decision (``guard=``) are the same on every
    rank. ``capacity`` bounds the routes per (expert, sub-shard) of the
    MoE dispatch (``moe_impl``); ``attn_impl`` forces the attention core,
    the ring's per-pair core under "sp"; ``ring_prefetch`` the ring's
    rotation order (bit-identical values).

    Collectives a step (``parallel.mesh.COLLECTIVES``) on a ("data",)
    mesh: SGD and the replicated optimizer make 2 all-reduces (the
    forward's router statistics and the grads); the ZeRO-sharded update
    adds 1 all-gather, LAMB's norms an all-reduce each and the sharded
    metrics block one. "sp" adds the ring's exchanges and, with "expert",
    the MoE's two all-to-alls over "sp" each way; "expert" adds the
    dispatch's collectives per layer (``parallel/moe.py``) and one
    all-reduce per norm of the guard and metrics.

    On the card each rank's attention runs the flash kernels (the ring's
    pairs through K3f, K3k, K3q). ``device`` (CUDA unless
    ``device="cpu"``) is the rank's device when the mesh has none.
    ``profile=`` and ``runprof=`` arm the seams under JAX's label
    ``lm_composed[<axes>]`` (the profile records the step's collectives).

    ``tuned=`` adopts the autotuner's knobs as JAX's does: an explicit
    config dict wins, ``True`` consults the tuning cache under
    ``tune_context`` (a ``tune.seams.lm_context`` dict), the default
    ``None`` consults it only when ``DL4J_TPU_TUNED`` is set. Adopted:
    ``block_q``/``block_k`` (the unsharded core's tiles: K3f's key split),
    ``moe_impl`` (only when the ``moe_impl=`` arg is None: an explicit arg
    outranks the cache) and ``capacity_factor`` (scales ``capacity`` by
    ceil, >= 1.0)."""
    from deeplearning4j_tpu_torch.tune.cache import resolve_step_tuning

    _check_composed_mesh(mesh)
    tuning = resolve_step_tuning(tuned, tune_context,
                                 ("flash_attention", "moe"))
    attn_blocks = _tuned_blocks(tuning)
    if moe_impl is None:
        moe_impl = tuning.get("moe_impl")
    capacity = int(math.ceil(
        capacity * float(tuning.get("capacity_factor", 1.0))))
    dev = _mesh_device(mesh, device)
    loss_fn = composed_loss_fn(mesh, n_heads, capacity, top_k, aux_weight,
                               attn_impl=attn_impl, moe_impl=moe_impl,
                               with_metrics=with_metrics,
                               ring_prefetch=ring_prefetch,
                               attn_blocks=attn_blocks)
    grads_fn = partial(_composed_loss_and_grads, mesh=mesh)
    guard_cfg = GuardConfig.coerce(guard)
    shards = _lm_shards(mesh)
    seams = {"profile": profile, "runprof": runprof,
             "profile_label": "lm_composed[" + "x".join(mesh.axis_names)
             + "]"}
    opt_cfg = OptimizerConfig.coerce(optimizer)
    if opt_cfg is None:
        return _make_sgd_step(loss_fn, lr, with_metrics, dev, donate=donate,
                              guard=guard_cfg, loss_and_grads=grads_fn,
                              shards=shards, **seams)
    opt_cfg = opt_cfg.resolved()
    zero = lm_update_sharding(mesh) if opt_cfg.sharded else None
    return _make_opt_step(loss_fn, lr, with_metrics, opt_cfg, dev,
                          donate=donate, guard=guard_cfg, zero=zero,
                          loss_and_grads=grads_fn, shards=shards, **seams)


# ----------------------------------------------------------------- dp×pp ----

def make_pp_stages(params: dict, n_heads: int, n_stages: int = 2,
                   top_k: int = 2, attn_impl: Optional[str] = None,
                   moe_fn=None):
    """Split the decoder stack at LAYER BOUNDARIES into ``n_stages``
    pipeline stages: stage i owns layers [i·L/S, (i+1)·L/S) and applies
    them in order (dense experts: the pipe axis shards STAGES, not
    experts). Requires n_layers % n_stages == 0.

    Returns (per_stage_params, stage_fn) for
    parallel.pipeline.stack_stage_params / pipeline_apply; embed/decoder
    stay outside the pipe, activations are (mb, T, d). ``attn_impl``
    forces every staged layer's attention core (default: the auto chain
    on the microbatch length: the flash kernels at T >= 1024);
    ``moe_fn(router_w, experts, flat)`` overrides the staged FFN
    (default: the dense top-k MoE)."""
    blocks = params["blocks"]
    n_layers = lm_n_layers(params)
    if n_layers % n_stages:
        raise ValueError(
            f"n_layers={n_layers} does not split over {n_stages} pipeline "
            "stages — layer-boundary staging needs n_layers % n_stages == 0")
    per = n_layers // n_stages
    per_stage = [tree_map(lambda _, a, i=i: a[i * per:(i + 1) * per], blocks)
                 for i in range(n_stages)]

    def core(q, k, v):
        return attention_core(q, k, v, causal=True, impl=attn_impl)

    def dense(rw, ex, x):
        return dense_moe(rw, ex, x, top_k)

    moe = moe_fn or dense

    def stage_fn(p, x):
        for i in range(tree_leaves(p)[0].shape[0]):
            x, _ = _decoder_block(_layer(p, i), x, n_heads, core, moe)
        return x

    return per_stage, stage_fn


def make_pp_loss(stage_fn, mesh, pipe_axis: str,
                 batch_axis: Optional[str] = None,
                 with_metrics: bool = False, overlap: bool = False):
    """Staged-LM task loss for the dp×pp path: embed lookup, the pipeline
    schedule over ``pipe_axis``, decoder, mean NLL. The dense twin is
    ``dense_loss_fn(n_heads, aux_weight=0.0)`` on the flattened
    microbatches.

    ``loss(trained, toks_mbs, targets_mbs)`` with trained = (this rank's
    stage params, embed, dec_w, dec_b) and the GLOBAL (n_micro, mb, T)
    tokens and targets. With ``batch_axis`` each rank pipelines its rows
    and the outputs are gathered over the rows before the decoder, so the
    loss is the global one on every rank; the stage params and the
    embedding, which see this rank's rows only, have their grads summed
    over ``batch_axis`` in the backward (one all-reduce), so autograd
    gives every rank the global gradient. ``with_metrics`` returns (loss,
    metrics) with the per-microbatch NLL means."""
    from deeplearning4j_tpu_torch.parallel.pipeline import pipeline_apply

    def loss(trained, toks_mbs, tgt_mbs):
        stacked, embed, dec_w, dec_b = trained
        if batch_axis is not None:
            leaves = sum_grads_ad(mesh, tree_leaves(stacked) + [embed],
                                  batch_axis)
            stacked, embed = tree_unflatten(stacked, leaves[:-1]), leaves[-1]
        x_mbs = embed[torch.as_tensor(toks_mbs).long()]     # (M, mb, T, d)
        outs = pipeline_apply(stacked, x_mbs, stage_fn, mesh, pipe_axis,
                              batch_axis=batch_axis, overlap=overlap)
        if batch_axis is not None:
            outs = gather_rows_ad(mesh, outs.transpose(0, 1).contiguous(),
                                  batch_axis).transpose(0, 1)
        logits = outs @ dec_w + dec_b
        logp = torch.log_softmax(logits, dim=-1)
        tgt = torch.as_tensor(tgt_mbs, device=logp.device).long()
        nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
        if with_metrics:
            return nll.mean(), {"microbatch_loss": nll.detach().mean(
                dim=tuple(range(1, nll.dim())))}
        return nll.mean()

    return loss


def pp_trained_to_lm_params(trained) -> dict:
    """The dp×pp training carry — (stage params, embed, dec_w, dec_b) —
    back to the params dict ``init_lm_params`` produces: the stage axis
    (S, L/S, ...) merged into the (L, ...) block axis (this rank's stage:
    its L/S layers)."""
    from deeplearning4j_tpu_torch.parallel.pipeline import merge_stage_axis

    stacked, embed, dec_w, dec_b = trained
    return {"embed": embed, "blocks": merge_stage_axis(stacked),
            "dec_w": dec_w, "dec_b": dec_b}


def lm_params_to_pp_trained(params: dict, mesh, n_heads: int,
                            n_stages: int, pipe_axis: str = "pipe",
                            top_k: int = 2,
                            attn_impl: Optional[str] = None):
    """Params → the dp×pp carry: (trained tuple, stage_fn), this rank's
    stage of the stack staged onto ``pipe_axis``."""
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        shard_stage_params,
        stack_stage_params,
    )

    per_stage, stage_fn = make_pp_stages(params, n_heads, n_stages=n_stages,
                                         top_k=top_k, attn_impl=attn_impl)
    stacked = shard_stage_params(stack_stage_params(per_stage), mesh,
                                 pipe_axis)
    trained = (stacked, params["embed"], params["dec_w"], params["dec_b"])
    return trained, stage_fn


# --------------------------------------------------------------- serving ----

def init_kv_cache(n_layers: int, n_slots: int, n_heads: int, head_dim: int,
                  max_len: int, dtype=torch.float32, *,
                  device: DeviceLike = None) -> dict:
    """Zeroed paged KV cache for ``n_slots`` concurrent requests: ``{"k",
    "v"}`` leaves of shape (L, S, H, T_max, Dh). Zeros (not garbage) so
    masked-out positions never inject non-finite values through the
    0-weight attention terms."""
    dev = resolve_device(device)
    shape = (n_layers, n_slots, n_heads, max_len, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _decoder_block_kv(layer_params: dict, h: torch.Tensor, n_heads: int,
                      attn_core, top_k: int) -> tuple:
    """``_decoder_block`` with the dense MoE FFN, additionally returning the
    layer's projected K/V (B, H, T, Dh) for cache seeding. Residual adds
    cast back to the carry dtype, as in JAX."""
    hn = _layernorm(h, layer_params["ln_g"], layer_params["ln_b"])
    q = _split_heads(hn @ layer_params["wq"], n_heads)
    k = _split_heads(hn @ layer_params["wk"], n_heads)
    v = _split_heads(hn @ layer_params["wv"], n_heads)
    h = h + (_merge_heads(attn_core(q, k, v))
             @ layer_params["wo"]).to(h.dtype)
    h2 = _layernorm(h, layer_params["ln2_g"], layer_params["ln2_b"])
    flat = h2.reshape(-1, h2.shape[-1])
    moe_out = dense_moe(layer_params["router"], layer_params["experts"],
                        flat, top_k)
    return h + moe_out.reshape(h.shape).to(h.dtype), k, v


def lm_prefill(params: dict, tokens: torch.Tensor, n_heads: int,
               top_k: int = 2, attn_impl: Optional[str] = None) -> tuple:
    """Prompt pass: tokens (B, T_pad) → (logits (B, T_pad, V), ks, vs) with
    ks/vs (L, B, H, T_pad, Dh), every layer's projected K/V. Attention
    routes through the core-selection seam (``attn_impl`` forces
    dense/blockwise/flash); causal masking makes right-padding exact."""
    def core(q, k, v):
        return attention_core(q, k, v, causal=True, impl=attn_impl)

    h = params["embed"][tokens.long()]
    ks, vs = [], []
    for i in range(lm_n_layers(params)):
        h, k, v = _decoder_block_kv(_layer(params["blocks"], i), h, n_heads,
                                    core, top_k)
        ks.append(k)
        vs.append(v)
    logits = h @ params["dec_w"] + params["dec_b"]
    return logits, torch.stack(ks), torch.stack(vs)


def _decode_block(layer_params: dict, h: torch.Tensor, ck: torch.Tensor,
                  cv: torch.Tensor, positions: torch.Tensor, n_heads: int,
                  top_k: int) -> torch.Tensor:
    """One decoder block for W new tokens per slot. h: (S, W, d); ck/cv:
    (S, H, T_max, Dh), written IN PLACE at ``positions``..``positions + W -
    1`` FIRST (one index-put each for K and V, every slot and offset at
    once); then every query attends with the mask ``index <= position +
    offset``. Callers keep ``positions + W <= T_max``: torch indexing
    raises where JAX's dynamic_update_slice would clamp."""
    hn = _layernorm(h, layer_params["ln_g"], layer_params["ln_b"])
    q = _split_heads(hn @ layer_params["wq"], n_heads)    # (S, H, W, Dh)
    k_new = _split_heads(hn @ layer_params["wk"], n_heads)
    v_new = _split_heads(hn @ layer_params["wv"], n_heads)
    pos_q = positions[:, None] + torch.arange(h.shape[1], device=h.device)
    slots = torch.arange(h.shape[0], device=h.device)[:, None]   # (S, 1)
    ck[slots, :, pos_q] = k_new.transpose(1, 2).to(ck.dtype)  # (S,W,H,Dh)
    cv[slots, :, pos_q] = v_new.transpose(1, 2).to(cv.dtype)
    scores = torch.einsum("shqd,shkd->shqk", q, ck) / (
        (q.shape[-1] * 1.0) ** 0.5)                           # (S,H,W,T_max)
    mask = (torch.arange(ck.shape[2], device=h.device)[None, None, None, :]
            <= pos_q[:, None, :, None])
    scores = scores.masked_fill(~mask, _NEG_INF)
    o = torch.einsum("shqk,shkd->shqd", softmax(scores), cv)
    h = h + (_merge_heads(o) @ layer_params["wo"]).to(h.dtype)
    h2 = _layernorm(h, layer_params["ln2_g"], layer_params["ln2_b"])
    flat = h2.reshape(-1, h2.shape[-1])                        # (S·W, d)
    moe_out = dense_moe(layer_params["router"], layer_params["experts"],
                        flat, top_k)
    return h + moe_out.reshape(h.shape).to(h.dtype)


def lm_verify_step(params: dict, cache: dict, tokens: torch.Tensor,
                   positions: torch.Tensor, n_heads: int,
                   top_k: int = 2) -> tuple:
    """W tokens per slot: tokens (S, W) land at ``positions``..``positions
    + W - 1`` (S,) in the cache (written in place) and per-position
    next-token logits (S, W, V) come back with it. Offset i's query sees
    exactly the cache a decode step at ``positions + i`` would, so
    logits[:, i] are those of i sequential decode steps over the same
    tokens: the speculative verify forward. Callers keep ``positions + W
    <= T_max``."""
    h = params["embed"][tokens.long()]                          # (S, W, d)
    positions = positions.long()
    for i in range(lm_n_layers(params)):
        h = _decode_block(_layer(params["blocks"], i), h, cache["k"][i],
                          cache["v"][i], positions, n_heads, top_k)
    return cache, h @ params["dec_w"] + params["dec_b"]


def lm_decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                   positions: torch.Tensor, n_heads: int,
                   top_k: int = 2) -> tuple:
    """One decode iteration over every slot: tokens (S,) land at
    ``positions`` (S,) in the cache and next-token logits (S, V) come back
    with the cache (updated in place): ``lm_verify_step`` at W=1."""
    cache, logits = lm_verify_step(params, cache, tokens[:, None],
                                   positions, n_heads, top_k)
    return cache, logits[:, 0, :]


def lm_chunk_prefill(params: dict, cache: dict, tokens: torch.Tensor,
                     start: int, slot: int, n_heads: int,
                     top_k: int = 2) -> tuple:
    """One slot's tokens (1, W) written at absolute positions
    ``start``..``start + W - 1`` of slot ``slot``'s cache rows (in place,
    through a view of the slot: no write-back), each query attending the
    slot's cache at ``index <= start + offset``: it sees every earlier
    chunk and any prefix-cache-seeded page. Returns (cache, logits (W,
    V)). ``start + W`` past T_max raises."""
    if start + tokens.shape[1] > cache["k"].shape[3]:
        raise ValueError(f"a {tokens.shape[1]}-wide chunk at {start} passes "
                         f"the cache's T_max {cache['k'].shape[3]}")
    h = params["embed"][tokens.long()]                          # (1, W, d)
    pos = torch.tensor([start], dtype=torch.int64, device=h.device)
    for i in range(lm_n_layers(params)):
        h = _decode_block(_layer(params["blocks"], i), h,
                          cache["k"][i, slot:slot + 1],
                          cache["v"][i, slot:slot + 1], pos, n_heads, top_k)
    return cache, (h @ params["dec_w"] + params["dec_b"])[0]


def sample_tokens(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: torch.Tensor) -> torch.Tensor:
    """Greedy argmax where ``temperature <= 0``, else a temperature-scaled
    categorical draw from ``generator``, per row, in one call. ``logits``
    is (..., V) and ``temperature`` has its leading shape. The draws
    cannot match ``jax.random.categorical``; greedy is the parity path."""
    greedy = logits.argmax(-1)
    flat = logits.reshape(-1, logits.shape[-1]).float()
    temps = temperature.reshape(-1, 1).float()
    probs = torch.softmax(flat / torch.clamp_min(temps, 1e-6), -1)
    sampled = torch.multinomial(probs, 1, generator=generator)
    sampled = sampled.reshape(greedy.shape)
    return torch.where(temperature > 0, sampled, greedy).to(torch.int32)


def make_decode_step(n_heads: int, top_k: int = 2, params_transform=None):
    """The serving engine's decode step: ``step(params, cache, tokens,
    positions, temps, generator) -> (cache, next_tokens)``. Shapes are
    fixed at the slot count. ``params_transform`` is the serve_dtype seam's
    int8→bf16 dequantization hook (serve/quant.py); None = identity."""
    transform = params_transform or (lambda p: p)

    @torch.inference_mode()
    def step(params, cache, tokens, positions, temps, generator):
        params = transform(params)
        cache, logits = lm_decode_step(params, cache, tokens, positions,
                                       n_heads, top_k)
        return cache, sample_tokens(logits, generator, temps)

    return step


def make_prefill_step(n_heads: int, top_k: int = 2,
                      attn_impl: Optional[str] = None,
                      params_transform=None):
    """Admission step: ``prefill(params, cache, tokens, last_idx, slot,
    temp, generator) -> (cache, first_token)``: the prompt pass (through
    the attn_impl seam), the cache-page write at ``slot`` and the first
    sampled token. ``tokens`` is (1, T_pad), right-padded to a bucket."""
    transform = params_transform or (lambda p: p)

    @torch.inference_mode()
    def prefill(params, cache, tokens, last_idx, slot, temp, generator):
        params = transform(params)
        t_pad = tokens.shape[1]
        if t_pad > cache["k"].shape[3]:
            raise ValueError(f"prefill width {t_pad} exceeds the cache's "
                             f"max_len {cache['k'].shape[3]}")
        logits, ks, vs = lm_prefill(params, tokens, n_heads, top_k,
                                    attn_impl)
        cache["k"][:, slot, :, :t_pad] = ks[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot, :, :t_pad] = vs[:, 0].to(cache["v"].dtype)
        return cache, sample_tokens(logits[0, last_idx], generator, temp)

    return prefill


def make_verify_step(n_heads: int, top_k: int = 2, params_transform=None):
    """The speculative flagship step: ``verify(params, cache, tokens,
    positions, temps, generator) -> (cache, toks)`` with tokens (S, W) →
    toks (S, W) int32. toks[:, i] is ``sample_tokens`` over the logits at
    offset i (greedy argmax where ``temps <= 0``: the value the acceptance
    rule compares the proposals against). Where JAX folds each offset into
    the step's key, the W draws come from ``generator`` in offset order."""
    transform = params_transform or (lambda p: p)

    @torch.inference_mode()
    def verify(params, cache, tokens, positions, temps, generator):
        params = transform(params)
        cache, logits = lm_verify_step(params, cache, tokens, positions,
                                       n_heads, top_k)
        toks = torch.stack([sample_tokens(logits[:, i, :], generator, temps)
                            for i in range(tokens.shape[1])], dim=1)
        return cache, toks

    return verify


def make_chunk_prefill_step(n_heads: int, top_k: int = 2,
                            params_transform=None):
    """Chunked/suffix prefill step: ``chunk(params, cache, tokens, start,
    last_idx, slot, temp, generator) -> (cache, tok)``: ``lm_chunk_prefill``
    of one slot's tokens (1, W), then ``tok`` sampled from the logits at
    in-chunk index ``last_idx``. The engine reads ``tok`` from the final
    chunk only (last_idx = prompt_len - 1 - start). ``start``, ``last_idx``
    and ``slot`` are host ints; the caller keeps ``start + W <= T_max``
    (the engine shifts the final chunk left to overlap: recomputing a
    position from the same tokens rewrites the same values)."""
    transform = params_transform or (lambda p: p)

    @torch.inference_mode()
    def chunk(params, cache, tokens, start, last_idx, slot, temp,
              generator):
        params = transform(params)
        cache, logits = lm_chunk_prefill(params, cache, tokens, int(start),
                                         int(slot), n_heads, top_k)
        return cache, sample_tokens(logits[int(last_idx)], generator, temp)

    return chunk


def draft_truncate_params(params: dict, n_layers: int) -> dict:
    """Layer-truncated draft LM: the flagship's first ``n_layers`` decoder
    blocks with the SAME embedding and decoder head, the draft for
    speculative decoding that needs no training. Every leaf is the
    flagship's tensor or a view of it (``blocks[...][:n]``), never a copy,
    as JAX shares the leaves."""
    total = lm_n_layers(params)
    if not (1 <= n_layers <= total):
        raise ValueError(
            f"draft n_layers must be in [1, {total}], got {n_layers}")
    blocks = tree_map(lambda _, x: x[:n_layers], params["blocks"])
    return {"embed": params["embed"], "blocks": blocks,
            "dec_w": params["dec_w"], "dec_b": params["dec_b"]}


def draft_distill_loss(teacher_params: dict, n_heads: int, top_k: int = 2,
                       attn_impl: Optional[str] = None):
    """Self-distillation objective for a trained draft: ``loss(draft_params,
    tokens)`` is the mean KL(teacher ‖ draft) over every position, the
    teacher (flagship) forward run without grad (JAX's ``stop_gradient``).
    Distil ``draft_truncate_params(flagship, n)`` with it, then hand the
    result to ``DecodeEngine(speculative=SpeculativeConfig(
    draft_params=...))``."""
    def core(q, k, v):
        return attention_core(q, k, v, causal=True, impl=attn_impl)

    moe = partial(dense_moe, top_k=top_k)

    def loss(draft_params: dict, tokens) -> torch.Tensor:
        with torch.no_grad():
            t_logits, _ = lm_forward(teacher_params, tokens, n_heads, core,
                                     moe)
        t_logp = torch.log_softmax(t_logits, dim=-1)
        d_logits, _ = lm_forward(draft_params, tokens, n_heads, core, moe)
        d_logp = torch.log_softmax(d_logits, dim=-1)
        return torch.mean(torch.sum(torch.exp(t_logp) * (t_logp - d_logp),
                                    dim=-1))

    return loss


def lm_dims(params: dict) -> dict:
    """Model dimensions recoverable from the params tree alone: everything
    except ``n_heads``, which the head split erases."""
    vocab, d_model = params["embed"].shape
    w1 = params["blocks"]["experts"]["w1"]
    n_layers, n_experts, _, d_ff = w1.shape
    return {"vocab": int(vocab), "d_model": int(d_model),
            "n_layers": int(n_layers), "n_experts": int(n_experts),
            "d_ff": int(d_ff)}


def lm_checkpoint_meta(params: dict, n_heads: int, top_k: int = 2) -> dict:
    """Checkpoint ``meta`` block carrying what the shapes erase."""
    return {"lm": {**lm_dims(params), "n_heads": int(n_heads),
                   "top_k": int(top_k)}}


def lm_replay(n_heads: int, top_k: int = 2, aux_weight: float = 1e-2,
              attn_impl: Optional[str] = None, *,
              device: DeviceLike = None):
    """``tools/step_replay.py`` factory for the LM's replay bundles
    (``--factory deeplearning4j_tpu_torch.models.transformer_lm:lm_replay
    --kwargs-json '{"n_heads": ..., "device": "cpu"}'``).

    Returns ``run(payload) -> dict`` re-executing the faulting step's loss
    and grad from a bundle whose payload is ``{"params": <lm params>,
    "batch": {"tokens", "targets"}}`` (numpy leaves), on ``device`` (CUDA
    unless ``device="cpu"``). The forward draws nothing at random, so a
    non-finite loss reproduces exactly."""
    from deeplearning4j_tpu_torch.interop import lm_params_from_numpy
    from deeplearning4j_tpu_torch.telemetry.metrics import global_norm

    dev = resolve_device(device)
    loss_fn = dense_loss_fn(n_heads, top_k, aux_weight, attn_impl=attn_impl)

    def run(payload: dict) -> dict:
        params = lm_params_from_numpy(payload["params"], dev)
        toks = torch.as_tensor(np.asarray(payload["batch"]["tokens"]),
                               dtype=torch.int64, device=dev)
        tgts = torch.as_tensor(np.asarray(payload["batch"]["targets"]),
                               dtype=torch.int64, device=dev)
        loss, grads = lm_value_and_grad(loss_fn, params, toks, tgts)
        return {"loss": float(loss), "grad_norm": float(global_norm(grads))}

    return run
