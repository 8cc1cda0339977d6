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

The mesh, sharding, pipeline, composed, verify and chunk-prefill step
factories, and the ``profile=``/``runprof=``/``tuned=`` seams, come with
later slices.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

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
    opt_update,
)
from deeplearning4j_tpu_torch.parallel.moe import (
    _routing,
    load_balance_loss,
    router_load_fraction,
)
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
                  with_metrics: bool = False):
    """Single-device loss (dense MoE; attention through the core seam).
    ``attn_impl=None`` auto-gates by shape: the flash kernels for long T,
    dense for short. ``with_metrics`` swaps in the (loss, metrics) twin.
    Returns ``loss_fn(params, tokens, targets)``."""
    def attn_core(q, k, v):
        return attention_core(q, k, v, causal=True, impl=attn_impl)

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


def init_lm_opt_state(optimizer, params: dict, *,
                      device: DeviceLike = None) -> dict:
    """The optimizer state the optimizer-threaded step expects: ``{"m",
    "v", "count"}`` with zero moments like the params, on ``device`` (CUDA
    unless ``device="cpu"``). There is no mesh here: the sharded (ZeRO)
    mode is rejected."""
    dev = resolve_device(device)
    cfg = OptimizerConfig.coerce(optimizer)
    if cfg is None:
        raise ValueError("init_lm_opt_state needs an optimizer "
                         "(name or OptimizerConfig)")
    if cfg.sharded:
        raise ValueError(
            "update_sharding='sharded' needs a mesh with a dp axis — "
            "single-device steps run the replicated update")
    return init_opt_state(cfg, tree_map(lambda _, x: x.to(dev), params))


def _loss_and_grads(loss_fn, params, tokens, targets, dev,
                    with_metrics: bool) -> tuple:
    """(loss, metrics or None, grads) with the batch moved to ``dev``."""
    value, grads = lm_value_and_grad(
        loss_fn, params, torch.as_tensor(tokens, device=dev),
        torch.as_tensor(targets, device=dev), has_aux=with_metrics)
    loss, metrics = value if with_metrics else (value, None)
    return loss, metrics, grads


def _make_sgd_step(loss_fn, lr: float, with_metrics: bool, dev,
                   donate: bool = False, guard=None):
    """The SGD step: ``step(params, tokens, targets) -> (new_params, loss)``,
    plus the guard block (``guard``) or the metrics dict
    (``with_metrics``, guard block merged in) as a third output."""
    def step(params, tokens, targets):
        loss, metrics, grads = _loss_and_grads(loss_fn, params, tokens,
                                               targets, dev, with_metrics)
        with torch.no_grad():
            if guard is None:
                new_params = tree_zip_map(lambda p, g: p - lr * g, params,
                                          grads)
                block = None
            else:
                new_params, block = guarded_sgd_update(params, grads, loss,
                                                       lr, guard)
            if with_metrics:
                block = {**metrics,
                         **train_step_metrics(params, grads, lr, loss=loss),
                         **(block or {})}
        new_params = commit(params, new_params, donate)
        if block is None:
            return new_params, loss
        return new_params, loss, block

    return step


def _make_opt_step(loss_fn, lr: float, with_metrics: bool,
                   optimizer: OptimizerConfig, dev, donate: bool = False,
                   guard=None):
    """The optimizer-threaded step: ``step(params, opt_state, tokens,
    targets) -> (new_params, new_opt_state, loss[, metrics/guard
    block])``. The loss and grads are the SGD step's; only the update
    differs. With ``donate`` the params and moments are updated in
    place."""
    def step(params, opt_state, tokens, targets):
        loss, metrics, grads = _loss_and_grads(loss_fn, params, tokens,
                                               targets, dev, with_metrics)
        with torch.no_grad():
            if guard is None:
                out = opt_update(optimizer, params, grads, opt_state, lr,
                                 with_metrics=with_metrics)
            else:
                out = guarded_opt_update(params, grads, opt_state, loss, lr,
                                         optimizer, guard,
                                         with_metrics=with_metrics)
            new_params, new_state = out[0], out[1]
            block = out[2] if len(out) == 3 else None
            if with_metrics:
                # the optimizer block LAST: its true ‖Δp‖/‖p‖ update_ratio
                # overrides the lr·‖g‖ SGD proxy of train_step_metrics
                block = {**metrics,
                         **train_step_metrics(params, grads, lr, loss=loss),
                         **block}
        new_params = commit(params, new_params, donate)
        new_state = commit(opt_state, new_state, donate)
        if block is None:
            return new_params, new_state, loss
        return new_params, new_state, loss, block

    return step


def make_single_device_train_step(n_heads: int, lr: float = 0.1,
                                  top_k: int = 2, aux_weight: float = 1e-2,
                                  attn_impl: Optional[str] = None,
                                  with_metrics: bool = False,
                                  donate: bool = False, guard=None,
                                  optimizer=None, *,
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
    ``device`` (CUDA unless ``device="cpu"``), where the params must be."""
    dev = resolve_device(device)
    loss_fn = dense_loss_fn(n_heads, top_k, aux_weight, attn_impl=attn_impl,
                            with_metrics=with_metrics)
    guard_cfg = GuardConfig.coerce(guard)
    opt_cfg = OptimizerConfig.coerce(optimizer)
    if opt_cfg is None:
        return _make_sgd_step(loss_fn, lr, with_metrics, dev, donate=donate,
                              guard=guard_cfg)
    if opt_cfg.sharded:
        raise ValueError(
            "update_sharding='sharded' needs a dp mesh axis — the "
            "single-device step has no replicas to shard the update over")
    return _make_opt_step(loss_fn, lr, with_metrics, opt_cfg.resolved(), dev,
                          donate=donate, guard=guard_cfg)


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
    1`` FIRST; then every query attends with the mask ``index <= position +
    offset``. Callers keep ``positions + W <= T_max``: torch indexing
    raises where JAX's dynamic_update_slice would clamp."""
    hn = _layernorm(h, layer_params["ln_g"], layer_params["ln_b"])
    q = _split_heads(hn @ layer_params["wq"], n_heads)    # (S, H, W, Dh)
    k_new = _split_heads(hn @ layer_params["wk"], n_heads)
    v_new = _split_heads(hn @ layer_params["wv"], n_heads)
    slots = torch.arange(h.shape[0], device=h.device)
    for w in range(h.shape[1]):
        ck[slots, :, positions + w] = k_new[:, :, w].to(ck.dtype)
        cv[slots, :, positions + w] = v_new[:, :, w].to(cv.dtype)
    scores = torch.einsum("shqd,shkd->shqk", q, ck) / (
        (q.shape[-1] * 1.0) ** 0.5)                           # (S,H,W,T_max)
    pos_q = positions[:, None] + torch.arange(h.shape[1], device=h.device)
    mask = (torch.arange(ck.shape[2], device=h.device)[None, None, None, :]
            <= pos_q[:, None, :, None])
    scores = scores.masked_fill(~mask, _NEG_INF)
    o = torch.einsum("shqk,shkd->shqd", softmax(scores), cv)
    h = h + (_merge_heads(o) @ layer_params["wo"]).to(h.dtype)
    h2 = _layernorm(h, layer_params["ln2_g"], layer_params["ln2_b"])
    flat = h2.reshape(-1, h2.shape[-1])                        # (S, d)
    moe_out = dense_moe(layer_params["router"], layer_params["experts"],
                        flat, top_k)
    return h + moe_out.reshape(h.shape).to(h.dtype)


def lm_decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                   positions: torch.Tensor, n_heads: int,
                   top_k: int = 2) -> tuple:
    """One decode iteration over every slot: tokens (S,) land at
    ``positions`` (S,) in the cache and next-token logits (S, V) come back
    with the cache (updated in place)."""
    h = params["embed"][tokens.long()][:, None, :]              # (S, 1, d)
    positions = positions.long()
    for i in range(lm_n_layers(params)):
        h = _decode_block(_layer(params["blocks"], i), h, cache["k"][i],
                          cache["v"][i], positions, n_heads, top_k)
    logits = (h @ params["dec_w"] + params["dec_b"])[:, 0, :]
    return cache, logits


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
