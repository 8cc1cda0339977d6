"""Counterpart of ``deeplearning4j_tpu/tune/seams.py``: the concrete tuning
harnesses per searchable seam.

A :class:`SeamHarness` bundles what ``tune.search.search`` needs for one
seam instance: the cache-key ``context`` (the canonical dict the winner
is stored AND looked up under — the ``tuned=`` consumers must build the
identical context, which is why the ``*_context`` builders live here),
the ``default_config`` baseline, a ``compile_fn`` (one profiled call per
candidate, ``telemetry.xprofile.profile_compiled``), a ``measure_fn``
(ONE timed, fenced call — ``torch.cuda.synchronize`` on the card — per
call; the searcher owns the paired-median loop), and the seam's
``outputs_match`` predicate at the tolerance its parity pins use (tokens
exact for serve, loss/grads <= 1e-5 for the blockwise-attention
reduction orders).

Contexts carry ``backend``: the device type, "cuda" or "cpu" (JAX writes
``jax.default_backend()``). Every harness runs on ``device`` (CUDA unless
``device="cpu"``; raises without a card). Inputs and params come from
CPU ``torch.Generator``s seeded 0 (params, q/k/v) and 1 (tokens), so the
card and the CPU see the same numbers, or from the caller (``params=``,
``tokens=``, ``qkv=``), which is how the tests inject JAX's draws.
Harnesses build their steps lazily and keep one per config, so phase 2's
repeated timings never rebuild. Each runs its default config once when it
is built: a process's first call allocates what later calls reuse (the
card's GEMM workspaces), which would otherwise land in the peak bytes of
the first candidate profiled and prune it. Shapes default to JAX's
CPU-friendly "fast" sizes; the CLI routes through here.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import (
    DeviceLike,
    resolve_device,
    tree_leaves,
    tree_map,
)

__all__ = [
    "SeamHarness",
    "flash_seam",
    "lm_context",
    "lm_seam",
    "serve_context",
    "serve_seam",
]

Config = Dict[str, Any]


@dataclass
class SeamHarness:
    seam: str
    context: Dict[str, Any]
    default_config: Config
    compile_fn: Callable[[Config], Any]
    measure_fn: Callable[[Config], Tuple[float, Any]]
    outputs_match: Callable[[Any, Any], bool]
    label: str = ""
    extras: Dict[str, Any] = field(default_factory=dict)


# ------------------------------------------------------- context builders ----

def _backend(device: DeviceLike) -> str:
    """The device type a context is keyed by: "cuda" unless ``device``
    says otherwise (a context is a dict: building one needs no card)."""
    return torch.device("cuda" if device is None else device).type


def lm_context(n_heads: int, d_model: int, n_layers: int, vocab: int,
               d_ff: int, n_experts: int, seq_len: int, batch: int,
               mesh_shape: Optional[Dict[str, int]] = None, *,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Cache-key context for the LM train-step seams. Any change — model
    dims, workload shape, mesh, device type — is a fingerprint miss."""
    return {
        "kind": "lm",
        "n_heads": n_heads, "d_model": d_model, "n_layers": n_layers,
        "vocab": vocab, "d_ff": d_ff, "n_experts": n_experts,
        "seq_len": seq_len, "batch": batch,
        "mesh": mesh_shape or {},
        "backend": _backend(device),
    }


def serve_context(dims: Dict[str, int], n_heads: int, max_len: int, *,
                  device: DeviceLike = None) -> Dict[str, Any]:
    """Cache-key context for the serve seam — built from ``lm_dims``
    (recoverable from the params alone) and the engine's device, so
    ``DecodeEngine(tuned=True)`` reconstructs it without caller help."""
    return {
        "kind": "serve",
        "n_heads": int(n_heads), "max_len": int(max_len),
        "d_model": int(dims["d_model"]), "n_layers": int(dims["n_layers"]),
        "vocab": int(dims["vocab"]), "d_ff": int(dims["d_ff"]),
        "n_experts": int(dims["n_experts"]),
        "backend": _backend(device),
    }


def _cfg_key(cfg: Config) -> Tuple:
    return tuple(sorted(cfg.items()))


def _timed(dev: torch.device, fn, *args):
    """One fenced execution: the call, then a synchronize on the card;
    wall seconds + outputs."""
    t0 = time.perf_counter()
    out = fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0, out


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _lm_params(params, vocab, d_model, n_heads, n_experts, d_ff, n_layers,
               dev):
    """``params`` (any tree of arrays) on ``dev``, or fresh ones drawn
    from a CPU generator seeded 0."""
    from deeplearning4j_tpu_torch.models.transformer_lm import init_lm_params

    if params is None:
        return init_lm_params(_generator(0), vocab, d_model, n_heads,
                              n_experts, d_ff, n_layers=n_layers,
                              device=dev)
    return tree_map(lambda _, x: torch.as_tensor(x).to(dev), params)


# ------------------------------------------------------------- flash seam ----

def flash_seam(seq_len: int = 1024, batch: int = 1, n_heads: int = 2,
               head_dim: int = 64, *, device: DeviceLike = None,
               qkv: Optional[Sequence] = None) -> SeamHarness:
    """Standalone blockwise-attention value+grad step (the loss
    ``mean(o²)`` and its grad in q); knobs (block_q, block_k) against
    ``default_block_policy``. On the card each config is a K3f key split
    (``ops.flash_attention.key_split_for``) with K3k and K3q behind it.
    Outputs match at the blockwise parity tolerance (1e-5 — reduction
    order moves with the split, bitwise is the wrong pin here)."""
    from deeplearning4j_tpu_torch.ops.flash_attention import (
        blockwise_attention,
        default_block_policy,
    )

    dev = resolve_device(device)
    shape = (batch, n_heads, seq_len, head_dim)
    if qkv is None:
        gen = _generator(0)
        qkv = [torch.randn(shape, generator=gen) for _ in range(3)]
    q, k, v = (torch.as_tensor(x, dtype=torch.float32).to(dev)
               for x in qkv)

    steps: Dict[Tuple, Any] = {}

    def _step(cfg: Config):
        ck = _cfg_key(cfg)
        if ck not in steps:
            bq, bk = int(cfg["block_q"]), int(cfg["block_k"])

            def step(q, k, v):
                qg = q.detach().requires_grad_()
                with torch.enable_grad():
                    o = blockwise_attention(qg, k, v, causal=True,
                                            block_q=bq, block_k=bk)
                    loss = torch.mean(o * o)
                    (grad,) = torch.autograd.grad(loss, (qg,))
                return loss.detach(), grad

            steps[ck] = step
        return steps[ck]

    def compile_fn(cfg: Config):
        from deeplearning4j_tpu_torch.telemetry.xprofile import (
            profile_compiled,
        )
        return profile_compiled(
            _step(cfg), q, k, v,
            label=f"tune.flash[{cfg['block_q']}x{cfg['block_k']}]")

    def measure_fn(cfg: Config):
        dt, (loss, grad) = _timed(dev, _step(cfg), q, k, v)
        return dt, (float(loss), grad.cpu().numpy())

    def outputs_match(a, b) -> bool:
        return (abs(a[0] - b[0]) <= 1e-5
                and bool(np.allclose(a[1], b[1], atol=1e-5, rtol=1e-5)))

    pol = default_block_policy(seq_len)
    _timed(dev, _step({"block_q": pol, "block_k": pol}), q, k, v)
    return SeamHarness(
        seam="flash_attention",
        context={"kind": "flash", "seq_len": seq_len, "batch": batch,
                 "n_heads": n_heads, "head_dim": head_dim,
                 "backend": dev.type},
        default_config={"block_q": pol, "block_k": pol},
        compile_fn=compile_fn, measure_fn=measure_fn,
        outputs_match=outputs_match, label="flash_attention")


# ---------------------------------------------------------------- lm seam ----

def lm_seam(vocab: int = 256, d_model: int = 64, n_heads: int = 2,
            n_experts: int = 2, d_ff: int = 128, n_layers: int = 2,
            seq_len: int = 256, batch: int = 2, top_k: int = 2, *,
            device: DeviceLike = None, params: Optional[dict] = None,
            tokens=None) -> SeamHarness:
    """The single-device LM train step with a forced blockwise core,
    searching the ``flash_attention`` seam THROUGH the factory's
    ``tuned=`` dict path — the exact code path a cache adoption takes (on
    the card: K3f at the config's key split, K3k and K3q, once a layer).
    One SGD step from fixed params; outputs (loss, update-norm) match at
    the blockwise 1e-5 tolerance."""
    from deeplearning4j_tpu_torch.models.transformer_lm import (
        make_single_device_train_step,
    )
    from deeplearning4j_tpu_torch.ops.flash_attention import (
        default_block_policy,
    )

    dev = resolve_device(device)
    params = _lm_params(params, vocab, d_model, n_heads, n_experts, d_ff,
                        n_layers, dev)
    if tokens is None:
        tokens = torch.randint(0, vocab, (batch, seq_len),
                               generator=_generator(1))
    toks = torch.as_tensor(tokens).long().to(dev)
    tgts = torch.roll(toks, -1, dims=1)

    steps: Dict[Tuple, Any] = {}

    def _step(cfg: Config):
        ck = _cfg_key(cfg)
        if ck not in steps:
            steps[ck] = make_single_device_train_step(
                n_heads, top_k=top_k, attn_impl="blockwise",
                tuned=dict(cfg), device=dev)
        return steps[ck]

    def compile_fn(cfg: Config):
        from deeplearning4j_tpu_torch.telemetry.xprofile import (
            profile_compiled,
        )
        return profile_compiled(
            _step(cfg), params, toks, tgts,
            label=f"tune.lm[{cfg['block_q']}x{cfg['block_k']}]")

    def measure_fn(cfg: Config):
        dt, (new_params, loss) = _timed(dev, _step(cfg), params, toks, tgts)
        upd = sum(float(torch.sum(torch.abs(n - p)))
                  for n, p in zip(tree_leaves(new_params),
                                  tree_leaves(params)))
        return dt, (float(loss), float(upd))

    def outputs_match(a, b) -> bool:
        return bool(np.allclose(np.asarray(a), np.asarray(b),
                                atol=1e-5, rtol=1e-4))

    pol = default_block_policy(seq_len)
    _timed(dev, _step({"block_q": pol, "block_k": pol}), params, toks, tgts)
    return SeamHarness(
        seam="flash_attention",
        context=lm_context(n_heads, d_model, n_layers, vocab, d_ff,
                           n_experts, seq_len, batch, device=dev),
        default_config={"block_q": pol, "block_k": pol},
        compile_fn=compile_fn, measure_fn=measure_fn,
        outputs_match=outputs_match, label="lm_single_device")


# ------------------------------------------------------------- serve seam ----

def serve_seam(vocab: int = 64, d_model: int = 32, n_heads: int = 2,
               n_experts: int = 2, d_ff: int = 64, n_layers: int = 2,
               max_len: int = 64, n_prompts: int = 6,
               max_new_tokens: int = 8, *,
               serve_dtype: Optional[str] = None,
               device: DeviceLike = None,
               params: Optional[dict] = None) -> SeamHarness:
    """``DecodeEngine`` scheduling knobs (min_bucket, slots) over a fixed
    greedy workload (JAX's prompts: numpy's ``default_rng(0)``). The
    profiled call is the bucketed prefill at the candidate's smallest
    bucket into a KV cache of its slot count, the cache made inside the
    call so that both knobs shape the bytes and peak bytes; the prefill
    runs K3f on the card where the bucket reaches the flash gate
    (``ops.flash_attention``'s auto chain). Outputs are the generated
    token tuples; greedy decode is token-deterministic, so the match is
    EXACT. ``serve_dtype`` is the engines' (None: f32, as JAX's)."""
    from deeplearning4j_tpu_torch.models.transformer_lm import (
        init_kv_cache,
        lm_dims,
        make_prefill_step,
    )
    from deeplearning4j_tpu_torch.serve.quant import (
        activation_dtype,
        dequantize_tree,
        prepare_serve_params,
    )

    dev = resolve_device(device)
    params = _lm_params(params, vocab, d_model, n_heads, n_experts, d_ff,
                        n_layers, dev)
    dims = lm_dims(params)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, vocab, size=int(n)))
               for n in rng.integers(3, max_len // 2, size=n_prompts)]

    prefill = make_prefill_step(n_heads, params_transform=dequantize_tree)
    serve_params = prepare_serve_params(params, serve_dtype)
    head_dim = d_model // n_heads
    cache_dtype = activation_dtype(serve_dtype)

    def _prefill_fresh(bucket: int, slots: int):
        cache = init_kv_cache(n_layers, slots, n_heads, head_dim, max_len,
                              dtype=cache_dtype, device=dev)
        padded = torch.zeros((1, bucket), dtype=torch.long, device=dev)
        return prefill(serve_params, cache, padded, 0, 0,
                       torch.tensor(0.0, device=dev),
                       torch.Generator(device=dev).manual_seed(0))

    def compile_fn(cfg: Config):
        from deeplearning4j_tpu_torch.telemetry.xprofile import (
            profile_compiled,
        )
        bucket = int(cfg["min_bucket"])
        slots = int(cfg["slots"])
        return profile_compiled(_prefill_fresh, bucket, slots,
                                label=f"tune.serve[b{bucket}s{slots}]")

    _timed(dev, _prefill_fresh, 8, 4)   # the default config's
    engines: Dict[Tuple, Any] = {}

    def _engine(cfg: Config):
        from deeplearning4j_tpu_torch.serve.engine import DecodeEngine
        ck = _cfg_key(cfg)
        if ck not in engines:
            engines[ck] = DecodeEngine(
                params, n_heads, n_slots=int(cfg["slots"]),
                min_bucket=int(cfg["min_bucket"]), max_len=max_len,
                serve_dtype=serve_dtype, seed=0, tuned=False, device=dev)
        return engines[ck]

    def measure_fn(cfg: Config):
        eng = _engine(cfg)
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=max_new_tokens,
                           temperature=0.0) for p in prompts]
        while not all(r.done.is_set() for r in reqs):
            eng.step()
        # done is set after the engine reads each token to the host, so
        # nothing of the run is still queued on the card
        dt = time.perf_counter() - t0
        return dt, tuple(tuple(r.generated) for r in reqs)

    return SeamHarness(
        seam="serve",
        context=serve_context(dims, n_heads, max_len, device=dev),
        default_config={"min_bucket": 8, "slots": 4},
        compile_fn=compile_fn,
        measure_fn=measure_fn,
        outputs_match=lambda a, b: a == b,
        label="serve_engine",
        extras={"params": params, "dims": dims, "max_len": max_len,
                "prompts": prompts, "engines": engines})
