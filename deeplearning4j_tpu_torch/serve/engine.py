"""Counterpart of ``deeplearning4j_tpu/serve/engine.py``: the continuous-
batching decode engine for the transformer LM.

One engine owns:

- a **fixed-slot KV cache** (models/transformer_lm.init_kv_cache): S pages
  of (L, H, T_max, Dh) keys/values, one per concurrent request;
- a **decode step** (make_decode_step) whose shapes are pinned at S: every
  iteration advances EVERY slot one token (inactive slots carry masked
  garbage);
- a **prefill step** (make_prefill_step): admission pads the prompt to its
  bucket (powers of two from ``min_bucket`` up to ``max_len``), runs the
  full-prompt pass through the ``attn_impl`` seam (on a CUDA tensor, the
  buckets that resolve to "flash"/"blockwise" run the Hopper flash-attention
  kernel), seeds the slot's cache page, and samples the first token.

Scheduling is iteration-level continuous batching: each ``step()`` first
admits queued requests into free slots (prefill), then runs one decode
step; requests retire per decode step at EOS / ``max_new_tokens`` /
cache-page exhaustion, and the freed slot is reusable on the very next
iteration.

Serving fast path: three schedule optimizations, each token-identical to
the cold engine at f32 and each off by default.

- ``prefix_cache=``: shared-prefix KV page reuse (serve/prefix_cache.py).
  Admission looks up the longest cached page-aligned prefix, copies it
  into the slot's cache rows, and prefills ONLY the uncached suffix (one
  chunk-step call, plain-torch attention). A FULL hit (the cached prefix
  covers all but at most the last prompt token) runs no flagship prefill
  at all: the last prompt token rides the ordinary decode step, whose
  write-then-mask math gives exactly the prefill's last-position logits.
  Every flagship prefill-shaped call (classic or chunk) counts
  ``serve_prefill_dispatches_total``. Pages are inserted after each
  prefill completes, as clones of the slot's rows.
- ``prefill_chunk=``: prompts longer than the chunk prefill in fixed-width
  chunks, ONE chunk per scheduler iteration interleaved with decode
  steps, so a long admission no longer blocks every running request's
  next token. The final chunk shifts left to ``n - W`` rather than
  changing width. While a slot is mid-prefill its host position points
  at the next chunk's start, so the shared decode step's garbage write
  for that slot lands where the next chunk overwrites it first.
- ``speculative=`` / ``DL4J_TPU_SERVE_SPEC``: draft/verify speculative
  decoding (serve/speculative.py). A layer-truncated (or distilled) draft
  proposes k tokens per slot in k draft decode steps, each read back to
  the host because the next proposal feeds on it; the flagship verifies
  all k in ONE ``make_verify_step`` call of width k+1, and the host
  accepts the longest matching prefix plus the flagship's bonus token.
  Near the cache's end (positions + k + 1 > max_len) and while a slot is
  mid-chunk, an iteration takes the plain decode step instead.

Only the classic prefill (cold misses, and every draft admission) runs
``attention_core`` and so the flash kernel K3f; the chunk, suffix and
verify steps use the decode step's einsum attention.

Request tracing: when a process tracer is configured
(telemetry/trace.py), every request becomes a ``serve.request`` span with
``serve.queue_wait`` / ``serve.prefill`` / ``serve.decode`` /
``serve.retire`` children (``accept`` and ``verify`` events on the decode
span, the retire reason and weight version as attributes), and every
scheduler iteration an ``engine.step`` span; the names, parents and
attributes are the JAX engine's, so ``tools/trace_report.py`` reads them.
Unconfigured, each site is a None check. Latency histograms carry the
request's trace id as an exemplar.

The engine runs on CUDA unless built with ``device="cpu"``, and raises when
CUDA is absent. Metrics land in the port's registry under ``serve_*``.
``from_checkpoint`` builds an engine from an LM checkpoint of either
package (scaleout/ckpt), ``from_live_params`` from a params tree already in
memory, whole or sharded over a mesh. ``runprof=`` (True, a label or a
``telemetry.runprof.RunProfiler``; the ``DL4J_TPU_RUNPROF`` knob when
None) arms the runtime profiler at construction: one ``serve_decode``
``StepTiming`` a decode tick, its host phase the tick's scheduler work
(admission, chunked prefill, retirement), its device phase the decode
step's span on the stream (CUDA events; on the CPU the call's wall).
``tuned=`` adopts the autotuner's ``serve`` seam (``min_bucket`` and
``slots``) under the context the engine builds from its params' dims,
``n_heads``, ``max_len`` and its device type (``tune.seams.serve_context``).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import DeviceLike, resolve_device, \
    tree_map
from deeplearning4j_tpu_torch.models.transformer_lm import (
    draft_truncate_params,
    init_kv_cache,
    lm_dims,
    make_chunk_prefill_step,
    make_decode_step,
    make_prefill_step,
    make_verify_step,
)
from deeplearning4j_tpu_torch.serve.prefix_cache import (
    PrefixPageCache,
    seed_slot_pages,
)
from deeplearning4j_tpu_torch.serve.quant import (
    activation_dtype,
    dequantize_tree,
    params_nbytes,
    prepare_serve_params,
)
from deeplearning4j_tpu_torch.serve.speculative import (
    accept_longest_prefix,
    resolve_speculative,
)
from deeplearning4j_tpu_torch.telemetry import trace as _trace
from deeplearning4j_tpu_torch.utils.lockwatch import make_condition, make_rlock

_UNSET = object()


class ServeRequest:
    """One generation request's lifecycle record. ``done`` is set when the
    request retires; ``generated`` then holds the output tokens (EOS
    excluded) and ``finish_reason`` one of "eos" | "max_new_tokens" |
    "max_len". Timestamps are perf_counter seconds: ``t_submit`` →
    ``t_first`` (first token) → ``t_done``; ``t_tokens`` stamps every
    accepted token. ``bucket`` is set by a classic prefill only."""

    def __init__(self, rid: int, prompt: List[int], max_new_tokens: int,
                 temperature: float, eos_id: Optional[int]):
        self.rid = rid
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.generated: List[int] = []
        self.finish_reason: Optional[str] = None
        self.done = threading.Event()
        self.slot: Optional[int] = None
        self.bucket: Optional[int] = None
        self.t_submit: float = 0.0
        self.t_admit: Optional[float] = None
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None
        # tracing: None unless a process tracer is configured at submit
        self.span = None          # serve.request (submit → retire)
        self.queue_span = None    # serve.queue_wait (submit → admission)
        self.decode_span = None   # serve.decode (admission → retire)
        self.prefill_span = None  # serve.prefill (may span iterations)
        # outlives the span: the retire-time latency observations carry
        # it as their exemplar after serve.request has ended
        self.trace_id = None
        self.prefill_ms: float = 0.0
        self.decode_ms: float = 0.0  # sum of the decode steps it rode
        # prefill_ms = the prefix-cache seed time + the suffix/chunk or
        # classic compute time
        self.prefill_cached_ms: float = 0.0
        self.prefill_suffix_ms: float = 0.0
        self.cached_tokens: int = 0     # positions seeded from the cache
        self.prefill_chunks: int = 0    # chunk-step calls this request ran
        self.t_tokens: List[float] = []

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit


class DecodeEngine:
    """KV-cached autoregressive decode with continuous batching (module
    docstring). Thread-safe: ``submit``/``generate`` may be called from
    any thread; ``step`` serializes on an internal lock. ``start()`` runs
    the scheduler on a background thread; without it, ``generate`` drives
    the loop inline."""

    def __init__(self, params: dict, n_heads: int, *, n_slots: int = 4,
                 max_len: int = 256, top_k: int = 2,
                 attn_impl: Optional[str] = None,
                 serve_dtype: Optional[str] = "bf16",
                 eos_id: Optional[int] = None, seed: int = 0,
                 registry=None, min_bucket: int = 8,
                 weight_version: Optional[str] = None,
                 prefix_cache=False, prefix_page_tokens: int = 16,
                 prefix_cache_pages: int = 256,
                 prefill_chunk: Optional[int] = None,
                 speculative=None, runprof=None, tuned=None,
                 device: DeviceLike = None):
        from deeplearning4j_tpu_torch.telemetry.registry import (
            default_registry,
        )

        from deeplearning4j_tpu_torch.telemetry.runprof import \
            resolve_runprof

        self.device = resolve_device(device)
        # tuned=: adopt the autotuner's "serve" seam, min_bucket and slots
        # (scheduling knobs; greedy decode stays token-identical). The
        # engine builds its own cache-key context from what it knows, so
        # a bare tuned=True works here. Explicit dict > cache >
        # DL4J_TPU_TUNED env > off.
        if tuned is not False:
            from deeplearning4j_tpu_torch.tune.cache import \
                resolve_step_tuning
            from deeplearning4j_tpu_torch.tune.seams import serve_context

            ctx = serve_context(lm_dims(params), int(n_heads), int(max_len),
                                device=self.device)
            tuning = resolve_step_tuning(tuned, ctx, ("serve",))
            if "min_bucket" in tuning:
                min_bucket = int(tuning["min_bucket"])
            if "slots" in tuning:
                n_slots = int(tuning["slots"])
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        if prefill_chunk is not None and not (
                1 <= int(prefill_chunk) < max_len):
            raise ValueError(
                f"prefill_chunk must be in [1, max_len), got "
                f"{prefill_chunk}")
        self.dims = lm_dims(params)
        self.n_heads = int(n_heads)
        if self.dims["d_model"] % self.n_heads:
            raise ValueError(
                f"d_model {self.dims['d_model']} % n_heads {n_heads} != 0")
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.top_k = int(top_k)
        self.attn_impl = attn_impl
        self.serve_dtype = serve_dtype
        self.eos_id = eos_id
        self.weight_version = weight_version
        self.registry = registry if registry is not None else \
            default_registry()
        # the runtime profiler: one serve_decode timing a decode tick (no
        # step profile, so runprof_measured_mfu stays unborn)
        self._runprof = resolve_runprof(runprof)
        if self._runprof is not None and self._runprof._registry is None:
            # an engine on a private registry keeps its profiler there too
            self._runprof._registry = self.registry
        if self._runprof is not None:
            self._runprof.arm("serve_decode")
        params = tree_map(lambda _, x: x.to(self.device), params)
        self.params = prepare_serve_params(params, serve_dtype)
        self.weight_bytes = params_nbytes(self.params)
        head_dim = self.dims["d_model"] // self.n_heads
        cache_dtype = activation_dtype(serve_dtype)
        self._cache = init_kv_cache(self.dims["n_layers"], self.n_slots,
                                    self.n_heads, head_dim, self.max_len,
                                    dtype=cache_dtype, device=self.device)
        self._decode = make_decode_step(self.n_heads, self.top_k,
                                        params_transform=dequantize_tree)
        self._prefill = make_prefill_step(self.n_heads, self.top_k,
                                          attn_impl=attn_impl,
                                          params_transform=dequantize_tree)
        self._buckets = self._make_buckets(min_bucket)
        # --- serving fast path, every seam off by default ---
        self.prefill_chunk = (None if prefill_chunk is None
                              else int(prefill_chunk))
        if prefix_cache is True:
            self._prefix = PrefixPageCache(
                page_tokens=prefix_page_tokens,
                capacity_pages=prefix_cache_pages,
                registry=self.registry)
        else:
            self._prefix = prefix_cache or None
        # one chunk step serves chunked prefill AND the prefix suffix
        self._chunk = (make_chunk_prefill_step(
            self.n_heads, self.top_k, params_transform=dequantize_tree)
            if (self.prefill_chunk is not None or self._prefix is not None)
            else None)
        self._chunking: dict = {}       # slot -> pending chunk plan
        self.spec = resolve_speculative(speculative)
        if self.spec is not None:
            if self.spec.k + 1 >= max_len:
                raise ValueError(
                    f"speculative k={self.spec.k} needs k+1 < max_len "
                    f"({max_len})")
            draft_raw = (tree_map(lambda _, x: x.to(self.device),
                                  self.spec.draft_params)
                         if self.spec.draft_params is not None
                         else draft_truncate_params(params,
                                                    self.spec.draft_layers))
            self._draft_params = prepare_serve_params(draft_raw,
                                                      serve_dtype)
            self._draft_cache = init_kv_cache(
                lm_dims(draft_raw)["n_layers"], self.n_slots,
                self.n_heads, head_dim, self.max_len, dtype=cache_dtype,
                device=self.device)
            self._draft_decode = make_decode_step(
                self.n_heads, self.top_k, params_transform=dequantize_tree)
            self._draft_prefill = make_prefill_step(
                self.n_heads, self.top_k, attn_impl=attn_impl,
                params_transform=dequantize_tree)
            self._verify = make_verify_step(
                self.n_heads, self.top_k, params_transform=dequantize_tree)
        self.spec_verify_steps = 0
        self.spec_accepted_total = 0
        self._spec_proposed_total = 0
        # the counter the full-prefix-hit check reads exists (at 0) from
        # construction; the spec instruments likewise when armed
        self.registry.counter("serve_prefill_dispatches_total")
        if self.spec is not None:
            for name in ("serve_spec_verify_steps_total",
                         "serve_spec_accepted_tokens_total",
                         "serve_spec_draft_prefills_total",
                         "serve_spec_draft_steps_total"):
                self.registry.counter(name)
            self.registry.histogram("serve_spec_accepted_per_verify")
            self.registry.histogram("serve_verify_step_ms")
            # serve_spec_accept_rate stays unborn until 8 verify steps
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(seed))
        self._lock = make_rlock("serve.engine")
        self._work = make_condition(self._lock, name="serve.engine")
        self._queue: List[ServeRequest] = []
        self._slots: List[Optional[ServeRequest]] = [None] * self.n_slots
        # host mirrors of the decode step's per-slot inputs
        self._tokens = np.zeros((self.n_slots,), np.int64)
        self._positions = np.zeros((self.n_slots,), np.int64)
        self._temps = np.zeros((self.n_slots,), np.float32)
        self._rid = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        # aggregate accounting for stats()
        self.tokens_total = 0
        self.requests_total = 0
        self.decode_steps = 0
        self._occupancy_sum = 0
        self._t_first_activity: Optional[float] = None

    # ------------------------------------------------------------ loading ----
    @classmethod
    def from_checkpoint(cls, root: str, *, n_heads: Optional[int] = None,
                        step: Optional[int] = None, **kwargs):
        """Build an engine from an LM checkpoint under ``root`` (the latest
        committed step, or ``step``): the manifest supplies the template,
        ``meta["lm"]`` (``lm_checkpoint_meta``) or the ``n_heads`` argument
        the head count the shapes erase. The params are restored straight
        onto the engine's device (``device=`` in ``kwargs``, CUDA unless
        "cpu")."""
        import os

        from deeplearning4j_tpu_torch.scaleout.ckpt import manifest as mf
        from deeplearning4j_tpu_torch.scaleout.ckpt.checkpointer import (
            Checkpointer,
        )
        from deeplearning4j_tpu_torch.scaleout.ckpt.reshard import (
            latest_step_dir,
            template_from_manifest,
        )

        if step is None:
            step_dir = latest_step_dir(root)
            if step_dir is None:
                raise FileNotFoundError(
                    f"no committed checkpoint under {root}")
        else:
            step_dir = os.path.join(root, mf.step_dir_name(step))
        manifest = mf.read_manifest(step_dir)
        template = template_from_manifest(manifest)
        state, _step, meta = Checkpointer(root).restore(
            template, step=manifest.step, device=kwargs.get("device"))
        # training saves wrap the tree as {"params": ...}; unwrap either way
        params = state.get("params", state) if isinstance(state, dict) \
            else state
        if not (isinstance(params, dict) and "embed" in params
                and "blocks" in params):
            raise ValueError(
                f"checkpoint under {root} is not a flagship-LM params tree "
                "(no embed/blocks leaves) — the decode engine serves "
                "models/transformer_lm checkpoints only")
        lm_meta = (meta or {}).get("lm") or {}
        n_heads = n_heads if n_heads is not None else lm_meta.get("n_heads")
        if n_heads is None:
            raise ValueError(
                "n_heads is not recoverable from param shapes — save with "
                "meta=lm_checkpoint_meta(params, n_heads) or pass n_heads=")
        kwargs.setdefault("top_k", int(lm_meta.get("top_k", 2)))
        kwargs.setdefault("weight_version", f"ckpt-step-{manifest.step}")
        return cls(params, int(n_heads), **kwargs)

    @classmethod
    def from_live_params(cls, params, n_heads: int, *, shardings=None,
                         mesh=None, device: DeviceLike = None, **kwargs):
        """Cold start from a params tree already in memory, e.g. a live
        trainer's: every leaf is copied device to device onto the serving
        device (CUDA unless ``device="cpu"``), never through the host. The
        engine is token-identical to one built from the same params
        directly. With ``shardings`` (a spec tree such as
        ``lm_param_shardings``') and ``mesh``, ``params`` is this rank's
        sharded tree: every rank of the mesh calls this, each sharded leaf
        is all-gathered rank to rank (``scaleout.ckpt.redistribute_tree``'s
        rebind off the mesh), and each rank gets the whole engine."""
        dev = resolve_device(device)
        if shardings is not None:
            from deeplearning4j_tpu_torch.scaleout.ckpt.redistribution \
                import Placement, placements, redistribute_tree

            params = redistribute_tree(
                params, Placement(), placements(shardings, params, mesh))
        kwargs.setdefault("weight_version", "live-params")
        return cls(tree_map(lambda _, x: x.to(dev), params), int(n_heads),
                   device=dev, **kwargs)

    # ---------------------------------------------------------- admission ----
    def _make_buckets(self, min_bucket: int) -> List[int]:
        buckets, b = [], max(2, int(min_bucket))
        while b < self.max_len:
            buckets.append(b)
            b *= 2
        buckets.append(self.max_len)
        return buckets

    def bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        return self.max_len

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               temperature: float = 0.0,
               eos_id=_UNSET) -> ServeRequest:
        """Enqueue a request (admitted into a slot by a later ``step``).
        ``temperature <= 0`` is greedy; ``eos_id`` defaults to the
        engine's (None = never)."""
        prompt = [int(t) for t in prompt]
        vocab = self.dims["vocab"]
        if not prompt:
            raise ValueError("empty prompt")
        if any(t < 0 or t >= vocab for t in prompt):
            raise ValueError(f"prompt tokens must be in [0, {vocab})")
        if len(prompt) > self.max_len - 1:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds max_len-1 = "
                f"{self.max_len - 1} (one cache position must remain for "
                "generation)")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        req = ServeRequest(next(self._rid), prompt, max_new_tokens,
                           temperature,
                           self.eos_id if eos_id is _UNSET else eos_id)
        req.t_submit = time.perf_counter()
        tracer = _trace.get_tracer()
        if tracer is not None:
            # parents under the submitting thread's current span, or roots
            # a fresh trace; the children below parent under it
            # explicitly, since they run on the scheduler's thread
            req.span = tracer.start_span(
                "serve.request",
                attrs={"rid": req.rid, "prompt_len": len(prompt),
                       "max_new_tokens": req.max_new_tokens,
                       "temperature": req.temperature,
                       "weight_version": self.weight_version})
            req.queue_span = tracer.start_span("serve.queue_wait",
                                               parent=req.span)
            req.trace_id = req.span.trace_id
        with self._work:
            self._queue.append(req)
            self.requests_total += 1
            if self._t_first_activity is None:
                self._t_first_activity = req.t_submit
            self.registry.counter("serve_requests_total").inc()
            self.registry.gauge("serve_queue_depth").set(
                float(len(self._queue)))
            self._work.notify_all()
        return req

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slots) if r is None]

    def _padded(self, tokens: Sequence[int], width: int) -> torch.Tensor:
        """``tokens`` right-padded with zeros to (1, width) on the device."""
        padded = np.zeros((1, width), np.int64)
        padded[0, :len(tokens)] = tokens
        return torch.from_numpy(padded).to(self.device)

    def _admit(self, req: ServeRequest, slot: int) -> None:
        n = len(req.prompt)
        if req.queue_span is not None:
            req.queue_span.end()
            req.queue_span = None
        req.t_admit = time.perf_counter()
        req.slot = slot
        self._slots[slot] = req
        self._temps[slot] = req.temperature
        # ---- prefix-cache lookup + slot seed (no flagship compute) ----
        plen = 0
        if self._prefix is not None:
            t0 = time.perf_counter()
            plen, k_pages, v_pages = self._prefix.lookup(req.prompt)
            if plen:
                seed_slot_pages(self._cache["k"], self._cache["v"],
                                torch.cat(k_pages, dim=2),
                                torch.cat(v_pages, dim=2), slot)
                # an attribution stamp, not a device time: the copy is
                # fenced by the step that next reads the cache
                req.prefill_cached_ms = (time.perf_counter() - t0) * 1000.0
                req.prefill_ms += req.prefill_cached_ms
            req.cached_tokens = plen
        req.prefill_span = (req.span.tracer.start_span(
            "serve.prefill", parent=req.span,
            attrs={"slot": slot, "prompt_len": n, "cached_tokens": plen})
            if req.span is not None else None)
        if self.spec is not None:
            self._draft_admit(req, slot, n)
        # ---- full hit: the cached prefix covers every position the last
        # prompt token's decode step does not write itself: NO flagship
        # prefill; the first token comes from the shared decode step ----
        if plen >= n - 1:
            self._tokens[slot] = req.prompt[-1]
            self._positions[slot] = n - 1
            self._finish_prefill_span(req, mode="cached_full")
            if req.span is not None:
                req.decode_span = req.span.tracer.start_span(
                    "serve.decode", parent=req.span, attrs={"slot": slot})
            return
        # ---- chunked path: long prompts (or any cached-prefix suffix)
        # run through the chunk step, one chunk per scheduler iteration
        # when prefill_chunk is configured ----
        if self._chunk is not None and (
                plen > 0 or (self.prefill_chunk is not None
                             and n > self.prefill_chunk)):
            plan = self._chunk_plan(req, plen)
            if self.prefill_chunk is not None and len(plan) > 1:
                # garbage-write shield: the shared decode step writes this
                # slot at _positions; point it where the next chunk
                # overwrites before any query can read it
                self._positions[slot] = plan[0][1]
                self._chunking[slot] = {"req": req, "plan": plan,
                                        "idx": 0}
                return
            for idx in range(len(plan)):
                self._run_chunk(req, slot, plan, idx)
            return
        # ---- classic one-shot bucketed prefill ----
        bucket = self.bucket_for(n)
        req.bucket = bucket
        if req.prefill_span is not None:
            req.prefill_span.set_attr("bucket", bucket)
        t0 = time.perf_counter()
        self._cache, tok = self._prefill(
            self.params, self._cache, self._padded(req.prompt, bucket),
            n - 1, slot, torch.tensor(req.temperature, device=self.device),
            self._generator)
        self.registry.counter("serve_prefill_dispatches_total").inc()
        tok = int(tok)  # fences the prefill: slot state changes with it
        now = time.perf_counter()
        req.prefill_suffix_ms += (now - t0) * 1000.0
        req.prefill_ms += (now - t0) * 1000.0
        self._complete_prefill(req, slot, tok, now, mode="full")

    def _draft_admit(self, req: ServeRequest, slot: int, n: int) -> None:
        """Seed the DRAFT cache for an admitted slot (speculative only):
        one draft-prefill call over the full prompt, counted apart from
        ``serve_prefill_dispatches_total`` (that one counts flagship
        work; the draft is the cost of speculation)."""
        self._draft_cache, _ = self._draft_prefill(
            self._draft_params, self._draft_cache,
            self._padded(req.prompt, self.bucket_for(n)), n - 1, slot,
            torch.tensor(0.0, device=self.device), self._generator)
        self.registry.counter("serve_spec_draft_prefills_total").inc()

    def _chunk_plan(self, req: ServeRequest, plen: int) -> list:
        """Chunk schedule covering prompt positions [plen, n): a list of
        ``(tokens (1, W) np.int64, start, last_idx)``. Interleaved mode
        (prefill_chunk set, suffix > chunk) uses W = prefill_chunk with the
        FINAL chunk shifted left to ``n - W`` (same width; the overlap
        rewrites identical values); the prefix-suffix one-shot uses one
        bucket-width chunk. Every start keeps start + W <= max_len, where
        torch indexing would raise."""
        n = len(req.prompt)
        C = self.prefill_chunk
        if C is not None and n - plen > C:
            starts = list(range(plen, n - C, C))
            starts.append(n - C)
            width = C
        else:
            width = min(self.bucket_for(n - plen), self.max_len)
            starts = [max(0, n - width)]
        plan = []
        for i, s in enumerate(starts):
            toks = np.zeros((1, width), np.int64)
            real = req.prompt[s:min(s + width, n)]
            toks[0, :len(real)] = real
            last_idx = (n - 1 - s) if i == len(starts) - 1 else width - 1
            plan.append((toks, s, last_idx))
        return plan

    def _run_chunk(self, req: ServeRequest, slot: int, plan: list,
                   idx: int) -> None:
        """Run chunk ``idx``; on the final chunk, complete the admission
        with its sampled first token."""
        toks, start, last_idx = plan[idx]
        final = idx == len(plan) - 1
        t0 = time.perf_counter()
        self._cache, tok = self._chunk(
            self.params, self._cache, torch.from_numpy(toks).to(self.device),
            start, last_idx, slot,
            torch.tensor(req.temperature, device=self.device),
            self._generator)
        self.registry.counter("serve_prefill_dispatches_total").inc()
        req.prefill_chunks += 1
        if final:
            tok = int(tok)  # fences the chunk, as the classic prefill
        now = time.perf_counter()
        req.prefill_suffix_ms += (now - t0) * 1000.0
        req.prefill_ms += (now - t0) * 1000.0
        if final:
            self._chunking.pop(slot, None)
            self._complete_prefill(
                req, slot, tok, now,
                mode="suffix" if req.cached_tokens else "chunked")
        else:
            # shield: the next chunk overwrites [next_start, + W)
            self._positions[slot] = plan[idx + 1][1]

    def _complete_prefill(self, req: ServeRequest, slot: int, tok: int,
                          now: float, mode: str) -> None:
        """Prompt K/V fully resident: publish its pages to the prefix
        cache (which clones them), arm decode state, accept the first
        token."""
        if self._prefix is not None:
            n_pages = len(req.prompt) // self._prefix.page_tokens
            if n_pages:
                span = n_pages * self._prefix.page_tokens
                self._prefix.insert(
                    req.prompt,
                    self._cache["k"][:, slot, :, :span, :],
                    self._cache["v"][:, slot, :, :span, :])
        self.registry.histogram("serve_prefill_ms").observe(
            req.prefill_ms, exemplar=req.trace_id)
        self._finish_prefill_span(req, mode=mode)
        self._positions[slot] = len(req.prompt)
        if req.span is not None:
            # started BEFORE the first accept: max_new_tokens=1 or an
            # instant EOS retire the request inside this very call
            req.decode_span = req.span.tracer.start_span(
                "serve.decode", parent=req.span, attrs={"slot": slot})
        self._accept_token(req, tok, now)

    def _finish_prefill_span(self, req: ServeRequest, mode: str) -> None:
        if req.prefill_span is None:
            return
        req.prefill_span.set_attr("mode", mode)
        req.prefill_span.set_attr("cached_tokens", req.cached_tokens)
        req.prefill_span.set_attr("chunks", req.prefill_chunks)
        req.prefill_span.set_attr("cached_ms",
                                  round(req.prefill_cached_ms, 3))
        req.prefill_span.set_attr("suffix_ms",
                                  round(req.prefill_suffix_ms, 3))
        req.prefill_span.end()
        req.prefill_span = None

    def _accept_token(self, req: ServeRequest, tok: int, now: float) -> None:
        """Record one sampled token for ``req`` and retire it at EOS /
        max_new_tokens / cache exhaustion (iteration-level eviction)."""
        if req.t_first is None:
            # for a full prefix hit that is the shared decode step
            req.t_first = now
        if req.eos_id is not None and tok == req.eos_id:
            self._finish(req, "eos", now)
            return
        req.generated.append(tok)
        req.t_tokens.append(now)
        if req.decode_span is not None:
            req.decode_span.add_event("accept", token=tok,
                                      n=len(req.generated))
        self.tokens_total += 1
        self.registry.counter("serve_tokens_total").inc()
        if len(req.generated) >= req.max_new_tokens:
            self._finish(req, "max_new_tokens", now)
        elif int(self._positions[req.slot]) >= self.max_len:
            # the cache page is exhausted: this token was the last that fits
            self._finish(req, "max_len", now)
        else:
            self._tokens[req.slot] = tok

    def _finish(self, req: ServeRequest, reason: str, now: float) -> None:
        req.finish_reason = reason
        req.t_done = now
        if req.span is not None:
            if req.decode_span is not None:
                req.decode_span.set_attr("decode_ms",
                                         round(req.decode_ms, 3))
                req.decode_span.set_attr("tokens", len(req.generated))
                req.decode_span.end()
                req.decode_span = None
            retire = req.span.tracer.start_span(
                "serve.retire", parent=req.span,
                attrs={"reason": reason, "tokens": len(req.generated),
                       "weight_version": self.weight_version})
            retire.end()
            # the attribution tools/trace_report.py tables: queue_wait +
            # prefill + decode + gap = latency by construction (gap: time
            # admitted but outside the request's own steps)
            queue_ms = ((req.t_admit or now) - req.t_submit) * 1000.0
            latency_ms = (now - req.t_submit) * 1000.0
            req.span.set_attr("queue_wait_ms", round(queue_ms, 3))
            req.span.set_attr("prefill_ms", round(req.prefill_ms, 3))
            req.span.set_attr("prefill_cached_ms",
                              round(req.prefill_cached_ms, 3))
            req.span.set_attr("prefill_suffix_ms",
                              round(req.prefill_suffix_ms, 3))
            req.span.set_attr("cached_tokens", req.cached_tokens)
            req.span.set_attr("decode_ms", round(req.decode_ms, 3))
            req.span.set_attr("gap_ms", round(
                latency_ms - queue_ms - req.prefill_ms - req.decode_ms, 3))
            req.span.set_attr("latency_ms", round(latency_ms, 3))
            req.span.set_attr("tokens", len(req.generated))
            req.span.set_attr("finish_reason", reason)
            req.span.end()
            req.span = None
        if req.slot is not None:
            self._slots[req.slot] = None
            self._tokens[req.slot] = 0
            self._positions[req.slot] = 0
            self._temps[req.slot] = 0.0
            req.slot = None
        self.registry.counter("serve_completed_total",
                              {"reason": reason}).inc()
        self.registry.histogram("serve_request_ms").observe(
            (now - req.t_submit) * 1000.0, exemplar=req.trace_id)
        if req.t_first is not None:
            self.registry.histogram("serve_first_token_ms").observe(
                (req.t_first - req.t_submit) * 1000.0,
                exemplar=req.trace_id)
        req.done.set()

    # ------------------------------------------------------------- stepping ----
    def has_work(self) -> bool:
        with self._lock:
            return bool(self._queue) or any(
                r is not None for r in self._slots)

    def step(self) -> int:
        """One scheduler iteration: admit into free slots, run one chunk
        for each slot mid-prefill, then one decode (or speculative) step
        over every slot. Returns tokens emitted (0 = idle)."""
        tracer = _trace.get_tracer()
        step_span = (tracer.start_span("engine.step", parent=False)
                     if tracer is not None else None)
        t_sched0 = time.perf_counter()  # the runtime profiler's phase clock
        with self._lock:
            tokens_before = self.tokens_total
            free = self._free_slots()
            admitted = 0
            while self._queue and free:
                self._admit(self._queue.pop(0), free.pop(0))
                admitted += 1
            self.registry.gauge("serve_queue_depth").set(
                float(len(self._queue)))
            # ---- chunked prefill: ONE chunk per mid-prefill slot per
            # iteration, interleaved with the decode steps ----
            for slot in list(self._chunking):
                st = self._chunking[slot]
                self._run_chunk(st["req"], slot, st["plan"], st["idx"])
                if slot in self._chunking:
                    st["idx"] += 1
            active = [r for r in self._slots
                      if r is not None and r.slot not in self._chunking]
            self.registry.gauge("serve_active_slots").set(
                float(len(active)))
            if not active:
                if step_span is not None:
                    step_span.set_attr("admissions", admitted)
                    step_span.set_attr("occupancy", 0)
                    step_span.set_attr("idle", not self._chunking)
                    step_span.end()
                return self.tokens_total - tokens_before
            # ---- speculative eligibility: the verify step writes k+1
            # positions per slot; near the page end (or while a slot is
            # mid-chunk) take the plain decode step, as JAX does, where
            # dynamic_update_slice would clamp and torch would raise ----
            spec_tick = (
                self.spec is not None and not self._chunking
                and all(int(self._positions[r.slot]) + self.spec.k + 1
                        <= self.max_len for r in active))
            if spec_tick:
                decode_ms = self._spec_step(active, step_span)
                # k+1 draft steps with their reads and a verify: no clean
                # dispatch/device split, the whole wall goes to the device
                rp_dispatch_ms, rp_device_ms = 0.0, decode_ms
            else:
                # every slot writes its K/V at its position: JAX's
                # dynamic_update_slice would clamp an out-of-range start
                # onto live positions, torch indexing would fault;
                # neither may happen (_accept_token retires at max_len)
                if int(self._positions.max()) >= self.max_len:
                    raise RuntimeError(
                        f"decode position {int(self._positions.max())} "
                        f"outside the cache page (max_len {self.max_len})")
                events = None
                if self._runprof is not None and self.device.type == "cuda":
                    events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                    events[0].record()
                t0 = time.perf_counter()
                self._cache, toks = self._decode(
                    self.params, self._cache,
                    torch.from_numpy(self._tokens).to(self.device),
                    torch.from_numpy(self._positions).to(self.device),
                    torch.from_numpy(self._temps).to(self.device),
                    self._generator)
                t_disp = time.perf_counter()
                if events is not None:
                    events[1].record()
                toks = toks.cpu().numpy()  # fences the step for retirement
                now = time.perf_counter()
                decode_ms = (now - t0) * 1000.0
                rp_dispatch_ms = (t_disp - t0) * 1000.0
                rp_device_ms = (events[0].elapsed_time(events[1])
                                if events is not None else rp_dispatch_ms)
                self.registry.histogram("serve_decode_step_ms").observe(
                    decode_ms)
                self.decode_steps += 1
                self._occupancy_sum += len(active)
                for req in active:
                    if req.decode_span is not None:
                        req.decode_ms += decode_ms
                    self._positions[req.slot] += 1
                    self._accept_token(req, int(toks[req.slot]), now)
            occupancy_after = sum(r is not None for r in self._slots)
            self.registry.gauge("serve_active_slots").set(
                float(occupancy_after))
            if step_span is not None:
                step_span.set_attr("admissions", admitted)
                step_span.set_attr("occupancy", len(active))
                step_span.set_attr("retired",
                                   len(active) - occupancy_after)
                step_span.set_attr("queue_depth", len(self._queue))
                step_span.set_attr("decode_ms", round(decode_ms, 3))
                step_span.end()
            if self._runprof is not None:
                from deeplearning4j_tpu_torch.telemetry.runprof import \
                    StepTiming

                # host phase: this tick's scheduler work (admission,
                # chunked prefill, retirement), everything outside the
                # decode call and its fence
                sched_ms = max(0.0, (time.perf_counter() - t_sched0)
                               * 1000.0 - decode_ms)
                self._runprof.record(StepTiming(
                    label="serve_decode", t_unix=time.time(),
                    wall_ms=decode_ms, host_ms=sched_ms,
                    dispatch_ms=rp_dispatch_ms, device_ms=rp_device_ms,
                    trace_id=(step_span.trace_id
                              if step_span is not None else None)))
            return self.tokens_total - tokens_before

    def _spec_step(self, active: List[ServeRequest], step_span) -> float:
        """One speculative iteration (under the scheduler lock): k draft
        decode steps propose, ONE flagship verify step of width k+1
        checks, the host accepts the longest matching prefix + the
        flagship's bonus token per slot. Greedy slots emit 1..k+1 tokens
        per flagship call and the stream is exactly the non-speculative
        one; sampling slots accept only position 0's sampled token."""
        k = self.spec.k
        t0 = time.perf_counter()
        drafts = np.zeros((self.n_slots, k), np.int64)
        cur = self._tokens.copy()
        dpos = self._positions.copy()
        temps = torch.from_numpy(self._temps).to(self.device)
        # k+1 draft steps, not k: the extra one writes the LAST proposal's
        # K/V into the draft cache, so a fully accepted round leaves no
        # hole at p+k when the next round starts from p+k+1 (its proposal
        # is discarded). Eligibility (p + k + 1 <= max_len) bounds every
        # write.
        for j in range(k + 1):
            self._draft_cache, dt = self._draft_decode(
                self._draft_params, self._draft_cache,
                torch.from_numpy(cur).to(self.device),
                torch.from_numpy(dpos).to(self.device), temps,
                self._generator)
            if j < k:
                # proposal j+1 feeds on proposal j: one host read each
                dt = dt.cpu().numpy()
                drafts[:, j] = dt
                cur = dt.astype(np.int64)
            dpos += 1
        self.registry.counter("serve_spec_draft_steps_total").inc(k + 1)
        t1 = time.perf_counter()
        vt = np.concatenate([self._tokens[:, None], drafts], axis=1)
        self._cache, vtoks = self._verify(
            self.params, self._cache, torch.from_numpy(vt).to(self.device),
            torch.from_numpy(self._positions).to(self.device), temps,
            self._generator)
        vtoks = vtoks.cpu().numpy()  # fences the verify for acceptance
        now = time.perf_counter()
        draft_ms = (t1 - t0) * 1000.0
        verify_ms = (now - t1) * 1000.0
        # a slow verify is attributable to a real request's trace
        self.registry.histogram("serve_verify_step_ms").observe(
            verify_ms, exemplar=active[0].trace_id)
        self.registry.histogram("serve_decode_step_ms").observe(
            draft_ms + verify_ms)
        self.registry.counter("serve_spec_verify_steps_total").inc()
        self.spec_verify_steps += 1
        self.decode_steps += 1
        self._occupancy_sum += len(active)
        for req in active:
            slot = req.slot
            p = int(self._positions[slot])
            if req.temperature > 0:
                a, emitted = 0, [int(vtoks[slot, 0])]
            else:
                a, emitted = accept_longest_prefix(drafts[slot],
                                                   vtoks[slot])
            self.spec_accepted_total += a
            self._spec_proposed_total += k
            self.registry.counter(
                "serve_spec_accepted_tokens_total").inc(a)
            self.registry.histogram(
                "serve_spec_accepted_per_verify").observe(
                float(a), exemplar=req.trace_id)
            if req.decode_span is not None:
                req.decode_ms += draft_ms + verify_ms
                req.decode_span.add_event("verify", accepted=a,
                                          proposed=k,
                                          emitted=len(emitted))
            for j, tok in enumerate(emitted):
                self._positions[slot] = p + j + 1
                self._accept_token(req, tok, now)
                if req.done.is_set():
                    break  # retired mid-run; trailing tokens discarded
        if self.spec_verify_steps >= 8:
            self.registry.gauge("serve_spec_accept_rate").set(
                self.spec_accepted_total
                / max(1, self._spec_proposed_total))
        if step_span is not None:
            step_span.set_attr("speculative", True)
            step_span.set_attr("draft_ms", round(draft_ms, 3))
        return draft_ms + verify_ms

    def run_until_idle(self, max_steps: int = 100_000) -> int:
        """Drive ``step`` until queue and slots drain; returns tokens."""
        total = 0
        for _ in range(max_steps):
            if not self.has_work():
                return total
            total += self.step()
        raise RuntimeError(f"engine still busy after {max_steps} steps")

    # ------------------------------------------------------- request API ----
    def generate(self, prompt: Sequence[int], max_new_tokens: int = 16,
                 temperature: float = 0.0, eos_id=_UNSET,
                 timeout: Optional[float] = None) -> List[int]:
        """Blocking convenience: submit + wait (background loop running)
        or submit + drive inline. Returns the generated tokens."""
        req = self.submit(prompt, max_new_tokens=max_new_tokens,
                          temperature=temperature, eos_id=eos_id)
        if self._thread is None:
            deadline = None if timeout is None else \
                time.perf_counter() + timeout
            while not req.done.is_set():
                self.step()
                if deadline is not None and time.perf_counter() > deadline:
                    raise TimeoutError(f"request {req.rid} timed out")
        elif not req.done.wait(timeout):
            raise TimeoutError(f"request {req.rid} timed out")
        return list(req.generated)

    # --------------------------------------------------- background loop ----
    def start(self) -> None:
        """Run the scheduler on a daemon thread (handler threads submit,
        one loop decodes)."""
        with self._lock:
            if self._thread is not None:
                return
            self._running = True
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def _loop(self) -> None:
        while True:
            with self._work:
                while self._running and not (
                        self._queue or any(r is not None
                                           for r in self._slots)):
                    self._work.wait(0.05)
                if not self._running:
                    return
            self.step()

    def stop(self) -> None:
        # swap the handle under the lock, join outside it: the loop needs
        # the lock to observe _running
        with self._work:
            self._running = False
            self._work.notify_all()
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10)

    # -------------------------------------------------------------- stats ----
    def stats(self) -> dict:
        """Scheduler state + throughput + per-in-flight-request ages, with
        the JAX engine's keys."""
        with self._lock:
            now = time.perf_counter()
            in_flight = []
            for r in self._queue:
                in_flight.append({
                    "rid": r.rid, "state": "queued",
                    "queued_s": round(now - r.t_submit, 3),
                    "tokens": 0, "prompt_len": len(r.prompt)})
            for r in self._slots:
                if r is None:
                    continue
                in_flight.append({
                    "rid": r.rid, "state": "running", "slot": r.slot,
                    "queued_s": round(
                        ((r.t_admit or now) - r.t_submit), 3),
                    "running_s": round(now - (r.t_admit or now), 3),
                    "tokens": len(r.generated),
                    "prompt_len": len(r.prompt)})
            active = sum(r is not None for r in self._slots)
            elapsed = (now - self._t_first_activity
                       if self._t_first_activity is not None else 0.0)
            return {
                "slots": self.n_slots,
                "active_slots": active,
                "queue_depth": len(self._queue),
                "max_len": self.max_len,
                "serve_dtype": self.serve_dtype or "f32",
                "weight_bytes": self.weight_bytes,
                "weight_version": self.weight_version,
                "prefill_buckets": list(self._buckets),
                "requests_total": self.requests_total,
                "tokens_total": self.tokens_total,
                "decode_steps": self.decode_steps,
                "occupancy_mean": (self._occupancy_sum / self.decode_steps
                                   if self.decode_steps else 0.0),
                "tokens_per_sec": (self.tokens_total / elapsed
                                   if elapsed > 0 else 0.0),
                "in_flight": in_flight,
                "prefill_chunk": self.prefill_chunk,
                "chunking_slots": len(self._chunking),
                "prefix_cache": (self._prefix.stats()
                                 if self._prefix is not None else None),
                "speculative": ({
                    "k": self.spec.k,
                    "verify_steps": self.spec_verify_steps,
                    "accepted_tokens": self.spec_accepted_total,
                    "accept_rate": (
                        self.spec_accepted_total
                        / max(1, self._spec_proposed_total)),
                } if self.spec is not None else None),
                "model": dict(self.dims, n_heads=self.n_heads,
                              top_k=self.top_k),
            }

    def metrics_record(self) -> dict:
        """Every ``serve_*`` instrument in this engine's registry as a flat
        ``{name: value}`` dict."""
        from deeplearning4j_tpu_torch.telemetry.registry import flat_record

        return flat_record(self.registry, prefixes=("serve_",))
