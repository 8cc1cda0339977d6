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

The engine runs on CUDA unless built with ``device="cpu"``, and raises when
CUDA is absent. Metrics land in the port's registry under ``serve_*``.
``from_checkpoint`` builds an engine from an LM checkpoint of either
package (scaleout/ckpt), ``from_live_params`` from a params tree already in
memory. The prefix cache, chunked prefill, speculative decoding, request
tracing, the runtime profiler and ``tuned=`` come with later slices.
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
    init_kv_cache,
    lm_dims,
    make_decode_step,
    make_prefill_step,
)
from deeplearning4j_tpu_torch.serve.quant import (
    activation_dtype,
    dequantize_tree,
    params_nbytes,
    prepare_serve_params,
)

_UNSET = object()


class ServeRequest:
    """One generation request's lifecycle record. ``done`` is set when the
    request retires; ``generated`` then holds the output tokens (EOS
    excluded) and ``finish_reason`` one of "eos" | "max_new_tokens" |
    "max_len". Timestamps are perf_counter seconds: ``t_submit`` →
    ``t_first`` (first token) → ``t_done``."""

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
        self.prefill_ms: float = 0.0

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
                 device: DeviceLike = None):
        from deeplearning4j_tpu_torch.telemetry.registry import (
            default_registry,
        )

        self.device = resolve_device(device)
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
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
        params = tree_map(lambda _, x: x.to(self.device), params)
        self.params = prepare_serve_params(params, serve_dtype)
        self.weight_bytes = params_nbytes(self.params)
        head_dim = self.dims["d_model"] // self.n_heads
        self._cache = init_kv_cache(self.dims["n_layers"], self.n_slots,
                                    self.n_heads, head_dim, self.max_len,
                                    dtype=activation_dtype(serve_dtype),
                                    device=self.device)
        self._decode = make_decode_step(self.n_heads, self.top_k,
                                        params_transform=dequantize_tree)
        self._prefill = make_prefill_step(self.n_heads, self.top_k,
                                          attn_impl=attn_impl,
                                          params_transform=dequantize_tree)
        self._buckets = self._make_buckets(min_bucket)
        self.registry.counter("serve_prefill_dispatches_total")
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(seed))
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
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
    def from_live_params(cls, params, n_heads: int, *,
                         device: DeviceLike = None, **kwargs):
        """Cold start from a params tree already in memory, e.g. a live
        trainer's: every leaf is copied device to device onto the serving
        device (CUDA unless ``device="cpu"``), never through the host. The
        engine is token-identical to one built from the same params
        directly. Redistribution from a tree sharded over several cards
        comes with ROADMAP slices 7 and 8."""
        dev = resolve_device(device)
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

    def _admit(self, req: ServeRequest, slot: int) -> None:
        """Classic one-shot bucketed prefill into ``slot``."""
        n = len(req.prompt)
        req.t_admit = time.perf_counter()
        req.slot = slot
        self._slots[slot] = req
        self._temps[slot] = req.temperature
        bucket = self.bucket_for(n)
        req.bucket = bucket
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :n] = req.prompt
        t0 = time.perf_counter()
        self._cache, tok = self._prefill(
            self.params, self._cache,
            torch.from_numpy(padded).to(self.device), n - 1, slot,
            torch.tensor(req.temperature, device=self.device),
            self._generator)
        self.registry.counter("serve_prefill_dispatches_total").inc()
        tok = int(tok)  # fences the prefill: slot state changes with it
        now = time.perf_counter()
        req.prefill_ms += (now - t0) * 1000.0
        self._complete_prefill(req, slot, tok, now)

    def _complete_prefill(self, req: ServeRequest, slot: int, tok: int,
                          now: float) -> None:
        """Prompt K/V resident: arm decode state, accept the first token."""
        self.registry.histogram("serve_prefill_ms").observe(req.prefill_ms)
        self._positions[slot] = len(req.prompt)
        self._accept_token(req, tok, now)

    def _accept_token(self, req: ServeRequest, tok: int, now: float) -> None:
        """Record one sampled token for ``req`` and retire it at EOS /
        max_new_tokens / cache exhaustion (iteration-level eviction)."""
        if req.t_first is None:
            req.t_first = now
        if req.eos_id is not None and tok == req.eos_id:
            self._finish(req, "eos", now)
            return
        req.generated.append(tok)
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
        if req.slot is not None:
            self._slots[req.slot] = None
            self._tokens[req.slot] = 0
            self._positions[req.slot] = 0
            self._temps[req.slot] = 0.0
            req.slot = None
        self.registry.counter("serve_completed_total",
                              {"reason": reason}).inc()
        self.registry.histogram("serve_request_ms").observe(
            (now - req.t_submit) * 1000.0)
        if req.t_first is not None:
            self.registry.histogram("serve_first_token_ms").observe(
                (req.t_first - req.t_submit) * 1000.0)
        req.done.set()

    # ------------------------------------------------------------- stepping ----
    def has_work(self) -> bool:
        with self._lock:
            return bool(self._queue) or any(
                r is not None for r in self._slots)

    def step(self) -> int:
        """One scheduler iteration: admit into free slots, then one decode
        step over every slot. Returns tokens emitted (0 = idle)."""
        with self._lock:
            tokens_before = self.tokens_total
            free = self._free_slots()
            while self._queue and free:
                self._admit(self._queue.pop(0), free.pop(0))
            self.registry.gauge("serve_queue_depth").set(
                float(len(self._queue)))
            active = [r for r in self._slots if r is not None]
            self.registry.gauge("serve_active_slots").set(
                float(len(active)))
            if not active:
                return self.tokens_total - tokens_before
            # every slot writes its K/V at its position: JAX's
            # dynamic_update_slice would clamp an out-of-range start onto
            # live positions, torch indexing would fault — neither may
            # happen (_accept_token retires a slot at max_len)
            if int(self._positions.max()) >= self.max_len:
                raise RuntimeError(
                    f"decode position {int(self._positions.max())} outside "
                    f"the cache page (max_len {self.max_len})")
            t0 = time.perf_counter()
            self._cache, toks = self._decode(
                self.params, self._cache,
                torch.from_numpy(self._tokens).to(self.device),
                torch.from_numpy(self._positions).to(self.device),
                torch.from_numpy(self._temps).to(self.device),
                self._generator)
            toks = toks.cpu().numpy()  # fences the step: retirement sees it
            now = time.perf_counter()
            decode_ms = (now - t0) * 1000.0
            self.registry.histogram("serve_decode_step_ms").observe(
                decode_ms)
            self.decode_steps += 1
            self._occupancy_sum += len(active)
            for req in active:
                self._positions[req.slot] += 1
                self._accept_token(req, int(toks[req.slot]), now)
            self.registry.gauge("serve_active_slots").set(
                float(sum(r is not None for r in self._slots)))
            return self.tokens_total - tokens_before

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
        the JAX engine's keys (the fast-path entries are off here)."""
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
                "prefill_chunk": None,
                "chunking_slots": 0,
                "prefix_cache": None,
                "speculative": None,
                "model": dict(self.dims, n_heads=self.n_heads,
                              top_k=self.top_k),
            }

    def metrics_record(self) -> dict:
        """Every ``serve_*`` instrument in this engine's registry as a flat
        ``{name: value}`` dict."""
        from deeplearning4j_tpu_torch.telemetry.registry import flat_record

        return flat_record(self.registry, prefixes=("serve_",))
