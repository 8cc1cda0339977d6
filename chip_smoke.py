#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (deeplearning4j_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build: compile every kernel of the serving path from csrc/ with nvcc for
   sm_90a (one nvcc per source, started together) and print the build time
   and the ptxas report;
2. kernel parity: each kernel against its plain PyTorch version on the card
   over T in {8, 100, 512, 1024, 2048} (1024 and 2048 are the buckets the
   serving run sends to the kernel), Dh in {16, 128}, causal and not, f32
   and bf16; then its time at the serving shape (B=1, H=4, T=2048, Dh=128,
   causal, bf16; CUDA events, median of 30 after warm-up) beside the plain
   version's, torch's scaled_dot_product_attention (a yardstick the port
   never calls) and the card's bound;
3. serving at the flagship's full width (vocab 2048, d_model 512, 4 heads of
   128, 4 experts, d_ff 1024, 2 layers; random weights from a seed):
   DecodeEngine(n_slots=8, max_len=2048, serve_dtype="bf16") answers 10
   greedy requests submitted before run_until_idle(), as the CLI's predict
   does, with prompts across the buckets; the kernel's launch count over
   that run must equal n_layers x the admissions whose bucket resolves to
   the kernel. A second engine with attn_impl="flash" on short prompts
   must do the same. The main path's requests run once more under
   torch.profiler for the device busy share and the kernels that take it.
   Prefill logits of one long prompt through the kernel and through dense
   attention must agree within 1e-3 at f32;
4. output: the card's name and power limit from nvidia-smi, one JSON line
   listing each kernel, and as the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Parity phases run with TF32 off (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 False), so f32 products are full f32.
Without CUDA, or outside a checkout of the repository, the script fails
before printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
DEVICE = "cuda"

# the flagship LM's serving width (bench.py's composed-flagship dims)
VOCAB, D_MODEL, N_HEADS, N_EXPERTS, D_FF, N_LAYERS = 2048, 512, 4, 4, 1024, 2
N_SLOTS, MAX_LEN, MAX_NEW = 8, 2048, 16
PROMPT_LENS = (5, 17, 40, 90, 200, 420, 700, 1100, 1500, 2000)
FLASH_PROMPT_LENS = (5, 40, 200)
PARITY_LEN = 1500

TOL = {"float32": {"o": 2e-5, "lse": 2e-5},
       "bfloat16": {"o": 2e-2, "lse": 1e-3}}


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------- phase 1 ----

def build_kernels() -> None:
    from deeplearning4j_tpu_torch.ops import _kernels

    names = sorted(_kernels.LAUNCHES)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        for name, path in zip(names, pool.map(_kernels.build, names)):
            log(f"[build] {name}: {path.name}")
            for line in _kernels.build_logs.get(name, "").splitlines():
                if "ptxas" in line or "error" in line or "warning" in line:
                    log(f"[build]   {line.strip()}")
    log(f"[build] {len(names)} kernel(s) built in "
        f"{time.perf_counter() - t0:.2f} s")


# ------------------------------------------------------------- phase 2 ----

def _qkv(shape, dtype, seed):
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
            for _ in range(3)]


def flash_parity() -> None:
    import torch

    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    n = 0
    for t in (8, 100, 512, 1024, 2048):
        for dh in (16, 128):
            for causal in (True, False):
                for dtype in (torch.float32, torch.bfloat16):
                    q, k, v = _qkv((2, 2, t, dh), dtype, seed=t + dh)
                    o, lse = fa.flash_attention_fwd(q, k, v, causal)
                    ro, rlse = fa.flash_attention_reference(q, k, v, causal)
                    torch.cuda.synchronize()
                    tol = TOL[str(dtype).split(".")[1]]
                    eo = (o.float() - ro.float()).abs().max().item()
                    el = (lse - rlse).abs().max().item()
                    ok = (o.dtype == dtype and lse.dtype == torch.float32
                          and eo <= tol["o"] and el <= tol["lse"]
                          and torch.isfinite(o.float()).all().item())
                    log(f"[parity] flash T={t} Dh={dh} causal={causal} "
                        f"{dtype}: o err {eo:.3g} lse err {el:.3g} "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(
                            f"flash kernel disagrees with its plain version "
                            f"at T={t} Dh={dh} causal={causal} {dtype}: "
                            f"o {eo} (tol {tol['o']}), lse {el} "
                            f"(tol {tol['lse']})")
                    n += 1
    log(f"[parity] flash_attention_fwd: {n} cases agree")


def flash_measure() -> dict:
    """The kernel at the serving shape: time, plain version, library call,
    bound. Inputs stay resident in the 50 MB L2 between calls, as q/k/v do
    when prefill's projections have just written them."""
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    b, h, t, dh = 1, N_HEADS, MAX_LEN, D_MODEL // N_HEADS
    q, k, v = _qkv((b, h, t, dh), torch.bfloat16, seed=7)
    o, _ = fa.flash_attention_fwd(q, k, v, True)
    ro, _ = fa.flash_attention_reference(q, k, v, True)
    err = (o.float() - ro.float()).abs().max().item()
    kernel_ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, True))
    plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v, True),
                       reps=20)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), reps=20)
    flops = 4.0 * b * h * t * t * dh / 2          # causal half of QK^T + PV
    nbytes = 4 * b * h * t * dh * 2 + b * h * t * 4  # q,k,v read, o written
    #                                                 (bf16), lse (f32)
    op_ms = flops / PEAK_BF16_FLOPS * 1e3
    byte_ms = nbytes / PEAK_BYTES * 1e3
    log(f"[measure] flash_attention_fwd B={b} H={h} T={t} Dh={dh} causal "
        f"bf16: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms; bound {max(op_ms, byte_ms) * 1e3:.2f} us "
        f"({flops / 1e9:.2f} GFLOP -> {op_ms * 1e3:.2f} us at 989 TFLOP/s; "
        f"{nbytes / 1e6:.2f} MB -> {byte_ms * 1e3:.2f} us at 3.35 TB/s); "
        f"kernel at {flops / kernel_ms / 1e9:.2f} TFLOP/s; max abs err "
        f"{err:.3g}")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "deeplearning4j_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "deeplearning4j_tpu/ops/flash_attention.py:405",
            "launches": None, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" if op_ms >= byte_ms else "bytes",
            "library_ms": library_ms}


# ------------------------------------------------------------- phase 3 ----

def _prompt(rng, n):
    return [int(x) for x in rng.randint(0, VOCAB, n)]


def _kernel_admissions(engine, reqs) -> int:
    from deeplearning4j_tpu_torch.ops.flash_attention import (
        resolve_attention_impl,
    )

    impl = engine.attn_impl
    return sum((impl or resolve_attention_impl(r.bucket))
               in ("flash", "blockwise") for r in reqs)


def device_busy(prof, wall_s: float) -> dict:
    """Device busy time (sum of kernel self times on the card) against the
    run's wall time, and the kernels that take most of it."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    self_us = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                                None) or e.self_cuda_time_total
    busy_ms = sum(self_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=self_us, reverse=True)[:6]
    return {"device_busy_ms": busy_ms, "wall_ms": wall_s * 1e3,
            "busy_share": busy_ms / (wall_s * 1e3),
            "top_kernels_ms": {e.key[:60]: self_us(e) / 1e3 for e in top}}


def serve(params, attn_impl, prompt_lens, seed, profiled=False) -> dict:
    """One engine, every request submitted before run_until_idle(); the
    kernel's launches are counted from 0 over exactly that run. With
    ``profiled`` the run goes under torch.profiler (its times then carry
    the profiler's cost) and the device busy share is reported."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.serve.engine import DecodeEngine
    from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

    registry = MetricsRegistry()
    engine = DecodeEngine(params, N_HEADS, n_slots=N_SLOTS, max_len=MAX_LEN,
                          serve_dtype="bf16", attn_impl=attn_impl,
                          registry=registry, seed=seed, device=DEVICE)
    rng = np.random.RandomState(seed)
    # warm-up over the same buckets: the timed run then shows the steady
    # state, not each shape's first-use cost in the libraries below torch
    for n in prompt_lens:
        engine.submit(_prompt(rng, n), max_new_tokens=2)
    engine.run_until_idle()
    sync()
    decode_hist = registry.histogram("serve_decode_step_ms")
    d_count0, d_sum0 = decode_hist.count, decode_hist.sum
    prompts = [_prompt(rng, n) for n in prompt_lens]

    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if profiled else contextlib.nullcontext())
    _kernels.reset_launches()
    with ctx as prof:
        t0 = time.perf_counter()
        reqs = [engine.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
        engine.run_until_idle()
        sync()
        wall = time.perf_counter() - t0
    launches = _kernels.LAUNCHES["flash_attention_fwd"]

    for r in reqs:
        if not (r.done.is_set() and r.finish_reason == "max_new_tokens"
                and len(r.generated) == MAX_NEW
                and all(0 <= tok < VOCAB for tok in r.generated)):
            raise AssertionError(f"request {r.rid} (prompt {len(r.prompt)}) "
                                 f"ended {r.finish_reason!r} with "
                                 f"{len(r.generated)} tokens")
    want = N_LAYERS * _kernel_admissions(engine, reqs)
    if launches != want:
        raise AssertionError(f"flash kernel launched {launches} times over "
                             f"the run, expected {want}")
    if want == 0:
        raise AssertionError("no admission resolved to the flash kernel")
    tokens = sum(len(r.generated) for r in reqs)
    by_bucket = {}
    for r in reqs:
        by_bucket.setdefault(r.bucket, []).append(r.prefill_ms)
    decode_steps = decode_hist.count - d_count0
    out = {"attn_impl": attn_impl, "profiled": profiled,
           "requests": len(reqs), "tokens": tokens,
           "wall_s": wall, "tokens_per_s": tokens / wall,
           "kernel_launches": launches, "kernel_admissions":
           want // N_LAYERS, "decode_steps": decode_steps,
           "decode_step_ms": (decode_hist.sum - d_sum0) / decode_steps,
           "prefill_ms_by_bucket": {b: statistics.mean(v)
                                    for b, v in sorted(by_bucket.items())}}
    if profiled:
        out.update(device_busy(prof, wall))
    log(f"[serve] {json.dumps(out)}")
    return out


def prefill_parity(params) -> None:
    """Prefill logits of one long prompt through the kernel and through
    dense attention at f32 (serve_dtype=None)."""
    import torch

    from deeplearning4j_tpu_torch.models.transformer_lm import lm_prefill

    rng = np.random.RandomState(11)
    toks = torch.zeros((1, MAX_LEN), dtype=torch.int64, device=DEVICE)
    toks[0, :PARITY_LEN] = torch.tensor(_prompt(rng, PARITY_LEN))
    with torch.inference_mode():
        flash, fks, _ = lm_prefill(params, toks, N_HEADS, attn_impl="flash")
        dense, dks, _ = lm_prefill(params, toks, N_HEADS, attn_impl="dense")
    sync()
    err = (flash - dense).abs().max().item()
    kerr = (fks - dks).abs().max().item()
    agree = (flash[0, :PARITY_LEN].argmax(-1)
             == dense[0, :PARITY_LEN].argmax(-1)).float().mean().item()
    log(f"[parity] prefill logits T={MAX_LEN} (prompt {PARITY_LEN}) f32 "
        f"flash vs dense: max abs err {err:.3g} (ks {kerr:.3g}), greedy "
        f"agreement {agree:.4f}")
    if not (err <= 1e-3 and torch.isfinite(flash).all().item()):
        raise AssertionError(f"prefill logits flash vs dense differ by {err}")


# ---------------------------------------------------------------- main ----

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.models.transformer_lm import init_lm_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; nvidia-smi: {smi}")

    build_kernels()
    flash_parity()
    kernel = flash_measure()

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = init_lm_params(gen, VOCAB, D_MODEL, N_HEADS, N_EXPERTS, D_FF,
                            n_layers=N_LAYERS, device=DEVICE)
    main_run = serve(params, None, PROMPT_LENS, seed=1)
    kernel["launches"] = main_run["kernel_launches"]
    serve(params, "flash", FLASH_PROMPT_LENS, seed=2)
    serve(params, None, PROMPT_LENS, seed=3, profiled=True)
    prefill_parity(params)

    print(smi)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
