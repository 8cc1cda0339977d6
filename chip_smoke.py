#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (deeplearning4j_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build: compile every kernel from csrc/ with nvcc for sm_90a (one nvcc
   per source, started together; a library is named by a digest of its
   source and the csrc headers it includes) and print the build time, the
   ptxas report and each library's count of tensor-core (HMMA)
   instructions and of local-memory spill instructions (STL, LDL) from
   cuobjdump -sass, or that cuobjdump is absent; a tensor-core kernel (K3f,
   K3k, K3q, K1) with no HMMA fails;
2. kernel parity: each kernel against its plain PyTorch version on the card:
   the forward (K3f) as (o, lse) over T in {8, 65, 100, 512, 1000, 1024,
   2048} (65 and 1000 ragged), Dh in {16, 24, 64, 128} (each head-dim
   bucket), causal and not, f32 and bf16, and on element-offset views at
   T=100; the backward pair (K3k: dK, dV; K3q: dQ) from K3f's o and lse
   over T in {1, 65, 100, 512, 2048}, Dh in {8, 40, 64, 96, 128} (each
   head-dim bucket), causal and not, f32 and bf16; then K3f's time at the
   serving shape (B=1, H=4, T=2048, Dh=128, causal, bf16) and all three at
   the training shape (B=4, H=4, T=2048, Dh=128, causal; f32, the training
   path's type, and bf16), each beside its plain version's time, torch's
   scaled_dot_product_attention (forward for K3f; fwd+bwd minus fwd for the
   K3k+K3q pair: a yardstick the port never calls) and the card's bound
   (CUDA events, median of 30 after warm-up, by device_ms, each kernel's
   time_ms beside it);
3. serving at the flagship's full width (vocab 2048, d_model 512, 4 heads of
   128, 4 experts, d_ff 1024, 2 layers; random weights from a seed):
   DecodeEngine(n_slots=8, max_len=2048, serve_dtype="bf16") answers 10
   greedy requests submitted before run_until_idle(), as the CLI's predict
   does, with prompts across the buckets; the forward kernel's launch count
   over that run must equal n_layers x the admissions whose bucket resolves
   to the kernel. A second engine with attn_impl="flash" on short prompts
   must do the same. The main path's requests run once more under
   torch.profiler for the device busy share and the kernels that take it.
   Prefill logits of one long prompt through the kernel and through dense
   attention must agree within 1e-3 at f32;
4. training at the same width: make_single_device_train_step(4,
   donate=True) with the auto core takes 2 warm-up and 10 timed SGD steps
   on one (B=4, T=2048) batch; every loss is finite, the last below the
   first, and each of K3f, K3k and K3q launches exactly n_layers x 10
   times. One step's loss and grads through the kernels agree with dense
   attention's (f32), with non-zero grads for wq, wk and wv, and both
   routes' grads are held against a float64 dense step on the same inputs,
   per leaf (logged); two steps of the Adam step with guard= and
   with_metrics= run through the kernels; the timed steps run once more
   under torch.profiler for the busy share; one step at d_model / n_heads
   = 256 (2 heads), T=1024, with the auto core runs dense attention (the
   kernels take Dh up to 128): finite, no flash launch;
5. the MNIST MLP (models/zoo.mnist_mlp at the bench's full width:
   784-500-300-10, relu, softmax/MCXENT, SGD lr 0.1 momentum 0.9, batch 512,
   data from synthetic_mnist): the fused-dense kernel K1 against its plain
   version on the card over 7 shapes (both MLP layers, ragged edges, 2-byte
   bf16 pitches) and both MLP layers from element-offset views x 4
   activations x f32/bf16, then its time at both hidden layers' shapes (f32
   and bf16) beside its plain version, torch.relu(torch.addmm(b, x, w))
   (two calls, a yardstick the port never calls) and the card's bound,
   timed with the card held busy while the host enqueues each call
   (device_ms);
   MultiLayerNetwork.fit_epochs over a ListDataSetIterator, 2 warm-up and
   MLP_STEPS timed steps (K1 launches exactly 2 x steps; the score on the
   first timed batch finite and lower after the run);
   make_train_epoch(conf, 200, donate=True) at f32 and under BF16_COMPUTE
   on a (200, 512, 784) chunk as bench.measure builds it (400 launches a
   chunk), a profiled chunk for the busy share;
   predict on 512 held-out examples (2 launches, accuracy above 0.9); one
   step's loss and grads through K1 against the plain dense route (f32);
6. the char-LSTM (models/zoo.char_lstm at the bench's lstm_wide width:
   vocab and hidden 512, batch 64, sequence 64, one-hot random tokens as
   bench.py makes them): the LSTM-cell kernel K2 against its plain version
   on the card over 6 shapes x f32/bf16/mixed inputs and both bench
   shapes from element-offset views, and the cell's backward K2b against
   its own over the same 6 shapes' 24 cases with random dc_new and dh and
   12 more as the last timestep's grads arrive (dc_new None, dh a row view
   of stride 3H); the launch floor (an empty kernel launched through K2's
   library on K2's grid, and K2 and K2b at 1x1); then K2's and K2b's time
   at both bench shapes (64x512, 256x128) beside their plain versions,
   ATen's _thnn_fused_lstm_cell and
   _thnn_fused_lstm_cell_backward_impl (yardsticks the port never calls),
   the floor and the bound; MultiLayerNetwork.fit_epochs, 2 warm-up and
   LSTM_STEPS timed steps at lr 0.01 (K2 and K2b each launch exactly 64 x
   steps; the score on the first timed batch finite and lower after the
   run); make_train_epoch(conf, 8, donate=True) chunks at f32, under
   BF16_COMPUTE, with set_lstm_gates(False) (the bench's _nokernels twin:
   neither kernel launches) and profiled with the kernels on and off
   (busy share, device operations a step and the most frequent by name,
   K2's and K2b's shares of device time); predict on a held-out batch (64
   K2 launches, no K2b, (64, 64) tokens); one step's loss and grads
   through K2 and K2b against the plain cell (f32);
7. the attention char-LM (models/zoo.char_attention_lm at the bench's
   attn_long width: vocab 128, d_model 512, 4 heads, batch 4, T=2048):
   fit_epochs, 2 warm-up and ATTN_STEPS timed steps with the auto core
   (K3f, K3k and K3q each launch once a step), output on one batch (one
   K3f launch), one step's loss and grads through the kernels against
   dense attention (f32) with non-zero grads for wq, wk and wv;
8. output: the card's name and power limit from nvidia-smi, one JSON line
   listing each kernel (K3f at the serving shape; K3f, K3k, K3q at the
   training shape in f32 and bf16 with their launches over the timed f32
   training run; K1 at both MLP layer shapes in f32 and bf16 with its
   launches over the timed fit_epochs run; K2 and K2b at both bench shapes
   in f32 with their launches over the timed char-LSTM fit_epochs run and
   the launch floor beside them), and as the last
   line {"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
   ...}}. An f32 row's bound is that of f32-accurate products: the least
   of the CUDA cores' 67 TFLOP/s and three TF32 products at 495 (the
   kernels' 3xTF32 split), named in bound_by, with the CUDA cores' bound
   kept beside it.

Parity phases run with TF32 off (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 False), so f32 products are full f32.
Without CUDA, or outside a checkout of the repository, the script fails
before printing any result.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit); f32 is the
# CUDA cores' rate, outside the tensor cores
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# the peak of an f32 row whose work is products: the least time the card
# has for f32-accurate products is min(FLOP on the CUDA cores, 3 FLOP of
# TF32 through the 3xTF32 split), which K1 and K3f take
F32_PRODUCTS = "f32 products"
DEVICE = "cuda"

# the flagship LM's serving width (bench.py's composed-flagship dims)
VOCAB, D_MODEL, N_HEADS, N_EXPERTS, D_FF, N_LAYERS = 2048, 512, 4, 4, 1024, 2
N_SLOTS, MAX_LEN, MAX_NEW = 8, 2048, 16
PROMPT_LENS = (5, 17, 40, 90, 200, 420, 700, 1100, 1500, 2000)
FLASH_PROMPT_LENS = (5, 40, 200)
PARITY_LEN = 1500

TOL = {"float32": {"o": 2e-5, "lse": 2e-5},
       "bfloat16": {"o": 2e-2, "lse": 1e-3}}
# backward kernels: max abs error over the reference's max abs value. Both
# sides compute in f32 from the same inputs, in other summation orders (f32:
# ~1e-6 expected); bf16 outputs round once to bf16 (2^-8 relative)
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}

# the flagship's single-chip training shape (bench.py:101-102, 583-665)
TRAIN_B, TRAIN_T, TRAIN_STEPS = 4, 2048, 10
TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq")
# kernel vs dense training step at f32: loss absolute, grads as max abs error
# over the leaf's max abs value. Both sides are full f32 summed in other
# orders, but at full width some of the 67M ReLU units of the expert FFNs
# sit within f32 noise of their kink and switch between the two runs; each
# switch moves one token's share (1/8192) of every grad it feeds, and more
# of one expert column: measured up to 2.1e-3 on experts.w1, ~1e-4 on the
# other block leaves, 1e-7 on the decoder's
LOSS_TOL, GRAD_TOL = 1e-4, 1e-2
ADAM_LR = 1e-3
OPT_METRICS = {"loss", "task_loss", "aux_loss", "router_load", "grad_norm",
               "param_norm", "update_ratio", "moment_norm_m",
               "moment_norm_v", "nonfinite", "clipped", "guard_grad_norm"}

# the MNIST MLP at the bench's width (bench.py:53-59, models/zoo.mnist_mlp)
MLP_H1, MLP_H2, MLP_BATCH = 500, 300, 512
MLP_WARMUP, MLP_STEPS, EPOCH_STEPS = 2, 50, 200
HELD_OUT = 512
# K1 parity: (M, K, N) with both MLP layers (bf16 rows of 500 and 300
# elements are 8-byte aligned only), a wider K, the head's shape, ragged
# edges on every side (257 x 100 x 129: K not a multiple of the 32-deep
# chunk, M and N past a tile) and 2-byte bf16 pitches (5x7x3, 1x1x1); then
# both MLP layers from element-offset views. Error is max abs error over
# the reference's max abs value: f32 sums in another order (~1e-6
# expected), bf16 rounds once (2^-8)
DENSE_SHAPES = ((512, 784, 500), (512, 500, 300), (512, 1024, 512),
                (100, 300, 10), (257, 100, 129), (5, 7, 3), (1, 1, 1))
DENSE_OFFSET_SHAPES = ((512, 784, 500), (512, 500, 300))
DENSE_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# K1 vs the plain dense route, one MLP step at f32: loss absolute; grads as
# max abs error over the leaf's max. Looser than f32 rounding: at batch 512
# a hidden unit within f32 noise of 0 can switch between the two runs (the
# ReLU-kink finding of the LM training grads)
MLP_LOSS_TOL, MLP_GRAD_TOL = 1e-5, 1e-3


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


# cycles of torch.cuda._sleep ahead of each timed call in device_ms: about
# 1 ms at the H100's clocks, longer than the host takes to enqueue the call
SLEEP_CYCLES = 2_000_000


def device_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` (CUDA events) with the
    host's launch cost kept out: the card sleeps while the host enqueues
    the start event and the call, so the interval holds only the call's
    kernels. ``time_ms``'s interval also holds the host's enqueue time when
    the card idles meanwhile, which matters for calls of tens of us."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------- phase 1 ----

# the kernels built on csrc/hopper_mma.cuh's mma.sync: their SASS must hold
# tensor-core instructions
TENSOR_CORE_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkv",
                       "flash_attention_bwd_dq", "fused_dense")


def build_kernels() -> None:
    from deeplearning4j_tpu_torch.ops import _kernels

    names = sorted(_kernels.LAUNCHES)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        for name, path in zip(names, pool.map(_kernels.build, names)):
            log(f"[build] {name}: {path.name}")
            for line in _kernels.build_logs.get(name, "").splitlines():
                if any(w in line for w in ("registers", "spill", "error",
                                           "warning")):
                    log(f"[build]   {line.strip()}")
    log(f"[build] {len(names)} kernel(s) built in "
        f"{time.perf_counter() - t0:.2f} s")
    cuobjdump = _cuda_tool("cuobjdump")
    if cuobjdump is None:
        log("[build] cuobjdump not found: tensor-core instruction counts "
            "not taken")
        return
    for name in names:
        sass = subprocess.run([cuobjdump, "-sass",
                               str(_kernels._library_path(name))],
                              capture_output=True, text=True).stdout
        counts = {op: len(re.findall(rf"\b{op}\b", sass))
                  for op in ("HMMA", "STL", "LDL")}
        log(f"[build] {name}: {counts['HMMA']} tensor-core (HMMA) "
            f"instructions in its SASS; local-memory spills: "
            f"{counts['STL']} STL, {counts['LDL']} LDL")
        if name in TENSOR_CORE_KERNELS and counts["HMMA"] == 0:
            raise AssertionError(f"{name} has no tensor-core instruction")


def _cuda_tool(name: str):
    """The CUDA toolkit's ``name`` (on PATH or under CUDA_HOME), or None."""
    import os
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which(name)
    if found or not CUDA_HOME:
        return found
    path = os.path.join(CUDA_HOME, "bin", name)
    return path if os.path.exists(path) else None


# ------------------------------------------------------------- phase 2 ----

def _qkv(shape, dtype, seed, offset=0):
    """Three random (B, H, T, Dh) tensors; with ``offset`` each is a view
    ``offset`` elements into its storage, so its base is only element-
    aligned (the kernels then stage with narrower copies)."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    n = int(np.prod(shape))
    return [torch.randn(n + offset, generator=gen, device=DEVICE).to(dtype)[
        offset:].view(shape) for _ in range(3)]


# K3f parity: T across the 64-row tiles' edges (65 and 1000 are ragged),
# Dh in each head-dim bucket (16, 24: 32; 64; 128), then element-offset
# views at T=100
FLASH_TS = (8, 65, 100, 512, 1000, 1024, 2048)
FLASH_DHS = (16, 24, 64, 128)


def flash_parity() -> None:
    import torch

    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    cases = [(t, dh, 0) for t in FLASH_TS for dh in FLASH_DHS]
    cases += [(100, dh, 1) for dh in FLASH_DHS]
    n = 0
    for t, dh, offset in cases:
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = _qkv((2, 2, t, dh), dtype, seed=t + dh,
                               offset=offset)
                o, lse = fa.flash_attention_fwd(q, k, v, causal)
                ro, rlse = fa.flash_attention_reference(q, k, v, causal)
                torch.cuda.synchronize()
                tol = TOL[str(dtype).split(".")[1]]
                eo = (o.float() - ro.float()).abs().max().item()
                el = (lse - rlse).abs().max().item()
                ok = (o.dtype == dtype and lse.dtype == torch.float32
                      and eo <= tol["o"] and el <= tol["lse"]
                      and torch.isfinite(o.float()).all().item())
                log(f"[parity] flash T={t} Dh={dh} causal={causal} {dtype}"
                    f"{f' offset {offset}' if offset else ''}: o err "
                    f"{eo:.3g} lse err {el:.3g} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(
                        f"flash kernel disagrees with its plain version at "
                        f"T={t} Dh={dh} causal={causal} {dtype} offset "
                        f"{offset}: o {eo} (tol {tol['o']}), lse {el} "
                        f"(tol {tol['lse']})")
                n += 1
    log(f"[parity] flash_attention_fwd: {n} cases agree")


def flash_measure() -> dict:
    """The kernel at the serving shape: its device time (``device_ms``),
    beside it with the host's launch in the interval (``time_ms``), the
    plain version, the library call (SDPA, ``device_ms``) and the bound.
    Inputs stay resident in the 50 MB L2 between calls, as q/k/v do when
    prefill's projections have just written them."""
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    b, h, t, dh = 1, N_HEADS, MAX_LEN, D_MODEL // N_HEADS
    q, k, v = _qkv((b, h, t, dh), torch.bfloat16, seed=7)
    o, _ = fa.flash_attention_fwd(q, k, v, True)
    ro, _ = fa.flash_attention_reference(q, k, v, True)
    err = (o.float() - ro.float()).abs().max().item()
    kernel_ms = device_ms(lambda: fa.flash_attention_fwd(q, k, v, True))
    host_ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, True))
    plain_ms = device_ms(lambda: fa.flash_attention_reference(q, k, v, True),
                         reps=20)
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), reps=20)
    flops = 4.0 * b * h * t * t * dh / 2          # causal half of QK^T + PV
    nbytes = 4 * b * h * t * dh * 2 + b * h * t * 4  # q,k,v read, o written
    #                                                 (bf16), lse (f32)
    entry = _kernel_entry(
        "flash_attention_fwd", "deeplearning4j_tpu/ops/flash_attention.py:405",
        kernel_ms, plain_ms, flops, nbytes, PEAK_BF16_FLOPS, err, library_ms,
        f"B={b} H={h} T={t} Dh={dh} causal bfloat16 (serving)",
        ms_with_launch=host_ms)
    log(f"[measure] flash_attention_fwd {entry['shape']}: kernel "
        f"{kernel_ms:.4f} ms ({host_ms:.4f} ms with the host's launch in the "
        f"interval), plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms; "
        f"bound {entry['bound_ms'] * 1e3:.2f} us ({entry['bound_by']}: "
        f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); kernel at "
        f"{flops / kernel_ms / 1e9:.2f} TFLOP/s; max abs err {err:.3g}")
    # B*H = 4 gives 128 blocks of 64 q rows; if one block's walk over the
    # keys bounds the time, it stays flat with one head and without the mask
    for heads, causal in ((1, True), (h, False)):
        q, k, v = _qkv((b, heads, t, dh), torch.bfloat16, seed=8)
        ms = device_ms(lambda: fa.flash_attention_fwd(q, k, v, causal))
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), reps=20)
        log(f"[measure] flash_attention_fwd B={b} H={heads} T={t} Dh={dh} "
            f"{'causal' if causal else 'not causal'} bfloat16: kernel "
            f"{ms:.4f} ms, sdpa {lib:.4f} ms")
    return entry


# K3k/K3q parity: T from one row through ragged edges (65, 100) to the
# training length; Dh in every head-dim bucket (8: 32; 40, 64: 64; 96, 128:
# 128), columns past dh zero-filled in all but 64 and 128
BWD_TS = (1, 65, 100, 512, 2048)
BWD_DHS = (8, 40, 64, 96, 128)


def bwd_parity() -> None:
    """K3k and K3q against ``flash_attention_bwd_reference`` on the card,
    with o and lse from K3f. Error: max abs error over the reference's max
    abs value, per output. At T=1 a softmax over one key has no gradient
    in its score, so dq = dk = 0 and both sides hold only rounding noise
    (dP against delta): there the two are held to dv's max instead."""
    import torch

    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    n = 0
    for t in BWD_TS:
        for dh in BWD_DHS:
            for causal in (True, False):
                for dtype in (torch.float32, torch.bfloat16):
                    q, k, v = _qkv((2, 2, t, dh), dtype, seed=3 * t + dh)
                    do = _qkv((2, 2, t, dh), dtype, seed=7 * t + dh)[0]
                    o, lse = fa.flash_attention_fwd(q, k, v, causal)
                    delta = fa.attention_delta(o, do)
                    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, do,
                                                        delta, causal)
                    dq = fa.flash_attention_bwd_dq(q, k, v, lse, do, delta,
                                                   causal)
                    want = fa.flash_attention_bwd_reference(q, k, v, o, lse,
                                                            do, causal)
                    sync()
                    tol = BWD_TOL[str(dtype).split(".")[1]]
                    scale = want[2] if t == 1 else None
                    errs = [_rel_err(g, w, scale) for g, w in
                            zip((dq, dk, dv), want)]
                    ok = (all(e <= tol for e in errs)
                          and all(g.dtype == dtype
                                  and torch.isfinite(g.float()).all().item()
                                  for g in (dq, dk, dv)))
                    log(f"[parity] bwd T={t} Dh={dh} causal={causal} "
                        f"{dtype}: rel err dq {errs[0]:.3g} dk {errs[1]:.3g} "
                        f"dv {errs[2]:.3g} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(
                            f"backward kernels disagree with their plain "
                            f"version at T={t} Dh={dh} causal={causal} "
                            f"{dtype}: dq/dk/dv {errs} (tol {tol})")
                    n += 1
    log(f"[parity] flash_attention_bwd_dkv, flash_attention_bwd_dq: {n} "
        f"cases agree")


def _rel_err(got, want, scale=None) -> float:
    """max |got - want| over max |want| (or over max |scale|)."""
    want = want.float()
    scale = want if scale is None else scale.float()
    return ((got.float() - want).abs().max()
            / scale.abs().max().clamp_min(1e-30)).item()


def _kernel_entry(name, replaces, ms, plain_ms, flops, nbytes, peak, err,
                  library_ms, shape, **extra) -> dict:
    """One row of the kernels line. ``peak`` is a FLOP/s rate, or
    F32_PRODUCTS for f32 products: then the operations' time is the least
    of the CUDA cores' (67 TFLOP/s) and three TF32 products' (3 FLOP at
    495), and the CUDA cores' bound is kept beside it."""
    ops = ""
    if peak == F32_PRODUCTS:
        cores_ms = flops / PEAK_F32_FLOPS * 1e3
        tf32_ms = 3 * flops / PEAK_TF32_FLOPS * 1e3
        op_ms = min(cores_ms, tf32_ms)
        ops = " (3xTF32)" if tf32_ms <= cores_ms else " (CUDA cores)"
        extra["bound_ms_cuda_cores"] = max(cores_ms,
                                           nbytes / PEAK_BYTES * 1e3)
    else:
        op_ms = flops / peak * 1e3
    byte_ms = nbytes / PEAK_BYTES * 1e3
    return {"name": name, "route": "cuda",
            "source": f"deeplearning4j_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" + ops if op_ms >= byte_ms else "bytes",
            "library_ms": library_ms, "shape": shape, **extra}


def train_shape_measure() -> list:
    """K3f, K3k and K3q at the training shape (B=4, H=4, T=2048, Dh=128,
    causal) in f32, the training path's type, and bf16: each kernel's time
    beside its plain version's, its bound, and torch's SDPA (forward for
    K3f; fwd+bwd minus fwd for the K3k+K3q pair), a yardstick the port
    never calls. The kernels and SDPA are timed by ``device_ms`` (each
    kernel by ``time_ms`` beside it, as ``ms_with_launch``); SDPA's
    backward is the ``device_ms`` of fwd+bwd minus that of fwd. Returns the
    entries of the kernels line, f32 then bf16."""
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    b, h, t, dh = TRAIN_B, N_HEADS, TRAIN_T, D_MODEL // N_HEADS
    pairs = b * h * t * t / 2 * dh * 2        # FLOPs of one causal product
    entries = []
    for dtype, peak in ((torch.float32, F32_PRODUCTS),
                        (torch.bfloat16, PEAK_BF16_FLOPS)):
        q, k, v = _qkv((b, h, t, dh), dtype, seed=21)
        do = _qkv((b, h, t, dh), dtype, seed=22)[0]
        elt = q.element_size()
        tile = b * h * t * dh * elt           # bytes of one (B,H,T,Dh) tensor
        row = b * h * t * 4                   # bytes of lse or delta
        o, lse = fa.flash_attention_fwd(q, k, v, True)
        delta = fa.attention_delta(o, do)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, do, delta, True)
        dq = fa.flash_attention_bwd_dq(q, k, v, lse, do, delta, True)
        ro, _ = fa.flash_attention_reference(q, k, v, True)
        rdq, rdk, rdv = fa.flash_attention_bwd_reference(q, k, v, o, lse,
                                                         do, True)
        err_fwd = (o.float() - ro.float()).abs().max().item()
        err_dkv = max((dk.float() - rdk.float()).abs().max().item(),
                      (dv.float() - rdv.float()).abs().max().item())
        err_dq = (dq.float() - rdq.float()).abs().max().item()

        def dkv():
            return fa.flash_attention_bwd_dkv(q, k, v, lse, do, delta, True)

        def dq_():
            return fa.flash_attention_bwd_dq(q, k, v, lse, do, delta, True)

        fwd_ms = device_ms(lambda: fa.flash_attention_fwd(q, k, v, True))
        fwd_host = time_ms(lambda: fa.flash_attention_fwd(q, k, v, True))
        dkv_ms, dkv_host = device_ms(dkv), time_ms(dkv)
        dq_ms, dq_host = device_ms(dq_), time_ms(dq_)
        fwd_plain = time_ms(lambda: fa.flash_attention_reference(
            q, k, v, True), reps=10)
        dkv_plain = time_ms(lambda: fa._bwd_dkv_plain(
            q, k, v, lse, do, delta, True), reps=10)
        dq_plain = time_ms(lambda: fa._bwd_dq_plain(
            q, k, v, lse, do, delta, True), reps=10)
        sdpa_fwd_dev = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), reps=20)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        sdpa_fwd_bwd = device_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qg, kg, vg, is_causal=True),
            (qg, kg, vg), do), reps=20)
        sdpa_bwd = sdpa_fwd_bwd - sdpa_fwd_dev
        shape = f"B={b} H={h} T={t} Dh={dh} causal {str(dtype)[6:]}"
        pair_note = ("SDPA backward for the K3k+K3q pair (dq, dk, dv): "
                     "fwd+bwd minus fwd")
        group = [
            _kernel_entry("flash_attention_fwd",
                          "deeplearning4j_tpu/ops/flash_attention.py:405",
                          fwd_ms, fwd_plain, 2 * pairs, 4 * tile + row, peak,
                          err_fwd, sdpa_fwd_dev, shape,
                          ms_with_launch=fwd_host),
            _kernel_entry("flash_attention_bwd_dkv",
                          "jax/experimental/pallas/ops/tpu/"
                          "flash_attention.py:1121 (_flash_attention_bwd_dkv,"
                          " via deeplearning4j_tpu/ops/flash_attention.py:405)",
                          dkv_ms, dkv_plain, 4 * pairs, 6 * tile + 2 * row,
                          peak, err_dkv, sdpa_bwd, shape,
                          library_covers=pair_note, ms_with_launch=dkv_host),
            _kernel_entry("flash_attention_bwd_dq",
                          "jax/experimental/pallas/ops/tpu/"
                          "flash_attention.py:1456 (_flash_attention_bwd_dq,"
                          " via deeplearning4j_tpu/ops/flash_attention.py:405)",
                          dq_ms, dq_plain, 3 * pairs, 5 * tile + 2 * row,
                          peak, err_dq, sdpa_bwd, shape,
                          library_covers=pair_note, ms_with_launch=dq_host)]
        for e in group:
            log(f"[measure] {e['name']} {shape}: kernel {e['ms']:.4f} ms "
                f"({e['ms_with_launch']:.4f} ms with the host's launch in "
                f"the interval), plain {e['plain_ms']:.4f} ms, sdpa {e['library_ms']:.4f} "
                f"ms, bound {e['bound_ms']:.4f} ms ({e['bound_by']}"
                + (f"; CUDA cores {e['bound_ms_cuda_cores']:.4f} ms"
                   if "bound_ms_cuda_cores" in e else "")
                + f"); max abs err {e['max_abs_err']:.3g}")
        log(f"[measure] K3k+K3q {shape}: {dkv_ms + dq_ms:.4f} ms against "
            f"SDPA's backward {sdpa_bwd:.4f} ms (fwd+bwd {sdpa_fwd_bwd:.4f} "
            f"minus fwd {sdpa_fwd_dev:.4f}); bound "
            f"{group[1]['bound_ms'] + group[2]['bound_ms']:.4f} ms")
        entries += group
        del q, k, v, do, o, lse, delta, dk, dv, dq, ro, rdq, rdk, rdv
        torch.cuda.empty_cache()
    return entries


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


def _self_us(event) -> float:
    """A profiler event's self time on the card, in us."""
    return (getattr(event, "self_device_time_total", None)
            or event.self_cuda_time_total)


def _by_name(prof, value) -> dict:
    """``value(event)`` of the profile's kernels on the card, summed by the
    first 60 characters of their names (template instances of one kernel
    share them), largest first."""
    from torch.autograd import DeviceType

    sums = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            sums[e.key[:60]] = sums.get(e.key[:60], 0) + value(e)
    return dict(sorted(sums.items(), key=lambda kv: kv[1], reverse=True))


def device_busy(prof, wall_s: float) -> dict:
    """Device busy time (sum of kernel self times on the card) against the
    run's wall time, and the kernels that take most of it."""
    by_name = _by_name(prof, _self_us)
    busy_ms = sum(by_name.values()) / 1e3
    return {"device_busy_ms": busy_ms, "wall_ms": wall_s * 1e3,
            "busy_share": busy_ms / (wall_s * 1e3),
            "top_kernels_ms": {k: us / 1e3
                               for k, us in list(by_name.items())[:6]}}


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


# ------------------------------------------------------------- phase 4 ----

def _train_setup(seed: int = 0):
    """Fresh f32 flagship params from a generator seeded ``seed`` and one
    (B, T) batch of tokens and next-token targets from a numpy seed."""
    import torch

    from deeplearning4j_tpu_torch.models.transformer_lm import init_lm_params

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = init_lm_params(gen, VOCAB, D_MODEL, N_HEADS, N_EXPERTS, D_FF,
                            n_layers=N_LAYERS, device=DEVICE)
    toks = np.random.RandomState(5).randint(0, VOCAB,
                                            (TRAIN_B, TRAIN_T + 1))
    toks = torch.as_tensor(toks, device=DEVICE)
    return params, toks[:, :-1], toks[:, 1:]


def _check_launches(run: str, steps: int) -> dict:
    from deeplearning4j_tpu_torch.ops import _kernels

    launches = dict(_kernels.LAUNCHES)
    want = N_LAYERS * steps
    for name in TRAIN_KERNELS:
        if launches[name] != want:
            raise AssertionError(f"{run}: {name} launched {launches[name]} "
                                 f"times, expected n_layers x steps = {want}")
    return launches


def train(profiled: bool = False) -> dict:
    """The flagship's single-device training step at full width with the
    auto attention core (the flash kernels at T=2048): 2 warm-up steps,
    then TRAIN_STEPS timed steps on one batch, launches counted from 0 over
    exactly those steps. With ``profiled`` the steps run under
    torch.profiler for the device busy share."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.models.transformer_lm import (
        make_single_device_train_step,
        selected_attn_impl,
    )
    from deeplearning4j_tpu_torch.ops import _kernels

    impl = selected_attn_impl(TRAIN_T, head_dim=D_MODEL // N_HEADS)
    if impl not in ("flash", "blockwise"):
        raise AssertionError(f"auto core at T={TRAIN_T} is {impl!r}")
    params, tokens, targets = _train_setup()
    step = make_single_device_train_step(N_HEADS, donate=True, device=DEVICE)
    for _ in range(2):
        params, loss = step(params, tokens, targets)
    sync()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if profiled else contextlib.nullcontext())
    _kernels.reset_launches()
    losses = []
    with ctx as prof:
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            params, loss = step(params, tokens, targets)
            losses.append(loss)
        sync()
        wall = time.perf_counter() - t0
    launches = _check_launches("training run", TRAIN_STEPS)
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses {losses}: not finite or not "
                             "falling")
    ms = wall * 1e3 / TRAIN_STEPS
    out = {"profiled": profiled, "attn_impl": impl, "steps": TRAIN_STEPS,
           "batch": [TRAIN_B, TRAIN_T], "wall_s": wall, "ms_per_step": ms,
           "samples_per_s": TRAIN_B * 1e3 / ms,
           "tokens_per_s": TRAIN_B * TRAIN_T * 1e3 / ms,
           "losses": losses, "launches": launches}
    if DEVICE == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if profiled:
        out.update(device_busy(prof, wall))
    log(f"[train] {json.dumps(out)}")
    return out


def grad_parity() -> None:
    """One step's loss and grads through the flash kernels
    (attn_impl="blockwise") against dense attention, f32 with TF32 off. The
    grads of wq, wk and wv must be non-zero in every layer: the first
    slice's flash output carried no graph, and those leaves got none.

    Both routes are also held against a float64 dense run on the same
    params and tokens, leaf by leaf, to attribute their gap (logged, not
    gated): if it comes from ReLU units of the expert FFNs at their kink,
    both f32 routes sit about equally far from float64 on the leaves fed
    by those units; if from the kernels, the kernel route sits farther."""
    import torch

    from deeplearning4j_tpu_torch._device import tree_leaves, tree_map
    from deeplearning4j_tpu_torch.models.transformer_lm import (
        _get as _leaf,
        dense_loss_fn,
        lm_value_and_grad,
    )

    params, tokens, targets = _train_setup()
    kl, kg = lm_value_and_grad(dense_loss_fn(N_HEADS, attn_impl="blockwise"),
                               params, tokens, targets)
    dl, dg = lm_value_and_grad(dense_loss_fn(N_HEADS, attn_impl="dense"),
                               params, tokens, targets)
    loss_err = abs(float(kl) - float(dl))
    errs = {}
    tree_map(lambda path, g: errs.__setitem__(
        ".".join(path), _rel_err(g, _leaf(dg, path))), kg)
    grad_err = max(errs.values())
    log(f"[parity] grad rel err per leaf: {json.dumps(errs)}")
    f64_attribution(params, tokens, targets, kl, kg, dl, dg, errs)
    zero = [key for key in ("wq", "wk", "wv")
            if not bool((kg["blocks"][key].abs().amax((1, 2)) > 0).all())]
    finite = all(torch.isfinite(g).all().item() for g in tree_leaves(kg))
    log(f"[parity] training step flash kernels vs dense, f32, B={TRAIN_B} "
        f"T={TRAIN_T}: loss {float(kl):.6f} vs {float(dl):.6f} (abs err "
        f"{loss_err:.3g}), worst leaf grad rel err {grad_err:.3g}, "
        f"zero-grad attention leaves {zero}")
    if not (loss_err <= LOSS_TOL and grad_err <= GRAD_TOL and not zero
            and finite):
        raise AssertionError(
            f"kernel vs dense training step: loss err {loss_err} (tol "
            f"{LOSS_TOL}), grad rel err {grad_err} (tol {GRAD_TOL}), zero "
            f"grads {zero}, finite {finite}")


def f64_attribution(params, tokens, targets, kl, kg, dl, dg,
                    errs) -> None:
    """Each f32 route's loss and per-leaf grad error against one float64
    dense step on the same params and tokens (max abs error over the f64
    leaf's max); logged at the leaf where the two routes differ most
    (``errs``: kernels vs dense per leaf) and at each route's worst."""
    import torch

    from deeplearning4j_tpu_torch._device import tree_map
    from deeplearning4j_tpu_torch.models.transformer_lm import (
        _get as _leaf,
        dense_loss_fn,
        lm_value_and_grad,
    )

    p64 = tree_map(lambda _, x: x.double(), params)
    rl, rg = lm_value_and_grad(dense_loss_fn(N_HEADS, attn_impl="dense"),
                               p64, tokens, targets)
    del p64

    def err(g, path):
        want = _leaf(rg, path)
        return ((g.double() - want).abs().max()
                / want.abs().max().clamp_min(1e-300)).item()

    out = {"loss_f64": float(rl),
           "loss_err": {"kernels": abs(float(kl) - float(rl)),
                        "dense_f32": abs(float(dl) - float(rl))},
           "kernels": {}, "dense_f32": {}}
    tree_map(lambda path, g: out["kernels"].__setitem__(
        ".".join(map(str, path)), err(g, path)), kg)
    tree_map(lambda path, g: out["dense_f32"].__setitem__(
        ".".join(map(str, path)), err(g, path)), dg)
    worst = {route: max(out[route], key=out[route].get)
             for route in ("kernels", "dense_f32")}
    worst["kernels vs dense"] = max(errs, key=errs.get)
    log(f"[parity] f64 attribution, B={TRAIN_B} T={TRAIN_T}: "
        f"{json.dumps(out)}")
    for route, leaf in worst.items():
        log(f"[parity] f64 attribution: worst leaf of {route} is "
            f"{leaf}: kernels {out['kernels'][leaf]:.3g}, dense f32 "
            f"{out['dense_f32'][leaf]:.3g} of the f64 leaf's max")
    del rg
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


# a head dim the kernels refuse: the flagship's width in 2 heads of 256
WIDE_HEADS, WIDE_T = 2, 1024


def wide_head_step() -> None:
    """One training step of the LM at d_model / n_heads = 256, T=1024, with
    the auto core: T alone would pick the kernels, which take Dh up to 128,
    so auto must run dense attention, launch no flash kernel and give a
    finite loss and grads."""
    import torch

    from deeplearning4j_tpu_torch._device import tree_leaves
    from deeplearning4j_tpu_torch.models.transformer_lm import (
        init_lm_params,
        make_single_device_train_step,
        selected_attn_impl,
    )
    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.ops.flash_attention import (
        resolve_attention_impl,
    )

    head_dim = D_MODEL // WIDE_HEADS
    by_t = resolve_attention_impl(WIDE_T)
    impl = selected_attn_impl(WIDE_T, head_dim=head_dim)
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    params = init_lm_params(gen, VOCAB, D_MODEL, WIDE_HEADS, N_EXPERTS, D_FF,
                            n_layers=N_LAYERS, device=DEVICE)
    toks = torch.as_tensor(np.random.RandomState(6).randint(
        0, VOCAB, (TRAIN_B, WIDE_T + 1)), device=DEVICE)
    step = make_single_device_train_step(WIDE_HEADS, device=DEVICE)
    _kernels.reset_launches()
    params, loss = step(params, toks[:, :-1], toks[:, 1:])
    sync()
    launches = {k: _kernels.LAUNCHES[k] for k in TRAIN_KERNELS}
    finite = (np.isfinite(float(loss))
              and all(torch.isfinite(p).all().item()
                      for p in tree_leaves(params)))
    out = {"head_dim": head_dim, "t": WIDE_T, "impl_by_t_alone": by_t,
           "impl": impl, "loss": float(loss), "launches": launches}
    log(f"[train] wide heads under auto: {json.dumps(out)}")
    if not (by_t == "blockwise" and impl == "dense" and finite
            and not any(launches.values())):
        raise AssertionError(f"Dh={head_dim} step under auto: {out}, "
                             f"finite {finite}")


def optimizer_path() -> None:
    """Two steps of the Adam step with the guard and metrics seams at full
    width, through the kernels, at Adam's usual rate ADAM_LR (the SGD
    default of 0.1 moves every weight by ~0.1 and throws the loss to ~2e4
    in one step)."""
    from deeplearning4j_tpu_torch.models.transformer_lm import (
        init_lm_opt_state,
        make_single_device_train_step,
    )
    from deeplearning4j_tpu_torch.ops import _kernels

    params, tokens, targets = _train_setup()
    step = make_single_device_train_step(N_HEADS, ADAM_LR, optimizer="adam",
                                         guard=True, with_metrics=True,
                                         device=DEVICE)
    state = init_lm_opt_state("adam", params, device=DEVICE)
    _kernels.reset_launches()
    for _ in range(2):
        params, state, loss, metrics = step(params, state, tokens, targets)
    sync()
    _check_launches("adam run", 2)
    values = {k: v.tolist() for k, v in metrics.items()}
    log(f"[train] adam+guard+metrics, 2 steps: loss {float(loss):.6f}, "
        f"count {int(state['count'])}, metrics {json.dumps(values)}")
    missing = OPT_METRICS - set(metrics)
    if (missing or int(state["count"]) != 2 or values["nonfinite"] != 0.0
            or not np.isfinite(float(loss))
            or not all(np.isfinite(np.asarray(v)).all()
                       for v in values.values())):
        raise AssertionError(f"adam step: missing metrics {missing}, count "
                             f"{int(state['count'])}, metrics {values}")


# ------------------------------------------------------------- phase 5 ----

def _dense_inputs(m, k, n, dtype, seed, offset=0):
    """x, W, b as the MLP's layers see them; with ``offset`` x and W are
    views ``offset`` elements into their storage."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.rand((m * k + offset,), generator=gen, device=DEVICE)
    w = torch.randn((k * n + offset,), generator=gen, device=DEVICE) / k ** 0.5
    b = torch.randn((n,), generator=gen, device=DEVICE) * 0.1
    return (x.to(dtype)[offset:].view(m, k), w.to(dtype)[offset:].view(k, n),
            b.to(dtype))


def dense_parity() -> None:
    """K1 against ``fused_dense_reference`` on the card."""
    import torch

    from deeplearning4j_tpu_torch.ops import pallas_kernels as pk

    cases = [(shape, 0) for shape in DENSE_SHAPES]
    cases += [(shape, 1) for shape in DENSE_OFFSET_SHAPES]
    n = 0
    for (m, k, nn), offset in cases:
        for act in pk._FUSABLE:
            for dtype in (torch.float32, torch.bfloat16):
                x, w, b = _dense_inputs(m, k, nn, dtype, seed=m + k + nn,
                                        offset=offset)
                got = pk.fused_dense_fwd(x, w, b, act)
                want = pk.fused_dense_reference(x, w, b, act)
                sync()
                tol = DENSE_TOL[str(dtype).split(".")[1]]
                err = _rel_err(got, want)
                ok = (got.dtype == dtype and tuple(got.shape) == (m, nn)
                      and err <= tol
                      and torch.isfinite(got.float()).all().item())
                log(f"[parity] fused_dense {m}x{k}x{nn} {act} {dtype}"
                    f"{f' offset {offset}' if offset else ''}: rel err "
                    f"{err:.3g} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(
                        f"fused_dense kernel disagrees with its plain version "
                        f"at {m}x{k}x{nn} {act} {dtype} offset {offset}: "
                        f"{err} (tol {tol})")
                n += 1
    log(f"[parity] fused_dense: {n} cases agree")


def dense_measure() -> list:
    """K1 at both hidden layers of the MLP (relu), f32 and bf16: its time,
    its plain version's, torch.relu(torch.addmm(b, x, w)) (two calls, a
    yardstick the port never calls), all by ``device_ms``, and the bound;
    beside them K1 by ``time_ms`` (host launch included). Operands stay
    resident in the 50 MB L2 between calls, as they are when the step has
    just written them. Returns the entries of the kernels line."""
    import torch

    from deeplearning4j_tpu_torch.ops import pallas_kernels as pk

    entries = []
    for layer, (k, n) in enumerate(((784, MLP_H1), (MLP_H1, MLP_H2))):
        m = MLP_BATCH
        for dtype, peak in ((torch.float32, F32_PRODUCTS),
                            (torch.bfloat16, PEAK_BF16_FLOPS)):
            x, w, b = _dense_inputs(m, k, n, dtype, seed=40 + layer)
            got = pk.fused_dense_fwd(x, w, b, "relu")
            want = pk.fused_dense_reference(x, w, b, "relu")
            err = (got.float() - want.float()).abs().max().item()
            ms = device_ms(lambda: pk.fused_dense_fwd(x, w, b, "relu"))
            plain = device_ms(lambda: pk.fused_dense_reference(x, w, b,
                                                               "relu"))
            lib = device_ms(lambda: torch.relu(torch.addmm(b, x, w)))
            host_ms = time_ms(lambda: pk.fused_dense_fwd(x, w, b, "relu"))
            elt = x.element_size()
            entry = _kernel_entry(
                "fused_dense", "deeplearning4j_tpu/ops/pallas_kernels.py:79",
                ms, plain, 2.0 * m * k * n, elt * (m * k + k * n + n + m * n),
                peak, err, lib,
                f"layer {layer}: ({m},{k})@({k},{n}) relu {str(dtype)[6:]}",
                library_covers="torch.relu(torch.addmm(b, x, w)): two calls",
                launches_cover="both MLP layers over the timed fit_epochs "
                               "run", ms_with_launch=host_ms)
            log(f"[measure] fused_dense {entry['shape']}: kernel "
                f"{ms:.4f} ms ({host_ms:.4f} ms with the host's launch in "
                f"the interval), plain {plain:.4f} ms, addmm+relu "
                f"{lib:.4f} ms, "
                f"bound {entry['bound_ms'] * 1e3:.3f} us ({entry['bound_by']}:"
                f" {2.0 * m * k * n / 1e9:.3f} GFLOP, "
                f"{elt * (m * k + k * n + n + m * n) / 1e6:.2f} MB); kernel "
                f"at {2.0 * m * k * n / ms / 1e9:.2f} TFLOP/s; max abs err "
                f"{err:.3g}")
            entries.append(entry)
    return entries


def _mnist(n: int, seed: int):
    """``n`` synthetic MNIST examples and one-hot labels (numpy)."""
    from deeplearning4j_tpu_torch.datasets.fetchers import synthetic_mnist

    x, y = synthetic_mnist(n, seed=seed)
    return x, np.eye(10, dtype=np.float32)[y]


def mlp_fit() -> dict:
    """The facade's main path: MultiLayerNetwork(mnist_mlp()).fit_epochs
    over a ListDataSetIterator at batch MLP_BATCH, MLP_WARMUP warm-up steps
    then MLP_STEPS timed steps (K1 counted from 0 over exactly those), then
    predict on HELD_OUT held-out examples (counted alone)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.models.zoo import mnist_mlp
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import _kernels

    b, w = MLP_BATCH, MLP_WARMUP
    x, y = _mnist(b * (w + MLP_STEPS), seed=7)
    net = MultiLayerNetwork(mnist_mlp(MLP_H1, MLP_H2), device=DEVICE).init()
    net.fit_epochs(ListDataSetIterator(DataSet(x[:w * b], y[:w * b]), b))
    first = DataSet(x[w * b:(w + 1) * b], y[w * b:(w + 1) * b])
    score0 = net.score(first)
    timed = ListDataSetIterator(DataSet(x[w * b:], y[w * b:]), b)
    sync()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    net.fit_epochs(timed)
    sync()
    wall = time.perf_counter() - t0
    launches = _kernels.LAUNCHES["fused_dense"]
    score1 = net.score(first)
    if launches != 2 * MLP_STEPS:
        raise AssertionError(f"fused_dense launched {launches} times over "
                             f"{MLP_STEPS} steps, expected 2 per step")
    if not (np.isfinite([score0, score1]).all() and score1 < score0):
        raise AssertionError(f"MLP score on the first timed batch "
                             f"{score0} -> {score1}: not finite or not "
                             "falling")
    hx, hy = _mnist(HELD_OUT, seed=8)
    _kernels.reset_launches()
    pred = net.predict(hx)
    predict_launches = _kernels.LAUNCHES["fused_dense"]
    accuracy = float((pred == hy.argmax(-1)).mean())
    if predict_launches != 2 or not accuracy > 0.9:
        raise AssertionError(f"predict: {predict_launches} launches "
                             f"(expected 2), accuracy {accuracy}")
    ms = wall * 1e3 / MLP_STEPS
    out = {"steps": MLP_STEPS, "batch": b, "wall_s": wall,
           "ms_per_step": ms, "samples_per_s": b * 1e3 / ms,
           "score_first_batch": [score0, score1], "launches": launches,
           "predict_launches": predict_launches,
           "held_out_accuracy": accuracy}
    log(f"[mlp] fit_epochs {json.dumps(out)}")
    return out


def mlp_epoch(bf16: bool, profiled: bool = False) -> dict:
    """make_train_epoch(conf, EPOCH_STEPS, donate=True) on one
    (EPOCH_STEPS, MLP_BATCH, 784) chunk of synthetic_mnist, as
    bench.measure("mlp") builds it: a warm-up chunk, then one timed chunk
    with K1 counted from 0 over it. With ``profiled`` the timed chunk runs
    under torch.profiler for the device busy share."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.models.zoo import mnist_mlp
    from deeplearning4j_tpu_torch.nn import functional as F
    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.ops.dtypes import BF16_COMPUTE

    conf = mnist_mlp(MLP_H1, MLP_H2)
    params = F.init_params(conf, 0, device=DEVICE)
    states = F.init_train_state(conf, params)
    epoch = F.make_train_epoch(conf, EPOCH_STEPS, donate=True,
                               policy=BF16_COMPUTE if bf16 else None)
    x, y = _mnist(MLP_BATCH * EPOCH_STEPS, seed=7)
    xs = torch.from_numpy(x).to(DEVICE).reshape(EPOCH_STEPS, MLP_BATCH, -1)
    ys = torch.from_numpy(y).to(DEVICE).reshape(EPOCH_STEPS, MLP_BATCH, -1)
    params, states, warm = epoch(params, states, 0, xs, ys, 1)
    warm = warm.tolist()
    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if profiled else contextlib.nullcontext())
    _kernels.reset_launches()
    with ctx as prof:
        t0 = time.perf_counter()
        params, states, scores = epoch(params, states, EPOCH_STEPS, xs, ys, 2)
        sync()
        wall = time.perf_counter() - t0
    launches = _kernels.LAUNCHES["fused_dense"]
    scores = scores.tolist()
    if launches != 2 * EPOCH_STEPS:
        raise AssertionError(f"fused_dense launched {launches} times over a "
                             f"{EPOCH_STEPS}-step chunk, expected "
                             f"{2 * EPOCH_STEPS}")
    if not (np.isfinite(warm + scores).all() and warm[-1] < warm[0]):
        raise AssertionError(f"epoch scores not finite or not falling: "
                             f"{warm[0]} -> {warm[-1]}, {scores[-1]}")
    ms = wall * 1e3 / EPOCH_STEPS
    out = {"policy": "bf16" if bf16 else "f32", "profiled": profiled,
           "steps": EPOCH_STEPS, "batch": MLP_BATCH, "wall_s": wall,
           "ms_per_step": ms, "samples_per_s": MLP_BATCH * 1e3 / ms,
           "launches": launches, "first_chunk_scores": [warm[0], warm[-1]],
           "last_score": scores[-1]}
    if profiled:
        from torch.autograd import DeviceType

        out.update(device_busy(prof, wall))
        out["device_ops_per_step"] = sum(
            e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA) / EPOCH_STEPS
    log(f"[mlp] train_epoch {json.dumps(out)}")
    return out


def mlp_grad_parity() -> None:
    """One MLP step's loss and grads (batch 512, f32, TF32 off) through K1
    against the plain dense route (set_fused_dense(False): pre_output +
    relu), from one set of params and one batch."""
    import torch

    from deeplearning4j_tpu_torch._device import tree_leaves, tree_unflatten
    from deeplearning4j_tpu_torch.models.zoo import mnist_mlp
    from deeplearning4j_tpu_torch.nn import functional as F
    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.ops import pallas_kernels as pk

    conf = mnist_mlp(MLP_H1, MLP_H2)
    params = F.init_params(conf, 3, device=DEVICE)
    x, y = (torch.from_numpy(a).to(DEVICE) for a in _mnist(MLP_BATCH, 9))

    def loss_and_grads(fused):
        pk.set_fused_dense(fused)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        _kernels.reset_launches()
        loss = F.network_loss(conf, tree_unflatten(params, leaves), x, y,
                              train=True)
        grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), grads, _kernels.LAUNCHES["fused_dense"]

    try:
        kl, kg, k_launches = loss_and_grads(True)
        dl, dg, d_launches = loss_and_grads(False)
    finally:
        pk.set_fused_dense(None)
    names = [f"{i}.{key}" for i in range(conf.n_layers) for key in ("W", "b")]
    errs = {n: _rel_err(g, w) for n, g, w in zip(names, kg, dg)}
    loss_err = abs(kl - dl)
    log(f"[parity] MLP step K1 vs plain dense, f32, batch {MLP_BATCH}: loss "
        f"{kl:.7f} vs {dl:.7f} (abs err {loss_err:.3g}), grad rel err per "
        f"leaf {json.dumps(errs)}; launches {k_launches} vs {d_launches}")
    if not (loss_err <= MLP_LOSS_TOL and max(errs.values()) <= MLP_GRAD_TOL
            and k_launches == 2 and d_launches == 0
            and all(torch.isfinite(g).all().item() for g in kg)):
        raise AssertionError(f"MLP grads through K1 vs plain dense: loss err "
                             f"{loss_err} (tol {MLP_LOSS_TOL}), grad errs "
                             f"{errs} (tol {MLP_GRAD_TOL}), launches "
                             f"{k_launches}/{d_launches}")


def mlp() -> list:
    """Phase 5; returns K1's entries of the kernels line."""
    dense_parity()
    entries = dense_measure()
    main_run = mlp_fit()
    for entry in entries:
        entry["launches"] = main_run["launches"]
        if "bfloat16" in entry["shape"]:
            entry["launches_cover"] += " (f32, the path's type)"
    mlp_epoch(bf16=False)
    mlp_epoch(bf16=True)
    mlp_epoch(bf16=False, profiled=True)
    mlp_grad_parity()
    return entries


# ------------------------------------------------------------- phase 6 ----

# the bench's widest char-LSTM, lstm_wide (bench.py:93, :203-206, :232-235):
# char_lstm(vocab=512), hidden 512, batch 64, sequence 64, chunk 8
LSTM_VOCAB, LSTM_BATCH, LSTM_SEQ, LSTM_CHUNK = 512, 64, 64, 8
LSTM_WARMUP, LSTM_STEPS = 2, 10
# fit_epochs's learning check trains at lr 0.01. At the zoo's lr 0.1,
# AdaGrad's near-sign first steps move every one of the 2.4M weights by
# ~0.1 and throw the score on random tokens far above ln(512), in both
# packages; the timed chunks keep the bench's conf (lr 0.1), whose speed
# does not depend on the rate
LSTM_FIT_LR = 0.01
# K2 parity shapes (B, H): both bench shapes (lstm_wide, lstm: bench.py:86,
# :203), the TPU gate's smallest, the widest H the TPU took, ragged ones;
# then the bench shapes from element-offset views (contiguous, aligned to
# one element only)
LSTM_CELL_SHAPES = ((64, 512), (256, 128), (8, 128), (100, 2048), (3, 10),
                    (1, 1))
LSTM_BENCH_SHAPES = ((LSTM_BATCH, LSTM_VOCAB), (256, 128))
# K2 against its plain version: at f32 within 1e-6 of max(1, |ref|) (both
# compute the same f32 ops with expf/tanhf, no fused multiply-add); at bf16
# within one bf16 step (2^-7 of the larger magnitude): both round one f32
# value once, which may differ in its last f32 ulp
CELL_F32_TOL, BF16_STEP = 1e-6, 2.0 ** -7
# ~25 f32 operations an element (3 sigmoids, 2 tanh, 3 products, 1 sum; a
# transcendental counted as 4): far below the bytes at any shape
CELL_OPS_PER_ELT = 25
# K2b, the cell's backward: the same 5 transcendentals, the sigmoids' sums
# and quotients and 22 products, sums and differences, ~48 an element; K2b
# moves 13 (B, H) streams (12 without dc_new), so bytes bound it too
CELL_BWD_OPS_PER_ELT = 48
# one LSTM step through K2 and K2b against set_lstm_gates(False), f32: loss
# absolute, grads as max abs error over the leaf's max (the two cells
# compute the same f32 ops; 64 timesteps of recurrence may carry an ulp)
LSTM_LOSS_TOL, LSTM_GRAD_TOL = 1e-5, 1e-4


def _one_hot_tokens(shape, vocab: int, seed: int):
    """Next-token data as bench.py:268-274 makes it: random tokens of
    ``shape + (seq + 1,)`` one-hot encoded; x the first seq, y the next
    (numpy f32)."""
    toks = np.random.RandomState(seed).randint(0, vocab, shape)
    eye = np.eye(vocab, dtype=np.float32)
    return eye[toks[..., :-1]], eye[toks[..., 1:]]


def _cell_inputs(b, h, ifog_dtype, c_dtype, seed, offset=0):
    """Random ifog (B, 4H) and c_prev (B, H); with ``offset`` each is a
    contiguous view ``offset`` elements into its storage."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    ifog = 2 * torch.randn(b * 4 * h + offset, generator=gen, device=DEVICE)
    c = torch.randn(b * h + offset, generator=gen, device=DEVICE)
    return (ifog.to(ifog_dtype)[offset:].view(b, 4 * h),
            c.to(c_dtype)[offset:].view(b, h))


def _cell_grads(b, h, c_dtype, seed, last_step=False):
    """Random (dc_new, dh) in c's dtype. With ``last_step`` they come as the
    last timestep's reach K2b: dc_new None (autograd leaves it undefined)
    and dh a row view of a (B, 3, H) grad, row stride 3H (torch.stack's
    backward hands out such views)."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    dh = torch.randn((b, 3 if last_step else 1, h), generator=gen,
                     device=DEVICE).to(c_dtype)[:, -1]
    if last_step:
        return None, dh
    dc = torch.randn((b, h), generator=gen, device=DEVICE).to(c_dtype)
    return dc, dh.contiguous()


def _cell_bwd_bytes(ifog, c, dc) -> int:
    """Bytes K2b must move: ifog read and d_ifog written (4H each), c_prev,
    c_new, dh and dc_new (when given) read and dc_prev written."""
    b, h = c.shape
    streams = 5 if dc is not None else 4
    return b * h * (8 * ifog.element_size() + streams * c.element_size())


def _cell_err(got, want) -> tuple:
    """(max abs error, within tolerance) of one K2 or K2b output against
    the plain version's, by the output's dtype."""
    import torch

    g, w = got.float(), want.float()
    diff = (g - w).abs()
    if got.dtype == torch.float32:
        ok = bool((diff <= CELL_F32_TOL * w.abs().clamp_min(1.0)).all())
    else:
        ok = bool((diff <= BF16_STEP * torch.maximum(g.abs(), w.abs())).all())
    return diff.max().item(), ok


def lstm_cell_parity() -> None:
    """K2 against ``lstm_gates_reference`` on the card at every shape of
    LSTM_CELL_SHAPES and at both bench shapes from element-offset views,
    for f32, bf16 and both mixes of input types."""
    import torch

    from deeplearning4j_tpu_torch.ops import pallas_kernels as pk

    f32, bf16 = torch.float32, torch.bfloat16
    n = 0
    shapes = [(b, h, 0) for b, h in LSTM_CELL_SHAPES]
    shapes += [(b, h, 1) for b, h in LSTM_BENCH_SHAPES]
    for b, h, offset in shapes:
        for ifog_dt, c_dt in ((f32, f32), (bf16, bf16), (bf16, f32),
                              (f32, bf16)):
            ifog, c = _cell_inputs(b, h, ifog_dt, c_dt, seed=b + h,
                                   offset=offset)
            got = pk.lstm_gates_fwd(ifog, c)
            want = pk.lstm_gates_reference(ifog, c)
            sync()
            checks = [_cell_err(g, w) for g, w in zip(got, want)]
            ok = (all(c_ok for _, c_ok in checks)
                  and all(g.dtype == c_dt and tuple(g.shape) == (b, h)
                          and torch.isfinite(g.float()).all().item()
                          for g in got))
            log(f"[parity] lstm_gates B={b} H={h} ifog {str(ifog_dt)[6:]} "
                f"c {str(c_dt)[6:]}{f' offset {offset}' if offset else ''}: "
                f"max abs err c_new {checks[0][0]:.3g} "
                f"h_new {checks[1][0]:.3g} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(
                    f"lstm_gates kernel disagrees with its plain version at "
                    f"B={b} H={h} ifog {ifog_dt} c {c_dt} offset {offset}: "
                    f"{checks}")
            n += 1
    log(f"[parity] lstm_gates: {n} cases agree")


def lstm_cell_bwd_parity() -> None:
    """K2b against ``lstm_gates_bwd_reference`` on the card at every shape
    of LSTM_CELL_SHAPES, for f32, bf16 and both mixes of input types with
    random dc_new and dh, then at f32 and bf16 with the last timestep's
    grads (dc_new None, dh a strided row view). c_new is the plain
    forward's."""
    import torch

    from deeplearning4j_tpu_torch.ops import pallas_kernels as pk

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(f32, f32, False), (bf16, bf16, False), (bf16, f32, False),
             (f32, bf16, False), (f32, f32, True), (bf16, bf16, True)]
    n = 0
    for b, h in LSTM_CELL_SHAPES:
        for ifog_dt, c_dt, last in cases:
            ifog, c = _cell_inputs(b, h, ifog_dt, c_dt, seed=b + h)
            c_new, _ = pk.lstm_gates_reference(ifog, c)
            dc, dh = _cell_grads(b, h, c_dt, seed=b + 2 * h, last_step=last)
            got = pk.lstm_gates_bwd(ifog, c, c_new, dc, dh)
            want = pk.lstm_gates_bwd_reference(ifog, c, c_new, dc, dh)
            sync()
            checks = [_cell_err(g, w) for g, w in zip(got, want)]
            ok = (all(c_ok for _, c_ok in checks)
                  and got[0].dtype == ifog_dt and got[1].dtype == c_dt
                  and tuple(got[0].shape) == (b, 4 * h)
                  and tuple(got[1].shape) == (b, h)
                  and all(torch.isfinite(g.float()).all().item()
                          for g in got))
            grads = ("dc_new None, dh row stride 3H" if last
                     else "random dc_new, dh")
            log(f"[parity] lstm_gates_bwd B={b} H={h} ifog "
                f"{str(ifog_dt)[6:]} c {str(c_dt)[6:]} ({grads}): max abs "
                f"err d_ifog {checks[0][0]:.3g} dc_prev {checks[1][0]:.3g} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(
                    f"lstm_gates_bwd kernel disagrees with its plain version "
                    f"at B={b} H={h} ifog {ifog_dt} c {c_dt} ({grads}): "
                    f"{checks}")
            n += 1
    log(f"[parity] lstm_gates_bwd: {n} cases agree")


def launch_floor() -> dict:
    """The floor under K2 and K2b: ``device_ms`` of an empty kernel that
    K2's library launches through the same ctypes path on K2's grid, at
    (1, 1) (one block) and at both bench shapes, and of K2 and K2b at
    (1, 1); beside them the empty launch by ``time_ms`` (the host's launch
    in the interval)."""
    import torch

    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.ops import pallas_kernels as pk

    lib = _kernels.load("lstm_gates")
    stream = torch.cuda.current_stream().cuda_stream

    def empty(b, h):
        rc = lib.dl4j_lstm_gates_empty(b, h, stream)
        if rc != 0:
            raise RuntimeError(f"empty launch failed: CUDA error {rc}")

    out = {}
    for b, h in ((1, 1), *LSTM_BENCH_SHAPES):
        out[f"empty_{b}x{h}"] = device_ms(lambda: empty(b, h))
    out["empty_1x1_with_launch"] = time_ms(lambda: empty(1, 1))
    ifog, c = _cell_inputs(1, 1, torch.float32, torch.float32, seed=1)
    c_new, _ = pk.lstm_gates_reference(ifog, c)
    dc, dh = _cell_grads(1, 1, torch.float32, seed=2)
    out["lstm_gates_1x1"] = device_ms(lambda: pk.lstm_gates_fwd(ifog, c))
    out["lstm_gates_bwd_1x1"] = device_ms(
        lambda: pk.lstm_gates_bwd(ifog, c, c_new, dc, dh))
    log(f"[measure] launch floor (ms, device_ms unless said) "
        f"{json.dumps(out)}")
    return out


def lstm_cell_measure(floor: dict) -> list:
    """K2 at both bench shapes, f32 (the training path's type) and bf16:
    its time, its plain version's and ATen's own CUDA LSTM cell's
    (``_thnn_fused_lstm_cell`` on pre-permuted i,f,g,o inputs with zero
    hidden gates, a yardstick the port never calls), all by ``device_ms``,
    and the bound; beside them K2 by ``time_ms`` (host launch included)
    and the empty kernel's ``device_ms`` on K2's grid (``launch_floor``).
    Returns the f32 entries of the kernels line."""
    import torch

    from deeplearning4j_tpu_torch.ops import pallas_kernels as pk

    entries = []
    for b, h in LSTM_BENCH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            ifog, c = _cell_inputs(b, h, dtype, dtype, seed=50 + h)
            got = pk.lstm_gates_fwd(ifog, c)
            want = pk.lstm_gates_reference(ifog, c)
            err = max(_cell_err(g, w)[0] for g, w in zip(got, want))
            ms = device_ms(lambda: pk.lstm_gates_fwd(ifog, c))
            plain = device_ms(lambda: pk.lstm_gates_reference(ifog, c))
            host_ms = time_ms(lambda: pk.lstm_gates_fwd(ifog, c))
            gates = torch.cat([ifog[:, :2 * h], ifog[:, 3 * h:],
                               ifog[:, 2 * h:3 * h]], dim=1).contiguous()
            zeros = torch.zeros_like(gates)
            fused = getattr(torch.ops.aten, "_thnn_fused_lstm_cell", None)
            lib, lib_note = None, ("this torch has no "
                                   "aten._thnn_fused_lstm_cell")
            if fused is not None:
                lib = device_ms(lambda: fused(gates, zeros, c))
                lib_note = ("aten._thnn_fused_lstm_cell(input_gates, "
                            "hidden_gates=0, cx): gate order i,f,g,o, "
                            "inputs pre-permuted; reads one more (B, 4H)")
            elt = c.element_size()
            entry = _kernel_entry(
                "lstm_gates", "deeplearning4j_tpu/ops/pallas_kernels.py:176",
                ms, plain, float(CELL_OPS_PER_ELT * b * h), 7 * b * h * elt,
                PEAK_F32_FLOPS, err, lib,
                f"B={b} H={h} {str(dtype)[6:]}", library_covers=lib_note,
                launches_cover="64 timesteps x the timed fit_epochs steps",
                ms_with_launch=host_ms,
                launch_floor_ms=floor[f"empty_{b}x{h}"])
            log(f"[measure] lstm_gates {entry['shape']}: kernel {ms:.4f} ms "
                f"({host_ms:.4f} ms with the host's launch in the interval),"
                f" plain {plain:.4f} ms, library "
                f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
                f"{entry['bound_ms'] * 1e3:.3f} us ({entry['bound_by']}: "
                f"{7 * b * h * elt / 1e6:.3f} MB); max abs err {err:.3g}")
            if dtype == torch.float32:
                entries.append(entry)
    return entries


def lstm_cell_bwd_measure(floor: dict) -> list:
    """K2b at both bench shapes, f32 and bf16, with random dc_new and dh:
    its time, its plain version's and ATen's own CUDA LSTM cell backward's
    (``_thnn_fused_lstm_cell_backward_impl`` on the activated gates in i,
    f, g, o order as its workspace, built outside the timed call: a
    yardstick the port never calls), all by ``device_ms``, and the bound;
    beside them K2b by ``time_ms`` and the launch floor. Returns the f32
    entries of the kernels line."""
    import torch

    from deeplearning4j_tpu_torch.ops import pallas_kernels as pk

    entries = []
    for b, h in LSTM_BENCH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            ifog, c = _cell_inputs(b, h, dtype, dtype, seed=60 + h)
            c_new, _ = pk.lstm_gates_reference(ifog, c)
            dc, dh = _cell_grads(b, h, dtype, seed=61 + h)
            got = pk.lstm_gates_bwd(ifog, c, c_new, dc, dh)
            want = pk.lstm_gates_bwd_reference(ifog, c, c_new, dc, dh)
            err = max(_cell_err(g, w)[0] for g, w in zip(got, want))
            ms = device_ms(lambda: pk.lstm_gates_bwd(ifog, c, c_new, dc, dh))
            plain = device_ms(
                lambda: pk.lstm_gates_bwd_reference(ifog, c, c_new, dc, dh))
            host_ms = time_ms(lambda: pk.lstm_gates_bwd(ifog, c, c_new, dc,
                                                        dh))
            z = ifog.float()
            workspace = torch.cat(
                [torch.sigmoid(z[:, :2 * h]), torch.tanh(z[:, 3 * h:]),
                 torch.sigmoid(z[:, 2 * h:3 * h])], dim=1).to(dtype)
            fused = getattr(torch.ops.aten,
                            "_thnn_fused_lstm_cell_backward_impl", None)
            lib, lib_err, lib_note = None, None, (
                "this torch has no aten._thnn_fused_lstm_cell_backward_impl")
            if fused is not None:
                lib = device_ms(lambda: fused(dh, dc, c, c_new, workspace,
                                              False))
                lib_gates, lib_dc, _ = fused(dh, dc, c, c_new, workspace,
                                             False)
                # back to i, f, o, g: the same function up to gate order
                lib_ifog = torch.cat([lib_gates[:, :2 * h],
                                      lib_gates[:, 3 * h:],
                                      lib_gates[:, 2 * h:3 * h]], dim=1)
                lib_err = max(_rel_err(lib_ifog, want[0]),
                              _rel_err(lib_dc, want[1]))
                lib_note = ("aten._thnn_fused_lstm_cell_backward_impl(dh, "
                            "dc_new, c_prev, c_new, workspace, False): gate "
                            "order i,f,g,o, activated gates precomputed as "
                            "its workspace (K2b recomputes them from ifog)")
            nbytes = _cell_bwd_bytes(ifog, c, dc)
            entry = _kernel_entry(
                "lstm_gates_bwd",
                "deeplearning4j_tpu/ops/pallas_kernels.py:240",
                ms, plain, float(CELL_BWD_OPS_PER_ELT * b * h), nbytes,
                PEAK_F32_FLOPS, err, lib, f"B={b} H={h} {str(dtype)[6:]}",
                replaces_note=("_lstm_gates_bwd, the lax backward of K2 that "
                               "XLA fuses: no pallas_call"),
                library_covers=lib_note, library_rel_err=lib_err,
                launches_cover="64 timesteps x the timed fit_epochs steps",
                ms_with_launch=host_ms,
                launch_floor_ms=floor[f"empty_{b}x{h}"])
            log(f"[measure] lstm_gates_bwd {entry['shape']}: kernel "
                f"{ms:.4f} ms ({host_ms:.4f} ms with the host's launch in the"
                f" interval), plain {plain:.4f} ms, library "
                f"{'n/a' if lib is None else f'{lib:.4f} ms'} (its outputs "
                f"{'n/a' if lib_err is None else f'{lib_err:.3g}'} from "
                f"the plain version's, relative), bound "
                f"{entry['bound_ms'] * 1e3:.3f} us ({entry['bound_by']}: "
                f"{nbytes / 1e6:.3f} MB), launch floor "
                f"{entry['launch_floor_ms']:.4f} ms; max abs err {err:.3g}")
            if dtype == torch.float32:
                entries.append(entry)
    return entries


def _lstm_conf(lr: float = 0.1):  # the zoo's rate
    from deeplearning4j_tpu_torch.models.zoo import char_lstm

    return char_lstm(vocab=LSTM_VOCAB, lr=lr)


def lstm_fit() -> dict:
    """The facade's main path on the char-LSTM: MultiLayerNetwork
    .fit_epochs over a ListDataSetIterator at batch 64, LSTM_WARMUP warm-up
    steps then LSTM_STEPS timed steps (K2 and K2b counted from 0 over
    exactly those: 64 each a step), then predict on a held-out batch
    (counted alone: 64 K2 launches, no K2b)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import _kernels

    b, w = LSTM_BATCH, LSTM_WARMUP
    x, y = _one_hot_tokens((b * (w + LSTM_STEPS), LSTM_SEQ + 1), LSTM_VOCAB,
                           seed=7)
    net = MultiLayerNetwork(_lstm_conf(LSTM_FIT_LR), device=DEVICE).init()
    net.fit_epochs(ListDataSetIterator(DataSet(x[:w * b], y[:w * b]), b))
    first = DataSet(x[w * b:(w + 1) * b], y[w * b:(w + 1) * b])
    score0 = net.score(first)
    timed = ListDataSetIterator(DataSet(x[w * b:], y[w * b:]), b)
    sync()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    net.fit_epochs(timed)
    sync()
    wall = time.perf_counter() - t0
    launches = _kernels.LAUNCHES["lstm_gates"]
    bwd_launches = _kernels.LAUNCHES["lstm_gates_bwd"]
    score1 = net.score(first)
    for name, n in (("lstm_gates", launches),
                    ("lstm_gates_bwd", bwd_launches)):
        if n != LSTM_SEQ * LSTM_STEPS:
            raise AssertionError(f"{name} launched {n} times over "
                                 f"{LSTM_STEPS} steps, expected {LSTM_SEQ} "
                                 "per step")
    if not (np.isfinite([score0, score1]).all() and score1 < score0):
        raise AssertionError(f"LSTM score on the first timed batch "
                             f"{score0} -> {score1}: not finite or not "
                             "falling")
    hx, _ = _one_hot_tokens((b, LSTM_SEQ + 1), LSTM_VOCAB, seed=8)
    _kernels.reset_launches()
    pred = net.predict(hx)
    predict_launches = _kernels.LAUNCHES["lstm_gates"]
    predict_bwd = _kernels.LAUNCHES["lstm_gates_bwd"]
    if (predict_launches != LSTM_SEQ or predict_bwd != 0
            or pred.shape != (b, LSTM_SEQ)):
        raise AssertionError(f"predict: {predict_launches} K2 launches "
                             f"(expected {LSTM_SEQ}), {predict_bwd} K2b "
                             f"(expected 0), shape {pred.shape}")
    ms = wall * 1e3 / LSTM_STEPS
    out = {"steps": LSTM_STEPS, "batch": [b, LSTM_SEQ], "lr": LSTM_FIT_LR,
           "wall_s": wall, "ms_per_step": ms, "samples_per_s": b * 1e3 / ms,
           "tokens_per_s": b * LSTM_SEQ * 1e3 / ms,
           "score_first_batch": [score0, score1], "launches": launches,
           "bwd_launches": bwd_launches, "predict_launches": predict_launches,
           "predict_bwd_launches": predict_bwd,
           "predict_shape": list(pred.shape)}
    log(f"[lstm] fit_epochs {json.dumps(out)}")
    return out


def _kernel_share(prof, name: str) -> float:
    """Device ms of the kernels whose name holds ``name``."""
    from torch.autograd import DeviceType

    return sum(_self_us(e) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and name in e.key) / 1e3


def lstm_epoch(bf16: bool, kernels: bool = True,
               profiled: bool = False) -> dict:
    """make_train_epoch(conf, 8, donate=True) on one (8, 64, 64, 512) chunk
    of one-hot tokens, as bench.measure("lstm_wide") builds it: a warm-up
    chunk, then one timed chunk with K2 and K2b counted from 0 over it.
    With ``kernels=False`` the chunk runs with set_lstm_gates(False), the
    bench's ``_nokernels`` twin: neither launches. With ``profiled`` the
    timed chunk runs under torch.profiler for the busy share, the device
    operations a step (the most frequent by name) and K2's and K2b's
    shares."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.nn import functional as F
    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.ops import pallas_kernels as pk
    from deeplearning4j_tpu_torch.ops.dtypes import BF16_COMPUTE

    conf = _lstm_conf()
    params = F.init_params(conf, 0, device=DEVICE)
    states = F.init_train_state(conf, params)
    epoch = F.make_train_epoch(conf, LSTM_CHUNK, donate=True,
                               policy=BF16_COMPUTE if bf16 else None)
    x, y = _one_hot_tokens((LSTM_CHUNK, LSTM_BATCH, LSTM_SEQ + 1),
                           LSTM_VOCAB, seed=2)
    xs, ys = (torch.from_numpy(a).to(DEVICE) for a in (x, y))
    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if profiled else contextlib.nullcontext())
    pk.set_lstm_gates(kernels)
    try:
        params, states, warm = epoch(params, states, 0, xs, ys, 1)
        warm = warm.tolist()
        _kernels.reset_launches()
        with ctx as prof:
            t0 = time.perf_counter()
            params, states, scores = epoch(params, states, LSTM_CHUNK, xs,
                                           ys, 2)
            sync()
            wall = time.perf_counter() - t0
    finally:
        pk.set_lstm_gates(None)
    launches = _kernels.LAUNCHES["lstm_gates"]
    bwd_launches = _kernels.LAUNCHES["lstm_gates_bwd"]
    scores = scores.tolist()
    want = LSTM_SEQ * LSTM_CHUNK if kernels else 0
    for name, n in (("lstm_gates", launches),
                    ("lstm_gates_bwd", bwd_launches)):
        if n != want:
            raise AssertionError(f"{name} launched {n} times over a "
                                 f"{LSTM_CHUNK}-step chunk, expected {want}")
    if not np.isfinite(warm + scores).all():
        raise AssertionError(f"LSTM epoch scores not finite: {warm}, "
                             f"{scores}")
    ms = wall * 1e3 / LSTM_CHUNK
    out = {"policy": "bf16" if bf16 else "f32", "kernels": kernels,
           "profiled": profiled, "steps": LSTM_CHUNK,
           "batch": [LSTM_BATCH, LSTM_SEQ], "wall_s": wall,
           "ms_per_step": ms, "samples_per_s": LSTM_BATCH * 1e3 / ms,
           "tokens_per_s": LSTM_BATCH * LSTM_SEQ * 1e3 / ms,
           "launches": launches, "bwd_launches": bwd_launches,
           "scores": warm + scores}
    if profiled:
        out.update(device_busy(prof, wall))
        counts = _by_name(prof, lambda e: e.count)
        out["device_ops_per_step"] = sum(counts.values()) / LSTM_CHUNK
        out["device_ops_per_step_by_kernel"] = {
            k: n / LSTM_CHUNK for k, n in list(counts.items())[:10]}
        for name in ("lstm_gates", "lstm_gates_bwd"):
            out[f"{name}_device_ms"] = _kernel_share(prof, f"{name}_kernel")
            out[f"{name}_share"] = (out[f"{name}_device_ms"]
                                    / max(out["device_busy_ms"], 1e-9))
    log(f"[lstm] train_epoch {json.dumps(out)}")
    return out


def lstm_grad_parity() -> None:
    """One char-LSTM step's loss and grads (batch 64, sequence 64, f32, TF32
    off) through K2 and K2b against set_lstm_gates(False) (the plain cell,
    forward and backward), from one set of params and one batch."""
    import torch

    from deeplearning4j_tpu_torch._device import tree_leaves, tree_unflatten
    from deeplearning4j_tpu_torch.nn import functional as F
    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.ops import pallas_kernels as pk

    conf = _lstm_conf()
    params = F.init_params(conf, 3, device=DEVICE)
    x, y = (torch.from_numpy(a).to(DEVICE) for a in _one_hot_tokens(
        (LSTM_BATCH, LSTM_SEQ + 1), LSTM_VOCAB, seed=9))

    def loss_and_grads(kernel):
        pk.set_lstm_gates(kernel)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        _kernels.reset_launches()
        loss = F.network_loss(conf, tree_unflatten(params, leaves), x, y,
                              train=True)
        grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), grads, (
            _kernels.LAUNCHES["lstm_gates"],
            _kernels.LAUNCHES["lstm_gates_bwd"])

    try:
        kl, kg, k_launches = loss_and_grads(True)
        dl, dg, d_launches = loss_and_grads(False)
    finally:
        pk.set_lstm_gates(None)
    names = sorted(params[0])
    errs = {n: _rel_err(g, w) for n, g, w in zip(names, kg, dg)}
    loss_err = abs(kl - dl)
    log(f"[parity] LSTM step K2+K2b vs plain cell, f32, batch {LSTM_BATCH}x"
        f"{LSTM_SEQ}: loss {kl:.7f} vs {dl:.7f} (abs err {loss_err:.3g}), "
        f"grad rel err per leaf {json.dumps(errs)}; launches {k_launches} "
        f"vs {d_launches}")
    if not (loss_err <= LSTM_LOSS_TOL and max(errs.values()) <= LSTM_GRAD_TOL
            and k_launches == (LSTM_SEQ, LSTM_SEQ)
            and d_launches == (0, 0)
            and all(torch.isfinite(g).all().item() for g in kg)):
        raise AssertionError(f"LSTM grads through K2+K2b vs plain cell: loss "
                             f"err {loss_err} (tol {LSTM_LOSS_TOL}), grad errs "
                             f"{errs} (tol {LSTM_GRAD_TOL}), launches "
                             f"{k_launches}/{d_launches}")


def lstm() -> list:
    """Phase 6; returns K2's and K2b's entries of the kernels line."""
    lstm_cell_parity()
    lstm_cell_bwd_parity()
    floor = launch_floor()
    entries = lstm_cell_measure(floor)
    bwd_entries = lstm_cell_bwd_measure(floor)
    main_run = lstm_fit()
    for entry in entries:
        entry["launches"] = main_run["launches"]
    for entry in bwd_entries:
        entry["launches"] = main_run["bwd_launches"]
    lstm_epoch(bf16=False)
    lstm_epoch(bf16=True)
    lstm_epoch(bf16=False, kernels=False)
    lstm_epoch(bf16=False, profiled=True)
    lstm_epoch(bf16=False, kernels=False, profiled=True)
    lstm_grad_parity()
    return entries + bwd_entries


# ------------------------------------------------------------- phase 7 ----

# the bench's long-context attention char-LM, attn_long (bench.py:97, :204,
# :239-241): char_attention_lm(vocab=128, d_model=512, n_heads=4,
# num_iterations=1), batch 4, T=2048
ATTN_VOCAB, ATTN_D, ATTN_HEADS, ATTN_B, ATTN_T = 128, 512, 4, 4, 2048
ATTN_WARMUP, ATTN_STEPS = 2, 5
# kernels vs dense attention, one step at f32: loss absolute, grads as max
# abs error over the leaf's max. No ReLU in this model (linear embedding),
# so no kink flips: the difference is the summation order of the kernels
# (their parity tolerance is 1e-4 of the max) carried through the block
ATTN_LOSS_TOL, ATTN_GRAD_TOL = 1e-4, 1e-3


def _attn_conf():
    from deeplearning4j_tpu_torch.models.zoo import char_attention_lm

    return char_attention_lm(vocab=ATTN_VOCAB, d_model=ATTN_D,
                             n_heads=ATTN_HEADS, num_iterations=1)


def attn_lm_fit() -> dict:
    """MultiLayerNetwork.fit_epochs on the attention char-LM at batch 4,
    T=2048 with the auto core: ATTN_WARMUP warm-up steps then ATTN_STEPS
    timed steps, K3f, K3k and K3q each counted from 0 over exactly those
    (once a step: one attention layer); then ``output`` on one batch (one
    K3f launch)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.ops.flash_attention import (
        resolve_attention_impl,
    )

    impl = resolve_attention_impl(ATTN_T)
    if impl not in ("flash", "blockwise"):
        raise AssertionError(f"auto core at T={ATTN_T} is {impl!r}")
    b, w = ATTN_B, ATTN_WARMUP
    x, y = _one_hot_tokens((b * (w + ATTN_STEPS), ATTN_T + 1), ATTN_VOCAB,
                           seed=11)
    net = MultiLayerNetwork(_attn_conf(), device=DEVICE).init()
    net.fit_epochs(ListDataSetIterator(DataSet(x[:w * b], y[:w * b]), b))
    timed = ListDataSetIterator(DataSet(x[w * b:], y[w * b:]), b)
    sync()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    net.fit_epochs(timed)
    sync()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    for name in TRAIN_KERNELS:
        if launches[name] != ATTN_STEPS:
            raise AssertionError(f"attention LM: {name} launched "
                                 f"{launches[name]} times over {ATTN_STEPS} "
                                 "steps, expected once a step")
    score = net.score(DataSet(x[:b], y[:b]))
    _kernels.reset_launches()
    out_logits = net.output(x[:b])
    sync()
    out_launches = dict(_kernels.LAUNCHES)
    if not (np.isfinite(score)
            and tuple(out_logits.shape) == (b, ATTN_T, ATTN_VOCAB)
            and bool(out_logits.isfinite().all())
            and out_launches["flash_attention_fwd"] == 1
            and out_launches["flash_attention_bwd_dkv"] == 0
            and out_launches["flash_attention_bwd_dq"] == 0):
        raise AssertionError(f"attention LM output: score {score}, shape "
                             f"{tuple(out_logits.shape)}, launches "
                             f"{out_launches}")
    ms = wall * 1e3 / ATTN_STEPS
    out = {"attn_impl": impl, "steps": ATTN_STEPS, "batch": [b, ATTN_T],
           "wall_s": wall, "ms_per_step": ms, "samples_per_s": b * 1e3 / ms,
           "tokens_per_s": b * ATTN_T * 1e3 / ms, "score": score,
           "launches": {k: launches[k] for k in TRAIN_KERNELS},
           "output_launches": {k: out_launches[k] for k in TRAIN_KERNELS}}
    log(f"[attn] fit_epochs {json.dumps(out)}")
    return out


def attn_lm_grad_parity() -> None:
    """One attention-LM step's loss and grads (batch 4, T=2048, f32, TF32
    off) through the kernels (the auto core) against
    set_attention_impl("dense"), with non-zero grads for wq, wk and wv."""
    import torch

    from deeplearning4j_tpu_torch._device import tree_leaves, tree_unflatten
    from deeplearning4j_tpu_torch.nn import functional as F
    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    conf = _attn_conf()
    params = F.init_params(conf, 3, device=DEVICE)
    x, y = (torch.from_numpy(a).to(DEVICE) for a in _one_hot_tokens(
        (ATTN_B, ATTN_T + 1), ATTN_VOCAB, seed=12))

    def loss_and_grads(impl):
        fa.set_attention_impl(impl)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        _kernels.reset_launches()
        loss = F.network_loss(conf, tree_unflatten(params, leaves), x, y,
                              train=True)
        grads = torch.autograd.grad(loss, leaves)
        return (float(loss.detach()), grads,
                sum(_kernels.LAUNCHES[k] for k in TRAIN_KERNELS))

    try:
        kl, kg, k_launches = loss_and_grads(None)
        dl, dg, d_launches = loss_and_grads("dense")
    finally:
        fa.set_attention_impl(None)
    names = [f"{i}.{key}" for i in range(conf.n_layers)
             for key in sorted(params[i])]
    errs = {n: _rel_err(g, w) for n, g, w in zip(names, kg, dg)}
    zero = [n for n, g in zip(names, kg)
            if n.split(".")[1] in ("wq", "wk", "wv")
            and not bool(g.abs().max() > 0)]
    loss_err = abs(kl - dl)
    log(f"[parity] attention LM step kernels vs dense, f32, B={ATTN_B} "
        f"T={ATTN_T}: loss {kl:.7f} vs {dl:.7f} (abs err {loss_err:.3g}), "
        f"grad rel err per leaf {json.dumps(errs)}; launches {k_launches} "
        f"vs {d_launches}; zero-grad attention leaves {zero}")
    if not (loss_err <= ATTN_LOSS_TOL and max(errs.values()) <= ATTN_GRAD_TOL
            and not zero and k_launches == 3 and d_launches == 0
            and all(torch.isfinite(g).all().item() for g in kg)):
        raise AssertionError(f"attention LM grads, kernels vs dense: loss "
                             f"err {loss_err} (tol {ATTN_LOSS_TOL}), grad "
                             f"errs {errs} (tol {ATTN_GRAD_TOL}), zero "
                             f"{zero}, launches {k_launches}/{d_launches}")


def attn_lm() -> dict:
    """Phase 7."""
    out = attn_lm_fit()
    attn_lm_grad_parity()
    return out


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
    bwd_parity()
    serve_entry = flash_measure()
    train_entries = train_shape_measure()

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = init_lm_params(gen, VOCAB, D_MODEL, N_HEADS, N_EXPERTS, D_FF,
                            n_layers=N_LAYERS, device=DEVICE)
    main_run = serve(params, None, PROMPT_LENS, seed=1)
    serve_entry["launches"] = main_run["kernel_launches"]
    serve(params, "flash", FLASH_PROMPT_LENS, seed=2)
    serve(params, None, PROMPT_LENS, seed=3, profiled=True)
    prefill_parity(params)
    del params

    train_main = train()
    for entry in train_entries:
        entry["launches"] = train_main["launches"][entry["name"]]
        entry["launches_cover"] = ("the timed f32 training run (the "
                                   "training path's type)")
    grad_parity()
    optimizer_path()
    train(profiled=True)
    wide_head_step()

    mlp_entries = mlp()
    lstm_entries = lstm()
    attn_lm()

    print(smi)
    print(json.dumps({"kernels": [serve_entry, *train_entries,
                                  *mlp_entries, *lstm_entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
