"""Build, load, count and cost the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled at first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface under
``deeplearning4j_tpu_torch/_build/`` and bound with ``ctypes``. The library
name carries a hash of its source and of every ``csrc`` header it pulls in
with a quoted ``#include``, so an edited source or header is rebuilt and a
built one is reused. Nothing here runs at import: the CPU tests import every
module of the package on a host without ``nvcc``.

``LAUNCHES`` holds one integer per kernel; a wrapper adds one where it
launches its kernel and nowhere else, so a run can show that the main path
went through the kernel. ``SOURCES`` names every library: each kernel's,
and the wide twins of the three flash kernels (head dims above 128), whose
launches count as their kernel's.

Each kernel has one cost function here (``*_cost``): its FLOPs,
transcendental operations and the bytes it must move at given shapes. The
wrappers report them into a step profile (``telemetry.xprofile``) on both
routes, and ``chip_smoke.py`` bounds each kernel's time by them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List

from deeplearning4j_tpu_torch._capture import KernelCost

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0,
                            "flash_attention_bwd_dkv": 0,
                            "flash_attention_bwd_dq": 0,
                            "fused_dense": 0,
                            "lstm_gates": 0,
                            "lstm_gates_bwd": 0}

# the libraries: csrc/<name>.cu each
SOURCES = tuple(sorted([*LAUNCHES, "flash_attention_fwd_wide",
                        "flash_attention_bwd_dkv_wide",
                        "flash_attention_bwd_dq_wide"]))

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# ptxas/nvcc output of the builds this process ran: {source name: text}
build_logs: Dict[str, str] = {}
# called as hook(name, signature) after each nvcc build: the compile
# events a listener counts (``utils.retrace_guard`` registers one)
compile_hooks: List[Callable[[str, str], None]] = []

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# the flash entry points' arguments: pointers, then (bh, tq, tk, dh,
# causal, shift, scale, is_bf16), the forward's key split, the stream
_FWD = [_P] * 5 + [_I] * 6 + [_F, _I, _I, _P]
_DKV = [_P] * 8 + [_I] * 6 + [_F, _I, _P]
_DQ = [_P] * 7 + [_I] * 6 + [_F, _I, _P]
# C signature of every exported entry point: {symbol: argtypes}
_SIGNATURES = {
    "flash_attention_fwd": {"dl4j_flash_attention_fwd": _FWD},
    "flash_attention_fwd_wide": {"dl4j_flash_attention_fwd_wide": _FWD},
    "flash_attention_bwd_dkv": {"dl4j_flash_attention_bwd_dkv": _DKV},
    "flash_attention_bwd_dkv_wide": {
        "dl4j_flash_attention_bwd_dkv_wide": _DKV},
    "flash_attention_bwd_dq": {"dl4j_flash_attention_bwd_dq": _DQ},
    "flash_attention_bwd_dq_wide": {"dl4j_flash_attention_bwd_dq_wide": _DQ},
    "fused_dense": {
        "dl4j_fused_dense": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "lstm_gates": {
        "dl4j_lstm_gates": [_P, _P, _P, _P, _L, _L, _I, _I, _P],
        # an empty kernel on K2's grid: the launch floor, for measurement
        "dl4j_lstm_gates_empty": [_L, _L, _P],
    },
    "lstm_gates_bwd": {
        "dl4j_lstm_gates_bwd": [_P, _P, _P, _P, _L, _P, _L, _P, _P, _L, _L,
                                _I, _I, _P],
    },
}


_count_lock = threading.Lock()


def count_launch(name: str) -> None:
    """Count one launch of ``name``'s kernel. Under a lock: ``+=`` on a
    dict entry is not atomic, and the scaleout runner's worker threads
    launch kernels concurrently."""
    with _count_lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build on a host "
                       "with the CUDA toolkit")


_QUOTED_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def source_files(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and the ``csrc`` files it includes with quoted
    ``#include``s, transitively, each once, in the order first reached."""
    seen: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _QUOTED_INCLUDE.findall(path.read_bytes()):
            todo.append(path.parent / inc.decode())
    return seen


def _library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in source_files(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists; returns
    the library path. The compiler's output is kept in ``build_logs``, and
    each compile calls ``compile_hooks`` with ``nvcc:<name>`` and its
    signature (the source with its hash, and the flags)."""
    out = _library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{build_logs[name]}")
    os.replace(tmp, out)
    signature = (f"{name}.cu@{out.stem.rsplit('_', 1)[-1]}, "
                 f"{' '.join(NVCC_FLAGS)}")
    for hook in list(compile_hooks):
        hook(f"nvcc:{name}", signature)
    return out


def load(name: str) -> ctypes.CDLL:
    """The bound library of kernel ``name``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for symbol, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


# ------------------------------------------------------------------ costs --
#
# Causal attention computes the scores on or below the diagonal: half of
# the (T, T) products and exponentials, as the kernels' tile walk skips
# the blocks above it. ``_pairs`` states that halving once for K3f, K3k
# and K3q, and their pairs at a shifted diagonal (Tq rows against Tk keys,
# key j seen by row i iff j <= i + shift) as the same area: the part of
# the (Tq, Tk) rectangle on or below the line j = i + shift.


def _pairs(b: int, h: int, t: int, causal: bool, tk: int = None,
           shift: int = 0) -> float:
    """(query, key) pairs the attention scores: B·H·T·Tk (Tk defaults to
    T), and under causal the area of the rectangle under the diagonal
    shifted by ``shift``: B·H·T²/2 at Tk = T, shift 0."""
    tk = t if tk is None else tk
    if not causal:
        return float(b) * h * t * tk

    def under(u: float) -> float:
        # ∫ min(max(w, 0), tk) dw from -∞ to u
        if u <= 0:
            return 0.0
        if u <= tk:
            return u * u / 2.0
        return tk * tk / 2.0 + float(tk) * (u - tk)

    return float(b) * h * (under(t + shift) - under(shift))


def flash_attention_fwd_cost(b: int, h: int, t: int, dh: int, causal: bool,
                             elt: int, tk: int = None,
                             shift: int = 0) -> KernelCost:
    """K3f over ``t`` query rows and ``tk`` keys (default ``t``) at the
    causal diagonal's ``shift``: two products over the pairs (Q·Kᵀ and
    P·V), one exp per pair; q, k, v read and o written (``elt`` bytes an
    element), lse (f32) written."""
    tk = t if tk is None else tk
    pairs = _pairs(b, h, t, causal, tk, shift)
    rows = float(b) * h * dh * elt
    return KernelCost(4.0 * pairs * dh, pairs,
                      rows * (2 * t + 2 * tk) + 4.0 * b * h * t)


def flash_attention_bwd_dkv_cost(b: int, h: int, t: int, dh: int,
                                 causal: bool, elt: int, tk: int = None,
                                 shift: int = 0) -> KernelCost:
    """K3k over ``t`` query rows and ``tk`` keys (default ``t``) at the
    causal diagonal's ``shift``: four products over the pairs (S = Q·Kᵀ
    again, dP = dO·Vᵀ, dV = Pᵀ·dO, dK = dSᵀ·Q), one exp per pair; q and do
    (t rows), k and v (tk rows) read, dk and dv (tk rows) written, lse and
    delta (f32, t) read."""
    tk = t if tk is None else tk
    pairs = _pairs(b, h, t, causal, tk, shift)
    rows = float(b) * h * dh * elt
    return KernelCost(8.0 * pairs * dh, pairs,
                      rows * (2 * t + 4 * tk) + 8.0 * b * h * t)


def flash_attention_bwd_dq_cost(b: int, h: int, t: int, dh: int,
                                causal: bool, elt: int, tk: int = None,
                                shift: int = 0) -> KernelCost:
    """K3q over ``t`` query rows and ``tk`` keys (default ``t``) at the
    causal diagonal's ``shift``: three products over the pairs (S, dP,
    dQ = dS·K), one exp per pair; q and do (t rows), k and v (tk rows)
    read, dq (t rows) written, lse and delta (f32, t) read."""
    tk = t if tk is None else tk
    pairs = _pairs(b, h, t, causal, tk, shift)
    rows = float(b) * h * dh * elt
    return KernelCost(6.0 * pairs * dh, pairs,
                      rows * (3 * t + 2 * tk) + 8.0 * b * h * t)


# activations whose epilogue is a transcendental an element
_TRANSCENDENTAL_ACTS = ("tanh", "sigmoid")


def fused_dense_cost(m: int, k: int, n: int, activation: str,
                     elt: int) -> KernelCost:
    """K1: the (M, K)·(K, N) product (the bias and activation epilogue is
    not counted as FLOPs); one transcendental an output for tanh and
    sigmoid; x, w, b read and the output written."""
    out = float(m) * n
    return KernelCost(2.0 * m * k * n,
                      out if activation in _TRANSCENDENTAL_ACTS else 0.0,
                      float(elt) * (m * k + k * n + n + m * n))


# ~25 f32 operations an element of K2 (3 sigmoids, 2 tanh, 3 products, 1
# sum; a transcendental counted as 4) and ~48 of K2b (the same 5
# transcendentals, the sigmoids' sums and quotients and 22 products, sums
# and differences)
CELL_OPS_PER_ELT = 25
CELL_BWD_OPS_PER_ELT = 48


def lstm_gates_cost(b: int, h: int, ifog_elt: int,
                    c_elt: int) -> KernelCost:
    """K2: ``CELL_OPS_PER_ELT`` operations and 5 transcendentals an
    element of (B, H); ifog (B, 4H) and c_prev read, c_new and h_new
    written."""
    n = float(b) * h
    return KernelCost(CELL_OPS_PER_ELT * n, 5 * n,
                      n * (4 * ifog_elt + 3 * c_elt))


def lstm_gates_bwd_cost(b: int, h: int, ifog_elt: int, c_elt: int,
                        has_dc: bool = True,
                        has_dh: bool = True) -> KernelCost:
    """K2b: ``CELL_BWD_OPS_PER_ELT`` operations and 5 transcendentals an
    element; ifog read and d_ifog written (4H each), c_prev and c_new
    read, dc_new and dh read when given, dc_prev written."""
    n = float(b) * h
    streams = 3 + int(bool(has_dc)) + int(bool(has_dh))
    return KernelCost(CELL_BWD_OPS_PER_ELT * n, 5 * n,
                      n * (8 * ifog_elt + streams * c_elt))

