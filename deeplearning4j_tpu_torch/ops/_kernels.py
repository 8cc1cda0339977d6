"""Build, load and count the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled at first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface under
``deeplearning4j_tpu_torch/_build/`` and bound with ``ctypes``. The library
name carries a hash of its source and of every ``csrc`` header it pulls in
with a quoted ``#include``, so an edited source or header is rebuilt and a
built one is reused. Nothing here runs at import: the CPU tests import every
module of the package on a host without ``nvcc``.

``LAUNCHES`` holds one integer per kernel; a wrapper adds one where it
launches its kernel and nowhere else, so a run can show that the main path
went through the kernel.
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
from typing import Dict, List

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

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# ptxas/nvcc output of the builds this process ran: {source name: text}
build_logs: Dict[str, str] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signature of every exported entry point: {symbol: argtypes}
_SIGNATURES = {
    "flash_attention_fwd": {
        "dl4j_flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                     _F, _I, _P],
    },
    "flash_attention_bwd_dkv": {
        "dl4j_flash_attention_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                         _I, _I, _I, _F, _I, _P],
    },
    "flash_attention_bwd_dq": {
        "dl4j_flash_attention_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                        _I, _I, _F, _I, _P],
    },
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


def count_launch(name: str) -> None:
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
    the library path. The compiler's output is kept in ``build_logs``."""
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
