"""Counterpart of ``deeplearning4j_tpu/utils/retrace_guard.py``: fail when a
region compiles beyond its pinned budget.

The JAX package counts XLA backend compiles: shape or weak-type drift (a
Python scalar where an array was traced, a batch that changes size)
silently recompiles a jitted step on every call. The port runs eagerly,
so an ordinary step compiles nothing. Its compile events are two:

- every ``nvcc`` build of a kernel (``ops._kernels.build``; a library
  already in ``_build/`` is loaded, not compiled, and is not counted).
  Its signature is the source with the hash of its text and headers, and
  the compiler's flags;
- every Dynamo graph compile wherever a caller uses ``torch.compile``
  (``torch._dynamo.callback``'s compile-start callbacks: a frame traced
  anew, or a backward graph compiled lazily). Its signature is the
  frame's arguments in order: a tensor as its dtype and shape
  (``f32[3]``), a Python scalar as its type and value (``float 2.0``,
  Dynamo specializes on it), anything else as its type name.

A warmed step then never compiles: ``retrace_guard(0)`` over it holds
that no kernel is rebuilt and no compiled function retraces. JAX's
compiles of eager steps (XLA's backend compile of each new jitted
program, of each dispatched primitive at a new shape) have no
counterpart: PyTorch dispatches eager operators to precompiled kernels
and compiles nothing for them.

Usage (context manager)::

    step = make_single_device_train_step(...)
    step(params, states, x, y)             # warm-up: kernels build once
    with retrace_guard(0, label="lm steady state"):
        for _ in range(5):
            params, states, loss = step(params, states, x, y)

A blown budget reports WHAT compiled in the region, each with its
signature and the positional diff against the previous compile of the
same function: "arg 0: f32[3] -> f32[5]" instead of a bare count.
"""

from __future__ import annotations

import inspect
import sys
import threading
import types
from typing import Optional

__all__ = ["RetraceBudgetExceeded", "retrace_guard", "compiles_so_far",
           "recent_compiles", "signature_diff"]


class RetraceBudgetExceeded(AssertionError):
    """A guarded region compiled more than its pinned budget."""


_lock = threading.Lock()
_counter = {"n": 0}
_installed = {"done": False}

_SIG_RING_MAX = 64
_sig_ring: list = []  # [{"seq", "name", "signature"}], bounded
_sig_seq = {"n": 0}

# the Dynamo triggers that compile a graph (CUDA-graph recording and
# Triton autotuning compile none)
_COMPILE_TRIGGERS = ("DYNAMO", "LAZY_BACKWARD")


def note_compile(name: str, signature: str) -> None:
    """Count one compile of ``name`` and record its signature (the kernel
    builder's hook and the Dynamo callback)."""
    with _lock:
        _counter["n"] += 1
        _sig_seq["n"] += 1
        _sig_ring.append({"seq": _sig_seq["n"], "name": name,
                          "signature": signature})
        del _sig_ring[:-_SIG_RING_MAX]


# ------------------------------------------------- compile signatures ----

_SHORT_DTYPES = {"float32": "f32", "float64": "f64", "float16": "f16",
                 "bfloat16": "bf16", "int64": "i64", "int32": "i32",
                 "int16": "i16", "int8": "i8", "uint8": "u8",
                 "bool": "bool", "complex64": "c64"}


def _describe_value(x) -> str:
    """One argument of a compile signature: ``f32[2,3]`` for a tensor
    (a shape without spaces), ``float 2.0`` for a Python scalar, the type
    name otherwise."""
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        name = str(dtype).rsplit(".", 1)[-1]
        dims = ",".join(str(int(d)) for d in shape)
        return f"{_SHORT_DTYPES.get(name, name)}[{dims}]"
    if isinstance(x, (bool, int, float, complex)) or x is None:
        return f"{type(x).__name__} {x!r}"
    return type(x).__name__


def _frame_args(code: types.CodeType, f_locals) -> list:
    """The compiled frame's arguments in order (then its ``*args``), as
    ``_describe_value``."""
    n = code.co_argcount + code.co_kwonlyargcount
    out = [_describe_value(f_locals[name]) for name in code.co_varnames[:n]
           if name in f_locals]
    if code.co_flags & inspect.CO_VARARGS:
        out.extend(_describe_value(v)
                   for v in f_locals.get(code.co_varnames[n], ()))
    return out


def _dynamo_frame() -> Optional[tuple]:
    """(code, locals) of the frame Dynamo is compiling: the ``code`` and
    ``locals`` arguments of ``torch._dynamo.convert_frame._compile`` up
    the stack of its compile-start callback, or None."""
    f = sys._getframe(1)
    while f is not None:
        if (f.f_code.co_name == "_compile"
                and "convert_frame" in f.f_code.co_filename):
            loc = f.f_locals
            code, frame_locals = loc.get("code"), loc.get("locals")
            if isinstance(code, types.CodeType) and frame_locals is not None:
                return code, frame_locals
        f = f.f_back
    return None


def _on_dynamo_compile(args) -> None:
    trigger = getattr(getattr(args, "callback_trigger", None), "name",
                      "DYNAMO")
    if trigger not in _COMPILE_TRIGGERS:
        return
    found = _dynamo_frame() if trigger == "DYNAMO" else None
    if found is None:
        note_compile(f"dynamo:{trigger.lower()}", "")
        return
    code, frame_locals = found
    name = f"dynamo:{code.co_name} ({code.co_filename}:{code.co_firstlineno})"
    note_compile(name, ", ".join(_frame_args(code, frame_locals)))


def _install() -> None:
    """Register for both compile events once: ``ops._kernels``'
    ``compile_hooks`` and Dynamo's compile-start callbacks."""
    with _lock:
        if _installed["done"]:
            return
        _installed["done"] = True
    from torch._dynamo.callback import on_compile_start

    from deeplearning4j_tpu_torch.ops import _kernels

    _kernels.compile_hooks.append(note_compile)
    on_compile_start(_on_dynamo_compile)


def recent_compiles(since_seq: int = 0) -> list:
    """Compile records (seq, name, signature) after ``since_seq``."""
    _install()
    with _lock:
        return [dict(r) for r in _sig_ring if r["seq"] > since_seq]


def signature_diff(prev: str, cur: str) -> str:
    """Human-readable positional diff of two signatures (arguments joined
    by ``", "``)."""
    a = [x for x in prev.split(", ") if x]
    b = [x for x in cur.split(", ") if x]
    if not a and not b:
        return "signatures unparsed"
    if len(a) != len(b):
        return f"arg count changed: {len(a)} -> {len(b)}"
    changes = [f"arg {i}: {x} -> {y}"
               for i, (x, y) in enumerate(zip(a, b)) if x != y]
    return "; ".join(changes) if changes else "signatures identical"


def compiles_so_far() -> int:
    """Process-wide compile count (kernel builds and Dynamo compiles
    since the guard was first installed): monotonic, meaningful as a
    delta, which is what ``retrace_guard`` takes."""
    _install()
    with _lock:
        return _counter["n"]


class retrace_guard:
    """Context manager asserting at most ``budget`` compiles happen inside
    the block.

    ``budget=0`` pins a steady-state region (a warmed step never
    compiles); a positive budget pins a cold region's count (the first
    step builds its kernels and nothing else). The count is process-wide:
    do not run guarded regions concurrently in threads.
    """

    def __init__(self, budget: int, label: str = ""):
        self.budget = int(budget)
        self.label = label
        self.count = 0
        self.compiled: list = []  # signature records seen inside the region
        self._start = 0
        self._sig_start = 0

    def __enter__(self) -> "retrace_guard":
        _install()
        self._start = compiles_so_far()
        with _lock:
            self._sig_start = _sig_seq["n"]
        return self

    def _signature_report(self) -> str:
        """What compiled in this region and the diff against each
        function's previous compile."""
        if not self.compiled:
            return ""
        lines = ["", "compiled in this region:"]
        with _lock:
            ring = [dict(r) for r in _sig_ring]
        for rec in self.compiled:
            lines.append(f"  {rec['name']} [{rec['signature']}]")
            prev = [r for r in ring
                    if r["name"] == rec["name"] and r["seq"] < rec["seq"]]
            if prev:
                lines.append("    vs previous compile: " + signature_diff(
                    prev[-1]["signature"], rec["signature"]))
        return "\n".join(lines)

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.count = compiles_so_far() - self._start
        self.compiled = recent_compiles(self._sig_start)
        if exc_type is None and self.count > self.budget:
            what = f" [{self.label}]" if self.label else ""
            raise RetraceBudgetExceeded(
                f"retrace budget exceeded{what}: {self.count} "
                f"compilation(s) in a region pinned to {self.budget}. "
                "Likely shape or type drift is recompiling a compiled "
                "function per call (a Python scalar where a tensor was "
                "traced, a changing batch shape), or a kernel source "
                "changed under a running process. Pin the input shapes "
                "and dtypes, or raise the budget deliberately if the new "
                "compiles are intended." + self._signature_report())
        return False
