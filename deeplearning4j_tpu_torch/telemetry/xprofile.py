"""Counterpart of ``deeplearning4j_tpu/telemetry/xprofile.py``: the step
profile (FLOPs, bytes, memory, collectives) and its attribution against a
measured step time.

The JAX package reads what XLA compiled (``cost_analysis()``,
``memory_analysis()``, the HLO's collectives) and runs nothing. An eager
PyTorch step has no compiled program, so the port counts the ops of one
REAL call of the step, the call that trains:

- ``profile_compiled(step, *args)`` runs ``step`` once under a capture (a
  ``TorchDispatchMode``) and returns its outputs' profile as a
  :class:`StepProfile`. ``flops`` counts the matrix products and
  convolutions of every op outside the kernel wrappers (the formulas of
  ``torch.utils.flop_counter``) plus each wrapper's analytic cost
  (``ops._kernels.*_cost``); ``transcendentals`` the exp/log/tanh/sigmoid
  family's elements plus the wrappers'; ``bytes_accessed`` the bytes each
  op outside a wrapper reads and writes (in eager mode every op goes to
  memory; views move none) plus the wrappers'. A wrapper reports its cost
  on both routes (its CUDA kernel, which the dispatcher never sees, or its
  plain version on the CPU, whose ops are not counted), so one step counts
  the same FLOPs on the card and on the CPU.
- Memory: ``argument_bytes``/``output_bytes`` from the tensors;
  ``alias_bytes``/``donated_args`` from outputs that share storage with
  an input (``donate=True``); ``temp_bytes`` and ``peak_bytes`` from the
  CUDA allocator's peak over the call, above what was allocated before it
  (``None`` on the CPU, as ``generated_code_bytes`` always is).
  ``compile_seconds`` is ``None``: an eager step compiles nothing.
- Collectives: every call of ``parallel.mesh``'s collectives during the
  capture, under JAX's HLO kind names (``COLLECTIVE_KINDS``), with its
  payload, group size and the wire-byte estimate below.
- ``ProfiledStep`` is the ``profile=`` seam: the first call is the
  profiled call and its outputs are returned; later calls pass through.
- ``ProfileStore``, ``attribute``, ``MemoryWatermarkSampler``: as in JAX,
  with the card's figures as defaults.

Wire-byte convention (JAX's, per device): for an op whose result buffer is
B bytes over a group of g ranks,

    all-reduce          2·(g−1)/g · B     (ring reduce-scatter+all-gather)
    all-gather          (g−1)/g · B       (B is the gathered result)
    reduce-scatter      (g−1) · B         (B is the 1/g scattered result)
    all-to-all          (g−1)/g · B       (1/g of the buffer stays local)
    collective-permute  B                 (one neighbor hop)
    broadcast           (g−1)/g · B       (the port's; JAX has none)

A group of one carries none. These are analytic estimates, not
measurements.

FLOPs convention: XLA counts a scanned body once; the port runs its layer
stack as a Python loop and counts every layer, so a 2-layer LM counts
about twice a 1-layer one, where XLA counts about the same
(tests/test_torch_xprofile.py pins both).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import flop_registry

from deeplearning4j_tpu_torch import _capture
from deeplearning4j_tpu_torch.utils.lockwatch import make_lock

log = logging.getLogger(__name__)

__all__ = [
    "CollectiveOp",
    "MemoryWatermarkSampler",
    "ProfileStore",
    "ProfiledStep",
    "StepProfile",
    "attribute",
    "default_profile_store",
    "maybe_profiled",
    "profile_compiled",
    "profile_lowered",
    "summarize_collectives",
]

# the card's figures for the attribution (H100 80GB HBM3, 700 W; NVIDIA's
# data sheet, dense). Callers on other parts pass their own peaks.
DEFAULT_PEAK_FLOPS = 989e12        # H100 80GB HBM3, 700 W: bf16 tensor cores
DEFAULT_HBM_BYTES_PER_SEC = 3.35e12  # H100 80GB HBM3, 700 W: HBM3
DEFAULT_ICI_BYTES_PER_SEC = 450e9  # H100 80GB HBM3, 700 W: NVLink, one way
# the other rates a kernel's bound takes: f32 on the CUDA cores and TF32
# on the tensor cores (H100 80GB HBM3, 700 W)
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12

# the port's collective kinds (parallel.mesh.COLLECTIVES) under JAX's HLO
# names
COLLECTIVE_KINDS = {"all_reduce": "all-reduce",
                    "all_gather": "all-gather",
                    "all_to_all": "all-to-all",
                    "send_recv": "collective-permute",
                    "broadcast": "broadcast"}


def _wire_bytes(kind: str, payload: int, group: int) -> float:
    """Per-device analytic wire bytes (the module docstring's table)."""
    if group <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (group - 1) / group * payload
    if kind in ("all-gather", "all-to-all", "broadcast"):
        return (group - 1) / group * payload
    if kind == "reduce-scatter":
        return float((group - 1) * payload)
    if kind == "collective-permute":
        return float(payload)
    return 0.0


@dataclass
class CollectiveOp:
    """One collective the step made."""

    kind: str
    payload_bytes: int
    group_size: int
    n_groups: int
    wire_bytes: float

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "payload_bytes": self.payload_bytes,
                "group_size": self.group_size, "n_groups": self.n_groups,
                "wire_bytes": round(self.wire_bytes, 1)}


def summarize_collectives(ops: List[CollectiveOp]) -> Dict[str, Dict]:
    """Per-kind aggregation: count, total payload/wire bytes, group sizes."""
    out: Dict[str, Dict] = {}
    for op in ops:
        agg = out.setdefault(op.kind, {
            "count": 0, "payload_bytes": 0, "wire_bytes": 0.0,
            "group_sizes": []})
        agg["count"] += 1
        agg["payload_bytes"] += op.payload_bytes
        agg["wire_bytes"] += op.wire_bytes
        if op.group_size not in agg["group_sizes"]:
            agg["group_sizes"].append(op.group_size)
    for agg in out.values():
        agg["wire_bytes"] = round(agg["wire_bytes"], 1)
        agg["group_sizes"].sort()
    return out


@dataclass
class StepProfile:
    """What one call of a step did, captured on that call.

    Fields the device does not report are ``None``, explicitly, never
    silently zero: the memory fields on the CPU, ``generated_code_bytes``
    and ``compile_seconds`` always. ``collectives`` is the per-kind
    summary; ``collective_ops`` keeps the per-op records (the first
    ``_MAX_OPS_KEPT``; counts and totals stay exact). ``kernels`` (the
    port's) holds each kernel wrapper's launches and analytic cost within
    the call."""

    label: str
    platform: str
    flops: Optional[float] = None
    transcendentals: Optional[float] = None
    bytes_accessed: Optional[float] = None
    argument_bytes: Optional[int] = None
    output_bytes: Optional[int] = None
    temp_bytes: Optional[int] = None
    alias_bytes: Optional[int] = None
    generated_code_bytes: Optional[int] = None
    peak_bytes: Optional[int] = None
    compile_seconds: Optional[float] = None
    donated_args: int = 0
    collectives: Dict[str, Dict] = field(default_factory=dict)
    collective_ops: List[Dict] = field(default_factory=list)
    collective_wire_bytes: float = 0.0
    recorded_at: Optional[float] = None
    kernels: Dict[str, Dict] = field(default_factory=dict)

    _MAX_OPS_KEPT = 32

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "StepProfile":
        known = {f for f in cls.__dataclass_fields__}  # type: ignore[attr-defined]
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_json(self) -> str:
        return json.dumps(self.to_dict())


# ------------------------------------------------------------- the capture ----

_aten = torch.ops.aten
# ops whose every output element is a transcendental (XLA's count)
_TRANSCENDENTAL = {getattr(_aten, n) for n in (
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh",
    "sigmoid", "sin", "cos", "tan", "erf", "erfc", "erfinv", "rsqrt",
    "sqrt", "pow", "_softmax", "_log_softmax", "logsumexp", "gelu", "silu",
    "atan", "asin", "acos", "sinh", "cosh", "asinh", "acosh", "atanh",
    "reciprocal") if hasattr(_aten, n)}
# ops that allocate or alias and move no data
_NO_TRAFFIC = {getattr(_aten, n) for n in (
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "detach", "alias", "lift_fresh",
    "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "is_same_size") if hasattr(_aten, n)}


def _is_view(func) -> bool:
    view = getattr(func, "is_view", None)
    if view is not None:
        return bool(view)
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in _pytree_leaves(tree) if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _StepCapture(TorchDispatchMode):
    """Counts the ops of one call (outside the kernel wrappers, which
    report their own cost through ``_capture.priced``) and collects the
    mesh's collectives."""

    def __init__(self):
        super().__init__()
        self.args = self.outputs = self.device = None
        self.peak_above = self.kept = None  # the allocator's, on the card
        self.flops = 0.0
        self.transcendentals = 0.0
        self.bytes = 0.0
        self.kernels: Dict[str, Dict] = {}
        self.ops: List[CollectiveOp] = []
        self.depth = 0
        self._lock = threading.Lock()

    # -- the hooks of deeplearning4j_tpu_torch._capture --
    def on_this_thread(self) -> bool:
        return self in _get_current_dispatch_mode_stack()

    def add_kernel(self, name: str, cost) -> None:
        with self._lock:
            k = self.kernels.setdefault(name, {
                "launches": 0, "flops": 0.0, "transcendentals": 0.0,
                "bytes": 0.0})
            k["launches"] += 1
            k["flops"] += cost.flops
            k["transcendentals"] += cost.transcendentals
            k["bytes"] += cost.bytes
            self.flops += cost.flops
            self.transcendentals += cost.transcendentals
            self.bytes += cost.bytes

    def add_collective(self, kind: str, payload: int, group: int) -> None:
        name = COLLECTIVE_KINDS.get(kind, kind)
        with self._lock:
            self.ops.append(CollectiveOp(
                kind=name, payload_bytes=payload, group_size=group,
                n_groups=1, wire_bytes=_wire_bytes(name, payload, group)))

    # -- the op counter --
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if not self.depth and packet not in flop_registry \
                and _decomposes(func):
            # a composite op reaches the mode whole under inference_mode
            # (aten.matmul in the serving steps): count its parts, as
            # autograd's dispatch hands them over in a training step
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self.depth:
            return out
        flops = 0.0
        formula = flop_registry.get(packet)
        if formula is not None:
            flops = float(formula(*args, **kwargs, out_val=out))
        trans = 0.0
        if packet in _TRANSCENDENTAL:
            trans = float(sum(t.numel() for t in _tensors(out)))
        nbytes = 0
        if packet not in _NO_TRAFFIC and not _is_view(func):
            nbytes = (sum(_nbytes(t) for t in _tensors((args, kwargs)))
                      + sum(_nbytes(t) for t in _tensors(out)))
        if flops or trans or nbytes:
            with self._lock:
                self.flops += flops
                self.transcendentals += trans
                self.bytes += nbytes
        return out


_COMPOSITE: Dict[Any, bool] = {}


def _decomposes(func) -> bool:
    """Whether ``func`` has a CompositeImplicitAutograd kernel (it is
    written in other aten ops), cached per op."""
    got = _COMPOSITE.get(func)
    if got is None:
        got = _COMPOSITE[func] = torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
    return got


def _storages(tree) -> Dict[int, int]:
    """{storage address: bytes} of the tensors in ``tree``, each storage
    once."""
    out: Dict[int, int] = {}
    for t in _tensors(tree):
        out.setdefault(t.untyped_storage().data_ptr(), _nbytes(t))
    return out


def _device_of(tree) -> Optional[torch.device]:
    for t in _tensors(tree):
        return t.device
    return None


def _capture_call(fn, args, kwargs) -> _StepCapture:
    """Run ``fn(*args, **kwargs)`` once under a capture, which keeps the
    call's outputs and what the allocator saw. One capture at a time in a
    process."""
    if _capture._active is not None:
        raise RuntimeError("a step profile is already being captured in "
                           "this process")
    cap = _StepCapture()
    cap.args = (args, kwargs)
    cap.device = _device_of(cap.args)
    cuda = cap.device is not None and cap.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(cap.device)
        base = torch.cuda.memory_allocated(cap.device)
        torch.cuda.reset_peak_memory_stats(cap.device)
    _capture.set_active(cap)
    try:
        with cap:
            cap.outputs = fn(*args, **kwargs)
    finally:
        _capture.set_active(None)
    if cuda:
        torch.cuda.synchronize(cap.device)
        cap.peak_above = torch.cuda.max_memory_allocated(cap.device) - base
        cap.kept = torch.cuda.memory_allocated(cap.device) - base
    return cap


def profile_lowered(capture, label: str = "step") -> StepProfile:
    """The :class:`StepProfile` of a finished capture (JAX's name: there it
    profiles a lowered program; an eager step has none, so the port
    profiles the call a capture recorded). Memory: the arguments' and
    outputs' storages, each once; outputs sharing an argument's storage
    are aliased (donated); on the card ``temp_bytes`` is the allocator's
    peak rise over the call less what the call kept, and ``peak_bytes``
    the arguments plus that rise."""
    arg_storages = _storages(capture.args)
    out_storages = _storages(capture.outputs)
    aliased = {p: n for p, n in out_storages.items() if p in arg_storages}
    donated = sum(1 for t in _tensors(capture.args)
                  if t.untyped_storage().data_ptr() in aliased)
    temp = peak = None
    if capture.peak_above is not None:
        temp = max(0, int(capture.peak_above - capture.kept))
        peak = int(sum(arg_storages.values()) + capture.peak_above)
    ops = capture.ops
    dev = capture.device
    return StepProfile(
        label=label,
        platform=dev.type if dev is not None else "cpu",
        flops=capture.flops,
        transcendentals=capture.transcendentals,
        bytes_accessed=capture.bytes,
        argument_bytes=int(sum(arg_storages.values())),
        output_bytes=int(sum(out_storages.values())),
        temp_bytes=temp,
        alias_bytes=int(sum(aliased.values())),
        peak_bytes=peak,
        compile_seconds=None,
        donated_args=donated,
        collectives=summarize_collectives(ops),
        collective_ops=[op.to_dict()
                        for op in ops[:StepProfile._MAX_OPS_KEPT]],
        collective_wire_bytes=round(sum(op.wire_bytes for op in ops), 1),
        recorded_at=time.time(),
        kernels=capture.kernels,
    )


def profile_compiled(fn, *args, label: str = "step",
                     store: Optional["ProfileStore"] = None,
                     keep_outputs: bool = False, **kwargs):
    """Run ``fn(*args, **kwargs)`` ONCE under the capture and profile that
    call: the one-stop API the seams and tests use. Returns the
    :class:`StepProfile`, or ``(outputs, profile)`` with ``keep_outputs``
    (the ``profile=`` seam returns the outputs of the same call). The call
    really runs: its side effects (a donated step's in-place update)
    happen."""
    cap = _capture_call(fn, args, kwargs)
    prof = profile_lowered(cap, label=label)
    if store is not None:
        store.record(prof)
    return (cap.outputs, prof) if keep_outputs else prof


# ------------------------------------------------------------- attribution ----

def attribute(profile: StepProfile, step_seconds: float,
              peak_flops: float = DEFAULT_PEAK_FLOPS,
              hbm_bytes_per_sec: float = DEFAULT_HBM_BYTES_PER_SEC,
              ici_bytes_per_sec: float = DEFAULT_ICI_BYTES_PER_SEC,
              ) -> Dict[str, Any]:
    """Fuse a profile with a MEASURED step time: measured MFU, HBM
    utilization, the roofline position (arithmetic intensity against the
    ridge ``peak_flops / hbm_bw``), the comm fraction the collective wire
    bytes imply at ``ici_bytes_per_sec``, and the resource whose implied
    time is largest (``bound``). The implied times are lower bounds."""
    step_seconds = max(float(step_seconds), 1e-12)
    flops = profile.flops or 0.0
    bytes_accessed = profile.bytes_accessed or 0.0
    wire = profile.collective_wire_bytes or 0.0
    t_compute = flops / peak_flops
    t_memory = bytes_accessed / hbm_bytes_per_sec
    t_comm = wire / ici_bytes_per_sec
    implied = {"compute": t_compute, "memory": t_memory, "comm": t_comm}
    bound = max(implied, key=lambda k: implied[k]) if any(
        v > 0 for v in implied.values()) else "unknown"
    ai = (flops / bytes_accessed) if bytes_accessed else None
    ridge = peak_flops / hbm_bytes_per_sec
    return {
        "step_seconds": step_seconds,
        "measured_mfu": flops / step_seconds / peak_flops,
        "hbm_utilization": bytes_accessed / step_seconds / hbm_bytes_per_sec,
        "comm_fraction": t_comm / step_seconds,
        "arithmetic_intensity": ai,
        "ridge_intensity": ridge,
        "bound": bound,
        "implied_seconds": implied,
        "model": {"peak_flops": peak_flops,
                  "hbm_bytes_per_sec": hbm_bytes_per_sec,
                  "ici_bytes_per_sec": ici_bytes_per_sec},
    }


# ------------------------------------------------------------ profile store ----

class ProfileStore:
    """Last StepProfile per label + registry mirror: ``profile_flops`` /
    ``profile_peak_bytes`` / ``profile_collective_wire_bytes`` /
    ``profile_compile_seconds`` (only when not None) gauges labeled
    ``{"step": label}``. Thread-safe."""

    def __init__(self, registry=None):
        self._lock = make_lock("profile.store")  # lockwatch seam
        self._profiles: Dict[str, Dict] = {}
        self._registry = registry

    def _mirror(self, prof: StepProfile) -> None:
        reg = self._registry
        if reg is None:
            from deeplearning4j_tpu_torch.telemetry.registry import \
                default_registry

            reg = default_registry()
        labels = {"step": prof.label}
        if prof.flops is not None:
            reg.gauge("profile_flops", labels).set(prof.flops)
        if prof.peak_bytes is not None:
            reg.gauge("profile_peak_bytes", labels).set(prof.peak_bytes)
        if prof.compile_seconds is not None:
            reg.gauge("profile_compile_seconds",
                      labels).set(prof.compile_seconds)
        reg.gauge("profile_collective_wire_bytes",
                  labels).set(prof.collective_wire_bytes)

    def record(self, prof: StepProfile) -> None:
        with self._lock:
            self._profiles[prof.label] = prof.to_dict()
        self._mirror(prof)

    def get(self, label: str) -> Optional[Dict]:
        with self._lock:
            return self._profiles.get(label)

    def snapshot(self) -> List[Dict]:
        with self._lock:
            return [self._profiles[k] for k in sorted(self._profiles)]


_default_store: Optional[ProfileStore] = None
_default_store_lock = threading.Lock()


def default_profile_store() -> ProfileStore:
    global _default_store
    with _default_store_lock:
        if _default_store is None:
            _default_store = ProfileStore()
        return _default_store


# ------------------------------------------------------------ profile= seam ----

def _signature(args) -> tuple:
    """The input signature a profile holds for: each tensor's (or
    array's) shape, dtype and device, and every other leaf's type."""
    return tuple((tuple(x.shape), x.dtype, x.device)
                 if isinstance(x, torch.Tensor) else
                 (tuple(x.shape), str(x.dtype)) if hasattr(x, "dtype")
                 and hasattr(x, "shape") else type(x)
                 for x in _pytree_leaves(args))


class ProfiledStep:
    """The ``profile=`` seam: the FIRST call runs under the capture, its
    :class:`StepProfile` lands on ``self.step_profile`` (and in the store),
    and its outputs are returned: profiling costs no extra execution.
    Later calls pass straight through. A later call with another input
    signature keeps the first profile and counts ``signature_fallbacks``,
    as JAX's falls back to the jit cache."""

    def __init__(self, fn, label: str = "step",
                 store: Optional[ProfileStore] = None):
        self._fn = fn
        self.label = label
        self._store = store if store is not None else default_profile_store()
        self._signature = None
        self.step_profile: Optional[StepProfile] = None
        self.signature_fallbacks = 0

    def __call__(self, *args):
        if self.step_profile is None:
            self._signature = _signature(args)
            out, prof = profile_compiled(self._fn, *args, label=self.label,
                                         store=self._store,
                                         keep_outputs=True)
            self.step_profile = prof
            return out
        if _signature(args) != self._signature:
            self.signature_fallbacks += 1
        return self._fn(*args)


def maybe_profiled(fn, profile, label: str):
    """Wrap ``fn`` in a :class:`ProfiledStep` when ``profile`` is truthy
    (a string overrides the label), else return ``fn`` unchanged."""
    if not profile:
        return fn
    return ProfiledStep(fn, label=profile if isinstance(profile, str)
                        else label)


# ------------------------------------------------------- memory watermarks ----

class MemoryWatermarkSampler:
    """Background device-memory watermark sampler: samples
    ``utils.profiling.device_memory_stats`` every ``interval_s`` on a
    daemon thread into ``profile_memory_bytes_in_use``,
    ``profile_memory_peak_bytes`` (the allocator's own peak) and
    ``profile_memory_watermark_bytes`` (the most in use THIS sampler saw)
    per device, and counts ticks in ``profile_memory_samples_total``. On
    the CPU the stats are empty and so are the watermarks, never an
    error."""

    def __init__(self, registry=None, interval_s: float = 0.5):
        self.interval_s = float(interval_s)
        if registry is None:
            from deeplearning4j_tpu_torch.telemetry.registry import \
                default_registry

            registry = default_registry()
        self._registry = registry
        self._lock = make_lock("profile.memwatch")  # lockwatch seam
        self._watermarks: Dict[str, int] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.samples = 0

    def sample_once(self) -> List[Dict]:
        """One sampling pass; returns the raw per-device stats list."""
        from deeplearning4j_tpu_torch.utils.profiling import \
            device_memory_stats

        stats = device_memory_stats()
        with self._lock:
            self.samples += 1
            for entry in stats:
                dev = entry.get("device", "?")
                in_use = entry.get("bytes_in_use")
                if in_use is None:
                    continue
                labels = {"device": dev}
                self._registry.gauge("profile_memory_bytes_in_use",
                                     labels).set(in_use)
                peak = entry.get("peak_bytes_in_use")
                if peak is not None:
                    self._registry.gauge("profile_memory_peak_bytes",
                                         labels).set(peak)
                wm = max(self._watermarks.get(dev, 0), int(in_use))
                self._watermarks[dev] = wm
                self._registry.gauge("profile_memory_watermark_bytes",
                                     labels).set(wm)
        self._registry.counter("profile_memory_samples_total").inc()
        return stats

    def watermarks(self) -> Dict[str, int]:
        """device → max bytes_in_use observed (empty on the CPU)."""
        with self._lock:
            return dict(self._watermarks)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception as exc:
                # a flaky stat must never kill the sampler thread; the
                # samples counter shows the stall
                log.debug("memory watermark sample failed: %r", exc)

    def start(self) -> "MemoryWatermarkSampler":
        if self._thread is None:
            self._stop.clear()
            self.sample_once()  # immediate first sample, not interval-late
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> Dict[str, int]:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=10)
            self._thread = None
            self.sample_once()  # closing sample catches the final state
        return self.watermarks()

    def __enter__(self) -> "MemoryWatermarkSampler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
