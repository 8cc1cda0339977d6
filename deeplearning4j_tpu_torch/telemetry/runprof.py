"""Counterpart of ``deeplearning4j_tpu/telemetry/runprof.py``: the runtime
profiler. Measured step-phase timings behind the ``runprof=`` seam,
streaming utilization gauges, and on-demand profiling sessions.

**1. Step-phase timers.** Each armed step records a ring-buffered
:class:`StepTiming`. The port's phase model (an eager PyTorch step runs
its ops as the host issues them; on the card they are queued on the
current CUDA stream, and the card works WHILE the host is still inside the
call)::

    ... previous step returns
    |-- host_ms ------|            host prep: data, batching, scheduler
    |-- dispatch_ms --|            the call's host wall (every op issued)
        |-- device_ms --------|    the step's span on its stream
    |-- wall_ms ---------------|   dispatch + the fence's wait

- On CUDA, ``device_ms`` is the time between two CUDA events recorded on
  the current stream before and after the call, read after the fence (a
  stream synchronize). It is NEVER the fence's wait alone: on a host-bound
  eager step the card has done most of the work by the time the call
  returns, and the wait would understate the device time many times over
  (and put ``runprof_measured_mfu`` above 1).
- On the CPU the host is the device: the ops run inside the call, so
  ``device_ms`` is the call's wall, equal to ``dispatch_ms``, and the
  fence waits for nothing.
- ``wall_ms`` is the in-call wall: the call plus the fence's wait. The
  JAX package's ``wall_ms = dispatch_ms + device_ms`` holds where the
  device starts when the dispatch returns (JAX's async enqueue); here the
  device span overlaps the dispatch, so ``device_ms <= wall_ms``.

``comm_wait_ms`` is the step profile's implied wire time
(``collective_wire_bytes / ici_bw``, clamped to ``device_ms``): an
estimate, not a counter. ``input_wait_ms`` is hook-fed
(:meth:`RunProfiler.note_input_wait`) and is a subset of ``host_ms``.

Gauges flushed every ``update_every`` steps, labeled ``{"step": label}``:
``runprof_steps_per_s``, ``runprof_step_ms`` (mean ``wall_ms``),
``runprof_measured_mfu`` (profile FLOPs / mean device seconds / peak; left
UNBORN until a profiled step supplies FLOPs, since the ``mfu_collapse``
rule is op ``<``), ``runprof_host_fraction``,
``runprof_input_wait_fraction`` and the counter ``runprof_steps_total``
(pre-created at arm time).

**2. Sessions**: :meth:`RunProfiler.start_session` /
:meth:`RunProfiler.stop_session` (env ``DL4J_TPU_RUNPROF=<N>``) capture an
N-step timeline. Every step is written ahead as one JSONL line to a
line-buffered sidecar (a killed process leaves at most a torn tail, which
:func:`load_session` reads around); ``stop_session`` writes the final JSON
atomically (tmp + ``os.replace``) with a summary and Chrome ``X`` trace
events. The schema is JAX's (``SCHEMA``): a session written by either
package loads in the other. Each timing carries the recording thread's
trace id (``trace.current_trace_context``).

Knobs: ``DL4J_TPU_RUNPROF`` arms the default profiler for every seam left
at ``runprof=None`` (``1``/``true`` = gauges only; an integer N > 1 also
starts an N-step session at first use; ``runprof=False`` opts out);
``DL4J_TPU_RUNPROF_DIR`` is the session directory (default
``runprof_sessions`` under the working directory).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import torch

from deeplearning4j_tpu_torch._device import tree_leaves
from deeplearning4j_tpu_torch.utils.lockwatch import make_lock

ENV_RUNPROF = "DL4J_TPU_RUNPROF"
ENV_RUNPROF_DIR = "DL4J_TPU_RUNPROF_DIR"
DEFAULT_SESSION_DIR = "runprof_sessions"
SCHEMA = "dl4j-tpu-runprof-v1"

# the gauges every armed label pre-creates; runprof_measured_mfu is
# deliberately absent (the "<" rule must read "never measured" as no data)
_ARM_GAUGES = ("runprof_steps_per_s", "runprof_step_ms",
               "runprof_host_fraction", "runprof_input_wait_fraction")


@dataclasses.dataclass
class StepTiming:
    """One measured step (the module docstring's phase model). ``t_unix``
    stamps the end of the fence; ``flops`` rides along when the step
    carries a ``step_profile``, so session readers can recompute MFU."""

    label: str
    t_unix: float
    wall_ms: float          # the in-call wall: dispatch + the fence's wait
    host_ms: float          # gap since the previous step returned
    dispatch_ms: float
    device_ms: float
    comm_wait_ms: float = 0.0
    input_wait_ms: float = 0.0
    trace_id: Optional[str] = None
    flops: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        d = {"label": self.label, "t_unix": round(self.t_unix, 6),
             "wall_ms": round(self.wall_ms, 4),
             "host_ms": round(self.host_ms, 4),
             "dispatch_ms": round(self.dispatch_ms, 4),
             "device_ms": round(self.device_ms, 4),
             "comm_wait_ms": round(self.comm_wait_ms, 4),
             "input_wait_ms": round(self.input_wait_ms, 4)}
        if self.trace_id is not None:
            d["trace_id"] = self.trace_id
        if self.flops is not None:
            d["flops"] = self.flops
        return d


class _LabelState:
    """Per-label accumulator between gauge flushes (mutated under the
    profiler's lock)."""

    __slots__ = ("ring", "n", "sum_wall", "sum_host", "sum_dispatch",
                 "sum_device", "sum_input", "window_t0", "flops",
                 "pending_input_wait_s", "total")

    def __init__(self, ring: int):
        self.ring: deque = deque(maxlen=ring)
        self.n = 0
        self.sum_wall = 0.0
        self.sum_host = 0.0
        self.sum_dispatch = 0.0
        self.sum_device = 0.0
        self.sum_input = 0.0
        self.window_t0: Optional[float] = None
        self.flops: Optional[float] = None
        self.pending_input_wait_s = 0.0
        self.total = 0

    def reset_window(self, t: float) -> None:
        self.n = 0
        self.sum_wall = self.sum_host = 0.0
        self.sum_dispatch = self.sum_device = self.sum_input = 0.0
        self.window_t0 = t


class RunProfiler:
    """Per-process runtime-profile aggregator: labeled step rings,
    streaming gauges and the session recorder. Thread-safe; the hot path
    takes the lock once per step and never does I/O or waits under it."""

    def __init__(self, registry=None, ring: int = 512,
                 update_every: int = 8, session_dir: Optional[str] = None,
                 peak_flops: Optional[float] = None):
        from deeplearning4j_tpu_torch.telemetry.xprofile import \
            DEFAULT_PEAK_FLOPS

        if update_every < 1:
            raise ValueError(f"update_every must be >= 1, got "
                             f"{update_every}")
        self._registry = registry
        self.ring = int(ring)
        self.update_every = int(update_every)
        self.session_dir = session_dir
        self.peak_flops = (float(peak_flops) if peak_flops is not None
                           else DEFAULT_PEAK_FLOPS)
        self._lock = make_lock("telemetry.runprof")  # lockwatch seam
        self._labels: Dict[str, _LabelState] = {}
        # session state: swapped under the lock, written outside it
        self._session_id: Optional[str] = None
        self._session_fh = None
        self._session_path: Optional[str] = None
        self._session_steps = 0          # 0 = until stop_session
        self._session_records: List[Dict] = []
        self._session_seq = 0
        self.sessions_completed: List[str] = []

    def registry(self):
        if self._registry is None:
            from deeplearning4j_tpu_torch.telemetry.registry import \
                default_registry

            return default_registry()
        return self._registry

    # ----------------------------------------------------------- instruments ----
    def arm(self, label: str) -> None:
        """Pre-create the watched instruments for ``label`` (idempotent;
        every seam calls it at construction). ``runprof_measured_mfu``
        stays unborn."""
        reg = self.registry()
        labels = {"step": label}
        reg.counter("runprof_steps_total", labels)
        for name in _ARM_GAUGES:
            reg.gauge(name, labels)
        with self._lock:
            if label not in self._labels:
                self._labels[label] = _LabelState(self.ring)

    def note_input_wait(self, seconds: float, label: str) -> None:
        """Time a host input pipeline spent WAITING for data before the
        next ``label`` step; attributed to that step's
        ``input_wait_ms``."""
        if seconds <= 0:
            return
        with self._lock:
            state = self._labels.get(label)
            if state is None:
                state = self._labels[label] = _LabelState(self.ring)
            state.pending_input_wait_s += float(seconds)

    # -------------------------------------------------------------- recording ----
    def record(self, timing: StepTiming) -> None:
        """Ring-append one measured step, flush the gauges every
        ``update_every`` steps, and write the session line ahead (outside
        the lock: one whole line per write)."""
        line = None
        stop_after = False
        with self._lock:
            state = self._labels.get(timing.label)
            if state is None:
                state = self._labels[timing.label] = _LabelState(self.ring)
            if state.pending_input_wait_s > 0:
                timing.input_wait_ms += state.pending_input_wait_s * 1000.0
                state.pending_input_wait_s = 0.0
            state.ring.append(timing)
            state.total += 1
            if state.window_t0 is None:
                # the first record opens the window at the step's start
                state.window_t0 = timing.t_unix - (
                    timing.wall_ms + timing.host_ms) / 1000.0
            state.n += 1
            state.sum_wall += timing.wall_ms
            state.sum_host += timing.host_ms
            state.sum_dispatch += timing.dispatch_ms
            state.sum_device += timing.device_ms
            state.sum_input += timing.input_wait_ms
            if timing.flops is not None:
                state.flops = timing.flops
            flush = state.n >= self.update_every
            if flush:
                gauges = self._gauge_values(state, timing.t_unix)
                n_flushed = state.n
                state.reset_window(timing.t_unix)
            if self._session_fh is not None:
                rec = {"ev": "step", "pid": os.getpid(),
                       **timing.to_dict()}
                self._session_records.append(rec)
                line = json.dumps(rec) + "\n"
                fh = self._session_fh
                if (self._session_steps
                        and len(self._session_records)
                        >= self._session_steps):
                    stop_after = True
        if flush:
            reg = self.registry()
            labels = {"step": timing.label}
            reg.counter("runprof_steps_total", labels).inc(n_flushed)
            for name, value in gauges.items():
                reg.gauge(name, labels).set(value)
        if line is not None:
            try:
                fh.write(line)
            except ValueError:
                pass  # the session closed between the lock and the write
        if stop_after:
            self.stop_session()

    def _gauge_values(self, state: _LabelState,
                      now_unix: float) -> Dict[str, float]:
        dt = max(now_unix - (state.window_t0 or now_unix), 1e-9)
        cycle_ms = state.sum_host + state.sum_wall
        out = {
            "runprof_steps_per_s": state.n / dt,
            "runprof_step_ms": state.sum_wall / state.n,
            "runprof_host_fraction": (state.sum_host / cycle_ms
                                      if cycle_ms > 0 else 0.0),
            "runprof_input_wait_fraction": (state.sum_input / cycle_ms
                                            if cycle_ms > 0 else 0.0),
        }
        if state.flops and state.sum_device > 0:
            device_s = state.sum_device / state.n / 1000.0
            out["runprof_measured_mfu"] = (
                state.flops / max(device_s, 1e-12) / self.peak_flops)
        return out

    def timings(self, label: str) -> List[StepTiming]:
        with self._lock:
            state = self._labels.get(label)
            return list(state.ring) if state is not None else []

    def snapshot(self) -> Dict[str, Any]:
        """The session and per-label state."""
        with self._lock:
            return {
                "schema": SCHEMA,
                "session": ({"id": self._session_id,
                             "path": self._session_path,
                             "steps_captured":
                                 len(self._session_records),
                             "steps_target": self._session_steps}
                            if self._session_id is not None else None),
                "sessions_completed": list(self.sessions_completed),
                "labels": {
                    label: {"steps_total": state.total,
                            "ring": len(state.ring)}
                    for label, state in sorted(self._labels.items())},
            }

    # --------------------------------------------------------------- sessions ----
    def _resolve_dir(self, session_dir: Optional[str]) -> str:
        return (session_dir or self.session_dir
                or os.environ.get(ENV_RUNPROF_DIR) or DEFAULT_SESSION_DIR)

    def start_session(self, steps: int = 0,
                      session_dir: Optional[str] = None) -> str:
        """Open an N-step capture (``steps=0``: until ``stop_session``),
        written ahead line by line from its first step. One session at a
        time (RuntimeError otherwise)."""
        out_dir = self._resolve_dir(session_dir)
        os.makedirs(out_dir, exist_ok=True)
        with self._lock:
            if self._session_id is not None:
                raise RuntimeError(
                    f"profiling session {self._session_id} already active")
            self._session_seq += 1
            seq = self._session_seq
        sid = f"{os.getpid()}-{int(time.time() * 1000)}-{seq}"
        path = os.path.join(out_dir, f"runprof_{sid}.jsonl")
        fh = open(path, "a", buffering=1)  # opened outside the lock
        fh.write(json.dumps({
            "ev": "session_start", "schema": SCHEMA, "session": sid,
            "pid": os.getpid(), "started_unix": time.time(),
            "steps": int(steps)}) + "\n")
        with self._lock:
            if self._session_id is not None:  # lost the race
                stale = self._session_id
                fh.close()
                os.unlink(path)
                raise RuntimeError(
                    f"profiling session {stale} already active")
            self._session_id = sid
            self._session_fh = fh
            self._session_path = path
            self._session_steps = int(steps)
            self._session_records = []
        return sid

    def stop_session(self) -> Optional[str]:
        """Close the capture and write the final JSON atomically next to
        the JSONL (kept: it is the crash evidence). Returns the JSON's
        path, or None when no session is active."""
        with self._lock:
            if self._session_id is None:
                return None
            sid = self._session_id
            fh = self._session_fh
            jsonl_path = self._session_path
            records = self._session_records
            self._session_id = None
            self._session_fh = None
            self._session_path = None
            self._session_records = []
            self._session_steps = 0
        fh.close()
        final = {"schema": SCHEMA, "session": sid, "pid": os.getpid(),
                 "partial": False, "steps": records,
                 "summary": summarize_session(records,
                                              peak_flops=self.peak_flops),
                 "chrome_trace": chrome_trace_events(records)}
        json_path = jsonl_path[:-len(".jsonl")] + ".json"
        tmp = f"{json_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as out:
            json.dump(final, out)
        os.replace(tmp, json_path)
        with self._lock:
            self.sessions_completed.append(json_path)
        return json_path

    @property
    def session_active(self) -> bool:
        with self._lock:
            return self._session_id is not None


# ------------------------------------------------------------ session readers ----

def _percentile(values: List[float], q: float) -> float:
    s = sorted(values)
    return s[min(len(s) - 1, max(0, math.ceil(q / 100 * len(s)) - 1))]


def summarize_session(records: List[Dict],
                      peak_flops: Optional[float] = None) -> Dict:
    """Phase breakdown of a session's step records. MFU is recomputed
    from the per-step ``flops`` stamps, so a reconstructed partial dump
    gets the summary the live one would have."""
    if peak_flops is None:
        from deeplearning4j_tpu_torch.telemetry.xprofile import \
            DEFAULT_PEAK_FLOPS

        peak_flops = DEFAULT_PEAK_FLOPS
    steps = [r for r in records if r.get("ev", "step") == "step"]
    if not steps:
        return {"steps": 0}
    walls = [float(r.get("wall_ms", 0.0)) for r in steps]
    out: Dict[str, Any] = {
        "steps": len(steps),
        "wall_ms": {"mean": round(sum(walls) / len(walls), 4),
                    "p50": round(_percentile(walls, 50), 4),
                    "p95": round(_percentile(walls, 95), 4)},
    }
    for key in ("host_ms", "dispatch_ms", "device_ms", "comm_wait_ms",
                "input_wait_ms"):
        vals = [float(r.get(key, 0.0)) for r in steps]
        out[f"{key}_mean"] = round(sum(vals) / len(vals), 4)
    span_s = (float(steps[-1].get("t_unix", 0.0))
              - float(steps[0].get("t_unix", 0.0)))
    if span_s > 0 and len(steps) > 1:
        out["steps_per_s"] = round((len(steps) - 1) / span_s, 3)
    cycle = out["host_ms_mean"] + out["wall_ms"]["mean"]
    if cycle > 0:
        out["host_fraction"] = round(out["host_ms_mean"] / cycle, 4)
        out["input_wait_fraction"] = round(
            out["input_wait_ms_mean"] / cycle, 4)
    flops = [float(r["flops"]) for r in steps if r.get("flops")]
    if flops and out["device_ms_mean"] > 0:
        out["measured_mfu"] = (
            flops[-1] / (out["device_ms_mean"] / 1000.0) / peak_flops)
    return out


def chrome_trace_events(records: List[Dict]) -> List[Dict]:
    """Chrome ``X`` events for the phase slices of every step record, in
    epoch microseconds (the tracer's span clock), laid end to end as
    host, dispatch, device back from the step's end; ``args.trace_id``
    links them to the span trees. The port's device span overlaps its
    dispatch, so there the slices are a layout, not a timeline."""
    events: List[Dict] = []
    for i, r in enumerate(records):
        if r.get("ev", "step") != "step":
            continue
        label = r.get("label", "step")
        pid = r.get("pid", 0)
        end_us = float(r.get("t_unix", 0.0)) * 1e6
        device_us = float(r.get("device_ms", 0.0)) * 1e3
        dispatch_us = float(r.get("dispatch_ms", 0.0)) * 1e3
        host_us = float(r.get("host_ms", 0.0)) * 1e3
        args = {"step_index": i}
        if r.get("trace_id"):
            args["trace_id"] = r["trace_id"]
        for name, ts, dur in (
                ("host", end_us - device_us - dispatch_us - host_us,
                 host_us),
                ("dispatch", end_us - device_us - dispatch_us,
                 dispatch_us),
                ("device", end_us - device_us, device_us)):
            if dur <= 0:
                continue
            events.append({"name": f"{label}.{name}", "cat": "runprof",
                           "ph": "X", "pid": pid, "tid": label,
                           "ts": round(ts, 1), "dur": round(dur, 1),
                           "args": args})
    return events


def load_session(path: str) -> Dict:
    """Load a session dump: a final ``.json`` directly; a ``.jsonl``
    write-ahead (a killed session) reconstructed, torn lines skipped and
    counted. A ``.json`` path that does not exist yet falls back to its
    ``.jsonl``."""
    if path.endswith(".json"):
        if os.path.isfile(path):
            with open(path) as fh:
                out = json.load(fh)
            out.setdefault("partial", False)
            return out
        path = path[:-len(".json")] + ".jsonl"
    sid = None
    records: List[Dict] = []
    torn = 0
    with open(path) as fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except ValueError:
                torn += 1  # killed mid-write: count, keep going
                continue
            if rec.get("ev") == "session_start":
                sid = rec.get("session")
            elif rec.get("ev") == "step":
                records.append(rec)
    return {"schema": SCHEMA, "session": sid, "partial": True,
            "torn_lines": torn, "steps": records,
            "summary": summarize_session(records),
            "chrome_trace": chrome_trace_events(records)}


def find_sessions(session_dir: str) -> List[Dict]:
    """Every session under ``session_dir``, final dumps preferred, killed
    sessions reconstructed from their write-ahead sidecars."""
    out = []
    if not os.path.isdir(session_dir):
        return out
    names = sorted(os.listdir(session_dir))
    finals = {n[:-len(".json")] for n in names if n.endswith(".json")}
    for name in names:
        if name.endswith(".json"):
            base = name[:-len(".json")]
        elif name.endswith(".jsonl") and name[:-len(".jsonl")] not in finals:
            base = name[:-len(".jsonl")]
        else:
            continue
        if not base.startswith("runprof_"):
            continue
        try:
            out.append(load_session(os.path.join(session_dir, name)))
        except (OSError, ValueError):
            continue
    return out


# ---------------------------------------------------------------- runprof= seam ----

def _cuda_device(tree) -> Optional[torch.device]:
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            return x.device if x.is_cuda else None
    return None


class RunProfiledStep:
    """The ``runprof=`` seam: phase-timed calls of a step (the module
    docstring's phase model). Unless the step already carries a
    ``step_profile`` it is composed over a ``ProfiledStep``, so the first
    call's profile (FLOPs, collectives) feeds ``runprof_measured_mfu`` and
    ``comm_wait_ms``.

    On CUDA each call records an event on the current stream before and
    after the step and synchronizes on the second (the fence that makes
    the measurement): that serializes host and card when armed, which is
    why the default (``runprof=None`` without the env knob) returns the
    step untouched."""

    def __init__(self, fn, label: str = "step",
                 profiler: Optional[RunProfiler] = None):
        from deeplearning4j_tpu_torch.telemetry.xprofile import ProfiledStep

        if not hasattr(fn, "step_profile"):
            fn = ProfiledStep(fn, label=label)
        self._fn = fn
        self.label = label
        self.profiler = (profiler if profiler is not None
                         else default_runprof())
        self._last_end: Optional[float] = None
        self.profiler.arm(label)

    @property
    def step_profile(self):
        return getattr(self._fn, "step_profile", None)

    def __call__(self, *args):
        from deeplearning4j_tpu_torch.telemetry import trace as _trace
        from deeplearning4j_tpu_torch.telemetry.xprofile import \
            DEFAULT_ICI_BYTES_PER_SEC

        dev = _cuda_device(args)
        t0 = time.perf_counter()
        host_ms = ((t0 - self._last_end) * 1000.0
                   if self._last_end is not None else 0.0)
        if dev is not None:
            stream = torch.cuda.current_stream(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        out = self._fn(*args)
        t_disp = time.perf_counter()
        if dev is not None:
            end.record(stream)
            end.synchronize()  # the fence
        t_end = time.perf_counter()
        dispatch_ms = (t_disp - t0) * 1000.0
        wall_ms = (t_end - t0) * 1000.0
        device_ms = (start.elapsed_time(end) if dev is not None
                     else dispatch_ms)
        prof = self.step_profile
        comm_wait_ms = 0.0
        flops = None
        if prof is not None:
            flops = prof.flops
            wire = prof.collective_wire_bytes or 0.0
            if wire:
                comm_wait_ms = min(
                    device_ms, wire / DEFAULT_ICI_BYTES_PER_SEC * 1000.0)
        ctx = _trace.current_trace_context()
        self.profiler.record(StepTiming(
            label=self.label, t_unix=time.time(), wall_ms=wall_ms,
            host_ms=host_ms, dispatch_ms=dispatch_ms, device_ms=device_ms,
            comm_wait_ms=comm_wait_ms,
            trace_id=ctx["trace_id"] if ctx else None, flops=flops))
        self._last_end = time.perf_counter()
        return out


# ------------------------------------------------------------- process default ----

_default_profiler: Optional[RunProfiler] = None
_default_profiler_lock = threading.Lock()


def default_runprof() -> RunProfiler:
    """The process-wide profiler, the one the env knob reaches. Starts
    the env knob's auto-session (``DL4J_TPU_RUNPROF=<N>``, N > 1) at
    creation."""
    global _default_profiler
    with _default_profiler_lock:
        if _default_profiler is None:
            _default_profiler = RunProfiler()
            n = _env_auto_session_steps()
            if n:
                try:
                    _default_profiler.start_session(steps=n)
                except OSError:
                    pass  # an unwritable dump dir must not stop training
        return _default_profiler


def get_runprof() -> Optional[RunProfiler]:
    """The default profiler if one exists (None before first use)."""
    return _default_profiler


def set_runprof(profiler: Optional[RunProfiler]) -> None:
    """Swap the process default (tests; None resets)."""
    global _default_profiler
    with _default_profiler_lock:
        _default_profiler = profiler


def _env_value() -> Optional[str]:
    val = os.environ.get(ENV_RUNPROF, "").strip()
    if not val or val.lower() in ("0", "false", "off", "no"):
        return None
    return val


def _env_auto_session_steps() -> int:
    val = _env_value()
    if val is None:
        return 0
    try:
        n = int(val)
    except ValueError:
        return 0
    return n if n > 1 else 0


def resolve_runprof(runprof) -> Optional[RunProfiler]:
    """A seam argument as a profiler or None: ``None`` consults the env
    knob; any other falsy value opts out; ``True`` or a string use the
    process default; a :class:`RunProfiler` is used as it is."""
    if runprof is None:
        return default_runprof() if _env_value() is not None else None
    if not runprof:
        return None
    if isinstance(runprof, RunProfiler):
        return runprof
    return default_runprof()


def maybe_runprof(fn, runprof, label: str):
    """Wrap ``fn`` in a :class:`RunProfiledStep` when the seam resolves
    armed (a string overrides the label), else return ``fn``
    unchanged."""
    profiler = resolve_runprof(runprof)
    if profiler is None:
        return fn
    return RunProfiledStep(
        fn, label=runprof if isinstance(runprof, str) else label,
        profiler=profiler)
