"""Counterpart of ``deeplearning4j_tpu/telemetry/trace.py``: span-based
tracing and the crash flight recorder, with the JAX package's span model
and its JSONL records, so ``tools/trace_report.py`` reads a trace of
either package unchanged.

Span model (OpenTelemetry-shaped, no dependencies):

- A **span** is ``(trace_id, span_id, parent_id, name, attrs, status)``
  plus two clocks: wall (``time.time``, comparable across processes, what
  tools/trace_report.py merges on) and monotonic (``time.perf_counter``,
  what durations are computed from).
- A **tracer** is per process. It appends every span to a JSONL sink as
  TWO records, ``{"ev": "B", ...}`` at start and ``{"ev": "E", ...}`` at
  end, so a ``kill -9`` mid-span still leaves the begin record on disk
  (the file is line-buffered). tools/trace_report.py treats an unmatched
  "B" as an *open* span.
- **Context propagation**: ``span.context()`` is a small dict
  ``{"trace_id", "span_id"}`` safe to ship over any transport; W3C
  ``traceparent`` headers format and parse it.

Flight recorder: a bounded in-memory ring of the last-N ended spans plus
the open span set. ``dump()`` writes ring + telemetry-counter snapshot +
the current CUDA device's ``torch.cuda.memory_stats`` (``[]`` on a host
without CUDA) to ``flightrec_<process>.json`` (atomic tmp+replace). Dumps
fire on unhandled exceptions (``install_crash_hooks`` chains
``sys.excepthook``), SIGTERM, explicit calls, and rate-limited
``flight_checkpoint`` calls at safe boundaries.

Unconfigured is free: every instrumentation site goes through
``maybe_span()`` / ``get_tracer()``, which are then a global read and a
no-op context manager. The tracer's lock is the ``telemetry.trace``
lockwatch seam (``utils.lockwatch.make_lock``).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import signal
import sys
import threading
import time
import uuid
from collections import deque
from typing import Dict, Iterator, List, Optional

from deeplearning4j_tpu_torch.utils.lockwatch import make_lock

SCHEMA = "dl4j-tpu-trace-v1"


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


def _new_trace_id() -> str:
    # W3C-native width (32 hex): a locally-rooted trace propagates over
    # HTTP traceparent without padding, so the SAME id string appears in
    # every process's span file and the report merges them as one tree
    return uuid.uuid4().hex


def _jsonable(v):
    if hasattr(v, "tolist"):
        v = v.tolist()
    if isinstance(v, float) and not math.isfinite(v):
        return repr(v)
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


class Span:
    """One timed operation. Not thread-safe by itself — a span is owned by
    the code path that started it; the tracer's sink/ring writes are the
    shared, locked part."""

    __slots__ = ("tracer", "name", "trace_id", "span_id", "parent_id",
                 "process", "attrs", "events", "status", "error",
                 "start_wall", "start_mono", "end_wall", "dur_ms", "_ended")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: Optional[str], attrs: Optional[Dict] = None):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.process = tracer.process
        self.attrs: Dict = dict(attrs or {})
        self.events: List[Dict] = []
        self.status = "open"
        self.error: Optional[str] = None
        self.start_wall = time.time()
        self.start_mono = time.perf_counter()
        self.end_wall: Optional[float] = None
        self.dur_ms: Optional[float] = None
        self._ended = False

    # -- enrichment --
    def set_attr(self, key: str, value) -> "Span":
        self.attrs[key] = value
        return self

    def add_event(self, name: str, **attrs) -> None:
        """A point-in-time marker inside the span (retry, reconnect,
        contribution arrival) — cheaper than a child span, still in the
        dump and the Chrome export."""
        self.events.append({"name": name, "ts": time.time(),
                            **{k: _jsonable(v) for k, v in attrs.items()}})

    def context(self) -> Dict[str, str]:
        """The wire-safe propagation context for this span."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    # -- lifecycle --
    def end(self, status: str = "ok", error: Optional[BaseException] = None
            ) -> None:
        if self._ended:
            return
        self._ended = True
        self.end_wall = time.time()
        self.dur_ms = (time.perf_counter() - self.start_mono) * 1000.0
        self.status = "error" if error is not None else status
        if error is not None:
            self.error = f"{type(error).__name__}: {error}"
        self.tracer._on_end(self)

    # -- serialization --
    def begin_record(self) -> Dict:
        return {"ev": "B", "schema": SCHEMA, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "name": self.name, "process": self.process,
                "pid": os.getpid(), "ts": self.start_wall,
                "attrs": {k: _jsonable(v) for k, v in self.attrs.items()}}

    def end_record(self) -> Dict:
        return {"ev": "E", "span_id": self.span_id, "trace_id": self.trace_id,
                "name": self.name, "process": self.process,
                "ts": self.end_wall, "dur_ms": round(self.dur_ms, 3),
                "status": self.status, "error": self.error,
                "attrs": {k: _jsonable(v) for k, v in self.attrs.items()},
                "events": self.events}

    def to_dict(self, now: Optional[float] = None) -> Dict:
        """Full snapshot (open spans report elapsed-so-far durations)."""
        d = {"trace_id": self.trace_id, "span_id": self.span_id,
             "parent_id": self.parent_id, "name": self.name,
             "process": self.process, "start": self.start_wall,
             "status": self.status,
             "attrs": {k: _jsonable(v) for k, v in self.attrs.items()},
             "events": self.events}
        if self._ended:
            d["end"] = self.end_wall
            d["dur_ms"] = round(self.dur_ms, 3)
            d["error"] = self.error
        else:
            d["dur_ms"] = round(
                ((now or time.time()) - self.start_wall) * 1000.0, 3)
            d["open"] = True
        return d


class Tracer:
    """Per-process tracer: span factory + JSONL sink + flight-recorder
    ring. ``current`` span tracking is per *thread* (a heartbeat or ckpt
    writer thread never silently parents under the training thread's
    span; cross-thread parents are passed explicitly)."""

    def __init__(self, process: str, trace_dir: Optional[str] = None,
                 path: Optional[str] = None, ring: int = 256,
                 flight_path: Optional[str] = None, registry=None,
                 min_checkpoint_interval_s: float = 1.0):
        self.process = str(process)
        safe = "".join(c if (c.isalnum() or c in "-_.") else "_"
                       for c in self.process)
        if trace_dir is not None:
            os.makedirs(trace_dir, exist_ok=True)
            path = path or os.path.join(trace_dir, f"spans_{safe}.jsonl")
            flight_path = flight_path or os.path.join(
                trace_dir, f"flightrec_{safe}.json")
        self.path = path
        self.flight_path = flight_path
        self._lock = make_lock("telemetry.trace")  # lockwatch seam
        self._fh = open(path, "a", buffering=1) if path else None
        self._ring: deque = deque(maxlen=max(1, int(ring)))
        self._open: Dict[str, Span] = {}
        self._tls = threading.local()
        if registry is None:
            from deeplearning4j_tpu_torch.telemetry.registry import (
                default_registry,
            )

            registry = default_registry()
        self.registry = registry
        # rate limit for flight_checkpoint ONLY (dump() always writes):
        # bounds the write-ahead artifact cost on fast round cadences —
        # the first checkpoint always lands (_last_dump_mono starts -inf)
        self.min_checkpoint_interval_s = float(min_checkpoint_interval_s)
        self._last_dump_mono = float("-inf")
        self._prev_excepthook = None
        self._prev_sigterm = None

    # ------------------------------------------------------------ spans ----
    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current_span(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    def current_context(self) -> Optional[Dict[str, str]]:
        sp = self.current_span()
        return sp.context() if sp is not None else None

    def start_span(self, name: str, parent=None,
                   attrs: Optional[Dict] = None) -> Span:
        """Start (and register) a span. ``parent`` may be a Span, a wire
        context dict, or None — None inherits this thread's current span;
        pass ``parent=False`` for an explicit root."""
        if parent is None:
            parent = self.current_span()
        elif parent is False:
            parent = None
        if isinstance(parent, Span):
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif isinstance(parent, dict) and parent.get("trace_id"):
            trace_id = str(parent["trace_id"])
            parent_id = parent.get("span_id")
        else:
            trace_id, parent_id = _new_trace_id(), None
        span = Span(self, name, trace_id, parent_id, attrs)
        rec = span.begin_record()
        with self._lock:
            self._open[span.span_id] = span
            self._write(rec)
        self.registry.counter("trace_spans_started_total").inc()
        return span

    def _on_end(self, span: Span) -> None:
        rec = span.end_record()
        with self._lock:
            self._open.pop(span.span_id, None)
            self._ring.append(rec)
            self._write(rec)
        self.registry.counter("trace_spans_ended_total").inc()
        if span.status == "error":
            self.registry.counter("trace_spans_error_total").inc()

    def _write(self, rec: Dict) -> None:
        if self._fh is not None:
            try:
                self._fh.write(json.dumps(rec) + "\n")
            except (OSError, ValueError):  # closed/full sink never kills
                pass                       # the traced run

    @contextlib.contextmanager
    def span(self, name: str, parent=None,
             attrs: Optional[Dict] = None) -> Iterator[Span]:
        """Context manager: starts the span, makes it this thread's
        current (so nested spans parent under it), ends it on exit — with
        ``status="error"`` and the exception recorded when one escapes."""
        sp = self.start_span(name, parent=parent, attrs=attrs)
        st = self._stack()
        st.append(sp)
        try:
            yield sp
        except BaseException as exc:
            sp.end(error=exc)
            raise
        finally:
            if st and st[-1] is sp:
                st.pop()
            else:  # defensive: mis-nested exits still unregister the span
                try:
                    st.remove(sp)
                except ValueError:
                    pass
            sp.end()

    # -------------------------------------------------- flight recorder ----
    def snapshot(self, limit: Optional[int] = None) -> Dict:
        """Open + recent spans (the /api/trace payload)."""
        now = time.time()
        with self._lock:
            recent = list(self._ring)
            open_spans = [s.to_dict(now) for s in self._open.values()]
        if limit is not None:
            recent = recent[-int(limit):]
        return {"schema": SCHEMA, "process": self.process, "ts": now,
                "open": open_spans, "recent": recent}

    def dump(self, reason: str, error: Optional[BaseException] = None,
             extra: Optional[Dict] = None) -> Optional[str]:
        """Write the flight-recorder artifact (atomic replace). Never
        raises — a dump is last-breath code; losing it must not mask the
        original failure. Routine ``checkpoint`` dumps skip the
        ``device_memory_stats`` probe (it costs ~ms per call); crash /
        SIGTERM / error dumps always carry it."""
        if self.flight_path is None:
            return None
        try:
            payload = self.snapshot()
            payload.update({
                "reason": str(reason), "pid": os.getpid(),
                "error": (f"{type(error).__name__}: {error}"
                          if error is not None else None),
                "counters": self._counters_snapshot(),
                "device_memory": (self._device_memory()
                                  if reason != "checkpoint" else None),
            })
            if extra:
                payload["extra"] = {k: _jsonable(v) for k, v in extra.items()}
            tmp = f"{self.flight_path}.tmp.{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump(payload, fh, separators=(",", ":"))
            os.replace(tmp, self.flight_path)
            self._last_dump_mono = time.perf_counter()
            self.registry.counter("trace_flight_dumps_total").inc()
            return self.flight_path
        except Exception:
            return None

    def flight_checkpoint(self, extra: Optional[Dict] = None
                          ) -> Optional[str]:
        """The write-ahead dump at a safe boundary (a round commit, a
        worker's round loop): a later kill -9 leaves THIS artifact even
        though no hook runs. Rate-limited by
        ``min_checkpoint_interval_s`` so a fast round cadence amortizes
        the artifact cost (the first call always writes; explicit
        ``dump()`` is never limited)."""
        if (time.perf_counter() - self._last_dump_mono
                < self.min_checkpoint_interval_s):
            return None
        return self.dump("checkpoint", extra=extra)

    def _counters_snapshot(self) -> Dict:
        try:
            return self.registry.snapshot()
        except Exception:
            return {}

    def _device_memory(self) -> List[Dict]:
        """The current CUDA device's allocator stats, or [] without CUDA."""
        try:
            import torch

            if not torch.cuda.is_available():
                return []
            dev = torch.cuda.current_device()
            return [{"device": f"cuda:{dev}",
                     **torch.cuda.memory_stats(dev)}]
        except Exception:  # no backend in a dying process: skip
            return []

    # ------------------------------------------------------ crash hooks ----
    def install_crash_hooks(self, sigterm: bool = True,
                            excepthook: bool = True) -> None:
        """Dump on unhandled exceptions and SIGTERM. Hooks chain to the
        previous handlers; SIGTERM installation is skipped off the main
        thread (signal module restriction) rather than failing."""
        if excepthook and self._prev_excepthook is None:
            self._prev_excepthook = sys.excepthook

            def _hook(exc_type, exc, tb):
                self.dump("unhandled_exception", error=exc)
                (self._prev_excepthook or sys.__excepthook__)(
                    exc_type, exc, tb)

            sys.excepthook = _hook
        if sigterm:
            def _on_term(signum, frame):
                self.dump("SIGTERM")
                prev = self._prev_sigterm
                if callable(prev):
                    prev(signum, frame)
                else:
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    os.kill(os.getpid(), signal.SIGTERM)

            try:
                self._prev_sigterm = signal.signal(signal.SIGTERM, _on_term)
            except ValueError:  # not the main thread
                pass

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# ------------------------------------------------- process-global tracer ----
# The OTel-style ambient tracer: instrumentation sites (the decode engine)
# read it per call, so tracing is a per-process switch, not a parameter
# threaded through every constructor.

_tracer: Optional[Tracer] = None
_tracer_lock = threading.Lock()


def get_tracer() -> Optional[Tracer]:
    return _tracer


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or clear, with None) the process tracer; returns the
    previous one so tests can restore it."""
    global _tracer
    with _tracer_lock:
        prev, _tracer = _tracer, tracer
    return prev


def configure(process: str, trace_dir: str, ring: int = 256,
              crash_hooks: bool = True, registry=None) -> Tracer:
    """Build a tracer writing under ``trace_dir``, install it as the
    process tracer, and (by default) arm the crash hooks. The one-liner
    for CLIs (``--trace-dir``) and tests."""
    tracer = Tracer(process, trace_dir=trace_dir, ring=ring,
                    registry=registry)
    if crash_hooks:
        tracer.install_crash_hooks()
    set_tracer(tracer)
    return tracer


@contextlib.contextmanager
def maybe_span(name: str, parent=None,
               attrs: Optional[Dict] = None) -> Iterator[Optional[Span]]:
    """``tracer.span(...)`` against the process tracer, or a no-op yield
    of None when tracing is off — the zero-cost seam every instrumented
    call site uses."""
    tracer = _tracer
    if tracer is None:
        yield None
        return
    with tracer.span(name, parent=parent, attrs=attrs) as sp:
        yield sp


def current_trace_context() -> Optional[Dict[str, str]]:
    """The calling thread's current span context (wire-safe dict), or
    None when tracing is off / no span is open."""
    tracer = _tracer
    return tracer.current_context() if tracer is not None else None


# ------------------------------------------------------- W3C traceparent ----
# The HTTP serving path propagates context as a ``traceparent`` header
# (https://www.w3.org/TR/trace-context/): ``00-<32 hex trace>-<16 hex
# span>-<2 hex flags>``. Internal ids are 16 hex chars (``_new_id``), so
# formatting left-pads to the W3C width and parsing keeps the full 32-char
# id as-is — trace ids are opaque strings everywhere in this tracer, so a
# caller-minted 32-char id flows through spans, sinks, and reports
# unchanged, and the one trace tree spans loadgen → HTTP → engine.

def format_traceparent(ctx: Dict[str, str]) -> str:
    """A ``traceparent`` header value for a span context dict. Ids shorter
    than the W3C widths are left-padded with zeros (parse→format is
    identity for ids already at full width)."""
    trace_id = str(ctx["trace_id"]).lower().rjust(32, "0")
    span_id = str(ctx["span_id"]).lower().rjust(16, "0")
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(header: Optional[str]) -> Optional[Dict[str, str]]:
    """Parse a ``traceparent`` header into a span-context dict, or None
    when the header is absent or malformed. Per the W3C spec a bad header
    is IGNORED (the request proceeds as a fresh root trace), never an
    error: a garbage header cannot fail a generation request."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id = parts[0], parts[1], parts[2]
    if version == "ff" or len(version) != 2:
        return None
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(version, 16), int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None  # all-zero ids are explicitly invalid in the spec
    return {"trace_id": trace_id.lower(), "span_id": span_id.lower()}
