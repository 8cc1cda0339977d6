"""Counterpart of ``deeplearning4j_tpu/utils/netwatch.py``, copied (no
framework in it): the runtime socket/RPC watchdog.

What a static review of socket hygiene cannot see is the RUN: the timeout
value that only exists at runtime, the peer that answers the connect and
then goes silent, the retry storm assembled across modules. This module
wraps sockets behind a seam so, when armed, every watched transport feeds
one process-wide record:

- an **enforced default timeout**: a watched socket whose owner never
  called ``settimeout`` gets the process default
  (``DL4J_TPU_NETWATCH_TIMEOUT_S``); under the watch there is no such
  thing as an unbounded blocking call;
- **per-endpoint telemetry** through the port's registry:
  ``netwatch_timeouts_total`` / ``netwatch_reconnects_total`` /
  ``netwatch_retries_total`` counters labeled ``{endpoint=...}``
  (reconnects/retries are client-policy events the owner reports via
  :func:`record_reconnect`/:func:`record_retry`; no-ops unarmed);
- a **blocked-too-long watchdog**: a watched ``recv``/``accept`` stuck
  past ``watchdog_s`` dumps every thread's stack through the port's
  flight recorder (``telemetry/trace.py``, ``reason=netwatch_stall``;
  stderr log fallback), then keeps waiting out its timeout: hung RPCs
  become stack traces.

The seam (``make_socket``/``wrap_socket``) is zero-cost when unarmed: it
hands back plain ``socket.socket`` objects, byte for byte. Arming is
``enable()`` (tests) or env ``DL4J_TPU_NETWATCH=1`` at socket-creation
time. Endpoints are labeled by ROLE, not address: every tracker client
socket is one ``tracker.client`` node, the granularity a fleet report
wants.

Knobs (all host-side, read at enable/creation time):

- ``DL4J_TPU_NETWATCH``: create watched sockets (``1``/``true``).
- ``DL4J_TPU_NETWATCH_TIMEOUT_S``: enforced default timeout for watched
  sockets whose owner set none (default 30).
- ``DL4J_TPU_NETWATCH_WATCHDOG_S``: blocked-too-long stall threshold
  (default 10).
"""

from __future__ import annotations

import logging
import os
import socket as _socket
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional

log = logging.getLogger(__name__)

__all__ = [
    "enable", "disable", "enabled", "reset", "make_socket", "wrap_socket",
    "record_reconnect", "record_retry", "summary", "metrics_record",
    "WatchedSocket",
]

_ENV_ON = "DL4J_TPU_NETWATCH"
_ENV_TIMEOUT = "DL4J_TPU_NETWATCH_TIMEOUT_S"
_ENV_WATCHDOG = "DL4J_TPU_NETWATCH_WATCHDOG_S"

# ops safe to re-issue after a chunked wait timed out without data: no
# bytes have moved, so the watchdog can probe in watchdog_s slices and
# dump mid-stall. connect/sendall are single-shot — re-calling them
# after a partial attempt has undefined state.
_CHUNKABLE = frozenset({"recv", "recv_into", "accept"})


class _State:
    """Process-wide watch state. ``active`` gates instrumentation so
    sockets wrapped while armed go quiet after ``disable()``."""

    def __init__(self) -> None:
        self.active = False
        self.default_timeout_s = 30.0
        self.watchdog_s = 10.0
        self.registry = None  # None = default_registry() at record time
        self.mu = threading.Lock()  # guards stats
        self.stats: Dict[str, Dict[str, float]] = {}
        self.stall_dumps = 0


_state = _State()
_tls = threading.local()


def _truthy(val: Optional[str]) -> bool:
    return (val or "").strip().lower() in ("1", "true", "yes", "on")


def enabled() -> bool:
    return _state.active


def enable(default_timeout_s: Optional[float] = None,
           watchdog_s: Optional[float] = None, registry=None) -> None:
    """Arm the watch for sockets created/wrapped from now on (and re-arm
    existing watched sockets)."""
    _state.active = True
    if default_timeout_s is None:
        default_timeout_s = float(os.environ.get(_ENV_TIMEOUT, "30"))
    _state.default_timeout_s = max(0.05, float(default_timeout_s))
    if watchdog_s is None:
        watchdog_s = float(os.environ.get(_ENV_WATCHDOG, "10"))
    _state.watchdog_s = max(0.05, float(watchdog_s))
    _state.registry = registry


def disable() -> None:
    """Quiesce every watched socket (they fall through to the plain
    inner socket) and keep the recorded stats for inspection."""
    _state.active = False


def reset() -> None:
    """Drop the recorded stats (test isolation)."""
    with _state.mu:
        _state.stats.clear()
        _state.stall_dumps = 0


def _armed_for_creation() -> bool:
    """Watched sockets are handed out while armed — and arming via the
    env var (a worker process launched with DL4J_TPU_NETWATCH=1) flips
    the full watch on at first socket creation."""
    if _state.active:
        return True
    if _truthy(os.environ.get(_ENV_ON)):
        enable()
        return True
    return False


# --------------------------------------------------------------- recording ----

def _stat(endpoint: str) -> Dict[str, float]:
    s = _state.stats.get(endpoint)
    if s is None:
        s = _state.stats[endpoint] = {
            "ops": 0.0, "timeouts": 0.0, "reconnects": 0.0,
            "retries": 0.0, "stalls": 0.0, "wait_ms_max": 0.0,
        }
    return s


def _registry():
    if _state.registry is not None:
        return _state.registry
    from deeplearning4j_tpu_torch.telemetry.registry import (
        default_registry,
    )

    return default_registry()


def _count(endpoint: str, what: str, metric: Optional[str] = None) -> None:
    with _state.mu:
        _stat(endpoint)[what] += 1
    if metric is None:
        return
    if getattr(_tls, "busy", False):
        return  # re-entrant metric emission
    _tls.busy = True
    try:
        _registry().counter(metric, {"endpoint": endpoint}).inc()
    finally:
        _tls.busy = False


def record_reconnect(endpoint: str) -> None:
    """The owner re-established a watched connection (client retry
    policy). No-op unarmed."""
    if _state.active:
        _count(endpoint, "reconnects", "netwatch_reconnects_total")


def record_retry(endpoint: str) -> None:
    """The owner re-issued a request after a transport fault. No-op
    unarmed."""
    if _state.active:
        _count(endpoint, "retries", "netwatch_retries_total")


# ---------------------------------------------------------------- watchdog ----

def _thread_stacks() -> Dict[str, List[str]]:
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        key = f"{names.get(ident, '?')}({ident})"
        out[key] = traceback.format_stack(frame)
    return out


def _stall_dump(endpoint: str, op: str, waited_s: float,
                timeout_s: Optional[float]) -> None:
    """Blocked-too-long artifact: all thread stacks through the flight
    recorder when a tracer is configured, stderr log otherwise. Never
    raises: the watchdog must not mask the stall it reports."""
    with _state.mu:
        _state.stall_dumps += 1
        _stat(endpoint)["stalls"] += 1
    extra = {
        "netwatch": {
            "endpoint": endpoint,
            "op": op,
            "waited_s": round(waited_s, 3),
            "timeout_s": timeout_s,
            "thread": threading.current_thread().name,
        },
        "thread_stacks": _thread_stacks(),
    }
    try:
        from deeplearning4j_tpu_torch.telemetry import trace as _trace

        tracer = _trace.get_tracer()
        if tracer is not None:
            tracer.dump("netwatch_stall", extra=extra)
            return
    except Exception:
        pass
    try:
        log.error("netwatch: %s.%s() blocked >%ss\n%s", endpoint, op,
                  round(waited_s, 1),
                  "\n".join(f"--- {k}\n{''.join(v)}"
                            for k, v in extra["thread_stacks"].items()))
    except Exception:
        pass


# ----------------------------------------------------------------- wrapper ----

class WatchedSocket:
    """A ``socket.socket`` whose blocking calls are timed, counted, and
    stall-dumped when the watch is armed; a plain passthrough when not.

    The enforced default: ``gettimeout()`` reports (and every blocking
    call uses) the process default whenever the owner never set one —
    under the watch an unbounded blocking call does not exist.
    ``accept()`` hands back the accepted connection wrapped under the
    same endpoint. ``makefile()`` streams bypass the watch (delegated) —
    wrap at the recv layer instead."""

    def __init__(self, inner: _socket.socket, endpoint: str):
        self._inner = inner
        self._endpoint = endpoint
        self._user_timeout = inner.gettimeout()

    # -- timeout plumbing --
    def settimeout(self, value) -> None:
        self._user_timeout = value
        self._inner.settimeout(value)

    def gettimeout(self):
        if self._user_timeout is None and _state.active:
            return _state.default_timeout_s
        return self._user_timeout

    def _effective_timeout(self) -> Optional[float]:
        if self._user_timeout is None:
            return _state.default_timeout_s
        return self._user_timeout

    # -- the watch --
    def _watched(self, op: str, fn, *args):
        if not _state.active:
            # disarmed mid-life: restore the owner's timeout before the
            # plain call (a chunked probe may have left a short one)
            if self._inner.gettimeout() != self._user_timeout:
                self._inner.settimeout(self._user_timeout)
            return fn(*args)
        timeout = self._effective_timeout()
        _count(self._endpoint, "ops")
        t0 = time.monotonic()
        if op not in _CHUNKABLE:
            # single-shot op: one attempt under the effective timeout
            self._inner.settimeout(timeout)
            try:
                return fn(*args)
            except _socket.timeout:
                waited = time.monotonic() - t0
                self._note_timeout(op, waited, timeout)
                raise
        deadline = None if timeout is None else t0 + timeout
        dumped = False
        while True:
            deadline_left = (None if deadline is None
                             else deadline - time.monotonic())
            if deadline_left is not None and deadline_left <= 0:
                waited = time.monotonic() - t0
                self._note_timeout(op, waited, timeout, dumped=dumped)
                raise _socket.timeout(
                    f"netwatch: {self._endpoint}.{op}() timed out after "
                    f"{timeout}s")
            chunk = (_state.watchdog_s if deadline_left is None
                     else min(_state.watchdog_s, deadline_left))
            self._inner.settimeout(max(chunk, 0.001))
            try:
                return fn(*args)
            except _socket.timeout:
                waited = time.monotonic() - t0
                if not dumped and waited >= _state.watchdog_s:
                    _stall_dump(self._endpoint, op, waited, timeout)
                    dumped = True  # one artifact per stuck call

    def _note_timeout(self, op: str, waited: float,
                      timeout: Optional[float], dumped: bool = False
                      ) -> None:
        with _state.mu:
            s = _stat(self._endpoint)
            s["wait_ms_max"] = max(s["wait_ms_max"], waited * 1000.0)
        _count(self._endpoint, "timeouts", "netwatch_timeouts_total")
        if not dumped and waited >= _state.watchdog_s:
            _stall_dump(self._endpoint, op, waited, timeout)

    # -- blocking surface --
    def recv(self, *args):
        return self._watched("recv", self._inner.recv, *args)

    def recv_into(self, *args):
        return self._watched("recv_into", self._inner.recv_into, *args)

    def accept(self):
        conn, addr = self._watched("accept", self._inner.accept)
        return wrap_socket(conn, self._endpoint), addr

    def connect(self, address):
        return self._watched("connect", self._inner.connect, address)

    def send(self, *args):
        return self._watched("send", self._inner.send, *args)

    def sendall(self, *args):
        return self._watched("sendall", self._inner.sendall, *args)

    # -- context manager + delegation --
    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._inner.close()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __repr__(self) -> str:
        return f"<WatchedSocket {self._endpoint!r} {self._inner!r}>"


# -------------------------------------------------------------------- seam ----

def make_socket(endpoint: str, *args, **kwargs):
    """The seam: a watched socket when the watch is armed (or
    ``DL4J_TPU_NETWATCH=1``), a plain ``socket.socket`` otherwise —
    byte-for-byte zero cost unarmed."""
    sock = _socket.socket(*args, **kwargs)
    if _armed_for_creation():
        return WatchedSocket(sock, endpoint)
    return sock


def wrap_socket(sock, endpoint: str):
    """Adopt an existing socket (a ``create_connection`` result, an
    accepted handler socket) into the watch. Returns ``sock`` unchanged
    when unarmed or already watched."""
    if not _armed_for_creation():
        return sock
    if isinstance(sock, WatchedSocket):
        return sock
    return WatchedSocket(sock, endpoint)


# ---------------------------------------------------------------- snapshots ----

def summary() -> Dict:
    """Aggregate watch state: per-endpoint stats + stall-dump count
    (what the bench detail and the tests assert on)."""
    with _state.mu:
        return {
            "endpoints": {ep: dict(s)
                          for ep, s in sorted(_state.stats.items())},
            "stall_dumps": _state.stall_dumps,
            "default_timeout_s": _state.default_timeout_s,
            "watchdog_s": _state.watchdog_s,
        }


def metrics_record() -> Dict[str, float]:
    """Flat ``netwatch_*`` keys for a telemetry step-log record (the JAX
    package's ``tools/telemetry_report.py`` renders these as its netwatch
    per-endpoint section)."""
    out: Dict[str, float] = {}
    with _state.mu:
        for ep, s in sorted(_state.stats.items()):
            safe = ep.replace(".", "_")
            out[f"netwatch_{safe}_ops"] = s["ops"]
            out[f"netwatch_{safe}_timeouts"] = s["timeouts"]
            out[f"netwatch_{safe}_reconnects"] = s["reconnects"]
            out[f"netwatch_{safe}_retries"] = s["retries"]
            out[f"netwatch_{safe}_wait_ms_max"] = round(
                s["wait_ms_max"], 3)
        if _state.stall_dumps:
            out["netwatch_stall_dumps"] = float(_state.stall_dumps)
    return out
