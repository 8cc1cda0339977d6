"""Counterpart of ``deeplearning4j_tpu/utils/lockwatch.py`` (a copy: host
code, over the port's ``telemetry.registry`` and ``telemetry.trace``).

The runtime lock-order watchdog: the dynamic half of the concurrency
lint, as ``utils.retrace_guard`` is the runtime half of the compile
rules.

A static lint proves per-module lock discipline; what it cannot see is
the CROSS-module order: a decode-engine step that calls into the
registry, a tracker RPC issued under a caller's lock. This module wraps
``Lock``/``RLock``/``Condition`` behind a seam so, when armed, every
control-plane lock feeds one process-wide record:

- a **lock-order graph**: per-thread acquisition stacks record an edge
  ``A -> B`` whenever ``B`` is acquired while ``A`` is held; an acquire
  that would close a cycle raises :class:`LockOrderViolation` *before*
  blocking (deadlocks are detected, not demonstrated), or is counted
  when ``raise_on_cycle`` is off;
- **hold-time and contention telemetry** through the metrics registry:
  ``lockwatch_acquires_total``/``lockwatch_contended_total`` counters and
  ``lockwatch_wait_ms``/``lockwatch_hold_ms`` histograms, labeled by the
  seam name (``telemetry.alerts``' ``lockwatch_contention_spike`` rule
  and ``telemetry.step_log``'s summary read them);
- a **blocked-too-long watchdog**: an acquire stuck past ``watchdog_s``
  dumps every thread's stack through the flight recorder
  (``telemetry.trace.get_tracer().dump``; a stderr log without a
  tracer), then keeps waiting: the artifact names both the wanted lock
  and who is where.

The seam (``make_lock``/``make_rlock``/``make_condition``) is zero-cost
when unarmed: it hands back plain ``threading`` primitives. Arming is
``enable()`` or env ``DL4J_TPU_LOCKWATCH=1`` at lock-creation time.
Locks are labeled by ROLE, not instance: every ``DecodeEngine``'s
scheduler lock is one ``serve.engine`` node, which is the granularity a
deadlock report wants. The port's seams carry the JAX package's 18 role
names (``telemetry.history``, ``telemetry.runprof``, ``telemetry.trace``,
``federation.pusher``, ``telemetry.registry``, ``profile.store``,
``profile.memwatch``, ``telemetry.alerts``, ``tune.cache``,
``tune.cache.default``, ``serve.prefix_cache``, ``fleet.router``,
``serve.engine`` (its rlock and its condition), ``fleet.replica``,
``tracker.state``, ``ckpt.async.error``, ``tracker.client``).

Knobs (all host-side, read at enable/creation time):

- ``DL4J_TPU_LOCKWATCH``: create watched primitives (``1``/``true``).
- ``DL4J_TPU_LOCKWATCH_WATCHDOG_S``: blocked-too-long threshold
  (default 30).
- ``DL4J_TPU_LOCKWATCH_RAISE``: ``0`` counts cycles instead of raising.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional, Set

log = logging.getLogger(__name__)

__all__ = [
    "LockOrderViolation", "enable", "disable", "enabled", "reset",
    "make_lock", "make_rlock", "make_condition", "graph_snapshot",
    "cycles_detected", "summary", "metrics_record", "WatchedLock",
    "WatchedRLock",
]

_ENV_ON = "DL4J_TPU_LOCKWATCH"
_ENV_WATCHDOG = "DL4J_TPU_LOCKWATCH_WATCHDOG_S"
_ENV_RAISE = "DL4J_TPU_LOCKWATCH_RAISE"

# histogram bounds for lock wait/hold: control-plane critical sections are
# microseconds-to-milliseconds; the default 1ms+ bench buckets would bin
# everything into the first bucket
_LOCK_MS_BUCKETS = (0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0,
                    500.0, 2500.0)


class LockOrderViolation(RuntimeError):
    """Acquiring this lock here closes a cycle in the observed lock-order
    graph — two threads taking the same locks in opposite orders can
    deadlock. Raised BEFORE blocking on the reversed acquire."""


class _State:
    """Process-wide watch state. ``active`` gates instrumentation so
    wrappers created while armed go quiet after ``disable()``."""

    def __init__(self) -> None:
        self.active = False
        self.raise_on_cycle = True
        self.watchdog_s = 30.0
        self.registry = None  # None = default_registry() at record time
        self.mu = threading.Lock()  # guards graph/edges/cycles/stats
        self.graph: Dict[str, Set[str]] = {}
        self.edge_sites: Dict[tuple, str] = {}
        self.cycles: List[Dict] = []
        self.stats: Dict[str, Dict[str, float]] = {}
        self.watchdog_dumps = 0


_state = _State()
_tls = threading.local()


def _held_stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _truthy(val: Optional[str]) -> bool:
    return (val or "").strip().lower() in ("1", "true", "yes", "on")


def _env_armed() -> bool:
    return _truthy(os.environ.get(_ENV_ON))


def enabled() -> bool:
    return _state.active


def enable(raise_on_cycle: Optional[bool] = None,
           watchdog_s: Optional[float] = None, registry=None) -> None:
    """Arm the watcher for locks created from now on (and re-arm existing
    watched primitives)."""
    _state.active = True
    if raise_on_cycle is None:
        raise_on_cycle = _truthy(os.environ.get(_ENV_RAISE, "1"))
    _state.raise_on_cycle = raise_on_cycle
    if watchdog_s is None:
        watchdog_s = float(os.environ.get(_ENV_WATCHDOG, "30"))
    _state.watchdog_s = max(0.05, float(watchdog_s))
    _state.registry = registry


def disable() -> None:
    """Quiesce every watched primitive (they fall through to the plain
    inner lock) and keep the recorded graph for inspection."""
    _state.active = False


def reset() -> None:
    """Drop the recorded graph/stats/cycles (test isolation)."""
    with _state.mu:
        _state.graph.clear()
        _state.edge_sites.clear()
        _state.cycles.clear()
        _state.stats.clear()
        _state.watchdog_dumps = 0


# --------------------------------------------------------------- recording ----

def _stat(name: str) -> Dict[str, float]:
    s = _state.stats.get(name)
    if s is None:
        s = _state.stats[name] = {
            "acquires": 0.0, "contended": 0.0, "wait_ms_total": 0.0,
            "hold_ms_total": 0.0, "wait_ms_max": 0.0, "hold_ms_max": 0.0,
        }
    return s


def _registry():
    if _state.registry is not None:
        return _state.registry
    from deeplearning4j_tpu_torch.telemetry.registry import \
        default_registry

    return default_registry()


def _record_acquire(name: str, wait_s: float, contended: bool) -> None:
    if getattr(_tls, "busy", False):
        return  # re-entrant metric emission (a watched registry lock)
    _tls.busy = True
    try:
        wait_ms = wait_s * 1000.0
        with _state.mu:
            s = _stat(name)
            s["acquires"] += 1
            s["wait_ms_total"] += wait_ms
            s["wait_ms_max"] = max(s["wait_ms_max"], wait_ms)
            if contended:
                s["contended"] += 1
        reg = _registry()
        labels = {"lock": name}
        reg.counter("lockwatch_acquires_total", labels).inc()
        if contended:
            reg.counter("lockwatch_contended_total", labels).inc()
        reg.histogram("lockwatch_wait_ms", labels,
                      buckets=_LOCK_MS_BUCKETS).observe(wait_ms)
    finally:
        _tls.busy = False


def _record_release(name: str, held_s: float) -> None:
    if getattr(_tls, "busy", False):
        return
    _tls.busy = True
    try:
        hold_ms = held_s * 1000.0
        with _state.mu:
            s = _stat(name)
            s["hold_ms_total"] += hold_ms
            s["hold_ms_max"] = max(s["hold_ms_max"], hold_ms)
        _registry().histogram("lockwatch_hold_ms", {"lock": name},
                              buckets=_LOCK_MS_BUCKETS).observe(hold_ms)
    finally:
        _tls.busy = False


# -------------------------------------------------------------- order graph ----

def _path(src: str, dst: str) -> Optional[List[str]]:
    """A path src -> ... -> dst in the recorded graph (None if absent).
    Caller holds ``_state.mu``."""
    prev = {src: None}
    frontier = [src]
    while frontier:
        cur = frontier.pop()
        for nxt in _state.graph.get(cur, ()):
            if nxt in prev:
                continue
            prev[nxt] = cur
            if nxt == dst:
                out = [dst]
                while prev[out[-1]] is not None:
                    out.append(prev[out[-1]])
                return list(reversed(out))
            frontier.append(nxt)
    return None


def _check_order(target: str) -> None:
    """Record held->target edges; detect (and maybe raise on) a cycle
    BEFORE the caller blocks on the reversed acquire. The acquire site
    (three frames of stack) is formatted only for an edge seen for the
    first time or a cycle: formatting it on every nested acquire, as the
    JAX package does, was most of the watch's cost on a host-bound decode
    loop."""
    held = [name for _lk, name, _t in _held_stack() if name != target]
    if not held:
        return
    frame = sys._getframe(2)

    def site_of() -> str:
        return "".join(traceback.format_stack(frame, limit=3))

    site = None
    if any((h, target) not in _state.edge_sites for h in held):
        site = site_of()
    with _state.mu:
        cycle = None
        for h in dict.fromkeys(held):  # ordered dedup
            rev = _path(target, h)
            if rev is not None and cycle is None:
                cycle = {"holding": h, "acquiring": target,
                         "reversed_path": rev,
                         "first_seen": _state.edge_sites.get(
                             (rev[0], rev[1]) if len(rev) > 1 else None,
                             "?"),
                         "thread": threading.current_thread().name,
                         "site": site}
            _state.graph.setdefault(h, set()).add(target)
            if (h, target) not in _state.edge_sites:
                if site is None:  # the edge went since the check (reset)
                    site = site_of()
                _state.edge_sites[(h, target)] = site
        if cycle is not None:
            if site is None:
                site = cycle["site"] = site_of()
            _state.cycles.append(cycle)
            raise_it = _state.raise_on_cycle
    if cycle is None:
        return
    _record_cycle_metric()
    msg = (f"lock-order cycle: thread {cycle['thread']!r} acquiring "
           f"{target!r} while holding {cycle['holding']!r}, but the "
           f"reversed order {' -> '.join(cycle['reversed_path'])} was "
           f"already recorded — opposite-order threads deadlock.\n"
           f"acquire site:\n{site}")
    if raise_it:
        raise LockOrderViolation(msg)
    log.error(msg)


def _record_cycle_metric() -> None:
    if getattr(_tls, "busy", False):
        return
    _tls.busy = True
    try:
        _registry().counter("lockwatch_cycles_total").inc()
    finally:
        _tls.busy = False


# ---------------------------------------------------------------- watchdog ----

def _thread_stacks() -> Dict[str, List[str]]:
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        key = f"{names.get(ident, '?')}({ident})"
        out[key] = traceback.format_stack(frame)
    return out


def _watchdog_dump(name: str, waited_s: float) -> None:
    """Blocked-too-long artifact: all thread stacks through the flight
    recorder when a tracer is configured, stderr log otherwise.
    Never raises — the watchdog must not mask the stall it reports."""
    with _state.mu:
        _state.watchdog_dumps += 1
    extra = {
        "lockwatch": {
            "lock": name,
            "waited_s": round(waited_s, 3),
            "thread": threading.current_thread().name,
            "held_elsewhere": sorted(
                {n for t in threading.enumerate()
                 for n in _held_names_of(t)}),
        },
        "thread_stacks": _thread_stacks(),
    }
    try:
        from deeplearning4j_tpu_torch.telemetry import trace as _trace

        tracer = _trace.get_tracer()
        if tracer is not None:
            tracer.dump("lockwatch_blocked", extra=extra)
            return
    except Exception:
        pass
    try:
        log.error("lockwatch: blocked >%ss acquiring %r\n%s",
                  round(waited_s, 1), name,
                  "\n".join(f"--- {k}\n{''.join(v)}"
                            for k, v in extra["thread_stacks"].items()))
    except Exception:
        pass


def _held_names_of(thread: threading.Thread) -> List[str]:
    # best-effort: only the CURRENT thread's stack is visible through the
    # TLS; other threads' holdings show up in their dumped stacks instead
    if thread is threading.current_thread():
        return [name for _lk, name, _t in _held_stack()]
    return []


# ---------------------------------------------------------------- wrappers ----

class WatchedLock:
    """A ``threading.Lock`` with order/wait/hold recording when the watch
    is armed; a plain passthrough when not."""

    _reentrant = False

    def __init__(self, name: str, inner=None):
        self.name = name
        self._inner = inner if inner is not None else threading.Lock()

    # -- bookkeeping --
    def _depth(self) -> int:
        return sum(1 for lk, _n, _t in _held_stack() if lk is self)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not _state.active:
            return self._inner.acquire(blocking, timeout)
        reentry = self._reentrant and self._depth() > 0
        # edges taken while EMITTING lockwatch metrics (the registry lock
        # under whatever lock is being recorded) are instrumentation, not
        # program order — they must not pollute the graph
        if not reentry and not getattr(_tls, "busy", False):
            _check_order(self.name)
        if not blocking:
            got = self._inner.acquire(False)
            if got:
                _held_stack().append((self, self.name, time.perf_counter()))
                if not reentry:
                    _record_acquire(self.name, 0.0, contended=False)
            return got
        t0 = time.perf_counter()
        deadline = None if timeout is None or timeout < 0 else t0 + timeout
        got = self._inner.acquire(True, 0.0005)  # fast path probe
        contended = not got
        dumped = False
        waited = 0.0
        while not got:
            # graftlint: allow[untimed-dispatch] host lock-wait clock — no device work in this window
            waited = time.perf_counter() - t0
            if deadline is not None and time.perf_counter() >= deadline:
                _record_acquire(self.name, waited, contended=True)
                return False
            chunk = (_state.watchdog_s if deadline is None
                     else min(_state.watchdog_s,
                              deadline - time.perf_counter()))
            got = self._inner.acquire(True, max(chunk, 0.001))
            if not got and not dumped and waited >= _state.watchdog_s:
                _watchdog_dump(self.name, waited)
                dumped = True  # one artifact per stuck acquire
        if not reentry:
            # graftlint: allow[untimed-dispatch] host lock-wait clock — no device work in this window
            _record_acquire(self.name, time.perf_counter() - t0, contended)
        _held_stack().append((self, self.name, time.perf_counter()))
        return True

    def release(self) -> None:
        # bookkeeping mirrors reality even if the watch was disabled
        # mid-hold — a stale stack entry would fabricate edges later
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] is self:
                _lk, name, t_acq = stack.pop(i)
                if _state.active and self._depth() == 0:
                    _record_release(name, time.perf_counter() - t_acq)
                break
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r} {self._inner!r}>"


class WatchedRLock(WatchedLock):
    """Reentrant flavor: re-acquires by the owning thread record neither
    edges nor contention. Implements the ``Condition`` integration
    surface (``_is_owned``/``_release_save``/``_acquire_restore``) so
    ``threading.Condition(WatchedRLock(...))`` behaves exactly like one
    built on a plain RLock."""

    _reentrant = True

    def __init__(self, name: str, inner=None):
        super().__init__(name, inner if inner is not None
                         else threading.RLock())

    def locked(self) -> bool:  # RLock has no locked() on older CPythons
        probe = self._inner.acquire(False)
        if probe:
            self._inner.release()
        return not probe

    # -- Condition protocol --
    def _is_owned(self) -> bool:
        return self._inner._is_owned()

    def _release_save(self):
        # Condition.wait: drop ALL recursion levels; close out bookkeeping
        if _state.active:
            stack = _held_stack()
            t_first = None
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][0] is self:
                    t_first = stack[i][2]
                    stack.pop(i)
            if t_first is not None:
                _record_release(self.name, time.perf_counter() - t_first)
        return self._inner._release_save()

    def _acquire_restore(self, saved) -> None:
        self._inner._acquire_restore(saved)
        if _state.active:
            _held_stack().append((self, self.name, time.perf_counter()))


def make_lock(name: str) -> "threading.Lock | WatchedLock":
    """The seam: a watched lock when the watch is armed (or
    ``DL4J_TPU_LOCKWATCH=1``), a plain ``threading.Lock`` otherwise."""
    if _armed_for_creation():
        return WatchedLock(name)
    return threading.Lock()


def make_rlock(name: str) -> "threading.RLock | WatchedRLock":
    if _armed_for_creation():
        return WatchedRLock(name)
    return threading.RLock()


def _armed_for_creation() -> bool:
    """Watched primitives are handed out while armed — and arming via the
    env var (a worker process launched with DL4J_TPU_LOCKWATCH=1) flips
    the full watch on at first lock creation."""
    if _state.active:
        return True
    if _env_armed():
        enable()
        return True
    return False


def make_condition(lock=None, name: str = "condition"):
    """A ``Condition`` over ``lock`` (a watched or plain lock; created via
    ``make_rlock(name)`` when omitted). Waiting on it records the hold
    handoff exactly like releasing the lock."""
    if lock is None:
        lock = make_rlock(name)
    return threading.Condition(lock)


# ---------------------------------------------------------------- snapshots ----

def graph_snapshot() -> Dict[str, List[str]]:
    """The observed lock-order graph, JSON-ready."""
    with _state.mu:
        return {a: sorted(bs) for a, bs in sorted(_state.graph.items())}


def cycles_detected() -> List[Dict]:
    with _state.mu:
        return [dict(c) for c in _state.cycles]


def summary() -> Dict:
    """Aggregate watch state: per-lock stats + graph + cycle/watchdog
    counts (what the bench detail and the stress tests assert on)."""
    with _state.mu:
        return {
            "locks": {n: dict(s) for n, s in sorted(_state.stats.items())},
            "graph": {a: sorted(bs)
                      for a, bs in sorted(_state.graph.items())},
            "cycles": len(_state.cycles),
            "watchdog_dumps": _state.watchdog_dumps,
        }


def metrics_record() -> Dict[str, float]:
    """Flat ``lockwatch_*`` keys for a telemetry step-log record —
    ``tools/telemetry_report.py`` renders these as its lockwatch section
    (silent when a log carries none)."""
    out: Dict[str, float] = {}
    with _state.mu:
        for name, s in sorted(_state.stats.items()):
            safe = name.replace(".", "_")
            out[f"lockwatch_{safe}_acquires"] = s["acquires"]
            out[f"lockwatch_{safe}_contended"] = s["contended"]
            out[f"lockwatch_{safe}_hold_ms_max"] = round(
                s["hold_ms_max"], 3)
            out[f"lockwatch_{safe}_hold_ms_mean"] = round(
                s["hold_ms_total"] / s["acquires"], 4) if s["acquires"] \
                else 0.0
            out[f"lockwatch_{safe}_wait_ms_max"] = round(
                s["wait_ms_max"], 3)
        if _state.cycles:
            out["lockwatch_cycles"] = float(len(_state.cycles))
        if _state.watchdog_dumps:
            out["lockwatch_watchdog_dumps"] = float(_state.watchdog_dumps)
    return out
