"""Counterpart of ``deeplearning4j_tpu/scaleout/remote_tracker.py``: the
cross-process StateTracker, a TCP server + client with the same contract.

Parity with ref: the reference's tracker is a Hazelcast data grid usable
embedded-or-client across machines
(scaleout/statetracker/hazelcast/BaseHazelCastStateTracker.java:78-100).
Here the master EMBEDS ``StateTrackerServer`` (which wraps a thread-safe
in-process tracker) and workers connect a ``StateTrackerClient``: the
identical ``StateTracker`` API on both sides, so every control-plane
component (work routers, aggregators, early stopping, the runners, the
serving fleet) runs unchanged across process boundaries.

Wire protocol, byte-compatible with the JAX package's: length-prefixed
(4-byte big-endian) pickle frames carrying (method, args, kwargs[,
trace_ctx]) -> (ok, result-or-exception). The optional 4th element is a
``telemetry.trace`` span context ({"trace_id", "span_id"}), present only
when the calling thread is inside a traced operation; the server, when a
process tracer is configured, records a ``tracker.serve`` span parented
under it. A 3-tuple frame stays valid: tracing off means the plain wire
format. A JAX client therefore talks to this server, and this client to a
JAX server, for every call whose arguments and results pickle the same in
both packages (membership, counters, KV rows, lifecycle flags). A ``Job``
pickles by its class path, so jobs cross only between processes of one
package. Pickle matches the payloads (Jobs holding numpy param arrays /
DataSets); the listener binds to 127.0.0.1 by default because a routable
bind would unpickle any peer's frames: the boundary is trusted-cluster
only, the reference's deployment model, not an internet-facing API.

Cross-process ``clear_updates(expected)``: the in-memory tracker keys the
"only clear what I aggregated" rule on object IDENTITY, which cannot cross
pickling. The server versions every update; ``updates()`` on the client
remembers each snapshot's versions and ``clear_updates`` sends them, so
the compare-and-delete happens server-side with the same no-lost-update
guarantee (a newer unseen snapshot is never deleted unaggregated).

Transport fault model: every client socket carries a connect AND a
per-request timeout, so a hung or restarting master turns into a bounded
stall, never a thread blocked forever in ``recv``. Idempotent calls
(reads, and the last-write-wins / compare-and-delete writes) are retried
on a fresh connection with bounded jittered backoff; non-idempotent calls
(``increment``, blind ``clear_updates``) fail fast, because a retry after
a lost response could double-apply. Every transport failure surfaces as
``TrackerUnavailable`` (a ``ConnectionError`` subclass, so existing
handlers keep working) rather than a bare socket error, and reconnects /
retries / failures land in the telemetry registry
(``tracker_reconnects_total`` / ``tracker_retries_total`` /
``tracker_failures_total``).

The client's request lock is a plain ``threading.Lock``: the JAX package's
lock-order watchdog (``utils/lockwatch``) comes with ROADMAP item 21d.
"""

from __future__ import annotations

import pickle
import random
import socket
import socketserver
import struct
import threading
import time
from typing import Any, Dict, Optional

from deeplearning4j_tpu_torch.scaleout.job import Job
from deeplearning4j_tpu_torch.scaleout.statetracker import (
    InMemoryStateTracker,
    StateTracker,
)
from deeplearning4j_tpu_torch.telemetry import trace as _trace
from deeplearning4j_tpu_torch.utils import netwatch

_HDR = struct.Struct(">I")
_MAX_FRAME = 1 << 30


class TrackerUnavailable(ConnectionError):
    """The tracker could not be reached (connect/request timeout, broken
    frame, or retry budget exhausted). Subclasses ``ConnectionError`` so
    pre-existing ``except (ConnectionError, OSError)`` handlers — worker
    heartbeat loops, poll loops — keep treating it as a transport fault."""


# Calls safe to re-issue after an ambiguous failure (the request may or may
# not have been applied before the connection broke): pure reads, and writes
# that are last-write-wins per key or compare-and-delete. ``increment`` and
# the blind ``clear_updates`` are excluded — replaying either can
# double-apply (double-count / drop an update that landed in between).
# High-frequency poll methods whose per-call spans would be pure noise
# (a version-wait loop issues dozens per round at poll_s cadence). Their
# aggregate cost is exactly the enclosing span's duration (worker.sync_wait
# etc), so skipping the per-poll spans loses nothing the timeline needs.
_UNTRACED_POLLS = frozenset({"count", "is_done"})

_IDEMPOTENT = frozenset({
    "add_worker", "remove_worker", "workers",
    "add_job", "job_for", "clear_job", "has_pending_jobs",
    "add_update", "updates_versioned", "clear_updates_versioned",
    "set_current", "get_current",
    "put_kv", "get_kv", "kv_snapshot",
    "add_replicate", "needs_replicate", "done_replicating",
    "count", "counters_snapshot", "finish", "is_done",
    "set_best_loss", "best_loss", "early_stop", "is_early_stop",
})

# Every RPC method must be classified one way or the other: a new method
# in neither set is a retry-policy decision nobody made, and
# ``_call_locked`` rejects it.
_NONIDEMPOTENT = frozenset({"increment", "clear_updates"})


def _send_frame(sock: socket.socket, obj: Any) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_HDR.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("tracker connection closed")
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket) -> Any:
    (n,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if n > _MAX_FRAME:
        raise ConnectionError(f"oversized tracker frame ({n} bytes)")
    return pickle.loads(_recv_exact(sock, n))


class _VersionedTracker(InMemoryStateTracker):
    """Server-side tracker: updates carry monotone versions so the
    clear-if-unchanged rule survives serialization."""

    def __init__(self):
        super().__init__()
        self._update_versions: Dict[str, int] = {}
        self._version_counter = 0

    def add_update(self, worker_id: str, job: Job) -> None:
        with self._lock:
            self._updates[worker_id] = job
            self._version_counter += 1
            self._update_versions[worker_id] = self._version_counter

    def updates_versioned(self):
        with self._lock:
            return dict(self._updates), dict(self._update_versions)

    def clear_updates_versioned(self, expected_versions: Dict[str, int]):
        with self._lock:
            for worker_id, version in expected_versions.items():
                if self._update_versions.get(worker_id) == version:
                    del self._updates[worker_id]
                    del self._update_versions[worker_id]

    def clear_updates(self, expected=None) -> None:
        # embedded-side callers still get identity semantics; keep the
        # version map consistent with whatever survives
        with self._lock:
            super().clear_updates(expected)
            self._update_versions = {
                w: v for w, v in self._update_versions.items()
                if w in self._updates
            }


class StateTrackerServer:
    """Embeds a versioned tracker and serves it over TCP (the "master"
    Hazelcast member). ``tracker`` is the embedded handle — the master-side
    code uses it directly with zero IPC."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 handler_timeout_s: float = 300.0):
        self.tracker = _VersionedTracker()
        self.handler_timeout_s = handler_timeout_s
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                # A dead client must not pin this handler thread
                # forever: bound every recv, generously enough that an idle but
                # alive client at the repo's poll cadences never trips
                # it. ``socket.timeout`` is an OSError, so expiry takes
                # the same client-went-away exit below.
                self.request = netwatch.wrap_socket(
                    self.request, "tracker.server.handler")
                self.request.settimeout(outer.handler_timeout_s)
                try:
                    while True:
                        frame = _recv_frame(self.request)
                        method, args, kwargs = frame[:3]
                        ctx = frame[3] if len(frame) > 3 else None
                        tracer = _trace.get_tracer()
                        sp = (tracer.start_span(
                                  "tracker.serve", parent=ctx,
                                  attrs={"method": method})
                              if tracer is not None and ctx else None)
                        try:
                            fn = getattr(outer.tracker, method)
                            _send_frame(self.request,
                                        (True, fn(*args, **kwargs)))
                            if sp is not None:
                                sp.end()
                        except Exception as e:  # surfaced client-side
                            if sp is not None:
                                sp.end(error=e)
                            _send_frame(self.request, (False, e))
                except (ConnectionError, EOFError, OSError):
                    return

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="state-tracker-server")
        self._thread.start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def shutdown(self) -> None:
        self._server.shutdown()  # stops serve_forever; established handler
        self._server.server_close()  # sockets drain on their own threads
        self._thread.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


class StateTrackerClient(StateTracker):
    """The "worker" Hazelcast client: every StateTracker method is one RPC
    to the master's server. Thread-safe (one socket, request lock).

    ``timeout`` bounds the TCP connect; ``request_timeout_s`` bounds every
    request/response round trip (a hung master is a ``TrackerUnavailable``
    after that many seconds, not a forever-blocked worker thread).
    Idempotent calls are retried up to ``retries`` times on a fresh
    connection with jittered exponential backoff; a broken frame mid-stream
    (master restart, dropped proxy) triggers the same reconnect path."""

    def __init__(self, address: str, timeout: float = 30.0,
                 request_timeout_s: float = 10.0, retries: int = 3,
                 backoff_s: float = 0.05, max_backoff_s: float = 1.0,
                 registry=None):
        host, _, port = address.rpartition(":")
        self._addr = (host, int(port))
        self._connect_timeout = timeout
        self._request_timeout_s = request_timeout_s
        self._retries = max(0, int(retries))
        self._backoff_s = backoff_s
        self._max_backoff_s = max_backoff_s
        if registry is None:
            from deeplearning4j_tpu_torch.telemetry.registry import (
                default_registry,
            )

            registry = default_registry()
        self._registry = registry
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        # version bookkeeping for clear_updates(expected) — see module doc
        self._snapshot_versions: Dict[int, Dict[str, int]] = {}
        self._connect()  # fail fast on a bad address, like the old client

    # ---- transport ----
    def _connect(self) -> None:
        sock = socket.create_connection(self._addr,
                                        timeout=self._connect_timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(self._request_timeout_s)
        self._sock = netwatch.wrap_socket(sock, "tracker.client")

    def _drop_socket(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _roundtrip(self, method: str, args, kwargs, span=None):
        if self._sock is None:
            self._connect()
            self._registry.counter("tracker_reconnects_total").inc()
            netwatch.record_reconnect("tracker.client")
            if span is not None:
                span.add_event("reconnect")
        if span is not None:
            frame = (method, args, kwargs, span.context())
        else:
            frame = (method, args, kwargs)
        _send_frame(self._sock, frame)
        return _recv_frame(self._sock)

    def _call(self, method: str, *args, **kwargs):
        """One RPC with the retry policy (see ``_call_locked``). When the
        calling thread is inside a traced span, the RPC gets its own
        ``tracker.rpc`` span (retries/reconnects as span events) and the
        span context rides the frame to the server — a thread with no open
        span (heartbeat loops, bare polls) stays on the untraced 3-tuple
        path, so tracing never floods the sink with liveness chatter."""
        tracer = _trace.get_tracer()
        if (tracer is not None and method not in _UNTRACED_POLLS
                and tracer.current_span() is not None):
            with tracer.span("tracker.rpc",
                             attrs={"method": method}) as sp:
                return self._call_locked(method, args, kwargs, sp)
        return self._call_locked(method, args, kwargs, None)

    def _call_locked(self, method: str, args, kwargs, span):
        """Any transport-layer failure — timeout, reset, short/garbled
        frame — closes the socket; idempotent methods then retry on a
        fresh connection, everything else surfaces ``TrackerUnavailable``
        immediately (see ``_IDEMPOTENT``)."""
        if method not in _IDEMPOTENT and method not in _NONIDEMPOTENT:
            raise ValueError(
                f"tracker RPC {method!r} has no idempotency classification; "
                "add it to _IDEMPOTENT or _NONIDEMPOTENT (this decides its "
                "retry policy — see the nonidempotent-retry lint)")
        attempts = (self._retries + 1) if method in _IDEMPOTENT else 1
        last_exc: Optional[BaseException] = None
        with self._lock:
            for attempt in range(attempts):
                if attempt:
                    self._registry.counter("tracker_retries_total").inc()
                    netwatch.record_retry("tracker.client")
                    if span is not None:
                        span.add_event("retry", attempt=attempt,
                                       error=repr(last_exc))
                    delay = min(self._max_backoff_s,
                                self._backoff_s * (2 ** (attempt - 1)))
                    time.sleep(delay * (0.5 + random.random() / 2))
                try:
                    ok, result = self._roundtrip(method, args, kwargs, span)
                except (ConnectionError, socket.timeout, OSError, EOFError,
                        struct.error, pickle.UnpicklingError) as exc:
                    last_exc = exc
                    self._drop_socket()  # broken frame ⇒ resync via reconnect
                    continue
                if not ok:
                    raise result  # server-side exception, transport is fine
                return result
        self._registry.counter("tracker_failures_total").inc()
        raise TrackerUnavailable(
            f"tracker at {self._addr[0]}:{self._addr[1]} unavailable after "
            f"{attempts} attempt(s) calling {method!r}: {last_exc!r}"
        ) from last_exc

    def close(self) -> None:
        with self._lock:
            self._drop_socket()

    # ---- workers ----
    def add_worker(self, worker_id):
        return self._call("add_worker", worker_id)

    def remove_worker(self, worker_id):
        return self._call("remove_worker", worker_id)

    def workers(self):
        return self._call("workers")

    # ---- jobs ----
    def add_job(self, job):
        return self._call("add_job", job)

    def job_for(self, worker_id):
        return self._call("job_for", worker_id)

    def clear_job(self, worker_id):
        return self._call("clear_job", worker_id)

    def has_pending_jobs(self):
        return self._call("has_pending_jobs")

    # ---- updates (versioned across the wire) ----
    def add_update(self, worker_id, job):
        return self._call("add_update", worker_id, job)

    def updates(self):
        jobs, versions = self._call("updates_versioned")
        self._snapshot_versions[id(jobs)] = versions
        # bound the cache: keep only the most recent few snapshots
        if len(self._snapshot_versions) > 8:
            oldest = next(iter(self._snapshot_versions))
            del self._snapshot_versions[oldest]
        return jobs

    def clear_updates(self, expected: Optional[Dict[str, Job]] = None):
        if expected is None:
            return self._call("clear_updates")
        versions = self._snapshot_versions.pop(id(expected), None)
        if versions is None:
            # not one of our snapshots (caller-built dict): conservative —
            # clearing blind could drop an unseen newer update, so no-op
            return None
        return self._call(
            "clear_updates_versioned",
            {w: versions[w] for w in expected if w in versions})

    # ---- current result ----
    def set_current(self, result):
        return self._call("set_current", result)

    def get_current(self):
        return self._call("get_current")

    # ---- generic KV blobs (last-write-wins per key, so the writes are
    # retry-safe idempotent like set_current) ----
    def put_kv(self, key, value):
        return self._call("put_kv", key, value)

    def get_kv(self, key, default=None):
        return self._call("get_kv", key, default)

    def kv_snapshot(self, prefix: str = ""):
        return self._call("kv_snapshot", prefix)

    # ---- replication ----
    def add_replicate(self, worker_id):
        return self._call("add_replicate", worker_id)

    def needs_replicate(self, worker_id):
        return self._call("needs_replicate", worker_id)

    def done_replicating(self, worker_id):
        return self._call("done_replicating", worker_id)

    # ---- counters / lifecycle ----
    def increment(self, key, by: float = 1.0):
        return self._call("increment", key, by)

    def count(self, key):
        return self._call("count", key)

    def counters_snapshot(self, prefix: str = ""):
        return self._call("counters_snapshot", prefix)

    def finish(self):
        return self._call("finish")

    def is_done(self):
        return self._call("is_done")

    # ---- early stopping / best model ----
    def set_best_loss(self, loss):
        return self._call("set_best_loss", loss)

    def best_loss(self):
        return self._call("best_loss")

    def early_stop(self):
        return self._call("early_stop")

    def is_early_stop(self):
        return self._call("is_early_stop")
