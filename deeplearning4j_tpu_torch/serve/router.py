"""Counterpart of ``deeplearning4j_tpu/serve/router.py``: the fleet front
end. Least-loaded request routing over N decode replicas with session
affinity, stale-heartbeat death detection, in-flight requeue, and
cold-start hooks: the DL4J ``WorkRouter``/``StateTracker`` layer reborn
for inference.

The router speaks ONLY the tracker protocol: replicas are tracker workers
(``add_worker`` membership, ``hb.<replica>`` counter heartbeats on their
own connection), load rows / request dispatches / progress streams all
ride the tracker's KV (``fleet.load.<replica>`` /
``fleet.req.<replica>.<rid>.<attempt>`` / ``fleet.prog.<rid>``, JSON
values, last-write-wins), with the JAX package's key layout and row
fields, so a JAX router can drive port replicas and the other way round.
No new sockets exist anywhere in the fleet: every byte crosses the
netwatch-seamed ``StateTrackerClient``.

Routing policy (:func:`pick_replica`, pure and unit-testable):

- only ``alive`` replicas are eligible: a replica whose heartbeat
  counter stalls past ``stale_after_s`` is marked ``stale`` and receives
  ZERO new dispatches while its in-flight work is given the grace window
  to finish (it may recover: a resumed heartbeat restores ``alive``);
- **session affinity**: a request carrying a ``session`` key routes to
  the replica that key is pinned to (so shared-prefix KV pages keep
  hitting), as long as that replica is alive; the pin is dropped only at
  burial, and a re-pinned session does NOT flap back when its old
  replica rejoins;
- otherwise **least-loaded**: minimal router-side outstanding count plus
  the replica's last published ``queue_depth + active_slots``, with a
  deterministic lexicographic replica-id tie-break.

Death and requeue: a heartbeat stalled past ``dead_after_s`` buries the
replica: deregister, retire its ``fleet_replica_heartbeat_unix{replica=...}``
gauge to the -1.0 sentinel (an absence rule watching it stops firing for
handled deaths), bump ``fleet_replicas_failed_total``, and REQUEUE every
in-flight request assigned to it: the retained prompt plus the tokens
already streamed back re-prefills on a survivor with ``max_new``
decremented by the tokens already emitted, so the client sees one
uninterrupted, greedy-token-identical stream. An optional ``cold_start``
callback then spawns the replacement (``FleetReplica.from_live_params``,
device to device, is the intended path: see serve/fleet.py).

The router exposes the engine driver protocol (``submit`` / ``has_work``
/ ``step``), so ``serve/loadgen.run_open_loop`` drives a fleet exactly
like one engine, and the UI's POST ``/api/generate`` and GET
``/api/fleet`` (``UiServer.attach_fleet``) front it. The router's lock
is the ``fleet.router`` lockwatch seam (``utils.lockwatch.make_rlock``).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Sequence

from deeplearning4j_tpu_torch.utils.lockwatch import make_rlock

LOAD_PREFIX = "fleet.load."
REQ_PREFIX = "fleet.req."
PROG_PREFIX = "fleet.prog."
INFO_PREFIX = "fleet.replica."
HB_PREFIX = "hb."

log = logging.getLogger(__name__)


def _env_float(name: str, default: float) -> float:
    """Float knob under the documented ``DL4J_TPU_FLEET_*`` namespace
    (every call site passes a namespaced literal), resolved host-side at
    construction."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


class FleetRequest:
    """One routed request's lifecycle record, the fleet twin of
    ``serve.engine.ServeRequest`` (same fields loadgen reads:
    ``generated`` / ``done`` / ``t_submit`` / ``t_first`` / ``t_done`` /
    ``t_tokens``), plus the routing trail: ``replica`` (current
    assignment), ``attempt`` (bumped per dispatch — progress rows from a
    buried replica's stale attempt are ignored), ``requeues``, and the
    requeue clock ``t_requeue`` -> ``t_first_after_requeue`` (requeue to
    first token)."""

    def __init__(self, rid: str, prompt: List[int], max_new_tokens: int,
                 temperature: float, eos_id: Optional[int],
                 session: Optional[str]):
        self.rid = rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.eos_id = eos_id
        self.session = session
        self.generated: List[int] = []
        self.finish_reason: Optional[str] = None
        self.done = threading.Event()
        self.t_submit = time.perf_counter()
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None
        self.t_tokens: List[float] = []
        self.replica: Optional[str] = None
        self.attempt = 0
        self.requeues = 0
        self.t_requeue: Optional[float] = None
        self.t_first_after_requeue: Optional[float] = None
        # tokens carried over from attempts on buried replicas: progress
        # rows of the CURRENT attempt report only its continuation, so
        # generated = _carried + current attempt's tokens
        self._carried: List[int] = []


def replica_load(view: Dict) -> float:
    """The least-loaded ordering key: requests this router has assigned
    and not yet seen complete (exact, instant) plus the replica's last
    published queue depth + busy slots (covers load from other
    frontends; lags one publish interval, which reads conservative)."""
    return (float(view.get("outstanding", 0))
            + float(view.get("queue_depth", 0))
            + float(view.get("active_slots", 0)))


def pick_replica(views: Sequence[Dict], session: Optional[str] = None,
                 affinity: Optional[Dict[str, str]] = None
                 ) -> Optional[str]:
    """Pure routing policy over replica view dicts (``replica_id`` /
    ``state`` / ``outstanding`` / ``queue_depth`` / ``active_slots``).
    Only ``state == "alive"`` replicas are eligible — stale ones receive
    zero new dispatches before burial. A pinned live session wins;
    otherwise least :func:`replica_load` with the lexicographically
    smallest ``replica_id`` breaking ties (deterministic: equal fleets
    always route identically). Returns None when nothing is alive."""
    alive = {v["replica_id"]: v for v in views if v.get("state") == "alive"}
    if not alive:
        return None
    if session is not None and affinity:
        pinned = affinity.get(session)
        if pinned in alive:
            return pinned
    return min(alive.values(),
               key=lambda v: (replica_load(v), v["replica_id"]))["replica_id"]


class FleetRouter:
    """Tracker-driven fleet front end. ``tracker`` is anything speaking
    the StateTracker protocol: the TCP ``StateTrackerClient`` in a real
    deployment, ``InMemoryStateTracker`` in unit tests. Single-threaded
    by default (the loadgen driver owns the ``step`` cadence, like the
    engine); ``start()`` runs the same loop on a daemon thread.

    Knobs (env defaults are the ``DL4J_TPU_FLEET_*`` namespace, read
    host-side at construction): ``stale_after_s`` /
    ``DL4J_TPU_FLEET_STALE_S`` — heartbeat stall that stops new
    dispatches; ``dead_after_s`` / ``DL4J_TPU_FLEET_DEAD_S`` — stall
    that buries the replica and requeues its in-flight requests;
    ``poll_s`` / ``DL4J_TPU_FLEET_POLL_S`` — the tracker poll floor
    (one membership + progress sweep per interval, however fast the
    driver calls ``step``)."""

    def __init__(self, tracker, *, registry=None,
                 stale_after_s: Optional[float] = None,
                 dead_after_s: Optional[float] = None,
                 poll_s: Optional[float] = None,
                 cold_start: Optional[Callable[[str], None]] = None):
        from deeplearning4j_tpu_torch.telemetry.registry import (
            default_registry,
        )

        self.tracker = tracker
        self.registry = registry if registry is not None else \
            default_registry()
        self.stale_after_s = (stale_after_s if stale_after_s is not None
                              else _env_float("DL4J_TPU_FLEET_STALE_S", 1.0))
        self.dead_after_s = (dead_after_s if dead_after_s is not None
                             else _env_float("DL4J_TPU_FLEET_DEAD_S", 3.0))
        if self.dead_after_s < self.stale_after_s:
            raise ValueError(
                f"dead_after_s={self.dead_after_s} must be >= "
                f"stale_after_s={self.stale_after_s} (stale is the "
                "zero-dispatch grace window BEFORE burial)")
        self.poll_s = (poll_s if poll_s is not None
                       else _env_float("DL4J_TPU_FLEET_POLL_S", 0.01))
        self.cold_start = cold_start
        self._lock = make_rlock("fleet.router")  # lockwatch seam
        self._halt = threading.Event()
        # membership: replica_id -> view dict (state/load/heartbeat book)
        self._views: Dict[str, Dict] = {}
        self._hb_seen: Dict[str, tuple] = {}
        self._affinity: Dict[str, str] = {}
        self._pending: List[FleetRequest] = []       # awaiting dispatch
        self._inflight: Dict[str, FleetRequest] = {}  # rid -> dispatched
        self._seq = 0
        self._uid = uuid.uuid4().hex[:6]
        self._last_poll = 0.0
        self._thread: Optional[threading.Thread] = None
        self.requests_total = 0
        self.completed_total = 0
        self.requeued_total = 0
        self.failed_replicas: List[str] = []

    # ------------------------------------------------------- submission ----
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               temperature: float = 0.0, eos_id: Optional[int] = None,
               session: Optional[str] = None) -> FleetRequest:
        """Enqueue a request for dispatch on the next ``step``. Same
        validation contract as ``DecodeEngine.submit``."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        with self._lock:
            self._seq += 1
            req = FleetRequest(f"fr-{self._uid}-{self._seq}", prompt,
                               int(max_new_tokens), float(temperature),
                               eos_id, session)
            self._pending.append(req)
            self.requests_total += 1
            self.registry.counter("fleet_requests_total").inc()
        return req

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._pending) or bool(self._inflight)

    # ------------------------------------------------------- membership ----
    def _refresh_membership(self, now_mono: float) -> None:
        """One control-plane sweep: membership + heartbeats + load rows.
        Liveness is heartbeat COUNT progression against the local
        monotonic clock (wall clocks across processes never compare), as
        ``DistributedMaster._dead_workers`` reads it, and each
        progression stamps the ``fleet_replica_heartbeat_unix{replica=...}``
        gauge an absence rule (``fleet_replica_down``) watches."""
        members = set(self.tracker.workers())
        hb = self.tracker.counters_snapshot(HB_PREFIX)
        loads = self.tracker.kv_snapshot(LOAD_PREFIX)
        dead: List[str] = []
        for rid in sorted(members):
            count = hb.get(HB_PREFIX + rid, 0.0)
            seen = self._hb_seen.get(rid)
            if seen is None or seen[0] != count:
                self._hb_seen[rid] = (count, now_mono)
                self.registry.gauge("fleet_replica_heartbeat_unix",
                                    {"replica": rid}).set(time.time())
            view = self._views.setdefault(
                rid, {"replica_id": rid, "state": "alive", "outstanding": 0,
                      "queue_depth": 0, "active_slots": 0, "slots": None,
                      "dispatches": 0})
            row = loads.get(LOAD_PREFIX + rid)
            if row is not None:
                try:
                    load = json.loads(row)
                except ValueError:
                    load = {}
                for key in ("queue_depth", "active_slots", "slots",
                            "weight_version", "tokens_total",
                            "prefix_hit_rate", "alerts_firing"):
                    if key in load:
                        view[key] = load[key]
            stalled = now_mono - self._hb_seen[rid][1]
            if stalled > self.dead_after_s:
                view["state"] = "dead"
                dead.append(rid)
            elif stalled > self.stale_after_s:
                view["state"] = "stale"
            else:
                view["state"] = "alive"
            view["heartbeat_age_s"] = round(stalled, 3)
        # forget views for replicas no longer registered and not carrying
        # our work (a buried replica's view survives until its requests
        # are requeued below)
        for rid in [r for r in self._views
                    if r not in members and self._views[r]["outstanding"] == 0]:
            self._views.pop(rid)
            self._hb_seen.pop(rid, None)
        for rid in dead:
            self._bury(rid)
        alive = [v for v in self._views.values() if v["state"] == "alive"]
        self.registry.gauge("fleet_replicas_alive").set(float(len(alive)))
        if alive:
            depths = [float(v.get("queue_depth", 0)) for v in alive]
            mean = sum(depths) / len(depths)
            ratio = (max(depths) / mean) if mean > 0 else 0.0
            self.registry.gauge("fleet_queue_imbalance_ratio").set(ratio)

    def _bury(self, rid: str) -> None:
        """Deregister a dead replica, retire its heartbeat series to the
        non-positive handled sentinel (-1.0), requeue every
        in-flight request it held, and drop its session pins so those
        sessions re-pin at next dispatch. ``cold_start`` (if any) runs
        from ``step`` AFTER the lock is released."""
        try:
            self.tracker.remove_worker(rid)
        except (ConnectionError, OSError) as exc:
            # control plane flapping; membership view already updated
            log.warning("deregistering dead replica %s failed: %r",
                        rid, exc)
        self._hb_seen.pop(rid, None)
        view = self._views.get(rid)
        if view is not None:
            view["state"] = "dead"
        self.registry.gauge("fleet_replica_heartbeat_unix",
                            {"replica": rid}).set(-1.0)
        self.registry.counter("fleet_replicas_failed_total").inc()
        self.failed_replicas.append(rid)
        for session in [s for s, r in self._affinity.items() if r == rid]:
            self._affinity.pop(session)
        for req in [r for r in self._inflight.values() if r.replica == rid]:
            self._requeue(req)

    def _requeue(self, req: FleetRequest) -> None:
        """Death-requeue: retain prompt + tokens already emitted, shrink
        the budget by what streamed, and put the request back at the
        FRONT of the dispatch queue (it has been waiting longest). The
        attempt bump makes any late progress rows from the buried
        replica's attempt inert. Reached only from ``_bury`` under
        ``step``'s locked section; the reentrant acquire keeps the
        invariant explicit."""
        with self._lock:
            self._inflight.pop(req.rid, None)
            if req.replica is not None:
                v = self._views.get(req.replica)
                if v is not None:
                    v["outstanding"] = max(0, v["outstanding"] - 1)
            remaining = req.max_new_tokens - len(req.generated)
            if remaining <= 0 or req.finish_reason is not None:
                self._finish(req, req.finish_reason or "max_new_tokens")
                return
            req._carried = list(req.generated)
            req.replica = None
            req.requeues += 1
            req.t_requeue = time.perf_counter()
            req.t_first_after_requeue = None
            self.requeued_total += 1
            self.registry.counter("fleet_requeued_total").inc()
            self._pending.insert(0, req)

    # --------------------------------------------------------- dispatch ----
    def _dispatch(self) -> None:
        views = list(self._views.values())
        still: List[FleetRequest] = []
        for req in self._pending:
            rid = pick_replica(views, req.session, self._affinity)
            if rid is None:
                still.append(req)  # nothing alive; retry next sweep
                continue
            if req.session is not None:
                self._affinity.setdefault(req.session, rid)
            req.replica = rid
            req.attempt += 1
            payload = {
                "rid": req.rid, "attempt": req.attempt,
                # the retained prompt: original tokens plus everything
                # already streamed, so the continuation re-prefills (and
                # prefix-cache hits) instead of regenerating
                "prompt": req.prompt + req._carried,
                "max_new": req.max_new_tokens - len(req._carried),
                "temperature": req.temperature, "eos_id": req.eos_id,
            }
            self.tracker.put_kv(
                f"{REQ_PREFIX}{rid}.{req.rid}.{req.attempt}",
                json.dumps(payload))
            self._inflight[req.rid] = req
            view = self._views[rid]
            view["outstanding"] += 1
            view["dispatches"] = view.get("dispatches", 0) + 1
            self.registry.counter("fleet_dispatches_total",
                                  {"replica": rid}).inc()
        self._pending = still

    # --------------------------------------------------------- progress ----
    def _poll_progress(self) -> None:
        if not self._inflight:
            return
        rows = self.tracker.kv_snapshot(PROG_PREFIX)
        now = time.perf_counter()
        for req in list(self._inflight.values()):
            raw = rows.get(PROG_PREFIX + req.rid)
            if raw is None:
                continue
            try:
                prog = json.loads(raw)
            except ValueError:
                continue
            if prog.get("attempt") != req.attempt:
                continue  # a buried replica's stale stream
            tokens = prog.get("tokens") or []
            merged = req._carried + [int(t) for t in tokens]
            if len(merged) > len(req.generated):
                if req.t_first is None:
                    req.t_first = now
                if req.t_requeue is not None and \
                        req.t_first_after_requeue is None:
                    req.t_first_after_requeue = now
                req.t_tokens.extend(
                    [now] * (len(merged) - len(req.generated)))
                req.generated = merged
            if prog.get("done"):
                self._finish(req, prog.get("finish_reason") or
                             "max_new_tokens")

    def _finish(self, req: FleetRequest, reason: str) -> None:
        self._inflight.pop(req.rid, None)
        if req.replica is not None:
            v = self._views.get(req.replica)
            if v is not None:
                v["outstanding"] = max(0, v["outstanding"] - 1)
        req.finish_reason = reason
        req.t_done = time.perf_counter()
        self.completed_total += 1
        self.registry.counter("fleet_completed_total",
                              {"reason": reason}).inc()
        req.done.set()

    # ------------------------------------------------------------- step ----
    def step(self) -> int:
        """One router iteration: membership/heartbeat sweep, progress
        ingestion, pending dispatch, then burial side effects
        (cold-start callbacks run OUTSIDE the lock — they spawn
        processes/threads and must not serialize routing). Rate-limited
        to one control-plane sweep per ``poll_s`` so a tight driver loop
        (loadgen's ``while has_work: step()``) cannot flood the tracker;
        returns the number of requests that completed."""
        now = time.monotonic()
        with self._lock:
            wait = self.poll_s - (now - self._last_poll)
        if wait > 0:
            # sleep OUTSIDE the lock: submit()/snapshot readers must not
            # block behind the poll pacing
            time.sleep(wait)
        spawn: List[str] = []
        with self._lock:
            self._last_poll = time.monotonic()
            before_failed = len(self.failed_replicas)
            done_before = self.completed_total
            self._refresh_membership(self._last_poll)
            spawn = self.failed_replicas[before_failed:]
            self._poll_progress()
            self._dispatch()
            completed = self.completed_total - done_before
        if self.cold_start is not None:
            for rid in spawn:
                self.cold_start(rid)
        return completed

    def run_until_idle(self, timeout_s: float = 300.0) -> None:
        deadline = time.monotonic() + timeout_s
        while self.has_work():
            if time.monotonic() > deadline:
                with self._lock:
                    in_flight, pending = (len(self._inflight),
                                          len(self._pending))
                raise TimeoutError(
                    f"fleet did not drain within {timeout_s}s "
                    f"({in_flight} in flight, {pending} pending)")
            self.step()

    def generate(self, prompt: Sequence[int], max_new_tokens: int = 16,
                 temperature: float = 0.0, eos_id: Optional[int] = None,
                 session: Optional[str] = None,
                 timeout: Optional[float] = None) -> List[int]:
        """Blocking convenience mirroring ``DecodeEngine.generate``:
        submit + wait (background loop running) or submit + drive
        inline."""
        req = self.submit(prompt, max_new_tokens=max_new_tokens,
                          temperature=temperature, eos_id=eos_id,
                          session=session)
        if self._thread is not None:
            if not req.done.wait(timeout):
                raise TimeoutError(
                    f"request {req.rid} did not finish within {timeout}s")
        else:
            deadline = (time.monotonic() + timeout
                        if timeout is not None else None)
            while not req.done.is_set():
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"request {req.rid} did not finish within "
                        f"{timeout}s")
                self.step()
        return list(req.generated)

    # -------------------------------------------------------- lifecycle ----
    def start(self) -> None:
        """Run the routing loop on a daemon thread (the front-end
        deployment shape: handler threads submit, one loop routes).
        ``step``'s internal poll pacing makes the loop one control-plane
        sweep per ``poll_s`` even when idle — membership sweeps (and
        death detection) continue between requests."""
        with self._lock:
            if self._thread is not None:
                return
            self._halt.clear()

            def loop():
                while not self._halt.is_set():
                    self.step()

            self._thread = threading.Thread(target=loop, daemon=True,
                                            name="fleet-router")
            self._thread.start()

    def stop(self) -> None:
        self._halt.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10)

    # --------------------------------------------------------- snapshot ----
    def fleet_snapshot(self) -> dict:
        """The GET ``/api/fleet`` view (``UiServer.attach_fleet``):
        per-replica health/load tables, the session-affinity table, and
        routing totals."""
        with self._lock:
            replicas = []
            for rid in sorted(self._views):
                v = self._views[rid]
                replicas.append({
                    "replica_id": rid, "state": v["state"],
                    "heartbeat_age_s": v.get("heartbeat_age_s"),
                    "queue_depth": v.get("queue_depth", 0),
                    "active_slots": v.get("active_slots", 0),
                    "slots": v.get("slots"),
                    "outstanding": v["outstanding"],
                    "dispatches": v.get("dispatches", 0),
                    "load": replica_load(v),
                    "weight_version": v.get("weight_version"),
                    "sessions": sum(1 for r in self._affinity.values()
                                    if r == rid),
                    "alerts_firing": v.get("alerts_firing"),
                })
            alive = [r for r in replicas if r["state"] == "alive"]
            depths = [float(r["queue_depth"]) for r in alive]
            mean = (sum(depths) / len(depths)) if depths else 0.0
            return {
                "replicas": replicas,
                "alive": len(alive),
                "affinity": dict(sorted(self._affinity.items())),
                "pending": len(self._pending),
                "in_flight": len(self._inflight),
                "requests_total": self.requests_total,
                "completed_total": self.completed_total,
                "requeued_total": self.requeued_total,
                "failed_replicas": list(self.failed_replicas),
                "queue_imbalance_ratio": (
                    (max(depths) / mean) if mean > 0 else 0.0),
            }
