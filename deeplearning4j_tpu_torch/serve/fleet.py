"""Counterpart of ``deeplearning4j_tpu/serve/fleet.py``: the fleet replica,
one ``DecodeEngine`` wrapped as a tracker worker, plus the ``python -m
deeplearning4j_tpu_torch.serve.fleet --replica`` process entry point.

A :class:`FleetReplica` is the serving twin of
``scaleout.distributed_runner``'s ``DistributedWorker``: it registers with
the tracker (``add_worker`` + ``fleet.replica.<id>`` info row),
heartbeats a ``hb.<id>`` counter on a SEPARATE tracker connection (a
wedged serve loop must not look alive), and runs a serve loop that (a)
claims request rows the :class:`~deeplearning4j_tpu_torch.serve.router.FleetRouter`
wrote under ``fleet.req.<id>.``, (b) drives ``engine.step()`` (each
admission's prefill runs the flash-attention kernel K3f on the card where
its bucket resolves to it), (c) streams token progress back under
``fleet.prog.<rid>``, and (d) on the publish cadence pushes its load row
(queue depth, slot occupancy, prefix-cache stats) plus the full registry
snapshot through ``telemetry.federation``. Rows and keys are the JAX
package's, so a JAX router drives a port replica.

Cold start is device to device: :meth:`FleetReplica.from_live_params`
adopts a params tree already in memory through
``DecodeEngine.from_live_params`` (every leaf copied onto the serving
device, never through the host), which is also how ``replica_main``
builds its engine, so a replacement spawned after a death goes init ->
copy -> serving with no checkpoint round trip.

``die()`` exists for chaos tests: it halts heartbeats and serving
abruptly (no deregistration, no farewell rows), exactly what the router
sees when a replica process takes a kill -9.

Each replica owns its engine, and so its KV cache and its sampling
``torch.Generator``; replicas in one process share nothing but the
params they were built from. ``--watch`` arms a watchtower
(``telemetry/alerts.arm_watchtower``) over the engine's registry: every
load publish ticks it, so SLO-burn verdicts ride the load row's
``alerts_firing`` and the tracker's alert rows. The replica's lock is the
``fleet.replica`` lockwatch seam (``utils.lockwatch.make_lock``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import threading
import time
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.serve.router import (
    HB_PREFIX,
    INFO_PREFIX,
    LOAD_PREFIX,
    PROG_PREFIX,
    REQ_PREFIX,
    _env_float,
)
from deeplearning4j_tpu_torch.utils.lockwatch import make_lock

log = logging.getLogger(__name__)


class FleetReplica:
    """Tracker-registered serving worker around one ``DecodeEngine``.

    ``tracker`` is an address string (``host:port``: two
    ``StateTrackerClient`` connections are opened, serve + heartbeat,
    as ``DistributedWorker`` does) or an in-process tracker object (unit
    tests; both loops then share it). ``start()`` spawns the serve and
    heartbeat threads; ``stop()`` deregisters and joins them; ``die()``
    is the in-process stand-in for kill -9. With ``watchtower=`` (a
    ``telemetry.alerts.Watchtower``) each load publish ticks it and the
    load row's ``alerts_firing`` counts its firing rules."""

    def __init__(self, engine, tracker, replica_id: str, *,
                 heartbeat_s: Optional[float] = None,
                 poll_s: Optional[float] = None,
                 publish_s: float = 0.25,
                 watchtower=None):
        from deeplearning4j_tpu_torch.telemetry.federation import (
            MetricsPusher,
        )

        self.engine = engine
        self.replica_id = str(replica_id)
        self.heartbeat_s = (heartbeat_s if heartbeat_s is not None else
                            _env_float("DL4J_TPU_FLEET_HEARTBEAT_S", 0.2))
        self.poll_s = (poll_s if poll_s is not None
                       else _env_float("DL4J_TPU_FLEET_POLL_S", 0.01))
        self.publish_s = float(publish_s)
        self._owns_trackers = isinstance(tracker, str)
        if self._owns_trackers:
            from deeplearning4j_tpu_torch.scaleout.remote_tracker import (
                StateTrackerClient,
            )

            self.tracker = StateTrackerClient(tracker,
                                              registry=engine.registry)
            self._hb_tracker = StateTrackerClient(tracker,
                                                  registry=engine.registry)
        else:
            self.tracker = tracker
            self._hb_tracker = tracker
        self.watchtower = watchtower
        self._pusher = MetricsPusher(self.tracker, self.replica_id,
                                     registry=engine.registry,
                                     interval_s=self.publish_s)
        self._lock = make_lock("fleet.replica")  # lockwatch seam
        # full request-row keys already claimed (rows outlive requests in
        # the KV — last-write-wins store, no deletes)
        self._claimed: set = set()
        # router rid -> (ServeRequest, attempt, tokens already published)
        self._serving: Dict[str, list] = {}
        self._stop = threading.Event()
        self._serve_thread: Optional[threading.Thread] = None
        self._hb_thread: Optional[threading.Thread] = None
        self._last_publish = 0.0
        self._alerts_firing = 0

    @classmethod
    def from_live_params(cls, params, n_heads: int, tracker,
                         replica_id: str, *, device=None,
                         engine_kwargs: Optional[dict] = None, **kwargs):
        """Device-to-device cold start: adopt a live params tree through
        ``DecodeEngine.from_live_params`` (CUDA unless ``device="cpu"``;
        raises without a card) and wrap the resulting engine as a fleet
        replica: the replacement-spawn path after a burial."""
        from deeplearning4j_tpu_torch.serve.engine import DecodeEngine

        engine = DecodeEngine.from_live_params(
            params, n_heads, device=device, **(engine_kwargs or {}))
        return cls(engine, tracker, replica_id, **kwargs)

    # ------------------------------------------------------ registration ----
    def _register(self) -> None:
        self.tracker.add_worker(self.replica_id)
        self._hb_tracker.increment(HB_PREFIX + self.replica_id)
        self.tracker.put_kv(INFO_PREFIX + self.replica_id, json.dumps({
            "replica_id": self.replica_id, "pid": os.getpid(),
            "started_unix": time.time(), "slots": self.engine.n_slots,
            "max_len": self.engine.max_len,
            "weight_version": self.engine.weight_version,
        }))
        self._publish_load()

    def _heartbeat_loop(self) -> None:
        # the DistributedWorker discipline: its own connection, transport
        # faults absorbed (a flapping master degrades liveness signal,
        # never kills the serving process)
        while not self._stop.wait(self.heartbeat_s):
            try:
                self._hb_tracker.increment(HB_PREFIX + self.replica_id)
            except (ConnectionError, OSError) as exc:
                log.warning("replica %s heartbeat failed (tracker "
                            "unreachable): %r", self.replica_id, exc)

    # ------------------------------------------------------------ serving ----
    def _claim_requests(self) -> None:
        prefix = f"{REQ_PREFIX}{self.replica_id}."
        try:
            rows = self.tracker.kv_snapshot(prefix)
        except (ConnectionError, OSError) as exc:
            log.warning("replica %s request poll failed: %r",
                        self.replica_id, exc)
            return
        for key in sorted(rows):
            if key in self._claimed:
                continue
            self._claimed.add(key)
            try:
                spec = json.loads(rows[key])
            except ValueError:
                continue
            kwargs = {"max_new_tokens": int(spec["max_new"]),
                      "temperature": float(spec.get("temperature", 0.0))}
            if spec.get("eos_id") is not None:
                kwargs["eos_id"] = int(spec["eos_id"])
            try:
                req = self.engine.submit(spec["prompt"], **kwargs)
            except ValueError as exc:
                # reject rows the engine cannot admit (oversized prompt,
                # bad tokens): the router sees a terminal progress row
                # instead of a hung request
                self.tracker.put_kv(PROG_PREFIX + spec["rid"], json.dumps({
                    "attempt": spec["attempt"], "tokens": [], "done": True,
                    "finish_reason": f"rejected: {exc}",
                    "replica": self.replica_id}))
                continue
            with self._lock:
                self._serving[spec["rid"]] = [req, spec["attempt"], -1]

    def _publish_progress(self) -> None:
        finished: List[str] = []
        with self._lock:
            serving = list(self._serving.items())
        for rid, entry in serving:
            req, attempt, published = entry
            n = len(req.generated)
            done = req.done.is_set()
            if n == published and not done:
                continue
            row = {"attempt": attempt, "tokens": list(req.generated),
                   "done": done, "finish_reason": req.finish_reason,
                   "replica": self.replica_id}
            try:
                self.tracker.put_kv(PROG_PREFIX + rid, json.dumps(row))
            except (ConnectionError, OSError) as exc:
                log.warning("replica %s progress push for %s failed: %r",
                            self.replica_id, rid, exc)
                continue  # next sweep retries; rows are idempotent
            entry[2] = n
            if done:
                finished.append(rid)
        if finished:
            with self._lock:
                for rid in finished:
                    self._serving.pop(rid, None)

    def _publish_load(self) -> None:
        stats = self.engine.stats()
        prefix_stats = stats.get("prefix_cache") or {}
        row = {
            "replica_id": self.replica_id, "ts": time.time(),
            "queue_depth": stats["queue_depth"],
            "active_slots": stats["active_slots"],
            "slots": stats["slots"],
            "weight_version": stats["weight_version"],
            "tokens_total": stats["tokens_total"],
            "requests_total": stats["requests_total"],
            "prefix_hit_rate": prefix_stats.get("hit_rate"),
            "alerts_firing": self._alerts_firing,
        }
        try:
            self.tracker.put_kv(LOAD_PREFIX + self.replica_id,
                                json.dumps(row))
        except (ConnectionError, OSError) as exc:
            log.warning("replica %s load publish failed: %r",
                        self.replica_id, exc)
        self._pusher.push_once()

    def _serve_loop(self) -> None:
        while not self._stop.is_set():
            self._claim_requests()
            worked = False
            if self.engine.has_work():
                self.engine.step()
                worked = True
            self._publish_progress()
            now = time.monotonic()
            if now - self._last_publish >= self.publish_s:
                self._last_publish = now
                if self.watchtower is not None:
                    self._alerts_firing = sum(
                        1 for a in self.watchtower.tick()
                        if a.get("state") == "firing")
                self._publish_load()
            if not worked:
                self._stop.wait(self.poll_s)

    # ---------------------------------------------------------- lifecycle ----
    def start(self) -> None:
        if self._serve_thread is not None:
            return
        self._stop.clear()
        self._register()
        self._serve_thread = threading.Thread(
            target=self._serve_loop, daemon=True,
            name=f"fleet-serve-{self.replica_id}")
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True,
            name=f"fleet-hb-{self.replica_id}")
        self._serve_thread.start()
        self._hb_thread.start()

    def die(self) -> None:
        """Abrupt in-process death: heartbeats and serving halt NOW, no
        deregistration, no final rows — the router must detect this off
        heartbeat staleness alone (chaos tests; real deployments die by
        signal)."""
        self._stop.set()
        serve, self._serve_thread = self._serve_thread, None
        hb, self._hb_thread = self._hb_thread, None
        if serve is not None:
            serve.join(timeout=10)
        if hb is not None:
            hb.join(timeout=10)

    def stop(self) -> None:
        """Graceful exit: halt loops, flush one last load row, leave the
        membership (the router forgets a deregistered replica once its
        outstanding work drains)."""
        self.die()
        try:
            self._publish_load()
            self.tracker.remove_worker(self.replica_id)
        except (ConnectionError, OSError):
            pass
        if self._owns_trackers:
            self.tracker.close()
            self._hb_tracker.close()


# -------------------------------------------------------------- process ----

def synthetic_params(spec: str, seed: int):
    """``V,D,H,E,DFF,L`` -> (params on the CPU, n_heads): ``init_lm_params``
    drawn from a CPU ``torch.Generator`` seeded with ``seed``, so the SAME
    seed gives the same weights on any host and device, which is what
    makes cross-process fleet output comparable to a single-engine
    oracle. The weights differ from the JAX package's (threefry) draws."""
    import torch

    from deeplearning4j_tpu_torch.models.transformer_lm import (
        init_lm_params,
    )

    dims = [int(x) for x in spec.split(",")]
    if len(dims) != 6:
        raise SystemExit(
            f"--synthetic wants V,D,H,E,DFF,L (6 ints), got {spec!r}")
    v, d, h, e, dff, layers = dims
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    return init_lm_params(gen, v, d, h, e, dff, n_layers=layers,
                          device="cpu"), h


def _serve_dtype(args):
    return None if args.serve_dtype in (None, "none") else args.serve_dtype


def _build_synthetic_engine(spec: str, seed: int, args) -> object:
    """A DecodeEngine over :func:`synthetic_params`, built through
    ``from_live_params`` onto ``args.device``, so even the CLI path goes
    device to device."""
    from deeplearning4j_tpu_torch.serve.engine import DecodeEngine

    params, h = synthetic_params(spec, seed)
    return DecodeEngine.from_live_params(
        params, h, n_slots=args.slots, max_len=args.max_len,
        serve_dtype=_serve_dtype(args), prefix_cache=args.prefix_cache,
        weight_version=f"synthetic-seed-{seed}", device=args.device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.serve.fleet",
        description="Serving-fleet replica process")
    p.add_argument("--replica", action="store_true", required=True,
                   help="run as a fleet replica (the only mode)")
    p.add_argument("--tracker", required=True, metavar="HOST:PORT",
                   help="StateTracker server address to register with")
    p.add_argument("--replica-id", default=None,
                   help="membership id (default: replica-<pid>)")
    p.add_argument("--synthetic", default=None, metavar="V,D,H,E,DFF,L",
                   help="serve a seeded synthetic LM of these dims")
    p.add_argument("--checkpoint", default=None, metavar="ROOT",
                   help="serve the latest committed checkpoint under ROOT")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-len", type=int, default=64)
    p.add_argument("--serve-dtype", default="none",
                   help='engine serve dtype ("none" = full precision)')
    p.add_argument("--prefix-cache", action="store_true")
    p.add_argument("--heartbeat-s", type=float, default=None)
    p.add_argument("--poll-s", type=float, default=None)
    p.add_argument("--publish-s", type=float, default=0.25)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the engine's device (default cuda)")
    p.add_argument("--watch", action="store_true",
                   help="arm a watchtower: SLO-burn verdicts ride the "
                        "load row's alerts_firing and the tracker's alert "
                        "rows")
    return p


def replica_main(argv=None) -> int:
    """Process entry point: build the engine, register, serve until the
    tracker declares the job done (or the master disappears). Prints
    ``FLEET_REPLICA_READY <id>`` once registered; spawners block on it.
    """
    from deeplearning4j_tpu_torch._device import resolve_device
    from deeplearning4j_tpu_torch.scaleout.remote_tracker import (
        TrackerUnavailable,
    )

    args = build_parser().parse_args(argv)
    if (args.synthetic is None) == (args.checkpoint is None):
        raise SystemExit("exactly one of --synthetic / --checkpoint")
    resolve_device(args.device)  # raises when CUDA is asked for and absent
    if args.synthetic is not None:
        engine = _build_synthetic_engine(args.synthetic, args.seed, args)
    else:
        from deeplearning4j_tpu_torch.serve.engine import DecodeEngine

        engine = DecodeEngine.from_checkpoint(
            args.checkpoint, n_slots=args.slots, max_len=args.max_len,
            serve_dtype=_serve_dtype(args), prefix_cache=args.prefix_cache,
            device=args.device)
    rid = args.replica_id or f"replica-{os.getpid()}"
    watchtower = None
    if args.watch:
        from deeplearning4j_tpu_torch.telemetry.alerts import arm_watchtower

        watchtower = arm_watchtower(registry=engine.registry,
                                    tracker_address=args.tracker,
                                    process=rid, start=False)
    replica = FleetReplica(engine, args.tracker, rid,
                           heartbeat_s=args.heartbeat_s,
                           poll_s=args.poll_s, publish_s=args.publish_s,
                           watchtower=watchtower)
    replica.start()
    print(f"FLEET_REPLICA_READY {rid}", flush=True)
    try:
        while True:
            try:
                if replica.tracker.is_done():
                    break
            except (TrackerUnavailable, ConnectionError, OSError):
                break  # master gone: nothing left to serve for
            time.sleep(0.25)
    except KeyboardInterrupt:
        pass
    replica.stop()
    if watchtower is not None:
        watchtower.stop()
    return 0


if __name__ == "__main__":
    sys.exit(replica_main())
