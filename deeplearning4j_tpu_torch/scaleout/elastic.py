"""Counterpart of ``deeplearning4j_tpu/scaleout/elastic.py``: elastic
multi-process parameter-averaging training.

SparkNet (arXiv:1511.06051) trains by running every worker's local SGD for a
fixed window and averaging parameters infrequently; DeepSpark
(arXiv:1602.08191) relaxes the barrier with a bounded-staleness knob. That
sync model is what makes elastic membership cheap: the only state a worker
uniquely owns is its *unsynced* delta, so a crashed worker costs one
round's local progress, never the run.

Topology: ``ElasticMaster`` embeds a ``StateTrackerServer`` (control plane:
membership, heartbeats, round counters) and shares a ``BlobStore`` (data
plane: parameter trees) with K ``ElasticWorker`` OS processes. Each worker
is one process on one device (CUDA unless the caller asks for the CPU) and
trains its local steps over a deterministic per-worker data stream.

Round protocol (global *versions* ``g = 0, 1, …``; version 0 is the initial
params, version ``g`` averages round ``g-1``'s contributions):

- worker: adopt the freshest committed global version, run ``sync_every``
  local steps, publish its params as the round-``r`` contribution, advance.
  With ``max_staleness = 0`` this is bulk-synchronous (wait for version
  ``r+1`` before round ``r+1``); with ``s > 0`` the worker keeps training on
  its local chain up to ``s`` rounds ahead of the last committed version,
  adopting the freshest global whenever one is available.
- master: a round commits when every *live* worker admitted at-or-before it
  has contributed; heartbeat-stale workers are deregistered mid-barrier, so
  a kill -9 turns into a shrunk survivor set, not a hung barrier. The
  commit averages all contributions received for the round (weighted by
  local step count, in sorted worker order), publishes the new version and
  bumps ``elastic.version``.

Membership: a worker that registers mid-run (rejoin or replacement) pulls
the current version's params and step and is admitted from the current
round (``admit.<wid>`` counter); earlier barriers never wait for it.
``min_workers`` picks degrade-vs-halt: the run continues on any survivor
set of at least ``min_workers`` and raises ``ElasticTrainingError`` below.

Numerical faults: the master gates every contribution on
``guardrails.tree_all_finite`` BEFORE it can reach ``average_trees``; a
NaN/Inf tree quarantines its worker through the bury path (excluded from
the barrier and from all later averaging; ``workers_quarantined`` counter,
``nonfinite`` barrier event and flight dump with ``nonfinite_report``).
Worker-side, ``SyntheticRegressionModel(guard=True)`` runs the guarded
update, so a poisoned batch is skipped inside the step.

Persistence: the master checkpoints the averaged params through
``scaleout.ckpt`` (``Checkpointer``, or ``AsyncCheckpointer`` to keep
snapshots off the aggregation thread) and ``resume()`` restarts from the
latest committed version.

Tracing: with a process tracer configured (``telemetry.trace``; the worker
CLI's ``--trace-dir`` or ``ElasticMaster(trace_dir=...)``) the protocol is
spanned end to end: master ``elastic.train`` / ``elastic.round`` /
``elastic.barrier`` (arrivals, burials and quarantines as events) /
``elastic.average`` / ``elastic.checkpoint``, worker ``worker.join`` /
``worker.round`` → ``worker.steps`` / ``worker.publish`` /
``worker.sync_wait``. The master's round-span context rides every published
global blob's meta, so worker round spans parent under the master round
that collects them. Both sides checkpoint the flight recorder at round
boundaries (write-ahead: a kill -9 still leaves the previous boundary's
dump and begin-records of the spans it left open) and dump it on error.

Watch: ``ElasticMaster(watch=True)`` and the worker CLI's ``--watch-dir``
arm ``telemetry.alerts.arm_watchtower``; the default rules
``worker_divergence``, ``worker_heartbeat_stale`` and
``nonfinite_step_rate`` read the registry names this module emits.

Blobs are npz bytes in the JAX package's layout (``leaf_<i>``,
``__paths__`` as keystr JSON, ``__meta__``), so a JAX worker can train
against a port master and the other way round. Locks are plain
``threading`` primitives (the lock-order watchdog is ROADMAP item 21d).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import logging
import os
import threading
import time
import uuid
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import (
    DeviceLike,
    keystr,
    resolve_device,
    tree_leaves,
    tree_paths,
    tree_unflatten,
    tree_zip_map,
)
from deeplearning4j_tpu_torch.optimize.guardrails import (
    _host,
    _read_tree_bytes,
    _tree_to_bytes,
)
from deeplearning4j_tpu_torch.scaleout.blobstore import BlobStore, open_store
from deeplearning4j_tpu_torch.scaleout.remote_tracker import (
    StateTrackerClient,
    StateTrackerServer,
    TrackerUnavailable,
)
from deeplearning4j_tpu_torch.telemetry import trace as _trace

log = logging.getLogger(__name__)

VERSION_KEY = "elastic.version"

_RUNTIME_PROFILING = ("{} comes with ROADMAP item 21a-ii (sessions, "
                      "runtime and compile-time profiling)")


class ElasticTrainingError(RuntimeError):
    """The run can no longer make progress (survivor set below
    ``min_workers``, or a round barrier timed out with no contributions)."""


# --------------------------------------------------------------- trees ----

def tree_to_bytes(tree, meta: Optional[Dict] = None) -> bytes:
    """Serialize a tree of tensor or array leaves (+ JSON-able meta) to
    npz bytes keyed by keystr path, the JAX package's layout. The writer
    is the one replay bundles use (``optimize.guardrails``)."""
    return _tree_to_bytes(tree, meta)


def tree_from_bytes(data: bytes, template) -> Tuple[object, Dict]:
    """Rebuild ``(tree, meta)`` from ``tree_to_bytes`` output (or the JAX
    package's) into the structure of ``template``, numpy leaves. Strict:
    the saved paths must be exactly the template's, in order."""
    paths, leaves, meta = _read_tree_bytes(data)
    want = [keystr(p) for p in tree_paths(template)]
    if want != paths:
        raise ValueError(
            f"elastic tree structure mismatch: payload has {paths}, "
            f"template expects {want}")
    return tree_unflatten(template, leaves), meta


def average_trees(trees: List, weights: List[float]):
    """Weighted parameter average, deterministic: float64 accumulation in
    the caller's order, cast back to each leaf's dtype, numpy leaves. The
    master and ``simulate_elastic`` both go through it, and its arithmetic
    is the JAX package's, operation for operation."""
    if not trees:
        raise ValueError("cannot average zero contributions")
    total = float(sum(weights))
    flats = [[_host(x) for x in tree_leaves(t)] for t in trees]
    out = []
    for i in range(len(flats[0])):
        acc = np.zeros_like(np.asarray(flats[0][i], np.float64))
        for leaves, w in zip(flats, weights):
            acc += np.asarray(leaves[i], np.float64) * (w / total)
        out.append(acc.astype(flats[0][i].dtype))
    return tree_unflatten(trees[0], out)


def _host_tree(tree):
    """Every leaf as a host numpy array."""
    return tree_unflatten(tree, [_host(x) for x in tree_leaves(tree)])


def _draw_seed(*ints: int) -> int:
    """A fixed integer function of ``ints`` (numpy's SeedSequence hash),
    the seed of one CPU ``torch.Generator`` draw: the same numbers give
    the same draw in every process and on every device."""
    return int(np.random.SeedSequence([int(i) for i in ints])
               .generate_state(1, np.uint64)[0] >> 1)


# --------------------------------------------------------------- model ----

class ElasticModel:
    """What a worker trains. ``run_steps`` owns the device and data
    details; the framework only moves host trees around it."""

    def init_params(self):
        raise NotImplementedError

    def run_steps(self, params, start_step: int, n_steps: int,
                  worker_seed: int):
        """Advance ``params`` by ``n_steps`` local steps whose data stream
        is a pure function of ``(worker_seed, step_index)``, so a
        survivor's trajectory is identical whether or not other workers
        exist. Returns ``(host params, last_loss: float)``."""
        raise NotImplementedError


# stream tags of the model's draws
_INIT, _TEACHER, _BATCH = 0, 1, 2


class SyntheticRegressionModel(ElasticModel):
    """Teacher-student regression with a tanh MLP, ``h = tanh(x @ w1 +
    b1)``, loss ``mean((h @ w2 - y)^2)``, trained by torch autograd on
    ``device`` (CUDA unless ``device="cpu"``): the reference workload of
    the elastic tests. Deterministic end to end: ``init_params`` and
    ``_batch_for(worker_seed, step)`` draw from a CPU ``torch.Generator``
    seeded by a fixed function of ``(seed, worker_seed, step)``; those two
    methods are the draw points (tests override them with JAX's draws).

    ``guard=True`` (``clip_norm``) runs ``guarded_sgd_update``; skips are
    counted on ``self.skipped_steps`` and the registry's
    ``guard_skipped_steps_total``. ``nan_at_step`` poisons one element of
    that global step's batch (only ``nan_worker_seed``'s when set), a pure
    function of ``(worker_seed, step)``, so ``simulate_elastic`` with the
    same knobs stays an exact oracle. ``optimizer=`` (a name or an
    ``optimize.updaters.OptimizerConfig``) swaps SGD for the stateful
    update; the moments live on the instance across ``run_steps`` calls
    (local optimizer state under parameter averaging) and compose with
    ``guard=True`` (a skipped step carries the moments bitwise).

    ``mesh_devices`` is kept for the JAX package's factories and
    ``--kwargs-json`` lines: there it splits the batch over a host's
    devices and takes the same mean. A worker here is one process on one
    device, so it changes no number. With ``update_sharding="sharded"``
    the moments live in the ZeRO layout over a one-rank "data" mesh
    (every leaf one row); Adam's arithmetic is the replicated one's.

    ``profile=`` and a truthy ``runprof=`` raise ``NotImplementedError``
    (ROADMAP item 21a-ii)."""

    def __init__(self, d_in: int = 8, d_hidden: int = 16, batch: int = 32,
                 lr: float = 0.05, seed: int = 0, mesh_devices: int = 2,
                 guard: bool = False, clip_norm: Optional[float] = None,
                 nan_at_step: Optional[int] = None,
                 nan_worker_seed: Optional[int] = None,
                 profile: bool = False, optimizer=None, runprof=None,
                 device: DeviceLike = None):
        if profile or runprof:
            raise NotImplementedError(_RUNTIME_PROFILING.format(
                "a profiled elastic step (profile=, runprof=)"))
        self.device = resolve_device(device)
        self.d_in, self.d_hidden = int(d_in), int(d_hidden)
        self.batch, self.lr, self.seed = int(batch), float(lr), int(seed)
        self.mesh_devices = int(mesh_devices)
        self.guard = bool(guard)
        self.clip_norm = clip_norm
        self.nan_at_step = nan_at_step
        self.nan_worker_seed = nan_worker_seed
        self.optimizer = optimizer
        self.skipped_steps = 0
        self._built = False
        self._opt_state = None
        self._teacher_w: Optional[torch.Tensor] = None

    # -- draw points --
    def _gen(self, *ints: int) -> torch.Generator:
        return torch.Generator().manual_seed(_draw_seed(self.seed, *ints))

    def init_params(self):
        """``{"w1", "b1", "w2"}`` on the model's device: normal weights
        scaled by 1/sqrt(d_in), a zero bias."""
        g = self._gen(_INIT)
        scale = 1.0 / np.sqrt(self.d_in)
        w1 = torch.randn(self.d_in, self.d_hidden, generator=g) * scale
        w2 = torch.randn(self.d_hidden, 1, generator=g) * scale
        return {"w1": w1.to(self.device),
                "b1": torch.zeros(self.d_hidden, device=self.device),
                "w2": w2.to(self.device)}

    def _teacher(self) -> torch.Tensor:
        if self._teacher_w is None:
            self._teacher_w = torch.randn(self.d_in, 1,
                                          generator=self._gen(_TEACHER))
        return self._teacher_w

    def _batch_for(self, worker_seed: int, step_index: int):
        """``(x, y)`` as float32 numpy arrays of the global step
        ``step_index`` of worker ``worker_seed``."""
        x = torch.randn(self.batch, self.d_in,
                        generator=self._gen(_BATCH, worker_seed, step_index))
        y = (x @ self._teacher()).numpy()
        x = x.numpy()
        if (self.nan_at_step is not None
                and int(step_index) == int(self.nan_at_step)
                and (self.nan_worker_seed is None
                     or int(worker_seed) == int(self.nan_worker_seed))):
            x = x.copy()
            x[0, 0] = np.nan
        return x, y

    # -- the step --
    @staticmethod
    def _loss_of(p, x, y):
        h = torch.tanh(x @ p["w1"] + p["b1"])
        return torch.mean((h @ p["w2"] - y) ** 2)

    def _guard_config(self):
        if not self.guard:
            return None
        from deeplearning4j_tpu_torch.optimize.guardrails import GuardConfig

        return GuardConfig(clip_norm=self.clip_norm)

    def _build(self, params) -> None:
        """Resolve the optimizer policy and its moments (on the first
        ``run_steps``, from the params it gets)."""
        from deeplearning4j_tpu_torch.optimize.updaters import (
            OptimizerConfig,
            ZeroSharding,
            init_opt_state,
        )
        from deeplearning4j_tpu_torch.parallel.mesh import DATA_AXIS, Mesh

        self._guard_cfg = self._guard_config()
        cfg = OptimizerConfig.coerce(self.optimizer)
        self._opt_cfg = cfg.resolved() if cfg is not None else None
        self._zero = None
        if self._opt_cfg is not None:
            if self._opt_cfg.sharded:
                self._zero = ZeroSharding(Mesh((DATA_AXIS,), (1,)),
                                          DATA_AXIS)
            if self._opt_state is None:
                self._opt_state = init_opt_state(self._opt_cfg, params,
                                                 self._zero)
        self._built = True

    def _step(self, params, x, y):
        """One local step: ``(params, loss, nonfinite flag or None)``."""
        leaves = [p.detach().requires_grad_(True) for p in
                  tree_leaves(params)]
        live = tree_unflatten(params, leaves)
        loss = self._loss_of(live, x, y)
        grads = tree_unflatten(params, list(torch.autograd.grad(loss,
                                                                leaves)))
        loss = loss.detach()
        with torch.no_grad():
            params = tree_unflatten(params, [p.detach() for p in leaves])
            if self._opt_cfg is not None:
                from deeplearning4j_tpu_torch.optimize.updaters import (
                    guarded_opt_update,
                    opt_update_shardmap,
                )

                if self._guard_cfg is None:
                    params, self._opt_state = opt_update_shardmap(
                        self._opt_cfg, params, grads, self._opt_state,
                        self.lr, self._zero)
                    return params, loss, None
                params, self._opt_state, gm = guarded_opt_update(
                    params, grads, self._opt_state, loss, self.lr,
                    self._opt_cfg, self._guard_cfg, zero=self._zero)
                return params, loss, gm["nonfinite"]
            if self._guard_cfg is None:
                return (tree_zip_map(lambda p, g: p - self.lr * g, params,
                                     grads), loss, None)
            from deeplearning4j_tpu_torch.optimize.guardrails import (
                guarded_sgd_update,
            )

            params, gm = guarded_sgd_update(params, grads, loss, self.lr,
                                            self._guard_cfg)
            return params, loss, gm["nonfinite"]

    def _on_device(self, params):
        """``params`` on the model's device: tensors already there are
        used as they are (the carried tree, an in-process adoption), host
        arrays from a blob are moved once."""
        leaves = tree_leaves(params)
        if leaves and all(isinstance(x, torch.Tensor)
                          and x.device == self.device for x in leaves):
            return params
        return tree_unflatten(params, [
            torch.tensor(_host(x), device=self.device) for x in leaves])

    def eval_loss(self, params, n_batches: int = 8,
                  eval_seed: int = 10_007) -> float:
        """Deterministic held-out MSE over ``n_batches`` batches of the
        stream ``eval_seed``."""
        p = self._on_device(params)
        total = 0.0
        with torch.no_grad():
            for i in range(int(n_batches)):
                x, y = self._batch_for(eval_seed, i)
                total += float(self._loss_of(
                    p, torch.tensor(x, device=self.device),
                    torch.tensor(y, device=self.device)))
        return total / n_batches

    def run_steps(self, params, start_step: int, n_steps: int,
                  worker_seed: int):
        params = self._on_device(params)
        if not self._built:
            self._build(params)
        loss = None
        flags = []  # device scalars; ONE fetch after the loop
        for i in range(int(n_steps)):
            x, y = self._batch_for(worker_seed, start_step + i)
            params, loss, nf = self._step(
                params, torch.tensor(x, device=self.device),
                torch.tensor(y, device=self.device))
            if nf is not None:
                flags.append(nf)
        host = _host_tree(params)
        if flags:
            skipped = int(sum(float(v) for v in torch.stack(flags).cpu()))
            self.skipped_steps += skipped
            if skipped:
                # the nonfinite_step_rate alert rule's counter, in the
                # process registry a worker-side watchtower samples
                from deeplearning4j_tpu_torch.telemetry.registry import (
                    default_registry,
                )

                default_registry().counter(
                    "guard_skipped_steps_total").inc(skipped)
        return host, (float(loss) if loss is not None else float("nan"))


def synthetic_regression_model(**kwargs) -> SyntheticRegressionModel:
    """CLI factory (``--model deeplearning4j_tpu_torch.scaleout.elastic:
    synthetic_regression_model``)."""
    return SyntheticRegressionModel(**kwargs)


def synthetic_replay(**kwargs):
    """``tools/step_replay.py`` factory for SyntheticRegressionModel replay
    bundles (``--factory deeplearning4j_tpu_torch.scaleout.elastic:
    synthetic_replay --kwargs-json '{"device": "cpu"}'``): re-executes the
    faulting step's loss and grad from a payload of ``{"params": ...,
    "batch": {"x", "y"}}`` with the training loss, so a non-finite result
    reproduces."""
    from deeplearning4j_tpu_torch.telemetry.metrics import global_norm

    model = SyntheticRegressionModel(**kwargs)

    def run(payload: Dict) -> Dict:
        p = model._on_device(payload["params"])
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(p)]
        x = torch.tensor(np.asarray(payload["batch"]["x"]),
                         device=model.device)
        y = torch.tensor(np.asarray(payload["batch"]["y"]),
                         device=model.device)
        loss = model._loss_of(tree_unflatten(p, leaves), x, y)
        grads = torch.autograd.grad(loss, leaves)
        return {"loss": float(loss),
                "grad_norm": float(global_norm(list(grads)))}

    return run


# ---------------------------------------------------------- blob layout ----

def _global_key(version: int) -> str:
    return f"elastic/global/round_{int(version):06d}.npz"


def _contrib_key(rnd: int, worker_id: str) -> str:
    return f"elastic/contrib/round_{int(rnd):06d}/{worker_id}.npz"


# --------------------------------------------------------------- worker ----

class ElasticWorker:
    """One elastic training process: register → adopt global params →
    ``sync_every`` local steps → publish contribution → repeat.

    Every tracker interaction goes through ``StateTrackerClient`` (timeouts
    and idempotent retries); a ``TrackerUnavailable`` in the main loop is
    absorbed as a stall (reconnect, re-register, continue), bounded by
    ``round_timeout_s``, so a master restart or a flaky link degrades
    throughput instead of killing the worker. The heartbeat thread has its
    own connection and is joined on exit. Without ``worker_seed`` the
    stream's seed is the CRC32 of the worker id."""

    def __init__(self, address: str, blob_uri: str, model: ElasticModel,
                 worker_id: Optional[str] = None, sync_every: int = 4,
                 max_staleness: int = 0, worker_seed: Optional[int] = None,
                 poll_s: float = 0.02, heartbeat_s: float = 0.25,
                 round_timeout_s: float = 60.0,
                 request_timeout_s: float = 5.0,
                 crash_at_round: Optional[int] = None,
                 crash_after_steps: int = 1):
        self.address = address
        self.blob: BlobStore = open_store(blob_uri)
        self.model = model
        self.worker_id = worker_id or f"ew-{uuid.uuid4().hex[:8]}"
        self.sync_every = max(1, int(sync_every))
        self.max_staleness = max(0, int(max_staleness))
        self.worker_seed = (int(worker_seed) if worker_seed is not None
                            else zlib.crc32(self.worker_id.encode())
                            % (1 << 31))
        self.poll_s = poll_s
        self.heartbeat_s = heartbeat_s
        self.round_timeout_s = round_timeout_s
        self.request_timeout_s = request_timeout_s
        # fault injection (tests): hard-exit (os._exit, no cleanup) after
        # ``crash_after_steps`` LOCAL steps of round ``crash_at_round`` —
        # mid-round, before that round's contribution is published
        self.crash_at_round = crash_at_round
        self.crash_after_steps = max(0, int(crash_after_steps))
        self.tracker: Optional[StateTrackerClient] = None
        self.round = 0          # next round this worker will contribute to
        self.local_step = 0
        # trace context of the master round span that published the last
        # adopted global version: the parent of this worker's round spans
        self._master_ctx: Optional[Dict] = None

    # -- tracker plumbing --
    def _connect(self) -> StateTrackerClient:
        return StateTrackerClient(self.address, timeout=10.0,
                                  request_timeout_s=self.request_timeout_s)

    def _register(self) -> None:
        t = self.tracker
        t.add_worker(self.worker_id)
        t.increment(f"hb.{self.worker_id}")

    def _heartbeat_loop(self, stop: threading.Event) -> None:
        # its own connection: the main loop's RPCs (and its stalls) never
        # delay the liveness signal the master watches
        try:
            hb = self._connect()
        except (ConnectionError, OSError) as exc:
            log.warning("worker %s heartbeat connect failed: %r; running "
                        "without a liveness signal", self.worker_id, exc)
            return
        try:
            while not stop.is_set():
                hb.increment(f"hb.{self.worker_id}")
                stop.wait(self.heartbeat_s)
        except (ConnectionError, OSError) as exc:
            log.warning("worker %s heartbeat loop died: %r",
                        self.worker_id, exc)
            return
        finally:
            hb.close()

    # -- protocol steps --
    def _committed_version(self) -> int:
        return int(self.tracker.count(VERSION_KEY))

    def _adopt(self, version: int, template):
        data = self.blob.try_get(_global_key(version))
        if data is None:
            return None
        return tree_from_bytes(data, template)

    def _wait_version_at_least(self, version: int, deadline: float) -> int:
        while True:
            if self.tracker.is_done():
                return -1
            v = self._committed_version()
            if v >= version:
                return v
            if time.monotonic() > deadline:
                raise ElasticTrainingError(
                    f"worker {self.worker_id}: global version {version} not "
                    f"committed within {self.round_timeout_s}s (stuck at {v})")
            time.sleep(self.poll_s)

    def _publish(self, rnd: int, params, loss: float) -> None:
        self.blob.put(_contrib_key(rnd, self.worker_id), tree_to_bytes(
            params, {"round": rnd, "worker": self.worker_id,
                     "n_steps": self.sync_every, "loss": loss}))
        # signal AFTER the atomic blob publish: a counter without a blob
        # can never be observed
        self.tracker.increment(f"contrib.{rnd}.{self.worker_id}")

    def run(self) -> Dict:
        """Train until the master finishes. Returns a summary dict (the
        final round and local step)."""
        self.tracker = self._connect()
        template = self.model.init_params()
        stop = threading.Event()
        hb = threading.Thread(target=self._heartbeat_loop, args=(stop,),
                              daemon=True)
        tracer = _trace.get_tracer()
        try:
            # join at the CURRENT version: the rejoin path and the cold
            # start are the same code
            with _trace.maybe_span("worker.join",
                                   attrs={"worker": self.worker_id}):
                v = self._committed_version()
                adopted = None
                deadline = time.monotonic() + self.round_timeout_s
                while adopted is None:
                    adopted = self._adopt(v, template)
                    if adopted is None:
                        if time.monotonic() > deadline:
                            raise ElasticTrainingError(
                                f"worker {self.worker_id}: no global params "
                                f"blob for version {v}")
                        time.sleep(self.poll_s)
                params, meta = adopted
                self._master_ctx = meta.get("trace")
                self.round = v
                self.local_step = int(meta.get("step", v * self.sync_every))
                if v > 0:
                    self.tracker.increment("elastic.joined")
                self.tracker.increment(f"admit.{self.worker_id}", float(v))
                self._register()
            hb.start()
            if tracer is not None:
                # write-ahead dump: a round-0 kill -9 still leaves this
                tracer.flight_checkpoint(extra={"event": "registered",
                                                "worker": self.worker_id,
                                                "round": self.round})
            self._run_rounds(params, template)
            return {"worker_id": self.worker_id, "round": self.round,
                    "step": self.local_step}
        except BaseException as exc:
            if tracer is not None:
                tracer.dump(type(exc).__name__, error=exc,
                            extra={"worker": self.worker_id,
                                   "round": self.round,
                                   "step": self.local_step})
            raise
        finally:
            stop.set()
            if hb.ident is not None:  # started: wait for its last RPC so
                hb.join(timeout=10)   # teardown never races hb.close()
            if self.tracker is not None:
                self.tracker.close()

    def _run_rounds(self, params, template):
        last_ok = time.monotonic()
        while True:
            # re-read per round: tracing can be switched mid-run
            tracer = _trace.get_tracer()
            try:
                if self.tracker.is_done():
                    return params
                # adopt the freshest committed version not yet seen; jump
                # forward if the cluster moved on without us
                v = self._committed_version()
                if v >= self.round:
                    adopted = self._adopt(v, template)
                    if adopted is not None:
                        params, meta = adopted
                        self._master_ctx = meta.get("trace")
                        self.round = v
                        self.local_step = int(
                            meta.get("step", v * self.sync_every))
                rnd = self.round
                # the round span parents under the master round span that
                # published the adopted version; a crash inside the
                # ``with`` skips __exit__, leaving the begin-record on disk
                # as an OPEN span for trace_report
                round_cm = (tracer.span(
                                "worker.round",
                                parent=self._master_ctx or False,
                                attrs={"round": rnd,
                                       "worker": self.worker_id,
                                       "start_step": self.local_step})
                            if tracer is not None
                            else contextlib.nullcontext())
                with round_cm:
                    if self.crash_at_round is not None and \
                            rnd >= self.crash_at_round:
                        with _trace.maybe_span(
                                "worker.steps",
                                attrs={"round": rnd,
                                       "n_steps": self.crash_after_steps}):
                            params, _ = self.model.run_steps(
                                params, self.local_step,
                                self.crash_after_steps, self.worker_seed)
                        os._exit(23)  # kill -9 analogue: mid-round, unsynced
                    with _trace.maybe_span(
                            "worker.steps",
                            attrs={"round": rnd,
                                   "start_step": self.local_step,
                                   "n_steps": self.sync_every}) as ssp:
                        params, loss = self.model.run_steps(
                            params, self.local_step, self.sync_every,
                            self.worker_seed)
                        if ssp is not None:
                            ssp.set_attr("loss", float(loss))
                    self.local_step += self.sync_every
                    with _trace.maybe_span(
                            "worker.publish",
                            attrs={"round": rnd, "worker": self.worker_id}):
                        self._publish(rnd, params, loss)
                    self.round = rnd + 1
                    # staleness window: block only once our lead over the
                    # committed version exceeds max_staleness
                    with _trace.maybe_span(
                            "worker.sync_wait",
                            attrs={"round": rnd,
                                   "wait_for_version":
                                       self.round - self.max_staleness}):
                        got = self._wait_version_at_least(
                            self.round - self.max_staleness,
                            time.monotonic() + self.round_timeout_s)
                if tracer is not None:
                    tracer.flight_checkpoint(
                        extra={"worker": self.worker_id, "round": self.round,
                               "step": self.local_step})
                if got < 0:
                    return params
                last_ok = time.monotonic()
            except TrackerUnavailable:
                # master restart / dropped link: stall, reconnect,
                # re-register (idempotent), carry on from local state,
                # bounded by round_timeout_s
                if time.monotonic() - last_ok > self.round_timeout_s:
                    raise
                time.sleep(self.poll_s * 5)
                try:
                    self.tracker.close()
                    self.tracker = self._connect()
                    self._register()
                except (ConnectionError, OSError):
                    continue


# --------------------------------------------------------------- master ----

class ElasticMaster:
    """The elastic counterpart of ``distributed_runner.DistributedMaster``:
    embeds the tracker server, owns the blob store, commits averaging
    rounds over whatever survivor set is alive, and checkpoints the
    averaged params (a host tree). ``train(rounds)`` returns the final
    averaged tree. ``watch=True`` arms a watchtower over ``registry``
    publishing into the embedded tracker (``watch_dir``: its history and
    alert JSONL); ``shutdown()`` ticks and stops it."""

    def __init__(self, model: ElasticModel, blob_uri: str,
                 sync_every: int = 4, min_workers: int = 1,
                 worker_timeout_s: float = 5.0,
                 register_timeout_s: float = 60.0,
                 round_timeout_s: float = 120.0, tick_s: float = 0.01,
                 checkpointer=None, checkpoint_every: int = 0,
                 registry=None, trace_dir: Optional[str] = None,
                 watch: bool = False, watch_dir: Optional[str] = None):
        from deeplearning4j_tpu_torch.telemetry.registry import (
            default_registry,
        )

        # adopt the process tracer if one is configured; trace_dir here
        # configures one (process name "master") with crash hooks
        self.tracer = _trace.get_tracer()
        if trace_dir is not None and self.tracer is None:
            self.tracer = _trace.configure("master", trace_dir)
        self._run_span = None
        self._round_span = None
        self.server = StateTrackerServer()
        self.tracker = self.server.tracker  # embedded: zero-IPC master side
        self.blob_uri = blob_uri
        self.blob = open_store(blob_uri)
        self.model = model
        self.sync_every = max(1, int(sync_every))
        self.min_workers = max(1, int(min_workers))
        self.worker_timeout_s = worker_timeout_s
        self.register_timeout_s = register_timeout_s
        self.round_timeout_s = round_timeout_s
        self.tick_s = tick_s
        self.checkpointer = checkpointer
        self.checkpoint_every = int(checkpoint_every)
        self.registry = registry if registry is not None else default_registry()
        self.version = 0
        self._params = _host_tree(self.model.init_params())
        self._template = self._params  # the tree's layout, for restore
        self._hb_seen: Dict[str, tuple] = {}
        self._admit: Dict[str, int] = {}
        # a contribution with any non-finite leaf is excluded from the
        # average and its worker buried, sticky for the run
        self._quarantined: set = set()
        self.watchtower = None
        if watch:
            from deeplearning4j_tpu_torch.telemetry.alerts import (
                arm_watchtower,
            )

            self.watchtower = arm_watchtower(
                registry=self.registry, tracker=self.tracker,
                process="master", out_dir=watch_dir)
        self._publish_version(self.version, self._params)

    # -- plumbing --
    @property
    def address(self) -> str:
        return self.server.address

    def _publish_version(self, version: int, params) -> None:
        meta = {"version": version, "step": version * self.sync_every}
        if self.tracer is not None:
            if self._run_span is None:
                self._run_span = self.tracer.start_span(
                    "elastic.train", parent=False,
                    attrs={"sync_every": self.sync_every,
                           "min_workers": self.min_workers})
            # the span for round ``version`` opens when version ``version``
            # is published and closes when version+1 commits; its context
            # rides the blob meta so worker round spans parent under it
            if self._round_span is not None:
                self._round_span.end()
            self._round_span = self.tracer.start_span(
                "elastic.round", parent=self._run_span,
                attrs={"round": version})
            meta["trace"] = self._round_span.context()
        self.blob.put(_global_key(version), tree_to_bytes(params, meta))
        # the counter IS the committed-version number; a resume can jump it
        # by more than one
        behind = version - self.tracker.count(VERSION_KEY)
        if behind > 0:
            self.tracker.increment(VERSION_KEY, float(behind))
        self.registry.gauge("elastic_version").set(float(version))

    def _live_workers(self) -> List[str]:
        return list(self.tracker.workers())

    def _dead_workers(self) -> List[str]:
        now = time.monotonic()
        dead = []
        for wid in self._live_workers():
            count = self.tracker.count(f"hb.{wid}")
            seen = self._hb_seen.get(wid)
            if seen is None or seen[0] != count:
                self._hb_seen[wid] = (count, now)
                # the absence rule's convention: a *_unix gauge per worker
                # (worker_heartbeat_stale checks it for staleness)
                self.registry.gauge("elastic_worker_heartbeat_unix",
                                    {"worker": wid}).set(time.time())
            elif now - seen[1] > self.worker_timeout_s:
                dead.append(wid)
        return dead

    def _retire(self, wid: str) -> None:
        """Out of the membership and the heartbeat watch; the heartbeat
        series takes the -1 sentinel (a handled worker stops the
        staleness alert)."""
        self.tracker.remove_worker(wid)
        self._hb_seen.pop(wid, None)
        self.registry.gauge("elastic_worker_heartbeat_unix",
                            {"worker": wid}).set(-1.0)

    def _bury(self, wid: str) -> None:
        self._retire(wid)
        self.tracker.increment("workers_failed")
        self.registry.counter("elastic_workers_failed_total").inc()
        log.warning("elastic worker %s heartbeat stale >%ss: deregistered; "
                    "continuing on the survivor set", wid,
                    self.worker_timeout_s)

    def _admit_round(self, wid: str) -> int:
        if wid not in self._admit:
            self._admit[wid] = int(self.tracker.count(f"admit.{wid}"))
            if self._admit[wid] > 0:
                self.registry.counter("elastic_workers_joined_total").inc()
        return self._admit[wid]

    def _contributions(self, rnd: int) -> Dict[str, tuple]:
        """(tree, n_steps) per worker with a committed contribution blob
        for ``rnd``: includes workers that died after publishing (their
        synced work is kept), never a quarantined worker's."""
        out: Dict[str, tuple] = {}
        signals = self.tracker.counters_snapshot(f"contrib.{rnd}.")
        for key, val in signals.items():
            if val <= 0:
                continue
            wid = key[len(f"contrib.{rnd}."):]
            if wid in self._quarantined:
                continue
            data = self.blob.try_get(_contrib_key(rnd, wid))
            if data is None:
                continue  # signal raced the (atomic) blob publish; re-poll
            tree, meta = tree_from_bytes(data, self._template)
            out[wid] = (tree, float(meta.get("n_steps", self.sync_every)))
        return out

    def _quarantine(self, wid: str, rnd: int, barrier_sp=None) -> None:
        """The bury path for NUMERICAL faults: a worker whose round-``rnd``
        contribution carries NaN/Inf leaves the membership and every later
        average (sticky: replace the process to rejoin). Recorded as the
        ``nonfinite`` barrier event and a flight dump naming the poisoned
        leaves."""
        from deeplearning4j_tpu_torch.optimize.guardrails import (
            nonfinite_report,
        )

        self._quarantined.add(wid)
        self._retire(wid)
        self.tracker.increment("workers_quarantined")
        self.registry.counter("elastic_workers_quarantined_total").inc()
        log.error("elastic worker %s published a NON-FINITE contribution "
                  "for round %s: quarantined (excluded from averaging and "
                  "the round barrier for the rest of the run)", wid, rnd)
        if barrier_sp is not None:
            barrier_sp.add_event("nonfinite", worker=wid, round=rnd)
        if self.tracer is not None:
            data = self.blob.try_get(_contrib_key(rnd, wid))
            report = []
            if data is not None:
                tree, _meta = tree_from_bytes(data, self._template)
                report = [e for e in nonfinite_report(tree)
                          if e.get("nonfinite")]
            self.tracer.dump("nonfinite",
                             extra={"worker": wid, "round": int(rnd),
                                    "poisoned_leaves": report})

    # -- lifecycle --
    def wait_for_workers(self, n: Optional[int] = None) -> None:
        need = n if n is not None else self.min_workers
        deadline = time.monotonic() + self.register_timeout_s
        while len(self._live_workers()) < need:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{len(self._live_workers())}/{need} elastic workers "
                    f"registered within {self.register_timeout_s}s")
            time.sleep(0.05)

    def _maybe_checkpoint(self, version: int) -> None:
        if (self.checkpointer is None or self.checkpoint_every <= 0
                or version % self.checkpoint_every):
            return
        ck_cm = (self.tracer.span("elastic.checkpoint",
                                  parent=self._round_span,
                                  attrs={"version": version})
                 if self.tracer is not None else contextlib.nullcontext())
        with ck_cm:
            self.checkpointer.save(
                version, {"params": self._params},
                meta={"elastic_version": version,
                      "elastic_step": version * self.sync_every,
                      "sync_every": self.sync_every})

    def train(self, rounds: int, finish: bool = True):
        """Commit ``rounds`` averaging rounds (versions ``start+1 ..
        start+rounds``); returns the final averaged host tree.
        ``finish=False`` keeps the cluster alive (workers park at the
        staleness gate) so a later ``train`` call can continue the run."""
        ok = False
        try:
            target = self.version + int(rounds)
            while self.version < target:
                rnd = self.version  # collecting round ``rnd`` contributions
                contribs = self._barrier(rnd)
                wids = sorted(contribs)  # deterministic averaging order
                avg_sp = (self.tracer.start_span(
                              "elastic.average", parent=self._round_span,
                              attrs={"round": rnd, "n_contrib": len(wids)})
                          if self.tracer is not None else None)
                self._params = average_trees(
                    [contribs[w][0] for w in wids],
                    [contribs[w][1] for w in wids])
                if avg_sp is not None:
                    avg_sp.end()
                self.version += 1
                self._publish_version(self.version, self._params)
                self.registry.counter("elastic_rounds_total").inc()
                self.tracker.increment("rounds_completed")
                self._maybe_checkpoint(self.version)
                if self.tracer is not None:
                    # write-ahead dump at the commit boundary
                    self.tracer.flight_checkpoint(
                        extra={"version": self.version,
                               "contributors": wids})
            ok = True
            return self._params
        except ElasticTrainingError as exc:
            if self.tracer is not None:
                self.tracer.dump("ElasticTrainingError", error=exc,
                                 extra={"version": self.version})
            raise
        finally:
            if finish or not ok:  # a failed run always releases the
                self.tracker.finish()  # workers' poll loops

    def _barrier(self, rnd: int) -> Dict[str, tuple]:
        """Collect round ``rnd`` until every live worker admitted
        at-or-before it has contributed, burying heartbeat-stale workers
        and quarantining non-finite contributions along the way (spanned
        as ``elastic.barrier`` with an event per arrival, burial and
        quarantine)."""
        from deeplearning4j_tpu_torch.optimize.guardrails import (
            tree_all_finite,
        )

        deadline = time.monotonic() + self.round_timeout_s
        barrier_sp = (self.tracer.start_span(
                          "elastic.barrier", parent=self._round_span,
                          attrs={"round": rnd})
                      if self.tracer is not None else None)
        seen: set = set()
        try:
            while True:
                for wid in self._dead_workers():
                    self._bury(wid)
                    if barrier_sp is not None:
                        barrier_sp.add_event("buried", worker=wid)
                live = self._live_workers()
                self.registry.gauge("elastic_live_workers").set(
                    float(len(live)))
                if len(live) < self.min_workers:
                    raise ElasticTrainingError(
                        f"survivor set {live} below min_workers="
                        f"{self.min_workers} at round {rnd} — halting "
                        "(raise min_workers tolerance or add workers)")
                contribs = self._contributions(rnd)
                for w in sorted(contribs):
                    if not tree_all_finite(contribs[w][0]):
                        contribs.pop(w)
                        self._quarantine(w, rnd, barrier_sp)
                live = self._live_workers()  # quarantine shrank the set
                if len(live) < self.min_workers:
                    raise ElasticTrainingError(
                        f"survivor set {live} below min_workers="
                        f"{self.min_workers} after quarantine at round "
                        f"{rnd} — halting")
                if barrier_sp is not None:
                    for w in sorted(contribs):
                        if w not in seen:
                            seen.add(w)
                            barrier_sp.add_event("contribution", worker=w)
                required = [w for w in live
                            if self._admit_round(w) <= rnd]
                if required and all(w in contribs for w in required):
                    if barrier_sp is not None:
                        barrier_sp.set_attr("contributors", sorted(contribs))
                        barrier_sp.set_attr("required", sorted(required))
                        barrier_sp.end()
                    return contribs
                if time.monotonic() > deadline:
                    raise ElasticTrainingError(
                        f"round {rnd} barrier timed out after "
                        f"{self.round_timeout_s}s: live={live} "
                        f"contributed={sorted(contribs)}")
                time.sleep(self.tick_s)
        except BaseException as exc:
            if barrier_sp is not None:
                barrier_sp.end(error=exc)
            raise

    def resume(self) -> Optional[int]:
        """Adopt the latest committed checkpoint (params and version);
        call before ``train``. Returns the resumed version or None."""
        if self.checkpointer is None:
            return None
        step = self.checkpointer.latest_step()
        if step is None:
            return None
        # the master's params are a host tree: restore onto the CPU
        state, version, meta = self.checkpointer.restore(
            {"params": self._template}, step=step, device="cpu")
        self._params = _host_tree(state["params"])
        self.version = int(meta.get("elastic_version", version))
        self._publish_version(self.version, self._params)
        return self.version

    def params(self):
        return self._params

    def shutdown(self) -> None:
        if self.watchtower is not None:
            self.watchtower.tick()  # the final verdict lands mid-interval
            self.watchtower.stop()
            self.watchtower = None
        if self.checkpointer is not None and hasattr(self.checkpointer,
                                                     "flush"):
            self.checkpointer.flush()
        if self.tracer is not None:
            if self._round_span is not None:
                self._round_span.end()
                self._round_span = None
            if self._run_span is not None:
                self._run_span.end()
                self._run_span = None
        self.server.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


# ----------------------------------------------------- parity reference ----

def simulate_elastic(model: ElasticModel, worker_seeds: List[int],
                     sync_every: int, rounds: int,
                     schedule: Optional[Dict[int, List[int]]] = None):
    """In-process reference of the round protocol: the same adoption,
    local-step indexing and ``average_trees``; the oracle of the
    multi-process tests. ``schedule`` maps round → the worker indices
    contributing that round (a mid-run kill or rejoin); default: everyone,
    every round. Returns ``(final host params, per-round mean losses)``."""
    global_params = _host_tree(model.init_params())
    losses: List[float] = []
    for rnd in range(int(rounds)):
        present = (schedule.get(rnd) if schedule is not None else None)
        idxs = list(range(len(worker_seeds))) if present is None else present
        if not idxs:
            raise ElasticTrainingError(f"simulated round {rnd} has no "
                                       "contributors")
        trees, weights, rl = [], [], []
        for i in idxs:
            p, loss = model.run_steps(global_params, rnd * sync_every,
                                      sync_every, worker_seeds[i])
            trees.append(_host_tree(p))
            weights.append(float(sync_every))
            rl.append(loss)
        global_params = average_trees(trees, weights)
        losses.append(float(np.mean(rl)))
    return global_params, losses


# ------------------------------------------------------------------ CLI ----

def _resolve_model(spec: str, kwargs: dict) -> ElasticModel:
    """"pkg.module:factory" → factory(**kwargs) -> ElasticModel."""
    module_name, _, attr = spec.partition(":")
    factory = getattr(importlib.import_module(module_name), attr)
    return factory(**kwargs)


def worker_main(argv=None) -> None:
    """CLI worker entry: ``python -m deeplearning4j_tpu_torch.scaleout.
    elastic --connect HOST:PORT --blob URI --model pkg.mod:factory
    [--device cuda|cpu] [...]``. The factory gets ``--kwargs-json`` and
    ``device=``. Prints ``ELASTIC_WORKER_DONE {json}`` at the end."""
    p = argparse.ArgumentParser(description="elastic training worker")
    p.add_argument("--connect", required=True, help="master tracker host:port")
    p.add_argument("--blob", required=True, help="shared blob store URI")
    p.add_argument("--model", required=True,
                   help="pkg.module:factory for the ElasticModel")
    p.add_argument("--kwargs-json", default="{}",
                   help="JSON kwargs for the model factory")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the worker's device (default cuda)")
    p.add_argument("--worker-id", default=None)
    p.add_argument("--worker-seed", type=int, default=None)
    p.add_argument("--sync-every", type=int, default=4)
    p.add_argument("--max-staleness", type=int, default=0)
    p.add_argument("--round-timeout-s", type=float, default=60.0)
    p.add_argument("--crash-at-round", type=int, default=None,
                   help="fault injection: os._exit mid-round at round N")
    p.add_argument("--crash-after-steps", type=int, default=1,
                   help="local steps to run inside the crashing round")
    p.add_argument("--trace-dir", default=None,
                   help="write per-process span JSONL and flight-recorder "
                        "dumps under this directory")
    p.add_argument("--watch-dir", default=None,
                   help="arm the watchtower: sample this process's "
                        "registry into a history spill, evaluate the "
                        "default alert pack, publish verdicts to the "
                        "master's tracker KV, and write history/alert "
                        "JSONL under this directory")
    args = p.parse_args(argv)
    resolve_device(args.device)  # raises when CUDA is asked for and absent
    kwargs = json.loads(args.kwargs_json)
    kwargs["device"] = args.device
    model = _resolve_model(args.model, kwargs)
    worker = ElasticWorker(
        args.connect, args.blob, model, worker_id=args.worker_id,
        sync_every=args.sync_every, max_staleness=args.max_staleness,
        worker_seed=args.worker_seed, round_timeout_s=args.round_timeout_s,
        crash_at_round=args.crash_at_round,
        crash_after_steps=args.crash_after_steps)
    if args.trace_dir:
        _trace.configure(worker.worker_id, args.trace_dir)
    tower = None
    if args.watch_dir:
        from deeplearning4j_tpu_torch.telemetry.alerts import arm_watchtower

        # its own tracker connection: alert publishes never ride (or
        # stall behind) the training loop's RPC slot
        tower = arm_watchtower(process=worker.worker_id,
                               tracker_address=args.connect,
                               out_dir=args.watch_dir)
    try:
        summary = worker.run()
    finally:
        if tower is not None:
            tower.tick()  # the final verdict lands even mid-interval
            tower.stop()
    print("ELASTIC_WORKER_DONE " + json.dumps(summary), flush=True)


if __name__ == "__main__":
    worker_main()
