"""Counterpart of ``deeplearning4j_tpu/scaleout/ckpt/checkpointer.py``:
periodic saves, retention, resume and telemetry over one checkpoint root.

``Checkpointer.save()`` writes a snapshot (manifest-committed, see
sharded_io), records save duration, bytes and chunk count in the port's
metrics registry under the JAX package's names (``ckpt_saves_total``,
``ckpt_save_ms``, ...), and applies retention: keep the newest
``keep_last`` committed steps, delete older ones, and sweep interrupted
(manifest-less) save directories once a same-or-newer step has committed.
``restore()`` reads a step back, CUDA unless the caller passes
``device="cpu"``: whole leaves, or with ``shardings=`` and ``mesh=`` this
rank's chunks. ``save_process``/``merge_save`` are the multi-process save
of a state sharded over a mesh: every rank writes the chunks it owns and
a part manifest, and the coordinator commits the merged manifest last.
Saves and restores run under ``ckpt.save``/``ckpt.merge_save``/
``ckpt.restore`` spans of the process tracer (``telemetry.trace``) when
one is configured.

``save_net``/``restore_net`` write and read a ``MultiLayerNetwork``'s
full training state (``net_state``), and ``CheckpointIterationListener``
saves it every ``save_every`` iterations through the listener chain
(``optimize/listeners.dispatch_listeners``): a raising save is logged and
skipped, never killing the run.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from deeplearning4j_tpu_torch._device import DeviceLike
from deeplearning4j_tpu_torch.scaleout.ckpt import manifest as mf
from deeplearning4j_tpu_torch.scaleout.ckpt import net_state as ns
from deeplearning4j_tpu_torch.scaleout.ckpt.reshard import (
    latest_step,
    latest_step_dir,
    restore_sharded,
    verify_checksums,
)
from deeplearning4j_tpu_torch.scaleout.ckpt.sharded_io import (
    merge_process_manifests,
    save_process_shards,
    save_sharded,
)
from deeplearning4j_tpu_torch.telemetry import trace as _trace

def replicated_shardings(template):
    """A spec tree placing every leaf of ``template`` whole (``()``): the
    restore layout of data-parallel params and updater state."""
    from deeplearning4j_tpu_torch._device import tree_map

    return tree_map(lambda _p, _x: (), template)


class Checkpointer:
    """Checkpoint store with retention and telemetry.

    save(step, state[, meta, mesh, specs])          → committed step dir
    restore(template[, shardings, step, device, mesh]) → (state, step, meta)
    latest_step() / step_dirs()        → what a resume would load
    """

    def __init__(self, root: str, keep_last: int = 3, registry=None,
                 prefix: str = "ckpt", verify_on_restore: bool = False):
        from deeplearning4j_tpu_torch.telemetry.registry import (
            default_registry,
        )

        self.root = str(root)
        self.keep_last = max(1, int(keep_last))
        self.registry = registry if registry is not None else \
            default_registry()
        self.prefix = prefix
        self.verify_on_restore = verify_on_restore
        # retention-race pin: the step a reader most recently resolved
        # (latest_step()/restore()) is never GC'd, even if newer saves push
        # it past keep_last mid-restore
        self._pin_lock = threading.Lock()
        self._last_resolved_step: Optional[int] = None

    # ------------------------------------------------------- last_good ----
    def _last_good_path(self) -> str:
        return os.path.join(self.root, "LAST_GOOD.json")

    def mark_last_good(self, step: int) -> None:
        """Tag ``step`` as the divergence watchdog's rollback target
        (``optimize.guardrails.DivergenceWatchdog.note_checkpoint``). The tag is a marker file
        next to the step dirs (atomic tmp+replace), so it survives the
        process and is visible to every reader of the root; ``gc()`` never
        collects the tagged step."""
        os.makedirs(self.root, exist_ok=True)
        tmp = f"{self._last_good_path()}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump({"step": int(step), "ts": time.time()}, fh)
        os.replace(tmp, self._last_good_path())
        self.registry.gauge(f"{self.prefix}_last_good_step").set(float(step))

    def last_good_step(self) -> Optional[int]:
        """The tagged rollback target, or None when none was ever tagged."""
        try:
            with open(self._last_good_path()) as fh:
                return int(json.load(fh)["step"])
        except (OSError, ValueError, KeyError, TypeError):
            return None

    # ------------------------------------------------------------- save ----
    def save(self, step: int, state, meta: Optional[Dict] = None,
             mesh=None, specs=None) -> str:
        """Save the WHOLE ``state`` (``specs``: each leaf's spec on
        ``mesh``, see ``sharded_io.save_sharded``)."""
        reg, p = self.registry, self.prefix
        with _trace.maybe_span("ckpt.save",
                               attrs={"step": int(step)}) as sp:
            t0 = time.perf_counter()
            # save_sharded copies every leaf to the host (a synchronizing
            # .cpu()), so nothing is left enqueued when the clock stops
            step_dir = save_sharded(self.root, step, state, meta=meta,
                                    mesh=mesh, specs=specs)
            save_ms = (time.perf_counter() - t0) * 1000.0
            manifest = mf.read_manifest(step_dir)
            n_chunks = sum(len(e.chunks) for e in manifest.leaves)
            reg.counter(f"{p}_saves_total").inc()
            reg.counter(f"{p}_bytes_total").inc(float(manifest.total_bytes))
            reg.histogram(f"{p}_save_ms").observe(save_ms)
            reg.gauge(f"{p}_last_step").set(float(step))
            reg.gauge(f"{p}_last_bytes").set(float(manifest.total_bytes))
            reg.gauge(f"{p}_last_shards").set(float(n_chunks))
            if sp is not None:
                sp.set_attr("bytes", int(manifest.total_bytes))
                sp.set_attr("chunks", int(n_chunks))
            self.gc()
            return step_dir

    def maybe_save(self, step: int, state_fn: Callable[[], object],
                   save_every: int, meta: Optional[Dict] = None,
                   mesh=None) -> Optional[str]:
        """Save iff ``step`` lands on the cadence (and is > 0)."""
        if save_every <= 0 or step <= 0 or step % save_every:
            return None
        return self.save(step, state_fn(), meta=meta, mesh=mesh)

    # ------------------------------------------------- multi-process save ----
    def save_process(self, step: int, state,
                     process_index: Optional[int] = None, *, mesh=None,
                     specs=None) -> str:
        """Every rank's half of a multi-process save: this rank's owned
        chunks of its LOCAL ``state`` plus an atomic part manifest
        (``sharded_io.save_process_shards``). The commit happens on the
        coordinator in ``merge_save``; until then the step is invisible."""
        return save_process_shards(self.root, step, state,
                                   process_index=process_index, mesh=mesh,
                                   specs=specs)

    def merge_save(self, step: int, n_processes: int,
                   meta: Optional[Dict] = None, mesh=None,
                   timeout_s: float = 120.0) -> str:
        """Coordinator only: the manifest merge barrier (waits for every
        part manifest, checks coverage, commits LAST) with the telemetry
        and retention of ``save``."""
        reg, p = self.registry, self.prefix
        with _trace.maybe_span("ckpt.merge_save",
                               attrs={"step": int(step),
                                      "n_processes": int(n_processes)}):
            t0 = time.perf_counter()
            step_dir = merge_process_manifests(
                self.root, step, n_processes, meta=meta, mesh=mesh,
                timeout_s=timeout_s)
            merge_ms = (time.perf_counter() - t0) * 1000.0
            manifest = mf.read_manifest(step_dir)
            reg.counter(f"{p}_saves_total").inc()
            reg.counter(f"{p}_bytes_total").inc(float(manifest.total_bytes))
            reg.histogram(f"{p}_save_ms").observe(merge_ms)
            reg.gauge(f"{p}_last_step").set(float(step))
            self.gc()
            return step_dir

    # ---------------------------------------------------------- restore ----
    def latest_step(self) -> Optional[int]:
        step = latest_step(self.root)
        if step is not None:
            self._pin(step)
        return step

    def _pin(self, step: int) -> None:
        with self._pin_lock:
            self._last_resolved_step = int(step)

    def step_dirs(self):
        return mf.committed_steps(self.root)

    def _dir_for(self, step: Optional[int]) -> str:
        if step is None:
            step_dir = latest_step_dir(self.root)
            if step_dir is None:
                raise FileNotFoundError(
                    f"no committed checkpoint under {self.root}")
            resolved = mf.parse_step(step_dir)
            if resolved is not None:
                self._pin(resolved)
            return step_dir
        step_dir = os.path.join(self.root, mf.step_dir_name(step))
        if not mf.has_manifest(step_dir):
            raise FileNotFoundError(
                f"step {step} has no committed checkpoint under {self.root}")
        self._pin(int(step))
        return step_dir

    def restore(self, template, shardings=None, step: Optional[int] = None,
                device: DeviceLike = None, mesh=None
                ) -> Tuple[object, int, Dict]:
        """Load the latest (or a specific) committed step into the template
        structure, as tensors on ``device`` (CUDA unless ``device="cpu"``):
        whole leaves, or with ``shardings`` (a spec tree) and ``mesh`` this
        rank's chunks of them. Returns ``(state, step, meta)``."""
        reg, p = self.registry, self.prefix
        with _trace.maybe_span("ckpt.restore") as sp:
            step_dir = self._dir_for(step)
            if self.verify_on_restore:
                problems = verify_checksums(step_dir)
                if problems:
                    raise ValueError(
                        f"checkpoint {step_dir} failed checksum "
                        "verification: " + "; ".join(problems))
            t0 = time.perf_counter()
            state, manifest = restore_sharded(step_dir, template, shardings,
                                              device=device, mesh=mesh)
            restore_ms = (time.perf_counter() - t0) * 1000.0
            reg.histogram(f"{p}_restore_ms").observe(restore_ms)
            reg.counter(f"{p}_restores_total").inc()
            if sp is not None:
                sp.set_attr("step", int(manifest.step))
            return state, manifest.step, dict(manifest.meta or {})

    def restore_net(self, step: Optional[int] = None,
                    device: DeviceLike = None):
        """Rebuild a MultiLayerNetwork on ``device`` (CUDA unless
        ``device="cpu"``) from a net-state checkpoint, one saved by
        ``CheckpointIterationListener`` or ``save_net`` in either package:
        returns ``(net, iteration)``."""
        from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        step_dir = self._dir_for(step)
        manifest = mf.read_manifest(step_dir)
        meta = dict(manifest.meta or {})
        net = MultiLayerNetwork(
            MultiLayerConfiguration.from_json(meta["conf"]),
            device=device).init()
        if any(e.path.startswith("['state']") for e in manifest.leaves):
            net._ensure_train_step()
        template = ns.net_state_template(net)
        state, _step, meta = self.restore(template, step=manifest.step,
                                          device=net.device)
        ns.restore_net_state(net, state, meta)
        return net, net._iteration

    def save_net(self, net, iteration: Optional[int] = None) -> str:
        tree, meta = ns.capture_net_state(net, iteration=iteration)
        return self.save(meta["iteration"], tree, meta=meta)

    # --------------------------------------------------------- retention ----
    def gc(self) -> None:
        """Retention sweep: keep the newest ``keep_last`` committed steps;
        delete older committed ones, and delete interrupted (manifest-less)
        directories that a same-or-newer committed step has superseded.

        Never deletes the step a reader most recently resolved via
        ``latest_step()``/``restore()``, nor the step tagged ``last_good``
        (the rollback target)."""
        committed = mf.committed_steps(self.root)
        if not committed:
            return
        newest = committed[-1][0]
        with self._pin_lock:
            pinned = self._last_resolved_step
        last_good = self.last_good_step()
        for step, step_dir in committed[:-self.keep_last]:
            if pinned is not None and step == pinned:
                continue
            if last_good is not None and step == last_good:
                continue
            shutil.rmtree(step_dir, ignore_errors=True)
        for step, step_dir in mf.uncommitted_dirs(self.root):
            if step is not None and step <= newest:
                shutil.rmtree(step_dir, ignore_errors=True)


class CheckpointIterationListener:
    """Periodic checkpointing through the exception-safe listener chain.

    ``state_fn(model, iteration) -> (tree, meta)`` defaults to
    ``capture_net_state``: params, updater state, key and iteration. The
    chain logs and skips a raising listener, so an unwritable disk turns a
    run checkpoint-less instead of killing it; a partial save is never
    visible (the manifest commits last).

    With ``mesh`` (parallel/mesh.py) the state is the data-parallel
    trainer's, replicated on every rank: rank 0 alone saves, and the
    manifest records the mesh's axes.
    """

    def __init__(self, checkpointer: Checkpointer, save_every: int = 10,
                 state_fn: Optional[Callable] = None, mesh=None):
        self.checkpointer = checkpointer
        self.save_every = max(1, int(save_every))
        self.state_fn = state_fn
        self.mesh = mesh
        self.saved_steps = []

    def __call__(self, model, iteration: int, score: float) -> None:
        if iteration <= 0 or iteration % self.save_every:
            return
        if self.mesh is not None and self.mesh.rank != 0:
            # every rank holds the same replicated state: the coordinator
            # alone writes it
            return
        if self.state_fn is not None:
            tree, meta = self.state_fn(model, iteration)
        else:
            tree, meta = ns.capture_net_state(model, iteration=iteration)
        meta = dict(meta)
        meta.setdefault("score", float(score))
        self.checkpointer.save(iteration, tree, meta=meta, mesh=self.mesh)
        self.saved_steps.append(iteration)
