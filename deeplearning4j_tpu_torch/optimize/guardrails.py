"""Counterpart of ``deeplearning4j_tpu/optimize/guardrails.py``: the guard
policy, finiteness of loss and grads, global-norm clipping and the
skip-on-nonfinite select inside a step; on the host, the divergence
watchdog, replay bundles and rollback.

A guarded step selects the updated params against the incoming ones with
``torch.where(finite, new, old)``, so a batch with a NaN/Inf loss or
gradient costs one step of progress and never the model. The select passes
the chosen operand through bitwise, and below the clip threshold the clip
scale is exactly 1.0: on a clean batch the guarded step computes the same
params as the unguarded one. Every flag stays a device tensor; nothing in
the step synchronises with the host.

The host half: ``DivergenceWatchdog`` reads each step's guard block and
loss, counts skipped and clipped steps in the registry, and declares
divergence after ``max_consecutive_skips`` skips in a row or a loss spike
above ``spike_factor`` times its EMA. While healthy it tags committed
checkpoints ``last_good`` (``Checkpointer.mark_last_good``); after a
divergence ``rollback()`` restores that step. On the first skip of a
burst it dumps the faulting step as a replay bundle
(``dump_replay_bundle``): one atomic npz in the JAX package's format
(``leaf_<i>`` members, ``__paths__`` and ``__meta__`` as JSON bytes), so
either package loads the other's bundles and ``tools/step_replay.py``
re-executes them.
"""

from __future__ import annotations

import io
import json
import logging
import math
import os
import re
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import tree_leaves, tree_paths, \
    tree_zip_map
from deeplearning4j_tpu_torch.telemetry import trace as _trace
from deeplearning4j_tpu_torch.telemetry.metrics import global_norm

log = logging.getLogger(__name__)

_TINY = 1e-30  # clip-scale denominator floor (exact-1.0 scale stays exact)


@dataclass(frozen=True)
class GuardConfig:
    """Guard policy for one train step.

    ``skip_nonfinite``: carry params unchanged through a step whose loss or
    grad global-norm is NaN/Inf. ``clip_norm``: global-norm clip threshold
    applied to the grads before the update (None = no clipping).
    """

    skip_nonfinite: bool = True
    clip_norm: Optional[float] = None

    @classmethod
    def coerce(cls, guard) -> Optional["GuardConfig"]:
        """Normalize the seam argument: None/False → no guard, True → the
        default policy, a GuardConfig → itself."""
        if guard is None or guard is False:
            return None
        if guard is True:
            return cls()
        if isinstance(guard, cls):
            return guard
        raise TypeError(
            f"guard= must be None/False, True, or a GuardConfig; got "
            f"{type(guard).__name__}")


def guard_stats(loss: torch.Tensor, grads, shards=None) -> Tuple:
    """(grad global-norm, finite?): a single NaN/Inf anywhere in the grad
    tree poisons the norm, so one scalar test covers every leaf.
    ``shards`` as in ``telemetry.metrics.global_norm``."""
    gn = global_norm(grads, shards)
    finite = torch.isfinite(loss.float()) & torch.isfinite(gn)
    return gn, finite


def clip_by_global_norm(grads, grad_norm: torch.Tensor,
                        clip_norm: float) -> Tuple:
    """Scale ``grads`` so their global norm is at most ``clip_norm``.
    Returns ``(grads, clipped?)``. Below the threshold the scale is exactly
    1.0."""
    scale = torch.clamp(clip_norm / torch.clamp_min(grad_norm, _TINY),
                        max=1.0)
    clipped = scale < 1.0
    return tree_zip_map(lambda g: g * scale.to(g.dtype), grads), clipped


def guard_select(finite: torch.Tensor, new_tree, old_tree):
    """Per-leaf ``where(finite, new, old)``: the skip-on-nonfinite select.
    The chosen operand passes through bitwise."""
    return tree_zip_map(lambda n, o: torch.where(finite, n, o), new_tree,
                        old_tree)


def guarded_sgd_update(params, grads, loss: torch.Tensor, lr: float,
                       cfg: GuardConfig, shards=None) -> Tuple:
    """The guarded SGD update: ``(new_params, guard_metrics)``.

    Clean batch → ``params - lr * grads``, the same as the unguarded
    update. Non-finite loss or grads → params carried unchanged,
    ``nonfinite`` set. The metrics are f32 device scalars (``nonfinite``,
    ``clipped``, ``guard_grad_norm``). ``shards`` as in
    ``guard_stats``."""
    gn, finite = guard_stats(loss, grads, shards)
    clipped = torch.zeros((), dtype=torch.float32, device=gn.device)
    if cfg.clip_norm is not None:
        grads, was_clipped = clip_by_global_norm(grads, gn, cfg.clip_norm)
        clipped = (was_clipped & finite).to(torch.float32)
    new_params = tree_zip_map(lambda p, g: p - lr * g, params, grads)
    if cfg.skip_nonfinite:
        new_params = guard_select(finite, new_params, params)
    metrics = {
        "nonfinite": (~finite).to(torch.float32),
        "clipped": clipped,
        "guard_grad_norm": gn,
    }
    return new_params, metrics


# ------------------------------------------------------ host-side checks ----

def _host(leaf) -> np.ndarray:
    """A leaf as a host array (a bfloat16 tensor widened to float32,
    which numpy holds without ``ml_dtypes``)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def _leaves_with_keystr(tree) -> List[Tuple[str, object]]:
    from deeplearning4j_tpu_torch._device import keystr

    return [(keystr(p), x) for p, x in zip(tree_paths(tree),
                                           tree_leaves(tree))
            if x is not None]


def tree_all_finite(tree) -> bool:
    """Host-side: every float leaf of ``tree`` is finite (integer and
    bool leaves pass)."""
    for _, leaf in _leaves_with_keystr(tree):
        arr = _host(leaf)
        if np.issubdtype(arr.dtype, np.floating) or \
                np.issubdtype(arr.dtype, np.complexfloating):
            if not np.all(np.isfinite(arr)):
                return False
    return True


def nonfinite_report(tree) -> List[Dict]:
    """Per-leaf forensics: path, shape, dtype, non-finite count, and the
    finite min/max — what ``tools/step_replay.py`` prints to point at the
    poison inside a bundle."""
    out: List[Dict] = []
    for path, leaf in _leaves_with_keystr(tree):
        arr = _host(leaf)
        entry = {"path": path, "shape": list(arr.shape),
                 "dtype": str(arr.dtype)}
        if np.issubdtype(arr.dtype, np.floating):
            finite = np.isfinite(arr)
            entry["nonfinite"] = int(arr.size - int(finite.sum()))
            if finite.any():
                entry["finite_min"] = float(arr[finite].min())
                entry["finite_max"] = float(arr[finite].max())
        else:
            entry["nonfinite"] = 0
        out.append(entry)
    return out


# -------------------------------------------------------- replay bundles ----

_KEY_SEG = re.compile(r"\['([^']*)'\]")


def _tree_to_bytes(tree, meta: Optional[Dict] = None) -> bytes:
    """A tree's leaves and JSON-able ``meta`` as npz bytes in the JAX
    package's layout (``scaleout/elastic.tree_to_bytes``)."""
    leaves = _leaves_with_keystr(tree)
    payload = {f"leaf_{i}": _host(x) for i, (_, x) in enumerate(leaves)}
    payload["__paths__"] = np.frombuffer(json.dumps(
        [p for p, _ in leaves]).encode(), np.uint8)
    payload["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(),
                                        np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **payload)
    return buf.getvalue()


def _read_tree_bytes(data: bytes) -> Tuple[List[str], List[np.ndarray],
                                            Dict]:
    """``(keystr paths, numpy leaves, meta)`` from ``_tree_to_bytes``
    output (or the JAX package's)."""
    with np.load(io.BytesIO(data)) as z:
        paths = json.loads(bytes(z["__paths__"]).decode())
        meta = json.loads(bytes(z["__meta__"]).decode())
        leaves = [np.asarray(z[f"leaf_{i}"]) for i in range(len(paths))]
    return paths, leaves, meta


def dump_replay_bundle(replay_dir: str, step: int, payload,
                       meta: Optional[Dict] = None) -> str:
    """Persist the faulting step as ONE atomic npz: ``payload`` is a
    string-keyed dict tree of tensors or arrays (conventionally
    ``{"params": ..., "batch": {...}}``), ``meta`` JSON-able context
    (step, RNG key, loss). Returns the bundle's path, for
    ``tools/step_replay.py``."""
    os.makedirs(replay_dir, exist_ok=True)
    meta = dict(meta or {})
    meta["step"] = int(step)
    meta.setdefault("saved_unix", time.time())
    path = os.path.join(replay_dir, f"replay_step_{int(step):08d}.npz")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(_tree_to_bytes(payload, meta))
    os.replace(tmp, path)
    return path


def load_replay_bundle(path: str, template=None) -> Tuple[object, Dict]:
    """Load ``(payload, meta)``, the leaves as numpy arrays. With
    ``template`` the stored paths must be exactly the template's, in
    order, and the payload takes its structure; without one the nested
    dicts are rebuilt from the stored paths."""
    from deeplearning4j_tpu_torch._device import tree_unflatten

    with open(path, "rb") as fh:
        paths, leaves, meta = _read_tree_bytes(fh.read())
    if template is not None:
        want = [p for p, _ in _leaves_with_keystr(template)]
        if want != paths:
            raise ValueError(
                f"replay bundle structure mismatch: payload has {paths}, "
                f"template expects {want}")
        return tree_unflatten(template, leaves), meta
    tree: Dict = {}
    for path_str, leaf in zip(paths, leaves):
        keys = _KEY_SEG.findall(path_str)
        if "".join(f"['{k}']" for k in keys) != path_str or not keys:
            raise ValueError(
                f"replay bundle {path}: unsupported leaf path {path_str!r} "
                "(bundles hold string-keyed dict trees only)")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree, meta


# -------------------------------------------------------------- watchdog ----

class DivergenceWatchdog:
    """Host-side divergence policy over guarded-step telemetry.

    Feed it one ``observe(step, loss, guard_metrics, ...)`` per train step
    (values may be device scalars; the watchdog reads them, so call it on
    the cadence the loop already syncs at). Its verdict:

    - ``"ok"``      — finite loss, healthy trajectory;
    - ``"skipped"`` — the in-step guard skipped this step (non-finite);
    - ``"clipped"`` — finite, but the global-norm clip engaged;
    - ``"diverged"``— ``max_consecutive_skips`` skips in a row, or a
      finite loss above ``spike_factor ×`` the loss EMA (after
      ``warmup_steps`` finite observations).

    While healthy, ``note_checkpoint(step)`` tags that committed step
    ``last_good`` (``Checkpointer.mark_last_good``: retention never
    collects it). After a ``"diverged"`` verdict, ``rollback(template[,
    shardings])`` restores the ``last_good`` step through
    ``Checkpointer.restore`` and resets the health state.

    Registry signals: ``guard_skipped_steps_total``,
    ``guard_clipped_steps_total``, ``guard_rollbacks_total``,
    ``guard_divergence_total``, ``guard_replay_bundles_total`` counters;
    ``guard_last_finite_loss`` / ``guard_consecutive_skips`` gauges.

    Forensics: on the FIRST skip of a burst, with ``replay_dir`` set and
    ``params``/``batch`` passed, the faulting step is dumped as a replay
    bundle (at most ``max_bundles`` kept, oldest deleted first).
    """

    def __init__(self, checkpointer=None, registry=None, *,
                 max_consecutive_skips: int = 3, ema_alpha: float = 0.1,
                 spike_factor: float = 10.0, warmup_steps: int = 5,
                 replay_dir: Optional[str] = None, max_bundles: int = 4):
        from deeplearning4j_tpu_torch.telemetry.registry import \
            default_registry

        self.checkpointer = checkpointer
        self.registry = registry if registry is not None else \
            default_registry()
        self.max_consecutive_skips = max(1, int(max_consecutive_skips))
        self.ema_alpha = float(ema_alpha)
        self.spike_factor = float(spike_factor)
        self.warmup_steps = max(0, int(warmup_steps))
        self.replay_dir = replay_dir
        self.max_bundles = max(1, int(max_bundles))
        self.skipped_steps = 0
        self.clipped_steps = 0
        self.rollbacks = 0
        self.consecutive_skips = 0
        self.last_finite_loss: Optional[float] = None
        self._ema: Optional[float] = None
        self._n_finite = 0
        self._divergence: Optional[str] = None
        self._bundles: List[str] = []

    # -- health --
    @property
    def diverged(self) -> bool:
        return self._divergence is not None

    @property
    def divergence_reason(self) -> Optional[str]:
        return self._divergence

    def observe(self, step: int, loss, guard_metrics: Optional[Dict] = None,
                *, params=None, batch=None, rng_key=None,
                meta: Optional[Dict] = None) -> str:
        """Digest one step's outcome; see the class docstring for the
        verdicts."""
        loss = float(loss)
        gm = guard_metrics or {}
        skipped = (float(gm.get("nonfinite", 0.0)) > 0.0
                   or not math.isfinite(loss))
        if skipped:
            self.skipped_steps += 1
            self.consecutive_skips += 1
            self.registry.counter("guard_skipped_steps_total").inc()
            self.registry.gauge("guard_consecutive_skips").set(
                float(self.consecutive_skips))
            if self.consecutive_skips == 1:
                self._dump_bundle(step, loss, params, batch, rng_key, meta)
            tracer = _trace.get_tracer()
            if tracer is not None:
                sp = tracer.current_span()
                if sp is not None:
                    sp.add_event("nonfinite", step=int(step))
            log.warning("guard: non-finite step %d skipped (loss=%r, "
                        "consecutive=%d)", step, loss,
                        self.consecutive_skips)
            if self.consecutive_skips >= self.max_consecutive_skips:
                self._declare(f"{self.consecutive_skips} consecutive "
                              f"non-finite steps at step {step}")
            return "diverged" if self.diverged else "skipped"
        self.consecutive_skips = 0
        self.registry.gauge("guard_consecutive_skips").set(0.0)
        self.last_finite_loss = loss
        self.registry.gauge("guard_last_finite_loss").set(loss)
        verdict = "ok"
        if float(gm.get("clipped", 0.0)) > 0.0:
            self.clipped_steps += 1
            self.registry.counter("guard_clipped_steps_total").inc()
            verdict = "clipped"
        if (self._ema is not None and self._n_finite >= self.warmup_steps
                and self._ema > 0.0
                and loss > self.spike_factor * self._ema):
            self._declare(
                f"loss {loss:.6g} spiked above {self.spike_factor}x the "
                f"EMA {self._ema:.6g} at step {step}")
        else:
            a = self.ema_alpha
            self._ema = loss if self._ema is None else \
                a * loss + (1.0 - a) * self._ema
        self._n_finite += 1
        return "diverged" if self.diverged else verdict

    def _declare(self, reason: str) -> None:
        if self._divergence is not None:
            return
        self._divergence = reason
        self.registry.counter("guard_divergence_total").inc()
        log.error("guard watchdog: divergence — %s", reason)
        tracer = _trace.get_tracer()
        if tracer is not None:
            tracer.dump("divergence", extra={"reason": reason})

    def _dump_bundle(self, step, loss, params, batch, rng_key, meta) -> None:
        if self.replay_dir is None or (params is None and batch is None):
            return
        payload: Dict = {}
        if params is not None:
            payload["params"] = params
        if batch is not None:
            payload["batch"] = batch
        bundle_meta = dict(meta or {})
        bundle_meta["loss"] = repr(loss)
        if rng_key is not None:
            bundle_meta["rng_key"] = np.asarray(
                _host(rng_key) if isinstance(rng_key, torch.Tensor)
                else rng_key).tolist()
        try:
            path = dump_replay_bundle(self.replay_dir, step, payload,
                                      bundle_meta)
        except Exception:  # forensics must never kill the guarded run
            log.exception("guard: replay-bundle dump failed for step %d",
                          step)
            return
        self._bundles.append(path)
        self.registry.counter("guard_replay_bundles_total").inc()
        while len(self._bundles) > self.max_bundles:
            stale = self._bundles.pop(0)
            try:
                os.remove(stale)
            except OSError:
                pass
        log.warning("guard: replay bundle for faulting step %d -> %s",
                    step, path)

    @property
    def bundles(self) -> List[str]:
        return list(self._bundles)

    # -- checkpoint policy --
    def note_checkpoint(self, step: int) -> None:
        """Call after a checkpoint of ``step`` commits: tags it
        ``last_good`` iff the run is healthy (no divergence, not in a
        skip burst), so a snapshot taken while the loss blows up never
        becomes the rollback target."""
        if self.checkpointer is None or self.diverged:
            return
        if self.consecutive_skips == 0:
            self.checkpointer.mark_last_good(int(step))

    def rollback(self, template, shardings=None, **restore_kwargs):
        """Restore the ``last_good`` checkpoint (the latest committed step
        if none was ever tagged) and reset the divergence state so
        training can resume. Returns ``(state, step, meta)``, exactly
        ``Checkpointer.restore``'s; ``restore_kwargs`` (``device=``,
        ``mesh=``) go to it."""
        if self.checkpointer is None:
            raise RuntimeError(
                "watchdog rollback needs a checkpointer (construct with "
                "DivergenceWatchdog(checkpointer=...))")
        step = self.checkpointer.last_good_step()
        state, got, meta = self.checkpointer.restore(
            template, shardings, step=step, **restore_kwargs)
        self.rollbacks += 1
        self.registry.counter("guard_rollbacks_total").inc()
        log.warning("guard watchdog: rolled back to last_good step %d "
                    "(divergence: %s)", got, self._divergence)
        tracer = _trace.get_tracer()
        if tracer is not None:
            tracer.dump("rollback", extra={"restored_step": int(got),
                                           "reason": self._divergence})
        self._divergence = None
        self.consecutive_skips = 0
        self._ema = None
        self._n_finite = 0
        return state, got, meta
