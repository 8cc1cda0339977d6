"""Counterpart of ``deeplearning4j_tpu/utils/profiling.py``: device traces,
scoped annotations and device-memory introspection, over
``torch.profiler`` and the CUDA caching allocator.

- ``trace(log_dir)`` records CPU activity and, on the card, CUDA activity
  (the kernels, ours among them) for the enclosed block and writes one
  Chrome trace (``trace_<pid>_<n>.json``) into ``log_dir``;
- ``annotate``/``named_scope`` name a range on that trace
  (``torch.profiler.record_function``);
- ``device_memory_stats`` gives one dict per CUDA device (bytes in use,
  peak, limit), empty dicts on the CPU;
- ``ProfilerIterationListener`` traces a window of a live training run;
- ``save_device_memory_profile`` writes the CUDA allocator's memory
  snapshot (``torch.cuda.memory._snapshot``), and raises on the CPU.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import pickle
from typing import Dict, List

import torch

_traces = itertools.count()


def _activities() -> list:
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _trace_path(log_dir: str) -> str:
    return os.path.join(log_dir,
                        f"trace_{os.getpid()}_{next(_traces)}.json")


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a CPU (and, with a card, CUDA) trace of the enclosed block
    into ``log_dir`` as a Chrome trace JSON, the device-side truth of
    where the time went."""
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        yield prof
    prof.export_chrome_trace(_trace_path(log_dir))


def annotate(name: str):
    """A named range on the trace timeline (e.g. ``with
    annotate("pretrain-layer0"): ...``)."""
    return torch.profiler.record_function(name)


def named_scope(name: str):
    """The JAX package's in-graph twin of ``annotate``. An eager step has
    no graph: the range is recorded as the ops run, on the host and (under
    ``trace``) beside the kernels they launch."""
    return torch.profiler.record_function(name)


def device_memory_stats() -> List[Dict]:
    """Per-device memory stats: ``bytes_in_use``, ``peak_bytes_in_use``,
    ``bytes_reserved`` and ``bytes_limit`` of each CUDA device; one dict
    holding only the device's name on the CPU."""
    if not torch.cuda.is_available():
        return [{"device": "cpu"}]
    out = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        out.append({"device": f"cuda:{i}",
                    "bytes_in_use": torch.cuda.memory_allocated(i),
                    "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
                    "bytes_reserved": torch.cuda.memory_reserved(i),
                    "bytes_limit": total})
    return out


class ProfilerIterationListener:
    """IterationListener that traces a window of a live training run: drop
    it into ``net.listeners``.

    Window semantics: listeners fire AFTER each iteration's compute, so
    the trace opens once the ``start``-th callback has fired and spans the
    NEXT ``steps`` iterations (callbacks start+1 … start+steps).
    ``start=0`` opens the window at the first callback. ``close()`` stops
    a still-open trace (training ended inside the window)."""

    def __init__(self, log_dir: str, start: int = 1, steps: int = 3):
        self.log_dir = log_dir
        self.start = start
        self.steps = steps
        self._active = False
        self._done = False
        self._seen = 0
        self._traced = 0
        self._prof = None

    def _start_trace(self) -> None:
        os.makedirs(self.log_dir, exist_ok=True)
        self._prof = torch.profiler.profile(activities=_activities())
        self._prof.start()

    def _stop_trace(self) -> None:
        prof, self._prof = self._prof, None
        prof.stop()
        prof.export_chrome_trace(_trace_path(self.log_dir))

    def __call__(self, model, iteration: int, score: float) -> None:
        self._seen += 1
        if self._active:
            self._traced += 1
            if self._traced >= self.steps:
                self._stop_trace()
                self._active = False
                self._done = True
            return
        if not self._done and self._seen >= self.start:
            self._start_trace()
            self._active = True
            self._traced = 0

    def close(self) -> None:
        """Stop a still-open trace (training ended inside the window)."""
        if self._active:
            self._stop_trace()
            self._active = False
            self._done = True


def save_device_memory_profile(path: str) -> str:
    """Write the CUDA allocator's memory snapshot (a pickle that
    ``torch.cuda.memory``'s viewer reads): allocation attribution for OOM
    hunts. Raises on a host without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError("save_device_memory_profile reads the CUDA "
                           "caching allocator; this host has no CUDA "
                           "device")
    snapshot = torch.cuda.memory._snapshot()
    with open(path, "wb") as f:
        pickle.dump(snapshot, f)
    return path
