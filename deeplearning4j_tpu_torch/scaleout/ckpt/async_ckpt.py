"""Counterpart of ``deeplearning4j_tpu/scaleout/ckpt/async_ckpt.py``:
snapshots saved off the training thread.

A blocking ``Checkpointer.save`` copies every leaf to the host and fsyncs
the files on the training thread, so the step time spikes at save steps
by the whole copy and write. ``AsyncCheckpointer`` moves that to a writer
thread:

- ``save(step, state)`` starts the device-to-host copies at once: every
  CUDA leaf is copied ``non_blocking`` into a pinned host buffer on a side
  stream that first waits for the work already enqueued on the current
  stream (so the copy holds the values as of the call), and one event
  marks the copies' end; a CPU leaf is cloned. The snapshot is enqueued
  and ``save`` returns; the writer thread waits on the event and runs the
  ordinary manifest-committed save of the host tree.
- The queue holds ``max_pending`` snapshots (2: one draining, one on
  deck). A save while it is full blocks, which bumps
  ``<prefix>_async_backpressure``: checkpoints made faster than the disk
  drains them apply backpressure instead of growing memory.
- A failed background save cannot raise on the caller's stack: it is
  counted (``<prefix>_async_failures_total``), logged, kept as
  ``last_error`` and re-raised at the next ``flush()``/``close()``.

The source tensors are kept alive and marked used on the side stream
(``record_stream``) until their copy is done, so a step that frees or
rebinds them is safe; a step that writes them IN PLACE (``donate=True``)
before the copy ends is not, as with JAX's donated buffers: ``flush()``
first. Atomicity is the checkpointer's: the writer thread calls the same
manifest-commit-last path. A plain lock guards ``last_error``.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch._device import tree_map
from deeplearning4j_tpu_torch.telemetry import trace as _trace
from deeplearning4j_tpu_torch.utils.lockwatch import make_lock

log = logging.getLogger(__name__)

_SENTINEL = object()


def _start_host_copies(state):
    """``(host tree, event, sources)``: pinned host copies of every CUDA
    leaf enqueued on a side stream behind the current stream's work (the
    event marks their end; None without CUDA leaves), CPU leaves cloned,
    other leaves as they are."""
    leaves = []

    def collect(_path, x):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            leaves.append(x)
        return x

    tree_map(collect, state)
    if not leaves:
        return tree_map(lambda _, x: x.detach().clone()
                        if isinstance(x, torch.Tensor) else x, state), \
            None, ()
    device = leaves[0].device
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        def copy(_path, x):
            if not isinstance(x, torch.Tensor):
                return x
            if not x.is_cuda:
                return x.detach().clone()
            x.record_stream(side)
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x.detach(), non_blocking=True)
            return host

        host_tree = tree_map(copy, state)
        event = torch.cuda.Event()
        event.record(side)
    return host_tree, event, tuple(leaves)


class AsyncCheckpointer:
    """A ``Checkpointer`` facade whose saves run on a writer thread.
    Restore, latest and retention delegate to the wrapped checkpointer,
    flushing pending saves first where staleness would surprise (a
    restore right after a save sees that save)."""

    def __init__(self, checkpointer, max_pending: int = 2):
        self._ck = checkpointer
        self.registry = checkpointer.registry
        self.prefix = checkpointer.prefix
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, max_pending))
        self._error_lock = make_lock("ckpt.async.error")
        self.last_error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._writer_loop,
                                        daemon=True, name="ckpt-writer")
        self._thread.start()

    # ---------------------------------------------------------- writes ----
    def save(self, step: int, state, meta: Optional[Dict] = None,
             mesh=None, specs=None) -> None:
        """Start the snapshot's device-to-host copies, enqueue it and
        return (the commit happens on the writer thread). Blocks only
        while ``max_pending`` snapshots wait."""
        reg, p = self.registry, self.prefix
        host, event, sources = _start_host_copies(state)
        # the caller's span context rides the queue item, so the writer's
        # ``ckpt.async_write`` span parents under the operation that asked
        item = (int(step), host, event, sources, dict(meta or {}), mesh,
                specs, _trace.current_trace_context())
        if self._queue.full():
            reg.counter(f"{p}_async_backpressure").inc()
        self._queue.put(item)
        reg.gauge(f"{p}_async_pending").set(float(self._queue.qsize()))

    def _writer_loop(self) -> None:
        reg, p = self.registry, self.prefix
        while True:
            item = self._queue.get()
            if item is _SENTINEL:
                self._queue.task_done()
                return
            step, host, event, sources, meta, mesh, specs, ctx = item
            tracer = _trace.get_tracer()
            try:
                if event is not None:
                    event.synchronize()
                del sources
                write_cm = (tracer.span("ckpt.async_write",
                                        parent=ctx or False,
                                        attrs={"step": step})
                            if tracer is not None
                            else contextlib.nullcontext())
                with write_cm:
                    self._ck.save(step, host, meta=meta, mesh=mesh,
                                  specs=specs)
                reg.counter(f"{p}_async_saves_total").inc()
            except BaseException as exc:  # surfaced at flush()/close()
                with self._error_lock:
                    self.last_error = exc
                reg.counter(f"{p}_async_failures_total").inc()
                log.exception("background checkpoint save for step %s "
                              "failed", step)
            finally:
                del item
                self._queue.task_done()
                reg.gauge(f"{p}_async_pending").set(
                    float(self._queue.qsize()))

    # ----------------------------------------------------------- sync ----
    def flush(self) -> None:
        """Block until every enqueued save has committed; re-raise the
        first background failure since the last flush."""
        self._queue.join()
        with self._error_lock:
            exc, self.last_error = self.last_error, None
        if exc is not None:
            raise exc

    def close(self) -> None:
        self.flush()
        self._queue.put(_SENTINEL)
        self._thread.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------- delegates ----
    def restore(self, template, shardings=None, step=None, device=None,
                mesh=None):
        self.flush()  # a restore must see the saves issued before it
        return self._ck.restore(template, shardings=shardings, step=step,
                                device=device, mesh=mesh)

    def restore_net(self, step=None, device=None):
        self.flush()
        return self._ck.restore_net(step=step, device=device)

    def latest_step(self):
        self.flush()
        return self._ck.latest_step()

    def step_dirs(self):
        return self._ck.step_dirs()

    def mark_last_good(self, step: int) -> None:
        # the tag must never name a step whose save is still in flight
        self.flush()
        self._ck.mark_last_good(step)

    def last_good_step(self):
        return self._ck.last_good_step()

    def gc(self) -> None:
        self._ck.gc()

    @property
    def root(self) -> str:
        return self._ck.root
