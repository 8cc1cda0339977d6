"""Counterpart of ``deeplearning4j_tpu/datasets/async_iterator.py``:
async prefetch wrappers feeding the device. ``AsyncDataSetIterator`` is
copied whole; ``NativeCSVDataSetIterator`` waits for the binding of the
native library (ROADMAP slice 6) and raises until then.

The reference feeds batches through an actor pipeline (BatchActor →
WorkerActor); the TPU equivalent is host-side prefetch ahead of device
infeed. Two paths:

- ``AsyncDataSetIterator``: wraps ANY DataSetIterator, a daemon thread keeps
  a bounded queue of upcoming batches while the device is busy.
- ``NativeCSVDataSetIterator``: full native path — the C++ loader
  (native/dataloader.cpp) parses + shuffles + batches in a background
  thread and python only slices the label column.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional


from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator

_SENTINEL = object()


class AsyncDataSetIterator(DataSetIterator):
    """Prefetch ``capacity`` batches from a backing iterator on a thread."""

    def __init__(self, backing: DataSetIterator, capacity: int = 4):
        self.backing = backing
        self.capacity = capacity
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._next_item = None
        self._producer_error: Optional[BaseException] = None
        self._start()

    def _start(self) -> None:
        self.backing.reset()
        self._queue = queue.Queue(maxsize=self.capacity)
        q = self._queue

        def produce():
            try:
                while self.backing.has_next():
                    q.put(self.backing.next())
            except BaseException as exc:  # surfaced from has_next()/next()
                self._producer_error = exc
            finally:
                q.put(_SENTINEL)

        self._producer_error = None
        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()
        self._next_item = None

    def reset(self) -> None:
        # drain the old producer completely so it can exit, then restart
        if self._thread is not None and self._thread.is_alive():
            while self._queue.get() is not _SENTINEL:
                pass
            self._thread.join()
        self._start()

    def has_next(self) -> bool:
        if self._next_item is None:
            self._next_item = self._queue.get()
        if self._next_item is _SENTINEL and self._producer_error is not None:
            exc, self._producer_error = self._producer_error, None
            raise exc
        return self._next_item is not _SENTINEL

    def next(self, num=None) -> DataSet:
        if not self.has_next():
            raise StopIteration
        item, self._next_item = self._next_item, None
        return item

    def batch(self) -> int:
        return self.backing.batch()

    def total_examples(self) -> int:
        return self.backing.total_examples()

    def input_columns(self) -> int:
        return self.backing.input_columns()

    def total_outcomes(self) -> int:
        return self.backing.total_outcomes()


class NativeCSVDataSetIterator(DataSetIterator):
    """DataSet batches straight from the native CSV prefetch loader (not
    ported yet)."""

    def __init__(self, path: str, batch_size: int, **kwargs):
        raise NotImplementedError(
            "NativeCSVDataSetIterator comes with ROADMAP slice 6, item 17 "
            "(the binding of the shared native/ library); "
            "AsyncDataSetIterator over a RecordReaderDataSetIterator reads "
            "the same CSV")
