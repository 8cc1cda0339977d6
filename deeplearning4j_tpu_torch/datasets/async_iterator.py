"""Counterpart of ``deeplearning4j_tpu/datasets/async_iterator.py``,
copied whole: async prefetch wrappers feeding the device;
``NativeCSVDataSetIterator`` runs over the port's binding of the native
library (``native.lib.NativeCSVLoader``).

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

import numpy as np

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
    """DataSet batches straight from the native CSV prefetch loader."""

    def __init__(self, path: str, batch_size: int,
                 num_possible_labels: Optional[int] = None,
                 label_index: int = -1, delimiter: str = ",",
                 skip_lines: int = 0, shuffle_seed: int = 0,
                 queue_capacity: int = 4):
        from deeplearning4j_tpu_torch.native import NativeCSVLoader

        self.path = path
        self.batch_size = batch_size
        self.num_possible_labels = num_possible_labels
        self.label_index = label_index
        self._mk = lambda: NativeCSVLoader(
            path, batch_size, delimiter=delimiter, skip_lines=skip_lines,
            shuffle_seed=shuffle_seed, queue_capacity=queue_capacity,
        )
        self._loader = self._mk()
        self._iter = iter(self._loader)
        self._pending: Optional[np.ndarray] = None

    @property
    def native(self) -> bool:
        return self._loader.native

    def reset(self) -> None:
        self._loader.close()
        self._loader = self._mk()
        self._iter = iter(self._loader)
        self._pending = None

    def has_next(self) -> bool:
        if self._pending is None:
            self._pending = next(self._iter, None)
        return self._pending is not None

    def next(self, num=None) -> DataSet:
        if not self.has_next():
            raise StopIteration
        mat, self._pending = self._pending, None
        li = self.label_index if self.label_index >= 0 else mat.shape[1] - 1
        labels_col = mat[:, li]
        features = np.delete(mat, li, axis=1)
        if self.num_possible_labels is None:
            labels = labels_col[:, None]
        else:
            idx = labels_col.astype(int)
            labels = np.zeros((len(mat), self.num_possible_labels), np.float32)
            labels[np.arange(len(mat)), idx] = 1.0
        return DataSet(features, labels)

    def batch(self) -> int:
        return self.batch_size

    def total_examples(self) -> int:
        return int(self._loader.rows)

    def input_columns(self) -> int:
        return int(self._loader.cols) - 1

    def total_outcomes(self) -> int:
        return self.num_possible_labels if self.num_possible_labels else 1

    def close(self) -> None:
        self._loader.close()
