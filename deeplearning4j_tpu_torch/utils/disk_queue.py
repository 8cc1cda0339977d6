"""Counterpart of ``deeplearning4j_tpu/utils/disk_queue.py``
(a copy: host code).

DiskBasedQueue (ref util/DiskBasedQueue.java, 205 LoC): FIFO whose
elements are spilled to disk so arbitrarily large work queues don't hold
memory. Elements are pickled one file per item under a spool directory."""

from __future__ import annotations

import os
import pickle
import tempfile
import threading
from collections import deque
from typing import Any, Optional


class DiskBasedQueue:
    def __init__(self, spool_dir: Optional[str] = None):
        self._dir = spool_dir or tempfile.mkdtemp(prefix="dl4j-queue-")
        os.makedirs(self._dir, exist_ok=True)
        self._order: deque = deque()
        self._seq = 0
        self._lock = threading.Lock()

    def add(self, item: Any) -> None:
        with self._lock:
            path = os.path.join(self._dir, f"item-{self._seq:012d}.pkl")
            self._seq += 1
            # graftlint: allow[blocking-under-lock] deliberate: disk IO IS this queue's critical section — seq/file/deque must commit atomically (ref DiskBasedQueue semantics)
            with open(path, "wb") as f:
                pickle.dump(item, f)
            self._order.append(path)

    def poll(self) -> Optional[Any]:
        """Remove and return the head, or None when empty."""
        with self._lock:
            if not self._order:
                return None
            path = self._order.popleft()
            # graftlint: allow[blocking-under-lock] deliberate: the read+unlink must be atomic with the dequeue or a concurrent peek() reads a vanishing file
            with open(path, "rb") as f:
                item = pickle.load(f)
            os.unlink(path)
            return item

    def peek(self) -> Optional[Any]:
        # read under the lock: a concurrent poll() may unlink the head file
        with self._lock:
            if not self._order:
                return None
            # graftlint: allow[blocking-under-lock] deliberate: reading the head under the lock is the documented guard against a concurrent poll() unlinking it
            with open(self._order[0], "rb") as f:
                return pickle.load(f)

    def is_empty(self) -> bool:
        with self._lock:
            return not self._order

    def __len__(self) -> int:
        with self._lock:
            return len(self._order)

    def clear(self) -> None:
        with self._lock:
            while self._order:
                os.unlink(self._order.popleft())
