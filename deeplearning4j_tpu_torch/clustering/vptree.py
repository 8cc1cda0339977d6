"""Counterpart of ``deeplearning4j_tpu/clustering/vptree.py`` (a copy:
numpy only): the vantage-point tree for metric nearest-neighbour search.

Parity with ref clustering/vptree/VPTree.java (build from items, search(target,
k) returning items + distances; euclidean default). Build is batch-recursive
over numpy arrays — the reference builds node-by-node with per-pair Java
distance calls; here each split computes all distances to the vantage point in
one vectorized op.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Sequence, Tuple

import numpy as np


class _VPNode:
    __slots__ = ("index", "threshold", "inside", "outside")

    def __init__(self, index: int, threshold: float,
                 inside: "Optional[_VPNode]", outside: "Optional[_VPNode]"):
        self.index = index
        self.threshold = threshold
        self.inside = inside
        self.outside = outside


class VPTree:
    def __init__(self, items: np.ndarray, labels: Optional[Sequence[str]] = None,
                 similarity: str = "euclidean", seed: int = 0):
        """items: (N,D). labels: optional per-row labels (ref wraps DataPoints)."""
        self.items = np.asarray(items, dtype=np.float64)
        self.labels = list(labels) if labels is not None else None
        if similarity not in ("euclidean", "cosine"):
            raise ValueError(f"unknown similarity {similarity!r}")
        self.similarity = similarity
        self._rng = np.random.RandomState(seed)
        if self.similarity == "cosine":
            norms = np.linalg.norm(self.items, axis=1, keepdims=True)
            self._normed = self.items / np.maximum(norms, 1e-12)
        self.root = self._build(list(range(len(self.items))))

    def _dist_many(self, index: int, others: np.ndarray) -> np.ndarray:
        if self.similarity == "cosine":
            return 1.0 - self._normed[others] @ self._normed[index]
        diff = self.items[others] - self.items[index]
        return np.linalg.norm(diff, axis=1)

    def _dist_point(self, target: np.ndarray, indices: np.ndarray) -> np.ndarray:
        if self.similarity == "cosine":
            t = target / max(np.linalg.norm(target), 1e-12)
            return 1.0 - self._normed[indices] @ t
        return np.linalg.norm(self.items[indices] - target, axis=1)

    def _build(self, indices: List[int]) -> Optional[_VPNode]:
        if not indices:
            return None
        vp = indices[self._rng.randint(len(indices))]
        rest = np.array([i for i in indices if i != vp], dtype=np.int64)
        if len(rest) == 0:
            return _VPNode(vp, 0.0, None, None)
        d = self._dist_many(vp, rest)
        threshold = float(np.median(d))
        inside = rest[d <= threshold]
        outside = rest[d > threshold]
        if len(inside) == len(rest):  # degenerate: all equal distances
            inside, outside = rest[: len(rest) // 2], rest[len(rest) // 2:]
        return _VPNode(vp, threshold,
                       self._build(list(inside)), self._build(list(outside)))

    def search(self, target, k: int) -> List[Tuple[int, float]]:
        """k nearest (index, distance) pairs, closest first. Ref VPTree.search."""
        target = np.asarray(target, dtype=np.float64)
        heap: List[Tuple[float, int]] = []  # max-heap on -distance
        tau = [np.inf]

        def visit(node: Optional[_VPNode]) -> None:
            if node is None:
                return
            d = float(self._dist_point(target, np.array([node.index]))[0])
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            elif d < tau[0]:
                heapq.heapreplace(heap, (-d, node.index))
                tau[0] = -heap[0][0]
            if d < node.threshold:
                visit(node.inside)
                if d + tau[0] >= node.threshold:
                    visit(node.outside)
            else:
                visit(node.outside)
                if d - tau[0] <= node.threshold:
                    visit(node.inside)

        visit(self.root)
        return sorted(((i, -negd) for negd, i in heap), key=lambda t: t[1])

    def word_for(self, index: int) -> Optional[str]:
        return self.labels[index] if self.labels else None
