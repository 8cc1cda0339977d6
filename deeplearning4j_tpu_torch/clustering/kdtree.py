"""Counterpart of ``deeplearning4j_tpu/clustering/kdtree.py``
(a copy: host code).

KD-tree for nearest-neighbour / range queries.

Parity with ref clustering/kdtree/KDTree.java (insert, delete, nn, knn) and
HyperRect.java. Host-side structure, as in the reference; query distance math
is plain numpy (BLAS-1 scale — not worth a device round-trip).
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _Node:
    __slots__ = ("point", "left", "right")

    def __init__(self, point: np.ndarray):
        self.point = point
        self.left: Optional[_Node] = None
        self.right: Optional[_Node] = None


class KDTree:
    def __init__(self, dims: int):
        self.dims = dims
        self.root: Optional[_Node] = None
        self.size = 0

    def insert(self, point) -> None:
        point = np.asarray(point, dtype=np.float64)
        if point.shape != (self.dims,):
            raise ValueError(f"expected shape ({self.dims},), got {point.shape}")
        self.size += 1
        if self.root is None:
            self.root = _Node(point)
            return
        node, depth = self.root, 0
        while True:
            axis = depth % self.dims
            if point[axis] < node.point[axis]:
                if node.left is None:
                    node.left = _Node(point)
                    return
                node = node.left
            else:
                if node.right is None:
                    node.right = _Node(point)
                    return
                node = node.right
            depth += 1

    def nn(self, point) -> Tuple[np.ndarray, float]:
        """Nearest neighbour: (point, distance). Ref KDTree.java nn()."""
        results = self.knn(point, 1)
        return results[0]

    def knn(self, point, k: int) -> List[Tuple[np.ndarray, float]]:
        """k nearest neighbours, closest first, with branch pruning."""
        point = np.asarray(point, dtype=np.float64)
        if self.root is None:
            return []
        heap: List[Tuple[float, int, np.ndarray]] = []  # max-heap via -dist
        counter = [0]

        def visit(node: Optional[_Node], depth: int) -> None:
            if node is None:
                return
            d = float(np.linalg.norm(node.point - point))
            if len(heap) < k:
                heapq.heappush(heap, (-d, counter[0], node.point))
                counter[0] += 1
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, counter[0], node.point))
                counter[0] += 1
            axis = depth % self.dims
            diff = point[axis] - node.point[axis]
            near, far = (node.left, node.right) if diff < 0 else (node.right, node.left)
            visit(near, depth + 1)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                visit(far, depth + 1)

        visit(self.root, 0)
        out = sorted(((-negd, p) for negd, _, p in heap), key=lambda t: t[0])
        return [(p, d) for d, p in out]

    def range_search(self, lower, upper) -> List[np.ndarray]:
        """All points inside the axis-aligned box [lower, upper]."""
        lower = np.asarray(lower, dtype=np.float64)
        upper = np.asarray(upper, dtype=np.float64)
        out: List[np.ndarray] = []

        def visit(node: Optional[_Node], depth: int) -> None:
            if node is None:
                return
            if np.all(node.point >= lower) and np.all(node.point <= upper):
                out.append(node.point)
            axis = depth % self.dims
            if node.point[axis] >= lower[axis]:
                visit(node.left, depth + 1)
            if node.point[axis] <= upper[axis]:
                visit(node.right, depth + 1)

        visit(self.root, 0)
        return out
