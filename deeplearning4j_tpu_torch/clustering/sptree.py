"""Counterpart of ``deeplearning4j_tpu/clustering/sptree.py``
(a copy: host code).

SpTree: n-dimensional Barnes-Hut space-partition tree.

Parity with ref clustering/sptree/SpTree.java (2^d children per node,
center-of-mass accumulation, computeEdgeForces / computeNonEdgeForces for
Barnes-Hut t-SNE gradients) + Cell.java.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class SpTree:
    NODE_RATIO = 8000.0

    def __init__(self, data: Optional[np.ndarray] = None,
                 corner: Optional[np.ndarray] = None,
                 width: Optional[np.ndarray] = None):
        if data is not None:
            data = np.asarray(data, dtype=np.float64)
            self.dims = data.shape[1]
            mean = data.mean(0)
            width_ = np.abs(data - mean).max(0) + 1e-5
            self._init_node(mean, width_)
            for i, row in enumerate(data):
                self.insert(row, i)
        else:
            self.dims = len(corner)
            self._init_node(np.asarray(corner, float), np.asarray(width, float))

    def _init_node(self, corner: np.ndarray, width: np.ndarray) -> None:
        self.corner = corner  # center of the cell
        self.width = width  # half-width per dim
        self.center_of_mass = np.zeros(self.dims)
        self.cum_size = 0
        self.point: Optional[np.ndarray] = None
        self.index = -1
        self.is_leaf = True
        self.num_children = 2 ** self.dims
        self.children: List[Optional[SpTree]] = [None] * self.num_children

    def _contains(self, point: np.ndarray) -> bool:
        return bool(np.all(np.abs(point - self.corner) <= self.width + 1e-12))

    def insert(self, point: np.ndarray, index: int = -1) -> bool:
        point = np.asarray(point, dtype=np.float64)
        if not self._contains(point):
            return False
        self.cum_size += 1
        frac = 1.0 / self.cum_size
        self.center_of_mass = (1 - frac) * self.center_of_mass + frac * point
        if self.is_leaf and self.point is None:
            self.point, self.index = point, index
            return True
        if self.point is not None and np.allclose(self.point, point):
            return True
        if self.is_leaf:
            self._subdivide()
        for i in range(self.num_children):
            child = self._child(i)
            if child.insert(point, index):
                return True
        return False

    def _child(self, i: int) -> "SpTree":
        if self.children[i] is None:
            offset = np.array([(1 if (i >> d) & 1 else -1)
                               for d in range(self.dims)], dtype=np.float64)
            half = self.width / 2
            self.children[i] = SpTree(corner=self.corner + offset * half,
                                      width=half)
        return self.children[i]

    def _subdivide(self) -> None:
        old_point, old_index = self.point, self.index
        self.point, self.index, self.is_leaf = None, -1, False
        for i in range(self.num_children):
            if self._child(i).insert(old_point, old_index):
                return

    def is_correct(self) -> bool:
        if self.point is not None and not self._contains(self.point):
            return False
        if self.is_leaf:
            return True
        return all(ch is None or ch.is_correct() for ch in self.children)

    def compute_non_edge_forces(self, point_index: int, point: np.ndarray,
                                theta: float, neg_f: np.ndarray) -> float:
        """Accumulate Barnes-Hut repulsion into neg_f; return Z contribution.
        Ref SpTree.computeNonEdgeForces."""
        if self.cum_size == 0 or (self.is_leaf and self.index == point_index):
            return 0.0
        diff = point - self.center_of_mass
        dist2 = float(diff @ diff)
        max_width = float(self.width.max()) * 2
        if self.is_leaf or max_width / np.sqrt(max(dist2, 1e-12)) < theta:
            q = 1.0 / (1.0 + dist2)
            mult = self.cum_size * q
            neg_f += mult * q * diff
            return mult
        total = 0.0
        for ch in self.children:
            if ch is not None:
                total += ch.compute_non_edge_forces(point_index, point, theta, neg_f)
        return total

    @staticmethod
    def compute_edge_forces(rows: np.ndarray, cols: np.ndarray,
                            vals: np.ndarray, y: np.ndarray) -> np.ndarray:
        """Attractive forces for sparse P (CSR rows/cols/vals), vectorized.
        Ref SpTree.computeEdgeForces (per-entry Java loop)."""
        n = y.shape[0]
        pos_f = np.zeros_like(y)
        for i in range(n):
            js = cols[rows[i]:rows[i + 1]]
            if len(js) == 0:
                continue
            diff = y[i] - y[js]
            q = vals[rows[i]:rows[i + 1]] / (1.0 + (diff * diff).sum(1))
            pos_f[i] = (q[:, None] * diff).sum(0)
        return pos_f
