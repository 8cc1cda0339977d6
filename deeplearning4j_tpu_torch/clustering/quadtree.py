"""Counterpart of ``deeplearning4j_tpu/clustering/quadtree.py``
(a copy: host code).

Quad-tree over 2-D points (Barnes-Hut helper).

Parity with ref clustering/quadtree/QuadTree.java + Cell.java: subdivide,
center-of-mass per cell, ``compute_non_edge_forces`` with the theta criterion,
and ``is_correct`` invariant used by the reference tests.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

QT_NODE_CAPACITY = 1  # ref QuadTree.java: one point per leaf


class Cell:
    """Axis-aligned square: center (x,y) and half-dimensions (hw,hh)."""

    __slots__ = ("x", "y", "hw", "hh")

    def __init__(self, x: float, y: float, hw: float, hh: float):
        self.x, self.y, self.hw, self.hh = x, y, hw, hh

    def contains(self, px: float, py: float) -> bool:
        return (self.x - self.hw <= px <= self.x + self.hw
                and self.y - self.hh <= py <= self.y + self.hh)


class QuadTree:
    def __init__(self, data: Optional[np.ndarray] = None,
                 cell: Optional[Cell] = None):
        """data: (N,2) — builds the full tree by inserting every row."""
        self.cell = cell
        self.center_of_mass = np.zeros(2)
        self.cum_size = 0
        self.point: Optional[np.ndarray] = None
        self.index = -1
        self.is_leaf = True
        self.children: List[Optional[QuadTree]] = [None, None, None, None]
        if data is not None:
            data = np.asarray(data, dtype=np.float64)
            mean = data.mean(0)
            span = np.abs(data - mean).max(0) + 1e-5
            self.cell = Cell(mean[0], mean[1], span[0], span[1])
            for i, row in enumerate(data):
                self.insert(row, i)

    def insert(self, point: np.ndarray, index: int = -1) -> bool:
        point = np.asarray(point, dtype=np.float64)
        if self.cell is None:
            raise ValueError("tree has no bounding cell")
        if not self.cell.contains(point[0], point[1]):
            return False
        # update cumulative center of mass (ref QuadTree.insert)
        self.cum_size += 1
        frac = 1.0 / self.cum_size
        self.center_of_mass = (1 - frac) * self.center_of_mass + frac * point
        if self.is_leaf and self.point is None:
            self.point, self.index = point, index
            return True
        if self.point is not None and np.allclose(self.point, point):
            return True  # duplicate point: mass already counted
        if self.is_leaf:
            self._subdivide()
        for child in self.children:
            if child.insert(point, index):
                return True
        return False

    def _subdivide(self) -> None:
        c = self.cell
        hw, hh = c.hw / 2, c.hh / 2
        quads = [(c.x - hw, c.y - hh), (c.x + hw, c.y - hh),
                 (c.x - hw, c.y + hh), (c.x + hw, c.y + hh)]
        self.children = [QuadTree(cell=Cell(x, y, hw, hh)) for x, y in quads]
        old_point, old_index = self.point, self.index
        self.point, self.index, self.is_leaf = None, -1, False
        for child in self.children:
            if child.insert(old_point, old_index):
                break

    def is_correct(self) -> bool:
        """Every stored point lies inside its node's cell (ref isCorrect)."""
        if self.point is not None and not self.cell.contains(*self.point):
            return False
        return self.is_leaf or all(ch.is_correct() for ch in self.children)

    def depth(self) -> int:
        if self.is_leaf:
            return 1
        return 1 + max(ch.depth() for ch in self.children)

    def compute_non_edge_forces(self, point_index: int, point: np.ndarray,
                                theta: float, neg_f: np.ndarray) -> float:
        """Barnes-Hut repulsive force accumulation; returns this node's
        contribution to Z (sum_q). Ref QuadTree.computeNonEdgeForces."""
        if self.cum_size == 0 or (self.is_leaf and self.index == point_index):
            return 0.0
        diff = point - self.center_of_mass
        dist2 = float(diff @ diff)
        max_width = max(self.cell.hw, self.cell.hh) * 2
        if self.is_leaf or max_width / np.sqrt(max(dist2, 1e-12)) < theta:
            q = 1.0 / (1.0 + dist2)
            mult = self.cum_size * q
            neg_f += mult * q * diff
            return mult
        return sum(ch.compute_non_edge_forces(point_index, point, theta, neg_f)
                   for ch in self.children)
