"""Counterpart of ``deeplearning4j_tpu/clustering/cluster.py``
(a copy: host code).

Point/Cluster/ClusterSet containers.

Parity with ref clustering/cluster/{Point,Cluster,ClusterSet}.java — light
host-side containers; the math lives in kmeans.py on device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class Point:
    """A single point (ref clustering/cluster/Point.java)."""

    array: np.ndarray
    id: Optional[str] = None
    label: Optional[str] = None

    @staticmethod
    def to_points(matrix: np.ndarray) -> List["Point"]:
        return [Point(np.asarray(row)) for row in matrix]


@dataclass
class Cluster:
    """A centroid plus its member points (ref clustering/cluster/Cluster.java)."""

    center: np.ndarray
    points: List[Point] = field(default_factory=list)
    id: Optional[str] = None

    def add_point(self, point: Point) -> None:
        self.points.append(point)

    def distance_to_center(self, point: Point) -> float:
        return float(np.linalg.norm(point.array - self.center))


@dataclass
class ClusterSet:
    """All clusters of one run (ref clustering/cluster/ClusterSet.java)."""

    clusters: List[Cluster] = field(default_factory=list)

    @property
    def centers(self) -> np.ndarray:
        return np.stack([c.center for c in self.clusters])

    def nearest_cluster(self, point: Point) -> Cluster:
        d = np.linalg.norm(self.centers - point.array, axis=1)
        return self.clusters[int(np.argmin(d))]

    def classify_point(self, point: Point, add: bool = True) -> Cluster:
        cluster = self.nearest_cluster(point)
        if add:
            cluster.add_point(point)
        return cluster
