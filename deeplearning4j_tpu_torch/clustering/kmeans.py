"""Counterpart of ``deeplearning4j_tpu/clustering/kmeans.py``: k-means with
the Lloyd iterations on the card.

Parity with ref clustering/kmeans/KMeansClustering.java:31 (setup with fixed
iteration count or min distribution-variation rate, euclidean/cosine distance)
over clustering/algorithm/BaseClusteringAlgorithm.java (init random centers →
iterate: assign points, recompute centers, check condition).

The k-means++ seeding is the JAX package's host numpy with
``np.random.RandomState(seed)``, so the seeded centers equal JAX's. One
Lloyd iteration is plain torch on the points' device (the JAX package's
jitted ``_lloyd_step``, no Pallas kernel): an (N, K) distance matrix
(‖x‖² − 2x·cᵀ + ‖c‖², one matrix product), the argmin, and the centers
recomputed by ``index_add_`` over the assignment (the card sums colliding
rows with atomics, in no fixed order). The convergence loop stays on the
host so the ConvergenceCondition / FixedIterationCountCondition semantics
match the reference; in fixed-iteration mode the costs stay on the device
until the loop ends and come back in one transfer.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.clustering.cluster import Cluster, ClusterSet, \
    Point


def _assign(points: torch.Tensor, centers: torch.Tensor,
            distance: str) -> torch.Tensor:
    """(N,) index of each point's nearest center."""
    if distance == "cosine":
        pn = points / (points.norm(dim=1, keepdim=True) + 1e-12)
        cn = centers / (centers.norm(dim=1, keepdim=True) + 1e-12)
        return (pn @ cn.T).argmax(1)
    if distance == "manhattan":
        return torch.cdist(points, centers, p=1).argmin(1)
    # euclidean: squared-euclidean is matmul-shaped and argmin-equal
    sq = ((points * points).sum(1, keepdim=True) - 2.0 * points @ centers.T
          + (centers * centers).sum(1)[None, :])
    return sq.argmin(1)


def _lloyd_step(points: torch.Tensor, centers: torch.Tensor, k: int,
                distance: str):
    """One Lloyd iteration: assign, then the centers recomputed from their
    members' sum; an empty cluster keeps its previous center (the
    reference keeps stale centers too). Returns (centers, assign, counts,
    cost), cost the mean squared distance to the assigned center, a 0-d
    tensor on the points' device."""
    assign = _assign(points, centers, distance)
    counts = torch.bincount(assign, minlength=k).to(points.dtype)
    sums = torch.zeros_like(centers).index_add_(0, assign, points)
    new_centers = torch.where(counts[:, None] > 0,
                              sums / counts.clamp_min(1.0)[:, None], centers)
    diffs = points - new_centers[assign]
    cost = (diffs * diffs).sum(-1).mean()
    return new_centers, assign, counts, cost


class KMeansClustering:
    """K-means with the reference's two stopping modes.

    ``setup(k, max_iterations, distance)``: fixed iteration count
    (ref KMeansClustering.java:43); ``setup_convergence(k, rate, distance)``:
    stop when the relative cost improvement falls below ``rate``
    (ref :49, VarianceVariationCondition). ``device`` is where the Lloyd
    iterations run: CUDA unless the caller passes ``"cpu"``.
    """

    def __init__(
        self,
        k: int,
        max_iterations: int = 100,
        distance: str = "euclidean",
        min_variation_rate: Optional[float] = None,
        seed: int = 123,
        device: DeviceLike = None,
    ):
        if distance not in ("euclidean", "cosine", "manhattan"):
            raise ValueError(f"unknown distance {distance!r}")
        self.k = k
        self.max_iterations = max_iterations
        self.distance = distance
        self.min_variation_rate = min_variation_rate
        self.seed = seed
        self.device = resolve_device(device)
        self.iteration_costs: List[float] = []

    @classmethod
    def setup(cls, k: int, max_iterations: int, distance: str = "euclidean",
              seed: int = 123, device: DeviceLike = None
              ) -> "KMeansClustering":
        return cls(k, max_iterations=max_iterations, distance=distance,
                   seed=seed, device=device)

    @classmethod
    def setup_convergence(cls, k: int, min_variation_rate: float,
                          distance: str = "euclidean",
                          max_iterations: int = 1000, seed: int = 123,
                          device: DeviceLike = None) -> "KMeansClustering":
        return cls(k, max_iterations=max_iterations, distance=distance,
                   min_variation_rate=min_variation_rate, seed=seed,
                   device=device)

    def _kpp_init(self, data: np.ndarray) -> np.ndarray:
        """k-means++ seeding (D² sampling), the JAX package's draws: the
        min over the centers so far is kept as a running minimum, which
        equals JAX's min over the list of every center's distances
        element for element, at one distance pass a center."""
        rng = np.random.RandomState(self.seed)
        n = data.shape[0]
        centers = [data[rng.randint(n)]]
        d2 = None
        for _ in range(1, self.k):
            last = ((data - centers[-1]) ** 2).sum(1)
            d2 = last if d2 is None else np.minimum(d2, last)
            probs = d2 / max(d2.sum(), 1e-12)
            centers.append(data[rng.choice(n, p=probs)])
        return np.stack(centers)

    def apply_to(self, points) -> ClusterSet:
        """Run clustering; accepts an (N,D) array or a list of Points."""
        if isinstance(points, (list, tuple)):
            point_objs = list(points)
            data = np.stack([p.array for p in point_objs])
        else:
            data = np.asarray(points, dtype=np.float32)
            point_objs = Point.to_points(data)
        n = data.shape[0]
        if n < self.k:
            raise ValueError(f"need at least k={self.k} points, got {n}")

        x = torch.as_tensor(np.asarray(data, np.float32), device=self.device)
        centers = torch.as_tensor(self._kpp_init(data).astype(np.float32),
                                  device=self.device)

        prev_cost = None
        assign = None
        costs: list = []  # fixed-iteration mode: 0-d tensors on the device
        for _ in range(self.max_iterations):
            centers, assign, _counts, cost = _lloyd_step(
                x, centers, self.k, self.distance)
            if self.min_variation_rate is None:
                costs.append(cost)
                continue
            cost = float(cost)  # the stop decision needs it on the host
            costs.append(cost)
            if prev_cost is not None:
                variation = abs(prev_cost - cost) / max(abs(prev_cost), 1e-12)
                if variation < self.min_variation_rate:
                    break
            prev_cost = cost
        if costs and isinstance(costs[0], torch.Tensor):
            costs = torch.stack(costs).cpu().tolist()
        self.iteration_costs = [float(c) for c in costs]

        centers_np = centers.cpu().numpy()
        assign_np = assign.cpu().numpy()
        clusters = [Cluster(center=centers_np[i]) for i in range(self.k)]
        for idx, p in zip(assign_np, point_objs):
            clusters[int(idx)].add_point(p)
        return ClusterSet(clusters=clusters)
