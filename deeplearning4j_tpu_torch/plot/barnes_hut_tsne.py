"""Counterpart of ``deeplearning4j_tpu/plot/barnes_hut_tsne.py``
(a copy: host code over the port's ``clustering.sptree`` and
``clustering.vptree``).

Barnes-Hut t-SNE (O(N log N)).

Parity with ref plot/BarnesHutTsne.java:62-109 (implements Model; sparse kNN
affinities via VPTree, SpTree-accelerated gradient with theta criterion,
gradient() / fit() surface). The sparse P construction vectorizes the per-row
Gaussian calibration; the tree walk stays on host as in the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.clustering.sptree import SpTree
from deeplearning4j_tpu_torch.clustering.vptree import VPTree


def _knn_affinities(x: np.ndarray, k: int, perplexity: float,
                    tol: float = 1e-5, iters: int = 50):
    """Sparse row-stochastic affinities over each point's k nearest
    neighbours (ref BarnesHutTsne.computeGaussianPerplexity)."""
    n = x.shape[0]
    tree = VPTree(x)
    rows = np.zeros(n + 1, np.int64)
    cols = np.zeros(n * k, np.int64)
    vals = np.zeros(n * k, np.float64)
    log_u = np.log(perplexity)
    for i in range(n):
        nbrs = tree.search(x[i], k + 1)
        nbrs = [(j, d) for j, d in nbrs if j != i][:k]
        idx = np.array([j for j, _ in nbrs])
        d2 = np.array([d for _, d in nbrs]) ** 2
        beta, lo, hi = 1.0, 0.0, np.inf
        for _ in range(iters):
            p = np.exp(-d2 * beta)
            psum = max(p.sum(), 1e-12)
            h = np.log(psum) + beta * (d2 * p).sum() / psum
            diff = h - log_u
            if abs(diff) < tol:
                break
            if diff > 0:
                lo = beta
                beta = beta * 2.0 if np.isinf(hi) else (beta + hi) / 2.0
            else:
                hi = beta
                beta = beta / 2.0 if lo <= 0 else (beta + lo) / 2.0
        p = np.exp(-d2 * beta)
        p /= max(p.sum(), 1e-12)
        rows[i + 1] = rows[i] + len(idx)
        cols[rows[i]:rows[i + 1]] = idx
        vals[rows[i]:rows[i + 1]] = p
    cols, vals = cols[: rows[n]], vals[: rows[n]]
    # symmetrize the sparse matrix: P = (P + Pᵀ) / (2N)
    from collections import defaultdict
    sym = defaultdict(float)
    for i in range(n):
        for ptr in range(rows[i], rows[i + 1]):
            j = cols[ptr]
            sym[(i, j)] += vals[ptr] / 2.0
            sym[(j, i)] += vals[ptr] / 2.0
    out_rows = np.zeros(n + 1, np.int64)
    entries = sorted(sym.items())
    out_cols = np.array([j for (_, j), _ in entries], np.int64)
    out_vals = np.array([v for _, v in entries], np.float64)
    for (i, _), _ in entries:
        out_rows[i + 1] += 1
    out_rows = np.cumsum(out_rows)
    out_vals /= max(out_vals.sum(), 1e-12)
    return out_rows, out_cols, out_vals


class BarnesHutTsne:
    """theta-approximate t-SNE; theta=0 reduces to the exact gradient
    (ref BarnesHutTsne.java field theta, default 0.5)."""

    def __init__(
        self,
        n_components: int = 2,
        theta: float = 0.5,
        perplexity: float = 30.0,
        learning_rate: float = 200.0,
        max_iter: int = 500,
        initial_momentum: float = 0.5,
        final_momentum: float = 0.8,
        switch_momentum_iteration: int = 250,
        stop_lying_iteration: int = 250,
        exaggeration: float = 12.0,
        min_gain: float = 0.01,
        seed: int = 123,
    ):
        self.n_components = n_components
        self.theta = theta
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.max_iter = max_iter
        self.initial_momentum = initial_momentum
        self.final_momentum = final_momentum
        self.switch_momentum_iteration = switch_momentum_iteration
        self.stop_lying_iteration = stop_lying_iteration
        self.exaggeration = exaggeration
        self.min_gain = min_gain
        self.seed = seed
        self.y: Optional[np.ndarray] = None

    def gradient(self, rows, cols, vals, y: np.ndarray) -> np.ndarray:
        """BH gradient at y for sparse symmetric P. Ref BarnesHutTsne.gradient."""
        n = y.shape[0]
        tree = SpTree(y)
        pos_f = SpTree.compute_edge_forces(rows, cols, vals, y)
        neg_f = np.zeros_like(y)
        z = 0.0
        for i in range(n):
            buf = np.zeros(y.shape[1])
            z += tree.compute_non_edge_forces(i, y[i], self.theta, buf)
            neg_f[i] = buf
        return pos_f - neg_f / max(z, 1e-12)

    def fit_transform(self, x) -> np.ndarray:
        x = np.asarray(x, np.float64)
        n = x.shape[0]
        k = min(int(3 * self.perplexity), n - 1)
        perp = min(self.perplexity, max((n - 1) / 3.0, 2.0))
        rows, cols, vals = _knn_affinities(x, k, perp)

        rng = np.random.RandomState(self.seed)
        y = rng.randn(n, self.n_components) * 1e-4
        vel = np.zeros_like(y)
        gains = np.ones_like(y)
        for it in range(self.max_iter):
            exagg = self.exaggeration if it < self.stop_lying_iteration else 1.0
            grad = self.gradient(rows, cols, vals * exagg, y)
            momentum = (self.initial_momentum
                        if it < self.switch_momentum_iteration
                        else self.final_momentum)
            same_sign = np.sign(grad) == np.sign(vel)
            gains = np.maximum(
                np.where(same_sign, gains * 0.8, gains + 0.2), self.min_gain
            )
            vel = momentum * vel - self.learning_rate * gains * grad
            y = y + vel
            y = y - y.mean(0)
        self.y = y
        return y

    # Model-ish surface (ref BarnesHutTsne implements Model)
    def fit(self, x) -> None:
        self.fit_transform(x)

    def output(self) -> Optional[np.ndarray]:
        return self.y

    def save(self, path: str, labels=None) -> None:
        assert self.y is not None, "fit first"
        with open(path, "w", encoding="utf-8") as f:
            for i, row in enumerate(self.y):
                coords = ",".join(f"{v:.6f}" for v in row)
                label = labels[i] if labels is not None else i
                f.write(f"{coords},{label}\n")
