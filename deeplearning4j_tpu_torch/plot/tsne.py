"""Counterpart of ``deeplearning4j_tpu/plot/tsne.py``: exact t-SNE on the
card.

Parity with ref plot/Tsne.java: d2p() perplexity calibration via per-point
binary search, gradient() with the (P−Q) attractive/repulsive split, descent
with momentum switch + early exaggeration (Tsne.java:272,:372-384).

Plain torch on the input's device (the JAX package's jitted functions, no
Pallas kernel): the calibration is the fixed 50-step bisection of every
row at once (JAX's vmapped scan), and the descent a Python loop over the
iterations whose costs stay in a device tensor and come back in one
transfer. Every N×N product is one matrix product; the rest is
elementwise work over N×N tensors, bound by device memory.

The initial embedding ``y0`` is drawn at one place, ``_initial_y``, from
a ``torch.Generator`` seeded with ``seed``; JAX draws
``jax.random.normal(PRNGKey(seed), (n, k)) * 1e-4``, which the parity
tests put there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import DeviceLike, resolve_device


def _pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    sq = (x * x).sum(1)
    d = sq[:, None] - 2.0 * (x @ x.T) + sq[None, :]
    return d.clamp_min_(0.0)


def _d2p(d: torch.Tensor, perplexity: float,
         tol_iters: int = 50) -> torch.Tensor:
    """Symmetric affinities from the squared distances ``d``: every row's
    beta = 1/2σ² bisected ``tol_iters`` times (all rows at once) so its
    entropy hits log(perplexity), then P + Pᵀ normalized and floored at
    1e-12. Ref Tsne.java d2p()."""
    n = d.shape[0]
    log_u = float(np.log(perplexity))
    off = ~torch.eye(n, dtype=torch.bool, device=d.device)

    def row_probs(beta):
        p = torch.exp(-d * beta[:, None]) * off
        psum = p.sum(1).clamp_min(1e-12)
        h = torch.log(psum) + beta * (d * p).sum(1) / psum
        return p / psum[:, None], h

    beta = torch.ones(n, dtype=d.dtype, device=d.device)
    lo = torch.zeros_like(beta)
    hi = torch.full_like(beta, float("inf"))
    for _ in range(tol_iters):
        _, h = row_probs(beta)
        too_high = h > log_u  # entropy too high → increase beta
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(
            too_high,
            torch.where(torch.isinf(hi), beta * 2.0, (beta + hi) / 2.0),
            torch.where(lo <= 0.0, beta / 2.0, (beta + lo) / 2.0))
    p, _ = row_probs(beta)
    p = p + p.T
    return (p / p.sum().clamp_min(1e-12)).clamp_min_(1e-12)


def _tsne_grad(p: torch.Tensor, y: torch.Tensor):
    """Gradient of KL(P‖Q) for the Student-t kernel; returns (grad, cost),
    the cost a 0-d tensor."""
    num = _pairwise_sq_dists(y).add_(1.0).reciprocal_()
    num.fill_diagonal_(0.0)
    q = (num / num.sum().clamp_min(1e-12)).clamp_min_(1e-12)
    cost = (p * (torch.log(p) - torch.log(q))).sum()
    pq = (p - q).mul_(num)  # (N,N)
    grad = 4.0 * (pq.sum(1, keepdim=True) * y - pq @ y)
    return grad, cost


def _descent_step(p: torch.Tensor, y: torch.Tensor, vel: torch.Tensor,
                  gains: torch.Tensor, momentum: float, learning_rate: float,
                  min_gain: float):
    """One iteration of the descent on the affinities ``p`` (exaggerated
    or not): the gradient, the adaptive per-element gains (ref
    Tsne.java:372-384), the momentum step, y re-centered. Returns (y,
    vel, gains, cost), the cost a 0-d tensor."""
    grad, cost = _tsne_grad(p, y)
    same_sign = torch.sign(grad) == torch.sign(vel)
    gains = torch.where(same_sign, gains * 0.8,
                        gains + 0.2).clamp_min_(min_gain)
    vel = momentum * vel - learning_rate * gains * grad
    y = y + vel
    return y - y.mean(0), vel, gains, cost


def _initial_y(seed: int, n: int, k: int,
               device: torch.device) -> torch.Tensor:
    """The draw point of the initial embedding: N(0, 1e-4²), (n, k) f32."""
    gen = torch.Generator().manual_seed(int(seed))
    return (torch.randn((n, k), generator=gen) * 1e-4).to(device)


class Tsne:
    """Exact t-SNE (ref plot/Tsne.java builder surface: maxIter, perplexity,
    learningRate, switchMomentumIteration, stopLyingIteration). ``device``
    is where it runs: CUDA unless the caller passes ``"cpu"``."""

    def __init__(
        self,
        n_components: int = 2,
        perplexity: float = 30.0,
        learning_rate: float = 500.0,
        max_iter: int = 1000,
        initial_momentum: float = 0.5,
        final_momentum: float = 0.8,
        switch_momentum_iteration: int = 100,
        stop_lying_iteration: int = 250,
        exaggeration: float = 4.0,
        min_gain: float = 0.01,
        seed: int = 123,
        device: DeviceLike = None,
    ):
        self.n_components = n_components
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
        self.device = resolve_device(device)
        self.costs: Optional[np.ndarray] = None

    def calculate(self, x, n_dims: Optional[int] = None,
                  perplexity: Optional[float] = None) -> np.ndarray:
        """Embed x (N,D) → (N, n_components). Ref Tsne.calculate."""
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        k = n_dims or self.n_components
        perp = perplexity or self.perplexity
        n = x.shape[0]
        if n - 1 < 3 * perp:
            perp = max((n - 1) / 3.0, 2.0)

        p = _d2p(_pairwise_sq_dists(x), perp)
        del x

        y = _initial_y(self.seed, n, k, self.device)
        vel = torch.zeros_like(y)
        gains = torch.ones_like(y)
        costs = torch.zeros(self.max_iter, dtype=torch.float32,
                            device=self.device)
        p_lying = p * self.exaggeration
        for i in range(self.max_iter):
            y, vel, gains, costs[i] = _descent_step(
                p_lying if i < self.stop_lying_iteration else p, y, vel,
                gains, self._momentum_at(i), self.learning_rate,
                self.min_gain)
        self.costs = costs.cpu().numpy()
        return y.cpu().numpy()

    def _momentum_at(self, i: int) -> float:
        """The momentum of iteration ``i``: initial before the switch,
        final from it."""
        return (self.initial_momentum if i < self.switch_momentum_iteration
                else self.final_momentum)

    # ref Tsne.plot(matrix, nDims, labels, path) writes coords for the UI
    def plot(self, x, n_dims: int, labels, path: str) -> np.ndarray:
        y = self.calculate(x, n_dims)
        with open(path, "w", encoding="utf-8") as f:
            for row, label in zip(y, labels):
                coords = ",".join(f"{v:.6f}" for v in row)
                f.write(f"{coords},{label}\n")
        return y
