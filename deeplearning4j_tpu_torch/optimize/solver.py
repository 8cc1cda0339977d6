"""Counterpart of ``deeplearning4j_tpu/optimize/solver.py``: the
optimization driver (ref: optimize/Solver.java:57-73, dispatch on
OptimizationAlgorithm; optimize/solvers/BaseOptimizer.java:129-206, the
iterate → adjust-gradient → line-search → terminate loop;
BackTrackLineSearch.java, ConjugateGradient.java, LBFGS.java,
IterationGradientDescent.java).

- ITERATION_GRADIENT_DESCENT / GRADIENT_DESCENT: the conf's updater on the
  gradient, ``num_iterations`` times;
- CONJUGATE_GRADIENT: Polak-Ribière with restart, Armijo backtracking;
- HESSIAN_FREE: truncated Newton, damped CG on Hessian-vector products
  (``torch.func.jvp`` of ``torch.func.grad``, forward over reverse as the
  JAX package's ``jax.jvp`` of ``jax.grad``), with the reduction-ratio
  damping schedule and a backtracked step;
- LBFGS: the two-loop recursion, history 5.

Where the JAX package jits the objective and runs the Armijo search as one
device ``lax.while_loop``, the port runs eager torch and host loops: the
search reads one scalar from the card a trial, CG one a CG iteration.
Scalars that decide a branch are computed in f32 on the card, as JAX
computes them. An objective that reaches a custom autograd Function
(``FusedDense``, K1's wrapper; the convolution route's ``_Conv2d``) has
no forward-mode rule, so HESSIAN_FREE raises there instead of returning a
wrong product; no objective the port's finetuning and pretraining build
reaches one.

Parameters travel as trees; the line-search solvers flatten them to one
vector (ref: MultiLayerNetwork params()/setParams).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from deeplearning4j_tpu_torch._device import tree_leaves, tree_unflatten, \
    tree_zip_map
from deeplearning4j_tpu_torch.nn.api import OptimizationAlgorithm
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.gradient import flatten_params, \
    unflatten_params
from deeplearning4j_tpu_torch.ops.rng import split
from deeplearning4j_tpu_torch.optimize.listeners import close_listeners, \
    dispatch_listeners
from deeplearning4j_tpu_torch.optimize.stepfunctions import step_function
from deeplearning4j_tpu_torch.optimize.terminations import EpsTermination, \
    Norm2Termination
from deeplearning4j_tpu_torch.optimize.updater import apply_updater, \
    init_updater_state

Tensor = torch.Tensor


def backtrack_line_search(f: Callable[[Tensor], Tensor], x: Tensor, fx,
                          g: Tensor, direction: Tensor, max_iterations: int,
                          initial_step: float = 1.0, c1: float = 1e-4,
                          rho: float = 0.5) -> Tensor:
    """Armijo backtracking (ref: BackTrackLineSearch.java): the first step
    of ``initial_step``·rhoⁱ, i < ``max_iterations``, with
    f(x + step·d) <= fx + c1·step·(g·d), as an f32 scalar tensor; 0 if
    none."""
    fx = torch.as_tensor(fx, dtype=torch.float32, device=x.device)
    slope = torch.dot(g, direction)
    step = torch.tensor(initial_step, dtype=torch.float32, device=x.device)
    with torch.no_grad():
        for _ in range(max_iterations):
            if bool(f(x + step * direction) <= fx + c1 * step * slope):
                return step
            step = step * rho
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _unflatten_views(template, flat: Tensor):
    """The template's tree over views of ``flat`` (differentiable, no
    copy)."""
    out, offset = [], 0
    for leaf in tree_leaves(template):
        n = leaf.numel()
        out.append(flat[offset:offset + n].view(leaf.shape))
        offset += n
    return tree_unflatten(template, out)


class Solver:
    """Optimizes ``score_fn`` starting from a params tree.

    score_fn(params, key) -> scalar tensor (minimized); the per-iteration
    key (an ``ops.rng`` int) lets stochastic objectives, such as the
    denoising autoencoder's corruption mask, draw fresh noise each
    iteration. grad_fn(params, key) -> a params-shaped gradient tree;
    defaults to autograd of score_fn. RBM pretraining passes its CD-k
    estimator here (ref: BaseOptimizer.java:133 gradientAndScore).
    """

    def __init__(self, conf: NeuralNetConfiguration, score_fn: Callable,
                 grad_fn: Optional[Callable] = None,
                 listeners: Sequence[Callable] = (),
                 num_iterations: Optional[int] = None):
        self.conf = conf
        self.listeners = list(listeners)
        self.num_iterations = (num_iterations if num_iterations is not None
                               else conf.num_iterations)
        self._score_fn = score_fn
        self._grad_fn = grad_fn
        # Norm2Termination (grad_norm < eps) subsumes ZeroDirection
        # (grad_norm == 0); ZeroDirection stays available for explicit use
        self._terminations = [EpsTermination(), Norm2Termination()]
        # how line-search solvers apply (direction, step) to x
        self._step_fn = step_function(conf.step_function)
        # gradient/negative_gradient step functions ignore the step size,
        # so the Armijo search is skipped
        self._uses_line_search = str(conf.step_function).lower() in (
            "default", "negative_default")
        self.score_history: List[float] = []

    # ---- public API (ref: Solver.optimize) ----
    def optimize(self, params, key: Optional[int] = None,
                 algo: Optional[OptimizationAlgorithm] = None):
        """Run the configured algorithm; ``algo`` overrides the conf's
        choice (CD-k pretraining forces iteration GD: its gradient does
        not come from the score surface)."""
        algo = algo or self.conf.optimization_algo
        if key is None:
            key = self.conf.seed
        try:
            if algo in (OptimizationAlgorithm.ITERATION_GRADIENT_DESCENT,
                        OptimizationAlgorithm.GRADIENT_DESCENT):
                return self._iteration_gd(params, key)
            if algo == OptimizationAlgorithm.CONJUGATE_GRADIENT:
                return self._conjugate_gradient(params, key)
            if algo == OptimizationAlgorithm.HESSIAN_FREE:
                return self._hessian_free(params, key)
            if algo == OptimizationAlgorithm.LBFGS:
                return self._lbfgs(params, key)
            raise ValueError(f"Unhandled optimization algorithm {algo}")
        finally:
            close_listeners(self.listeners)

    # ---- shared helpers ----
    def _value_and_grad(self, params, key):
        """(score, grads tree), both detached."""
        if self._grad_fn is not None:
            with torch.no_grad():
                return self._score_fn(params, key), self._grad_fn(params, key)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            score = self._score_fn(tree_unflatten(params, leaves), key)
            grads = torch.autograd.grad(score, leaves, allow_unused=True,
                                        materialize_grads=True)
        return score.detach(), tree_unflatten(params, list(grads))

    def _notify(self, iteration: int, score: float) -> None:
        self.score_history.append(score)
        dispatch_listeners(self.listeners, self, iteration, score)

    def _should_stop(self, score: float, old_score: float,
                     grad_norm: float) -> bool:
        return any(t.terminate(score, old_score, grad_norm)
                   for t in self._terminations)

    def _line_search(self, template, x, fx, g, d, key) -> Tensor:
        """Armijo search over the flat param vector; one key for the whole
        search, so a stochastic objective stays the same within it."""
        def f(flat):
            return self._score_fn(_unflatten_views(template, flat), key)

        return backtrack_line_search(
            f, x, fx, g, d,
            max_iterations=self.conf.num_line_search_iterations)

    def _search_step(self, template, x, score, g, d, key):
        """(step, d, stop): Armijo step along d, retrying along -g,
        honoring step functions that ignore the step size. Shared by CG
        and L-BFGS."""
        if not self._uses_line_search:
            return 1.0, d, False
        step = self._line_search(template, x, score, g, d, key)
        if float(step) == 0.0:
            d = -g
            step = self._line_search(template, x, score, g, d, key)
            if float(step) == 0.0:
                return step, d, True
        return step, d, False

    def _flat_value_and_grad(self, template, x, key):
        score, grads = self._value_and_grad(_unflatten_views(template, x),
                                            key)
        g = flatten_params(grads)
        return float(score), g, float(torch.linalg.norm(g))

    # ---- iteration gradient descent (SGD + updater) ----
    def _iteration_gd(self, params, key):
        state = init_updater_state(params)
        dev = tree_leaves(params)[0].device
        old_score = float("inf")
        for i in range(self.num_iterations):
            key, sub = split(key)
            score, grads = self._value_and_grad(params, sub)
            with torch.no_grad():
                it = torch.full((), i, dtype=torch.int64, device=dev)
                update, state = apply_updater(self.conf, it, grads, params,
                                              state)
                params = tree_zip_map(lambda p, u: p - u, params, update)
            score = float(score)
            self._notify(i, score)
            if self._should_stop(score, old_score, float("inf")):
                break
            old_score = score
        return params

    # ---- conjugate gradient with backtracking line search ----
    def _conjugate_gradient(self, params, key):
        template = params
        x = flatten_params(params).detach()
        old_score = float("inf")
        g_prev = d = None
        for i in range(self.num_iterations):
            key, sub = split(key)
            score, g, gnorm = self._flat_value_and_grad(template, x, sub)
            self._notify(i, score)
            if self._should_stop(score, old_score, gnorm):
                break
            if d is None:
                d = -g
            else:
                # Polak-Ribière with automatic restart
                # (ref: ConjugateGradient.java)
                beta = float(torch.dot(g, g - g_prev)
                             / (torch.dot(g_prev, g_prev) + 1e-12))
                beta = max(0.0, beta)
                d = -g + beta * d
                if float(torch.dot(d, g)) >= 0:  # not a descent direction
                    d = -g
            step, d, stop = self._search_step(template, x, score, g, d, sub)
            if stop:
                break
            x = self._step_fn(x, d, step)
            g_prev = g
            old_score = score
        return unflatten_params(template, x)

    # ---- Hessian-free (truncated Newton; ref: StochasticHessianFree.java
    # and the R-op machinery in MultiLayerNetwork.java:561-634,1436-1509) --
    def _hessian_free(self, params, key, cg_iters: int = 50,
                      lam0: float = 1.0):
        """Martens-style truncated Newton: each outer iteration CG-solves
        (H + λI) d = −g with Hessian-vector products, then adapts λ by the
        reduction ratio ρ (ref dampingUpdate: λ×2/3 if ρ>0.75, λ×3/2 if
        ρ<0.25) and backtracks the step if needed."""
        template = params
        x = flatten_params(params).detach()

        def f_flat(flat, key):
            return self._score_fn(_unflatten_views(template, flat), key)

        def hvp(flat, v, key):
            grad = torch.func.grad(lambda z: f_flat(z, key))
            return torch.func.jvp(grad, (flat,), (v,))[1]

        def cg_solve(flat, g, lam, key):
            """CG on (H+λI)d = −g: an iteration cap and a residual
            tolerance."""
            b = -g
            d = torch.zeros_like(b)
            r = b
            p = r
            rs = torch.dot(r, r)
            tol2 = 1e-10 * torch.clamp_min(torch.dot(b, b), 1e-30)
            i = 0
            while i < cg_iters and bool(rs > tol2):
                ap = hvp(flat, p, key) + lam * p
                denom = torch.dot(p, ap)
                alpha = rs / torch.where(denom.abs() < 1e-30,
                                         denom.new_tensor(1e-30), denom)
                d = d + alpha * p
                r = r - alpha * ap
                rs_new = torch.dot(r, r)
                p = r + (rs_new / torch.clamp_min(rs, 1e-30)) * p
                rs = rs_new
                i += 1
            return d

        lam = lam0
        old_score = float("inf")
        for i in range(self.num_iterations):
            key, sub = split(key)
            score, g, gnorm = self._flat_value_and_grad(template, x, sub)
            self._notify(i, score)
            if self._should_stop(score, old_score, gnorm):
                break
            lam32 = torch.tensor(lam, dtype=torch.float32, device=x.device)
            d = cg_solve(x, g, lam32, sub)
            # quadratic-model decrease: q(d) − q(0) = gᵀd + ½ dᵀ(H+λI)d
            hd = hvp(x, d, sub) + lam32 * d
            model_delta = float(torch.dot(g, d) + 0.5 * torch.dot(d, hd))
            with torch.no_grad():
                # the ratio from the un-backtracked step, so the damping
                # sees how good the quadratic model was at d itself
                full_score = float(f_flat(x + d, sub))
                rho = ((full_score - score) / model_delta
                       if model_delta < 0 else 0.0)
                # backtrack until the true score decreases; "not (new <
                # score)" so NaN/inf scores count as failures too
                step_scale = 1.0
                new_score = full_score
                while not (new_score < score) and step_scale > 1e-4:
                    step_scale *= 0.5
                    new_score = float(f_flat(x + step_scale * d, sub))
            if not (new_score < score):
                lam *= 1.5  # no progress at any scale → more damping
                continue
            if rho > 0.75:
                lam *= 2.0 / 3.0
            elif rho < 0.25:
                lam *= 1.5
            x = self._step_fn(x, d, step_scale)
            old_score = score
        return unflatten_params(template, x)

    # ---- L-BFGS (two-loop recursion, history m=5; ref: LBFGS.java) ----
    def _lbfgs(self, params, key, history: int = 5):
        template = params
        x = flatten_params(params).detach()
        s_hist: List[Tensor] = []
        y_hist: List[Tensor] = []
        old_score = float("inf")
        g_prev = x_prev = None
        for i in range(self.num_iterations):
            key, sub = split(key)
            score, g, gnorm = self._flat_value_and_grad(template, x, sub)
            self._notify(i, score)
            if self._should_stop(score, old_score, gnorm):
                break
            if g_prev is not None:
                s, y = x - x_prev, g - g_prev
                if float(torch.dot(s, y)) > 1e-10:
                    s_hist.append(s)
                    y_hist.append(y)
                    if len(s_hist) > history:
                        s_hist.pop(0)
                        y_hist.pop(0)
            # two-loop recursion
            q = g
            alphas = []
            for s, y in zip(reversed(s_hist), reversed(y_hist)):
                rho_i = 1.0 / float(torch.dot(y, s))
                a = rho_i * float(torch.dot(s, q))
                alphas.append((a, rho_i))
                q = q - a * y
            if s_hist:
                gamma = float(torch.dot(s_hist[-1], y_hist[-1])
                              / torch.dot(y_hist[-1], y_hist[-1]))
                q = gamma * q
            for (a, rho_i), s, y in zip(reversed(alphas), s_hist, y_hist):
                b = rho_i * float(torch.dot(y, q))
                q = q + (a - b) * s
            d = -q
            step, d, stop = self._search_step(template, x, score, g, d, sub)
            if stop:
                break
            x_prev, g_prev = x, g
            x = self._step_fn(x, d, step)
            old_score = score
        return unflatten_params(template, x)
