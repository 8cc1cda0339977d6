"""Counterpart of ``deeplearning4j_tpu/nn/layers/rbm.py``: the restricted
Boltzmann machine with CD-k contrastive divergence (ref:
nn/layers/feedforward/rbm/RBM.java).

propUp/propDown (:318, :351), sampling by unit type (BINARY, GAUSSIAN,
RECTIFIED, SOFTMAX hidden; BINARY, GAUSSIAN, LINEAR, SOFTMAX visible,
:217-310), the Gibbs chain (:266) and the CD-k gradient (:111-191). The
chain is a host loop of k steps with keys threaded as the JAX package's
``lax.scan`` threads them. Samples come from ``_bernoulli`` and
``_normal``, torch generators seeded by ``ops.rng`` keys: the streams are
not JAX's, so parity tests inject JAX's draws there (SOFTMAX units draw
nothing: the sample is the mean).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.api import HiddenUnit, VisibleUnit
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.params import BIAS_KEY, VISIBLE_BIAS_KEY, \
    WEIGHT_KEY
from deeplearning4j_tpu_torch.ops.rng import generator, split

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def _bernoulli(key: int, mean: Tensor) -> Tensor:
    """1 where a uniform draw falls below ``mean``, else 0, in mean's
    dtype (``jax.random.bernoulli(key, mean)``)."""
    u = torch.rand(mean.shape, generator=generator(key, mean.device),
                   device=mean.device)
    return (u < mean).to(mean.dtype)


def _normal(key: int, like: Tensor) -> Tensor:
    """Standard normal draws shaped like ``like``."""
    return torch.randn(like.shape, generator=generator(key, like.device),
                       device=like.device).to(like.dtype)


def prop_up(conf: NeuralNetConfiguration, params: Params, v: Tensor) -> Tensor:
    """Hidden mean given visible (ref: RBM.java:318 propUp)."""
    pre = v @ params[WEIGHT_KEY] + params[BIAS_KEY]
    h = conf.hidden_unit
    if h == HiddenUnit.RECTIFIED:
        return torch.clamp_min(pre, 0.0)
    if h == HiddenUnit.BINARY:
        return torch.sigmoid(pre)
    if h == HiddenUnit.SOFTMAX:
        return torch.softmax(pre, dim=-1)
    if h == HiddenUnit.GAUSSIAN:
        return pre
    raise ValueError(f"Unhandled hidden unit {h}")


def prop_down(conf: NeuralNetConfiguration, params: Params,
              h: Tensor) -> Tensor:
    """Visible mean given hidden (ref: RBM.java:351 propDown)."""
    pre = h @ params[WEIGHT_KEY].T + params[VISIBLE_BIAS_KEY]
    v = conf.visible_unit
    if v == VisibleUnit.BINARY:
        return torch.sigmoid(pre)
    if v == VisibleUnit.SOFTMAX:
        return torch.softmax(pre, dim=-1)
    if v in (VisibleUnit.GAUSSIAN, VisibleUnit.LINEAR):
        return pre
    raise ValueError(f"Unhandled visible unit {v}")


def sample_hidden_given_visible(conf: NeuralNetConfiguration, params: Params,
                                v: Tensor, key: int) -> Tuple[Tensor, Tensor]:
    """(mean, sample) (ref: RBM.java:217)."""
    mean = prop_up(conf, params, v)
    h = conf.hidden_unit
    if h == HiddenUnit.BINARY:
        sample = _bernoulli(key, mean)
    elif h == HiddenUnit.GAUSSIAN:
        sample = mean + _normal(key, mean)
    elif h == HiddenUnit.RECTIFIED:
        # noisy ReLU: mean + N(0,1)*sqrt(sigmoid(mean)), clipped at 0
        noise = _normal(key, mean)
        sample = torch.clamp_min(
            mean + noise * torch.sqrt(torch.sigmoid(mean)), 0.0)
    elif h == HiddenUnit.SOFTMAX:
        sample = mean
    else:
        raise ValueError(f"Unhandled hidden unit {h}")
    return mean, sample


def sample_visible_given_hidden(conf: NeuralNetConfiguration, params: Params,
                                h: Tensor, key: int) -> Tuple[Tensor, Tensor]:
    """(mean, sample) (ref: RBM.java sampleVisibleGivenHidden)."""
    mean = prop_down(conf, params, h)
    v = conf.visible_unit
    if v == VisibleUnit.BINARY:
        sample = _bernoulli(key, mean)
    elif v in (VisibleUnit.GAUSSIAN, VisibleUnit.LINEAR):
        sample = mean + _normal(key, mean)
    elif v == VisibleUnit.SOFTMAX:
        sample = mean
    else:
        raise ValueError(f"Unhandled visible unit {v}")
    return mean, sample


def contrastive_divergence(conf: NeuralNetConfiguration, params: Params,
                           v0: Tensor, key: int) -> Dict[str, Tensor]:
    """CD-k gradient (to be *descended*): negative-phase minus
    positive-phase statistics, ÷ batch (ref: RBM.java:111-191
    gradient())."""
    k0, kchain = split(key)
    h0_mean, h_sample = sample_hidden_given_visible(conf, params, v0, k0)
    for step_key in split(kchain, max(conf.k, 1)):
        kv, kh = split(step_key)
        _, v_sample = sample_visible_given_hidden(conf, params, h_sample, kv)
        hk_mean, h_sample = sample_hidden_given_visible(conf, params,
                                                        v_sample, kh)
    vk = v_sample

    n = v0.shape[0]
    w_grad = (vk.T @ hk_mean - v0.T @ h0_mean) / n
    hb_grad = (hk_mean - h0_mean).mean(0)
    vb_grad = (vk - v0).mean(0)
    if conf.apply_sparsity and conf.sparsity > 0:
        # push hidden biases toward sparse activations (ref:
        # BasePretrainNetwork.applySparsity on the hidden-bias gradient)
        hb_grad = hb_grad + conf.sparsity * h0_mean.mean(0)
    return {WEIGHT_KEY: w_grad, BIAS_KEY: hb_grad, VISIBLE_BIAS_KEY: vb_grad}


def free_energy(conf: NeuralNetConfiguration, params: Params,
                v: Tensor) -> Tensor:
    """Mean free energy; the RBM score (lower = better fit)."""
    pre = v @ params[WEIGHT_KEY] + params[BIAS_KEY]
    vbias_term = v @ params[VISIBLE_BIAS_KEY]
    hidden_term = torch.nn.functional.softplus(pre).sum(-1)
    return (-hidden_term - vbias_term).mean()


def reconstruction_error(conf: NeuralNetConfiguration, params: Params,
                         v: Tensor) -> Tensor:
    """Cross-entropy between input and its one-step reconstruction (the
    score the reference reports during pretraining); squared error for
    non-binary visible units."""
    recon = prop_down(conf, params, prop_up(conf, params, v))
    eps = 1e-7
    p = torch.clamp(recon, eps, 1 - eps)
    if conf.visible_unit == VisibleUnit.BINARY:
        return -(v * torch.log(p) + (1 - v) * torch.log(1 - p)).sum(-1).mean()
    return ((v - recon) ** 2).sum(-1).mean()


def forward(conf: NeuralNetConfiguration, params: Params, x: Tensor, *,
            train: bool = False, key: Optional[int] = None) -> Tensor:
    return prop_up(conf, params, x)
