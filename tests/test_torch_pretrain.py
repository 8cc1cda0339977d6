"""The port's pretraining layers (deeplearning4j_tpu_torch/nn/layers/
autoencoder.py, rbm.py, recursive_autoencoder.py) and greedy layerwise
pretraining and finetuning through ``MultiLayerNetwork`` (the stacked
denoising autoencoder, ``zoo.stacked_denoising_autoencoder``), held
against the JAX package on the CPU.

Randomness is injected, never regenerated: threefry and the port's torch
generators never draw the same numbers. The autoencoder's corruption mask
and the RBM's samples are JAX's draws, put in at the port's draw points
(``nn.layers.dense._bernoulli`` as the autoencoder module binds it,
``rbm._bernoulli`` and ``rbm._normal``), or the settings draw nothing
(corruption 0; SOFTMAX hidden and visible units, whose sample is the
mean). A Bernoulli draw is JAX's uniform draw compared with the port's
mean, as ``jax.random.bernoulli`` compares it.

Tolerances: layer functions and their grads at f32, 1e-5 of the
reference's max |value|; networks after pretraining and finetuning, 1e-5
absolute on params (the SdA trains with the conf's AdaGrad at lr 0.1 and
momentum 0.5 from JAX's params, on data without near-zero gradients).
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterator import \
    ListDataSetIterator as JListIterator
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.nn import params as jparams_mod
from deeplearning4j_tpu.nn.layers import autoencoder as jae
from deeplearning4j_tpu.nn.layers import rbm as jrbm
from deeplearning4j_tpu.nn.layers import recursive_autoencoder as jrae
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
from deeplearning4j_tpu_torch.eval import evaluation as t_eval
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.nn import layers as tlayers
from deeplearning4j_tpu_torch.nn import params as tparams_mod
from deeplearning4j_tpu_torch.nn.layers import autoencoder as tae
from deeplearning4j_tpu_torch.nn.layers import rbm as trbm
from deeplearning4j_tpu_torch.nn.layers import recursive_autoencoder as trae
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners import CollectScoresListener

REL = 1e-5
ATOL = 1e-5
N_IN, N_OUT, N = 20, 8, 12


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _layer(layer_type, n_in=N_IN, n_out=N_OUT, seed=4, **kw):
    """The same layer conf in both packages and JAX-initialised params for
    both, biases made non-zero so they count."""
    jc = jconf.NeuralNetConfiguration(layer_type=layer_type, n_in=n_in,
                                      n_out=n_out, **kw)
    tc = tconf.NeuralNetConfiguration(layer_type=layer_type, n_in=n_in,
                                      n_out=n_out, **kw)
    p = jax.tree_util.tree_map(np.asarray, jparams_mod.init_layer_params(
        jax.random.PRNGKey(seed), jc))
    rng = np.random.RandomState(seed)
    p = {k: (v if k == "W" else rng.randn(*v.shape).astype(np.float32) * 0.1)
         for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    return tc, jc, tp, jax.tree_util.tree_map(jnp.asarray, p)


def _x(n=N, d=N_IN, seed=0):
    return np.random.RandomState(seed).rand(n, d).astype(np.float32)


def _grads(fn, params):
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    out = fn(leaves)
    keys = sorted(leaves)
    return out.detach(), dict(zip(keys, torch.autograd.grad(
        out, [leaves[k] for k in keys])))


# --------------------------------------------------------- autoencoder ----

@pytest.mark.parametrize("sparsity", [0.0, 0.05])
@pytest.mark.parametrize("loss", ["RECONSTRUCTION_CROSSENTROPY", "MSE"])
def test_autoencoder_matches_jax_with_its_mask(loss, sparsity):
    """encode, decode (tied weights), forward, and pretrain_loss with its
    grads, the corruption mask JAX's draw for the key."""
    tc, jc, tp, jp = _layer("AUTOENCODER", corruption_level=0.3,
                            loss_function=loss, sparsity=sparsity,
                            apply_sparsity=sparsity > 0)
    x = _x()
    key = jax.random.PRNGKey(3)
    mask = np.array(jax.random.bernoulli(key, 0.7, x.shape))
    assert 0 < mask.mean() < 1
    draws = []

    def jax_mask(k, p, like):
        draws.append((k, p))
        return torch.from_numpy(mask)

    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    h = tae.encode(tc, tp, tx)
    assert _rel(_np(h), jae.encode(jc, jp, jx)) <= REL
    assert _rel(_np(tlayers.forward(tc, tp, tx)), jae.forward(jc, jp, jx)) \
        <= REL
    assert _rel(_np(tae.decode(tc, tp, h)), jae.decode(jc, jp, jae.encode(
        jc, jp, jx))) <= REL
    orig = tae._bernoulli
    tae._bernoulli = jax_mask
    try:
        corrupted = tae.get_corrupted_input(11, tx, 0.3)
        loss_t, grads_t = _grads(
            lambda q: tae.pretrain_loss(tc, q, tx, 11), tp)
    finally:
        tae._bernoulli = orig
    assert draws == [(11, pytest.approx(0.7))] * 2
    np.testing.assert_array_equal(_np(corrupted),
                                  jae.get_corrupted_input(key, jx, 0.3))
    loss_j, grads_j = jax.value_and_grad(
        lambda q: jae.pretrain_loss(jc, q, jx, key))(jp)
    assert _rel(_np(loss_t), loss_j) <= REL
    for k in grads_j:
        assert _rel(_np(grads_t[k]), grads_j[k]) <= REL, k


def test_corruption_draws_its_rate_and_zero_draws_nothing():
    x = torch.ones(200, 300)
    y = tae.get_corrupted_input(5, x, 0.3)
    assert abs(float((y == 0).float().mean()) - 0.3) < 0.01
    assert torch.equal(y, tae.get_corrupted_input(5, x, 0.3))
    assert torch.equal(tae.get_corrupted_input(5, x, 0.0), x)


# ----------------------------------------------------------------- RBM ----

@pytest.mark.parametrize("unit", ["BINARY", "GAUSSIAN", "RECTIFIED",
                                  "SOFTMAX"])
def test_rbm_prop_up_matches_jax(unit):
    tc, jc, tp, jp = _layer("RBM", hidden_unit=unit)
    x = _x()
    got = trbm.prop_up(tc, tp, torch.from_numpy(x))
    assert _rel(_np(got), jrbm.prop_up(jc, jp, jnp.asarray(x))) <= REL
    assert torch.equal(tlayers.forward(tc, tp, torch.from_numpy(x)), got)


@pytest.mark.parametrize("unit", ["BINARY", "GAUSSIAN", "LINEAR", "SOFTMAX"])
def test_rbm_prop_down_matches_jax(unit):
    tc, jc, tp, jp = _layer("RBM", visible_unit=unit)
    h = np.random.RandomState(1).rand(N, N_OUT).astype(np.float32)
    got = trbm.prop_down(tc, tp, torch.from_numpy(h))
    assert _rel(_np(got), jrbm.prop_down(jc, jp, jnp.asarray(h))) <= REL


def _check_cd(tc, jc, tp, jp, x, key_int, jkey):
    got = trbm.contrastive_divergence(tc, tp, torch.from_numpy(x), key_int)
    want = jrbm.contrastive_divergence(jc, jp, jnp.asarray(x), jkey)
    assert sorted(got) == sorted(want) == ["W", "b", "vb"]
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert _rel(_np(got[k]), want[k]) <= REL, k


@pytest.mark.parametrize("sparsity", [0.0, 0.1])
@pytest.mark.parametrize("k", [1, 3])
def test_rbm_cd_k_with_softmax_units_matches_jax(k, sparsity):
    """SOFTMAX hidden and visible units draw nothing: CD-k's gradient
    depends on the params and data alone."""
    tc, jc, tp, jp = _layer("RBM", hidden_unit="SOFTMAX",
                            visible_unit="SOFTMAX", k=k, sparsity=sparsity,
                            apply_sparsity=sparsity > 0)
    _check_cd(tc, jc, tp, jp, _x(), 9, jax.random.PRNGKey(9))


def _jax_draw_keys(jkey, k):
    """The keys JAX's CD-k draws with, in call order: the first hidden
    sample's, then each Gibbs step's visible and hidden samples'."""
    k0, kscan = jax.random.split(jkey)
    keys = [k0]
    for step_key in jax.random.split(kscan, max(k, 1)):
        kv, kh = jax.random.split(step_key)
        keys += [kv, kh]
    return keys


@pytest.mark.parametrize("hidden,visible", [
    ("BINARY", "BINARY"), ("GAUSSIAN", "BINARY"), ("RECTIFIED", "GAUSSIAN"),
    ("BINARY", "LINEAR")])
@pytest.mark.parametrize("k", [1, 2])
def test_rbm_cd_k_with_injected_samples_matches_jax(hidden, visible, k):
    """Sampled units: each of the port's draws is JAX's for the same call
    (a uniform draw compared with the port's mean for BINARY, normal
    noise for the others)."""
    tc, jc, tp, jp = _layer("RBM", hidden_unit=hidden, visible_unit=visible,
                            k=k)
    jkey = jax.random.PRNGKey(21)
    keys = _jax_draw_keys(jkey, k)
    calls = []

    def bernoulli(key, mean):
        calls.append(key)
        u = jax.random.uniform(keys[len(calls) - 1], tuple(mean.shape))
        return (torch.from_numpy(np.array(u)) < mean).to(mean.dtype)

    def normal(key, like):
        calls.append(key)
        z = jax.random.normal(keys[len(calls) - 1], tuple(like.shape))
        return torch.from_numpy(np.array(z))

    orig = trbm._bernoulli, trbm._normal
    trbm._bernoulli, trbm._normal = bernoulli, normal
    try:
        _check_cd(tc, jc, tp, jp, _x(seed=2), 21, jkey)
    finally:
        trbm._bernoulli, trbm._normal = orig
    assert len(calls) == len(keys) == 1 + 2 * k
    assert len(set(calls)) == len(calls)


@pytest.mark.parametrize("visible", ["BINARY", "GAUSSIAN"])
def test_rbm_scores_match_jax(visible):
    tc, jc, tp, jp = _layer("RBM", visible_unit=visible)
    x = _x(seed=3)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    assert _rel(_np(trbm.free_energy(tc, tp, tx)),
                jrbm.free_energy(jc, jp, jx)) <= REL
    assert _rel(_np(trbm.reconstruction_error(tc, tp, tx)),
                jrbm.reconstruction_error(jc, jp, jx)) <= REL


def test_rbm_binary_samples_follow_their_means():
    tc, _, tp, _ = _layer("RBM", n_in=50, n_out=40)
    mean, sample = trbm.sample_hidden_given_visible(
        tc, tp, torch.rand(400, 50, generator=torch.Generator().manual_seed(
            0)), key=3)
    assert set(sample.unique().tolist()) <= {0.0, 1.0}
    assert abs(float(sample.mean() - mean.mean())) < 0.01


# ---------------------------------------------------- recursive AE ----

def test_recursive_autoencoder_matches_jax():
    """_fold (final parent and per-step losses), pretrain_loss with its
    grads, encode_sequence and forward."""
    tc, jc, tp, jp = _layer("RECURSIVE_AUTOENCODER", n_in=6, n_out=5,
                            activation_function="tanh")
    assert tuple(tp["W"].shape) == (11, 5) and tuple(tp["vb"].shape) == (11,)
    x = _x(n=7, d=6, seed=4)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    parent, losses = trae._fold(tc, tp, tx)
    jparent, jlosses = jrae._fold(jc, jp, jx)
    assert tuple(losses.shape) == jlosses.shape == (6,)
    assert _rel(_np(parent), jparent) <= REL
    assert _rel(_np(losses), jlosses) <= REL
    assert _rel(_np(trae.encode_sequence(tc, tp, x)),
                jrae.encode_sequence(jc, jp, x)) <= REL
    assert _rel(_np(tlayers.forward(tc, tp, tx)), jrae.forward(jc, jp, jx)) \
        <= REL
    loss_t, grads_t = _grads(lambda q: trae.pretrain_loss(tc, q, tx, 0), tp)
    loss_j, grads_j = jax.value_and_grad(
        lambda q: jrae.pretrain_loss(jc, q, jx, jax.random.PRNGKey(0)))(jp)
    assert _rel(_np(loss_t), loss_j) <= REL
    for k in grads_j:
        assert _rel(_np(grads_t[k]), grads_j[k]) <= REL, k
    one = trae.pretrain_loss(tc, tp, tx[:1], 0)
    assert float(one) == float(jrae.pretrain_loss(jc, jp, jx[:1], None)) == 0


# ------------------------------------------------------------ networks ----

def _sda(package, corruption=0.0, num_iterations=5):
    zoo = jzoo if package == "jax" else tzoo
    return zoo.stacked_denoising_autoencoder(
        n_in=N_IN, hidden=(12, 8), n_out=4, corruption_level=corruption,
        num_iterations=num_iterations)


def _sda_data(n=24, seed=5):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, N_IN).astype(np.float32),
            np.eye(4, dtype=np.float32)[rng.randint(0, 4, n)])


def _close(got, want, atol=ATOL):
    got = interop.tree_to_numpy(got)
    want = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), want)
    gl, wl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl) > 0
    for g, w in zip(gl, wl):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


def _pair(jconf_, tconf_):
    jnet = JNet(jconf_).init()
    tnet = MultiLayerNetwork(tconf_, device="cpu", params=(
        interop.mln_params_from_numpy(jax.tree_util.tree_map(
            np.asarray, jnet.params_tree), device="cpu")))
    return jnet, tnet


def test_sda_pretrain_and_finetune_match_jax():
    """Greedy pretraining of both AE layers (a Solver on each layer's
    pretrain_loss, two batches), then finetuning the head over the
    top-of-stack activations, at corruption 0: params after each phase
    against JAX's."""
    x, y = _sda_data()
    jnet, tnet = _pair(_sda("jax"), _sda("port"))
    jnet.pretrain(JListIterator(JDataSet(x, y), 12))
    tscores = CollectScoresListener()
    tnet.set_listeners([tscores])
    tnet.pretrain(ListDataSetIterator(DataSet(x, y), 12))
    _close(tnet.params_tree, jnet.params_tree)
    assert not np.allclose(interop.tree_to_numpy(tnet.params_tree)[0]["W"],
                           np.asarray(JNet(_sda("jax")).init()
                                      .params_tree[0]["W"]))
    # 2 layers x 2 batches x 5 iterations, each solver from iteration 0
    assert [i for i, _ in tscores.scores] == list(range(5)) * 4
    jnet.finetune(JListIterator(JDataSet(x, y), 12))
    tnet.finetune(ListDataSetIterator(DataSet(x, y), 12))
    _close(tnet.params_tree, jnet.params_tree)
    assert tnet._train_state is None


def test_sda_fit_matches_jax():
    """``fit`` on the SdA conf: pretrain → finetune → backprop, one
    batch."""
    x, y = _sda_data(seed=6)
    jnet, tnet = _pair(_sda("jax", num_iterations=3),
                       _sda("port", num_iterations=3))
    jnet.fit(x, y)
    tnet.fit(x, y)
    assert tnet._iteration == jnet._iteration == 3
    _close(tnet.params_tree, jnet.params_tree)
    _close(tnet._train_state, jnet._train_state)


def test_rbm_and_recursive_ae_stacks_pretrain_like_jax():
    """An RBM layer (SOFTMAX units: CD-k draws nothing) under forced
    iteration GD, and a recursive AE layer on a Solver over its
    pretrain_loss, in one stack."""
    def build(conf):
        return (conf.NeuralNetConfiguration.Builder()
                .n_in(N_IN).n_out(10).lr(0.1).num_iterations(4).seed(3)
                .activation_function("sigmoid")
                .optimization_algo("CONJUGATE_GRADIENT")
                .list(3)
                .override(0, layer_type="RBM", hidden_unit="SOFTMAX",
                          visible_unit="SOFTMAX", k=2)
                .override(1, layer_type="RECURSIVE_AUTOENCODER", n_in=10,
                          n_out=6, activation_function="tanh")
                .override(2, layer_type="OUTPUT", n_in=6, n_out=4,
                          activation_function="softmax",
                          loss_function="MCXENT")
                .pretrain(True).backward(False).build())

    x, y = _sda_data(n=16, seed=7)
    jnet, tnet = _pair(build(jconf), build(tconf))
    jnet.fit(x, y)
    tnet.fit(x, y)
    _close(tnet.params_tree, jnet.params_tree)
    assert tnet._iteration == 0


def test_sda_gate_through_the_port():
    """accuracy_gates.gate_sda_digits's protocol through the port:
    sklearn's digits, the seeded 1500/297 split, the SdA (64-96-48-10,
    corruption 0.2, 15 iterations) fit at batch 250, then 30 epochs of
    fit_epochs at batch 128; Evaluation accuracy >= 0.90."""
    from accuracy_gates import _split

    from deeplearning4j_tpu_torch.datasets.fetchers import digits_data

    x, y = digits_data()
    (xtr, ytr), (xte, yte) = _split(x, y, 1500)
    conf = tzoo.stacked_denoising_autoencoder(
        n_in=64, hidden=(96, 48), n_out=10, corruption_level=0.2, lr=0.1,
        num_iterations=15)
    net = MultiLayerNetwork(conf, device="cpu").init()
    labels = np.eye(10, dtype=np.float32)[ytr]
    net.fit(xtr, labels=labels, batch_size=250)
    net.fit_epochs(xtr, num_epochs=30, labels=labels, batch_size=128)
    ev = t_eval.Evaluation()
    ev.eval(np.eye(10, dtype=np.float32)[yte], net.label_probabilities(xte))
    assert ev.accuracy() >= 0.90, ev.stats()


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    conf = tzoo.stacked_denoising_autoencoder()
    for call in (lambda: MultiLayerNetwork(conf),
                 lambda: tparams_mod.init_layer_params(0, conf.conf(0)),
                 lambda: MultiLayerNetwork.from_json(conf.to_json())):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
