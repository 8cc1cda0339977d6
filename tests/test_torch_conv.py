"""The port's convolution and subsampling layers
(deeplearning4j_tpu_torch/nn/layers/convolution.py, subsampling.py), their
params, and the conv zoo confs (``lenet``, ``digits_conv``,
``conv_wide``) through ``MultiLayerNetwork``, held against the JAX package
on the CPU.

Parameters come from JAX's own init and go to the port through
``interop.mln_params_from_numpy``; data from numpy seeds and
``synthetic_mnist`` (bit-identical in both packages). The JAX side runs
with ``set_fused_dense(True)`` (the tests' 8 fake host devices turn its
default off), so both packages differentiate LeNet's relu dense layers
through the same derivative-from-output backward; on the CPU the port's
dense layers run K1's plain version.

Tolerances:
- layer outputs and grads at f32: 1e-5 of the reference's max |value|
  (the routes sum in different orders);
- networks at f32: 1e-5 absolute on outputs, scores, params and updater
  state;
- bf16: 3e-2 absolute against eager JAX (``jax.disable_jit()``: jitted
  XLA keeps f32 between fused bf16 ops); bf16 pooling 1e-2 of the
  reference's max |value| (one bf16 ulp at the window sums' magnitude
  exceeds 3e-2: eager JAX rounds after each add of a window, the port
  once).

MAX pooling's gradient is held on continuous inputs only: on ties XLA's
select-and-scatter and torch's argmax may pick different elements of a
window (after a ReLU most ties are zeros, whose upstream gradient is zero
anyway).
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.fetchers import synthetic_mnist as j_mnist
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.nn import functional as JF
from deeplearning4j_tpu.nn import params as jparams_mod
from deeplearning4j_tpu.nn.layers import convolution as jconv
from deeplearning4j_tpu.nn.layers import subsampling as jsub
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.ops import dtypes as jdt
from deeplearning4j_tpu.ops import pallas_kernels as jpk
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.fetchers import synthetic_mnist
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
from deeplearning4j_tpu_torch.eval import evaluation as t_eval
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.nn import functional as TF
from deeplearning4j_tpu_torch.nn import layers as tlayers
from deeplearning4j_tpu_torch.nn import params as tparams_mod
from deeplearning4j_tpu_torch.nn.layers import convolution as tconv
from deeplearning4j_tpu_torch.nn.layers import subsampling as tsub
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import dtypes as tdt
from deeplearning4j_tpu_torch.ops import pallas_kernels as tpk

B = 8
ATOL = 1e-5
BF16_ATOL = 3e-2
LAYER_REL = 1e-5
CONV_MODELS = ["lenet", "digits_conv", "conv_wide"]


@pytest.fixture(autouse=True)
def jax_fused_on():
    jpk.set_fused_dense(True)
    try:
        yield
    finally:
        jpk.set_fused_dense(None)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jp(np_params):
    return jax.tree_util.tree_map(jnp.asarray, np_params)


def _tp(np_params, dtype=None):
    return interop.mln_params_from_numpy(np_params, device="cpu",
                                         dtype=dtype)


def _close(got, want, atol=ATOL):
    got = interop.tree_to_numpy(got)
    want = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), want)
    gl, wl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


# ------------------------------------------------------------ conv2d ----

# (batch, C, H, W, O, KH, KW): LeNet's two convolutions, digits_conv's,
# and conv_wide's two at narrowed batch, spatial size and output channels
# (their contractions, 800 and 3200, kept above the gate)
CONV_SHAPES = {
    "lenet_conv1": (4, 1, 28, 28, 6, 5, 5),
    "lenet_conv2": (4, 6, 12, 12, 16, 5, 5),
    "digits_conv": (4, 1, 8, 8, 16, 3, 3),
    "conv_wide_conv1": (2, 32, 12, 12, 16, 5, 5),
    "conv_wide_conv2": (2, 128, 7, 9, 8, 5, 5),
}


def _conv_inputs(shape, seed):
    b, c, h, w, o, kh, kw = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(b, c, h, w).astype(np.float32)
    wt = (rng.randn(o, c, kh, kw) / np.sqrt(c * kh * kw)).astype(np.float32)
    return x, wt


@pytest.mark.parametrize("emitter", [None, True, False],
                         ids=["gate", "conv", "im2col"])
@pytest.mark.parametrize("name", sorted(CONV_SHAPES))
def test_conv2d_matches_jax(name, emitter):
    """``conv2d`` under each setting of ``set_conv_emitter`` against the
    JAX package's under the same setting, and against both packages'
    ``im2col_conv``; the gate sends contractions of 512 and above to the
    convolution route in both."""
    shape = CONV_SHAPES[name]
    x, w = _conv_inputs(shape, seed=len(name))
    calls = []
    orig = tconv.im2col_conv

    def counting(*args):
        calls.append(1)
        return orig(*args)

    tconv.set_conv_emitter(emitter)
    jconv.set_conv_emitter(emitter)
    tconv.im2col_conv = counting
    try:
        got = tconv.conv2d(torch.from_numpy(x), torch.from_numpy(w))
        want = jconv.conv2d(jnp.asarray(x), jnp.asarray(w))
    finally:
        tconv.im2col_conv = orig
        tconv.set_conv_emitter(None)
        jconv.set_conv_emitter(None)
    b, c, h, wd, o, kh, kw = shape
    assert tuple(got.shape) == want.shape == (b, o, h - kh + 1, wd - kw + 1)
    assert _rel(_np(got), _np(want)) <= LAYER_REL
    oracle = tconv.im2col_conv(torch.from_numpy(x), torch.from_numpy(w))
    assert _rel(_np(oracle), _np(jconv.im2col_conv(jnp.asarray(x),
                                                   jnp.asarray(w)))) \
        <= LAYER_REL
    assert _rel(_np(got), _np(oracle)) <= LAYER_REL
    wide = c * kh * kw >= tconv._EMITTER_MIN_CONTRACTION
    assert tconv._EMITTER_MIN_CONTRACTION == jconv._EMITTER_MIN_CONTRACTION
    assert len(calls) == int(not (wide if emitter is None else emitter))


@pytest.mark.parametrize("emitter", [True, False], ids=["conv", "im2col"])
def test_conv2d_grads_match_jax(emitter):
    """Grads wrt x and w of sum(conv2d · r) against ``jax.vjp``, at LeNet's
    second convolution."""
    x, w = _conv_inputs(CONV_SHAPES["lenet_conv2"], seed=3)
    r = np.random.RandomState(4).randn(4, 16, 8, 8).astype(np.float32)
    tconv.set_conv_emitter(emitter)
    jconv.set_conv_emitter(emitter)
    try:
        tx = torch.from_numpy(x).requires_grad_()
        tw = torch.from_numpy(w).requires_grad_()
        (tconv.conv2d(tx, tw) * torch.from_numpy(r)).sum().backward()
        _, vjp = jax.vjp(jconv.conv2d, jnp.asarray(x), jnp.asarray(w))
        jgx, jgw = vjp(jnp.asarray(r))
    finally:
        tconv.set_conv_emitter(None)
        jconv.set_conv_emitter(None)
    assert _rel(_np(tx.grad), _np(jgx)) <= LAYER_REL
    assert _rel(_np(tw.grad), _np(jgw)) <= LAYER_REL


def _layer(layer_type, n_in, n_out, **kw):
    """The same layer conf in both packages, and JAX-initialised params
    for both."""
    jc = jconf.NeuralNetConfiguration(layer_type=layer_type, n_in=n_in,
                                      n_out=n_out, **kw)
    tc = tconf.NeuralNetConfiguration(layer_type=layer_type, n_in=n_in,
                                      n_out=n_out, **kw)
    p = jax.tree_util.tree_map(
        np.asarray, jparams_mod.init_layer_params(jax.random.PRNGKey(4), jc))
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    return tc, jc, tp, _jp(p)


@pytest.mark.parametrize("act", ["relu", "tanh", "sigmoid", "linear"])
def test_conv_layer_forward_matches_jax(act):
    """The layer: conv + bias broadcast over (H, W) + activation."""
    tc, jc, tp, jp = _layer("CONVOLUTION", 6, 16, filter_size=(5, 5),
                            activation_function=act)
    tp["convbias"] = torch.linspace(-0.5, 0.5, 16)
    jp["convbias"] = jnp.asarray(tp["convbias"].numpy())
    x = np.random.RandomState(5).randn(3, 6, 12, 12).astype(np.float32)
    got = tlayers.forward(tc, tp, torch.from_numpy(x))
    want = jconv.forward(jc, jp, jnp.asarray(x))
    assert _rel(_np(got), _np(want)) <= LAYER_REL


def test_conv_layer_bf16_matches_eager_jax():
    """bf16 weights set the compute dtype: an f32 input is cast to bf16
    in both packages."""
    tc, jc, tp, jp = _layer("CONVOLUTION", 6, 16, filter_size=(5, 5),
                            activation_function="relu")
    x = np.random.RandomState(6).randn(3, 6, 12, 12).astype(np.float32)
    for emitter in (True, False):
        tconv.set_conv_emitter(emitter)
        jconv.set_conv_emitter(emitter)
        try:
            got = tconv.forward(tc, {k: v.bfloat16() for k, v in tp.items()},
                                torch.from_numpy(x))
            with jax.disable_jit():
                want = jconv.forward(jc, jax.tree_util.tree_map(
                    lambda a: a.astype(jnp.bfloat16), jp), jnp.asarray(x))
        finally:
            tconv.set_conv_emitter(None)
            jconv.set_conv_emitter(None)
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        np.testing.assert_allclose(_np(got), _np(want), atol=BF16_ATOL,
                                   rtol=0)


# ------------------------------------------------------------- pooling ----

POOL_CASES = [((3, 4, 24, 24), (2, 2)), ((3, 4, 8, 8), (2, 2)),
              ((2, 3, 7, 9), (2, 2)), ((2, 3, 11, 6), (3, 2)),
              ((2, 2, 5, 5), (2, 3)), ((1, 1, 3, 3), (3, 3))]


@pytest.mark.parametrize("pool", ["MAX", "SUM", "AVG", "NONE"])
@pytest.mark.parametrize("shape,stride", POOL_CASES,
                         ids=[f"{s[2]}x{s[3]}-{t[0]}{t[1]}"
                              for s, t in POOL_CASES])
def test_subsampling_matches_jax(pool, shape, stride):
    """Every pooling type, window = stride, VALID: odd sizes drop the
    remainder as ``reduce_window`` does. Output and input grads of
    sum(out · r) on continuous inputs (no ties in a window)."""
    tc = tconf.NeuralNetConfiguration(layer_type="SUBSAMPLING",
                                      stride=stride, convolution_type=pool)
    jc = jconf.NeuralNetConfiguration(layer_type="SUBSAMPLING",
                                      stride=stride, convolution_type=pool)
    rng = np.random.RandomState(sum(shape) + stride[0])
    x = rng.randn(*shape).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_()
    got = tlayers.forward(tc, {}, tx)
    want, vjp = jax.vjp(lambda a: jsub.forward(jc, {}, a), jnp.asarray(x))
    assert tuple(got.shape) == want.shape
    if pool != "NONE":
        assert want.shape[2:] == (shape[2] // stride[0],
                                  shape[3] // stride[1])
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=0)
    r = rng.randn(*want.shape).astype(np.float32)
    (got * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(_np(tx.grad), _np(vjp(jnp.asarray(r))[0]),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("pool", ["MAX", "SUM", "AVG"])
def test_subsampling_bf16_matches_eager_jax(pool):
    tc = tconf.NeuralNetConfiguration(layer_type="SUBSAMPLING",
                                      convolution_type=pool)
    jc = jconf.NeuralNetConfiguration(layer_type="SUBSAMPLING",
                                      convolution_type=pool)
    x = np.random.RandomState(9).randn(2, 3, 9, 8).astype(np.float32)
    got = tsub.forward(tc, {}, torch.from_numpy(x).bfloat16())
    with jax.disable_jit():
        want = jsub.forward(jc, {}, jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    assert _rel(_np(got), _np(want)) <= 1e-2


# -------------------------------------------------------------- params ----

@pytest.mark.parametrize("filter_size,n_in,n_out",
                         [((5, 5), 1, 6), ((5, 5), 32, 128), ((3, 3), 1, 16),
                          ((2, 4), 3, 5)])
def test_conv_params_keys_shapes_and_init(filter_size, n_in, n_out):
    """OIHW ``convweights`` and zero ``convbias``, as JAX inits them, with
    SIZE's U(-s, s), s = sqrt(6 / (fan_in + fan_out)) over the first two
    axes (the JAX package's fan convention)."""
    kw = dict(layer_type="CONVOLUTION", n_in=n_in, n_out=n_out,
              filter_size=filter_size, weight_init="SIZE")
    tp = tparams_mod.init_layer_params(11, tconf.NeuralNetConfiguration(
        **kw), device="cpu")
    jp = jparams_mod.init_layer_params(jax.random.PRNGKey(11),
                                       jconf.NeuralNetConfiguration(**kw))
    assert sorted(tp) == sorted(jp) == ["convbias", "convweights"]
    for k in tp:
        assert tuple(tp[k].shape) == jp[k].shape
        assert tp[k].dtype == torch.float32 and jp[k].dtype == jnp.float32
    assert torch.equal(tp["convbias"], torch.zeros(n_out))
    s = np.sqrt(6.0 / (n_out + n_in))
    w = tp["convweights"].numpy()
    assert np.abs(w).max() <= s
    if w.size >= 1000:
        assert abs(w.mean()) < 0.05 * s
        assert abs(w.std() - s / np.sqrt(3)) < 0.05 * s
    sub = tparams_mod.init_layer_params(0, tconf.NeuralNetConfiguration(
        layer_type="SUBSAMPLING"), device="cpu")
    assert sub == {}


# ------------------------------------------------------------ networks ----

@pytest.mark.parametrize("model", CONV_MODELS)
def test_conv_zoo_confs_match_jax_and_load_across(model):
    tc, jc = getattr(tzoo, model)(), getattr(jzoo, model)()
    assert tc.to_json() == jc.to_json()
    net = MultiLayerNetwork.from_json(jc.to_json(), device="cpu")
    assert net.conf == tc


def _lenet_data(n, seed):
    x, y = synthetic_mnist(n, seed=seed)
    jx, jy = j_mnist(n, seed=seed)
    np.testing.assert_array_equal(x, jx)
    return x, np.eye(10, dtype=np.float32)[y]


@pytest.fixture(scope="module")
def lenet_params():
    p = JF.init_params(jzoo.lenet(), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, p)


def test_lenet_inference_matches_jax(lenet_params):
    """feed_forward (every layer's activation), output, predict and score
    at f32, both conv routes."""
    tc, jc = tzoo.lenet(), jzoo.lenet()
    x, y = _lenet_data(B, seed=1)
    tp, jp = _tp(lenet_params), _jp(lenet_params)
    for emitter in (None, True):
        tconv.set_conv_emitter(emitter)
        jconv.set_conv_emitter(emitter)
        try:
            tacts = TF.feed_forward(tc, tp, torch.from_numpy(x))
            jacts = JF.feed_forward(jc, jp, jnp.asarray(x))
        finally:
            tconv.set_conv_emitter(None)
            jconv.set_conv_emitter(None)
        assert [tuple(a.shape) for a in tacts] == [a.shape for a in jacts]
        for ta, ja in zip(tacts, jacts):
            assert _rel(_np(ta), _np(ja)) <= LAYER_REL
    tnet = MultiLayerNetwork(tc, params=tp, device="cpu")
    jnet = JNet(jc, params=jp)
    _close(tnet.output(x), jnet.output(x))
    np.testing.assert_array_equal(tnet.predict(x), jnet.predict(x))
    assert abs(tnet.score(DataSet(x, y))
               - jnet.score(JDataSet(x, y))) <= ATOL


def _jax_steps(jc, np_params, xs, ys, policy=None):
    step = (JF._raw_train_step(jc, policy) if policy is not None
            else JF.make_train_step(jc))
    params = _jp(np_params)
    states = JF.init_train_state(jc, params)
    scores = []
    for i in range(len(xs)):
        params, states, s = step(params, states, jnp.asarray(i),
                                 jnp.asarray(xs[i]), jnp.asarray(ys[i]),
                                 jax.random.PRNGKey(i))
        scores.append(float(s))
    return params, states, scores


def _port_steps(tc, np_params, xs, ys, policy=None):
    step = TF.make_train_step(tc, policy=policy)
    params = _tp(np_params)
    states = TF.init_train_state(tc, params)
    scores = []
    for i in range(len(xs)):
        params, states, s = step(params, states, i, xs[i], ys[i], i)
        scores.append(float(s))
    return params, states, scores


def _with_lr(mlc, lr):
    return dataclasses.replace(mlc, confs=tuple(
        dataclasses.replace(c, lr=lr) for c in mlc.confs))


@pytest.mark.parametrize("policy", ["f32", "bf16"])
def test_lenet_three_train_steps_match_jax(lenet_params, policy):
    """Scores, params and updater state after 3 SGD steps of the zoo's
    LeNet (momentum 0.9). f32 at the zoo's lr 0.05; bf16 under
    BF16_COMPUTE against eager JAX at lr 0.01: at 0.05 the score climbs
    from 5.4 to 20.9 in 3 steps at batch 8 (JAX alone, f32), and that
    divergence turns the packages' different bf16 roundings (the port's
    dense layers round once, JAX's fallback three times) into 0.16 apart
    on a weight; at 0.01 the steps descend and agree to 2e-3."""
    tc, jc = tzoo.lenet(), jzoo.lenet()
    x, y = _lenet_data(3 * B, seed=2)
    xs, ys = x.reshape(3, B, 784), y.reshape(3, B, 10)
    if policy == "f32":
        jparams, jstates, jscores = _jax_steps(jc, lenet_params, xs, ys)
        tparams, tstates, tscores = _port_steps(tc, lenet_params, xs, ys)
        atol = ATOL
    else:
        tc, jc = _with_lr(tc, 0.01), _with_lr(jc, 0.01)
        with jax.disable_jit():
            jparams, jstates, jscores = _jax_steps(
                jc, lenet_params, xs, ys, jdt.BF16_COMPUTE)
        tparams, tstates, tscores = _port_steps(tc, lenet_params, xs, ys,
                                                tdt.BF16_COMPUTE)
        atol = BF16_ATOL
    np.testing.assert_allclose(tscores, jscores, atol=atol, rtol=0)
    assert np.isfinite(tscores).all()
    _close(tparams, jparams, atol)
    _close(tstates, jstates, atol)
    assert all(p.dtype == torch.float32 for layer in tparams
               for p in layer.values())


def test_lenet_fused_and_unfused_dense_routes_agree(lenet_params):
    """LeNet's two relu dense layers go through ``fused_dense`` (K1's
    wrapper; its plain version on the CPU), the head and the conv layers
    never do; ``set_fused_dense(False)`` gives the same loss and grads."""
    tc = tzoo.lenet()
    x, y = _lenet_data(B, seed=3)
    calls = []
    orig = tpk.fused_dense_fwd

    def counting(*args):
        calls.append(tuple(args[1].shape))
        return orig(*args)

    def loss_and_grads():
        params = _tp(lenet_params)
        leaves = [p.requires_grad_() for layer in params
                  for p in layer.values()]
        loss = TF.network_loss(tc, params, torch.from_numpy(x),
                               torch.from_numpy(y), train=True)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    tpk.fused_dense_fwd = counting
    try:
        kl, kg = loss_and_grads()
        assert calls == [(256, 120), (120, 84)]
        tpk.set_fused_dense(False)
        pl, pg = loss_and_grads()
        assert len(calls) == 2
    finally:
        tpk.fused_dense_fwd = orig
        tpk.set_fused_dense(None)
    assert abs(float(kl) - float(pl)) <= ATOL
    for a, b in zip(kg, pg):
        assert _rel(a, b) <= LAYER_REL


def test_lenet_fit_epochs_matches_jax_and_checkpoints_cross(lenet_params,
                                                            tmp_path):
    """The facade: 2 epochs of fit_epochs in both packages from one set of
    params, then each package's save loads in the other."""
    tc, jc = tzoo.lenet(), jzoo.lenet()
    x, y = _lenet_data(2 * B, seed=4)
    tnet = MultiLayerNetwork(tc, params=_tp(lenet_params), device="cpu")
    jnet = JNet(jc, params=_jp(lenet_params))
    tnet.fit_epochs(ListDataSetIterator(DataSet(x, y), B), num_epochs=2)
    jnet.fit_epochs(JDataSet(x, y), num_epochs=2, batch_size=B)
    assert tnet._iteration == jnet._iteration == 4
    _close(tnet.params_tree, jnet.params_tree)
    _close(tnet._train_state, jnet._train_state)
    tnet.save(str(tmp_path / "port.npz"))
    back = JNet.load(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(np.asarray(back.params()),
                                  tnet.params().numpy())
    jnet.save(str(tmp_path / "jax.npz"))
    fwd = MultiLayerNetwork.load(str(tmp_path / "jax.npz"), device="cpu")
    np.testing.assert_array_equal(fwd.params().numpy(),
                                  np.asarray(jnet.params()))


def test_conv_wide_narrowed_train_step_matches_jax():
    """conv_wide's layer types and gate at a narrowed width: 32 input
    channels (contraction 800, the convolution route), 16 output
    channels, 16x16 input; one SGD step."""
    def narrow(mlc):
        confs = list(mlc.confs)
        confs[0] = dataclasses.replace(confs[0], n_out=16)
        confs[2] = dataclasses.replace(confs[2], n_in=16, n_out=8)
        confs[4] = dataclasses.replace(confs[4], n_in=8, n_out=12)
        confs[5] = dataclasses.replace(confs[5], n_in=12)
        return dataclasses.replace(mlc, confs=tuple(confs))

    tc, jc = narrow(tzoo.conv_wide()), narrow(jzoo.conv_wide())
    p = jax.tree_util.tree_map(np.asarray,
                               JF.init_params(jc, jax.random.PRNGKey(2)))
    rng = np.random.RandomState(7)
    xs = rng.randn(1, 2, 32, 16, 16).astype(np.float32)
    ys = np.eye(10, dtype=np.float32)[rng.randint(0, 10, (1, 2))]
    jparams, jstates, jscores = _jax_steps(jc, p, xs, ys)
    tparams, tstates, tscores = _port_steps(tc, p, xs, ys)
    np.testing.assert_allclose(tscores, jscores, atol=ATOL, rtol=0)
    _close(tparams, jparams)
    _close(tstates, jstates)


def test_digits_conv_gate_through_the_port():
    """accuracy_gates.gate_digits_conv's protocol through the port:
    sklearn's digits, the seeded 1500/297 split, fit_epochs for 40 epochs
    at batch 128, Evaluation accuracy >= 0.96."""
    from accuracy_gates import _split

    from deeplearning4j_tpu_torch.datasets.fetchers import digits_data

    x, y = digits_data()
    (xtr, ytr), (xte, yte) = _split(x, y, 1500)
    net = MultiLayerNetwork(tzoo.digits_conv(), device="cpu").init()
    net.fit_epochs(ListDataSetIterator(
        DataSet(xtr, np.eye(10, dtype=np.float32)[ytr]), 128), num_epochs=40)
    assert net._iteration == 40 * 12
    ev = t_eval.Evaluation()
    ev.eval(np.eye(10, dtype=np.float32)[yte], net.label_probabilities(xte))
    assert ev.accuracy() >= 0.96, ev.stats()


def test_entry_points_raise_without_cuda(lenet_params):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    tc = tzoo.lenet()
    for call in (lambda: tparams_mod.init_layer_params(0, tc.conf(0)),
                 lambda: MultiLayerNetwork(tc),
                 lambda: MultiLayerNetwork(tzoo.conv_wide()),
                 lambda: TF.init_params(tc, 0),
                 lambda: interop.mln_params_from_numpy(lenet_params)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
