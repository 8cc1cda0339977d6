"""The port's MultiLayerNetwork (deeplearning4j_tpu_torch/nn/functional.py,
nn/multilayer.py) held against the JAX package's on the CPU.

Parameters come from JAX's own init and go to the port through
``interop.mln_params_from_numpy``; data from ``synthetic_mnist`` (numpy
seeded, bit-identical in both packages). The JAX side runs with
``set_fused_dense(True)``, restored in ``finally`` (the tests' 8 fake host
devices turn its default off), so both packages differentiate the dense
layers through the same derivative-from-output backward. The narrow MLP
(784-64-32-10, batch 32) is ragged for the TPU gate, so JAX runs
``_dense_ref`` under the custom VJP and the port the kernel's plain version.

Tolerances: f32 1e-5 absolute on scores, params and updater state (the two
sum in different orders); the bf16 policy 3e-2 against eager JAX
(``jax.disable_jit()``: jitted XLA keeps f32 between fused bf16 ops), where
the port rounds each dense forward once and JAX's fallback three times.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.fetchers import synthetic_mnist as j_mnist
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import functional as JF
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.ops import dtypes as jdt
from deeplearning4j_tpu.ops import pallas_kernels as jpk
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.fetchers import synthetic_mnist
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn import functional as TF
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import _kernels
from deeplearning4j_tpu_torch.ops import dtypes as tdt
from deeplearning4j_tpu_torch.ops import pallas_kernels as tpk

H1, H2, B = 64, 32, 32
ATOL = 1e-5
BF16_ATOL = 3e-2


@pytest.fixture(autouse=True)
def jax_fused_on():
    jpk.set_fused_dense(True)
    try:
        yield
    finally:
        jpk.set_fused_dense(None)


@pytest.fixture(scope="module")
def data():
    x, y = synthetic_mnist(4 * B, seed=3)
    return x, np.eye(10, dtype=np.float32)[y]


@pytest.fixture(scope="module")
def jax_params():
    conf = jzoo.mnist_mlp(H1, H2)
    p = JF.init_params(conf, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, p)


def _conf():
    return tzoo.mnist_mlp(H1, H2), jzoo.mnist_mlp(H1, H2)


def _jp(np_params):
    return jax.tree_util.tree_map(jnp.asarray, np_params)


def _close(got, want, atol=ATOL):
    got = interop.tree_to_numpy(got)
    want = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


def test_synthetic_mnist_is_bit_identical():
    for n, seed in ((17, 7), (64, 3)):
        tx, ty = synthetic_mnist(n, seed=seed)
        jx, jy = j_mnist(n, seed=seed)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


def test_inference_matches_jax(jax_params, data):
    x, y = data
    tc, jc = _conf()
    tp = interop.mln_params_from_numpy(jax_params, device="cpu")
    jp = _jp(jax_params)
    tacts = TF.feed_forward(tc, tp, torch.from_numpy(x))
    jacts = JF.feed_forward(jc, jp, jnp.asarray(x))
    assert len(tacts) == len(jacts) == 4
    _close(tacts, jacts)
    _close(TF.output(tc, tp, torch.from_numpy(x)), JF.output(jc, jp,
                                                             jnp.asarray(x)))
    _close(TF.score(tc, tp, torch.from_numpy(x), torch.from_numpy(y)),
           JF.score(jc, jp, jnp.asarray(x), jnp.asarray(y)))
    _close(TF.network_per_example_loss(tc, tp, torch.from_numpy(x),
                                       torch.from_numpy(y)),
           JF.network_per_example_loss(jc, jp, jnp.asarray(x),
                                       jnp.asarray(y)))
    _close(TF.hidden_activation(tc, tp, torch.from_numpy(x), 2),
           JF.hidden_activation(jc, jp, jnp.asarray(x), 2))
    tnet = MultiLayerNetwork(tc, params=tp, device="cpu")
    jnet = JNet(jc, params=jp)
    np.testing.assert_array_equal(tnet.predict(x), jnet.predict(x))
    assert abs(tnet.score(DataSet(x, y)) - jnet.score(JDataSet(x, y))) <= ATOL
    _close(tnet.label_probabilities(x), jnet.label_probabilities(x))


def test_fused_and_unfused_dense_routes_agree(jax_params, data):
    x, y = data
    tc, _ = _conf()
    tp = interop.mln_params_from_numpy(jax_params, device="cpu")
    fused = TF.score(tc, tp, torch.from_numpy(x), torch.from_numpy(y))
    try:
        tpk.set_fused_dense(False)
        plain = TF.score(tc, tp, torch.from_numpy(x), torch.from_numpy(y))
    finally:
        tpk.set_fused_dense(None)
    assert abs(float(fused) - float(plain)) <= ATOL


def _jax_steps(jc, jax_params, x, y, policy=None, n=3):
    step = (JF._raw_train_step(jc, policy) if policy is not None
            else JF.make_train_step(jc))
    params = _jp(jax_params)
    states = JF.init_train_state(jc, params)
    scores = []
    for i in range(n):
        xb, yb = x[i * B:(i + 1) * B], y[i * B:(i + 1) * B]
        params, states, s = step(params, states, jnp.asarray(i),
                                 jnp.asarray(xb), jnp.asarray(yb),
                                 jax.random.PRNGKey(i))
        scores.append(float(s))
    return params, states, scores


def _port_steps(tc, jax_params, x, y, policy=None, n=3, donate=False):
    step = TF.make_train_step(tc, donate=donate, policy=policy)
    params = interop.mln_params_from_numpy(jax_params, device="cpu")
    states = TF.init_train_state(tc, params)
    scores = []
    for i in range(n):
        xb, yb = x[i * B:(i + 1) * B], y[i * B:(i + 1) * B]
        params, states, s = step(params, states, i, xb, yb, i)
        scores.append(float(s))
    return params, states, scores


@pytest.mark.parametrize("policy", ["f32", "bf16"])
def test_three_train_steps_match_jax(jax_params, data, policy):
    x, y = data
    tc, jc = _conf()
    if policy == "f32":
        jparams, jstates, jscores = _jax_steps(jc, jax_params, x, y)
        tparams, tstates, tscores = _port_steps(tc, jax_params, x, y)
        atol = ATOL
    else:
        with jax.disable_jit():
            jparams, jstates, jscores = _jax_steps(jc, jax_params, x, y,
                                                   jdt.BF16_COMPUTE)
        tparams, tstates, tscores = _port_steps(tc, jax_params, x, y,
                                                tdt.BF16_COMPUTE)
        atol = BF16_ATOL
    np.testing.assert_allclose(tscores, jscores, atol=atol, rtol=0)
    assert tscores[-1] < tscores[0]
    _close(tparams, jparams, atol)
    _close(tstates, jstates, atol)
    assert all(p["W"].dtype == torch.float32 for p in tparams)


def test_donated_step_updates_in_place(jax_params, data):
    x, y = data
    tc, _ = _conf()
    kept, _, kept_scores = _port_steps(tc, jax_params, x, y, n=2)
    step = TF.make_train_step(tc, donate=True)
    params = interop.mln_params_from_numpy(jax_params, device="cpu")
    states = TF.init_train_state(tc, params)
    w0 = params[0]["W"]
    scores = []
    for i in range(2):
        params, states, s = step(params, states, i, x[i * B:(i + 1) * B],
                                 y[i * B:(i + 1) * B], i)
        scores.append(float(s))
    assert params[0]["W"] is w0
    assert scores == kept_scores
    _close(params, interop.tree_to_numpy(kept), 0.0)


def test_train_epoch_matches_jax_and_sequential_steps(jax_params, data):
    x, y = data
    tc, jc = _conf()
    xs = x[:3 * B].reshape(3, B, -1)
    ys = y[:3 * B].reshape(3, B, -1)
    jepoch = JF.make_train_epoch(jc, 3, donate=False)
    jp = _jp(jax_params)
    jparams, jstates, jscores = jepoch(jp, JF.init_train_state(jc, jp),
                                       jnp.asarray(0), jnp.asarray(xs),
                                       jnp.asarray(ys), jax.random.PRNGKey(1))
    epoch = TF.make_train_epoch(tc, 3, donate=True)
    tp = interop.mln_params_from_numpy(jax_params, device="cpu")
    tparams, tstates, tscores = epoch(tp, TF.init_train_state(tc, tp), 0,
                                      torch.from_numpy(xs),
                                      torch.from_numpy(ys), 1)
    assert tscores.shape == (3,) and tscores.dtype == torch.float32
    np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores),
                               atol=ATOL, rtol=0)
    _close(tparams, jparams)
    _close(tstates, jstates)
    sparams, sstates, sscores = _port_steps(tc, jax_params, x, y)
    assert tscores.tolist() == sscores
    _close(tparams, interop.tree_to_numpy(sparams), 0.0)


@pytest.mark.parametrize("how", ["fit", "fit_epochs"])
def test_facade_training_matches_jax(jax_params, data, how):
    x, y = data
    tc, jc = _conf()
    tnet = MultiLayerNetwork(
        tc, params=interop.mln_params_from_numpy(jax_params, device="cpu"),
        device="cpu")
    jnet = JNet(jc, params=_jp(jax_params))
    if how == "fit":
        tnet.fit(DataSet(x, y), batch_size=B)
        jnet.fit(JDataSet(x, y), batch_size=B)
    else:
        tnet.fit_epochs(ListDataSetIterator(DataSet(x, y), B), num_epochs=2)
        jnet.fit_epochs(JDataSet(x, y), num_epochs=2, batch_size=B)
    assert tnet._iteration == jnet._iteration
    _close(tnet.params_tree, jnet.params_tree)
    _close(tnet._train_state, jnet._train_state)
    np.testing.assert_allclose(tnet.params().numpy(),
                               np.asarray(jnet.params()), atol=ATOL, rtol=0)


def test_facade_inference_launch_path_uses_the_wrapper(jax_params, data):
    """feed_forward and predict go through the fused-dense wrapper once per
    hidden layer: two calls of ``fused_dense_fwd`` per pass."""
    x, _ = data
    tc, _ = _conf()
    net = MultiLayerNetwork(
        tc, params=interop.mln_params_from_numpy(jax_params, device="cpu"),
        device="cpu")
    calls = []
    orig = tpk.fused_dense_fwd

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return orig(*args, **kw)

    tpk.fused_dense_fwd = counting
    try:
        net.predict(x)
        assert calls == [(x.shape[0], 784), (x.shape[0], H1)]
    finally:
        tpk.fused_dense_fwd = orig
    assert _kernels.LAUNCHES["fused_dense"] == 0


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_load_across_packages(jax_params, tmp_path, writer):
    tc, jc = _conf()
    path = str(tmp_path / f"net_{writer}.npz")
    if writer == "port":
        src = MultiLayerNetwork(tc, device="cpu").init()
        src.save(path)
        dst = JNet.load(path)
        want = src.params().numpy()
        got = np.asarray(dst.params())
        assert dst.conf == jc
    else:
        src = JNet(jc, params=_jp(jax_params))
        src.save(path)
        dst = MultiLayerNetwork.load(path, device="cpu")
        want = np.asarray(src.params())
        got = dst.params().numpy()
        assert dst.to_json() == jc.to_json()
    np.testing.assert_array_equal(got, want)


def test_save_load_round_trip_in_port(tmp_path):
    tc, _ = _conf()
    net = MultiLayerNetwork(tc, device="cpu").init()
    net.save(str(tmp_path / "ckpt"))
    back = MultiLayerNetwork.load(str(tmp_path / "ckpt"), device="cpu")
    assert torch.equal(back.params(), net.params())
    assert MultiLayerNetwork.from_json(net.to_json(),
                                       device="cpu").conf == net.conf


def test_merge_matches_jax_and_clone_is_unaffected_by_training(jax_params,
                                                                data):
    x, y = data
    tc, jc = _conf()
    rng = np.random.RandomState(9)
    other_np = jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32), jax_params)
    tnet = MultiLayerNetwork(
        tc, params=interop.mln_params_from_numpy(jax_params, device="cpu"),
        device="cpu")
    clone = tnet.clone()
    before = clone.params().clone()
    tnet.merge(MultiLayerNetwork(tc, params=interop.mln_params_from_numpy(
        other_np, device="cpu"), device="cpu"), batch_size=4)
    jnet = JNet(jc, params=_jp(jax_params))
    jnet.merge(JNet(jc, params=_jp(other_np)), batch_size=4)
    _close(tnet.params_tree, jnet.params_tree)
    tnet.fit(DataSet(x, y), batch_size=B)
    assert torch.equal(clone.params(), before)
    assert not torch.equal(tnet.params(), before)
    with pytest.raises(ValueError, match="not of equal length"):
        tnet.merge(MultiLayerNetwork(tzoo.digits_mlp(), device="cpu"), 1)


def test_set_params_wrong_length_raises_like_jax(jax_params):
    tc, jc = _conf()
    tnet = MultiLayerNetwork(tc, device="cpu").init()
    jnet = JNet(jc, params=_jp(jax_params))
    with pytest.raises(ValueError) as port_err:
        tnet.set_params(np.zeros(7, np.float32))
    with pytest.raises(ValueError) as jax_err:
        jnet.set_params(np.zeros(7, np.float32))
    assert str(port_err.value) == str(jax_err.value)
    n = tnet.num_params()
    assert n == 784 * H1 + H1 + H1 * H2 + H2 + H2 * 10 + 10
    tnet.set_params(np.arange(n, dtype=np.float32))
    assert float(tnet.params_tree[2]["b"][-1]) == n - 1


def test_fit_without_labels_raises():
    tc, _ = _conf()
    net = MultiLayerNetwork(tc, device="cpu").init()
    with pytest.raises(ValueError, match="No labels"):
        net.fit(DataSet(np.zeros((4, 784), np.float32)))


def test_unported_paths_raise_and_name_their_slice():
    net = MultiLayerNetwork(jzoo.stacked_denoising_autoencoder().to_json(),
                            device="cpu")
    with pytest.raises(NotImplementedError, match="slice 5"):
        net.fit(DataSet(np.zeros((4, 784), np.float32),
                        np.zeros((4, 10), np.float32)))
    with pytest.raises(NotImplementedError, match="slice 5"):
        net.init()
    mlp = MultiLayerNetwork(tzoo.mnist_mlp(H1, H2), device="cpu")
    for call in (lambda: mlp.pretrain(None), lambda: mlp.finetune(None),
                 lambda: mlp.set_listeners([object()])):
        with pytest.raises(NotImplementedError, match="slice 5"):
            call()
    mlp.set_listeners([])


@pytest.mark.parametrize("model", ["char_lstm", "char_attention_lm"])
def test_sequence_heads_now_score_and_train(model):
    """The LSTM and ATTENTION heads, which raised before their slice, take
    a JAX-written conf through MultiLayerNetwork: a finite score, a train
    step, and per-timestep predictions."""
    net = MultiLayerNetwork(getattr(jzoo, model)(8).to_json(),
                            device="cpu").init()
    toks = np.random.RandomState(0).randint(0, 8, (2, 4))
    x = np.eye(8, dtype=np.float32)[toks]
    score = TF.network_loss(net.conf, net.params_tree, torch.from_numpy(x),
                            torch.from_numpy(x))
    assert score.shape == () and torch.isfinite(score)
    net.fit_epochs(DataSet(x, x))
    assert net._iteration == 1
    assert net.predict(x).shape == (2, 4)


def test_entry_points_raise_without_cuda(jax_params):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    tc, _ = _conf()
    for call in (lambda: MultiLayerNetwork(tc),
                 lambda: TF.init_params(tc, 0),
                 lambda: interop.mln_params_from_numpy(jax_params),
                 lambda: interop.updater_state_from_numpy(
                     tuple({"hist": p, "v": p} for p in jax_params)),
                 lambda: MultiLayerNetwork.from_json(tc.to_json())):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
