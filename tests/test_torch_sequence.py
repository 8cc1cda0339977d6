"""The port's sequence heads (deeplearning4j_tpu_torch/nn/layers/lstm.py,
nn/layers/attention.py, the sequence branch of nn/functional.py) and the
zoo's ``char_lstm`` and ``char_attention_lm`` through
``MultiLayerNetwork``, held against the JAX package on the CPU.

Parameters come from JAX's own init and go to the port through
``interop.mln_params_from_numpy``; token data from numpy seeds, one-hot
encoded as ``bench.py`` encodes it. On the CPU the LSTM cell runs K2's
plain version and the attention core its dense or flash plain versions.

Tolerances:
- f32: 1e-5 absolute on outputs, scores, params and updater state (the two
  sum in different orders). The zoo confs train with AdaGrad, whose step
  is lr·g/(sqrt(Σg²) + 1e-6): where a gradient is near zero, it turns f32
  summation noise into an update difference of order lr (the near-sign
  first steps of Adam and LAMB, ROADMAP Queue 3). At the zoo's lr 0.1 one
  attention weight moved 3.2e-5 apart after 3 steps; the step-by-step
  parity runs AdaGrad at lr 1e-3, as the LM's Adam parity does, and SGD at
  the zoo's lr 0.1;
- bf16 policy: 3e-2 absolute against eager JAX (``jax.disable_jit()``:
  jitted XLA keeps f32 between fused bf16 ops), with AdaGrad off: with it
  on, a bf16 rounding difference in a gradient near zero flips a ±lr
  update (measured: 0.1 on single weights after one step while every
  gradient agreed to 1% of its leaf's max);
- layer forwards at f32: 1e-5 relative to the reference's max.
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
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.nn import functional as JF
from deeplearning4j_tpu.nn import params as jparams_mod
from deeplearning4j_tpu.nn.layers import attention as jattn
from deeplearning4j_tpu.nn.layers import lstm as jlstm
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.ops import dtypes as jdt
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.nn import functional as TF
from deeplearning4j_tpu_torch.nn import layers as tlayers
from deeplearning4j_tpu_torch.nn import params as tparams_mod
from deeplearning4j_tpu_torch.nn.layers import attention as tattn
from deeplearning4j_tpu_torch.nn.layers import lstm as tlstm
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import _kernels
from deeplearning4j_tpu_torch.ops import dtypes as tdt
from deeplearning4j_tpu_torch.ops import flash_attention as tfa
from deeplearning4j_tpu_torch.ops import pallas_kernels as tpk

V, T, B = 16, 5, 4
D_MODEL, N_HEADS = 16, 2
ATOL = 1e-5
BF16_ATOL = 3e-2
LAYER_REL = 1e-5
MODELS = ["char_lstm", "char_attention_lm"]


def _confs(model, num_iterations=1):
    """(port conf, JAX conf) of one zoo sequence model at the tests'
    width."""
    if model == "char_lstm":
        return tzoo.char_lstm(V), jzoo.char_lstm(V)
    kw = dict(d_model=D_MODEL, n_heads=N_HEADS, num_iterations=num_iterations)
    return tzoo.char_attention_lm(V, **kw), jzoo.char_attention_lm(V, **kw)


def _no_adagrad(mlc):
    return dataclasses.replace(mlc, confs=tuple(
        dataclasses.replace(c, use_ada_grad=False) for c in mlc.confs))


def _with_lr(mlc, lr):
    return dataclasses.replace(mlc, confs=tuple(
        dataclasses.replace(c, lr=lr) for c in mlc.confs))


def _tokens(n, t=T, seed=1):
    """(x, y): one-hot inputs and next-token labels, (n, t, V) f32."""
    toks = np.random.RandomState(seed).randint(0, V, (n, t + 1))
    eye = np.eye(V, dtype=np.float32)
    return eye[toks[:, :-1]], eye[toks[:, 1:]]


@pytest.fixture(scope="module")
def jax_params():
    out = {}
    for model in MODELS:
        _, jc = _confs(model)
        p = JF.init_params(jc, jax.random.PRNGKey(0))
        out[model] = jax.tree_util.tree_map(np.asarray, p)
    return out


def _jp(np_params):
    return jax.tree_util.tree_map(jnp.asarray, np_params)


def _tp(np_params, dtype=None):
    return interop.mln_params_from_numpy(np_params, device="cpu",
                                         dtype=dtype)


def _close(got, want, atol=ATOL):
    got = interop.tree_to_numpy(got)
    want = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


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


# ------------------------------------------------------------- layers ----

@pytest.mark.parametrize("hidden,batch", [(16, 3), (128, 8)])
@pytest.mark.parametrize("lift", [False, True], ids=["3d", "2d"])
def test_lstm_layer_matches_jax(hidden, batch, lift):
    """``hidden_sequence`` and ``forward``, f32. At hidden 128 and batch 8
    JAX runs its Pallas cell in interpret mode; the 2-D case is one
    (time, n_in) sequence, lifted to a batch of one."""
    tc, jc, tp, jp = _layer("LSTM", 7, hidden)
    rng = np.random.RandomState(hidden)
    x = rng.randn(*((T, 7) if lift else (batch, T, 7))).astype(np.float32)
    th = tlstm.hidden_sequence(tc, tp, torch.from_numpy(x))
    jh = jlstm.hidden_sequence(jc, jp, jnp.asarray(x))
    tout = tlayers.forward(tc, tp, torch.from_numpy(x))
    jout = jlstm.forward(jc, jp, jnp.asarray(x))
    assert tuple(th.shape) == jh.shape == ((1 if lift else batch), T, hidden)
    assert tuple(tout.shape) == jout.shape
    assert _rel(_np(th), _np(jh)) <= LAYER_REL
    assert _rel(_np(tout), _np(jout)) <= LAYER_REL


def test_lstm_layer_matches_eager_jax_bf16():
    """bf16 at the TPU gate's shape, where both cells round once: the
    recurrence and the decoder within the bf16 tolerance."""
    tc, jc, tp, jp = _layer("LSTM", 7, 128)
    x = np.random.RandomState(2).randn(8, 4, 7).astype(np.float32)
    tpb = {k: v.bfloat16() for k, v in tp.items()}
    with jax.disable_jit():
        jout = jlstm.forward(jc, jax.tree_util.tree_map(
            lambda a: a.astype(jnp.bfloat16), jp),
            jnp.asarray(x, jnp.bfloat16))
    tout = tlstm.forward(tc, tpb, torch.from_numpy(x).bfloat16())
    assert tout.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tout), _np(jout), atol=BF16_ATOL, rtol=0)


def test_lstm_layer_with_no_timesteps():
    tc, _, tp, _ = _layer("LSTM", 7, 16)
    h = tlstm.hidden_sequence(tc, tp, torch.zeros(3, 0, 7))
    assert tuple(h.shape) == (3, 0, 16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lift", [False, True], ids=["3d", "2d"])
def test_attention_layer_matches_jax(causal, lift):
    tc, jc, tp, jp = _layer("ATTENTION", D_MODEL, V, n_heads=N_HEADS,
                            causal=causal)
    rng = np.random.RandomState(int(causal))
    x = rng.randn(*((8, D_MODEL) if lift else (3, 8, D_MODEL))
                  ).astype(np.float32)
    th = tattn.hidden_sequence(tc, tp, torch.from_numpy(x))
    jh = jattn.hidden_sequence(jc, jp, jnp.asarray(x))
    tout = tlayers.forward(tc, tp, torch.from_numpy(x))
    jout = jattn.forward(jc, jp, jnp.asarray(x))
    assert tuple(th.shape) == jh.shape
    assert tuple(tout.shape) == jout.shape == (1 if lift else 3, 8, V)
    assert _rel(_np(th), _np(jh)) <= LAYER_REL
    assert _rel(_np(tout), _np(jout)) <= LAYER_REL


def test_attention_layer_through_the_kernel_route_matches_dense():
    """The layer with the flash core (``FlashAttention``, the kernels'
    wiring; their plain versions on the CPU) against the dense core: the
    same logits, and grads for every leaf, wq, wk and wv non-zero."""
    tc, _, tp, _ = _layer("ATTENTION", D_MODEL, V, n_heads=N_HEADS)
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 8, D_MODEL)
                         .astype(np.float32))
    out = {}
    for impl in ("dense", "flash"):
        leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
        try:
            tfa.set_attention_impl(impl)
            y = tattn.forward(tc, leaves, x)
        finally:
            tfa.set_attention_impl(None)
        keys = sorted(leaves)
        grads = torch.autograd.grad((y * y).sum(), [leaves[k] for k in keys])
        out[impl] = (y.detach(), dict(zip(keys, grads)))
    assert _rel(out["flash"][0], out["dense"][0]) <= LAYER_REL
    for k, g in out["flash"][1].items():
        assert _rel(g, out["dense"][1][k]) <= LAYER_REL, k
    for k in ("wq", "wk", "wv"):
        assert out["flash"][1][k].abs().max() > 0, k


def test_forward_ring_matches_jax_on_a_one_rank_axis():
    """``forward_ring`` over an "sp" axis of one rank (the multi-rank
    parity is tests/test_torch_ring_attention.py) against JAX's on a
    1-device mesh: the ring's single pair is the block."""
    import jax.sharding as jsh

    from deeplearning4j_tpu_torch.parallel.mesh import Mesh

    tc, jc, tp, jp = _layer("ATTENTION", D_MODEL, V, n_heads=N_HEADS)
    x = np.random.RandomState(2).randn(2, 16, D_MODEL).astype(np.float32)
    got = tattn.forward_ring(tc, tp, torch.from_numpy(x), Mesh(("sp",), (1,)),
                             "sp")
    want = jattn.forward_ring(jc, jp, jnp.asarray(x),
                              jsh.Mesh(np.array(jax.devices()[:1]), ("sp",)),
                              "sp")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_attention_params_check_heads_like_jax():
    for n_heads in (0, 3):
        tc = tconf.NeuralNetConfiguration(layer_type="ATTENTION", n_in=16,
                                          n_out=4, n_heads=n_heads)
        jc = jconf.NeuralNetConfiguration(layer_type="ATTENTION", n_in=16,
                                          n_out=4, n_heads=n_heads)
        with pytest.raises(ValueError) as port_err:
            tparams_mod.init_layer_params(0, tc, device="cpu")
        with pytest.raises(ValueError) as jax_err:
            jparams_mod.init_layer_params(jax.random.PRNGKey(0), jc)
        assert str(port_err.value) == str(jax_err.value)


# ------------------------------------------------------------ networks ----

@pytest.mark.parametrize("model", MODELS)
def test_zoo_conf_json_matches_jax(model):
    tc, jc = _confs(model)
    assert tc.to_json() == jc.to_json()
    tdefault = getattr(tzoo, model)()
    jdefault = getattr(jzoo, model)()
    assert tdefault.to_json() == jdefault.to_json()
    net = MultiLayerNetwork.from_json(jc.to_json(), device="cpu")
    assert net.conf == tc


@pytest.mark.parametrize("model", MODELS)
def test_inference_matches_jax(jax_params, model):
    """output, feed_forward, predict (argmax per timestep), score and the
    per-example loss, f32."""
    tc, jc = _confs(model)
    x, y = _tokens(B)
    tp, jp = _tp(jax_params[model]), _jp(jax_params[model])
    _close(TF.feed_forward(tc, tp, torch.from_numpy(x)),
           JF.feed_forward(jc, jp, jnp.asarray(x)))
    _close(TF.network_per_example_loss(tc, tp, torch.from_numpy(x),
                                       torch.from_numpy(y)),
           JF.network_per_example_loss(jc, jp, jnp.asarray(x),
                                       jnp.asarray(y)))
    tnet = MultiLayerNetwork(tc, params=tp, device="cpu")
    jnet = JNet(jc, params=jp)
    _close(tnet.output(x), jnet.output(x))
    pred = tnet.predict(x)
    assert pred.shape == (B, T)
    np.testing.assert_array_equal(pred, jnet.predict(x))
    assert abs(tnet.score(DataSet(x, y)) - jnet.score(JDataSet(x, y))) <= ATOL


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("loss", ["MSE", "XENT"])
def test_sequence_head_losses_match_jax(jax_params, model, loss):
    """The other loss branches of the sequence head: MSE on the logits
    (``per_example_loss``) and sigmoid cross-entropy from the logits."""
    tc, jc = _confs(model)

    def with_loss(mlc):
        confs = list(mlc.confs)
        confs[-1] = dataclasses.replace(confs[-1], loss_function=loss)
        return dataclasses.replace(mlc, confs=tuple(confs))

    tc, jc = with_loss(tc), with_loss(jc)
    x, y = _tokens(B, seed=4)
    _close(TF.network_loss(tc, _tp(jax_params[model]), torch.from_numpy(x),
                           torch.from_numpy(y)),
           JF.network_loss(jc, _jp(jax_params[model]), jnp.asarray(x),
                           jnp.asarray(y)))


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


@pytest.mark.parametrize("run", ["f32-sgd", "f32-adagrad", "bf16-sgd"])
@pytest.mark.parametrize("model", MODELS)
def test_three_train_steps_match_jax(jax_params, model, run):
    """Scores, params and updater state after 3 steps. "sgd": the zoo conf
    with AdaGrad off (SGD at lr 0.1, momentum 0.5); "adagrad": the zoo
    conf as it is, at lr 1e-3 (see the module docstring: at lr 0.1 one
    weight with a near-zero gradient moved 3.2e-5 apart in f32)."""
    tc, jc = _confs(model)
    if run.endswith("sgd"):
        tc, jc = _no_adagrad(tc), _no_adagrad(jc)
    else:
        tc, jc = _with_lr(tc, 1e-3), _with_lr(jc, 1e-3)
    x, y = _tokens(3 * B, seed=2)
    xs, ys = x.reshape(3, B, T, V), y.reshape(3, B, T, V)
    if run.startswith("f32"):
        jparams, jstates, jscores = _jax_steps(jc, jax_params[model], xs, ys)
        tparams, tstates, tscores = _port_steps(tc, jax_params[model], xs,
                                                ys)
        atol = ATOL
    else:
        with jax.disable_jit():
            jparams, jstates, jscores = _jax_steps(
                jc, jax_params[model], xs, ys, jdt.BF16_COMPUTE)
        tparams, tstates, tscores = _port_steps(tc, jax_params[model], xs,
                                                ys, tdt.BF16_COMPUTE)
        atol = BF16_ATOL
    np.testing.assert_allclose(tscores, jscores, atol=atol, rtol=0)
    assert np.isfinite(tscores).all()
    _close(tparams, jparams, atol)
    _close(tstates, jstates, atol)
    assert all(p.dtype == torch.float32 for layer in tparams
               for p in layer.values())


@pytest.mark.parametrize("model", MODELS)
def test_train_epoch_matches_jax(jax_params, model):
    tc, jc = _confs(model)
    x, y = _tokens(3 * B, seed=6)
    xs, ys = x.reshape(3, B, T, V), y.reshape(3, B, T, V)
    jp = _jp(jax_params[model])
    jparams, jstates, jscores = JF.make_train_epoch(jc, 3, donate=False)(
        jp, JF.init_train_state(jc, jp), jnp.asarray(0), jnp.asarray(xs),
        jnp.asarray(ys), jax.random.PRNGKey(1))
    tp = _tp(jax_params[model])
    tparams, tstates, tscores = TF.make_train_epoch(tc, 3, donate=True)(
        tp, TF.init_train_state(tc, tp), 0, torch.from_numpy(xs),
        torch.from_numpy(ys), 1)
    assert tscores.shape == (3,) and tscores.dtype == torch.float32
    np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores),
                               atol=ATOL, rtol=0)
    _close(tparams, jparams)
    _close(tstates, jstates)


@pytest.mark.parametrize("model", MODELS)
def test_facade_fit_epochs_matches_jax(jax_params, model):
    tc, jc = _confs(model)
    x, y = _tokens(2 * B, seed=8)
    tnet = MultiLayerNetwork(tc, params=_tp(jax_params[model]),
                             device="cpu")
    jnet = JNet(jc, params=_jp(jax_params[model]))
    tnet.fit_epochs(ListDataSetIterator(DataSet(x, y), B), num_epochs=2)
    jnet.fit_epochs(JDataSet(x, y), num_epochs=2, batch_size=B)
    assert tnet._iteration == jnet._iteration == 4
    _close(tnet.params_tree, jnet.params_tree)
    _close(tnet._train_state, jnet._train_state)


def test_char_lstm_learns_the_echo_task():
    """The JAX package's test_char_lstm_trains_via_public_api at time 8:
    predict the previous timestep's token through fit_epochs; predict
    gives the argmax per timestep."""
    vocab = 8
    seq = np.random.RandomState(0).randint(0, vocab, size=(16, 8))
    x = np.eye(vocab, dtype=np.float32)[seq]
    y = np.concatenate([np.zeros_like(x[:, :1]), x[:, :-1]], axis=1)
    net = MultiLayerNetwork(tzoo.char_lstm(vocab=vocab, lr=0.05),
                            device="cpu").init()
    ds = DataSet(x, y)
    before = net.score(ds)
    net.fit_epochs(ds, num_epochs=150)
    after = net.score(ds)
    assert after < before * 0.6, (before, after)
    pred = net.predict(x)
    assert pred.shape == (16, 8)
    acc = float((pred[:, 1:] == np.argmax(y, axis=-1)[:, 1:]).mean())
    assert acc > 0.5, acc


def test_char_attention_lm_fit_learns_a_cyclic_pattern():
    """``fit`` (num_iterations steps a batch) learns next-char prediction
    on a cyclic pattern, as the JAX package's attention LM does."""
    pattern = np.arange(8) % 4
    seq = np.stack([np.roll(np.tile(pattern, 2), -s)[:9] for s in range(8)])
    eye = np.eye(V, dtype=np.float32)
    x, y = eye[seq[:, :-1]], eye[seq[:, 1:]]
    net = MultiLayerNetwork(
        tzoo.char_attention_lm(V, d_model=D_MODEL, n_heads=N_HEADS, lr=0.3,
                               num_iterations=10), device="cpu").init()
    for _ in range(5):
        net.fit(DataSet(x, y))
    pred = net.predict(x)
    assert pred.shape == (8, 8)
    assert (pred == seq[:, 1:]).mean() == 1.0


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_load_across_packages(jax_params, tmp_path, model,
                                          writer):
    tc, jc = _confs(model)
    path = str(tmp_path / f"{model}_{writer}.npz")
    x, _ = _tokens(2)
    if writer == "port":
        src = MultiLayerNetwork(tc, device="cpu").init()
        src.save(path)
        dst = JNet.load(path)
        np.testing.assert_array_equal(np.asarray(dst.params()),
                                      src.params().numpy())
        assert dst.conf == jc
        _close(src.output(x), dst.output(x))
    else:
        src = JNet(jc, params=_jp(jax_params[model]))
        src.save(path)
        dst = MultiLayerNetwork.load(path, device="cpu")
        np.testing.assert_array_equal(dst.params().numpy(),
                                      np.asarray(src.params()))
        assert dst.to_json() == jc.to_json()
        _close(dst.output(x), src.output(x))


@pytest.mark.parametrize("model", MODELS)
def test_interop_takes_the_sequence_layers_and_their_updater_state(
        jax_params, model):
    _, jc = _confs(model)
    np_params = jax_params[model]
    tp = _tp(np_params)
    _close(tp, np_params, 0.0)
    jstates = jax.tree_util.tree_map(
        np.asarray, JF.init_train_state(jc, _jp(np_params)))
    ts = interop.updater_state_from_numpy(jstates, device="cpu")
    _close(ts, jstates, 0.0)


@pytest.mark.parametrize("case", ["partial_lstm", "conv", "extra_key",
                                  "state_mismatch"])
def test_interop_rejects_other_key_sets(jax_params, case):
    layer = dict(jax_params["char_lstm"][0])
    if case == "partial_lstm":
        del layer["decoderbias"]
        with pytest.raises(ValueError, match="ported layer type"):
            interop.mln_params_from_numpy((layer,), device="cpu")
    elif case == "conv":
        # a conv layer carries across whole (slice 5), not without its
        # bias
        conv = {"convweights": np.zeros((2, 1, 3, 3), np.float32),
                "convbias": np.zeros(2, np.float32)}
        assert interop.mln_params_from_numpy((conv,), device="cpu")
        del conv["convbias"]
        with pytest.raises(ValueError, match="ported layer type"):
            interop.mln_params_from_numpy((conv,), device="cpu")
    elif case == "extra_key":
        layer["W"] = np.zeros((2, 2))
        with pytest.raises(ValueError, match="ported layer type"):
            interop.mln_params_from_numpy((layer,), device="cpu")
    else:
        other = {"W": np.zeros((2, 2)), "b": np.zeros(2)}
        with pytest.raises(ValueError, match="must hold exactly"):
            interop.updater_state_from_numpy(({"hist": layer, "v": other},),
                                             device="cpu")


def test_lstm_network_runs_through_the_cell_wrapper(jax_params):
    """Each timestep of the char-LSTM calls ``lstm_gates_fwd`` once (the
    wrapper that launches K2 on the card); on the CPU nothing is counted
    as a launch. ``set_lstm_gates(False)`` bypasses it and gives the same
    loss and grads at f32."""
    tc, _ = _confs("char_lstm")
    x, y = _tokens(B)
    calls = []
    orig = tpk.lstm_gates_fwd

    def counting(*args):
        calls.append(tuple(args[0].shape))
        return orig(*args)

    def loss_and_grads():
        params = _tp(jax_params["char_lstm"])
        leaves = [p.requires_grad_() for p in params[0].values()]
        loss = TF.network_loss(tc, params, torch.from_numpy(x),
                               torch.from_numpy(y))
        return loss.detach(), torch.autograd.grad(loss, leaves)

    tpk.lstm_gates_fwd = counting
    try:
        kl, kg = loss_and_grads()
        assert calls == [(B, 4 * V)] * T
        tpk.set_lstm_gates(False)
        pl, pg = loss_and_grads()
        assert len(calls) == T
    finally:
        tpk.lstm_gates_fwd = orig
        tpk.set_lstm_gates(None)
    assert _kernels.LAUNCHES["lstm_gates"] == 0
    assert abs(float(kl) - float(pl)) <= ATOL
    for a, b in zip(kg, pg):
        assert _rel(a, b) <= LAYER_REL


def test_entry_points_raise_without_cuda(jax_params):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    tc, _ = _confs("char_lstm")
    ta, _ = _confs("char_attention_lm")
    np_params = jax_params["char_lstm"]
    for call in (lambda: tparams_mod.init_layer_params(0, tc.conf(0)),
                 lambda: tparams_mod.init_layer_params(0, ta.conf(1)),
                 lambda: MultiLayerNetwork(tc),
                 lambda: MultiLayerNetwork(ta),
                 lambda: TF.init_params(tc, 0),
                 lambda: interop.mln_params_from_numpy(np_params),
                 lambda: interop.updater_state_from_numpy(
                     tuple({"hist": p, "v": p} for p in np_params))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
