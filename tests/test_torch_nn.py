"""The port's MultiLayerNetwork building blocks held against the JAX
package on the CPU: activations, losses, the dtype policy, configuration
JSON, the flat parameter vector, the updater, and the parts that cannot be
held bitwise (random init, dropout), checked by their properties.

Inputs come from numpy seeds and go through both packages. Tolerances:
f32 values 1e-6 relative to the reference's scale (elementwise math; the
two libraries' transcendentals differ in the last ulp), updater outputs
1e-6 absolute (O(1) values, a handful of f32 ops).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.nn import gradient as jgrad
from deeplearning4j_tpu.nn import params as jparams
from deeplearning4j_tpu.ops import activations as jact
from deeplearning4j_tpu.ops import dtypes as jdt
from deeplearning4j_tpu.ops import losses as jloss
from deeplearning4j_tpu.optimize import updater as jupd
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.nn import gradient as tgrad
from deeplearning4j_tpu_torch.nn import layers as tlayers
from deeplearning4j_tpu_torch.nn import params as tparams
from deeplearning4j_tpu_torch.nn import weights as tweights
from deeplearning4j_tpu_torch.nn.layers import dense as tdense
from deeplearning4j_tpu_torch.ops import activations as tact
from deeplearning4j_tpu_torch.ops import dtypes as tdt
from deeplearning4j_tpu_torch.ops import losses as tloss
from deeplearning4j_tpu_torch.ops import rng as trng
from deeplearning4j_tpu_torch.optimize import updater as tupd

REL = 1e-6
UPD_ATOL = 1e-6


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


# ------------------------------------------------------------ numerics ----

@pytest.mark.parametrize("name", jact.activation_names())
def test_every_activation_matches_jax(name):
    x = np.random.RandomState(0).randn(6, 9).astype(np.float32) * 3
    want = np.asarray(jact.activation(name)(jnp.asarray(x)))
    got = tact.activation(name)(_t(x)).numpy()
    assert tact.activation_names() == jact.activation_names()
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("name", ["sigmoid", "tanh", "relu", "linear",
                                  "identity", "softmax", "hardtanh",
                                  "softplus"])
def test_every_derivative_matches_jax(name):
    y = np.random.RandomState(1).uniform(-1.5, 1.5, (5, 7)).astype(np.float32)
    want = np.asarray(jact.derivative(name, jnp.asarray(y)))
    got = tact.derivative(name, _t(y)).numpy()
    assert _rel(got, want) <= REL


def test_unknown_activation_and_derivative_raise_like_jax():
    for fn in (lambda m: m.activation("swishy"),
               lambda m: m.derivative("cube", jnp.ones(2) if m is jact
                                      else torch.ones(2))):
        with pytest.raises(ValueError) as port_err:
            fn(tact)
        with pytest.raises(ValueError) as jax_err:
            fn(jact)
        assert str(port_err.value) == str(jax_err.value)


def _loss_inputs(seed=2):
    rng = np.random.RandomState(seed)
    labels = np.eye(5, dtype=np.float32)[rng.randint(0, 5, 8)]
    out = rng.dirichlet(np.ones(5), 8).astype(np.float32)
    logits = rng.randn(8, 5).astype(np.float32) * 2
    return labels, out, logits


@pytest.mark.parametrize("kind", [k.value for k in jloss.LossFunction])
def test_every_loss_matches_jax(kind):
    labels, out, _ = _loss_inputs()
    jp = jloss.per_example_loss(kind, jnp.asarray(labels), jnp.asarray(out))
    tp = tloss.per_example_loss(kind, _t(labels), _t(out))
    assert tuple(tp.shape) == jp.shape == (8,)
    assert _rel(tp.numpy(), np.asarray(jp)) <= REL
    jl = jloss.loss(kind, jnp.asarray(labels), jnp.asarray(out))
    tl = tloss.loss(kind, _t(labels), _t(out))
    assert _rel(float(tl), float(jl)) <= REL


@pytest.mark.parametrize("kind", ["MCXENT", "NEGATIVELOGLIKELIHOOD", "XENT",
                                  "RECONSTRUCTION_CROSSENTROPY"])
def test_fused_logits_losses_match_jax(kind):
    labels, _, logits = _loss_inputs(3)
    jp = jloss.per_example_loss_from_logits(kind, jnp.asarray(labels),
                                            jnp.asarray(logits))
    tp = tloss.per_example_loss_from_logits(kind, _t(labels), _t(logits))
    assert _rel(tp.numpy(), np.asarray(jp)) <= REL
    jl = jloss.loss_from_logits(kind, jnp.asarray(labels), jnp.asarray(logits))
    tl = tloss.loss_from_logits(kind, _t(labels), _t(logits))
    assert _rel(float(tl), float(jl)) <= REL
    with pytest.raises(ValueError, match="No fused-logits path"):
        tloss.per_example_loss_from_logits("MSE", _t(labels), _t(logits))


def test_finalize_loss_and_fusable_set():
    v = np.float32(0.37)
    for kind in ("RMSE_XENT", "MSE", "MCXENT"):
        want = float(jloss.finalize_loss(kind, jnp.asarray(v)))
        got = float(tloss.finalize_loss(kind, torch.tensor(v)))
        assert abs(got - want) <= 1e-7
    assert abs(float(tloss.finalize_loss("RMSE_XENT", torch.tensor(v)))
               - np.sqrt(0.37 + 1e-7)) <= 1e-7
    assert ({(a, k.value) for a, k in tloss.FUSABLE}
            == {(a, k.value) for a, k in jloss.FUSABLE})


def test_policy_casts_like_jax():
    assert tdt.DEFAULT == tdt.Policy()
    for tp, jp in ((tdt.DEFAULT, jdt.DEFAULT),
                   (tdt.BF16_COMPUTE, jdt.BF16_COMPUTE)):
        for field in ("param_dtype", "compute_dtype", "output_dtype"):
            assert (str(getattr(tp, field)).split(".")[-1]
                    == jnp.dtype(getattr(jp, field)).name)
    x = torch.randn(3, 4)
    assert tdt.cast_in(tdt.BF16_COMPUTE, x).dtype == torch.bfloat16
    assert tdt.cast_out(tdt.BF16_COMPUTE,
                        x.bfloat16()).dtype == torch.float32
    assert tdt.cast_in(tdt.DEFAULT, x) is x


# --------------------------------------------------------------- conf ----

def _rich_jax_conf():
    """A conf touching every field family: schedules, distributions,
    regularisation, conv tuples, preprocessors, several layer types."""
    return (jconf.NeuralNetConfiguration.Builder()
            .n_in(12).n_out(8).activation_function("tanh").lr(0.05)
            .momentum(0.8).momentum_after({3: 0.95, 10: 0.99})
            .use_regularization(True).l1(1e-4).l2(1e-3).dropout(0.25)
            .weight_init("DISTRIBUTION").dist(("uniform", -0.2, 0.2))
            .reset_ada_grad_iterations(5).step_function("negative_default")
            .list(4)
            .override(1, layer_type="CONVOLUTION", n_in=1, n_out=4,
                      filter_size=(3, 3), stride=(1, 1))
            .override(2, layer_type="LSTM", n_in=8, n_out=8)
            .override(3, layer_type="OUTPUT", n_in=8, n_out=3,
                      activation_function="softmax", loss_function="MCXENT")
            .input_preprocessor(1, "ff_to_conv")
            .hidden_layer_sizes(8, 8)
            .use_drop_connect(True).pretrain(False).backward(True)
            .build())


@pytest.mark.parametrize("make", ["mnist_mlp", "digits_mlp", "rich"])
def test_conf_json_loads_across_packages_both_ways(make):
    if make == "rich":
        jc = _rich_jax_conf()
    else:
        jc = getattr(jzoo, make)()
    text = jc.to_json()
    tc = tconf.MultiLayerConfiguration.from_json(text)
    assert tc.to_json() == text
    back = jconf.MultiLayerConfiguration.from_json(tc.to_json())
    assert back == jc
    single = jc.conf(0).to_json()
    assert tconf.NeuralNetConfiguration.from_json(single).to_json() == single


@pytest.mark.parametrize("make", ["mnist_mlp", "digits_mlp"])
def test_zoo_confs_equal_field_for_field(make):
    jc, tc = getattr(jzoo, make)(), getattr(tzoo, make)()
    assert json.loads(tc.to_json()) == json.loads(jc.to_json())
    assert tc.n_layers == jc.n_layers
    for i in range(jc.n_layers):
        for field, jv in jc.conf(i).to_dict().items():
            tv = tc.conf(i).to_dict()[field]
            assert json.dumps(tv) == json.dumps(jv), (i, field)


def test_conf_rejects_unknown_names_at_build_time():
    with pytest.raises(ValueError, match="Unknown activation"):
        tconf.NeuralNetConfiguration(activation_function="swishy")
    with pytest.raises(ValueError, match="Unknown step function"):
        tconf.NeuralNetConfiguration(step_function="sideways")
    c = tconf.NeuralNetConfiguration(momentum=0.5,
                                     momentum_after={2: 0.9, 5: 0.99})
    assert [c.momentum_at(i) for i in (0, 2, 4, 5)] == [0.5, 0.9, 0.9, 0.99]
    hash(tzoo.mnist_mlp())


# ------------------------------------------------- params and vectors ----

def _np_mlp_params(sizes=(20, 16, 8, 4), seed=0):
    rng = np.random.RandomState(seed)
    return tuple({"W": rng.randn(a, b).astype(np.float32),
                  "b": rng.randn(b).astype(np.float32)}
                 for a, b in zip(sizes[:-1], sizes[1:]))


def test_flat_vector_order_matches_jax():
    npp = _np_mlp_params()
    jflat = np.asarray(jgrad.flatten_params(
        tuple({k: jnp.asarray(v) for k, v in p.items()} for p in npp)))
    tp = interop.mln_params_from_numpy(npp, device="cpu")
    tflat = tgrad.flatten_params(tp)
    np.testing.assert_array_equal(tflat.numpy(), jflat)
    assert tgrad.num_params(tp) == jflat.size
    back = tgrad.unflatten_params(tp, tflat * 2)
    for p, q in zip(back, tp):
        assert torch.equal(p["W"], q["W"] * 2) and torch.equal(p["b"],
                                                               q["b"] * 2)


def test_unflatten_wrong_length_raises_like_jax():
    npp = _np_mlp_params()
    jp = tuple({k: jnp.asarray(v) for k, v in p.items()} for p in npp)
    tp = interop.mln_params_from_numpy(npp, device="cpu")
    with pytest.raises(ValueError) as jax_err:
        jgrad.unflatten_params(jp, jnp.zeros(5))
    with pytest.raises(ValueError) as port_err:
        tgrad.unflatten_params(tp, torch.zeros(5))
    assert str(port_err.value) == str(jax_err.value)


def test_interop_rejects_other_key_sets_and_round_trips():
    npp = _np_mlp_params()
    with pytest.raises(ValueError, match="exactly"):
        interop.mln_params_from_numpy(({"W": npp[0]["W"]},), device="cpu")
    with pytest.raises(ValueError, match="tuple"):
        interop.mln_params_from_numpy(npp[0], device="cpu")
    tp = interop.mln_params_from_numpy(npp, device="cpu",
                                       dtype=torch.bfloat16)
    assert tp[0]["W"].dtype == torch.bfloat16
    back = interop.tree_to_numpy(interop.mln_params_from_numpy(npp,
                                                               device="cpu"))
    assert isinstance(back, tuple)
    for p, q in zip(back, npp):
        np.testing.assert_array_equal(p["W"], q["W"])
    states = tuple({"hist": p, "v": p} for p in npp)
    ts = interop.updater_state_from_numpy(states, device="cpu")
    assert torch.equal(ts[1]["v"]["b"], torch.from_numpy(npp[1]["b"]))
    with pytest.raises(ValueError, match="exactly"):
        interop.updater_state_from_numpy(({"hist": npp[0]},), device="cpu")


@pytest.mark.parametrize("scheme", ["SIZE", "VI", "UNIFORM", "NORMALIZED",
                                    "ZERO", "DISTRIBUTION"])
def test_weight_init_distributions(scheme):
    """The port draws from torch's generator, so it is checked by range
    and moments, not against JAX's numbers."""
    fan_in, fan_out = 300, 200
    w = tweights.init_weights(5, (fan_in, fan_out), scheme, device="cpu")
    assert w.shape == (fan_in, fan_out) and w.dtype == torch.float32
    bound = {"SIZE": np.sqrt(6.0 / (fan_in + fan_out)),
             "VI": np.sqrt(6.0) / np.sqrt(fan_in + fan_out + 1.0),
             "UNIFORM": 1.0 / fan_in, "NORMALIZED": 0.5 / fan_in}
    if scheme == "ZERO":
        assert not w.any()
    elif scheme == "DISTRIBUTION":  # default ("normal", 0, 0.01)
        assert abs(float(w.mean())) < 5e-4
        assert abs(float(w.std()) - 0.01) < 5e-4
    else:
        s = bound[scheme]
        assert float(w.abs().max()) <= s
        assert abs(float(w.mean())) < 0.02 * s
        assert abs(float(w.var()) - s * s / 3) < 0.03 * s * s
    again = tweights.init_weights(5, (fan_in, fan_out), scheme, device="cpu")
    assert torch.equal(w, again)


def test_layer_params_keys_shapes_and_zero_bias():
    conf = tzoo.mnist_mlp(64, 32)
    p = tparams.init_layer_params(3, conf.conf(0), device="cpu")
    assert sorted(p) == ["W", "b"]
    assert p["W"].shape == (784, 64) and p["b"].shape == (64,)
    assert not p["b"].any()
    s = np.sqrt(6.0 / (784 + 64))
    assert float(p["W"].abs().max()) <= s


def test_rng_keys_are_deterministic_and_distinct():
    a, b = trng.split(7)
    assert [a, b] == trng.split(7) and a != b
    assert len(set(trng.split(7, 100))) == 100
    assert trng.fold_in(7, 1) == trng.fold_in(7, 1) != trng.fold_in(7, 2)
    ks1, ks2 = trng.KeySequence(3), trng.KeySequence(3)
    seq = [ks1.next() for _ in range(4)]
    assert seq == [ks2.next() for _ in range(4)] and len(set(seq)) == 4
    assert ks1.fold(0) == ks2.fold(0)
    g1, g2 = trng.generator(seq[0], "cpu"), trng.generator(seq[0], "cpu")
    assert torch.equal(torch.rand(5, generator=g1), torch.rand(5,
                                                               generator=g2))


# ------------------------------------------------------------ updater ----

_UPDATER_CASES = {
    "sgd": dict(momentum=0.0, use_ada_grad=False),
    "momentum": dict(momentum=0.9, use_ada_grad=False),
    "momentum_after": dict(momentum=0.5, use_ada_grad=False,
                           momentum_after={2: 0.95}),
    "adagrad_reset": dict(momentum=0.0, use_ada_grad=True,
                          reset_ada_grad_iterations=2),
    "l1": dict(momentum=0.0, use_ada_grad=False, use_regularization=True,
               l1=1e-3),
    "l2": dict(momentum=0.9, use_ada_grad=False, use_regularization=True,
               l2=1e-2),
    "unit_norm": dict(momentum=0.9, use_ada_grad=True,
                      constrain_gradient_to_unit_norm=True),
}


@pytest.mark.parametrize("case", sorted(_UPDATER_CASES))
def test_apply_updater_matches_jax(case):
    """Iterations 0..3 threaded through both updaters on the same grads,
    params and state: crosses the momentum_after entry at 2 and the
    AdaGrad reset at 2."""
    kw = _UPDATER_CASES[case]
    jc = jconf.NeuralNetConfiguration(lr=0.1, **kw)
    tc = tconf.NeuralNetConfiguration(lr=0.1, **kw)
    rng = np.random.RandomState(4)
    layer = {"W": rng.randn(6, 5).astype(np.float32),
             "b": rng.randn(5).astype(np.float32)}
    jparams = {k: jnp.asarray(v) for k, v in layer.items()}
    tparams_ = {k: _t(v) for k, v in layer.items()}
    jstate = jupd.init_updater_state(jparams)
    tstate = tupd.init_updater_state(tparams_)
    for it in range(4):
        grads = {k: rng.randn(*v.shape).astype(np.float32)
                 for k, v in layer.items()}
        jup, jstate = jupd.apply_updater(
            jc, jnp.asarray(it), {k: jnp.asarray(v) for k, v in grads.items()},
            jparams, jstate)
        tup, tstate = tupd.apply_updater(
            tc, torch.tensor(it), {k: _t(v) for k, v in grads.items()},
            tparams_, tstate)
        for k in ("W", "b"):
            np.testing.assert_allclose(tup[k].numpy(), np.asarray(jup[k]),
                                       atol=UPD_ATOL, rtol=0)
            for s in ("hist", "v"):
                np.testing.assert_allclose(tstate[s][k].numpy(),
                                           np.asarray(jstate[s][k]),
                                           atol=UPD_ATOL, rtol=0)
        jparams = {k: jparams[k] - jup[k] for k in jparams}
        tparams_ = {k: tparams_[k] - tup[k] for k in tparams_}


# ------------------------------------------------ dropout, unported ----

def test_dropout_keeps_rate_scales_and_is_identity_at_eval():
    x = torch.ones(400, 500)
    y = tdense.apply_dropout(x, 0.3, True, key=11)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.005
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert torch.equal(y, tdense.apply_dropout(x, 0.3, True, key=11))
    assert not torch.equal(y, tdense.apply_dropout(x, 0.3, True, key=12))
    assert tdense.apply_dropout(x, 0.3, False, key=11) is x
    assert tdense.apply_dropout(x, 0.3, True, key=None) is x
    assert tdense.apply_dropout(x, 0.0, True, key=11) is x


def test_drop_connect_masks_weights_at_half_and_scales_by_two():
    conf = tconf.NeuralNetConfiguration(n_in=300, n_out=200,
                                        activation_function="linear")
    params = {"W": torch.ones(300, 200), "b": torch.zeros(200)}
    eye = torch.eye(300)
    w_eff = tdense.pre_output(conf, params, eye, train=True, key=3,
                              drop_connect=True)
    kept = w_eff != 0
    assert abs(float(kept.float().mean()) - 0.5) < 0.01
    assert torch.equal(w_eff[kept], torch.full_like(w_eff[kept], 2.0))
    plain = tdense.pre_output(conf, params, eye, train=False, key=3,
                              drop_connect=True)
    assert torch.equal(plain, params["W"])
    # forward in training with drop-connect leaves the fused route
    out = tdense.forward(conf, params, eye, train=True, key=3,
                         drop_connect=True)
    assert abs(float((out != 0).float().mean()) - 0.5) < 0.01


@pytest.mark.parametrize("layer_type", ["RBM", "AUTOENCODER",
                                        "RECURSIVE_AUTOENCODER",
                                        "CONVOLUTION", "SUBSAMPLING"])
def test_unported_layer_types_name_their_slice(layer_type):
    conf = tconf.NeuralNetConfiguration(layer_type=layer_type, n_in=4,
                                        n_out=4)
    with pytest.raises(NotImplementedError, match="slice 5"):
        tparams.init_layer_params(0, conf, device="cpu")
    with pytest.raises(NotImplementedError, match="slice 5"):
        tlayers.forward(conf, {}, torch.ones(2, 4))


@pytest.mark.parametrize("layer_type", ["LSTM", "ATTENTION"])
def test_sequence_layer_types_init_with_jax_keys_and_shapes(layer_type):
    """The LSTM and ATTENTION layers (ported with K2 and the attention
    layer) init with the JAX package's keys, shapes and dtypes, and their
    weights are drawn from the conf's scheme: SIZE's U(-s, s), s =
    sqrt(6 / (fan_in + fan_out)); the gains ones, the biases zeros."""
    kw = {"n_heads": 2} if layer_type == "ATTENTION" else {}
    tc = tconf.NeuralNetConfiguration(layer_type=layer_type, n_in=8,
                                      n_out=6, weight_init="SIZE", **kw)
    jc = jconf.NeuralNetConfiguration(layer_type=layer_type, n_in=8,
                                      n_out=6, weight_init="SIZE", **kw)
    got = tparams.init_layer_params(0, tc, device="cpu")
    want = jparams.init_layer_params(jax.random.PRNGKey(0), jc)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert got[k].dtype == torch.float32 and w.dtype == jnp.float32, k
        if k in ("ln_g",):
            assert torch.equal(got[k], torch.ones_like(got[k]))
        elif k in ("ln_b", "decoderbias"):
            assert torch.equal(got[k], torch.zeros_like(got[k]))
        else:
            fan_in, fan_out = w.shape
            s = np.sqrt(6.0 / (fan_in + fan_out))
            assert float(got[k].abs().max()) <= s, k
            assert float(got[k].std()) > 0, k
    out = tlayers.forward(tc, got, torch.ones(2, 3, 8))
    assert tuple(out.shape) == (2, 3, 6)
