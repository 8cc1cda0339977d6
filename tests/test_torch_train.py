"""The port's single-device LM training step
(deeplearning4j_tpu_torch/models/transformer_lm.make_single_device_train_step)
held against the JAX package's on the same parameters and batch.

JAX parameters come from its own ``init_lm_params`` and go to the port with
``interop.lm_params_from_numpy``; tokens come from a numpy seed. On the CPU
the port's "blockwise" core is ``FlashAttention`` over the kernels' plain
versions, held against JAX's ``blockwise_attention`` custom VJP. Tolerance:
f32, 1e-5 absolute on loss, grads, params and optimizer moments (the two
packages sum in different orders; values are O(1) and below).

The Adam and LAMB steps run at ``OPT_LR`` = 1e-3, Adam's usual rate, not the
SGD default of 0.1: their first steps are nearly sign(g)·lr, so an element
whose gradient nearly cancels (|g| ~ 1e-7, where f32 summation order moves
g by ~1e-8) turns into an update difference of order lr·eps·δg/g², which at
lr 0.1 reaches 2e-4 on one weight of 8192 while every gradient agrees to
1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer_lm as jlm
from deeplearning4j_tpu.optimize import guardrails as jguard
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu.parallel import moe as jmoe
from deeplearning4j_tpu.telemetry import metrics as jmetrics
from deeplearning4j_tpu_torch.interop import (
    lm_params_from_numpy,
    opt_state_from_numpy,
    tree_to_numpy,
)
from deeplearning4j_tpu_torch.models import transformer_lm as tlm
from deeplearning4j_tpu_torch.optimize import guardrails as tguard
from deeplearning4j_tpu_torch.optimize import updaters as tupd
from deeplearning4j_tpu_torch.parallel import moe as tmoe
from deeplearning4j_tpu_torch.telemetry import metrics as tmetrics

V, D, H, E, DFF, L, B, T = 64, 32, 2, 2, 64, 2, 2, 64
ATOL = 1e-5
OPT_LR = 1e-3
IMPLS = ["dense", "blockwise"]


@pytest.fixture(scope="module")
def np_params():
    p = jlm.init_lm_params(jax.random.PRNGKey(0), V, D, H, E, DFF,
                           n_layers=L)
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def batch():
    toks = np.random.RandomState(4).randint(0, V, (B, T + 1)).astype(
        np.int32)
    return toks[:, :-1], toks[:, 1:]


def _jp(np_params):
    return jax.tree_util.tree_map(jnp.asarray, np_params)


def _tp(np_params):
    return lm_params_from_numpy(np_params, "cpu")


def _close(got, want, atol=ATOL):
    """A torch tree (or tensor) against a JAX one, leaf by leaf."""
    if isinstance(got, dict):
        got = tree_to_numpy(got)
    elif isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    _close_np(got, want, atol)


def _close_np(got, want, atol):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _close_np(got[key], want[key], atol)
        return
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _bits_equal(a: dict, b: dict) -> bool:
    """Bitwise equality of two torch trees (NaN equal to the same NaN)."""
    fa, fb = tree_to_numpy(a), tree_to_numpy(b)
    leaves_a = jax.tree_util.tree_leaves(fa)
    leaves_b = jax.tree_util.tree_leaves(fb)
    return all(x.dtype == y.dtype and x.tobytes() == y.tobytes()
               for x, y in zip(leaves_a, leaves_b))


@pytest.mark.parametrize("impl", IMPLS)
def test_loss_and_grads_match_jax(np_params, batch, impl):
    tok, tgt = batch
    jloss, jgrads = jax.value_and_grad(jlm.dense_loss_fn(H, attn_impl=impl))(
        _jp(np_params), jnp.asarray(tok), jnp.asarray(tgt))
    loss, grads = tlm.lm_value_and_grad(
        tlm.dense_loss_fn(H, attn_impl=impl), _tp(np_params),
        torch.from_numpy(tok), torch.from_numpy(tgt))
    _close(loss, jloss)
    _close(grads, jax.tree_util.tree_map(np.asarray, jgrads))
    # the slice-1 fault: every attention leaf of every layer gets a grad
    for key in ("wq", "wk", "wv", "ln_g", "ln_b"):
        assert (grads["blocks"][key].abs().flatten(1).amax(1) > 0).all(), key


@pytest.mark.parametrize("impl", IMPLS)
def test_sgd_steps_match_jax(np_params, batch, impl):
    tok, tgt = batch
    jstep = jlm.make_single_device_train_step(H, attn_impl=impl)
    tstep = tlm.make_single_device_train_step(H, attn_impl=impl,
                                              device="cpu")
    jp, tp = _jp(np_params), _tp(np_params)
    for _ in range(3):
        jp, jloss = jstep(jp, jnp.asarray(tok), jnp.asarray(tgt))
        tp, tloss = tstep(tp, tok, tgt)
        _close(tloss, jloss)
    _close(tp, jax.tree_util.tree_map(np.asarray, jp))


def _opt_run(np_params, batch, impl, optimizer, n_steps, **kw):
    tok, tgt = batch
    jstep = jlm.make_single_device_train_step(H, OPT_LR, attn_impl=impl,
                                              optimizer=optimizer, **kw)
    tstep = tlm.make_single_device_train_step(H, OPT_LR, attn_impl=impl,
                                              optimizer=optimizer,
                                              device="cpu", **kw)
    jp, tp = _jp(np_params), _tp(np_params)
    js = jlm.init_lm_opt_state(optimizer, jp)
    ts = tlm.init_lm_opt_state(optimizer, tp, device="cpu")
    for _ in range(n_steps):
        jout = jstep(jp, js, jnp.asarray(tok), jnp.asarray(tgt))
        tout = tstep(tp, ts, tok, tgt)
        assert len(tout) == len(jout)
        jp, js, tp, ts = jout[0], jout[1], tout[0], tout[1]
        _close(tout[2], jout[2])
    return jout, tout


def _close_state(ts, js):
    assert ts["count"].dtype == torch.int32
    assert int(ts["count"]) == int(js["count"])
    _close(ts["m"], jax.tree_util.tree_map(np.asarray, js["m"]))
    _close(ts["v"], jax.tree_util.tree_map(np.asarray, js["v"]))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("optimizer,n_steps", [("adam", 3), ("lamb", 1)])
def test_optimizer_steps_match_jax(np_params, batch, impl, optimizer,
                                   n_steps):
    jout, tout = _opt_run(np_params, batch, impl, optimizer, n_steps)
    _close(tout[0], jax.tree_util.tree_map(np.asarray, jout[0]))
    _close_state(tout[1], jout[1])


@pytest.mark.parametrize("optimizer", [None, "adam"])
@pytest.mark.parametrize("guard", [True, "clip"])
def test_guard_block_matches_jax(np_params, batch, optimizer, guard):
    """On a clean batch the guard block matches JAX's and the params are
    those of the unguarded step; ``clip`` clips (threshold below the grad
    norm) and must agree too."""
    tok, tgt = batch
    jg = jguard.GuardConfig(clip_norm=0.5) if guard == "clip" else True
    tg = tguard.GuardConfig(clip_norm=0.5) if guard == "clip" else True
    lr = OPT_LR if optimizer else 0.1
    jstep = jlm.make_single_device_train_step(H, lr, attn_impl="dense",
                                              guard=jg, optimizer=optimizer)
    tstep = tlm.make_single_device_train_step(H, lr, attn_impl="dense",
                                              guard=tg, optimizer=optimizer,
                                              device="cpu")
    jp, tp = _jp(np_params), _tp(np_params)
    if optimizer is None:
        jout = jstep(jp, jnp.asarray(tok), jnp.asarray(tgt))
        tout = tstep(tp, tok, tgt)
    else:
        jout = jstep(jp, jlm.init_lm_opt_state(optimizer, jp),
                     jnp.asarray(tok), jnp.asarray(tgt))
        tout = tstep(tp, tlm.init_lm_opt_state(optimizer, tp, device="cpu"),
                     tok, tgt)
        _close_state(tout[1], jout[1])
    jgm, tgm = jout[-1], tout[-1]
    assert sorted(tgm) == sorted(jgm) == ["clipped", "guard_grad_norm",
                                          "nonfinite"]
    _close(tgm, {k: np.asarray(v) for k, v in jgm.items()})
    assert float(tgm["clipped"]) == (1.0 if guard == "clip" else 0.0)
    assert float(tgm["nonfinite"]) == 0.0
    _close(tout[0], jax.tree_util.tree_map(np.asarray, jout[0]))


@pytest.mark.parametrize("optimizer", [None, "adam"])
def test_guard_skips_nonfinite_bitwise(np_params, batch, optimizer):
    """A NaN param poisons loss and grads: params and optimizer state come
    back bitwise, with nonfinite set, as in JAX."""
    tok, tgt = batch
    poisoned = jax.tree_util.tree_map(np.copy, np_params)
    poisoned["blocks"]["wq"][0, 0, 0] = np.nan
    jstep = jlm.make_single_device_train_step(H, attn_impl="dense",
                                              guard=True, optimizer=optimizer)
    tstep = tlm.make_single_device_train_step(H, attn_impl="dense",
                                              guard=True, optimizer=optimizer,
                                              device="cpu")
    jp, tp = _jp(poisoned), _tp(poisoned)
    if optimizer is None:
        jout = jstep(jp, jnp.asarray(tok), jnp.asarray(tgt))
        tout = tstep(tp, tok, tgt)
    else:
        # one clean step first, so the state carried through is not zeros
        clean = tlm.make_single_device_train_step(H, attn_impl="dense",
                                                  optimizer=optimizer,
                                                  device="cpu")
        _, ts, _ = clean(_tp(np_params),
                         tlm.init_lm_opt_state(optimizer, tp, device="cpu"),
                         tok, tgt)
        js = jupd.init_opt_state(jupd.OptimizerConfig.coerce(optimizer), jp)
        jout = jstep(jp, js, jnp.asarray(tok), jnp.asarray(tgt))
        tout = tstep(tp, ts, tok, tgt)
        assert _bits_equal(tout[1], ts)
        assert int(tout[1]["count"]) == 1
    assert _bits_equal(tout[0], tp)
    assert float(tout[-1]["nonfinite"]) == float(jout[-1]["nonfinite"]) == 1.0
    assert not np.isfinite(float(tout[-2])) and not np.isfinite(
        float(jout[-2]))


@pytest.mark.parametrize("optimizer", [None, "adam", "lamb"])
def test_with_metrics_matches_jax(np_params, batch, optimizer):
    tok, tgt = batch
    kw = dict(lr=OPT_LR if optimizer else 0.1, attn_impl="blockwise",
              with_metrics=True, optimizer=optimizer)
    jstep = jlm.make_single_device_train_step(H, **kw)
    tstep = tlm.make_single_device_train_step(H, device="cpu", **kw)
    jp, tp = _jp(np_params), _tp(np_params)
    if optimizer is None:
        jout = jstep(jp, jnp.asarray(tok), jnp.asarray(tgt))
        tout = tstep(tp, tok, tgt)
    else:
        jout = jstep(jp, jlm.init_lm_opt_state(optimizer, jp),
                     jnp.asarray(tok), jnp.asarray(tgt))
        tout = tstep(tp, tlm.init_lm_opt_state(optimizer, tp, device="cpu"),
                     tok, tgt)
    jm, tm = jout[-1], tout[-1]
    assert sorted(tm) == sorted(jm)
    _close(tm, {k: np.asarray(v) for k, v in jm.items()})
    assert abs(float(tm["router_load"].sum()) - 1.0) < 1e-6


@pytest.mark.parametrize("seed", [0, 1])
def test_load_balance_loss_and_router_load_match_jax(seed):
    rng = np.random.RandomState(seed)
    rw = rng.randn(D, 4).astype(np.float32)
    x = rng.randn(50, D).astype(np.float32)
    want = jmoe.load_balance_loss(jnp.asarray(rw), jnp.asarray(x))
    trw = torch.from_numpy(rw).requires_grad_()
    got = tmoe.load_balance_loss(trw, torch.from_numpy(x))
    _close(got, want)
    # the gradient flows through the mean router probability only
    jgrad = jax.grad(jmoe.load_balance_loss)(jnp.asarray(rw), jnp.asarray(x))
    (tgrad,) = torch.autograd.grad(got, trw)
    _close(tgrad, jgrad)
    for top_k in (1, 2):
        _close(tmoe.router_load_fraction(torch.from_numpy(rw),
                                         torch.from_numpy(x), top_k),
               jmoe.router_load_fraction(jnp.asarray(rw), jnp.asarray(x),
                                         top_k))


def test_router_load_ties_take_the_first_expert():
    """Equal logits: argmax and top-k pick the lower index, in both."""
    rw = np.zeros((D, 4), np.float32)
    x = np.ones((6, D), np.float32)
    got = tmoe.router_load_fraction(torch.from_numpy(rw),
                                    torch.from_numpy(x), 1)
    assert got.tolist() == [1.0, 0.0, 0.0, 0.0]
    _close(tmoe.load_balance_loss(torch.from_numpy(rw), torch.from_numpy(x)),
           jmoe.load_balance_loss(jnp.asarray(rw), jnp.asarray(x)))


def test_global_norm_and_step_metrics_match_jax(np_params):
    jp = _jp(np_params)
    tp = _tp(np_params)
    _close(tmetrics.global_norm(tp), jmetrics.global_norm(jp))
    assert float(tmetrics.global_norm({})) == 0.0
    half = jax.tree_util.tree_map(lambda x: x * 0.5, jp)
    thalf = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, half),
                                 "cpu")
    _close(tmetrics.update_metrics(tp, thalf, 0.1),
           {k: np.asarray(v) for k, v in
            jmetrics.update_metrics(jp, half, 0.1).items()})
    _close(tmetrics.train_step_metrics(tp, thalf, 0.1,
                                       loss=torch.tensor(2.0)),
           {k: np.asarray(v) for k, v in jmetrics.train_step_metrics(
               jp, half, 0.1, loss=2.0).items()})


def test_donate_false_leaves_inputs_untouched(np_params, batch):
    tok, tgt = batch
    tp = _tp(np_params)
    before = tree_to_numpy(tp)
    step = tlm.make_single_device_train_step(H, optimizer="adam",
                                             device="cpu")
    state = tlm.init_lm_opt_state("adam", tp, device="cpu")
    new_p, new_s, _ = step(tp, state, tok, tgt)
    assert _bits_equal(tp, lm_params_from_numpy(before, "cpu"))
    assert int(state["count"]) == 0 and float(tmetrics.global_norm(
        state["m"])) == 0.0
    assert new_p["embed"] is not tp["embed"] and int(new_s["count"]) == 1


@pytest.mark.parametrize("optimizer", [None, "adam"])
def test_donate_true_updates_in_place(np_params, batch, optimizer):
    """donate=True returns the incoming tensors holding what donate=False
    returns."""
    tok, tgt = batch
    kw = dict(attn_impl="dense", optimizer=optimizer, device="cpu")
    plain = tlm.make_single_device_train_step(H, **kw)
    donated = tlm.make_single_device_train_step(H, donate=True, **kw)
    tp = _tp(np_params)
    args = ((tlm.init_lm_opt_state(optimizer, tp, device="cpu"),)
            if optimizer else ())
    want = plain(_tp(np_params), *args, tok, tgt)
    got = donated(tp, *args, tok, tgt)
    assert got[0] is tp and got[0]["blocks"]["wq"] is tp["blocks"]["wq"]
    assert _bits_equal(got[0], want[0])
    if optimizer:
        assert got[1] is args[0] and _bits_equal(got[1], want[1])


def test_sharded_update_and_bad_seams_rejected(np_params, monkeypatch):
    cfg = tupd.OptimizerConfig(update_sharding="sharded")
    with pytest.raises(ValueError, match="sharded"):
        tlm.make_single_device_train_step(H, optimizer=cfg, device="cpu")
    with pytest.raises(ValueError, match="sharded"):
        tlm.init_lm_opt_state(cfg, _tp(np_params), device="cpu")
    monkeypatch.setenv(tupd.UPDATE_SHARDING_ENV, "bogus")
    with pytest.raises(ValueError):
        tupd.resolve_update_sharding()
    assert tupd.resolve_update_sharding("replicated") == \
        jupd.resolve_update_sharding("replicated")
    with pytest.raises(ValueError):
        tupd.OptimizerConfig(name="rmsprop")
    with pytest.raises(TypeError):
        tguard.GuardConfig.coerce("yes")
    with pytest.raises(ValueError, match="optimizer"):
        tlm.init_lm_opt_state(None, _tp(np_params), device="cpu")
    assert tupd.OptimizerConfig.coerce("adagrad").eps == \
        jupd.OptimizerConfig.coerce("adagrad").eps
    with pytest.raises(TypeError):
        tlm.make_single_device_train_step(H, profile=True, device="cpu")


@pytest.mark.parametrize("name", ["adagrad", "momentum", "sgd"])
def test_other_optimizers_match_jax(np_params, name):
    """The legacy-lineage updates on one synthetic gradient, with weight
    decay, against JAX's opt_update."""
    rng = np.random.RandomState(6)
    grads_np = jax.tree_util.tree_map(
        lambda x: rng.randn(*x.shape).astype(np.float32) * 0.01, np_params)
    jcfg = jupd.OptimizerConfig(name=name, weight_decay=0.01)
    tcfg = tupd.OptimizerConfig(name=name, weight_decay=0.01)
    jp = _jp(np_params)
    js = jupd.init_opt_state(jcfg, jp)
    ts = tupd.init_opt_state(tcfg, _tp(np_params))
    jnew, jst, jm = jupd.opt_update(jcfg, jp, _jp(grads_np), js, 0.1,
                                    with_metrics=True)
    tnew, tst, tm = tupd.opt_update(tcfg, _tp(np_params),
                                    lm_params_from_numpy(grads_np, "cpu"),
                                    ts, 0.1, with_metrics=True)
    _close(tnew, jax.tree_util.tree_map(np.asarray, jnew))
    _close_state(tst, jst)
    _close(tm, {k: np.asarray(v) for k, v in jm.items()})


def test_opt_state_round_trips_through_numpy(np_params):
    jp = _jp(np_params)
    js = jupd.init_opt_state(jupd.OptimizerConfig(), jp)
    js = {"m": jax.tree_util.tree_map(lambda x: x + 1.5, js["m"]),
          "v": js["v"], "count": js["count"] + 7}
    np_state = {"m": jax.tree_util.tree_map(np.asarray, js["m"]),
                "v": jax.tree_util.tree_map(np.asarray, js["v"]),
                "count": np.asarray(js["count"])}
    ts = opt_state_from_numpy(np_state, "cpu")
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 7
    back = tree_to_numpy(ts)
    assert int(back["count"]) == 7
    np.testing.assert_array_equal(back["m"]["embed"], np_state["m"]["embed"])
    with pytest.raises(ValueError, match="exactly"):
        opt_state_from_numpy({"m": {}, "v": {}}, "cpu")
    bf = tree_to_numpy({"x": torch.ones(3, dtype=torch.bfloat16)})
    assert bf["x"].dtype == np.float32


def test_training_reduces_loss_through_the_flash_core(np_params, batch):
    """Five SGD steps on one batch through FlashAttention: the loss falls,
    as the chip run checks at full width."""
    tok, tgt = batch
    step = tlm.make_single_device_train_step(H, attn_impl="flash",
                                             donate=True, device="cpu")
    tp = _tp(np_params)
    losses = []
    for _ in range(5):
        tp, loss = step(tp, tok, tgt)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert tlm.selected_attn_impl(T) == jlm.selected_attn_impl(T)
    assert tlm.selected_attn_impl(2048, "flash") == "flash"
