"""The port's data-parallel LM step (``make_composed_train_step`` on a
("data",) mesh, deeplearning4j_tpu_torch/models/transformer_lm.py) held
against the JAX package's composed step on a 4-device ("data",) mesh of
the tests' CPU devices.

Four gloo ranks start ONCE for the module (tests/_torch_parallel_ranks.py,
torch and the port only) and run every scenario from the JAX package's
params: SGD, the metrics block, a guarded run with one non-finite batch,
Adam replicated and ZeRO-sharded, and a batch whose shards route
differently; the JAX references run in this process while they do.

Tolerances: params to ``REL`` of each leaf's largest finite magnitude (the
ranks sum their grads in gloo's order, JAX in XLA's), losses to
``LOSS_TOL``; the port's replicated and sharded Adam to ``ZERO_ATOL`` (the
same math). The Adam runs are float64 on both sides (JAX under x64): at
f32, Adam's normalized first steps turn the summation-order noise of an
expert bias's near-zero grads into 5e-5 of the leaf's max.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_lm_init import lm_params_np
from _torch_parallel_ranks import collect_ranks, spawn_ranks
from deeplearning4j_tpu.models import transformer_lm as JT
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu_torch.interop import lm_params_from_numpy, \
    tree_to_numpy
from deeplearning4j_tpu_torch.models import transformer_lm as TT
from deeplearning4j_tpu_torch.parallel.mesh import Mesh

WORLD = 4
V, D, H, E, FF, L, T, B = 64, 32, 2, 4, 64, 2, 16, 8
LR = 0.1
CAP = 0            # capacity: inert without an "expert" axis
REL = 1e-5         # f32 params, of each leaf's largest finite magnitude
LOSS_TOL = 1e-5    # relative
ZERO_ATOL = 1e-6   # sharded against replicated Adam
SPAWN_TIMEOUT_S = 240

ADAM = {mode: {"name": "adam", "lr": 1e-3, "update_sharding": mode}
        for mode in ("replicated", "sharded")}
# 2 all-reduces a step (the forward's router statistics, the grads); the
# ZeRO update adds its one all-gather
COLLECTIVES = {"sgd": (2, 0), "metrics": (2, 0), "guard": (2, 0),
               "adam_replicated": (2, 0), "adam_sharded": (2, 1),
               "routing": (2, 0)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _batches(rng, n, lo=0, hi=V - 1):
    return [(rng.randint(lo, hi, (B, T)).astype(np.int32),
             rng.randint(0, V, (B, T)).astype(np.int32)) for _ in range(n)]


def _routing_batch(rng):
    """Shard r's rows draw tokens from their own eighth of the vocab, so
    the shards route differently."""
    tokens = np.concatenate([
        rng.randint(16 * r, 16 * r + 16, (B // WORLD, T))
        for r in range(WORLD)]).astype(np.int32)
    return tokens, rng.randint(0, V, (B, T)).astype(np.int32)


def _inputs():
    params = lm_params_np(0, V, D, H, E, FF, L)
    rng = np.random.RandomState(0)
    batches = _batches(rng, 3)
    # the guarded run: token V-1's embedding is inf and only batch 1 (on
    # rank 2's rows) reads it, so that batch's loss is non-finite
    guard_params = jax.tree_util.tree_map(np.copy, params)
    guard_params["embed"][V - 1] = np.inf
    guard_batches = _batches(rng, 3)
    guard_batches[1][0][5, 3] = V - 1
    params64 = jax.tree_util.tree_map(lambda a: a.astype(np.float64), params)
    common = {"kind": "lm", "n_heads": H, "capacity": CAP, "lr": LR,
              "params": params, "batches": batches}
    return {
        "sgd": dict(common),
        "metrics": dict(common, with_metrics=True),
        "guard": dict(common, guard=True, params=guard_params,
                      batches=guard_batches),
        "adam_replicated": dict(common, optimizer=ADAM["replicated"],
                                params=params64, x64=True),
        "adam_sharded": dict(common, optimizer=ADAM["sharded"],
                             params=params64, x64=True),
        "routing": dict(common, batches=[_routing_batch(rng)]),
    }


def _jax_run(inp):
    """JAX's composed step on the 4-device ("data",) mesh over ``inp``'s
    batches: (params, losses, blocks, canonical opt state)."""
    if inp.get("x64"):
        with jax.enable_x64(True):
            return _jax_run(dict(inp, x64=False))
    mesh = jmesh.data_parallel_mesh(WORLD)
    opt = (None if inp.get("optimizer") is None
           else jupd.OptimizerConfig(**inp["optimizer"]))
    step = JT.make_composed_train_step(
        mesh, H, CAP, lr=LR, with_metrics=inp.get("with_metrics", False),
        guard=inp.get("guard"), optimizer=opt)
    params = JT.shard_lm_params(
        jax.tree_util.tree_map(jnp.asarray, inp["params"]), mesh)
    state = None if opt is None else JT.init_lm_opt_state(opt, params, mesh)
    losses, blocks = [], []
    for tokens, targets in inp["batches"]:
        tk, tg = JT.shard_lm_batch(jnp.asarray(tokens), jnp.asarray(targets),
                                   mesh)
        out = (step(params, tk, tg) if opt is None
               else step(params, state, tk, tg))
        if opt is None:
            params, loss = out[0], out[1]
        else:
            params, state, loss = out[0], out[1], out[2]
        losses.append(float(loss))
        if len(out) == (3 if opt is None else 4):
            blocks.append(_np(out[-1]))
    canon = None
    if opt is not None:
        zero = JT.lm_update_sharding(mesh) if opt.sharded else None
        canon = jupd.canonical_opt_state(state, params, zero)
    return _np(params), losses, blocks, canon


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results and JAX's, per scenario."""
    root = tmp_path_factory.mktemp("lm_dp")
    inputs = _inputs()
    procs = spawn_ranks(root, inputs, WORLD)
    try:
        ref = {name: _jax_run(inp) for name, inp in inputs.items()}
    finally:
        results = collect_ranks(root, procs, SPAWN_TIMEOUT_S)
    return inputs, results, ref


def _rank(runs, name, rank=0):
    out = runs[1][rank][name]
    assert "error" not in out, out.get("error")
    return out


def _assert_close(got, want, rel=REL, what=""):
    """Every leaf of ``got`` within ``rel`` of ``want``'s largest finite
    magnitude, with non-finite entries in the same places."""
    w_leaves = jax.tree_util.tree_leaves_with_path(want)
    g_leaves = jax.tree_util.tree_leaves(got)
    assert len(w_leaves) == len(g_leaves), what
    for (path, w), g in zip(w_leaves, g_leaves):
        w, g = np.asarray(w, np.float64), np.asarray(g, np.float64)
        where = (what, jax.tree_util.keystr(path))
        assert w.shape == g.shape, where
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=str(where))
        np.testing.assert_array_equal(g[~fin], w[~fin], err_msg=str(where))
        if fin.any():
            err = float(np.max(np.abs(w[fin] - g[fin])))
            assert err <= rel * float(np.max(np.abs(w[fin]))), (where, err)


def _max_rel_err(got, want) -> float:
    errs = []
    for w, g in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(got)):
        w, g = np.asarray(w, np.float64), np.asarray(g, np.float64)
        errs.append(float(np.max(np.abs(w - g))) / float(np.max(np.abs(w))))
    return max(errs)


@pytest.mark.parametrize("name", ["sgd", "metrics", "guard",
                                  "adam_replicated", "adam_sharded"])
def test_steps_match_jax_on_every_rank(runs, name):
    params, losses, _, _ = runs[2][name]
    for rank in range(WORLD):
        out = _rank(runs, name, rank)
        _assert_close(out["params"], params, what=(name, rank))
        np.testing.assert_allclose(out["losses"], losses, rtol=LOSS_TOL)


def test_metrics_block_is_jax_global_one(runs):
    _, _, blocks, _ = runs[2]["metrics"]
    for rank in range(WORLD):
        got = _rank(runs, "metrics", rank)["blocks"]
        assert len(got) == len(blocks) == 3
        for g, w in zip(got, blocks):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-7,
                                           err_msg=k)


def test_guard_skips_the_non_finite_batch_on_every_rank(runs):
    _, losses, blocks, _ = runs[2]["guard"]
    assert not np.isfinite(losses[1]) and np.isfinite(losses[2])
    assert [float(b["nonfinite"]) for b in blocks] == [0.0, 1.0, 0.0]
    for rank in range(WORLD):
        got = _rank(runs, "guard", rank)["blocks"]
        assert [float(b["nonfinite"]) for b in got] == [0.0, 1.0, 0.0]
        for g, w in zip(got, blocks):
            if np.isfinite(w["guard_grad_norm"]):
                np.testing.assert_allclose(g["guard_grad_norm"],
                                           w["guard_grad_norm"], rtol=1e-5)


@pytest.mark.parametrize("mode", ["replicated", "sharded"])
def test_adam_state_matches_jax(runs, mode):
    name = "adam_" + mode
    _, _, _, canon = runs[2][name]
    out = _rank(runs, name, 1)
    _assert_close(out["opt_state"]["m"], canon["m"], what="m")
    _assert_close(out["opt_state"]["v"], canon["v"], what="v")
    assert int(out["opt_state"]["count"]) == int(canon["count"]) == 3
    if mode == "sharded":
        # this rank's (1, chunk) row of the (dp, ceil(n/dp)) layout
        assert out["m_shape"] == (1, -(-V * D // WORLD))


def test_sharded_adam_equals_replicated(runs):
    rep = _rank(runs, "adam_replicated")
    shard = _rank(runs, "adam_sharded")
    for a, b in zip(jax.tree_util.tree_leaves(rep["params"]),
                    jax.tree_util.tree_leaves(shard["params"])):
        np.testing.assert_allclose(b, a, atol=ZERO_ATOL, rtol=0)


@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collectives_per_step(runs, name):
    reduces, gathers = COLLECTIVES[name]
    out = _rank(runs, name, 3)
    n = len(runs[0][name]["batches"])
    assert out["all_reduce"] == [reduces] * n
    assert out["all_gather"] == [gathers] * n


def test_aux_is_global_where_shards_route_differently(runs):
    """Per-rank aux averaging is not JAX's loss: on a batch whose shards
    route differently, the mean of the shards' aux losses misses the
    global aux, and one SGD step from the shards' averaged grads misses
    JAX's params; the ranks' step matches both."""
    inp = runs[0]["routing"]
    params, losses, _, _ = runs[2]["routing"]
    tokens, targets = inp["batches"][0]
    # JAX's global aux: the dense loss's metrics on the whole batch
    jloss = JT.dense_loss_fn(H, with_metrics=True)
    _, jm = jloss(jax.tree_util.tree_map(jnp.asarray, inp["params"]),
                  jnp.asarray(tokens), jnp.asarray(targets))
    tp = lm_params_from_numpy(inp["params"], "cpu")
    step = TT.make_single_device_train_step(H, lr=LR, with_metrics=True,
                                            device="cpu")
    rows = B // WORLD
    shard_aux, shard_loss, shard_params = [], [], []
    for r in range(WORLD):
        sl = slice(r * rows, (r + 1) * rows)
        p, loss, m = step(tp, torch.from_numpy(tokens[sl]),
                          torch.from_numpy(targets[sl]))
        shard_aux.append(float(m["aux_loss"]))
        shard_loss.append(float(loss))
        shard_params.append(tree_to_numpy(p))
    gap = abs(np.mean(shard_aux) - float(jm["aux_loss"]))
    assert gap > 100 * LOSS_TOL * float(jm["aux_loss"]), gap
    naive = jax.tree_util.tree_map(lambda *xs: np.mean(xs, axis=0),
                                   *shard_params)
    assert _max_rel_err(naive, params) > 10 * REL
    assert abs(np.mean(shard_loss) - losses[0]) > 10 * LOSS_TOL * losses[0]
    for rank in range(WORLD):
        out = _rank(runs, "routing", rank)
        _assert_close(out["params"], params, what=rank)
        np.testing.assert_allclose(out["losses"], losses, rtol=LOSS_TOL)


def _fake_mesh(n, r, names=("data",)):
    return types.SimpleNamespace(axis_names=names, shape={"data": n},
                                 coords={"data": r}, device=None, size=n)


def test_shard_lm_batch_rows_and_indivisible_batch():
    tokens = np.arange(8 * 3).reshape(8, 3)
    targets = tokens + 100
    jm = jmesh.data_parallel_mesh(WORLD)
    jt, _ = JT.shard_lm_batch(jnp.asarray(tokens), jnp.asarray(targets), jm)
    for r in range(WORLD):
        tk, tg = TT.shard_lm_batch(tokens, targets, _fake_mesh(WORLD, r),
                                   device="cpu")
        want = np.asarray(jt.addressable_shards[r].data)
        np.testing.assert_array_equal(tk.numpy(), want)
        np.testing.assert_array_equal(tg.numpy(), want + 100)
    with pytest.raises(ValueError):
        JT.shard_lm_batch(jnp.zeros((6, 3)), jnp.zeros((6, 3)), jm)
    with pytest.raises(ValueError, match="does not split"):
        TT.shard_lm_batch(np.zeros((6, 3)), np.zeros((6, 3)),
                          _fake_mesh(WORLD, 0), device="cpu")


def test_lm_param_shardings_replicate_every_leaf():
    params = lm_params_np(1, V, D, H, E, FF, L)
    jm = jmesh.data_parallel_mesh(WORLD)
    want = jax.tree_util.tree_map(lambda s: tuple(s.spec),
                                  JT.lm_param_shardings(params, jm))
    got = TT.lm_param_shardings(lm_params_from_numpy(params, "cpu"),
                                Mesh(("data",), (1,)))
    flat_w = jax.tree_util.tree_leaves_with_path(
        want, is_leaf=lambda x: isinstance(x, tuple))
    flat_g = jax.tree_util.tree_leaves_with_path(
        got, is_leaf=lambda x: isinstance(x, tuple))
    assert [(jax.tree_util.keystr(p), s) for p, s in flat_g] == \
        [(jax.tree_util.keystr(p), s) for p, s in flat_w]
    assert all(s == () for _, s in flat_g)
    zero = TT.lm_update_sharding(Mesh(("data",), (1,)))
    assert zero.axis == "data" and zero.n == 1


@pytest.mark.parametrize("axes", [("data", "sp"), ("data", "expert"),
                                  ("sp",), ("data", "sp", "expert")])
def test_sp_and_expert_meshes_place_like_jax(axes):
    """On ("data", "sp", "expert") meshes (each axis of one rank here; the
    multi-rank parity is tests/test_torch_composed.py) the composed step
    builds, the param specs are JAX's, the batch block is the one
    ``P("data", "sp")`` places on the rank, and one SGD step equals JAX's
    composed step on the same-shaped 1-device mesh."""
    import jax.sharding as jsh

    mesh = Mesh(axes, (1,) * len(axes))
    jm = jsh.Mesh(np.array(jax.devices()[:1]).reshape((1,) * len(axes)),
                  axes)
    params = lm_params_np(1, V, D, H, E, FF, 1)
    want = jax.tree_util.tree_map(lambda s: tuple(s.spec),
                                  JT.lm_param_shardings(params, jm))
    got = TT.lm_param_shardings(lm_params_from_numpy(params, "cpu"), mesh)
    assert jax.tree_util.tree_leaves(got, is_leaf=lambda x: isinstance(
        x, tuple)) == jax.tree_util.tree_leaves(
        want, is_leaf=lambda x: isinstance(x, tuple))
    tokens, targets = _batches(np.random.RandomState(5), 1)[0]
    tk, tg = TT.shard_lm_batch(tokens, targets, mesh, device="cpu")
    np.testing.assert_array_equal(tk.numpy(), tokens)
    step = TT.make_composed_train_step(mesh, H, B * T, lr=LR, device="cpu")
    tp, loss = step(TT.shard_lm_params(lm_params_from_numpy(params, "cpu"),
                                       mesh, device="cpu"), tk, tg)
    jstep = JT.make_composed_train_step(jm, H, B * T, lr=LR)
    jtk, jtg = JT.shard_lm_batch(jnp.asarray(tokens), jnp.asarray(targets),
                                 jm)
    jp, jloss = jstep(JT.shard_lm_params(
        jax.tree_util.tree_map(jnp.asarray, params), jm), jtk, jtg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL)
    _assert_close(tree_to_numpy(tp), _np(jp), what=axes)


def test_unported_seams_raise_and_sharded_state_needs_a_mesh():
    mesh = Mesh(("data",), (1,))
    # tuned=True needs the context its cache entry is keyed by (JAX's
    # resolve_step_tuning contract)
    with pytest.raises(ValueError, match="tune_context"):
        TT.make_composed_train_step(mesh, H, CAP, device="cpu", tuned=True)
    params = lm_params_from_numpy(
        lm_params_np(1, V, D, H, E, FF, 1),
        "cpu")
    # profile= and runprof= (item 21a-ii) arm and change no output
    from deeplearning4j_tpu_torch._device import tree_leaves
    from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry
    from deeplearning4j_tpu_torch.telemetry.runprof import RunProfiler

    tokens = np.random.RandomState(3).randint(0, V, (B, T + 1))
    plain = TT.make_composed_train_step(mesh, H, CAP, device="cpu")
    want = plain(params, tokens[:, :-1], tokens[:, 1:])
    for kw in ({"profile": True},
               {"runprof": RunProfiler(registry=MetricsRegistry())}):
        step = TT.make_composed_train_step(mesh, H, CAP, device="cpu", **kw)
        got = step(params, tokens[:, :-1], tokens[:, 1:])
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(want), tree_leaves(got)))
        assert step.step_profile.label == "lm_composed[data]"
    cfg = jupd.OptimizerConfig(name="adam", update_sharding="sharded")
    with pytest.raises(ValueError, match="mesh"):
        JT.init_lm_opt_state(cfg, params)
    tcfg = ADAM["sharded"]
    from deeplearning4j_tpu_torch.optimize.updaters import OptimizerConfig

    with pytest.raises(ValueError, match="mesh"):
        TT.init_lm_opt_state(OptimizerConfig(**tcfg), params, device="cpu")
    st = TT.init_lm_opt_state(OptimizerConfig(**tcfg), params, mesh,
                              device="cpu")
    assert tuple(st["m"]["embed"].shape) == (1, V * D)
