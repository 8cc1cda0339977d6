"""The port's composed LM step (``make_composed_train_step`` on meshes over
("data", "sp", "expert"), deeplearning4j_tpu_torch/models/transformer_lm.py)
and its staged twin (``make_pp_stages``/``make_pp_loss`` over ("data",
"pipe")) held against the JAX package's on 4-device meshes of the same
shapes.

Four gloo ranks start ONCE for the module (tests/_torch_composed_ranks.py,
torch and the port only) and run every scenario from the JAX package's
params and batches; the JAX references run in this process meanwhile.
Each scenario runs 3 steps. Tolerances: params to ``REL`` of each leaf's
largest magnitude (each rank's expert group against its slice of JAX's
leaf), losses to ``LOSS_TOL`` relative, the metrics blocks to
``METRIC_TOL``. The optimizer runs are float64 on both sides (JAX under
x64), as in test_torch_lm_dp.py: Adam's and LAMB's normalized first steps
amplify the summation-order noise of near-zero grads.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

from _torch_lm_init import lm_params_np
from _torch_parallel_ranks import collect_ranks, spawn_ranks
from deeplearning4j_tpu.models import transformer_lm as JT
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu.parallel import pipeline as jpipe
from deeplearning4j_tpu_torch.interop import lm_params_from_numpy
from deeplearning4j_tpu_torch.models import transformer_lm as TT
from deeplearning4j_tpu_torch.parallel import moe as tmoe
from deeplearning4j_tpu_torch.parallel.mesh import Mesh

SCRIPT = Path(__file__).resolve().parent / "_torch_composed_ranks.py"
WORLD = 4
V, D, H, FF, B, T = 32, 16, 2, 32, 4, 16
LR = 0.1
STEPS = 3
REL = 1e-5          # f32 params, of each leaf's largest magnitude
LOSS_TOL = 1e-5     # relative
METRIC_TOL = 1e-5   # relative, with an absolute floor of 1e-7
SPAWN_TIMEOUT_S = 240

DP_EP = (("data", "expert"), (2, 2))
DP_SP_EP = (("data", "sp", "expert"), (1, 2, 2))
DP2_SP2 = (("data", "sp", "expert"), (2, 2, 1))
EP4 = (("expert",), (4,))
DP_PP = (("data", "pipe"), (2, 2))

# name: (mesh, n_experts, n_layers, capacity, step kwargs)
COMPOSED = {
    "dp_ep": (DP_EP, 4, 2, (B // 2) * T, {}),
    "dp_ep_blockwise_replicated": (DP_EP, 8, 1, (B // 2) * T,
                                   {"attn_impl": "blockwise",
                                    "moe_impl": "replicated"}),
    "dp_sp_ep_blockwise": (DP_SP_EP, 4, 2, B * (T // 2),
                           {"attn_impl": "blockwise",
                            "moe_impl": "alltoall"}),
    "dp_sp_ep_dense_replicated": (DP_SP_EP, 4, 1, B * (T // 2),
                                  {"attn_impl": "dense",
                                   "moe_impl": "replicated"}),
    "dp2_sp2_blockwise": (DP2_SP2, 2, 1, (B // 2) * (T // 2),
                          {"attn_impl": "blockwise"}),
    "ep4_alltoall_2d": (EP4, 4, 1, B * T,
                        {"attn_impl": "blockwise",
                         "moe_impl": "alltoall_2d"}),
    # a capacity that drops routes: the same routes drop as in JAX
    "dp_ep_drops_metrics": (DP_EP, 4, 1, 4, {"with_metrics": True}),
    "dp_sp_ep_drops_guard": (DP_SP_EP, 4, 1, 4,
                             {"with_metrics": True, "guard": True,
                              "attn_impl": "blockwise"}),
    "adam_sharded": (DP_EP, 4, 1, (B // 2) * T,
                     {"optimizer": {"name": "adam", "lr": 1e-3,
                                    "update_sharding": "sharded"}}),
    "lamb_metrics": (DP_SP_EP, 4, 1, B * (T // 2),
                     {"optimizer": {"name": "lamb", "lr": 1e-3},
                      "with_metrics": True, "attn_impl": "blockwise"}),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jmesh(spec):
    names, sizes = spec
    return JMesh(np.array(jax.devices()[:WORLD]).reshape(sizes), names)


def _batches(seed):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, V, (B, T)).astype(np.int32),
             rng.randint(0, V, (B, T)).astype(np.int32))
            for _ in range(STEPS)]


def _composed_inputs():
    out = {}
    for i, (name, (mesh, e, layers, cap, kw)) in enumerate(
            sorted(COMPOSED.items())):
        params = lm_params_np(i, V, D, H, e, FF, layers)
        if "optimizer" in kw:
            params = jax.tree_util.tree_map(
                lambda a: a.astype(np.float64), params)
        out[name] = dict(kw, kind="composed", mesh=mesh, n_heads=H,
                         capacity=cap, lr=LR, params=params,
                         batches=_batches(i), x64="optimizer" in kw)
    return out


def _pp_inputs():
    # JAX's own draws here: with other draws a top-2 route can sit on a
    # near-tie the two packages break apart over three staged steps
    params = _np(JT.init_lm_params(jax.random.PRNGKey(7), V, D, H, 4, FF, 4))
    toks = np.random.RandomState(8).randint(0, V, (4, 2, T + 1))
    return {"pp_lm": {"kind": "pp_lm", "mesh": DP_PP, "n_heads": H,
                      "params": params, "toks": toks[..., :-1],
                      "tgts": toks[..., 1:], "lr": LR, "steps": STEPS,
                      "batch_axis": "data", "attn_impl": "blockwise"}}


def _jax_composed(inp):
    """JAX's composed step on the 4-device mesh over ``inp``'s batches."""
    if inp.get("x64"):
        with jax.enable_x64(True):
            return _jax_composed(dict(inp, x64=False))
    mesh = _jmesh(inp["mesh"])
    opt = inp.get("optimizer")
    opt = None if opt is None else jupd.OptimizerConfig(**opt)
    step = JT.make_composed_train_step(
        mesh, H, inp["capacity"], lr=LR, attn_impl=inp.get("attn_impl"),
        moe_impl=inp.get("moe_impl"),
        with_metrics=inp.get("with_metrics", False), guard=inp.get("guard"),
        optimizer=opt)
    params = JT.shard_lm_params(
        jax.tree_util.tree_map(jnp.asarray, inp["params"]), mesh)
    state = None if opt is None else JT.init_lm_opt_state(opt, params, mesh)
    losses, blocks = [], []
    for tokens, targets in inp["batches"]:
        tk, tg = JT.shard_lm_batch(jnp.asarray(tokens), jnp.asarray(targets),
                                   mesh)
        out = (step(params, tk, tg) if opt is None
               else step(params, state, tk, tg))
        jax.block_until_ready(out)
        params = out[0]
        if opt is not None:
            state = out[1]
        losses.append(float(out[1 if opt is None else 2]))
        if len(out) == (3 if opt is None else 4):
            blocks.append(_np(out[-1]))
    return _np(params), losses, blocks


def _jax_pp(inp):
    """JAX's dp×pp staged LM: value_and_grad of make_pp_loss and SGD."""
    mesh = _jmesh(inp["mesh"])
    params = jax.tree_util.tree_map(jnp.asarray, inp["params"])
    per_stage, stage_fn = JT.make_pp_stages(params, H, n_stages=2,
                                            attn_impl=inp["attn_impl"])
    stacked = jpipe.shard_stage_params(jpipe.stack_stage_params(per_stage),
                                       mesh, "pipe")
    loss = JT.make_pp_loss(stage_fn, mesh, "pipe", batch_axis="data")
    vg = jax.jit(jax.value_and_grad(loss))
    trained = (stacked, params["embed"], params["dec_w"], params["dec_b"])
    losses = []
    for _ in range(STEPS):
        lv, g = vg(trained, jnp.asarray(inp["toks"]), jnp.asarray(
            inp["tgts"]))
        trained = jax.tree_util.tree_map(lambda p, gg: p - LR * gg, trained,
                                         g)
        losses.append(float(lv))
    return losses, _np(JT.pp_trained_to_lm_params(trained))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results and JAX's, per scenario."""
    root = tmp_path_factory.mktemp("composed")
    inputs = {**_composed_inputs(), **_pp_inputs()}
    procs = spawn_ranks(root, inputs, WORLD, script=SCRIPT)
    try:
        ref = {name: _jax_composed(inp) for name, inp in inputs.items()
               if inp["kind"] == "composed"}
        ref["pp_lm"] = _jax_pp(inputs["pp_lm"])
    finally:
        results = collect_ranks(root, procs, SPAWN_TIMEOUT_S)
    return inputs, results, ref


def _rank(runs, name, rank):
    out = runs[1][rank][name]
    assert "error" not in out, out.get("error")
    return out


def _coords(spec, rank):
    names, sizes = spec
    coords, rem = {}, rank
    for a, s in reversed(list(zip(names, sizes))):
        coords[a] = rem % s
        rem //= s
    return coords


def _local(params, spec, rank):
    """JAX's global params as the rank holds them: its expert group."""
    names, sizes = spec
    if "expert" not in names:
        return params
    ep = dict(zip(names, sizes))["expert"]
    e = _coords(spec, rank)["expert"]

    def one(path, a):
        if "experts" in jax.tree_util.keystr(path):
            g = a.shape[1] // ep
            return a[:, e * g:(e + 1) * g]
        return a

    return jax.tree_util.tree_map_with_path(one, params)


def _assert_close(got, want, rel=REL, what=""):
    w_leaves = jax.tree_util.tree_leaves_with_path(want)
    g_leaves = jax.tree_util.tree_leaves(got)
    assert len(w_leaves) == len(g_leaves), what
    for (path, w), g in zip(w_leaves, g_leaves):
        w, g = np.asarray(w, np.float64), np.asarray(g, np.float64)
        where = (what, jax.tree_util.keystr(path))
        assert w.shape == g.shape, where
        err = float(np.max(np.abs(w - g)))
        assert err <= rel * float(np.max(np.abs(w))), (where, err)


@pytest.mark.parametrize("name", sorted(COMPOSED))
def test_composed_step_matches_jax_on_every_rank(runs, name):
    inputs, _, ref = runs
    params, losses, _ = ref[name]
    spec = inputs[name]["mesh"]
    for rank in range(WORLD):
        out = _rank(runs, name, rank)
        _assert_close(out["params"], _local(params, spec, rank),
                      what=(name, rank))
        np.testing.assert_allclose(out["losses"], losses, rtol=LOSS_TOL)


@pytest.mark.parametrize("name", ["dp_ep_drops_metrics",
                                  "dp_sp_ep_drops_guard", "lamb_metrics"])
def test_metrics_blocks_are_jax_global_ones(runs, name):
    _, _, blocks = runs[2][name]
    for rank in range(WORLD):
        got = _rank(runs, name, rank)["blocks"]
        assert len(got) == len(blocks) == STEPS
        for g, w in zip(got, blocks):
            assert set(g) == set(w), (set(g) ^ set(w))
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=METRIC_TOL,
                                           atol=1e-7, err_msg=k)


def test_capacity_drops_routes_and_counts_them_as_the_host_does(runs):
    """At capacity 4 the dispatch drops routes; the first step's
    moe_dropped_frac equals expected_dropped / routes counted on the host
    from the dense forward's pre-MoE activations, over the sub-shards of
    the resolved dispatch (the steps themselves agree with JAX's, above)."""
    inputs = runs[0]
    for name in ("dp_ep_drops_metrics", "dp_sp_ep_drops_guard"):
        inp = inputs[name]
        params = lm_params_from_numpy(inp["params"], "cpu")
        _, moe_ins = TT.lm_forward(
            params, torch.from_numpy(inp["batches"][0][0]), H,
            lambda q, k, v: TT.attention_core(q, k, v, causal=True,
                                              impl="dense"),
            lambda rw, ex, x: TT.dense_moe(rw, ex, x, 2))
        names, sizes = inp["mesh"]
        fake = types.SimpleNamespace(axis_names=names,
                                     shape=dict(zip(names, sizes)))
        shards = tmoe.route_shards(
            fake, tuple(a for a in ("data", "sp") if a in names), "expert",
            B * T)
        want = tmoe.expected_dropped(params["blocks"]["router"][0],
                                     moe_ins[0], inp["capacity"], 2,
                                     n_shards=shards) / (B * T * 2)
        assert want > 0, name
        got = float(_rank(runs, name, 0)["blocks"][0]["moe_dropped_frac"])
        assert abs(got - want) < 1e-6, (name, got, want)


def test_collectives_per_step(runs):
    """What each step issues: the dp×ep SGD step makes the forward's
    statistics all-reduce and the grads' all-reduce, and per layer the
    dispatch's two all-to-alls forward and two backward, its gather and
    the split's backward gather, and the router grads' all-reduce."""
    out = _rank(runs, "dp_ep", 0)
    n_layers = 2
    want = {"all_reduce": 2 + n_layers, "all_gather": 2 * n_layers,
            "all_to_all": 4 * n_layers, "send_recv": 0, "broadcast": 0}
    assert out["collectives"] == [want] * STEPS
    # the ring (sp 2, one layer, blockwise): one exchange forward and two
    # backward (the last carries dK/dV home), and the MoE's relayout
    ring = _rank(runs, "dp_sp_ep_blockwise", 0)["collectives"][0]
    assert ring["send_recv"] == 3 * 2
    assert ring["all_to_all"] == (4 + 4) * 2


def test_param_specs_put_experts_on_the_expert_axis(runs):
    out = _rank(runs, "dp_ep", 1)
    specs = out["specs"]
    assert specs["blocks"]["experts"]["w1"] == (None, "expert")
    assert specs["blocks"]["wq"] == () and specs["embed"] == ()
    params = lm_params_np(0, V, D, H, 4, FF, 1)
    want = jax.tree_util.tree_map(
        lambda s: tuple(s.spec), JT.lm_param_shardings(params,
                                                       _jmesh(DP_EP)))
    got = TT.lm_param_shardings(lm_params_from_numpy(params, "cpu"),
                                types.SimpleNamespace(
                                    axis_names=DP_EP[0],
                                    shape=dict(zip(*DP_EP))))
    flat = jax.tree_util.tree_leaves_with_path(
        want, is_leaf=lambda x: isinstance(x, tuple))
    gflat = jax.tree_util.tree_leaves_with_path(
        got, is_leaf=lambda x: isinstance(x, tuple))
    assert [(jax.tree_util.keystr(p), s) for p, s in gflat] == \
        [(jax.tree_util.keystr(p), s) for p, s in flat]


@pytest.mark.parametrize("overlap", [False, True])
def test_pp_lm_matches_jax_and_overlap_is_bit_identical(runs, overlap):
    """dp2×pp2, 4 layers (two a stage), blockwise core: the staged LM's
    SGD steps through make_pp_loss against JAX's on the same mesh, on
    every rank (its stage's layers); the overlap schedule bit-identical to
    the strict one."""
    losses, params = runs[2]["pp_lm"]
    for rank in range(WORLD):
        out = _rank(runs, "pp_lm", rank)
        got = out[overlap]
        np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_TOL)
        stage = _coords(DP_PP, rank)["pipe"]
        want = dict(params)
        want["blocks"] = jax.tree_util.tree_map(
            lambda a: a[2 * stage:2 * stage + 2], params["blocks"])
        _assert_close(got["params"], want, what=("pp", rank, overlap))
        if overlap:
            strict = out[False]
            assert got["losses"] == strict["losses"]
            for a, b in zip(jax.tree_util.tree_leaves(got["params"]),
                            jax.tree_util.tree_leaves(strict["params"])):
                np.testing.assert_array_equal(a, b)


def test_selected_moe_impl_and_mesh_rules_match_jax():
    for spec in (DP_EP, DP_SP_EP, EP4):
        jm = _jmesh(spec)
        fake = types.SimpleNamespace(axis_names=spec[0],
                                     shape=dict(zip(*spec)))
        for impl in (None, "replicated", "alltoall_2d"):
            for n in (B * T, B * T - 4):
                assert TT.selected_moe_impl(fake, n, impl) == \
                    JT.selected_moe_impl(jm, n, impl)
    fake = types.SimpleNamespace(axis_names=("data",), shape={"data": 4})
    assert TT.selected_moe_impl(fake, 64) is None
    # a "model" axis replicates the LM over its ranks, as JAX's
    # lm_param_shardings does; "pipe" runs through make_pp_loss
    TT.make_composed_train_step(Mesh(("data", "model"), (1, 1)), H,
                                device="cpu")
    with pytest.raises(NotImplementedError, match="make_pp_stages"):
        TT.make_composed_train_step(Mesh(("data", "pipe"), (1, 1)), H,
                                    device="cpu")
    params = lm_params_from_numpy(
        lm_params_np(1, V, D, H, 3, FF, 1),
        "cpu")
    with pytest.raises(ValueError, match="do not shard"):
        TT.lm_param_shardings(params, types.SimpleNamespace(
            axis_names=("expert",), shape={"expert": 2}))
