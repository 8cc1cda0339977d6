"""Tensor parallelism in the port (parallel/sharding.apply_shardings,
parallel/tensor_parallel.make_tp_train_step, the composed LM step with a
"model" axis) and the data-parallel trainer on a ("data", "model") mesh,
held against the JAX package on 4-device meshes of the same shapes.

Four gloo ranks start ONCE for the module (tests/_torch_tp_ranks.py, torch
and the port only) and run every scenario; JAX's references run in this
process meanwhile. Tolerances: params within ``REL`` of each leaf's
largest magnitude, scores within ``REL`` relative (JAX's own 1e-5 for the
attention TP step against one device); the port's TP step against its own
single-device step with dropout and drop-connect within ``REL`` too.
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
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_lm_init import lm_params_np
from _torch_parallel_ranks import collect_ranks, spawn_ranks
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.impl import IrisDataSetIterator
from deeplearning4j_tpu.datasets.iterator import \
    ListDataSetIterator as JListIterator
from deeplearning4j_tpu.models import transformer_lm as JT
from deeplearning4j_tpu.models.zoo import char_attention_lm as jattn_lm
from deeplearning4j_tpu.nn import functional as JF
from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.ops.pallas_kernels import set_fused_dense
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu.parallel import sharding as jsharding
from deeplearning4j_tpu.parallel import trainer as jtrainer
from deeplearning4j_tpu_torch.interop import mln_params_from_numpy
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.parallel import sharding

SCRIPT = Path(__file__).resolve().parent / "_torch_tp_ranks.py"
WORLD = 4
REL = 1e-5
SPAWN_TIMEOUT_S = 240
DP_TP = (("data", "model"), (2, 2))
TP4 = (("data", "model"), (1, 4))
# the composed LM (tests/test_torch_composed.py's dims)
V, D, H, FF, B, T = 32, 16, 2, 32, 4, 16


def _iris_conf(num_iterations=1, dropout=0.0, drop_connect=False):
    b = (JBuilder.Builder()
         .n_in(4).n_out(8).activation_function("tanh")
         .lr(0.1).momentum(0.9).num_iterations(num_iterations).seed(42))
    if dropout:
        b = b.dropout(dropout)
    return (b.list(2)
            .override(1, layer_type="OUTPUT", n_in=8, n_out=3,
                      activation_function="softmax", loss_function="MCXENT")
            .use_drop_connect(drop_connect)
            .pretrain(False).backward(True).build())


def _mlp_conf(n_out):
    """An MLP-shaped conf for tp 4: a column, a row, then the head: column
    (its logits gathered for the loss) when ``n_out`` divides 4, else
    replicated. Momentum and the unit-norm constraint on."""
    return (JBuilder.Builder()
            .n_in(6).n_out(8).activation_function("tanh")
            .lr(0.1).momentum(0.9).num_iterations(1).seed(3)
            .constrain_gradient_to_unit_norm(True)
            .list(3)
            .override(1, n_in=8, n_out=12)
            .override(2, layer_type="OUTPUT", n_in=12, n_out=n_out,
                      activation_function="softmax", loss_function="MCXENT")
            .pretrain(False).backward(True).build())


def _attn_conf():
    return jattn_lm(vocab=8, d_model=16, n_heads=4, lr=0.1,
                    num_iterations=1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jmesh(spec):
    names, sizes = spec
    return jax.sharding.Mesh(
        np.array(jax.devices()[:WORLD]).reshape(sizes), names)


def _iris():
    batch = IrisDataSetIterator(150, 150).next()
    x = np.asarray(batch.features, np.float32)
    y = np.asarray(batch.labels, np.float32)
    perm = np.random.RandomState(0).permutation(150)
    return x[perm], y[perm]


def _attn_batch():
    toks = np.arange(4)[:, None] + np.arange(9)[None]
    onehot = np.eye(8, dtype=np.float32)[toks % 8]
    return onehot[:, :-1], onehot[:, 1:]


def _init(conf, seed=0):
    return _np(JF.init_params(conf, jax.random.PRNGKey(seed)))


def _inputs():
    x, y = _iris()
    iris = _iris_conf()
    local = _iris_conf(num_iterations=3)
    rng = np.random.RandomState(5)
    mx = rng.rand(3, 8, 6).astype(np.float32)
    attn_x, attn_y = _attn_batch()
    out = {
        "trainer_sync": {"kind": "trainer", "mesh": DP_TP, "sync": True,
                         "conf": iris.to_json(), "params": _init(iris),
                         "x": x[:96], "y": y[:96], "batch": 48},
        "trainer_local": {"kind": "trainer", "mesh": DP_TP, "sync": False,
                          "conf": local.to_json(), "params": _init(local),
                          "x": x[:96], "y": y[:96], "batch": 96},
        "mesh_2d": {"kind": "trainer", "mesh": DP_TP, "sync": True,
                    "conf": _iris_conf(3).to_json(),
                    "params": _init(_iris_conf(3)),
                    "x": x[:144], "y": y[:144], "batch": 144},
        "attn_dp2_tp2": {"kind": "tp_step", "mesh": DP_TP,
                         "conf": _attn_conf().to_json(),
                         "params": _init(_attn_conf()),
                         "batches": [(0, attn_x, attn_y, 1)]},
        "iris_dropout_dp2_tp2": {
            "kind": "tp_step", "mesh": DP_TP,
            "conf": _iris_conf(dropout=0.5, drop_connect=True).to_json(),
            "params": _init(iris),
            "batches": [(i, x[i * 8:(i + 1) * 8], y[i * 8:(i + 1) * 8],
                         11 + i) for i in range(3)]},
        "iris_dp2_tp2": {"kind": "tp_step", "mesh": DP_TP,
                         "conf": iris.to_json(), "params": _init(iris),
                         "batches": [(i, x[i * 8:(i + 1) * 8],
                                      y[i * 8:(i + 1) * 8], None)
                                     for i in range(3)]},
    }
    for name, n_out in (("mlp_tp4_gathered_head", 4),
                        ("mlp_tp4_replicated_head", 3)):
        conf = _mlp_conf(n_out)
        ys = np.eye(n_out, dtype=np.float32)[rng.randint(0, n_out, (3, 8))]
        out[name] = {"kind": "tp_step", "mesh": TP4, "conf": conf.to_json(),
                     "params": _init(conf, 1),
                     "batches": [(i, mx[i], ys[i], None) for i in range(3)]}
    params = lm_params_np(4, V, D, H, 2, FF, 2)
    rng = np.random.RandomState(6)
    out["composed_dp_model"] = {
        "kind": "composed", "mesh": DP_TP, "n_heads": H, "capacity": 0,
        "lr": 0.1, "params": params,
        "batches": [(rng.randint(0, V, (B, T)).astype(np.int32),
                     rng.randint(0, V, (B, T)).astype(np.int32))
                    for _ in range(3)]}
    return out


def _jax_trainer(inp):
    conf = JConf.from_json(inp["conf"])
    net = JNet(conf, params=jax.tree_util.tree_map(jnp.array,
                                                   inp["params"]))
    trainer = jtrainer.ParameterAveragingTrainer(
        net, jmesh.mesh_2d(2, 2), average_each_iteration=inp["sync"])
    trainer.fit_data_set(JListIterator(JDataSet(inp["x"], inp["y"]),
                                       inp["batch"]))
    return _np(net.params_tree)


def _jax_steps(inp, placed_mesh=None):
    """JAX's make_train_step over the batches, on one device or (with
    ``placed_mesh``) on params placed by apply_shardings and the batch
    over "data"."""
    conf = JConf.from_json(inp["conf"])
    params = jax.tree_util.tree_map(jnp.asarray, inp["params"])
    if placed_mesh is not None:
        params = jsharding.apply_shardings(
            params, jsharding.param_shardings(conf, placed_mesh),
            placed_mesh)
    states = JF.init_train_state(conf, params)
    step = JF.make_train_step(conf)
    scores = []
    for it, x, y, key in inp["batches"]:
        x, y = jnp.asarray(x), jnp.asarray(y)
        if placed_mesh is not None:
            data = NamedSharding(placed_mesh, P("data"))
            x, y = jax.device_put(x, data), jax.device_put(y, data)
        params, states, score = step(params, states, jnp.asarray(it), x, y,
                                     jax.random.PRNGKey(key or 0))
        scores.append(float(score))
    return _np(params), scores


def _jax_composed(inp):
    mesh = _jmesh(inp["mesh"])
    step = JT.make_composed_train_step(mesh, H, inp["capacity"], lr=0.1)
    params = JT.shard_lm_params(
        jax.tree_util.tree_map(jnp.asarray, inp["params"]), mesh)
    losses = []
    for tokens, targets in inp["batches"]:
        tk, tg = JT.shard_lm_batch(jnp.asarray(tokens), jnp.asarray(targets),
                                   mesh)
        params, loss = step(params, tk, tg)
        losses.append(float(loss))
    return _np(params), losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results and JAX's references, per scenario."""
    root = tmp_path_factory.mktemp("tp")
    inputs = _inputs()
    procs = spawn_ranks(root, inputs, WORLD, script=SCRIPT)
    ref = {}
    set_fused_dense(True)
    try:
        for name, inp in inputs.items():
            if inp["kind"] == "trainer":
                ref[name] = _jax_trainer(inp)
            elif inp["kind"] == "composed":
                ref[name] = _jax_composed(inp)
            elif "dropout" not in name:
                ref[name] = _jax_steps(inp)
        ref["attn_placed"] = _jax_steps(inputs["attn_dp2_tp2"],
                                        jmesh.mesh_2d(2, 2))
    finally:
        set_fused_dense(None)
        results = collect_ranks(root, procs, SPAWN_TIMEOUT_S)
    return inputs, results, ref


def _rank(runs, name, rank):
    out = runs[1][rank][name]
    assert "error" not in out, out.get("error")
    return out


def _assert_close(got, want, rel=REL, what=""):
    w_leaves = jax.tree_util.tree_leaves_with_path(want)
    g_leaves = jax.tree_util.tree_leaves(got)
    assert len(w_leaves) == len(g_leaves), what
    for (path, w), g in zip(w_leaves, g_leaves):
        w, g = np.asarray(w, np.float64), np.asarray(g, np.float64)
        where = (what, jax.tree_util.keystr(path))
        assert w.shape == g.shape, where
        err = float(np.max(np.abs(w - g))) if w.size else 0.0
        assert err <= rel * float(np.max(np.abs(w))), (where, err)


# ------------------------------------------------------ the trainer ----

@pytest.mark.parametrize("name", ["trainer_sync", "trainer_local"])
def test_trainer_on_mesh_2d_trains_every_row_like_jax(runs, name):
    """On mesh_2d(2, 2) each rank takes the rows of its "data" coordinate
    (the "model" pair the same rows), every row of the batch lands on a
    rank, and the trained params equal JAX's trainer on the same mesh."""
    inputs, _, ref = runs
    n = len(inputs[name]["x"])
    rows = [_rank(runs, name, r)["rows"] for r in range(WORLD)]
    assert sorted(set(np.concatenate(rows).tolist())) == list(range(n))
    for r in range(WORLD):
        np.testing.assert_array_equal(rows[r], rows[r ^ 1])  # model pair
        _assert_close(_rank(runs, name, r)["params"], ref[name],
                      what=(name, r))


def test_mesh_2d_tp_sharding_compiles(runs):
    """tests/test_parallel.py's test on mesh_2d(2, 2): the Megatron specs,
    apply_shardings, then the trainer's sync fit of 144 rows, here held
    against JAX's trainer on the same mesh."""
    inputs, _, ref = runs
    conf = MultiLayerConfiguration.from_json(inputs["mesh_2d"]["conf"])
    fake = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 2, "model": 2},
                                 coords={"data": 0, "model": 1})
    shardings = sharding.param_shardings(conf, fake)
    assert "W" in shardings[0]
    placed = sharding.apply_shardings(
        mln_params_from_numpy(inputs["mesh_2d"]["params"], "cpu"),
        shardings, fake)
    assert tuple(placed[0]["W"].shape) == (4, 4)
    for r in range(WORLD):
        out = _rank(runs, "mesh_2d", r)
        assert sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(
            out["params"])) == 4 * 8 + 8 + 8 * 3 + 3
        _assert_close(out["params"], ref["mesh_2d"], what=("mesh_2d", r))
        # one all-reduce a step, over "data"
        assert out["collectives"]["all_reduce"] == 1


# ------------------------------------------------- apply_shardings ----

@pytest.mark.parametrize("conf_fn,spec", [
    (_iris_conf, DP_TP), (_attn_conf, DP_TP),
    (lambda: _mlp_conf(4), TP4)])
def test_apply_shardings_chunks_equal_jax_addressable_shards(conf_fn, spec):
    jconf = conf_fn()
    tconf = MultiLayerConfiguration.from_json(jconf.to_json())
    mesh = _jmesh(spec)
    params = JF.init_params(jconf, jax.random.PRNGKey(2))
    placed = jsharding.apply_shardings(
        params, jsharding.param_shardings(jconf, mesh), mesh)
    full = mln_params_from_numpy(_np(params), "cpu")
    names, sizes = spec
    for dev_index, dev in enumerate(mesh.devices.flat):
        coords = dict(zip(names, np.unravel_index(dev_index, sizes)))
        fake = types.SimpleNamespace(axis_names=names,
                                     shape=dict(zip(names, sizes)),
                                     coords={a: int(c) for a, c in
                                             coords.items()})
        local = sharding.apply_shardings(
            full, sharding.param_shardings(tconf, fake), fake)
        for layer, jlayer in zip(local, placed):
            for k, leaf in layer.items():
                shard = [s for s in jlayer[k].addressable_shards
                         if s.device == dev][0]
                np.testing.assert_array_equal(leaf.numpy(),
                                              np.asarray(shard.data))


def test_shard_leading_axis_over_model_takes_the_rank_rows():
    stacked = {"a": torch.arange(8.0).reshape(4, 2)}
    fake = types.SimpleNamespace(axis_names=("model",), shape={"model": 2},
                                 coords={"model": 1})
    got = sharding.shard_leading_axis(stacked, fake, "model")
    np.testing.assert_array_equal(got["a"].numpy(),
                                  stacked["a"][2:].numpy())


@pytest.mark.parametrize("name", ["attn_dp2_tp2", "iris_dp2_tp2",
                                  "mlp_tp4_gathered_head",
                                  "mlp_tp4_replicated_head"])
def test_gather_shardings_round_trips_the_placed_chunks(runs, name):
    """Every rank's placed chunks are its apply_shardings chunks, and the
    gather of the trained chunks is a whole tree equal on every rank."""
    inputs, _, _ = runs
    spec = inputs[name]["mesh"]
    conf = MultiLayerConfiguration.from_json(inputs[name]["conf"])
    full = mln_params_from_numpy(inputs[name]["params"], "cpu")
    first = _rank(runs, name, 0)["params"]
    for r in range(WORLD):
        out = _rank(runs, name, r)
        fake = types.SimpleNamespace(
            axis_names=spec[0], shape=dict(zip(*spec)),
            coords=dict(zip(spec[0], np.unravel_index(r, spec[1]))))
        want = sharding.apply_shardings(
            full, sharding.param_shardings(conf, fake), fake)
        for a, b in zip(jax.tree_util.tree_leaves(out["placed"]),
                        [x.numpy() for x in
                         jax.tree_util.tree_leaves(want)]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(jax.tree_util.tree_leaves(out["params"]),
                        jax.tree_util.tree_leaves(first)):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------- the TP step ----

def test_attention_tp_sharded_step_matches_single_device(runs):
    """JAX's test at dp2×tp2 (qkv column-, wo row-parallel, heads split
    over "model"): the port's step against JAX's single-device step,
    score and params within 1e-5. Against JAX's placed step the bound is
    1e-5 plus that step's own distance from one device: GSPMD sums wq's
    near-cancelling grad in another order (8e-6 off one device here)."""
    _, _, ref = runs
    want, want_scores = ref["attn_dp2_tp2"]
    placed, placed_scores = ref["attn_placed"]
    for r in range(WORLD):
        out = _rank(runs, "attn_dp2_tp2", r)
        assert "wq" in out["specs"][1] and "wo" in out["specs"][1]
        assert abs(out["scores"][0] - want_scores[0]) < 1e-5
        assert abs(out["scores"][0] - placed_scores[0]) < 1e-5
        for la, lb, lp in zip(out["params"], want, placed):
            for k in lb:
                assert float(np.max(np.abs(la[k] - lb[k]))) < 1e-5, k
                spread = float(np.max(np.abs(lp[k] - lb[k])))
                assert float(np.max(np.abs(la[k] - lp[k]))) < \
                    1e-5 + spread, k
        # the DENSE layer takes 3-D input: no K1, as on one device
        assert out["k1"] == [0]


@pytest.mark.parametrize("name", ["mlp_tp4_gathered_head",
                                  "mlp_tp4_replicated_head", "iris_dp2_tp2"])
def test_tp_step_matches_jax_single_device(runs, name):
    """dp1×tp4 MLPs (a column, a row, a gathered or a replicated head)
    with momentum and the unit-norm constraint, and the iris conf at
    dp2×tp2: three steps against JAX's single-device step, and the
    updater state's gather against the port's single-device step's."""
    want, scores = runs[2][name]
    specs = _rank(runs, name, 0)["specs"]
    head = "W" in specs[2] if len(specs) > 2 else None
    if name == "mlp_tp4_gathered_head":
        assert specs[2]["W"] == (None, "model")
    if name == "mlp_tp4_replicated_head":
        assert specs[2] == {} and specs[1]["W"] == ("model", None)
    del head
    for r in range(WORLD):
        out = _rank(runs, name, r)
        _assert_close(out["params"], want, what=(name, r))
        np.testing.assert_allclose(out["scores"], scores, rtol=REL)
        _assert_close(out["params"], out["single"], what=(name, "single"))
        # K1 where one device's DENSE layers take it: both hidden layers
        # of the MLPs (the row layer's partial product), iris' one
        n_dense = 2 if name.startswith("mlp") else 1
        assert out["k1"] == [n_dense] * 3


def test_tp_step_with_dropout_and_drop_connect_equals_single_device(runs):
    """Masks drawn at the global shape and sliced: the dp2×tp2 step with a
    key equals the port's single-device step with the same key."""
    for r in range(WORLD):
        out = _rank(runs, "iris_dropout_dp2_tp2", r)
        np.testing.assert_allclose(out["scores"], out["single_scores"],
                                   rtol=REL)
        _assert_close(out["params"], out["single"], what=r)


def test_tp_step_collectives(runs):
    """The iris conf at dp2×tp2 (a column hidden layer, a row-parallel
    head): a step makes g's all-reduce forward and the grads' over "data"
    — two all-reduces, no gather (f's backward all-reduce has no work: its
    input is the batch, which takes no grad)."""
    for r in range(WORLD):
        got = _rank(runs, "iris_dp2_tp2", r)["collectives"]
        assert [(c["all_reduce"], c["all_gather"]) for c in got] == \
            [(2, 0)] * 3


# ------------------------------------------------- the composed LM ----

def test_composed_step_on_data_model_matches_jax(runs):
    """The LM's composed step on ("data", "model") 2×2, replicated over
    "model" as JAX's lm_param_shardings places it: losses and params
    against JAX's on the same mesh."""
    params, losses = runs[2]["composed_dp_model"]
    for r in range(WORLD):
        out = _rank(runs, "composed_dp_model", r)
        _assert_close(out["params"], params, what=("composed", r))
        np.testing.assert_allclose(out["losses"], losses, rtol=REL)
        # the sums run over "data" alone
        assert all(c["all_reduce"] == 2 for c in out["collectives"])
