"""The port's data-parallel trainer (deeplearning4j_tpu_torch/parallel/)
held against the JAX package's, on the CPU.

Single-process checks mirror tests/test_parallel.py's TestMultihost, the
ZeRO layout of optimize/updaters.py and parallel/sharding.py's specs. The
multi-process checks start four gloo ranks ONCE for the module
(tests/_torch_parallel_ranks.py, which imports torch and the port only),
feed them the JAX package's params and batches, and compare what they
return with the JAX trainer on a 4-device mesh of the tests' CPU devices
(``data_parallel_mesh(4)``): sync steps, a local-fit round, an uneven
batch, an RMSE_XENT head, a guarded non-finite step, Adam replicated and
ZeRO-sharded, LAMB's metrics block, dropout with JAX's masks put in, and
a checkpoint written by rank 0 and resumed on every rank. Every sync step
must make exactly one all-reduce.

Tolerances: f32 training parity to ``REL`` of each leaf's largest
magnitude (the ranks sum their gradients in gloo's order, JAX in XLA's);
the port's replicated and sharded Adam to ``ZERO_ATOL`` (the same math).
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

from _torch_parallel_ranks import collect_ranks, spawn_ranks
from deeplearning4j_tpu.datasets.impl import IrisDataSetIterator
from deeplearning4j_tpu.nn import functional as JF
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.ops.pallas_kernels import set_fused_dense
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu.parallel import sharding as jsharding
from deeplearning4j_tpu.parallel import trainer as jtrainer
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.optimize import updaters as tupd
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel import multihost, sharding

WORLD = 4
REL = 1e-5        # f32 training parity, relative to each leaf's max
ZERO_ATOL = 1e-6  # sharded against replicated Adam: the same math
SPAWN_TIMEOUT_S = 240


def _iris_conf(builder, num_iterations=1, loss="MCXENT", dropout=0.0):
    b = (builder.Builder()
         .n_in(4).n_out(8).activation_function("tanh")
         .lr(0.1).momentum(0.9).num_iterations(num_iterations).seed(42))
    if dropout:
        b = b.dropout(dropout)
    return (b.list(2)
            .override(1, layer_type="OUTPUT", n_in=8, n_out=3,
                      activation_function="softmax", loss_function=loss)
            .pretrain(False).backward(True).build())


def _adam_conf(builder):
    """tests/test_updaters.py TestSyncTrainerOptimizer's conf."""
    return (builder.Builder()
            .n_in(4).n_out(8).activation_function("tanh").lr(0.01)
            .num_iterations(1).seed(0).list(2)
            .override(1, layer_type="OUTPUT", n_in=8, n_out=3,
                      activation_function="softmax", loss_function="MCXENT")
            .pretrain(False).backward(True).build())


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _iris():
    batch = IrisDataSetIterator(150, 150).next()
    return (np.asarray(batch.features, np.float32),
            np.asarray(batch.labels, np.float32))


def _init(conf, seed=0):
    params = JF.init_params(conf, jax.random.PRNGKey(seed))
    return params, JF.init_train_state(conf, params)


def _assert_close(got, want, rel=REL, what=""):
    """Every leaf of ``got`` within ``rel`` of ``want``'s largest
    magnitude (exact where that is 0)."""
    g_leaves = jax.tree_util.tree_leaves_with_path(want)
    t_leaves = jax.tree_util.tree_leaves(got)
    assert len(g_leaves) == len(t_leaves), what
    for (path, w), t in zip(g_leaves, t_leaves):
        w, t = np.asarray(w, np.float64), np.asarray(t, np.float64)
        assert w.shape == t.shape, (what, jax.tree_util.keystr(path))
        err = float(np.max(np.abs(w - t))) if w.size else 0.0
        assert err <= rel * float(np.max(np.abs(w), initial=0.0)), (
            what, jax.tree_util.keystr(path), err)


def _bits_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y), equal_nan=True)
        for x, y in zip(la, lb))


@pytest.fixture(autouse=True)
def _jax_fused_dense():
    # the tests' 8 fake devices turn JAX's fused dense off; the port
    # differentiates through the activation's output, as the fused path
    set_fused_dense(True)
    try:
        yield
    finally:
        set_fused_dense(None)


# ------------------------------------------------------------ inputs ----

def _batches(x, y, n_steps, rows, key_base=0):
    """(iteration, x, y, w, key) for each step: JAX keys as the step's
    key on the JAX side, the port's int key beside it."""
    out = []
    for i in range(n_steps):
        xs = x[i * rows:(i + 1) * rows]
        ys = y[i * rows:(i + 1) * rows]
        out.append((i, xs, ys, np.ones((len(xs),), np.float32),
                    key_base + i))
    return out


def _dropout_masks(jkey, conf, local_rows):
    """The masks JAX's sync step draws on every shard: the step key's
    first split, one key per layer, each layer's first split."""
    kdrop = jax.random.split(jkey)[0]
    keys = jax.random.split(kdrop, conf.n_layers)
    masks = []
    for i in range(conf.n_layers):
        kd = jax.random.split(keys[i])[0]
        shape = (local_rows, conf.conf(i).n_in)
        masks.append(np.asarray(jax.random.bernoulli(
            kd, 1.0 - conf.conf(i).dropout, shape)))
    return masks


def _inputs(tmp_root):
    x, y = _iris()
    rng = np.random.RandomState(0)
    perm = rng.permutation(150)
    xs, ys = x[perm], y[perm]
    conf = _iris_conf(JBuilder)
    params, states = _init(conf)
    common = {"conf": conf.to_json(), "params": _np(params),
              "states": _np(states)}
    nan_x = xs[:48].copy()
    nan_x[5, 1] = np.nan
    guard_batches = _batches(xs, ys, 3, 48)
    guard_batches[1] = (1, nan_x, ys[:48], np.ones(48, np.float32), 1)
    rmse = _iris_conf(JBuilder, loss="RMSE_XENT")
    drop = _iris_conf(JBuilder, dropout=0.5)
    adam = _adam_conf(JBuilder)
    ap, _ = _init(adam)
    ax = rng.rand(16, 4).astype(np.float32)
    ay = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 16)]
    adam_batches = [(i, ax, ay, np.ones(16, np.float32), 7)
                    for i in range(3)]
    return {
        "mesh": dict(common),
        "sync": dict(common, batches=_batches(xs, ys, 3, 48)),
        "local": dict(common, local_iterations=3,
                      batches=_batches(xs, ys, 1, 48)),
        "uneven": dict(common, x=x, y=y),
        "rmse": dict(common, kind="sync", conf=rmse.to_json(),
                     batches=_batches(xs, ys, 2, 48)),
        "guard": dict(common, batches=guard_batches),
        "adam": {"conf": adam.to_json(), "params": _np(ap),
                 "batches": adam_batches},
        "metrics": {"conf": adam.to_json(), "params": _np(ap),
                    "batches": adam_batches[:1]},
        "dropout": dict(common, conf=drop.to_json(),
                        masks=_dropout_masks(jax.random.PRNGKey(11), drop,
                                             48 // WORLD),
                        batches=_batches(xs, ys, 1, 48)),
        "ckpt": dict(common, x=xs[:64], y=ys[:64], batch=16,
                     root=str(tmp_root / "ckpt")),
    }


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the four ranks once; returns (inputs, [rank results])."""
    root = tmp_path_factory.mktemp("ranks")
    inputs = _inputs(root)
    procs = spawn_ranks(root, inputs, WORLD)
    return inputs, collect_ranks(root, procs, SPAWN_TIMEOUT_S)


def _result(ranks, name, rank=0):
    out = ranks[1][rank][name]
    assert "error" not in out, out.get("error")
    return out


def _jax_steps(step, params, states, batches, with_aux=False):
    scores, aux = [], []
    for it, x, y, w, key in batches:
        out = step(params, states, jnp.asarray(it), x, y, w,
                   jax.random.PRNGKey(key))
        params, states, score = out[0], out[1], out[2]
        scores.append(float(score))
        if with_aux:
            aux.append(jax.device_get(out[3]))
    return _np(params), _np(states), scores, aux


def _conf_of(inp):
    from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration

    return MultiLayerConfiguration.from_json(inp["conf"])


def _jax_copy(tree):
    return jax.tree_util.tree_map(jnp.array, tree)


# ------------------------------------------------- single process ----

class TestMultihost:
    """tests/test_parallel.py's TestMultihost through the port, in this
    process (no group: a one-rank mesh)."""

    def test_initialize_single_process_noop(self):
        multihost.initialize()  # no coordinator configured → no-op
        idx, count = multihost.process_info()
        assert idx == 0 and count == 1
        assert multihost.is_coordinator()

    def test_global_mesh_default(self):
        mesh = multihost.global_mesh(("data",))
        assert mesh.shape["data"] == multihost.process_info()[1] == 1

    def test_global_mesh_multi_axis(self):
        mesh = multihost.global_mesh(("data", "model"), (1, 1))
        assert dict(mesh.shape) == {"data": 1, "model": 1}

    def test_global_mesh_validation(self):
        with pytest.raises(ValueError):
            multihost.global_mesh(("a", "b"))
        with pytest.raises(ValueError):
            multihost.global_mesh(("a", "b"), (3, 2))

    def test_explicit_coordinator_requires_rank(self):
        multihost._initialized = False
        try:
            with pytest.raises(ValueError):
                multihost.initialize(coordinator="h:1234")
        finally:
            multihost._initialized = True


def test_mesh_is_the_group_and_never_filled_in():
    mesh = tmesh.data_parallel_mesh()
    assert mesh.size == 1 and mesh.rank == 0 and mesh.device is None
    assert mesh.axis_names == (jmesh.DATA_AXIS,) == (tmesh.DATA_AXIS,)
    assert tmesh.MODEL_AXIS == jmesh.MODEL_AXIS
    with pytest.raises(ValueError, match="world size 1"):
        tmesh.data_parallel_mesh(2)
    with pytest.raises(ValueError, match="world size"):
        tmesh.mesh_2d(2, 2)
    t = torch.arange(3.0)
    tmesh.reset_collectives()
    assert mesh.all_reduce(t) is t and mesh.all_gather(t) is t
    assert tmesh.COLLECTIVES == {"all_reduce": 0, "all_gather": 0,
                                 "all_to_all": 0, "send_recv": 0,
                                 "broadcast": 0}
    assert tmesh.local_device_count() >= 1


@pytest.mark.parametrize("shape", [(4, 8), (8,), (3, 5, 7), (), (6, 10)])
@pytest.mark.parametrize("n", [1, 3, 4, 8])
def test_zero_layout_and_partition_equal_jax(shape, n):
    jax_mesh = jmesh.data_parallel_mesh(n)
    fake = types.SimpleNamespace(axis_names=("data",), shape={"data": n},
                                 coords={"data": 0})
    jz = jupd.ZeroSharding(jax_mesh, "data")
    tz = tupd.ZeroSharding(fake, "data")
    chunk, pad = tz.layout(shape)
    assert (0, (), chunk, pad) == jz.layout("['w']", shape)
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    jpart = np.asarray(jupd._partition(jnp.asarray(x), 0, n, chunk, pad))
    np.testing.assert_array_equal(tupd._partition(x, n, chunk, pad), jpart)
    tpart = tupd._partition(torch.from_numpy(x), n, chunk, pad)
    np.testing.assert_array_equal(tpart.numpy(), jpart)
    np.testing.assert_array_equal(tupd._unpartition(tpart, shape).numpy(), x)


def test_zero_sharding_needs_the_axis():
    with pytest.raises(ValueError, match="dp axis"):
        tupd.ZeroSharding(tmesh.data_parallel_mesh(), "model")


def test_partition_canonical_round_trip_one_rank():
    """TestOptStateCheckpoint.test_partition_canonical_round_trip on the
    port's one-rank mesh: canonical moments are param-shaped and the
    partition of them gives the rows back bitwise."""
    conf = _iris_conf(NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn import functional as TF

    params = TF.init_params(conf, 0, device="cpu")
    cfg = tupd.OptimizerConfig(name="adam", update_sharding="sharded")
    zero = tupd.ZeroSharding(tmesh.data_parallel_mesh())
    st = tupd.init_opt_state(cfg, params, zero)
    from deeplearning4j_tpu_torch._device import tree_map

    st = {"m": tree_map(lambda _, a: a + torch.arange(a.numel()).reshape(
              a.shape).float(), st["m"]),
          "v": tree_map(lambda _, a: a + 0.5, st["v"]), "count": st["count"]}
    can = tupd.canonical_opt_state(st, params, zero)
    back = tupd.partition_opt_state(can, zero, device="cpu")
    assert _bits_equal(_np_t(st["m"]), _np_t(back["m"]))
    assert _bits_equal(_np_t(st["v"]), _np_t(back["v"]))
    for p, c in zip(jax.tree_util.tree_leaves(_np_t(params)),
                    jax.tree_util.tree_leaves(can["m"])):
        assert p.shape == c.shape
    assert tupd.opt_state_shardings("s") == {"m": "s", "v": "s",
                                             "count": None}
    assert tupd.leaf_of(params, (1, "W")) is params[1]["W"]


def _np_t(tree):
    from deeplearning4j_tpu_torch.interop import tree_to_numpy

    return tree_to_numpy(tree)


@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 4), (8, 1)])
def test_param_shardings_equal_jax(dp, tp):
    jconf = _iris_conf(JBuilder)
    tconf = _iris_conf(NeuralNetConfiguration)
    fake = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": dp, "model": tp})
    want = jsharding.param_shardings(jconf, jmesh.mesh_2d(dp, tp))
    got = sharding.param_shardings(tconf, fake)
    assert [{k: tuple(v.spec) for k, v in layer.items()} for layer in want] \
        == list(got)
    assert sharding.replicated(fake) == tuple(jsharding.replicated(
        jmesh.mesh_2d(dp, tp)).spec)
    stacked = sharding.stack_along_leading_axis(
        [{"a": torch.ones(2)}, {"a": torch.zeros(2)}])
    assert stacked["a"].shape == (2, 2)
    # placing over "model" (tensor parallelism) takes the rank's chunk
    fake.coords = {"data": 0, "model": tp - 1}
    if tp <= 2:
        assert torch.equal(
            sharding.shard_leading_axis(stacked, fake, "model")["a"],
            stacked["a"][tp - 1:])
    assert sharding.apply_shardings((), got, fake) == ()


def test_profile_seams_raise_naming_slice_9():
    """The seams slice 9 named (item 21a-ii) now arm: on a one-rank mesh
    the profiled and phase-timed step's outputs equal the plain step's,
    under JAX's label; four ranks run in tests/test_torch_xprofile.py."""
    from deeplearning4j_tpu_torch._device import tree_leaves
    from deeplearning4j_tpu_torch.nn import functional as TF
    from deeplearning4j_tpu_torch.parallel.trainer import \
        make_sync_train_step
    from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry
    from deeplearning4j_tpu_torch.telemetry.runprof import RunProfiler

    conf = _iris_conf(NeuralNetConfiguration)
    mesh = tmesh.data_parallel_mesh()
    params = TF.init_params(conf, 0, device="cpu")
    states = TF.init_train_state(conf, params)
    x, y = _iris()
    args = (0, x[:16], y[:16], np.ones(16, np.float32), 1)
    want = make_sync_train_step(conf, mesh)(params, states, *args)
    for kw in ({"profile": True},
               {"runprof": RunProfiler(registry=MetricsRegistry())}):
        step = make_sync_train_step(conf, mesh, **kw)
        got = step(params, states, *args)
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(want), tree_leaves(got)))
        assert step.step_profile.label == "dp_sync[1]"
        assert step.step_profile.flops > 0


@pytest.mark.parametrize("sync", [True, False])
def test_one_rank_trainer_matches_jax(sync):
    """The trainer with no process group (a one-rank mesh) against JAX's
    trainer on ``data_parallel_mesh(1)``, both modes, 5 iterations."""
    from deeplearning4j_tpu_torch.datasets.impl import IrisDataSetIterator \
        as TIris
    from deeplearning4j_tpu_torch.interop import mln_params_from_numpy
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import ParameterAveragingTrainer

    jnet = JNet(_iris_conf(JBuilder, num_iterations=5)).init()
    tnet = MultiLayerNetwork(
        _iris_conf(NeuralNetConfiguration, num_iterations=5),
        params=mln_params_from_numpy(_np(jnet.params_tree), device="cpu"),
        device="cpu")
    jtrainer.ParameterAveragingTrainer(
        jnet, jmesh.data_parallel_mesh(1),
        average_each_iteration=sync).fit_data_set(
        IrisDataSetIterator(150, 150))
    ParameterAveragingTrainer(tnet, average_each_iteration=sync)\
        .fit_data_set(TIris(150, 150))
    _assert_close(_np_t(tnet.params_tree), _np(jnet.params_tree))


def test_one_rank_sync_step_keeps_float64():
    """The fused all-reduce buffer takes the widest dtype among its
    tensors, so an f64 network's grads, params and state keep their
    precision (a one-rank mesh passes the buffer through, bitwise), and
    an f64 sync step keeps every leaf f64 and equals the single-device
    step (whose loss the heads score in f32)."""
    from deeplearning4j_tpu_torch._device import tree_map
    from deeplearning4j_tpu_torch.nn import functional as TF
    from deeplearning4j_tpu_torch.parallel.trainer import (
        _flat_all_reduce,
        make_sync_train_step,
    )

    mesh = tmesh.data_parallel_mesh()
    ins = [torch.tensor([1.0 + 1e-12, -3e-300], dtype=torch.float64),
           torch.tensor([[0.1, 0.2]], dtype=torch.float32),
           torch.tensor(7, dtype=torch.int32)]
    outs = _flat_all_reduce(mesh, ins)
    for i, o in zip(ins, outs):
        assert o.dtype == i.dtype and o.shape == i.shape
        assert torch.equal(o, i)

    conf = _iris_conf(NeuralNetConfiguration)
    params = tree_map(lambda _, a: a.double(),
                      TF.init_params(conf, 0, device="cpu"))
    states = tree_map(lambda _, a: a.double() if a.is_floating_point()
                      else a, TF.init_train_state(conf, params))
    x, y = _iris()
    x, y = x[:48].astype(np.float64), y[:48].astype(np.float64)
    want = TF.make_train_step(conf)(params, states, 0, x, y, None)
    got = make_sync_train_step(conf, mesh)(
        params, states, 0, x, y, np.ones(48, np.float64), None)
    for w, g in zip(jax.tree_util.tree_leaves(_np_t(want[:2])),
                    jax.tree_util.tree_leaves(_np_t(got[:2]))):
        assert g.dtype == w.dtype
        if w.dtype.kind == "f":
            assert w.dtype == np.float64
    _assert_close(_np_t(got[:2]), _np_t(want[:2]), what="f64 step")


# ------------------------------------------------- four gloo ranks ----

def test_ranks_form_one_mesh(ranks):
    inputs, results = ranks
    jconf = _conf_of(inputs["mesh"])
    want = [{k: tuple(v.spec) for k, v in layer.items()}
            for layer in jsharding.param_shardings(jconf,
                                                   jmesh.mesh_2d(2, 2))]
    for r in range(WORLD):
        out = _result(ranks, "mesh", r)
        assert out["world"] == WORLD and out["rank"] == r
        assert out["coords"] == {"data": r}
        assert tuple(out["process_info"]) == (r, WORLD)
        assert out["is_coordinator"] == (r == 0)
        assert out["global_2x2"] == {"data": r // 2, "model": r % 2}
        assert "world size 4" in out["oversized"]
        assert list(out["specs_2x2"]) == want


def test_every_rank_holds_the_same_params(ranks):
    def held(name, r):
        out = _result(ranks, name, r)
        return out["after"]["after"] if name == "guard" else out["params"]

    for name in ("sync", "local", "uneven", "guard", "dropout", "metrics"):
        for r in range(1, WORLD):
            assert _bits_equal(held(name, 0), held(name, r)), name


def test_sync_steps_match_jax_with_one_all_reduce(ranks):
    inp = ranks[0]["sync"]
    out = _result(ranks, "sync")
    conf = _conf_of(inp)
    step = jtrainer.make_sync_train_step(conf,
                                         jmesh.data_parallel_mesh(WORLD))
    p, s, scores, _ = _jax_steps(step, _jax_copy(inp["params"]),
                                 _jax_copy(inp["states"]), inp["batches"])
    _assert_close(out["params"], p, what="params")
    _assert_close(out["states"], s, what="updater state")
    np.testing.assert_allclose(out["scores"], scores, rtol=REL)
    assert out["all_reduce"] == [1, 1, 1]
    assert out["all_gather"] == [0, 0, 0]


def test_local_fit_round_matches_jax(ranks):
    inp = ranks[0]["local"]
    out = _result(ranks, "local")
    step = jtrainer.make_local_fit_step(
        _conf_of(inp), jmesh.data_parallel_mesh(WORLD),
        inp["local_iterations"])
    p, s, scores, _ = _jax_steps(step, _jax_copy(inp["params"]),
                                 _jax_copy(inp["states"]), inp["batches"])
    _assert_close(out["params"], p, what="params")
    _assert_close(out["states"], s, what="updater state")
    np.testing.assert_allclose(out["scores"], scores, rtol=REL)
    assert out["all_reduce"] == [1]


def test_uneven_batch_gradient_unbiased(ranks):
    """150 rows over 4 ranks leaves 2 padded rows of weight 0: the step
    lands on the single-device step on the unpadded batch (JAX's
    test_uneven_batch_gradient_unbiased), and on JAX's 4-device trainer."""
    inp = ranks[0]["uneven"]
    out = _result(ranks, "uneven")
    conf = _conf_of(inp)
    seq = JNet(conf, params=_jax_copy(inp["params"]))
    seq._do_backward(inp["x"], inp["y"])
    _assert_close(out["params"], _np(seq.params_tree), what="vs 1 device")
    par = JNet(conf, params=_jax_copy(inp["params"]))
    from deeplearning4j_tpu.datasets.dataset import DataSet
    from deeplearning4j_tpu.datasets.iterator import ListDataSetIterator

    jtrainer.ParameterAveragingTrainer(
        par, jmesh.data_parallel_mesh(WORLD),
        average_each_iteration=True).fit_data_set(
        ListDataSetIterator(DataSet(inp["x"], inp["y"]), 150))
    _assert_close(out["params"], _np(par.params_tree), what="vs JAX mesh")


def test_rmse_xent_head_matches_jax(ranks):
    inp = ranks[0]["rmse"]
    out = _result(ranks, "rmse")
    step = jtrainer.make_sync_train_step(_conf_of(inp),
                                         jmesh.data_parallel_mesh(WORLD))
    p, s, scores, _ = _jax_steps(step, _jax_copy(inp["params"]),
                                 _jax_copy(inp["states"]), inp["batches"])
    _assert_close(out["params"], p, what="params")
    _assert_close(out["states"], s, what="updater state")
    np.testing.assert_allclose(out["scores"], scores, rtol=REL)
    assert out["all_reduce"] == [1, 1]


def test_guard_skips_a_nonfinite_batch_on_every_rank(ranks):
    inp = ranks[0]["guard"]
    step = jtrainer.make_sync_train_step(
        _conf_of(inp), jmesh.data_parallel_mesh(WORLD), guard=True)
    p, s, _, aux = _jax_steps(step, _jax_copy(inp["params"]),
                              _jax_copy(inp["states"]), inp["batches"],
                              with_aux=True)
    for r in range(WORLD):
        out = _result(ranks, "guard", r)
        # the skipped step carries params AND updater state bitwise
        assert _bits_equal(out["nan"]["before"], out["nan"]["after"])
        assert [m["nonfinite"] for m in out["metrics"]] == [0.0, 1.0, 0.0]
        assert [float(a["nonfinite"]) for a in aux] == [0.0, 1.0, 0.0]
    out = _result(ranks, "guard")
    _assert_close(out["after"]["after"], (p, s), what="after the skip")


def test_adam_replicated_sharded_and_jax(ranks):
    inp = ranks[0]["adam"]
    out = _result(ranks, "adam")
    rep, shd = out["replicated"], out["sharded"]
    np.testing.assert_allclose(rep["scores"], shd["scores"], atol=ZERO_ATOL,
                               rtol=0)
    for a, b in zip(jax.tree_util.tree_leaves(rep["params"]),
                    jax.tree_util.tree_leaves(shd["params"])):
        assert float(np.max(np.abs(a - b))) <= ZERO_ATOL
    # each rank holds its (1, chunk) row: W is 4x8 = 32 → chunk 8
    assert tuple(shd["m_row_shape"]) == (1, 8)
    assert rep["all_reduce"] == shd["all_reduce"] == [1, 1, 1]
    assert rep["all_gather"] == [0, 0, 0] and shd["all_gather"] == [1, 1, 1]
    conf = _conf_of(inp)
    mesh = jmesh.data_parallel_mesh(WORLD)
    params = _jax_copy(inp["params"])
    for mode, res in (("replicated", rep), ("sharded", shd)):
        cfg = jupd.OptimizerConfig(name="adam", lr=1e-3,
                                   update_sharding=mode)
        step = jtrainer.make_sync_train_step(conf, mesh, optimizer=cfg)
        st = jtrainer.init_sync_opt_state(cfg, params, mesh)
        p, st, scores, _ = _jax_steps(step, _jax_copy(params), st,
                                      inp["batches"])
        _assert_close(res["params"], p, what=mode)
        np.testing.assert_allclose(res["scores"], scores, rtol=REL)
        zero = jupd.ZeroSharding(mesh, "data") if mode == "sharded" else None
        jcan = jupd.canonical_opt_state(
            jax.tree_util.tree_map(jnp.asarray, st), params, zero)
        _assert_close(res["canonical"]["m"], jcan["m"], what="m")
        _assert_close(res["canonical"]["v"], jcan["v"], what="v")
        assert int(res["canonical"]["count"]) == int(jcan["count"]) == 3


def test_sharded_lamb_metrics_block_matches_jax(ranks):
    inp = ranks[0]["metrics"]
    out = _result(ranks, "metrics")
    cfg = jupd.OptimizerConfig(name="lamb", lr=1e-3,
                               update_sharding="sharded")
    mesh = jmesh.data_parallel_mesh(WORLD)
    params = _jax_copy(inp["params"])
    step = jtrainer.make_sync_train_step(_conf_of(inp), mesh, optimizer=cfg,
                                         with_metrics=True, guard=True)
    st = jtrainer.init_sync_opt_state(cfg, params, mesh)
    p, _, _, aux = _jax_steps(step, _jax_copy(params), st, inp["batches"],
                              with_aux=True)
    assert set(out["metrics"]) == set(aux[0])
    for k, v in aux[0].items():
        assert abs(out["metrics"][k] - float(v)) <= REL * max(abs(float(v)),
                                                              1e-6), k
    _assert_close(out["params"], p, what="params")


def test_dropout_with_jax_masks_matches_jax(ranks):
    inp = ranks[0]["dropout"]
    out = _result(ranks, "dropout")
    assert out["draws"] == [(12, 4), (12, 8)]
    step = jtrainer.make_sync_train_step(_conf_of(inp),
                                         jmesh.data_parallel_mesh(WORLD))
    it, x, y, w, _ = inp["batches"][0]
    p, s, scores, _ = _jax_steps(step, _jax_copy(inp["params"]),
                                 _jax_copy(inp["states"]),
                                 [(it, x, y, w, 11)])
    _assert_close(out["params"], p, what="params")
    _assert_close(out["states"], s, what="updater state")
    np.testing.assert_allclose(out["scores"], scores, rtol=REL)


def test_checkpoint_written_by_rank_0_and_resumed_on_every_rank(ranks):
    from deeplearning4j_tpu.scaleout.ckpt.reshard import latest_step

    inp = ranks[0]["ckpt"]
    assert _result(ranks, "ckpt", 0)["saved"] == [2, 4]
    steps = sorted(os.listdir(inp["root"]))
    assert steps == ["step_0000000002", "step_0000000004"], steps
    assert latest_step(inp["root"]) == 4  # JAX's reader sees the commits
    for r in range(WORLD):
        out = _result(ranks, "ckpt", r)
        if r:
            assert out["saved"] == []
        assert out["resumed_step"] == out["resumed_iteration"] == 4
        assert _bits_equal(out["trained"], out["resumed"])
        assert _bits_equal(out["trained_state"], out["resumed_state"])
