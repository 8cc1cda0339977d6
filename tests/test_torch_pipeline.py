"""The port's GPipe pipeline (deeplearning4j_tpu_torch/parallel/pipeline.py)
held against the JAX package's.

Four gloo ranks start ONCE for the module (tests/_torch_composed_ranks.py)
and run ``pipeline_apply`` and ``make_pipeline_train_step`` on a ("pipe",)
mesh of 4 stages and a ("data", "pipe") mesh of 2×2 (microbatch rows over
"data"), ``pipeline_from_conf`` on a uniform dense segment and
``heterogeneous_pipeline_from_conf`` on the zoo's digits MLP; JAX runs the
same inputs on 4-device meshes of the same shapes meanwhile. Each rank
holds its stage: its outputs, grads and params are held against its slice
of JAX's. Grads are held to the sequential forward through JAX's, as JAX's
own tests hold them. The overlapped schedule is bit-identical to the
strict one. Tolerance 1e-5 (f32), as JAX's tests.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

from _torch_parallel_ranks import collect_ranks, spawn_ranks
from deeplearning4j_tpu.models.zoo import digits_mlp
from deeplearning4j_tpu.nn import functional as JF
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JBuilderConf
from deeplearning4j_tpu.parallel import pipeline as jpipe
from deeplearning4j_tpu_torch.parallel import pipeline as tpipe

SCRIPT = Path(__file__).resolve().parent / "_torch_composed_ranks.py"
WORLD = 4
D, MB, STEPS = 16, 4, 3
TOL = 1e-5
SPAWN_TIMEOUT_S = 240
PIPE4 = (("pipe",), (4,))
DP_PP = (("data", "pipe"), (2, 2))

# name: (mesh, n_micro, batch_axis, with_metrics, seed)
SCENARIOS = {
    "pipe4": (PIPE4, 8, None, False, 0),
    "pipe4_m6": (PIPE4, 6, None, False, 1),
    "pipe4_m2": (PIPE4, 2, None, False, 2),
    "dp_pp": (DP_PP, 8, "data", True, 3),
}


def _jstage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _jmesh(spec):
    names, sizes = spec
    return JMesh(np.array(jax.devices()[:WORLD]).reshape(sizes), names)


def _uniform_conf():
    return (JBuilderConf.Builder()
            .n_in(D).n_out(D).activation_function("tanh").seed(3)
            .weight_init("VI").list(5)
            .override(4, layer_type="OUTPUT", n_in=D, n_out=3,
                      activation_function="softmax", loss_function="MCXENT")
            .pretrain(False).backward(True).build())


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _inputs():
    out = {}
    for name, (mesh, m, batch_axis, metrics, seed) in SCENARIOS.items():
        rng = np.random.RandomState(seed)
        n_stages = dict(zip(*mesh))["pipe"]
        out[name] = {
            "kind": "pipeline", "mesh": mesh, "batch_axis": batch_axis,
            "with_metrics": metrics, "steps": STEPS,
            "stages": {"w": (rng.randn(n_stages, D, D) / np.sqrt(D))
                       .astype(np.float32),
                       "b": (rng.randn(n_stages, D) * 0.1).astype(
                           np.float32)},
            "x": rng.randn(m, MB, D).astype(np.float32),
            "tgt": np.tanh(rng.randn(m, MB, D)).astype(np.float32)}
    conf = _uniform_conf()
    params = _np(JF.init_params(conf, jax.random.PRNGKey(0)))
    x = np.random.RandomState(5).randn(8, MB, D).astype(np.float32)
    out["conf_uniform"] = {"kind": "pipeline_conf", "mesh": PIPE4,
                           "conf": conf.to_json(), "params": params, "x": x}
    digits = digits_mlp(hidden=32)
    out["conf_digits"] = {
        "kind": "pipeline_conf", "mesh": (("data", "pipe"), (2, 2)),
        "heterogeneous": True, "conf": digits.to_json(),
        "params": _np(JF.init_params(digits, jax.random.PRNGKey(0))),
        "x": np.random.RandomState(6).randn(8, MB, 64).astype(np.float32)}
    return out


def _jax_pipeline(inp):
    mesh = _jmesh(inp["mesh"])
    batch_axis = inp["batch_axis"]
    stacked = jpipe.shard_stage_params(
        {k: jnp.asarray(v) for k, v in inp["stages"].items()}, mesh)
    x, tgt = jnp.asarray(inp["x"]), jnp.asarray(inp["tgt"])

    def loss(p):
        y = jpipe.pipeline_apply(p, x, _jstage, mesh, batch_axis=batch_axis)
        return jnp.mean((y - tgt) ** 2), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(stacked)
    step = jpipe.make_pipeline_train_step(
        _jstage, lambda a, b: jnp.mean((a - b) ** 2), mesh, lr=0.2,
        batch_axis=batch_axis, with_metrics=inp["with_metrics"])
    params = jax.tree_util.tree_map(jnp.array, stacked)
    losses, blocks = [], []
    for _ in range(STEPS):
        res = step(params, x, tgt)
        jax.block_until_ready(res)
        params = res[0]
        losses.append(float(res[1]))
        if len(res) == 3:
            blocks.append(_np(res[2]))
    return {"y": np.asarray(y), "grads": _np(g), "losses": losses,
            "blocks": blocks, "params": _np(params)}


def _jax_conf(inp):
    from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration

    conf = MultiLayerConfiguration.from_json(inp["conf"])
    params = jax.tree_util.tree_map(jnp.asarray, inp["params"])
    x = jnp.asarray(inp["x"])
    if inp.get("heterogeneous"):
        return np.asarray(jax.vmap(lambda xb: JF.output(conf, params, xb))(x))
    return np.asarray(jax.vmap(lambda m: _seq_conf(conf, params, m))(x))


def _seq_conf(conf, params, m):
    from deeplearning4j_tpu.nn import layers as layer_ops

    for i in range(4):
        m = layer_ops.forward(conf.conf(i), params[i], m)
    return m


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    inputs = _inputs()
    procs = spawn_ranks(root, inputs, WORLD, script=SCRIPT)
    try:
        ref = {name: (_jax_pipeline(inp) if inp["kind"] == "pipeline"
                      else _jax_conf(inp))
               for name, inp in inputs.items()}
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


def _rows(a, spec, rank, batch_axis, dim=1):
    if batch_axis is None:
        return a
    n = dict(zip(*spec))[batch_axis]
    r = _coords(spec, rank)[batch_axis]
    k = a.shape[dim] // n
    return np.take(a, range(r * k, (r + 1) * k), axis=dim)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pipeline_apply_matches_jax_outputs_and_stage_grads(runs, name):
    """Every rank's output rows (every stage returns them) and its stage's
    grads of mean((y - tgt)²) equal JAX's, strict and overlapped; the
    overlapped outputs and grads are bit-identical to the strict ones."""
    inp, want = runs[0][name], runs[2][name]
    spec = inp["mesh"]
    for rank in range(WORLD):
        out = _rank(runs, name, rank)
        s = _coords(spec, rank)["pipe"]
        for overlap in (False, True):
            got = out[f"apply_{overlap}"]
            np.testing.assert_allclose(
                got["y"], _rows(want["y"], spec, rank, inp["batch_axis"]),
                atol=TOL)
            for k in ("b", "w"):
                np.testing.assert_allclose(got[k][0], want["grads"][k][s],
                                           atol=TOL, err_msg=(name, k))
        for k in ("y", "b", "w"):
            np.testing.assert_array_equal(out["apply_True"][k],
                                          out["apply_False"][k])


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_train_step_matches_jax_and_overlap_is_bit_identical(runs, name):
    inp, want = runs[0][name], runs[2][name]
    spec = inp["mesh"]
    for rank in range(WORLD):
        out = _rank(runs, name, rank)
        s = _coords(spec, rank)["pipe"]
        strict, over = out["train_False"], out["train_True"]
        np.testing.assert_allclose(strict["losses"], want["losses"],
                                   rtol=TOL)
        for k in ("b", "w"):
            np.testing.assert_allclose(strict["params"][k][0],
                                       want["params"][k][s], atol=TOL)
        assert over["losses"] == strict["losses"]
        for k in ("b", "w"):
            np.testing.assert_array_equal(over["params"][k],
                                          strict["params"][k])
    assert want["losses"][-1] < want["losses"][0]


def test_dp_pp_metrics_match_jax(runs):
    want = runs[2]["dp_pp"]["blocks"]
    for rank in range(WORLD):
        got = _rank(runs, "dp_pp", rank)["train_False"]["blocks"]
        assert len(got) == len(want) == STEPS
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                           atol=1e-7, err_msg=k)


def test_pipeline_from_conf_matches_network_forward(runs):
    want = runs[2]["conf_uniform"]
    for rank in range(WORLD):
        np.testing.assert_allclose(_rank(runs, "conf_uniform", rank)["y"],
                                   want, atol=TOL)


def test_heterogeneous_pipeline_digits_mlp_matches_forward(runs):
    """digits_mlp (64→32→10) one layer a stage on a 2×2 ("data",
    "pipe") mesh: the padded pipeline's first 10 lanes are the network's
    output, the padding exact zeros."""
    want = runs[2]["conf_digits"]
    for rank in range(WORLD):
        out = _rank(runs, "conf_digits", rank)
        assert out["width"] == 10
        np.testing.assert_allclose(out["y"][..., :10], want, atol=TOL,
                                   rtol=TOL)
        assert float(np.max(np.abs(out["y"][..., 10:]))) == 0.0


def test_validation_and_stage_helpers():
    import types

    from deeplearning4j_tpu_torch.interop import mln_params_from_numpy
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh

    conf = _uniform_conf()
    tconf = MultiLayerConfiguration.from_json(conf.to_json())
    params = mln_params_from_numpy(
        _np(JF.init_params(conf, jax.random.PRNGKey(0))), device="cpu")
    fake = types.SimpleNamespace(axis_names=("pipe",), shape={"pipe": 2},
                                 coords={"pipe": 1})
    with pytest.raises(ValueError, match="pipe axis"):
        tpipe.pipeline_from_conf(tconf, params, fake)
    with pytest.raises(ValueError, match="not DENSE"):
        tpipe.pipeline_from_conf(tconf, params, fake, layers=[3, 4])
    digits = MultiLayerConfiguration.from_json(digits_mlp(32).to_json())
    with pytest.raises(ValueError, match="pipe axis"):
        tpipe.heterogeneous_pipeline_from_conf(
            digits, (), types.SimpleNamespace(axis_names=("pipe",),
                                              shape={"pipe": 4}))
    stacked = tpipe.stack_stage_params([{"w": torch.full((2,), float(i))}
                                        for i in range(4)])
    assert [p["w"][0].item() for p in
            tpipe.unstack_stage_params(stacked)] == [0.0, 1.0, 2.0, 3.0]
    fake4 = types.SimpleNamespace(axis_names=("pipe",), shape={"pipe": 4},
                                  coords={"pipe": 2})
    assert tpipe.shard_stage_params(stacked, fake4)["w"][0, 0].item() == 2.0
    merged = tpipe.merge_stage_axis({"w": torch.zeros(2, 3, 5)})
    assert merged["w"].shape == (6, 5)
    with pytest.raises(ValueError, match="leading dim"):
        tpipe.pipeline_apply(stacked, torch.zeros(2, 1, 2), lambda p, x: x,
                             Mesh(("pipe",), (1,)))
    with pytest.raises(ValueError, match="needs the 'data' axis"):
        tpipe.pp_update_sharding(Mesh(("pipe",), (1,)))
    with pytest.raises(ValueError, match="tune_context"):
        tpipe.make_pipeline_train_step(lambda p, x: x, lambda a, b: a,
                                       Mesh(("pipe",), (1,)), tuned=True)
    # profile= (item 21a-ii) arms under JAX's label and changes no output
    from deeplearning4j_tpu_torch._device import tree_leaves

    w = {"w": torch.full((1, 2, 2), 0.5), "b": torch.zeros(1, 2)}
    xs = torch.ones(2, 1, 2)

    def stage(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    def mse(a, b):
        return ((a - b) ** 2).mean()

    plain = tpipe.make_pipeline_train_step(stage, mse, Mesh(("pipe",), (1,)))
    step = tpipe.make_pipeline_train_step(stage, mse, Mesh(("pipe",), (1,)),
                                          profile=True)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(plain(w, xs, xs)), tree_leaves(step(w, xs, xs))))
    assert step.step_profile.label == "pipeline[pipe]"
