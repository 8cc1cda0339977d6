"""The port's expert-parallel MoE (deeplearning4j_tpu_torch/parallel/moe.py)
held against the JAX package's ``moe_apply`` and ``moe_reference``.

Four gloo ranks start ONCE for the module (tests/_torch_composed_ranks.py)
and run ``moe_apply`` on an ("expert",) mesh of 4 (the "alltoall_2d"
dispatch as its 2×2 grid) and on a ("data", "expert") mesh of 2×2 with
the tokens over "data"; JAX runs the same inputs on 4-device meshes of the
same shapes meanwhile: outputs, and the grads of mean((out - tgt)²) for
the router and each rank's expert group. At a capacity that drops routes
the same routes drop as in JAX (held to JAX's values and to
``moe_reference`` over the dispatch's sub-shards). Tolerance 1e-5 (f32),
as JAX's tests. The single-process checks (selection seam, validation,
load balance, references) run here.

JAX's own ``test_capacity_overflow_drops_tokens[alltoall]`` fails because
its capacity 4 drops nothing under the all-to-all's 8 sub-shards of 8
tokens (``assert dropped > 0``); the overflow cases here pick capacities
that do drop, and assert so.
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
from deeplearning4j_tpu.parallel import moe as jmoe
from deeplearning4j_tpu_torch.parallel import moe as tmoe
from deeplearning4j_tpu_torch.parallel.mesh import Mesh

SCRIPT = Path(__file__).resolve().parent / "_torch_composed_ranks.py"
WORLD = 4
D, N = 8, 64
TOL = 1e-5
SPAWN_TIMEOUT_S = 240
EP4 = (("expert",), (4,))
DP_EP = (("data", "expert"), (2, 2))

IMPL_RUNS = {f"{impl}_top{k}": {"impl": impl, "top_k": k}
             for impl in ("alltoall", "alltoall_2d", "replicated")
             for k in (1, 2)}
# name: (mesh, n_experts, capacity, token_axes, runs, seed)
SCENARIOS = {
    "ample": (EP4, 8, N, (), IMPL_RUNS, 0),
    "tight": (EP4, 4, 2, (), IMPL_RUNS, 1),
    "grouped_g4": (EP4, 16, 3, (), {"alltoall_top2": {"impl": "alltoall",
                                                      "top_k": 2}}, 2),
    "dp_ep": (DP_EP, 4, 3, ("data",),
              {"alltoall_top2": {"impl": "alltoall", "top_k": 2},
               "replicated_top2": {"impl": "replicated", "top_k": 2},
               "seam_replicated": {"global_impl": "replicated"},
               "auto": {}}, 3),
}


def _jexpert(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _texpert(p, x):
    return torch.tanh(x @ p["w"] + p["b"][:, None, :])


def _setup(n_experts, seed):
    rng = np.random.RandomState(seed)
    experts = {"w": (rng.randn(n_experts, D, D) / np.sqrt(D))
               .astype(np.float32),
               "b": (rng.randn(n_experts, D) * 0.1).astype(np.float32)}
    router = (rng.randn(D, n_experts) / np.sqrt(D)).astype(np.float32)
    x = rng.randn(N, D).astype(np.float32)
    tgt = np.tanh(rng.randn(N, D)).astype(np.float32)
    return router, experts, x, tgt


def _jmesh(spec):
    names, sizes = spec
    return JMesh(np.array(jax.devices()[:WORLD]).reshape(sizes), names)


def _inputs():
    out = {}
    for name, (mesh, e, cap, axes, runs, seed) in SCENARIOS.items():
        router, experts, x, tgt = _setup(e, seed)
        out[name] = {"kind": "moe", "mesh": mesh, "router": router,
                     "experts": experts, "x": x, "tgt": tgt,
                     "capacity": cap, "token_axes": axes, "runs": runs}
    return out


def _jax_run(inp, kw):
    mesh = _jmesh(inp["mesh"])
    router = jnp.asarray(inp["router"])
    experts = {k: jnp.asarray(v) for k, v in inp["experts"].items()}
    x, tgt = jnp.asarray(inp["x"]), jnp.asarray(inp["tgt"])
    impl = kw.get("impl") or kw.get("global_impl")

    def loss(rw, ps):
        out = jmoe.moe_apply(rw, ps, x, mesh, _jexpert, inp["capacity"],
                             top_k=kw.get("top_k", 1),
                             token_axes=tuple(inp["token_axes"]), impl=impl)
        return jnp.mean((out - tgt) ** 2), out

    (_, out), (gr, ge) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(router, experts)
    return {"out": np.asarray(out), "router": np.asarray(gr),
            "b": np.asarray(ge["b"]), "w": np.asarray(ge["w"])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe")
    inputs = _inputs()
    procs = spawn_ranks(root, inputs, WORLD, script=SCRIPT)
    try:
        ref = {name: {run: _jax_run(inp, kw)
                      for run, kw in inp["runs"].items()}
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


def _check(runs, name, run):
    inp = runs[0][name]
    spec = inp["mesh"]
    want = runs[2][name][run]
    sizes = dict(zip(*spec))
    for rank in range(WORLD):
        got = _rank(runs, name, rank)[run]
        c = _coords(spec, rank)
        rows = N // sizes.get("data", 1)
        r = c.get("data", 0)
        np.testing.assert_allclose(got["out"],
                                   want["out"][r * rows:(r + 1) * rows],
                                   atol=TOL, err_msg=(name, run, rank))
        np.testing.assert_allclose(got["router"], want["router"], atol=TOL,
                                   err_msg=(name, run, rank))
        g = want["w"].shape[0] // sizes["expert"]
        e = c["expert"]
        for k in ("b", "w"):
            np.testing.assert_allclose(got[k], want[k][e * g:(e + 1) * g],
                                       atol=TOL, err_msg=(name, run, k))


@pytest.mark.parametrize("run", sorted(IMPL_RUNS))
def test_moe_matches_jax_with_ample_capacity(runs, run):
    """G=2 experts a rank, nothing dropped: outputs and grads equal JAX's
    on every rank, for each dispatch and top-k."""
    _check(runs, "ample", run)


@pytest.mark.parametrize("run", sorted(IMPL_RUNS))
def test_capacity_overflow_drops_the_same_routes(runs, run):
    """Capacity 2 a (expert, sub-shard): routes drop, the same as JAX's
    (outputs and grads), and the output is ``moe_reference``'s over the
    dispatch's sub-shards."""
    _check(runs, "tight", run)
    inp = runs[0]["tight"]
    mesh = types_mesh(EP4)
    impl, k = IMPL_RUNS[run]["impl"], IMPL_RUNS[run]["top_k"]
    shards = tmoe.route_shards(mesh, (), "expert", N, impl)
    router, x = torch.from_numpy(inp["router"]), torch.from_numpy(inp["x"])
    dropped = tmoe.expected_dropped(router, x, 2, k, n_shards=shards)
    assert dropped > 0
    frac = float(tmoe.dropped_route_fraction(router, x, 2, k, shards))
    assert abs(frac - dropped / (N * k)) < 1e-6
    assert abs(frac - float(jmoe.dropped_route_fraction(
        jnp.asarray(inp["router"]), jnp.asarray(inp["x"]), 2, k,
        n_shards=shards))) < 1e-6
    per = [{n: torch.from_numpy(a[e]) for n, a in inp["experts"].items()}
           for e in range(4)]
    ref = tmoe.moe_reference(router, per, x, _texpert, 2, k, shards)
    got = np.concatenate([_rank(runs, "tight", 0)[run]["out"]])
    np.testing.assert_allclose(got, ref.numpy(), atol=TOL)


def test_grouped_g4_alltoall_matches_jax(runs):
    _check(runs, "grouped_g4", "alltoall_top2")


@pytest.mark.parametrize("run", ["alltoall_top2", "replicated_top2",
                                 "seam_replicated", "auto"])
def test_dp_ep_token_axes_match_jax(runs, run):
    """Tokens over "data" and experts over "expert" (token_axes), the
    seam's override and the auto gate included."""
    _check(runs, "dp_ep", run)


def test_alltoall_2d_is_bit_identical_to_flat(runs):
    for rank in range(WORLD):
        out = _rank(runs, "tight", rank)
        for k in (1, 2):
            flat, two = out[f"alltoall_top{k}"], out[f"alltoall_2d_top{k}"]
            for key in ("out", "router", "b", "w"):
                np.testing.assert_array_equal(flat[key], two[key])
            # two grouped exchanges for each flat one: the dispatch and
            # the return forward, the return's transpose backward (x is
            # data here, so the dispatch's transpose does not run)
            assert two["collectives"]["all_to_all"] == \
                2 * flat["collectives"]["all_to_all"] == 6


def types_mesh(spec):
    import types

    names, sizes = spec
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, sizes)))


# ------------------------------------------------------- single process ----

def test_seam_and_route_shards_match_jax(monkeypatch):
    for impl in (None, "alltoall", "alltoall_2d", "replicated"):
        for n in (64, 60):
            assert tmoe.resolve_moe_impl(n, 8, impl) == \
                jmoe.resolve_moe_impl(n, 8, impl)
            for spec, axes in ((EP4, ()), (DP_EP, ("data",))):
                assert tmoe.route_shards(types_mesh(spec), axes, "expert",
                                         n, impl) == jmoe.route_shards(
                    _jmesh(spec), axes, "expert", n, impl)
    monkeypatch.setenv(tmoe.MOE_IMPL_ENV, "alltoall_2d")
    assert tmoe.get_moe_impl() == jmoe.get_moe_impl() == "alltoall_2d"
    tmoe.set_moe_impl("replicated")
    try:
        assert tmoe.resolve_moe_impl(64, 8) == "replicated"
    finally:
        tmoe.set_moe_impl(None)
    monkeypatch.setenv(tmoe.MOE_IMPL_ENV, "alltoall_3d")
    with pytest.raises(ValueError, match="alltoall_3d"):
        tmoe.resolve_moe_impl(64, 8)
    with pytest.raises(ValueError, match="unknown moe impl"):
        tmoe.set_moe_impl("pairwise")


def test_factor_expert_axis_matches_jax():
    for n in (4, 6, 8, 9, 12, 16):
        assert tmoe.factor_expert_axis(n) == jmoe.factor_expert_axis(n)
    for bad in (2, 3, 5, 7):
        with pytest.raises(ValueError, match="not factorizable"):
            tmoe.factor_expert_axis(bad)


def test_validation_messages_match_jax():
    """The checks raise where JAX's do (one rank: a mesh with no group)."""
    router, experts, x, _ = _setup(4, 5)
    mesh = Mesh(("expert",), (1,))
    tr = torch.from_numpy(router)
    te = {k: torch.from_numpy(v) for k, v in experts.items()}
    tx = torch.from_numpy(x)
    with pytest.raises(ValueError, match="top_k"):
        tmoe.moe_apply(tr, te, tx, mesh, _texpert, 8, top_k=3)
    with pytest.raises(ValueError, match="unknown moe impl"):
        tmoe.moe_apply(tr, te, tx, mesh, _texpert, 8, impl="sparse")
    with pytest.raises(ValueError, match="leading dim"):
        tmoe.moe_apply(tr, {k: v[:2] for k, v in te.items()}, tx, mesh,
                       _texpert, 8)
    with pytest.raises(ValueError, match="not factorizable"):
        tmoe.moe_apply(tr, te, tx, mesh, _texpert, 8, impl="alltoall_2d")


def test_one_rank_moe_equals_reference_and_dense():
    """On one rank every dispatch is moe_reference's semantics; top-2 at
    ample capacity gives every token both experts."""
    router, experts, x, _ = _setup(4, 6)
    mesh = Mesh(("expert",), (1,))
    tr, tx = torch.from_numpy(router), torch.from_numpy(x)
    te = {k: torch.from_numpy(v) for k, v in experts.items()}
    per = [{k: v[e] for k, v in te.items()} for e in range(4)]
    for impl in ("alltoall", "replicated"):
        for cap in (N, 5):
            out = tmoe.moe_apply(tr, te, tx, mesh, _texpert, cap, top_k=2,
                                 impl=impl)
            ref = tmoe.moe_reference(tr, per, tx, _texpert, cap, 2)
            jref = jmoe.moe_reference(
                jnp.asarray(router),
                [{k: jnp.asarray(v[e]) for k, v in experts.items()}
                 for e in range(4)], jnp.asarray(x), _jexpert, cap, 2)
            np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=TOL)
            np.testing.assert_allclose(ref.numpy(), np.asarray(jref),
                                       atol=TOL)
    full = tmoe.moe_apply(tr, te, tx, mesh, _texpert, N, top_k=2)
    assert int((full == 0).all(-1).sum()) == 0


def test_load_balance_and_expert_load_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(N, D).astype(np.float32)
    rw = np.zeros((D, 8), np.float32)
    assert abs(float(tmoe.load_balance_loss(torch.from_numpy(rw),
                                            torch.from_numpy(x))) - 1) < 1e-5
    rw[:, 0] = 5.0
    xp = np.abs(x)
    got = float(tmoe.load_balance_loss(torch.from_numpy(rw),
                                       torch.from_numpy(xp)))
    want = float(jmoe.load_balance_loss(jnp.asarray(rw), jnp.asarray(xp)))
    assert abs(got - want) < 1e-5 and got > 4.0
    for k in (1, 2):
        r2 = rng.randn(D, 8).astype(np.float32)
        np.testing.assert_array_equal(
            tmoe.expert_load(torch.from_numpy(r2), torch.from_numpy(x),
                             k).numpy(),
            np.asarray(jmoe.expert_load(jnp.asarray(r2), jnp.asarray(x), k)))


def test_stack_and_shard_expert_params():
    per = [{"w": torch.full((2, 2), float(e))} for e in range(8)]
    stacked = tmoe.stack_expert_params(per)
    assert stacked["w"].shape == (8, 2, 2)
    mesh = types_mesh(EP4)
    mesh.coords = {"expert": 2}
    local = tmoe.shard_expert_params(stacked, mesh)
    assert local["w"][:, 0, 0].tolist() == [4.0, 5.0]
    with pytest.raises(ValueError, match="does not split"):
        tmoe.shard_expert_params({"w": torch.zeros(6, 2)}, mesh)
