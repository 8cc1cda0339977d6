"""The port's checkpoints over a mesh (scaleout/ckpt: the multi-process
writer, ``restore_sharded(shardings=)``, the live redistribution plans,
``AsyncCheckpointer``, the ``ckpt.*`` spans) held against the JAX
package's, mirroring the host cases of tests/test_ckpt.py,
test_ckpt_resume.py and test_redistribution.py.

Four gloo ranks start ONCE for the module (tests/_torch_ckpt_ranks.py,
torch and the port only): they save a TP-sharded MLN state and the
composed LM's expert slabs from their own chunks and merge the parts,
restore the JAX package's saves onto meshes of another shape, and run the
redistribution plans. JAX saves and restores the same states on 4-device
meshes of the test process's CPU devices. Every comparison is exact
(tolerance 0): manifests, chunks and restored values.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import threading
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

from _torch_parallel_ranks import collect_ranks, spawn_ranks
from deeplearning4j_tpu.models import transformer_lm as JT
from deeplearning4j_tpu.nn import functional as JF
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.parallel import sharding as jsharding
from deeplearning4j_tpu.scaleout.ckpt import manifest as jmf
from deeplearning4j_tpu.scaleout.ckpt import redistribution as jrd
from deeplearning4j_tpu.scaleout.ckpt.reshard import \
    restore_sharded as j_restore
from deeplearning4j_tpu.scaleout.ckpt.sharded_io import \
    save_sharded as j_save
from deeplearning4j_tpu_torch.interop import lm_params_from_numpy
from deeplearning4j_tpu_torch.models import transformer_lm as TL
from deeplearning4j_tpu_torch.scaleout.ckpt import (
    AsyncCheckpointer,
    Checkpointer,
    Placement,
    latest_step,
    merge_process_manifests,
    plan_cross_mesh,
    plan_redistribution,
    read_manifest,
    save_process_shards,
    save_sharded,
    step_dir_name,
)
from deeplearning4j_tpu_torch.scaleout.ckpt import manifest as tmf
from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

SCRIPT = Path(__file__).resolve().parent / "_torch_ckpt_ranks.py"
WORLD = 4
SPAWN_TIMEOUT_S = 240
V, D, H, E, FF = 32, 16, 2, 4, 32
DP_TP = (("data", "model"), (2, 2))
TP4 = (("data", "model"), (1, 4))
DP_EP = (("data", "expert"), (2, 2))
DP_SP_EP = (("data", "sp", "expert"), (1, 2, 2))
EP4 = (("expert",), (4,))
DP_PP = (("data", "pipe"), (2, 2))
ED = (("expert", "data"), (2, 2))   # "data" minor: ranks 1 and 2 swap


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jmesh(spec):
    names, sizes = spec
    return JMesh(np.array(jax.devices()[:WORLD]).reshape(sizes), names)


def _fake(spec, rank=0):
    names, sizes = spec
    coords = dict(zip(names, (int(c) for c in np.unravel_index(rank,
                                                                 sizes))))
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, sizes)),
                                 coords=coords, rank=rank)


def _mln_conf():
    return (JBuilder.Builder()
            .n_in(4).n_out(8).activation_function("tanh")
            .lr(0.1).momentum(0.9).num_iterations(1).seed(42)
            .list(2)
            .override(1, layer_type="OUTPUT", n_in=8, n_out=4,
                      activation_function="softmax", loss_function="MCXENT")
            .pretrain(False).backward(True).build())


def _mln_state():
    """The MLN's params and a nonzero momentum state: one JAX step."""
    conf = _mln_conf()
    params = JF.init_params(conf, jax.random.PRNGKey(0))
    states = JF.init_train_state(conf, params)
    rng = np.random.RandomState(0)
    x = rng.rand(8, 4).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 8)]
    params, states, _ = JF.make_train_step(conf)(
        params, states, jnp.asarray(0), x, y, jax.random.PRNGKey(1))
    return conf, _np(params), _np(states)


def _jax_mln_placed(conf, params, states, spec):
    """The MLN state placed on a JAX mesh by apply_shardings (the state's
    leaves like their params')."""
    mesh = _jmesh(spec)
    shardings = jsharding.param_shardings(conf, mesh)
    rep = NamedSharding(mesh, P())
    placed = jsharding.apply_shardings(params, shardings, mesh)
    st = tuple({k: {n: jax.device_put(a, shardings[i].get(n, rep))
                    for n, a in layer.items()} for k, layer in s.items()}
               for i, s in enumerate(states))
    return {"params": placed, "state": st}, mesh


def _lm_params(seed=0):
    return _np(JT.init_lm_params(jax.random.PRNGKey(seed), V, D, H, E, FF,
                                 2))


def _inputs(root: Path):
    conf, params, states = _mln_state()
    lm = _lm_params()
    # the JAX saves the ranks restore onto meshes of another shape
    jstate, _ = _jax_mln_placed(conf, params, states, DP_TP)
    j_mln_dir = j_save(str(root / "jax_mln"), 1, jstate)
    jlm = JT.shard_lm_params(jax.tree_util.tree_map(jnp.asarray, lm),
                             _jmesh(DP_EP))
    j_lm_dir = j_save(str(root / "jax_lm"), 1, {"params": jlm})
    mln = {"conf": conf.to_json(), "params": params, "states": states}
    rng = np.random.default_rng(7)
    axes = ["data", "sp", "expert"]

    def random_spec():
        remaining = list(axes)
        rng.shuffle(remaining)
        entries = []
        for _ in range(3):
            take = int(rng.integers(0, len(remaining) + 1))
            picked = tuple(remaining[:take])
            remaining = remaining[take:]
            entries.append(picked if len(picked) > 1 else
                           picked[0] if picked else None)
        return tuple(entries)

    return {
        "save_mln": dict(mln, kind="save_mln", mesh=DP_TP,
                         root=str(root / "port_mln")),
        "save_lm": {"kind": "save_lm", "mesh": DP_EP, "params": lm,
                    "root": str(root / "port_lm")},
        "restore_jax_mln": dict(mln, kind="restore_jax_mln", mesh=TP4,
                                step_dir=j_mln_dir),
        "restore_jax_lm": {"kind": "restore_jax_lm", "mesh": EP4,
                           "params": lm, "step_dir": j_lm_dir},
        "plans": {"kind": "plans", "mesh": DP_EP, "cases": {
            "move": ((None, "expert"), ("expert", None)),
            "gather": (("data", "expert"), (None, "expert")),
            "gather_all": ((None, "expert"), ()),
            "slice": ((), ("data", "expert")),
            "gather_move": ((("data", "expert"), None), (None, "data")),
            "gather_slice": (("data", None), (None, "expert"))},
            "cross": {
                "ep_to_dp_sp_ep": (DP_EP, (None, "expert"), DP_SP_EP,
                                   (None, "expert")),
                "dp_sp_ep_to_ep": (DP_SP_EP, ("data", "sp"), DP_EP,
                                   ("data", "expert")),
                "pp_to_ep": (DP_PP, ("pipe", None), DP_EP,
                             (None, "expert")),
                "permute": (DP_EP, ("data", None), ED, ("data", None))}},
        "round_trip": {"kind": "round_trip", "mesh": (tuple(axes),
                                                      (2, 2, 1)),
                       "x": rng.normal(size=(8, 8, 8)).astype(np.float32),
                       "pairs": [(random_spec(), random_spec())
                                 for _ in range(8)]},
        "live_lm": {"kind": "live_lm", "mesh": DP_EP, "params": lm,
                    "root": str(root / "live"), "cases": {
                        "dp_ep_to_dp_sp_ep": (DP_EP, DP_SP_EP),
                        "dp_sp_ep_to_dp_ep": (DP_SP_EP, DP_EP),
                        "dp_ep_to_single": (DP_EP, None),
                        "single_to_dp_sp_ep": (None, DP_SP_EP)}},
        "engine_live": {"kind": "engine_live", "mesh": DP_EP,
                        "params": _lm_params(3), "n_heads": H},
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt_mesh")
    inputs = _inputs(root)
    procs = spawn_ranks(root, inputs, WORLD, script=SCRIPT)
    ref = {}
    try:
        conf, params, states = _mln_state()
        jstate, mesh = _jax_mln_placed(conf, params, states, DP_TP)
        ref["mln_dir"] = j_save(str(root / "jax_ref_mln"), 3, jstate,
                                meta={"src": "port"})
        ref["mln_full"] = {"params": params, "state": states}
        lm = inputs["save_lm"]["params"]
        jlm = JT.shard_lm_params(jax.tree_util.tree_map(jnp.asarray, lm),
                                 _jmesh(DP_EP))
        ref["lm_dir"] = j_save(str(root / "jax_ref_lm"), 5,
                               {"params": jlm})
    finally:
        results = collect_ranks(root, procs, SPAWN_TIMEOUT_S)
    return inputs, results, ref


def _rank(runs, name, rank=0):
    out = runs[1][rank][name]
    assert "error" not in out, out.get("error")
    return out


def _manifest_rows(m):
    return [(e.path, tuple(e.shape), e.dtype, e.spec,
             [(c.file, tuple(c.start), tuple(c.shape), c.crc32)
              for c in e.chunks]) for e in m.leaves]


# --------------------------------------------- the multi-process writer ----

@pytest.mark.parametrize("name,ref_dir,step", [
    ("save_mln", "mln_dir", 3), ("save_lm", "lm_dir", 5)])
def test_merged_save_from_four_ranks_equals_jax_manifest(runs, name,
                                                         ref_dir, step):
    """A TP-sharded MLN state (params and momentum over ("data", "model"))
    and the LM's expert slabs (over ("data", "expert")), each rank saving
    only its chunks: the merged manifest equals JAX's save of the same
    state on a mesh of the same shape (paths, shapes, dtypes, specs,
    chunk files, starts and CRCs, topology), and every rank restores its
    own chunks bit-exact."""
    inputs, _, ref = runs
    got = read_manifest(os.path.join(inputs[name]["root"],
                                     step_dir_name(step)))
    want = jmf.read_manifest(ref[ref_dir])
    assert _manifest_rows(got) == _manifest_rows(want)
    assert got.mesh == want.mesh
    assert tmf.list_part_manifests(os.path.join(
        inputs[name]["root"], step_dir_name(step))) == []
    for r in range(WORLD):
        assert _rank(runs, name, r)["restored_bits_equal"], r


@pytest.mark.parametrize("spec", [TP4, (("data", "model"), (4, 1)), None])
def test_jax_restores_the_port_mln_save_onto_another_mesh(runs, spec):
    inputs, _, ref = runs
    full = ref["mln_full"]
    step_dir = os.path.join(inputs["save_mln"]["root"], step_dir_name(3))
    template = jax.tree_util.tree_map(jnp.asarray, full)
    shardings = None
    if spec is not None:
        placed, _ = _jax_mln_placed(_mln_conf(), full["params"],
                                    full["state"], spec)
        shardings = jax.tree_util.tree_map(lambda a: a.sharding, placed)
    got, _ = j_restore(step_dir, template, shardings)
    for a, b in zip(jax.tree_util.tree_leaves(_np(got)),
                    jax.tree_util.tree_leaves(full)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spec", [DP_SP_EP, EP4, None])
def test_jax_restores_the_port_lm_save_onto_another_mesh(runs, spec):
    inputs, _, _ = runs
    lm = inputs["save_lm"]["params"]
    step_dir = os.path.join(inputs["save_lm"]["root"], step_dir_name(5))
    template = {"params": jax.tree_util.tree_map(jnp.asarray, lm)}
    shardings = None if spec is None else {
        "params": JT.lm_param_shardings(template["params"], _jmesh(spec))}
    got, _ = j_restore(step_dir, template, shardings)
    for a, b in zip(jax.tree_util.tree_leaves(_np(got["params"])),
                    jax.tree_util.tree_leaves(lm)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["restore_jax_mln", "restore_jax_lm"])
def test_port_restores_jax_saves_onto_another_mesh(runs, name):
    """JAX's saves over ("data", "model") 2×2 and ("data", "expert") 2×2
    restored by every rank onto ("data", "model") 1×4 and ("expert",) 4
    with ``restore_sharded(shardings=)``: each rank's chunks equal what
    ``apply_shardings``/``shard_lm_params`` give it."""
    for r in range(WORLD):
        assert _rank(runs, name, r)["bits_equal"], r
    shapes = _rank(runs, "restore_jax_mln", 1)["shapes"]
    assert (4, 2) in shapes  # layer 0's W: 2 of its 8 columns a rank


def _lm_state_fake(rank, spec):
    full = lm_params_from_numpy(_lm_params(), "cpu")
    mesh = _fake(spec, rank)
    return full, TL.shard_lm_params(full, mesh, device="cpu"), \
        TL.lm_param_shardings(full, mesh), mesh


def test_process_shards_plus_merge_equals_single_save(tmp_path):
    """Four processes' parts (one process here, each rank's place on the
    mesh described) merged through the Checkpointer: chunk-identical to
    ``save_sharded`` of the whole state with the same specs, invisible
    until merged, no part manifests left after."""
    ck = Checkpointer(str(tmp_path), registry=MetricsRegistry())
    for r in range(WORLD):
        _, local, specs, mesh = _lm_state_fake(r, DP_EP)
        ck.save_process(3, {"params": local}, mesh=mesh,
                        specs={"params": specs})
    assert ck.latest_step() is None
    ck.merge_save(3, n_processes=WORLD, meta={"src": "mh"}, mesh=mesh)
    assert ck.latest_step() == 3
    full, _, specs, mesh = _lm_state_fake(0, DP_EP)
    ref = save_sharded(str(tmp_path / "single"), 3, {"params": full},
                       mesh=mesh, specs={"params": specs})
    got = read_manifest(os.path.join(str(tmp_path), step_dir_name(3)))
    assert _manifest_rows(got) == _manifest_rows(read_manifest(ref))
    assert got.meta == {"src": "mh"}
    assert tmf.list_part_manifests(
        os.path.join(str(tmp_path), step_dir_name(3))) == []
    for r in range(WORLD):
        full, local, specs, mesh = _lm_state_fake(r, DP_SP_EP)
        state, _, _ = ck.restore({"params": full}, {"params": specs},
                                 device="cpu", mesh=mesh)
        for a, b in zip(jax.tree_util.tree_leaves(state["params"]),
                        jax.tree_util.tree_leaves(local)):
            assert torch.equal(a, b)


def test_merge_barrier_refuses_holey_checkpoint(tmp_path):
    """A merge whose parts do not cover every leaf (a rank's chunks
    missing) refuses to commit."""
    for r in (0, 2, 3):     # rank 1, the owner of expert group 1, died
        _, local, specs, mesh = _lm_state_fake(r, DP_EP)
        save_process_shards(str(tmp_path), 7, {"params": local},
                            mesh=mesh, specs={"params": specs})
    with pytest.raises(TimeoutError, match="3/4"):
        merge_process_manifests(str(tmp_path), 7, 4, timeout_s=0.2)
    with pytest.raises(ValueError, match="cover"):
        merge_process_manifests(str(tmp_path), 7, 3, timeout_s=5)
    assert latest_step(str(tmp_path)) is None  # nothing committed


def test_master_crash_mid_manifest_merge_resumes_prior_step(tmp_path):
    """Parts written but no merge (the coordinator crashed): latest_step
    still answers the previous step, its sharded restore is byte-clean,
    and a later committed save sweeps the debris."""
    ck = Checkpointer(str(tmp_path), registry=MetricsRegistry())
    full, _, specs, mesh = _lm_state_fake(0, DP_EP)
    ck.save(3, {"params": full}, mesh=mesh, specs={"params": specs})
    for r in range(WORLD):
        _, local, specs, mesh = _lm_state_fake(r, DP_EP)
        save_process_shards(str(tmp_path), 4, {"params": local}, mesh=mesh,
                            specs={"params": specs})
    assert ck.latest_step() == 3
    full, local, specs, mesh = _lm_state_fake(2, DP_EP)
    state, step, _ = ck.restore({"params": full}, {"params": specs},
                                device="cpu", mesh=mesh)
    assert step == 3
    for a, b in zip(jax.tree_util.tree_leaves(state["params"]),
                    jax.tree_util.tree_leaves(local)):
        assert torch.equal(a, b)
    ck.save(5, {"params": full})
    assert not os.path.isdir(os.path.join(str(tmp_path), step_dir_name(4)))
    assert ck.latest_step() == 5


def _lm_restore(step_dir, params, mesh):
    """``restore_sharded`` of the LM params onto ``mesh``'s rank (None:
    whole)."""
    from deeplearning4j_tpu_torch.scaleout.ckpt import restore_sharded

    state, manifest = restore_sharded(
        step_dir, {"params": params},
        shardings=None if mesh is None else {
            "params": TL.lm_param_shardings(params, mesh)},
        device="cpu", mesh=mesh)
    return state["params"], manifest


def test_grouped_expert_cross_g_restore(tmp_path):
    """The expert layout is G-invariant: a save from a dp2×ep2 mesh (8
    experts, G=4) restores SPLIT onto ("data", "expert") 1×8 (G=1, each
    rank one expert), that layout's parts saved again MERGE back into a
    whole restore, every chunk where ``shard_lm_params`` puts it."""
    params = lm_params_from_numpy(_np(JT.init_lm_params(
        jax.random.PRNGKey(5), V, D, H, 8, FF, 2)), "cpu")
    g4, g1 = (("data", "expert"), (2, 2)), (("data", "expert"), (1, 8))

    def save_parts(root, spec, n):
        for r in range(n):
            mesh = _fake(spec, r)
            save_process_shards(root, 1, {"params": TL.shard_lm_params(
                params, mesh, device="cpu")}, mesh=mesh, specs={
                    "params": TL.lm_param_shardings(params, mesh)})
        return merge_process_manifests(root, 1, n, mesh=mesh)

    step_dir = save_parts(str(tmp_path / "g4"), g4, 4)
    for r in range(8):
        mesh = _fake(g1, r)
        got, _ = _lm_restore(step_dir, params, mesh)
        want = TL.shard_lm_params(params, mesh, device="cpu")
        assert got["blocks"]["experts"]["w1"].shape[1] == 1
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert torch.equal(a, b)
    step_dir = save_parts(str(tmp_path / "g1"), g1, 8)
    whole, _ = _lm_restore(step_dir, params, None)
    for a, b in zip(jax.tree_util.tree_leaves(whole),
                    jax.tree_util.tree_leaves(params)):
        assert torch.equal(a, b)


def test_ckpt_inspect_reads_a_merged_port_save(tmp_path, capsys):
    """JAX's ``tools/ckpt_inspect.py`` on a save merged from four ranks'
    parts: summary, CRC verification, JSON."""
    from tools.ckpt_inspect import main

    for r in range(WORLD):
        _, local, specs, mesh = _lm_state_fake(r, DP_EP)
        save_process_shards(str(tmp_path), 2, {"params": local}, mesh=mesh,
                            specs={"params": specs})
    merge_process_manifests(str(tmp_path), 2, WORLD, mesh=mesh)
    assert main([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "step 2" in out and "['params']['embed']" in out
    assert main([str(tmp_path), "--verify"]) == 0
    assert "ok:" in capsys.readouterr().out
    assert main([str(tmp_path), "--json"]) == 0
    import json

    payload = json.loads(capsys.readouterr().out)
    assert payload["step"] == 2 and payload["leaves"] > 0


# ------------------------------------------------- redistribution plans ----

def _kinds_both(src, dst, spec, ndim=None):
    fake = _fake(spec)
    got = plan_redistribution(src, dst, fake, ndim).kinds()
    want = jrd.plan_redistribution(P(*src), P(*dst), _jmesh(spec),
                                   ndim).kinds()
    assert got == want
    return got


class TestPlanDerivation:
    """JAX's TestPlanDerivation with the port's spec tuples on 4-rank
    meshes, no ranks started: the plans equal JAX's."""

    def test_noop_move_gather_slice_kinds(self):
        assert _kinds_both(("data", "expert"), ("data", "expert"),
                           DP_EP) == []
        assert _kinds_both((None, "expert"), ("expert", None),
                           DP_EP) == ["all_to_all"]
        assert _kinds_both(("data", "expert"), (None, "expert"),
                           DP_EP) == ["all_gather"]
        assert _kinds_both((None, None), ("data", "expert"),
                           DP_EP) == ["slice"]

    def test_compound_plan_orders_gather_move_slice(self):
        plan = plan_redistribution((("data", "expert"), None),
                                   (None, "data"), _fake(DP_EP))
        assert plan.kinds() == ["all_gather", "all_to_all"]
        assert plan.steps[0].partition_spec() == ("data", None)
        assert _kinds_both(("data", None), (None, "expert"),
                           DP_EP) == ["all_gather", "slice"]

    def test_unknown_axis_rejected(self):
        with pytest.raises(ValueError, match="not on the mesh"):
            plan_redistribution(("bogus",), (), _fake(DP_EP))

    def test_cross_mesh_plan_kinds(self):
        def both(sa, a, sb, b):
            got = plan_cross_mesh(Placement(_fake(sa), a),
                                  Placement(_fake(sb), b), 2).kinds()
            want = jrd.plan_cross_mesh(
                NamedSharding(_jmesh(sa), P(*a)),
                NamedSharding(_jmesh(sb), P(*b)), 2).kinds()
            assert got == want
            return got

        assert both(DP_EP, (None, "expert"), DP_SP_EP,
                    (None, "expert")) == ["ppermute"]
        assert both(DP_EP, (None, "expert"), EP4,
                    (None, "expert")) == ["all_to_all"]
        assert both(DP_EP, ("data", None), DP_PP,
                    ("data", None)) == ["ppermute"]


def test_executed_plans_land_the_chunks_with_their_collectives(runs):
    """Every executed plan lands each rank's ``local_chunk`` of the
    whole array, and ``COLLECTIVES`` counts its step kinds: one
    all-gather a gather, one all-to-all a move, nothing a slice, one
    point-to-point exchange a permutation; a rebind onto the mesh one
    broadcast, off it one all-gather."""
    counter = {"all_gather": "all_gather", "all_to_all": "all_to_all"}
    for r in range(WORLD):
        out = _rank(runs, "plans", r)
        for name, case in out.items():
            assert case["equal"], (name, r)
            if "kinds" not in case:
                continue
            if case["kinds"] == ["ppermute"]:
                # one exchange on a rank whose chunk moves (or that sends
                # its chunk to one), none where nothing moves
                if name == "permute" and r in (1, 2):
                    assert case["collectives"] == {"send_recv": 1}, r
                else:
                    assert case["collectives"] in ({}, {"send_recv": 1})
                if name != "permute":
                    assert case["collectives"] == {}, (name, r)
                continue
            want = {}
            for kind in case["kinds"]:
                if kind in counter:
                    want[counter[kind]] = want.get(counter[kind], 0) + 1
            assert case["collectives"] == want, (name, case)
        assert out["rebind_on"]["collectives"] == {"broadcast": 1}
        assert out["rebind_off"]["collectives"] == {"all_gather": 1}
        assert out["move"]["kinds"] == ["all_to_all"]
        assert out["pp_to_ep"]["kinds"] == ["all_to_all"]
        assert out["permute"]["kinds"] == ["ppermute"]


def test_randomized_round_trip_identity(runs):
    for r in range(WORLD):
        assert all(_rank(runs, "round_trip", r)["ok"]), r


@pytest.mark.parametrize("case", ["dp_ep_to_dp_sp_ep", "dp_sp_ep_to_dp_ep",
                                  "dp_ep_to_single", "single_to_dp_sp_ep"])
def test_live_matches_host_restore(runs, case):
    """The LM's params moved live across the cross-mesh matrix land
    bit-identical to the host restore of the source's save onto the
    target, and to the target's own placement."""
    for r in range(WORLD):
        out = _rank(runs, "live_lm", r)[case]
        assert out["live_equals_restore"] and out["live_equals_place"], r


def test_engine_cold_start_from_live_sharded_params(runs):
    for r in range(WORLD):
        out = _rank(runs, "engine_live", r)
        assert out["version"] == "live-params"
        assert out["live"] == out["host"] and len(out["live"]) == 6


# ------------------------------------------------------ async and spans ----

def test_async_checkpointer_keeps_training_thread_free(tmp_path):
    """Saves commit in the background with the bytes of a blocking save;
    a restore after a save sees it."""
    reg = MetricsRegistry()
    ck = AsyncCheckpointer(
        Checkpointer(str(tmp_path), keep_last=3, registry=reg))
    trees = {i: {"x": torch.arange(64.0) * i} for i in (1, 2, 3)}
    for i, tree in trees.items():
        ck.save(i, tree, meta={"i": i})
    state, step, meta = ck.restore({"x": torch.zeros(64)}, device="cpu")
    assert step == 3 and meta["i"] == 3
    np.testing.assert_array_equal(state["x"].numpy(), np.arange(64.0) * 3)
    assert reg.counter("ckpt_async_saves_total").value == 3
    assert reg.counter("ckpt_saves_total").value == 3
    sync = save_sharded(str(tmp_path / "sync"), 3, trees[3])
    assert _manifest_rows(read_manifest(sync)) == _manifest_rows(
        read_manifest(os.path.join(str(tmp_path), step_dir_name(3))))
    ck.close()


def test_async_snapshot_is_taken_at_save(tmp_path):
    """The save copies the state when it is called: an in-place update
    right after it does not reach the checkpoint."""
    with AsyncCheckpointer(Checkpointer(str(tmp_path),
                                        registry=MetricsRegistry())) as ck:
        x = torch.ones(16)
        ck.save(1, {"x": x})
        x.mul_(5.0)
        state, _, _ = ck.restore({"x": torch.zeros(16)}, device="cpu")
    assert torch.equal(state["x"], torch.ones(16))


def test_async_concurrent_save_flush_close(tmp_path):
    """Saver threads racing flush() against the max_pending=2
    backpressure: every enqueued save commits exactly once, no deadlock,
    failures none."""
    reg = MetricsRegistry()
    ck = AsyncCheckpointer(
        Checkpointer(str(tmp_path), keep_last=100, registry=reg),
        max_pending=2)
    errors = []

    def saver(i):
        try:
            for j in range(4):
                step = i * 1000 + j
                ck.save(step, {"x": torch.full((32,), float(step))},
                        meta={"step": step})
        except BaseException as exc:  # noqa: BLE001
            errors.append(exc)

    def flusher():
        try:
            for _ in range(4):
                ck.flush()
        except BaseException as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=saver, args=(i,)) for i in range(3)]
    threads.append(threading.Thread(target=flusher))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "stress hung"
    ck.close()
    assert not errors, errors
    assert reg.counter("ckpt_async_saves_total").value == 12
    assert reg.counter("ckpt_async_failures_total").value == 0
    assert len(ck.step_dirs()) == 12
    state, step, _ = ck.restore({"x": torch.zeros(32)}, device="cpu")
    assert torch.equal(state["x"], torch.full((32,), float(step)))


def test_ckpt_spans_where_the_jax_checkpointer_emits_them(tmp_path):
    from deeplearning4j_tpu_torch.telemetry import trace

    tracer = trace.configure("ckpt-test", str(tmp_path / "trace"),
                             crash_hooks=False)
    try:
        ck = Checkpointer(str(tmp_path / "ck"), registry=MetricsRegistry())
        ck.save(1, {"w": torch.ones(3)})
        ck.restore({"w": torch.zeros(3)}, device="cpu")
        save_process_shards(ck.root, 2, {"w": torch.ones(3)})
        ck.merge_save(2, 1)
        names = [s["name"] for s in tracer.snapshot()["recent"]]
    finally:
        trace.set_tracer(None)
        tracer.close()
    for name in ("ckpt.save", "ckpt.restore", "ckpt.merge_save"):
        assert name in names, names
