"""One rank of the port's checkpoint-over-a-mesh checks: the multi-process
writer (``save_process_shards`` + ``merge_process_manifests`` through the
``Checkpointer``), ``restore_sharded(shardings=)`` of the port's and the
JAX package's saves, the live redistribution plans and the serving cold
start from a sharded tree.

Run as ``python tests/_torch_ckpt_ranks.py RANK WORLD PORT IN OUT``,
started by ``_torch_parallel_ranks.spawn_ranks(..., script=SCRIPT)``: the
rank joins a gloo group on ``127.0.0.1:PORT``, runs every scenario of
``IN`` on the mesh it names and writes its results to
``OUT/rank<RANK>.pkl``. It imports torch and the port only.
"""

from __future__ import annotations

import os
import pickle
import sys
import traceback

import numpy as np
import torch

torch.set_num_threads(1)

from deeplearning4j_tpu_torch._device import tree_leaves  # noqa: E402
from deeplearning4j_tpu_torch.interop import (  # noqa: E402
    lm_params_from_numpy,
    mln_params_from_numpy,
    tree_to_numpy,
)
from deeplearning4j_tpu_torch.models import transformer_lm as TL  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from deeplearning4j_tpu_torch.parallel import multihost  # noqa: E402
from deeplearning4j_tpu_torch.parallel import sharding  # noqa: E402
from deeplearning4j_tpu_torch.scaleout.ckpt import (  # noqa: E402
    Checkpointer,
    Placement,
    placements,
    plan_cross_mesh,
    plan_redistribution,
    redistribute,
    redistribute_tree,
    restore_sharded,
)
from deeplearning4j_tpu_torch.telemetry.registry import (  # noqa: E402
    MetricsRegistry,
)

CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a))


def _tensors(tree):
    from deeplearning4j_tpu_torch._device import tree_map

    return tree_map(lambda _, a: _t(a), tree)


def _bits_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _mln_state(inp, mesh):
    """This rank's chunks of the TP-sharded MLN state and the state's
    spec tree."""
    conf = MultiLayerConfiguration.from_json(inp["conf"])
    full = {"params": mln_params_from_numpy(inp["params"], CPU),
            "state": _tensors(inp["states"])}
    shardings = sharding.param_shardings(conf, mesh)
    specs = {"params": sharding.layer_specs(full["params"], shardings),
             "state": sharding.state_specs(full["params"], shardings)}
    return full, sharding.shard_tree(full, specs, mesh), specs


def _merged_save(root, step, local, specs, mesh, meta=None):
    """Every rank's part, then the coordinator's merge."""
    ck = Checkpointer(root, registry=MetricsRegistry())
    ck.save_process(step, local, mesh=mesh, specs=specs)
    mesh.barrier()
    if mesh.rank == 0:
        ck.merge_save(step, mesh.size, meta=meta, mesh=mesh)
    mesh.barrier()
    return ck


def scenario_save_mln(inp, mesh):
    """The TP-sharded MLN state saved by the 4 ranks and merged; each rank
    restores its chunks back with ``shardings=``."""
    full, local, specs = _mln_state(inp, mesh)
    ck = _merged_save(inp["root"], 3, local, specs, mesh, {"src": "port"})
    template = {k: v for k, v in full.items()}
    got, step, meta = ck.restore(template, shardings=specs, step=3,
                                 device=CPU, mesh=mesh)
    return {"restored_bits_equal": _bits_equal(got, local), "step": step,
            "meta": meta}


def scenario_save_lm(inp, mesh):
    """The composed LM's expert slabs (``shard_lm_params``) saved by the 4
    ranks and merged."""
    full = lm_params_from_numpy(inp["params"], CPU)
    local = TL.shard_lm_params(full, mesh, device=CPU)
    specs = TL.lm_param_shardings(full, mesh)
    ck = _merged_save(inp["root"], 5, {"params": local},
                      {"params": specs}, mesh)
    got, _, _ = ck.restore({"params": full},
                           shardings={"params": specs}, device=CPU,
                           mesh=mesh)
    return {"restored_bits_equal": _bits_equal(got["params"], local)}


def scenario_restore_jax_mln(inp, mesh):
    """A JAX save of the TP-sharded MLN state (another mesh) restored onto
    this mesh: the rank's chunks equal ``apply_shardings``'."""
    full, local, specs = _mln_state(inp, mesh)
    got, _ = restore_sharded(inp["step_dir"], full, shardings=specs,
                             device=CPU, mesh=mesh)
    return {"bits_equal": _bits_equal(got, local),
            "shapes": [tuple(x.shape) for x in tree_leaves(got)]}


def scenario_restore_jax_lm(inp, mesh):
    full = lm_params_from_numpy(inp["params"], CPU)
    local = TL.shard_lm_params(full, mesh, device=CPU)
    got, _ = restore_sharded(inp["step_dir"], {"params": full},
                             shardings={"params": TL.lm_param_shardings(
                                 full, mesh)}, device=CPU, mesh=mesh)
    return {"bits_equal": _bits_equal(got["params"], local)}


def _count(fn):
    pmesh.reset_collectives()
    out = fn()
    return out, {k: v for k, v in pmesh.COLLECTIVES.items() if v}


def scenario_plans(inp, mesh):
    """Executed plans on a ("data", "expert") mesh: each case's chunk
    against ``local_chunk`` of the whole array, and its collectives."""
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    out = {}
    for name, (src, dst) in inp["cases"].items():
        plan = plan_redistribution(src, dst, mesh, 2)
        local = sharding.local_chunk(x, src, mesh)
        got, coll = _count(lambda: redistribute(
            local, Placement(mesh, dst), Placement(mesh, src)))
        out[name] = {"kinds": plan.kinds(), "collectives": coll,
                     "equal": torch.equal(got, sharding.local_chunk(
                         x, dst, mesh))}
    # across meshes over the same ranks, and rebinds
    for name, (src_mesh, src, dst_mesh, dst) in inp["cross"].items():
        a, b = pmesh.Mesh(*src_mesh), pmesh.Mesh(*dst_mesh)
        plan = plan_cross_mesh(Placement(a, src), Placement(b, dst), 2)
        got, coll = _count(lambda: redistribute(
            sharding.local_chunk(x, src, a), Placement(b, dst),
            Placement(a, src)))
        out[name] = {"kinds": plan.kinds(), "collectives": coll,
                     "equal": torch.equal(got, sharding.local_chunk(
                         x, dst, b))}
    whole = x if mesh.rank == 0 else torch.zeros_like(x)
    got, coll = _count(lambda: redistribute(
        whole, Placement(mesh, ("data", "expert")), Placement()))
    out["rebind_on"] = {"collectives": coll, "equal": torch.equal(
        got, sharding.local_chunk(x, ("data", "expert"), mesh))}
    got, coll = _count(lambda: redistribute(
        sharding.local_chunk(x, (None, "expert"), mesh), Placement(),
        Placement(mesh, (None, "expert"))))
    out["rebind_off"] = {"collectives": coll,
                         "equal": torch.equal(got, x)}
    return out


def scenario_round_trip(inp, mesh):
    """src → dst → src over the scenario's random specs is bitwise the
    identity, and each leg lands ``local_chunk``'s chunk."""
    x = _t(inp["x"])
    out = []
    for src, dst in inp["pairs"]:
        local = sharding.local_chunk(x, src, mesh)
        there = redistribute(local, Placement(mesh, dst),
                             Placement(mesh, src))
        back = redistribute(there, Placement(mesh, src),
                            Placement(mesh, dst))
        out.append(bool(torch.equal(there, sharding.local_chunk(
            x, dst, mesh)) and torch.equal(back, local)))
    return {"ok": out}


def _lm_placed(full, mesh_spec):
    """(local tree, spec tree, mesh) of the LM on a mesh (None: whole on
    every rank)."""
    if mesh_spec is None:
        return full, None, None
    mesh = pmesh.Mesh(*mesh_spec)
    return (TL.shard_lm_params(full, mesh, device=CPU),
            TL.lm_param_shardings(full, mesh), mesh)


def scenario_live_lm(inp, mesh):
    """Live redistribution of the LM params across meshes against the host
    restore of the source's merged save onto the target: bit-exact."""
    full = lm_params_from_numpy(inp["params"], CPU)
    out = {}
    for name, (src_spec, dst_spec) in inp["cases"].items():
        src_local, src_specs, src_mesh = _lm_placed(full, src_spec)
        dst_local, dst_specs, dst_mesh = _lm_placed(full, dst_spec)
        root = os.path.join(inp["root"], name)
        if src_mesh is None:
            if mesh.rank == 0:
                Checkpointer(root, registry=MetricsRegistry()).save(
                    0, {"params": src_local})
            mesh.barrier()
            src_pl = None
        else:
            _merged_save(root, 0, {"params": src_local},
                         {"params": src_specs}, src_mesh)
            src_pl = placements(src_specs, src_local, src_mesh)
        dst_pl = (Placement() if dst_mesh is None
                  else placements(dst_specs, full, dst_mesh))
        oracle, _ = restore_sharded(
            os.path.join(root, "step_0000000000"), {"params": full},
            shardings=None if dst_mesh is None else {"params": dst_specs},
            device=CPU, mesh=dst_mesh)
        live = redistribute_tree(
            src_local, dst_pl if dst_mesh is None else dst_pl,
            src_pl)
        out[name] = {"live_equals_restore": _bits_equal(
            live, oracle["params"]), "live_equals_place": _bits_equal(
            live, dst_local)}
    return out


def scenario_engine_live(inp, mesh):
    """DecodeEngine.from_live_params on a dp×ep sharded tree against the
    engine on the whole params: the same tokens."""
    from deeplearning4j_tpu_torch.serve.engine import DecodeEngine

    full = lm_params_from_numpy(inp["params"], CPU)
    local = TL.shard_lm_params(full, mesh, device=CPU)
    kw = dict(n_slots=2, max_len=32, serve_dtype=None, seed=0)
    live = DecodeEngine.from_live_params(
        local, inp["n_heads"], shardings=TL.lm_param_shardings(full, mesh),
        mesh=mesh, device=CPU, **kw)
    host = DecodeEngine(full, inp["n_heads"], device=CPU, **kw)
    prompt = [1, 2, 3, 4]
    return {"live": live.generate(prompt, max_new_tokens=6),
            "host": host.generate(prompt, max_new_tokens=6),
            "version": live.weight_version,
            "whole": _bits_equal(live.params, full)}


SCENARIOS = {name[len("scenario_"):]: fn for name, fn in
             list(globals().items()) if name.startswith("scenario_")}


def main(argv) -> int:
    rank, world, port, in_path, out_dir = argv
    rank, world = int(rank), int(world)
    with open(in_path, "rb") as f:
        inputs = pickle.load(f)
    results = {}
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device=CPU)
    try:
        for name in sorted(inputs):
            inp = inputs[name]
            mesh = pmesh.Mesh(*inp["mesh"])
            try:
                results[name] = SCENARIOS[inp["kind"]](inp, mesh)
            except Exception:  # reported per scenario, the rest still run
                results[name] = {"error": traceback.format_exc()}
            mesh.barrier()
    finally:
        multihost.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
