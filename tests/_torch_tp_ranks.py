"""One rank of the tensor-parallel port's multi-process checks: the
data-parallel trainer on a ("data", "model") mesh, ``make_tp_train_step``
on ("data", "model") meshes, and the LM's composed step with a "model"
axis.

Run as ``python tests/_torch_tp_ranks.py RANK WORLD PORT IN OUT``,
started by ``_torch_parallel_ranks.spawn_ranks(..., script=SCRIPT)``: the
rank joins a gloo group on ``127.0.0.1:PORT``, runs every scenario of
``IN`` (a pickle of numpy trees) on the mesh the scenario names
(``inp["mesh"]``: axis names and sizes) and writes its results to
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

from _torch_composed_ranks import scenario_composed  # noqa: E402,F401
from deeplearning4j_tpu_torch.interop import (  # noqa: E402
    mln_params_from_numpy,
    tree_to_numpy,
)
from deeplearning4j_tpu_torch.nn import functional as F  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.ops import pallas_kernels  # noqa: E402
from deeplearning4j_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from deeplearning4j_tpu_torch.parallel import multihost  # noqa: E402
from deeplearning4j_tpu_torch.parallel import sharding  # noqa: E402
from deeplearning4j_tpu_torch.parallel import trainer as T  # noqa: E402
from deeplearning4j_tpu_torch.parallel.tensor_parallel import (  # noqa: E402
    make_tp_train_step,
)

CPU = "cpu"
K1_CALLS = [0]


def _count_k1():
    """Count the fused-dense kernel's calls (its CPU twin runs here)."""
    original = pallas_kernels.fused_dense_fwd

    def counted(*args, **kwargs):
        K1_CALLS[0] += 1
        return original(*args, **kwargs)

    pallas_kernels.fused_dense_fwd = counted


def _conf(s: str) -> MultiLayerConfiguration:
    return MultiLayerConfiguration.from_json(s)


def scenario_trainer(inp, mesh):
    """``ParameterAveragingTrainer.fit_data_set`` (sync or local) on the
    mesh from the JAX package's params; the rows ``_shard_rows`` gives
    this rank."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    net = MultiLayerNetwork(_conf(inp["conf"]),
                            params=mln_params_from_numpy(inp["params"], CPU),
                            device=CPU)
    trainer = T.ParameterAveragingTrainer(
        net, mesh, average_each_iteration=inp["sync"])
    x, y = inp["x"], inp["y"]
    pmesh.reset_collectives()
    trainer.fit_data_set(ListDataSetIterator(DataSet(x, y), inp["batch"]))
    rows = T._shard_rows(np.arange(len(x))[:, None], mesh, torch.device(CPU))
    return {"params": tree_to_numpy(net.params_tree),
            "rows": rows[:, 0].numpy(), "collectives": dict(
                pmesh.COLLECTIVES)}


def scenario_tp_step(inp, mesh):
    """``make_tp_train_step`` over the batches from the whole params
    placed with ``apply_shardings``: per step the score, the collectives
    and K1's calls; the final local params, their gather, and the port's
    single-device step on the same batches and keys."""
    conf = _conf(inp["conf"])
    full = mln_params_from_numpy(inp["params"], CPU)
    specs = sharding.param_shardings(conf, mesh)
    local = sharding.apply_shardings(full, specs, mesh)
    states = F.init_train_state(conf, local)
    step = make_tp_train_step(conf, mesh)
    out = {"scores": [], "collectives": [], "k1": [], "specs": specs,
           "placed": tree_to_numpy(local)}
    for it, x, y, key in inp["batches"]:
        pmesh.reset_collectives()
        K1_CALLS[0] = 0
        local, states, score = step(local, states, it, x, y, key)
        out["scores"].append(float(score))
        out["collectives"].append(dict(pmesh.COLLECTIVES))
        out["k1"].append(K1_CALLS[0])
    out["local"] = tree_to_numpy(local)
    out["params"] = tree_to_numpy(sharding.gather_shardings(local, specs,
                                                            mesh))
    out["states"] = tree_to_numpy(sharding.gather_tree(
        states, sharding.state_specs(local, specs), mesh))
    single = F.make_train_step(conf)
    params = mln_params_from_numpy(inp["params"], CPU)
    st = F.init_train_state(conf, params)
    out["single_scores"] = []
    for it, x, y, key in inp["batches"]:
        params, st, score = single(params, st, it, x, y, key)
        out["single_scores"].append(float(score))
    out["single"] = tree_to_numpy(params)
    return out


SCENARIOS = {name[len("scenario_"):]: fn for name, fn in
             list(globals().items()) if name.startswith("scenario_")}


def main(argv) -> int:
    rank, world, port, in_path, out_dir = argv
    rank, world = int(rank), int(world)
    with open(in_path, "rb") as f:
        inputs = pickle.load(f)
    _count_k1()
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
