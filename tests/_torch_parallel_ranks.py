"""One rank of the data-parallel port's multi-process checks.

Run as ``python tests/_torch_parallel_ranks.py RANK WORLD PORT IN OUT``:
the rank joins a gloo process group on ``127.0.0.1:PORT`` through
``parallel.multihost.initialize``, reads the scenarios' inputs (a pickle
of numpy trees) from ``IN``, runs every scenario through the port's
trainer and writes its results to ``OUT/rank<RANK>.pkl``. It imports torch
and the port only; tests/test_torch_parallel.py starts the ranks, runs the
JAX package's trainer on the same inputs in its own process, and compares.
"""

from __future__ import annotations

import os
import pickle
import sys
import traceback

import numpy as np
import torch

torch.set_num_threads(1)

from deeplearning4j_tpu_torch.interop import (  # noqa: E402
    mln_params_from_numpy,
    tree_to_numpy,
    updater_state_from_numpy,
)
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import dense  # noqa: E402
from deeplearning4j_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from deeplearning4j_tpu_torch.parallel import multihost  # noqa: E402
from deeplearning4j_tpu_torch.parallel import trainer as T  # noqa: E402

CPU = "cpu"


def _conf(s: str) -> MultiLayerConfiguration:
    return MultiLayerConfiguration.from_json(s)


def _params(tree):
    return mln_params_from_numpy(tree, device=CPU)


def _states(tree):
    return updater_state_from_numpy(tree, device=CPU)


def _run_steps(step, params, states, batches):
    """Run ``step`` over ``batches`` of (iteration, x, y, w, key); returns
    the final params and states as numpy, the scores, and the all-reduces
    and all-gathers each step made."""
    scores, reduces, gathers = [], [], []
    for it, x, y, w, key in batches:
        pmesh.reset_collectives()
        out = step(params, states, it, x, y, w, key)
        reduces.append(pmesh.COLLECTIVES["all_reduce"])
        gathers.append(pmesh.COLLECTIVES["all_gather"])
        params, states, score = out[0], out[1], out[2]
        scores.append(float(score))
    return {"params": tree_to_numpy(params), "states": tree_to_numpy(states),
            "scores": scores, "all_reduce": reduces, "all_gather": gathers}


def scenario_mesh(inp, mesh):
    out = {"world": mesh.size, "rank": mesh.rank,
           "coords": dict(mesh.coords),
           "process_info": multihost.process_info(),
           "is_coordinator": multihost.is_coordinator(),
           "global_2x2": dict(multihost.global_mesh(
               ("data", "model"), (2, 2)).coords)}
    try:
        pmesh.data_parallel_mesh(mesh.size + 4)
        out["oversized"] = None
    except ValueError as e:
        out["oversized"] = str(e)
    from deeplearning4j_tpu_torch.parallel.sharding import param_shardings

    out["specs_2x2"] = param_shardings(_conf(inp["conf"]),
                                       pmesh.mesh_2d(2, 2))
    return out


def scenario_sync(inp, mesh):
    conf = _conf(inp["conf"])
    step = T.make_sync_train_step(conf, mesh)
    return _run_steps(step, _params(inp["params"]), _states(inp["states"]),
                      inp["batches"])


def scenario_local(inp, mesh):
    conf = _conf(inp["conf"])
    step = T.make_local_fit_step(conf, mesh, inp["local_iterations"])
    return _run_steps(step, _params(inp["params"]), _states(inp["states"]),
                      inp["batches"])


def scenario_uneven(inp, mesh):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    net = MultiLayerNetwork(_conf(inp["conf"]), params=_params(inp["params"]),
                            device=CPU)
    x, y = inp["x"], inp["y"]
    trainer = T.ParameterAveragingTrainer(net, mesh,
                                          average_each_iteration=True)
    trainer.fit_data_set(ListDataSetIterator(DataSet(x, y), len(x)))
    return {"params": tree_to_numpy(net.params_tree)}


def scenario_guard(inp, mesh):
    conf = _conf(inp["conf"])
    step = T.make_sync_train_step(conf, mesh, guard=True)
    params, states = _params(inp["params"]), _states(inp["states"])
    out = {"metrics": []}
    for name, (it, x, y, w, key) in zip(("clean", "nan", "after"),
                                        inp["batches"]):
        before = tree_to_numpy((params, states))
        params, states, score, gm = step(params, states, it, x, y, w, key)
        out["metrics"].append({k: float(v) for k, v in gm.items()})
        out[name] = {"before": before,
                     "after": tree_to_numpy((params, states)),
                     "score": float(score)}
    return out


def scenario_adam(inp, mesh):
    from deeplearning4j_tpu_torch.optimize.updaters import (
        OptimizerConfig,
        ZeroSharding,
        canonical_opt_state,
    )

    conf = _conf(inp["conf"])
    out = {}
    for mode in ("replicated", "sharded"):
        cfg = OptimizerConfig(name="adam", lr=1e-3, update_sharding=mode)
        step = T.make_sync_train_step(conf, mesh, optimizer=cfg)
        params = _params(inp["params"])
        st = T.init_sync_opt_state(cfg, params, mesh)
        res = _run_steps(step, params, st, inp["batches"])
        res["m_row_shape"] = res["states"]["m"][0]["W"].shape
        zero = ZeroSharding(mesh) if mode == "sharded" else None
        # rebuild the final state as tensors for the canonical gather
        final = {"m": _tensors(res["states"]["m"]),
                 "v": _tensors(res["states"]["v"]),
                 "count": torch.tensor(int(res["states"]["count"]))}
        res["canonical"] = canonical_opt_state(final, params, zero)
        out[mode] = res
    return out


def _tensors(tree):
    from deeplearning4j_tpu_torch._device import tree_map

    return tree_map(lambda _, a: torch.from_numpy(np.array(a)), tree)


def scenario_metrics(inp, mesh):
    from deeplearning4j_tpu_torch.optimize.updaters import OptimizerConfig

    conf = _conf(inp["conf"])
    cfg = OptimizerConfig(name="lamb", lr=1e-3, update_sharding="sharded")
    step = T.make_sync_train_step(conf, mesh, optimizer=cfg,
                                  with_metrics=True, guard=True)
    params = _params(inp["params"])
    st = T.init_sync_opt_state(cfg, params, mesh)
    it, x, y, w, key = inp["batches"][0]
    new_p, _, _, metrics = step(params, st, it, x, y, w, key)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": tree_to_numpy(new_p)}


def scenario_dropout(inp, mesh):
    """One sync step with the JAX package's dropout masks put in at the
    port's draw point, in draw order (layer 0's input, then the head's)."""
    conf = _conf(inp["conf"])
    masks = [torch.from_numpy(m) for m in inp["masks"]]
    original = dense._bernoulli
    calls = []

    def injected(key, p, like):
        m = masks[len(calls)]
        calls.append(tuple(like.shape))
        assert tuple(m.shape) == tuple(like.shape), (m.shape, like.shape)
        return m

    dense._bernoulli = injected
    try:
        step = T.make_sync_train_step(conf, mesh)
        res = _run_steps(step, _params(inp["params"]),
                         _states(inp["states"]), inp["batches"])
    finally:
        dense._bernoulli = original
    res["draws"] = calls
    return res


def scenario_ckpt(inp, mesh):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.scaleout.ckpt import Checkpointer

    conf = _conf(inp["conf"])
    root = inp["root"]
    x, y = inp["x"], inp["y"]
    net = MultiLayerNetwork(conf, params=_params(inp["params"]), device=CPU)
    trainer = T.ParameterAveragingTrainer(
        net, mesh, average_each_iteration=True,
        checkpointer=Checkpointer(root), checkpoint_every=2)
    trainer.fit_data_set(ListDataSetIterator(DataSet(x, y), inp["batch"]))
    saved = list(trainer._ckpt_listener.saved_steps)
    fresh = MultiLayerNetwork(conf, device=CPU).init()
    resumer = T.ParameterAveragingTrainer(fresh, mesh,
                                          average_each_iteration=True)
    step = resumer.resume(Checkpointer(root))
    return {"saved": saved, "resumed_step": step,
            "resumed_iteration": resumer._iteration,
            "trained": tree_to_numpy(net.params_tree),
            "trained_state": tree_to_numpy(net._train_state),
            "resumed": tree_to_numpy(fresh.params_tree),
            "resumed_state": tree_to_numpy(fresh._train_state)}


SCENARIOS = {name[len("scenario_"):]: fn for name, fn in globals().items()
             if name.startswith("scenario_")}


def main(argv) -> int:
    rank, world, port, in_path, out_dir = argv
    rank, world = int(rank), int(world)
    with open(in_path, "rb") as f:
        inputs = pickle.load(f)
    results = {}
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device=CPU)
    try:
        mesh = pmesh.data_parallel_mesh()
        for name in sorted(inputs):
            try:
                kind = inputs[name].get("kind", name)
                results[name] = SCENARIOS[kind](inputs[name], mesh)
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
