"""One rank of the data-parallel port's multi-process checks, and the
launcher the test modules start four of.

Run as ``python tests/_torch_parallel_ranks.py RANK WORLD PORT IN OUT``:
the rank joins a gloo process group on ``127.0.0.1:PORT`` through
``parallel.multihost.initialize``, reads the scenarios' inputs (a pickle
of numpy trees) from ``IN``, runs every scenario through the port (the
MLP trainer, the LM's composed step, Word2Vec's sharded steps and mesh
fit) and writes its results to ``OUT/rank<RANK>.pkl``. It imports torch
and the port only: JAX's random draws come in the inputs, precomputed by
the test process (``_neg_slots`` returns them in call order).
tests/test_torch_parallel.py, test_torch_lm_dp.py and
test_torch_word2vec_mesh.py start the ranks (``spawn_ranks``), run the
JAX package on the same inputs in their own process meanwhile, collect
the ranks' results (``collect_ranks``, each rank killed after a timeout)
and compare.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import traceback
from pathlib import Path

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
REPO = Path(__file__).resolve().parent.parent


# ------------------------------------------------------------ launcher ----

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(root: Path, inputs: dict, world: int,
                script: Path = Path(__file__).resolve()) -> list:
    """Write ``inputs`` under ``root`` and start ``world`` ranks of
    ``script`` (this file's scenarios by default); returns the
    processes."""
    in_path = root / "inputs.pkl"
    with open(in_path, "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world),
         str(port), str(in_path), str(root)],
        env=env, cwd=str(root), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def collect_ranks(root: Path, procs: list, timeout: float) -> list:
    """Wait for ``procs`` (each killed after ``timeout`` s) and load every
    rank's results; a failed rank fails with its output."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r]}"
    results = []
    for r in range(len(procs)):
        with open(root / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results



# ------------------------------------------------------------ scenarios ----


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


def _lm_optimizer(spec):
    from deeplearning4j_tpu_torch.optimize.updaters import OptimizerConfig

    return None if spec is None else OptimizerConfig(**spec)


def _floats(block):
    import numpy as np

    return {k: np.asarray(v.detach().cpu().numpy()) for k, v in block.items()}


def scenario_lm(inp, mesh):
    """Steps of ``make_composed_train_step`` on the global batches of
    ``inp``; per step the loss, the metrics/guard block and the
    collectives, and the final params (and canonical optimizer state)."""
    from deeplearning4j_tpu_torch.interop import lm_params_from_numpy, \
        tree_to_numpy
    from deeplearning4j_tpu_torch.models import transformer_lm as T
    from deeplearning4j_tpu_torch.optimize.updaters import \
        canonical_opt_state
    from deeplearning4j_tpu_torch.parallel import mesh as pmesh

    opt = _lm_optimizer(inp.get("optimizer"))
    step = T.make_composed_train_step(
        mesh, inp["n_heads"], inp["capacity"], lr=inp["lr"],
        with_metrics=inp.get("with_metrics", False),
        guard=inp.get("guard"), optimizer=opt, device=CPU)
    params = T.shard_lm_params(lm_params_from_numpy(inp["params"], CPU),
                               mesh, device=CPU)
    state = (None if opt is None else
             T.init_lm_opt_state(opt, params, mesh, device=CPU))
    out = {"losses": [], "blocks": [], "all_reduce": [], "all_gather": []}
    for tokens, targets in inp["batches"]:
        tk, tg = T.shard_lm_batch(tokens, targets, mesh, device=CPU)
        pmesh.reset_collectives()
        res = (step(params, tk, tg) if opt is None
               else step(params, state, tk, tg))
        out["all_reduce"].append(pmesh.COLLECTIVES["all_reduce"])
        out["all_gather"].append(pmesh.COLLECTIVES["all_gather"])
        if opt is None:
            params, loss = res[0], res[1]
        else:
            params, state, loss = res[0], res[1], res[2]
        out["losses"].append(float(loss))
        if len(res) == (3 if opt is None else 4):
            out["blocks"].append(_floats(res[-1]))
    out["params"] = tree_to_numpy(params)
    if opt is not None:
        zero = T.lm_update_sharding(mesh) if opt.sharded else None
        out["opt_state"] = canonical_opt_state(state, params, zero)
        out["m_shape"] = tuple(state["m"]["embed"].shape)
    return out


def _inject_slots(slots):
    """Make ``models.word2vec._neg_slots`` return this rank's precomputed
    JAX draws, in call order."""
    import torch

    from deeplearning4j_tpu_torch.models import word2vec as w2v

    queue = list(slots)

    def neg_slots(key, shape, n_slots, device):
        s = queue.pop(0)
        assert tuple(s.shape) == tuple(shape), (s.shape, shape)
        return torch.from_numpy(s.astype("int64")).to(device)

    w2v._neg_slots = neg_slots
    return queue


def _t(a):
    import numpy as np
    import torch

    return torch.from_numpy(np.array(a))


def scenario_w2v_step(inp, mesh):
    """One sharded SGNS (per-pair or shared negatives) or HS step."""
    from deeplearning4j_tpu_torch.models import word2vec as w2v

    rank = mesh.rank
    syn0, syn1 = _t(inp["syn0"]), _t(inp["syn1"])
    if inp["objective"] == "hs":
        step = w2v.make_sharded_hs_step(mesh)
        syn0, syn1, loss = step(syn0, syn1, _t(inp["centers"]),
                                _t(inp["points"]), _t(inp["codes"]),
                                _t(inp["mask"]), _t(inp["weights"]),
                                inp["lr"])
    else:
        left = _inject_slots(inp["slots"][rank])
        step = w2v.make_sharded_sgns_step(mesh, inp["negative"],
                                          inp["neg_group"])
        syn0, syn1, loss = step(syn0, syn1, _t(inp["centers"]),
                                _t(inp["contexts"]), _t(inp["weights"]),
                                _t(inp["neg_table"]), inp["lr"],
                                inp["key"])
        assert not left
    return {"syn0": syn0.numpy(), "syn1": syn1.numpy(), "loss": float(loss)}


def scenario_w2v_fit(inp, mesh):
    """A ``Word2Vec(mesh=...)`` fit on the python tokenizer path, with the
    JAX package's per-shard negatives put in."""
    from deeplearning4j_tpu_torch.models.word2vec import Word2Vec
    from deeplearning4j_tpu_torch.text.sentence_iterator import \
        CollectionSentenceIterator
    from deeplearning4j_tpu_torch.text.tokenization import \
        DefaultTokenizerFactory

    class PythonTokenizer(DefaultTokenizerFactory):
        """A subclass: the vocab builds on the python path."""

    left = _inject_slots(inp["slots"][mesh.rank]) if inp["slots"] else []
    vec = Word2Vec(sentence_iterator=CollectionSentenceIterator(inp["corpus"]),
                   tokenizer_factory=PythonTokenizer(), mesh=mesh, device=CPU,
                   **inp["kwargs"])
    vec.fit()
    assert not left, len(left)
    table = vec.lookup_table
    return {"syn0": table.syn0, "syn1": table.syn1, "syn1neg": table.syn1neg,
            "batch_size": vec.batch_size,
            "n_pairs": vec.last_fit_timings["n_pairs"],
            "n_dispatches": vec.last_fit_timings["n_dispatches"]}


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
