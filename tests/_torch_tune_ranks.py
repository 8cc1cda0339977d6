"""One rank of the autotuner's multi-process adoption pins: the composed
LM step and the pipeline step, each built twice from the same inputs, at
its default and through ``tuned=``.

Run as ``python tests/_torch_tune_ranks.py RANK WORLD PORT IN OUT``,
started by ``_torch_parallel_ranks.spawn_ranks(..., script=SCRIPT)``; the
scenario runner is ``_torch_composed_ranks.main``. It imports torch and
the port only; tests/test_torch_tune.py compares the two runs of every
rank bit for bit.
"""

from __future__ import annotations

import sys

import _torch_composed_ranks as base
from deeplearning4j_tpu_torch.interop import tree_to_numpy

CPU = "cpu"


def scenario_tuned_composed(inp, mesh):
    """make_composed_train_step (SGD) at its default and with
    ``tuned=inp["tuned"]``: each run's losses and this rank's params."""
    from deeplearning4j_tpu_torch.models import transformer_lm as T

    full = base.lm_params_from_numpy(inp["params"], CPU)
    tk, tg = T.shard_lm_batch(inp["tokens"], inp["targets"], mesh,
                              device=CPU)
    out = {}
    for name, tuned in (("default", None), ("tuned", inp["tuned"])):
        step = T.make_composed_train_step(mesh, inp["n_heads"],
                                          inp["capacity"], tuned=tuned,
                                          device=CPU)
        params = T.shard_lm_params(full, mesh, device=CPU)
        losses = []
        for _ in range(inp["steps"]):
            params, loss = step(params, tk, tg)
            losses.append(float(loss))
        out[name] = {"losses": losses, "params": tree_to_numpy(params)}
    return out


def scenario_tuned_pipeline(inp, mesh):
    """make_pipeline_train_step at its strict default and with
    ``tuned=inp["tuned"]`` (the overlapped schedule): each run's losses
    and this rank's stage params."""
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        make_pipeline_train_step,
        shard_stage_params,
    )

    x, tgt = base._t(inp["x"]), base._t(inp["tgt"])
    out = {}
    for name, tuned in (("default", None), ("tuned", inp["tuned"])):
        step = make_pipeline_train_step(
            base._stage_fn, lambda a, b: ((a - b) ** 2).mean(), mesh,
            lr=0.2, tuned=tuned)
        params = shard_stage_params(
            {k: base._t(v) for k, v in inp["stages"].items()}, mesh)
        losses = []
        for _ in range(inp["steps"]):
            params, loss = step(params, x, tgt)
            losses.append(float(loss))
        out[name] = {"losses": losses, "params": tree_to_numpy(params)}
    return out


base.SCENARIOS.update({name[len("scenario_"):]: fn for name, fn in
                       list(globals().items())
                       if name.startswith("scenario_")})

if __name__ == "__main__":
    sys.exit(base.main(sys.argv[1:]))
