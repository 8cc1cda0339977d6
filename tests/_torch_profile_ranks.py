"""One rank of the step profile's multi-process checks: the collectives a
profiled step records on a mesh of gloo ranks.

Run as ``python tests/_torch_profile_ranks.py RANK WORLD PORT IN OUT``,
started by ``_torch_parallel_ranks.spawn_ranks(..., script=SCRIPT)``; the
scenario runner is ``_torch_composed_ranks.main``. Each scenario runs one
step twice from the same inputs, unwrapped and with ``profile=True`` (and
``runprof=``), and returns whether the two outputs are equal
(``torch.equal``), the profile's dict and the runtime profiler's timings.
It imports torch and the port only.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import _torch_composed_ranks as base
from deeplearning4j_tpu_torch._device import tree_leaves, tree_map

CPU = "cpu"


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def _twice(make, args_fn):
    """(unwrapped outputs == profiled outputs, profile dict, timings)."""
    from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry
    from deeplearning4j_tpu_torch.telemetry.runprof import RunProfiler

    plain = make(None, None)(*args_fn())
    prof = RunProfiler(registry=MetricsRegistry(), update_every=1)
    step = make(True, prof)
    got = step(*args_fn())
    timings = [t.to_dict() for t in prof.timings(step.label)]
    return {"equal": _equal(plain, got),
            "profile": step.step_profile.to_dict(), "timings": timings}


def scenario_profiled_trainer(inp, mesh):
    """make_sync_train_step on an MLP: the profile of one step and the
    bytes its fused all-reduce carries (grads, loss sum, weight sum)."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn import functional as F
    from deeplearning4j_tpu_torch.parallel.trainer import \
        make_sync_train_step

    conf = (NeuralNetConfiguration.Builder()
            .n_in(4).n_out(8).activation_function("tanh")
            .lr(0.1).momentum(0.9).num_iterations(1).seed(42)
            .list(2)
            .override(1, layer_type="OUTPUT", n_in=8, n_out=3,
                      activation_function="softmax", loss_function="MCXENT")
            .pretrain(False).backward(True).build())
    params = F.init_params(conf, 0, device=CPU)
    states = F.init_train_state(conf, params)
    rng = np.random.RandomState(0)
    x = rng.rand(16, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 16)]
    w = np.ones(16, np.float32)

    def args():
        return (tree_map(lambda _, v: v.clone(), params), states, 0, x, y,
                w, 3)

    out = _twice(lambda profile, runprof: make_sync_train_step(
        conf, mesh, profile=profile, runprof=runprof), args)
    out["reduced_bytes"] = 4 * (sum(t.numel() for t in tree_leaves(params))
                                + 2)
    return out


def scenario_profiled_composed(inp, mesh):
    """make_composed_train_step (SGD) from the same params twice."""
    from deeplearning4j_tpu_torch.models import transformer_lm as T

    def make(profile, runprof):
        return T.make_composed_train_step(
            mesh, inp["n_heads"], inp["capacity"], lr=0.1,
            attn_impl=inp.get("attn_impl"), moe_impl=inp.get("moe_impl"),
            profile=profile, runprof=runprof, device=CPU)

    full = base.lm_params_from_numpy(inp["params"], CPU)
    tk, tg = T.shard_lm_batch(inp["tokens"], inp["targets"], mesh,
                              device=CPU)
    return _twice(make, lambda: (T.shard_lm_params(full, mesh, device=CPU),
                                 tk, tg))


def scenario_profiled_pipeline(inp, mesh):
    """make_pipeline_train_step over ("data", "pipe") from the same stage
    params twice."""
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        make_pipeline_train_step,
        shard_stage_params,
    )

    x, tgt = base._t(inp["x"]), base._t(inp["tgt"])

    def make(profile, runprof):
        return make_pipeline_train_step(
            base._stage_fn, lambda a, b: ((a - b) ** 2).mean(), mesh,
            lr=0.2, batch_axis=inp.get("batch_axis"), profile=profile,
            runprof=runprof)

    return _twice(make, lambda: (shard_stage_params(
        {k: base._t(v) for k, v in inp["stages"].items()}, mesh), x, tgt))


base.SCENARIOS.update({name[len("scenario_"):]: fn for name, fn in
                       list(globals().items())
                       if name.startswith("scenario_")})

if __name__ == "__main__":
    sys.exit(base.main(sys.argv[1:]))
