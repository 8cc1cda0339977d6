"""The port's ``DecodeEngine.from_checkpoint`` and ``from_live_params``
held against the JAX package's, on the CPU.

Greedy decode at ``serve_dtype="f32"`` is the parity path (as in
tests/test_torch_serve.py): an engine built from a checkpoint, by either
package, must emit exactly the JAX engine's tokens from the same
checkpoint, with more requests than slots.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.models.transformer_lm import (
    init_lm_params as j_init_lm_params,
    lm_checkpoint_meta as j_lm_checkpoint_meta,
)
from deeplearning4j_tpu.scaleout.ckpt.checkpointer import (
    Checkpointer as JCheckpointer,
)
from deeplearning4j_tpu.serve.engine import DecodeEngine as JaxEngine
from deeplearning4j_tpu.telemetry.registry import (
    MetricsRegistry as JRegistry,
)
from deeplearning4j_tpu_torch.interop import lm_params_from_numpy
from deeplearning4j_tpu_torch.models.transformer_lm import (
    lm_checkpoint_meta,
)
from deeplearning4j_tpu_torch.scaleout.ckpt import Checkpointer
from deeplearning4j_tpu_torch.serve import DecodeEngine
from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

V, D, H, E, DFF, L = 61, 16, 2, 4, 32, 2
MAXLEN, MAX_NEW = 32, 6


@pytest.fixture(scope="module")
def jparams():
    return j_init_lm_params(jax.random.PRNGKey(0), V, D, H, E, DFF,
                            n_layers=L)


@pytest.fixture(scope="module")
def tparams(jparams):
    return lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")


def _prompts(n=5, seed=4):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, V, rng.randint(3, 12))))
            for _ in range(n)]


def _run(engine):
    reqs = [engine.submit(p, max_new_tokens=MAX_NEW) for p in _prompts()]
    engine.run_until_idle()
    return [r.generated for r in reqs]


def _knobs(registry):
    return dict(n_slots=2, max_len=MAXLEN, serve_dtype="f32",
                registry=registry)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_from_checkpoint_tokens_equal_jax(jparams, tparams, tmp_path,
                                          writer):
    root = str(tmp_path / writer)
    if writer == "jax":
        JCheckpointer(root, registry=JRegistry()).save(
            7, {"params": jparams}, meta=j_lm_checkpoint_meta(jparams, H))
    else:
        Checkpointer(root, registry=MetricsRegistry()).save(
            7, {"params": tparams}, meta=lm_checkpoint_meta(tparams, H))
    want = _run(JaxEngine.from_checkpoint(root, **_knobs(JRegistry())))
    eng = DecodeEngine.from_checkpoint(root, device="cpu",
                                       **_knobs(MetricsRegistry()))
    assert _run(eng) == want
    assert eng.weight_version == "ckpt-step-7"
    assert eng.stats()["weight_version"] == "ckpt-step-7"
    assert eng.device.type == "cpu" and eng.n_heads == H


def test_from_checkpoint_takes_top_k_and_a_step(jparams, tmp_path):
    root = str(tmp_path)
    ck = JCheckpointer(root, registry=JRegistry())
    ck.save(1, jparams, meta=j_lm_checkpoint_meta(jparams, H, top_k=1))
    ck.save(2, {"params": jparams}, meta=j_lm_checkpoint_meta(jparams, H))
    eng = DecodeEngine.from_checkpoint(root, step=1, device="cpu",
                                       **_knobs(MetricsRegistry()))
    jeng = JaxEngine.from_checkpoint(root, step=1, **_knobs(JRegistry()))
    assert eng.top_k == jeng.top_k == 1  # an unwrapped tree, meta's top_k
    assert eng.weight_version == jeng.weight_version == "ckpt-step-1"
    assert _run(eng) == _run(jeng)
    latest = DecodeEngine.from_checkpoint(root, device="cpu", top_k=1,
                                          **_knobs(MetricsRegistry()))
    assert latest.weight_version == "ckpt-step-2" and latest.top_k == 1


def test_from_checkpoint_errors_match_jax(jparams, tmp_path):
    bare = str(tmp_path / "bare")
    JCheckpointer(bare, registry=JRegistry()).save(1, {"params": jparams})
    for engine, kw in ((DecodeEngine, {"device": "cpu"}), (JaxEngine, {})):
        with pytest.raises(ValueError, match="n_heads"):
            engine.from_checkpoint(bare, **kw)
    eng = DecodeEngine.from_checkpoint(bare, n_heads=H, device="cpu",
                                       **_knobs(MetricsRegistry()))
    assert _run(eng) == _run(JaxEngine.from_checkpoint(
        bare, n_heads=H, **_knobs(JRegistry())))
    other = str(tmp_path / "other")
    JCheckpointer(other, registry=JRegistry()).save(
        1, {"params": {"W": np.ones((2, 2), np.float32)}})
    for engine, kw in ((DecodeEngine, {"device": "cpu"}), (JaxEngine, {})):
        with pytest.raises(ValueError, match="not a flagship-LM params tree"):
            engine.from_checkpoint(other, n_heads=H, **kw)
        with pytest.raises(FileNotFoundError, match="no committed"):
            engine.from_checkpoint(str(tmp_path / "none"), **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DecodeEngine.from_checkpoint(bare, n_heads=H)


def test_from_live_params_equals_a_direct_engine(tparams):
    direct = DecodeEngine(tparams, H, device="cpu",
                          **_knobs(MetricsRegistry()))
    live = DecodeEngine.from_live_params(tparams, H, device="cpu",
                                         **_knobs(MetricsRegistry()))
    assert live.weight_version == "live-params"
    assert all(t.device.type == "cpu"
               for t in jax.tree_util.tree_leaves(
                   live.params,
                   is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert _run(live) == _run(direct)
    pinned = DecodeEngine.from_live_params(tparams, H, device="cpu",
                                           weight_version="v3",
                                           **_knobs(MetricsRegistry()))
    assert pinned.weight_version == "v3"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DecodeEngine.from_live_params(tparams, H)
