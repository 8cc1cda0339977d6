"""The port's decode engine (deeplearning4j_tpu_torch/serve/engine.py) and
serve_dtype seam held against the JAX package's, on the CPU.

Greedy decode at ``serve_dtype=None`` (f32) is the parity path: the port's
engine must emit exactly the JAX engine's tokens for every attention core,
with more requests than slots so slots are evicted and readmitted. The JAX
library TPU kernel does not run on the CPU, so the port's "flash" is held
against JAX's "blockwise", the same function. Where a token differs, the
assertion reports the smallest top-2 logit margin of the JAX prefill, so a
near-tie is named instead of hidden.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_lm_init import lm_params_np
from deeplearning4j_tpu.serve.engine import DecodeEngine as JaxEngine
from deeplearning4j_tpu.serve.quant import QuantTensor as JQuantTensor
from deeplearning4j_tpu.serve.quant import (
    params_nbytes as j_params_nbytes,
    prepare_serve_params as j_prepare,
)
from deeplearning4j_tpu.telemetry.registry import (
    MetricsRegistry as JaxRegistry,
)
from deeplearning4j_tpu_torch.interop import lm_params_from_numpy
from deeplearning4j_tpu_torch.serve import (
    DecodeEngine,
    QuantTensor,
    dequantize_tree,
    params_nbytes,
    prepare_serve_params,
)
from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

REPO = Path(__file__).resolve().parent.parent
V, D, H, E, DFF, L = 61, 16, 2, 4, 32, 2
MAXLEN = 32
MAX_NEW = 6


@pytest.fixture(scope="module")
def np_params():
    return lm_params_np(0, V, D, H, E, DFF, L)


def _prompts(n, seed=2, lo=3, hi=12):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, V, rng.randint(lo, hi))))
            for _ in range(n)]


_JAX_RUNS = {}


def _jax_tokens(np_params, attn_impl):
    """The JAX engine's greedy tokens for the 3 prompts through 2 slots
    (cached per core: "flash" maps to JAX's "blockwise")."""
    jimpl = "blockwise" if attn_impl == "flash" else attn_impl
    if jimpl not in _JAX_RUNS:
        params = jax.tree_util.tree_map(jnp.asarray, np_params)
        eng = JaxEngine(params, H, n_slots=2, max_len=MAXLEN,
                        serve_dtype=None, attn_impl=jimpl,
                        registry=JaxRegistry())
        reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in _prompts(3)]
        eng.run_until_idle()
        _JAX_RUNS[jimpl] = ([r.generated for r in reqs], eng)
    return _JAX_RUNS[jimpl]


def _port_engine(np_params, **kw):
    kw.setdefault("registry", MetricsRegistry())
    return DecodeEngine(lm_params_from_numpy(np_params, "cpu"), H,
                        n_slots=2, max_len=MAXLEN, device="cpu", **kw)


def _prefill_margin(np_params, prompt):
    """Smallest top-2 gap of the JAX prefill logits over the prompt."""
    from deeplearning4j_tpu.models.transformer_lm import lm_prefill

    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    logits = np.asarray(lm_prefill(params, jnp.asarray([prompt]), H)[0][0])
    top = np.sort(logits, -1)
    return float((top[:, -1] - top[:, -2]).min())


@pytest.mark.parametrize("attn_impl", [None, "dense", "blockwise", "flash"])
def test_greedy_tokens_identical_to_jax_engine(np_params, attn_impl):
    want, _ = _jax_tokens(np_params, attn_impl)
    eng = _port_engine(np_params, serve_dtype=None, attn_impl=attn_impl)
    prompts = _prompts(3)
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    eng.run_until_idle()
    assert all(r.done.is_set() for r in reqs)
    for p, r, w in zip(prompts, reqs, want):
        assert r.generated == w, (
            p, r.generated, w,
            f"smallest top-2 prefill margin {_prefill_margin(np_params, p)}")
    # 3 requests through 2 slots: a slot was freed and readmitted
    assert eng.stats()["requests_total"] == 3
    assert all(r.finish_reason == "max_new_tokens" for r in reqs)


def test_stats_and_metrics_keys_match_jax(np_params):
    _, jeng = _jax_tokens(np_params, None)
    eng = _port_engine(np_params, serve_dtype=None)
    for p in _prompts(3):
        eng.submit(p, max_new_tokens=MAX_NEW)
    eng.run_until_idle()
    mine, theirs = eng.stats(), jeng.stats()
    assert set(mine) == set(theirs)
    assert mine["model"] == theirs["model"]
    for key in ("slots", "max_len", "serve_dtype", "weight_bytes",
                "prefill_buckets", "requests_total", "tokens_total",
                "decode_steps", "prefill_chunk", "chunking_slots",
                "prefix_cache", "speculative"):
        assert mine[key] == theirs[key], key
    mrec, jrec = eng.metrics_record(), jeng.metrics_record()
    assert set(mrec) == set(jrec)
    for key in ("serve_requests_total", "serve_tokens_total",
                "serve_prefill_dispatches_total", "serve_completed_total",
                "serve_decode_step_ms_count", "serve_prefill_ms_count"):
        assert mrec[key] == jrec[key], key


def test_int8_quantization_bit_identical_to_jax(np_params):
    jq = j_prepare(jax.tree_util.tree_map(jnp.asarray, np_params), "int8")
    tq = prepare_serve_params(lm_params_from_numpy(np_params, "cpu"),
                              "int8")
    jleaves = jax.tree_util.tree_leaves_with_path(
        jq, is_leaf=lambda x: isinstance(x, JQuantTensor))
    assert len(jleaves) == 16
    for path, jleaf in jleaves:
        tleaf = tq
        for key in path:
            tleaf = tleaf[key.key]
        if isinstance(jleaf, JQuantTensor):
            assert isinstance(tleaf, QuantTensor), path
            assert tleaf.q.dtype == torch.int8
            np.testing.assert_array_equal(tleaf.q.numpy(),
                                          np.asarray(jleaf.q))
            np.testing.assert_array_equal(tleaf.scale.numpy(),
                                          np.asarray(jleaf.scale))
            np.testing.assert_array_equal(
                tleaf.dequantize().float().numpy(),
                np.asarray(jleaf.dequantize().astype(jnp.float32)))
        else:
            assert tleaf.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(
                tleaf.float().numpy(), np.asarray(jleaf.astype(jnp.float32)))
    assert params_nbytes(tq) == j_params_nbytes(jq)
    deq = dequantize_tree(tq)
    assert deq["embed"].dtype == torch.bfloat16
    with pytest.raises(ValueError):
        prepare_serve_params(tq, "fp8")


@pytest.mark.parametrize("serve_dtype", ["bf16", "int8"])
def test_reduced_precision_engine_serves(np_params, serve_dtype):
    """bf16 and int8 engines serve every request with in-range tokens and
    the cache at bf16; greedy streams are deterministic."""
    outs = []
    for _ in range(2):
        eng = _port_engine(np_params, serve_dtype=serve_dtype)
        reqs = [eng.submit(p, max_new_tokens=4) for p in _prompts(3)]
        eng.run_until_idle()
        assert eng._cache["k"].dtype == torch.bfloat16
        assert all(len(r.generated) == 4 for r in reqs)
        assert all(0 <= t < V for r in reqs for t in r.generated)
        outs.append([r.generated for r in reqs])
    assert outs[0] == outs[1]


def test_sampling_and_greedy_share_a_step(np_params):
    """Sampling slots draw from the engine's seeded generator (same seed,
    same draws); greedy slots in the same decode step stay greedy."""
    def run(seed):
        eng = _port_engine(np_params, serve_dtype=None, seed=seed)
        hot = eng.submit(_prompts(1, seed=5)[0], max_new_tokens=8,
                         temperature=1.0)
        cold = eng.submit(_prompts(3)[0], max_new_tokens=MAX_NEW)
        eng.run_until_idle()
        return hot.generated, cold.generated

    want_cold = _jax_tokens(np_params, None)[0][0]
    hot_a, cold_a = run(7)
    hot_b, cold_b = run(7)
    assert hot_a == hot_b and len(hot_a) == 8
    assert all(0 <= t < V for t in hot_a)
    assert cold_a == cold_b == want_cold


def test_eos_and_max_len_retire(np_params):
    eng = _port_engine(np_params, serve_dtype=None)
    prompt = _prompts(1)[0]
    first = eng.generate(prompt, max_new_tokens=3)
    r = eng.submit(prompt, max_new_tokens=3, eos_id=first[-1])
    eng.run_until_idle()
    assert r.finish_reason == "eos"
    assert r.generated == first[:first.index(first[-1])]
    long = eng.submit(list(range(MAXLEN - 2)), max_new_tokens=50)
    eng.run_until_idle()
    # prefill fills 30 positions and samples 1; decode writes positions 30
    # and 31, each yielding one more token: the page holds max_len
    assert long.finish_reason == "max_len" and len(long.generated) == 3
    with pytest.raises(ValueError):
        eng.submit(list(range(MAXLEN)))
    with pytest.raises(ValueError):
        eng.submit([V])


def test_background_loop_serves_threads(np_params):
    eng = _port_engine(np_params, serve_dtype=None)
    eng.start()
    try:
        got = eng.generate(_prompts(3)[0], max_new_tokens=MAX_NEW,
                           timeout=60)
    finally:
        eng.stop()
    assert got == _jax_tokens(np_params, None)[0][0]
    assert eng._thread is None


def test_engine_without_device_raises_when_cuda_absent(np_params):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    tp = lm_params_from_numpy(np_params, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(tp, H, n_slots=2, max_len=MAXLEN)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Importing every module of the port leaves ``jax`` and
    ``deeplearning4j_tpu`` out of ``sys.modules``. In a subprocess: this
    test process already imported both (tests/conftest.py)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import deeplearning4j_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'deeplearning4j_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'deeplearning4j_tpu' or "
        "m.startswith('deeplearning4j_tpu.'))\n"
        "assert len(names) >= 120, names\n"
        "for m in ('optimize.guardrails', 'optimize.updaters', "
        "'telemetry.metrics', 'text.vocab', 'native.lib', "
        "'models.word2vec', 'models.rntn', 'nn.tree', 'text.corpora.treeparser', "
        "'parallel.trainer', 'parallel.multihost', 'utils.counter', "
        "'scaleout.runner', 'scaleout.checkpoint', 'scaleout.nlp_perform', "
        "'scaleout.iterative_reduce', 'scaleout.statetracker', "
        "'utils.netwatch', 'scaleout.remote_tracker', "
        "'scaleout.distributed_runner', 'scaleout.provision', "
        "'telemetry.federation', 'serve.router', 'serve.fleet', "
        "'parallel.mesh', 'parallel.moe', 'parallel.ring_attention', "
        "'parallel.pipeline', 'scaleout.elastic', 'telemetry.step_log', "
        "'telemetry.prometheus', 'telemetry.history', 'telemetry.alerts'):\n"
        "    assert 'deeplearning4j_tpu_torch.' + m in names, m\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
