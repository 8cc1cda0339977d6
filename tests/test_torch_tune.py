"""The port's autotuner (deeplearning4j_tpu_torch/tune/) and its ``tuned=``
seams held against the JAX package's: every case of tests/test_tune.py
through the port (its lockwatch fixture aside: the port's cache keeps
plain locks), plus

- the registered spaces equal JAX's, seam, version, knobs and candidates,
  and their validity verdicts match JAX's over each space's product at
  three contexts;
- ``fingerprint`` equal to JAX's over a matrix of contexts, and a cache
  entry JAX's ``TuningCache.store`` wrote is a hit for the port's
  ``lookup`` (and the other way round);
- with the same synthetic ``compile_fn``/``measure_fn`` the port's
  decisions file has JAX's pruning, counts and winner, and
  ``tools/tune_report.py`` reads the port's decisions and cache;
- the seams' cost vectors: every ``flash_attention`` candidate's is equal
  (the kernels' analytic costs do not depend on tiles), so none is
  pruned; the ``serve`` candidates' differ by bucket and slots, and the
  smallest of both prunes the rest;
- ``key_split_for``'s table, and K3f's entry called with split 0 when no
  tiles are given;
- the adoption pins, each against its default and against JAX's from the
  same injected params: single-device tiles within 1e-5 of JAX's step;
  the composed step's ``alltoall_2d`` dispatch bit for bit against the
  port's own default over 4 gloo ranks (tests/_torch_tune_ranks.py,
  started once for the module); the pipeline's ``overlap`` bit for bit;
  the engine's tokens equal to JAX's tuned engine's; and the env gate end
  to end, on a cache JAX's searcher side wrote.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import json
import logging
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parallel_ranks import collect_ranks, spawn_ranks
from deeplearning4j_tpu.models import transformer_lm as JT
from deeplearning4j_tpu.telemetry.xprofile import StepProfile as JProfile
from deeplearning4j_tpu.tune import cache as jcache
from deeplearning4j_tpu.tune.search import search as jax_search
from deeplearning4j_tpu.tune import seams as jseams
from deeplearning4j_tpu.tune import space as jspace
from deeplearning4j_tpu_torch._device import tree_leaves
from deeplearning4j_tpu_torch.interop import (
    lm_params_from_numpy,
    tree_to_numpy,
)
from deeplearning4j_tpu_torch.models import transformer_lm as TT
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry
from deeplearning4j_tpu_torch.telemetry.xprofile import StepProfile
from deeplearning4j_tpu_torch.tune import seams as tseams
from deeplearning4j_tpu_torch.tune.cache import (
    TuningCache,
    fingerprint,
    resolve_step_tuning,
    resolve_tuned,
)
from deeplearning4j_tpu_torch.tune.search import search, spearman
from deeplearning4j_tpu_torch.tune.space import (
    Knob,
    SearchSpace,
    get_space,
    space_names,
    space_version,
)

REPO = Path(__file__).resolve().parent.parent
SCRIPT = Path(__file__).resolve().parent / "_torch_tune_ranks.py"
WORLD = 4
SPAWN_TIMEOUT_S = 240
# the tolerances of tests/test_tune.py: the blockwise tiles reorder sums
# (1e-5, loss and params); the MoE dispatch and the pipeline schedule are
# bitwise; greedy tokens exact
TILE_TOL = 1e-5
CACHE_LOGGER = "deeplearning4j_tpu_torch.tune.cache"


@pytest.fixture(autouse=True)
def _no_ambient_tuning(monkeypatch):
    """Keep every test hermetic: the env gate off, the cache path off any
    real TUNE_CACHE.json."""
    monkeypatch.delenv("DL4J_TPU_TUNED", raising=False)
    monkeypatch.delenv("DL4J_TPU_TUNE_CACHE", raising=False)


# ------------------------------------------------------------- spaces ----

def test_registered_spaces_cover_the_tunable_seams():
    assert set(space_names()) >= {"flash_attention", "moe", "pipeline",
                                  "serve"}
    for seam in space_names():
        space = get_space(seam)
        assert space.size() > 0
        assert isinstance(space_version(seam), int)


def test_flash_space_rejects_non_dividing_and_oversize_blocks():
    space = get_space("flash_attention")
    ctx = {"seq_len": 256}
    valid = [cfg for cfg, reason in space.configs(ctx) if reason is None]
    # exactly the tiles that divide 256 and fit: {64,128,256}^2
    assert len(valid) == 9
    for cfg in valid:
        assert 256 % cfg["block_q"] == 0 and 256 % cfg["block_k"] == 0
    reasons = {json.dumps(cfg, sort_keys=True): reason
               for cfg, reason in space.configs(ctx) if reason}
    assert any("exceeds seq_len" in r for r in reasons.values())


def test_moe_space_applies_the_factorization_predicate():
    space = get_space("moe")
    by_impl = {}
    for cfg, reason in space.configs({"expert_devices": 3}):
        by_impl.setdefault(cfg["moe_impl"], set()).add(reason is None)
    assert by_impl["alltoall_2d"] == {False}
    assert True in by_impl["alltoall"]
    ok = [cfg for cfg, reason in space.configs({"expert_devices": 4})
          if reason is None and cfg["moe_impl"] == "alltoall_2d"]
    assert ok
    for cfg, reason in space.configs({"expert_devices": 1}):
        if cfg["moe_impl"] != "replicated":
            assert reason is not None


def test_pipeline_and_serve_space_validity():
    assert all(reason is None or "does not divide" in reason
               for _, reason in get_space("pipeline").configs({"batch": 8}))
    assert any(reason for _, reason
               in get_space("pipeline").configs({"batch": 6}))
    serve_reasons = [reason for cfg, reason
                     in get_space("serve").configs({"max_len": 16})
                     if cfg["min_bucket"] >= 16]
    assert serve_reasons and all(r for r in serve_reasons)


_VERDICT_CONTEXTS = {
    "flash_attention": ({"seq_len": 256}, {"seq_len": 2048},
                        {"seq_len": 384}),
    "moe": ({"expert_devices": 1}, {"expert_devices": 3},
            {"expert_devices": 8}),
    "pipeline": ({"batch": 8}, {"batch": 6}, {"batch": 4}),
    "serve": ({"max_len": 16}, {"max_len": 2048}, {"max_len": 8}),
}


@pytest.mark.parametrize("seam", sorted(_VERDICT_CONTEXTS))
def test_spaces_and_verdicts_equal_jax(seam):
    mine, theirs = get_space(seam), jspace.get_space(seam)
    assert (mine.seam, mine.version, mine.knobs) == (
        theirs.seam, theirs.version,
        tuple(Knob(k.name, k.candidates) for k in theirs.knobs))
    for ctx in _VERDICT_CONTEXTS[seam]:
        assert list(mine.configs(ctx)) == list(theirs.configs(ctx)), ctx


# ---------------------------------------------------- synthetic search ----

def _profile(flops, nbytes, peak, wire=0.0, cls=StepProfile):
    return cls(label="syn", platform="cpu", flops=flops,
               bytes_accessed=nbytes, peak_bytes=peak,
               collective_wire_bytes=wire, compile_seconds=0.01)


def _syn_space(candidates=(1, 2, 3, 4), validity=None, cls=SearchSpace,
               knob=Knob):
    return cls(seam="synthetic", version=7,
               knobs=(knob("x", tuple(candidates)),), validity=validity)


def _syn_search(search_fn, space, profile_cls, out_dir):
    profiles = {1: (100.0, 100.0, 100), 2: (50.0, 50.0, 50),
                3: (80.0, 80.0, 200)}
    times = {1: 0.010, 2: 0.005}
    compiled, measured = [], []

    def compile_fn(cfg):
        compiled.append(cfg["x"])
        return _profile(*profiles[cfg["x"]], cls=profile_cls)

    def measure_fn(cfg):
        measured.append(cfg["x"])
        return times[cfg["x"]], "same-output"

    res = search_fn(space, {"seq_len": 1}, {"x": 1}, compile_fn,
                    measure_fn, repeats=3, out_dir=str(out_dir))
    return res, compiled, measured


def _four_is_out(cfg, ctx):
    return "four is right out" if cfg["x"] == 4 else None


def test_search_prunes_dominated_without_executing(tmp_path):
    """x=3 is strictly dominated by x=2 in phase 1 and never reaches
    measure_fn; x=4 is invalid and never reaches compile_fn."""
    res, compiled, measured = _syn_search(
        search, _syn_space(validity=_four_is_out), StepProfile, tmp_path)
    assert 4 not in compiled and 3 not in measured and 4 not in measured
    rec3 = next(r for r in res.candidates if r.config == {"x": 3})
    assert rec3.pruned_by == {"x": 2} and rec3.pruned_reason
    assert not rec3.measured
    assert res.winner_config == {"x": 2}
    assert res.tuned_vs_default == pytest.approx(2.0)
    assert res.counts == {"total": 4, "invalid": 1, "profiled": 3,
                          "pruned": 1, "measured": 2}
    assert res.rank_correlation == pytest.approx(1.0)
    rec = json.loads((tmp_path / "tuning_synthetic.json").read_text())
    assert rec["schema"] == "dl4j-tpu-tuning-v1"
    assert rec["space_version"] == 7
    assert any(c["pruned_by"] for c in rec["candidates"])


def test_search_numerics_mismatch_cannot_win():
    times = {1: 0.010, 2: 0.002}

    def measure_fn(cfg):
        return times[cfg["x"]], ("ref" if cfg["x"] == 1 else "DIFFERENT")

    res = search(_syn_space(candidates=(1, 2)), {}, {"x": 1},
                 lambda cfg: None, measure_fn, repeats=3)
    assert res.winner_config == {"x": 1}
    assert res.tuned_vs_default == pytest.approx(1.0)
    rec2 = next(r for r in res.candidates if r.config == {"x": 2})
    assert rec2.measured and rec2.numerics_match is False and not rec2.winner


def test_search_compile_none_keeps_candidate_on_frontier():
    times = {1: 0.010, 2: 0.004}
    res = search(_syn_space(candidates=(1, 2)), {}, {"x": 1},
                 lambda cfg: None, lambda cfg: (times[cfg["x"]], "ok"),
                 repeats=3)
    assert res.counts["profiled"] == 0 and res.counts["pruned"] == 0
    assert res.counts["measured"] == 2
    assert res.winner_config == {"x": 2}


def test_search_injects_missing_default_and_rejects_invalid_default():
    res = search(_syn_space(candidates=(1, 2)), {}, {"x": 99},
                 lambda cfg: None,
                 lambda cfg: (0.01 if cfg["x"] == 99 else 0.02, "ok"),
                 repeats=3)
    assert res.counts["total"] == 3
    assert res.winner_config == {"x": 99}
    with pytest.raises(ValueError, match="default config"):
        search(_syn_space(candidates=(1, 2),
                          validity=lambda cfg, ctx: "no"), {}, {"x": 1},
               lambda cfg: None, lambda cfg: (0.01, "ok"))


def test_spearman_basics():
    assert spearman([1.0, 2.0, 3.0], [10.0, 20.0, 30.0]) == pytest.approx(1.0)
    assert spearman([1.0, 2.0, 3.0], [3.0, 2.0, 1.0]) == pytest.approx(-1.0)
    assert spearman([1.0, 1.0, 1.0], [1.0, 2.0, 3.0]) is None
    assert spearman([1.0], [1.0]) is None


def test_decisions_equal_jax_and_tune_report_reads_them(tmp_path, capsys):
    """The same synthetic search in both packages: the decisions files
    are equal key for key; tools/tune_report.py reads the port's
    directory and its cache."""
    mine, _, _ = _syn_search(search, _syn_space(validity=_four_is_out),
                             StepProfile, tmp_path / "port")
    theirs, _, _ = _syn_search(
        jax_search, _syn_space(validity=_four_is_out,
                                   cls=jspace.SearchSpace, knob=jspace.Knob),
        JProfile, tmp_path / "jax")
    a = json.loads((tmp_path / "port" / "tuning_synthetic.json").read_text())
    b = json.loads((tmp_path / "jax" / "tuning_synthetic.json").read_text())
    # the implied seconds differ by the peaks attribute() assumes (the
    # card's against the TPU's); the decisions do not
    same = ("config", "is_default", "invalid_reason", "profiled",
            "arithmetic_intensity", "pruned_by", "measured",
            "ratio_vs_default", "numerics_match", "winner")
    assert [{k: c[k] for k in same} for c in a.pop("candidates")] == [
        {k: c[k] for k in same} for c in b.pop("candidates")]
    assert a == b
    assert mine.counts == theirs.counts and \
        mine.winner_config == theirs.winner_config
    cache = TuningCache(str(tmp_path / "cache.json"))
    cache.store("serve", _CTX, {"min_bucket": 4, "slots": 8})
    sys.path.insert(0, str(REPO / "tools"))
    import tune_report

    assert tune_report.main([str(tmp_path / "port"), "--cache",
                             cache.path, "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    seam = report["seams"][0]
    assert seam["seam"] == "synthetic" and seam["counts"]["pruned"] == 1
    assert [r["config"] for r in report["cache_entries"]] == [
        {"min_bucket": 4, "slots": 8}]
    assert not report["cache_entries"][0]["stale"]


# -------------------------------------------------------------- cache ----

_CTX = {"kind": "lm", "d_model": 64, "n_heads": 2, "mesh": (2, 4),
        "backend": "cpu"}


def test_fingerprint_is_shape_sensitive_and_order_stable():
    assert fingerprint(_CTX) == fingerprint(dict(reversed(list(
        _CTX.items()))))
    assert fingerprint(_CTX) == fingerprint({**_CTX, "mesh": [2, 4]})
    for key, val in (("d_model", 128), ("mesh", (4, 2)), ("backend", "tpu")):
        assert fingerprint({**_CTX, key: val}) != fingerprint(_CTX)


def test_fingerprints_equal_jax_over_contexts():
    contexts = [_CTX, {**_CTX, "backend": "cuda"}, {"kind": "x"}, {},
                tseams.lm_context(2, 64, 2, 256, 128, 2, 256, 2,
                                  device="cpu"),
                tseams.lm_context(4, 512, 2, 2048, 1024, 4, 2048, 4,
                                  {"data": 2, "expert": 2}, device="cpu"),
                tseams.serve_context({"d_model": 32, "n_layers": 2,
                                      "vocab": 64, "d_ff": 64,
                                      "n_experts": 2}, 2, 64,
                                     device="cpu"),
                {"nested": {"b": [1, (2, 3)], "a": 1.5}, "s": "x"}]
    for ctx in contexts:
        assert fingerprint(ctx) == jcache.fingerprint(ctx), ctx
    # the context builders are JAX's on the CPU, key for key
    assert tseams.lm_context(2, 64, 2, 256, 128, 2, 256, 2,
                             device="cpu") == jseams.lm_context(
        2, 64, 2, 256, 128, 2, 256, 2)
    # the card's contexts name the device type: never JAX's "gpu"
    assert tseams.lm_context(2, 64, 2, 256, 128, 2, 256, 2)[
        "backend"] == "cuda"


def test_cache_files_cross_both_packages(tmp_path):
    """One cache file, either package's store, the other's lookup."""
    path = str(tmp_path / "cache.json")
    jcache.TuningCache(path).store("flash_attention", _CTX,
                                   {"block_q": 64, "block_k": 128})
    mine = TuningCache(path, registry=MetricsRegistry())
    assert mine.lookup("flash_attention", _CTX) == {"block_q": 64,
                                                    "block_k": 128}
    mine.store("serve", _CTX, {"min_bucket": 4, "slots": 8})
    assert jcache.TuningCache(path).lookup("serve", _CTX) == {
        "min_bucket": 4, "slots": 8}
    assert set(mine.entries()) == set(jcache.TuningCache(path).entries())


def test_cache_store_lookup_hit_and_shape_miss(tmp_path):
    cache = TuningCache(str(tmp_path / "cache.json"))
    key = cache.store("flash_attention", _CTX, {"block_q": 64, "block_k": 64})
    assert key == f"flash_attention:{fingerprint(_CTX)}"
    assert cache.lookup("flash_attention", _CTX) == {"block_q": 64,
                                                     "block_k": 64}
    assert cache.lookup("flash_attention", {**_CTX, "d_model": 128}) is None
    assert cache.lookup("flash_attention", {**_CTX, "mesh": (4, 2)}) is None
    assert cache.lookup("flash_attention", {**_CTX, "backend": "tpu"}) is None
    assert cache.lookup("serve", _CTX) is None


def test_corrupt_cache_is_ignored_loudly(tmp_path, caplog):
    path = tmp_path / "cache.json"
    path.write_text("{this is not json", encoding="utf-8")
    cache = TuningCache(str(path), registry=MetricsRegistry())
    with caplog.at_level(logging.WARNING, logger=CACHE_LOGGER):
        assert cache.lookup("flash_attention", _CTX) is None
    assert any("unreadable" in r.message for r in caplog.records)
    path.write_text(json.dumps({"schema": "someone-elses", "entries": {}}),
                    encoding="utf-8")
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger=CACHE_LOGGER):
        assert cache.lookup("flash_attention", _CTX) is None
    assert any("unexpected schema" in r.message for r in caplog.records)
    cache.store("flash_attention", _CTX, {"block_q": 64, "block_k": 64})
    assert cache.lookup("flash_attention", _CTX) is not None


def test_stale_space_version_misses_and_sets_gauge(tmp_path, caplog):
    reg = MetricsRegistry()
    path = tmp_path / "cache.json"
    cache = TuningCache(str(path), registry=reg)
    cache.store("flash_attention", _CTX, {"block_q": 64, "block_k": 64})
    data = json.loads(path.read_text())
    for entry in data["entries"].values():
        entry["space_version"] = 999
    path.write_text(json.dumps(data), encoding="utf-8")
    with caplog.at_level(logging.WARNING, logger=CACHE_LOGGER):
        assert cache.lookup("flash_attention", _CTX) is None
    assert any("stale" in r.message for r in caplog.records)
    # the watchtower signal (alert rule tune_cache_stale fires on > 0)
    assert reg.gauge("tune_cache_stale_entries").value == 1.0
    assert cache.stale_count() == 1


def test_concurrent_store_and_lookup_under_lockwatch(tmp_path):
    """8 threads hammer store+lookup on one cache file: every entry lands
    and the file never tears (JAX runs this under its lockwatch fixture;
    the port's cache keeps plain locks, so the same threads run
    without it)."""
    cache = TuningCache(str(tmp_path / "cache.json"))
    errors = []

    def worker(i):
        try:
            for j in range(5):
                ctx = {**_CTX, "d_model": 64 + i * 10 + j}
                cache.store("flash_attention", ctx,
                            {"block_q": 64, "block_k": 64 * (1 + j % 2)})
                assert cache.lookup("flash_attention", ctx) is not None
                cache.entries()
        except Exception as e:  # surfaced below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert len(cache.entries()) == 40
    data = json.loads((tmp_path / "cache.json").read_text())
    assert len(data["entries"]) == 40


def test_resolve_tuned_precedence(tmp_path, monkeypatch):
    cache = TuningCache(str(tmp_path / "cache.json"))
    cache.store("serve", _CTX, {"min_bucket": 4, "slots": 8})
    assert resolve_tuned({"slots": 2}, "serve", _CTX, cache) == {"slots": 2}
    assert resolve_tuned(False, "serve", _CTX, cache) is None
    assert resolve_tuned(None, "serve", _CTX, cache) is None
    monkeypatch.setenv("DL4J_TPU_TUNED", "1")
    assert resolve_tuned(None, "serve", _CTX, cache) == {"min_bucket": 4,
                                                         "slots": 8}
    monkeypatch.delenv("DL4J_TPU_TUNED")
    assert resolve_tuned(True, "serve", _CTX, cache) == {"min_bucket": 4,
                                                         "slots": 8}
    with pytest.raises(TypeError):
        resolve_tuned(3.14, "serve", _CTX, cache)


def test_resolve_step_tuning_contract(monkeypatch):
    assert resolve_step_tuning({"block_q": 64}, None,
                               ("flash_attention",)) == {"block_q": 64}
    assert resolve_step_tuning(False, _CTX, ("flash_attention",)) == {}
    with pytest.raises(ValueError, match="tune_context"):
        resolve_step_tuning(True, None, ("flash_attention",))
    monkeypatch.setenv("DL4J_TPU_TUNED", "1")
    assert resolve_step_tuning(None, None, ("flash_attention",)) == {}


# ------------------------------------------------ the seams' costs ----

def test_flash_candidates_share_one_cost_vector_and_none_is_pruned():
    """Phase 1 runs each valid candidate once; the kernels' analytic costs
    do not depend on tiles, so no flash candidate dominates another."""
    h = tseams.flash_seam(seq_len=128, n_heads=1, head_dim=16,
                          device="cpu")
    res = search(get_space(h.seam), h.context, h.default_config,
                 h.compile_fn, h.measure_fn, h.outputs_match, repeats=3)
    costs = [json.dumps(r.cost, sort_keys=True) for r in res.candidates
             if r.profiled]
    assert len(costs) == 4 and len(set(costs)) == 1
    assert res.counts == {"total": 25, "invalid": 21, "profiled": 4,
                          "pruned": 0, "measured": 4}
    assert all(r.numerics_match for r in res.candidates if r.measured)
    assert h.context["backend"] == "cpu"


def test_serve_candidates_differ_by_bucket_and_slots_and_prune():
    h = tseams.serve_seam(max_len=32, n_prompts=2, max_new_tokens=2,
                          device="cpu")
    res = search(get_space(h.seam), h.context, h.default_config,
                 h.compile_fn, h.measure_fn, h.outputs_match, repeats=3)
    cost = {(r.config["min_bucket"], r.config["slots"]): r.cost
            for r in res.candidates if r.profiled}
    for b in (4, 8, 16):
        a, c = cost[(b, 2)], cost[(b, 8)]
        assert a["implied_memory_s"] < c["implied_memory_s"]
    assert cost[(4, 2)]["implied_compute_s"] < \
        cost[(16, 2)]["implied_compute_s"]
    assert {json.dumps(r.config, sort_keys=True) for r in res.candidates
            if r.measured} == {'{"min_bucket": 4, "slots": 2}',
                               '{"min_bucket": 8, "slots": 4}'}
    assert res.counts["pruned"] == res.counts["profiled"] - 2
    assert all(r.numerics_match for r in res.candidates if r.measured)


# --------------------------------------------- the flash tiles on K3f ----

def test_key_split_for_table():
    assert fa.key_split_for() == 0
    assert fa.key_split_for(512, None) == 0
    for bq in (None, 64, 1024):
        assert fa.key_split_for(bq, 64) == 1
        for bk in (128, 256, 512, 1024):
            assert fa.key_split_for(bq, bk) == 2
    with pytest.raises(ValueError, match="key_split"):
        fa.flash_attention_fwd(*(torch.zeros(1, 1, 4, 8)
                                 for _ in range(3)), key_split=3)


def _recording_fwd(monkeypatch):
    seen = []
    orig = fa.flash_attention_fwd

    def rec(q, k, v, causal=False, key_split=0):
        seen.append(key_split)
        return orig(q, k, v, causal, key_split=key_split)

    monkeypatch.setattr(fa, "flash_attention_fwd", rec)
    return seen


def test_k3f_takes_split_0_without_tiles(monkeypatch):
    seen = _recording_fwd(monkeypatch)
    q, k, v = (torch.randn(1, 2, 32, 8, generator=torch.Generator()
                           .manual_seed(i)) for i in range(3))
    want = fa.attention_core(q, k, v, causal=True, impl="dense")
    for tiles, split in (((None, None), 0), ((64, 64), 1),
                         ((64, 512), 2)):
        got = fa.attention_core(q, k, v, causal=True, impl="blockwise",
                                block_q=tiles[0], block_k=tiles[1])
        assert seen[-1] == split
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    fa.attention_core(q, k, v, causal=True, impl="flash", block_q=64,
                      block_k=64)
    assert seen[-1] == 0  # as in JAX, the tiles reach "blockwise" only
    # the LM step: no tiles, split 0; tuned tiles, their split per layer
    params = lm_params_from_numpy(_np(_jax_params()), "cpu")
    toks, tgts = _lm_data(2, 16)
    seen.clear()
    TT.make_single_device_train_step(_H, attn_impl="blockwise",
                                     device="cpu")(params, toks, tgts)
    assert seen == [0]
    seen.clear()
    TT.make_single_device_train_step(
        _H, attn_impl="blockwise", tuned={"block_q": 8, "block_k": 64},
        device="cpu")(params, toks, tgts)
    assert seen == [1]


# --------------------------------------- tuned-adoption numerics pins ----

_V, _D, _H, _E, _DFF = 32, 16, 2, 4, 32


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_params(n_layers=1, n_experts=_E):
    """The LM's params as JAX arrays, drawn by the port's init (JAX's own
    costs seconds of compiles) and handed to both packages."""
    return jax.tree_util.tree_map(jnp.asarray, tree_to_numpy(
        TT.init_lm_params(torch.Generator().manual_seed(0), _V, _D, _H,
                          n_experts, _DFF, n_layers=n_layers,
                          device="cpu")))


def _lm_data(b, t, seed=1):
    toks = np.random.RandomState(seed).randint(0, _V, (b, t + 1))
    return toks[:, :-1], toks[:, 1:]


def _max_abs(a, b) -> float:
    return max(float(np.max(np.abs(np.asarray(x, np.float32)
                                   - np.asarray(y, np.float32))))
               for x, y in zip(jax.tree_util.tree_leaves(a),
                               jax.tree_util.tree_leaves(b)))


def test_single_device_tuned_blocks_parity_1e5():
    """tuned={block_q, block_k} on the single-device step: loss AND params
    within 1e-5 of the default over 3 SGD steps, and of JAX's tuned step
    from the same params and tokens."""
    toks, tgts = _lm_data(2, 128)
    jp = _jax_params()
    jstep = JT.make_single_device_train_step(
        _H, attn_impl="blockwise", tuned={"block_q": 64, "block_k": 64})
    default = TT.make_single_device_train_step(_H, attn_impl="blockwise",
                                               device="cpu")
    tuned = TT.make_single_device_train_step(
        _H, attn_impl="blockwise", tuned={"block_q": 64, "block_k": 64},
        device="cpu")
    p_d = p_t = lm_params_from_numpy(_np(jp), "cpu")
    for i in range(3):
        p_d, l_d = default(p_d, toks, tgts)
        p_t, l_t = tuned(p_t, toks, tgts)
        jp, l_j = jstep(jp, jnp.asarray(toks), jnp.asarray(tgts))
        assert abs(float(l_d) - float(l_t)) < TILE_TOL, i
        assert abs(float(l_t) - float(l_j)) < TILE_TOL, i
    assert _max_abs(tree_to_numpy(p_d), tree_to_numpy(p_t)) < TILE_TOL
    assert _max_abs(tree_to_numpy(p_t), _np(jp)) < TILE_TOL


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Four gloo ranks, started once: the composed step on ("expert",) 4
    and the pipeline on ("pipe",) 4, each at its default and tuned."""
    root = tmp_path_factory.mktemp("tune_ranks")
    b, t = 4, 16
    toks = np.random.RandomState(5).randint(0, _V, (b, t + 1))
    rng = np.random.RandomState(3)
    d, n_stages, n_micro, mb = 8, 4, 8, 2
    inputs = {
        "composed": {
            "kind": "tuned_composed", "mesh": (("expert",), (WORLD,)),
            "n_heads": _H, "capacity": b * t, "steps": 2,
            "params": _np(_jax_params()), "tokens": toks[:, :-1],
            "targets": toks[:, 1:],
            "tuned": {"moe_impl": "alltoall_2d", "capacity_factor": 1.0}},
        "pipeline": {
            "kind": "tuned_pipeline", "mesh": (("pipe",), (n_stages,)),
            "steps": 3,
            "stages": {"w": (rng.randn(n_stages, d, d) / np.sqrt(d))
                       .astype(np.float32),
                       "b": np.zeros((n_stages, d), np.float32)},
            "x": rng.randn(n_micro, mb, d).astype(np.float32),
            "tgt": np.tanh(rng.randn(n_micro, mb, d)).astype(np.float32),
            "tuned": {"microbatches": n_micro, "overlap": True}},
    }
    procs = spawn_ranks(root, inputs, WORLD, script=SCRIPT)
    return collect_ranks(root, procs, SPAWN_TIMEOUT_S)


def _bitwise_runs(ranks, name):
    for rank in ranks:
        out = rank[name]
        assert "error" not in out, out.get("error")
        assert out["default"]["losses"] == out["tuned"]["losses"]
        for a, c in zip(jax.tree_util.tree_leaves(out["default"]["params"]),
                        jax.tree_util.tree_leaves(out["tuned"]["params"])):
            assert np.array_equal(a, c)


def test_composed_tuned_alltoall_2d_bitwise(ranks):
    """tuned={moe_impl: alltoall_2d} on the composed step over an
    ("expert",) mesh of 4 gloo ranks: losses and every rank's params bit
    for bit the default step's (capacity_factor 1.0 keeps capacity)."""
    _bitwise_runs(ranks, "composed")


def test_pipeline_tuned_overlap_bitwise(ranks):
    """tuned={overlap: True} through the pipeline factory's seam: loss
    AND every stage's params bit for bit the strict default's."""
    _bitwise_runs(ranks, "pipeline")


def test_engine_tuned_knobs_token_identical():
    """tuned={min_bucket, slots} changes SCHEDULING only: the greedy
    streams equal the default engine's and JAX's tuned engine's, and the
    knobs landed."""
    from deeplearning4j_tpu.serve import DecodeEngine as JEngine
    from deeplearning4j_tpu_torch.serve import DecodeEngine

    jp = _jax_params(n_layers=2, n_experts=2)
    params = lm_params_from_numpy(_np(jp), "cpu")
    rng = np.random.RandomState(11)
    prompts = [list(map(int, rng.randint(0, _V, rng.randint(3, 10))))
               for _ in range(4)]
    knobs = {"min_bucket": 4, "slots": 3}
    eng_d = DecodeEngine(params, _H, n_slots=2, max_len=32,
                         serve_dtype=None, tuned=False, device="cpu")
    eng_t = DecodeEngine(params, _H, n_slots=2, max_len=32,
                         serve_dtype=None, tuned=knobs, device="cpu")
    eng_j = JEngine(jp, _H, n_slots=2, max_len=32, serve_dtype=None,
                    tuned=knobs)
    assert eng_t.n_slots == eng_j.n_slots == 3 and eng_d.n_slots == 2
    assert eng_t._buckets == eng_j._buckets
    for p in prompts:
        got = eng_t.generate(p, max_new_tokens=5)
        assert got == eng_d.generate(p, max_new_tokens=5), p
        assert got == eng_j.generate(p, max_new_tokens=5), p


def test_engine_env_gate_adopts_cached_winner(tmp_path, monkeypatch):
    """End-to-end cache adoption: a winner JAX's cache stored under JAX's
    serve_context of the same params is picked up by the port's engine on
    the CPU through the DL4J_TPU_TUNED env gate: the fingerprint the
    engine builds is the one the searcher stores under."""
    from deeplearning4j_tpu_torch.serve import DecodeEngine

    jp = _jax_params(n_layers=2, n_experts=2)
    params = lm_params_from_numpy(_np(jp), "cpu")
    cache_path = str(tmp_path / "cache.json")
    ctx = jseams.serve_context(JT.lm_dims(jp), _H, 32)
    assert ctx == tseams.serve_context(TT.lm_dims(params), _H, 32,
                                       device="cpu")
    jcache.TuningCache(cache_path).store("serve", ctx,
                                         {"min_bucket": 4, "slots": 5})
    monkeypatch.setenv("DL4J_TPU_TUNE_CACHE", cache_path)
    monkeypatch.setenv("DL4J_TPU_TUNED", "1")
    eng = DecodeEngine(params, _H, n_slots=2, max_len=32, serve_dtype=None,
                       device="cpu")
    assert eng.n_slots == 5 and eng._buckets[0] == 4
    # a different max_len is a different fingerprint -> defaults hold
    eng2 = DecodeEngine(params, _H, n_slots=2, max_len=16,
                        serve_dtype=None, device="cpu")
    assert eng2.n_slots == 2
    # the step factory under the same gate, with its lm context
    lctx = tseams.lm_context(_H, _D, 1, _V, _DFF, _E, 64, 2, device="cpu")
    TuningCache(cache_path).store("flash_attention", lctx,
                                  {"block_q": 64, "block_k": 64})
    seen = _recording_fwd(monkeypatch)
    toks, tgts = _lm_data(2, 64)
    TT.make_single_device_train_step(
        _H, attn_impl="blockwise", tune_context=lctx, device="cpu")(
        lm_params_from_numpy(_np(_jax_params()), "cpu"), toks, tgts)
    assert seen == [1]
