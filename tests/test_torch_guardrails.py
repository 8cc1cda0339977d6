"""The port's guardrails host half (optimize/guardrails.py:
``DivergenceWatchdog``, replay bundles, rollback, and the LM's replay
factory ``models.transformer_lm.lm_replay``) held against the JAX
package's, mirroring tests/test_guardrails.py's ``TestWatchdog`` and
``TestReplayBundles``.

Bundles cross both ways: the port's load in JAX's ``load_replay_bundle``
(and so in ``tools/step_replay.py``, which re-executes them with the
port's factory), JAX's load in the port's. The LM runs on the CPU from
the JAX package's params; the rollback's resumed steps hold to 1e-6 of
each leaf's max, as JAX's test does.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import json
import math
import subprocess
import sys

import jax
import numpy as np
import pytest

from _torch_lm_init import lm_params_np
from deeplearning4j_tpu.optimize import guardrails as jg
from deeplearning4j_tpu_torch.interop import lm_params_from_numpy, \
    tree_to_numpy
from deeplearning4j_tpu_torch.models.transformer_lm import (
    lm_replay,
    make_single_device_train_step,
)
from deeplearning4j_tpu_torch.optimize.guardrails import (
    DivergenceWatchdog,
    dump_replay_bundle,
    load_replay_bundle,
    nonfinite_report,
    tree_all_finite,
)
from deeplearning4j_tpu_torch.scaleout.ckpt import Checkpointer
from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, D, H, E, DFF = 32, 16, 2, 4, 32
B, T = 4, 16
FACTORY = "deeplearning4j_tpu_torch.models.transformer_lm:lm_replay"
FACTORY_KW = json.dumps({"n_heads": H, "attn_impl": "dense",
                         "device": "cpu"})


def _np_params():
    return lm_params_np(0, V, D, H, E, DFF, 2)


def _params():
    return lm_params_from_numpy(_np_params(), "cpu")


def _data(seed=1):
    toks = np.random.RandomState(seed).randint(0, V, (B, T + 1))
    return toks[:, :-1], toks[:, 1:]


def _poison(params, leaf="embed"):
    out = dict(params)
    out[leaf] = params[leaf].clone()
    out[leaf].view(-1)[0] = float("nan")
    return out


def _tree_bits_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return len(la) == len(lb) and all(
        np.asarray(x).tobytes() == np.asarray(y).tobytes()
        for x, y in zip(la, lb))


def _step_replay(path, *args):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "step_replay.py"),
         path, *args], capture_output=True, text=True, timeout=120,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO,
                           OMP_NUM_THREADS="1"))


class TestWatchdog:
    def test_consecutive_skips_declare_divergence(self):
        reg = MetricsRegistry()
        wd = DivergenceWatchdog(registry=reg, max_consecutive_skips=3)
        assert wd.observe(0, 1.0) == "ok"
        assert wd.observe(1, float("nan"), {"nonfinite": 1.0}) == "skipped"
        assert wd.observe(2, float("nan"), {"nonfinite": 1.0}) == "skipped"
        assert wd.observe(3, float("nan"), {"nonfinite": 1.0}) == "diverged"
        assert wd.diverged and "consecutive" in wd.divergence_reason
        assert reg.counter("guard_skipped_steps_total").value == 3
        assert reg.counter("guard_divergence_total").value == 1

    def test_finite_step_resets_the_burst(self):
        wd = DivergenceWatchdog(registry=MetricsRegistry(),
                                max_consecutive_skips=2)
        wd.observe(0, float("nan"), {"nonfinite": 1.0})
        assert wd.observe(1, 1.0) == "ok"
        assert wd.observe(2, float("nan"), {"nonfinite": 1.0}) == "skipped"
        assert not wd.diverged

    def test_ema_spike_declares_divergence(self):
        reg = MetricsRegistry()
        wd = DivergenceWatchdog(registry=reg, spike_factor=5.0,
                                warmup_steps=4)
        for i in range(4):
            assert wd.observe(i, 1.0 + 0.01 * i) == "ok"
        assert wd.observe(4, 3.0) == "ok"
        assert wd.observe(5, 50.0) == "diverged"
        assert "spiked" in wd.divergence_reason
        assert reg.gauge("guard_last_finite_loss").value == 50.0

    def test_clipped_counter_and_registry(self):
        reg = MetricsRegistry()
        wd = DivergenceWatchdog(registry=reg)
        assert wd.observe(0, 1.0, {"clipped": 1.0}) == "clipped"
        assert wd.observe(1, 1.0, {"clipped": 0.0}) == "ok"
        assert reg.counter("guard_clipped_steps_total").value == 1
        assert wd.clipped_steps == 1

    def test_note_checkpoint_tags_only_while_healthy(self, tmp_path):
        ck = Checkpointer(str(tmp_path), registry=MetricsRegistry())
        wd = DivergenceWatchdog(checkpointer=ck,
                                registry=MetricsRegistry(),
                                max_consecutive_skips=5)
        wd.observe(0, 1.0)
        wd.note_checkpoint(1)
        assert ck.last_good_step() == 1
        wd.observe(1, float("nan"), {"nonfinite": 1.0})
        wd.note_checkpoint(2)  # mid-burst: must NOT move the tag
        assert ck.last_good_step() == 1

    def test_verdicts_match_jax_watchdog(self):
        """One stream of losses and guard blocks through both watchdogs:
        the same verdicts and counters."""
        stream = [(1.0, {}), (float("nan"), {"nonfinite": 1.0}),
                  (1.1, {"clipped": 1.0}), (0.9, {}), (1.0, {}),
                  (1.0, {}), (30.0, {}), (float("nan"), {"nonfinite": 1.0}),
                  (float("nan"), {"nonfinite": 1.0})]
        from deeplearning4j_tpu.telemetry.registry import \
            MetricsRegistry as JRegistry

        tw = DivergenceWatchdog(registry=MetricsRegistry(), warmup_steps=3,
                                spike_factor=5.0, max_consecutive_skips=2)
        jw = jg.DivergenceWatchdog(registry=JRegistry(), warmup_steps=3,
                                   spike_factor=5.0,
                                   max_consecutive_skips=2)
        got = [tw.observe(i, loss, gm) for i, (loss, gm) in
               enumerate(stream)]
        want = [jw.observe(i, loss, gm) for i, (loss, gm) in
                enumerate(stream)]
        assert got == want
        assert (tw.skipped_steps, tw.clipped_steps, tw.divergence_reason) \
            == (jw.skipped_steps, jw.clipped_steps, jw.divergence_reason)

    def test_rollback_restores_last_good_with_resume_parity(self, tmp_path):
        """Healthy steps checkpointed, step 2 tagged last_good, params
        poisoned, K skips → diverged, rollback restores the step-2 state
        bitwise, and two resumed steps equal the unguarded twin's within
        1e-6 of each leaf's max."""
        reg = MetricsRegistry()
        ck = Checkpointer(str(tmp_path), keep_last=5, registry=reg)
        wd = DivergenceWatchdog(checkpointer=ck, registry=reg,
                                max_consecutive_skips=2,
                                replay_dir=str(tmp_path / "replay"))
        params = _params()
        tk, tg = _data()
        step = make_single_device_train_step(H, attn_impl="dense",
                                             guard=True, device="cpu")
        for i in range(1, 3):
            params, loss, gm = step(params, tk, tg)
            assert wd.observe(i, loss, gm) == "ok"
            ck.save(i, {"params": params})
            wd.note_checkpoint(i)
        saved = tree_to_numpy(params)
        assert ck.last_good_step() == 2
        params = _poison(params)
        poisoned = tree_to_numpy(params)
        verdict = None
        for i in range(3, 6):
            params, loss, gm = step(params, tk, tg)
            # the skip carries the params bitwise
            assert _tree_bits_equal(tree_to_numpy(params), poisoned)
            verdict = wd.observe(i, loss, gm, params=params,
                                 batch={"tokens": tk, "targets": tg})
            if verdict == "diverged":
                break
        assert verdict == "diverged"
        assert wd.bundles and os.path.exists(wd.bundles[0])
        state, got, _meta = wd.rollback({"params": _params()}, device="cpu")
        assert got == 2
        assert _tree_bits_equal(tree_to_numpy(state["params"]), saved)
        assert reg.counter("guard_rollbacks_total").value == 1
        assert not wd.diverged
        a = state["params"]
        b = lm_params_from_numpy(saved, "cpu")
        ref = make_single_device_train_step(H, attn_impl="dense",
                                            device="cpu")
        for _ in range(2):
            a, la, _ = step(a, tk, tg)
            b, lb = ref(b, tk, tg)
            assert abs(float(la) - float(lb)) <= 1e-6
        for x, y in zip(jax.tree_util.tree_leaves(tree_to_numpy(a)),
                        jax.tree_util.tree_leaves(tree_to_numpy(b))):
            assert float(np.max(np.abs(x - y))) <= \
                1e-6 * float(np.max(np.abs(y)))


class TestReplayBundles:
    def _bundle(self, tmp_path, step=2, poison_batch=True):
        params = _params()
        tk, tg = _data()
        x = np.random.RandomState(0).rand(4, 3).astype(np.float32)
        if poison_batch:
            x[1, 2] = np.nan
        return dump_replay_bundle(
            str(tmp_path), step,
            {"params": params, "batch": {"x": x, "tokens": tk,
                                         "targets": tg}},
            {"worker": "w0", "rng_key": [0, step]}), x

    def test_bundle_roundtrip_and_forensics(self, tmp_path):
        path, x = self._bundle(tmp_path)
        payload, meta = load_replay_bundle(path)
        assert meta["step"] == 2 and meta["worker"] == "w0"
        assert meta["rng_key"] == [0, 2]
        np.testing.assert_array_equal(payload["batch"]["x"], x)
        bad = [e for e in nonfinite_report(payload) if e["nonfinite"]]
        assert [e["path"] for e in bad] == ["['batch']['x']"]
        assert bad[0]["nonfinite"] == 1
        assert not tree_all_finite(payload)
        assert tree_all_finite(payload["params"])

    def test_bundles_load_across_packages(self, tmp_path):
        """A port bundle loads in JAX's loader with the same leaves and
        forensics, and a JAX bundle in the port's."""
        path, _ = self._bundle(tmp_path)
        tp, tmeta = load_replay_bundle(path)
        jp, jmeta = jg.load_replay_bundle(path)
        assert tmeta == jmeta
        assert _tree_bits_equal(tp, jp)
        assert nonfinite_report(tp) == jg.nonfinite_report(jp)
        jpath = jg.dump_replay_bundle(str(tmp_path / "jax"), 4, jp,
                                      {"worker": "j"})
        back, meta = load_replay_bundle(jpath)
        assert meta["worker"] == "j" and meta["step"] == 4
        assert _tree_bits_equal(back, jp)
        with pytest.raises(ValueError, match="structure mismatch"):
            load_replay_bundle(jpath, template={"params": {}})

    def test_step_replay_cli_reproduces_nonfinite(self, tmp_path):
        """``tools/step_replay.py`` with the port's factory re-executes a
        port bundle of poisoned params: the non-finite loss
        reproduces."""
        tk, tg = _data()
        path = dump_replay_bundle(
            str(tmp_path), 7, {"params": _poison(_params()),
                               "batch": {"tokens": tk, "targets": tg}}, {})
        out = _step_replay(path, "--factory", FACTORY, "--kwargs-json",
                           FACTORY_KW, "--expect-nonfinite", "--json")
        assert out.returncode == 0, out.stderr[-800:]
        rep = json.loads(out.stdout)
        assert rep["reproduced"] is True
        assert rep["result"]["loss"] == "nan"
        assert any(e["nonfinite"] for e in rep["forensics"])

    def test_step_replay_cli_clean_bundle_fails_expectation(self, tmp_path):
        tk, tg = _data()
        path = dump_replay_bundle(
            str(tmp_path), 0, {"params": _params(),
                               "batch": {"tokens": tk, "targets": tg}}, {})
        out = _step_replay(path, "--factory", FACTORY, "--kwargs-json",
                           FACTORY_KW, "--expect-nonfinite")
        assert out.returncode == 1

    def test_step_replay_cli_missing_bundle(self, tmp_path):
        out = _step_replay(str(tmp_path / "nope.npz"))
        assert out.returncode == 2

    def test_lm_replay_factory(self, tmp_path):
        """The port's factory reproduces a poisoned-params non-finite loss
        from a JAX bundle, and its clean loss and grad norm equal JAX's
        factory's on the same payload."""
        from deeplearning4j_tpu.models.transformer_lm import \
            lm_replay as j_lm_replay

        tk, tg = _data()
        clean = _np_params()
        poisoned = dict(clean, embed=clean["embed"].copy())
        poisoned["embed"].flat[0] = np.nan
        path = jg.dump_replay_bundle(
            str(tmp_path), 7, {"params": poisoned,
                               "batch": {"tokens": tk, "targets": tg}}, {})
        payload, _ = load_replay_bundle(path)
        run = lm_replay(H, attn_impl="dense", device="cpu")
        assert not math.isfinite(run(payload)["loss"])
        payload = {"params": clean, "batch": {"tokens": tk, "targets": tg}}
        got = run(payload)
        want = j_lm_replay(H, attn_impl="dense")(payload)
        assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
        assert abs(got["grad_norm"] - want["grad_norm"]) <= \
            1e-5 * want["grad_norm"]

    def test_watchdog_bundle_retention(self, tmp_path):
        wd = DivergenceWatchdog(registry=MetricsRegistry(),
                                max_consecutive_skips=100,
                                replay_dir=str(tmp_path), max_bundles=2)
        batch = {"x": np.ones((2, 2), np.float32)}
        for i in range(4):
            wd.observe(i, float("nan"), {"nonfinite": 1.0}, batch=batch)
            wd.observe(100 + i, 1.0)  # close the burst so each skip dumps
        assert len(wd.bundles) == 2
        assert all(os.path.exists(p) for p in wd.bundles)
        assert len(os.listdir(tmp_path)) == 2
