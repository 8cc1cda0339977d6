"""The port's runtime profiler (deeplearning4j_tpu_torch/telemetry/runprof.py):
the ``runprof=`` seam and its env knob, phase timings and streaming gauges
on real steps, arm-time gauges (``runprof_measured_mfu`` unborn until a
profiled step supplies FLOPs), the DecodeEngine's decode ticks, the
measured-MFU cross-check against the wall, sessions (write-ahead JSONL,
a killed writer's torn tail), and the session readers held against the
JAX package's on the same records and files, both ways.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import glob
import json
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest

from _torch_lm_init import lm_params_np
from deeplearning4j_tpu.telemetry import runprof as jrp
from deeplearning4j_tpu_torch._device import tree_leaves
from deeplearning4j_tpu_torch.interop import lm_params_from_numpy
from deeplearning4j_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    flat_record,
)
from deeplearning4j_tpu_torch.telemetry.runprof import (
    _ARM_GAUGES,
    SCHEMA,
    RunProfiledStep,
    RunProfiler,
    StepTiming,
    chrome_trace_events,
    find_sessions,
    load_session,
    maybe_runprof,
    resolve_runprof,
    set_runprof,
    summarize_session,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, D, H, E, FF = 64, 32, 2, 2, 64


def _timing(label="s", wall=2.0, host=0.1, dispatch=0.5, device=1.5,
            flops=None, t_unix=None, trace_id=None):
    return StepTiming(label=label, t_unix=time.time() if t_unix is None
                      else t_unix, wall_ms=wall, host_ms=host,
                      dispatch_ms=dispatch, device_ms=device,
                      flops=flops, trace_id=trace_id)


def _registry_names(registry, prefix="runprof_"):
    snap = registry.snapshot()
    return {r["name"] for kind in ("counters", "gauges", "histograms")
            for r in snap[kind] if r["name"].startswith(prefix)}


def _lm_params(layers=1):
    return lm_params_from_numpy(lm_params_np(0, V, D, H, E, FF, layers),
                                "cpu")


def _tokens(b=8, t=32, seed=1):
    toks = np.random.RandomState(seed).randint(0, V, (b, t + 1))
    return toks[:, :-1], toks[:, 1:]


@pytest.fixture
def clean_default(monkeypatch):
    """Isolate the process-default profiler and the env knob."""
    monkeypatch.delenv("DL4J_TPU_RUNPROF", raising=False)
    monkeypatch.delenv("DL4J_TPU_RUNPROF_DIR", raising=False)
    set_runprof(None)
    yield monkeypatch
    set_runprof(None)


# ------------------------------------------------------------- seam resolution ----

class TestSeamResolution:
    def test_default_off_without_env(self, clean_default):
        assert resolve_runprof(None) is None
        fn = lambda x: x  # noqa: E731
        assert maybe_runprof(fn, None, "lbl") is fn

    def test_env_knob_arms_the_default(self, clean_default):
        clean_default.setenv("DL4J_TPU_RUNPROF", "1")
        prof = resolve_runprof(None)
        assert isinstance(prof, RunProfiler)
        assert prof is resolve_runprof(None)
        assert not prof.session_active

    def test_env_off_spellings(self, clean_default):
        for off in ("0", "false", "off", "no", ""):
            clean_default.setenv("DL4J_TPU_RUNPROF", off)
            assert resolve_runprof(None) is None, off

    def test_false_always_opts_out(self, clean_default):
        clean_default.setenv("DL4J_TPU_RUNPROF", "1")
        assert resolve_runprof(False) is None
        fn = lambda x: x  # noqa: E731
        assert maybe_runprof(fn, False, "lbl") is fn

    def test_explicit_profiler_used_as_is(self, clean_default):
        prof = RunProfiler(registry=MetricsRegistry())
        assert resolve_runprof(prof) is prof
        step = maybe_runprof(lambda x: x, "mine", "lbl")
        assert isinstance(step, RunProfiledStep) and step.label == "mine"

    def test_env_auto_session(self, clean_default, tmp_path):
        clean_default.setenv("DL4J_TPU_RUNPROF", "5")
        clean_default.setenv("DL4J_TPU_RUNPROF_DIR", str(tmp_path))
        prof = resolve_runprof(None)
        assert prof.session_active
        for _ in range(5):
            prof.record(_timing())
        assert not prof.session_active
        assert len(prof.sessions_completed) == 1
        assert prof.sessions_completed[0].startswith(str(tmp_path))

    def test_env_knob_arms_the_lm_step(self, clean_default):
        from deeplearning4j_tpu_torch.models import transformer_lm as TT

        clean_default.setenv("DL4J_TPU_RUNPROF", "1")
        step = TT.make_single_device_train_step(H, device="cpu")
        assert isinstance(step, RunProfiledStep)
        assert step.label == "lm_single_device"
        assert not isinstance(TT.make_single_device_train_step(
            H, device="cpu", runprof=False), RunProfiledStep)


# ------------------------------------------------- phase timings on a real step ----

class TestPhaseTimings:
    def test_profiled_step_phases_and_gauges(self):
        """RunProfiledStep on a real step: phases measured, gauges
        streamed, FLOPs from the composed ProfiledStep. On the CPU the
        host is the device: device_ms is the call's wall."""
        reg = MetricsRegistry()
        prof = RunProfiler(registry=reg, update_every=2)
        step = RunProfiledStep(lambda x: (x @ x).sum(), label="unit",
                               profiler=prof)
        x = torch.ones((32, 32))
        for _ in range(4):
            step(x)
        timings = prof.timings("unit")
        assert len(timings) == 4
        for t in timings:
            assert t.wall_ms >= t.device_ms >= 0.0
            assert t.device_ms == t.dispatch_ms
            assert t.flops == 2 * 32 ** 3
        assert timings[0].host_ms == 0.0
        assert all(t.host_ms > 0.0 for t in timings[1:])
        flat = flat_record(reg, prefixes=("runprof_",))
        assert flat["runprof_steps_total"] == 4.0
        assert flat["runprof_step_ms"] > 0.0
        assert flat["runprof_steps_per_s"] > 0.0
        assert 0.0 <= flat["runprof_host_fraction"] <= 1.0
        assert flat["runprof_measured_mfu"] > 0.0

    def test_step_profile_passthrough_and_no_double_wrap(self):
        from deeplearning4j_tpu_torch.telemetry.xprofile import ProfiledStep

        prof = RunProfiler(registry=MetricsRegistry())
        inner = ProfiledStep(lambda x: x + 1, label="p")
        step = RunProfiledStep(inner, label="p", profiler=prof)
        assert step._fn is inner
        step(torch.ones((2,)))
        assert step.step_profile is inner.step_profile is not None
        assert step.step_profile.flops == 0.0

    def test_input_wait_hook_feeds_fraction_gauge(self):
        reg = MetricsRegistry()
        prof = RunProfiler(registry=reg, update_every=2)
        prof.note_input_wait(0.010, "loader")
        prof.record(_timing(label="loader", wall=10.0, host=1.0))
        prof.record(_timing(label="loader", wall=10.0, host=1.0))
        assert prof.timings("loader")[0].input_wait_ms == pytest.approx(10.0)
        flat = flat_record(reg, prefixes=("runprof_",))
        assert flat["runprof_input_wait_fraction"] > 0.0

    def test_armed_lm_step_changes_no_output(self):
        from deeplearning4j_tpu_torch.models import transformer_lm as TT

        params = _lm_params()
        x, y = _tokens()
        prof = RunProfiler(registry=MetricsRegistry(), update_every=1)
        plain = TT.make_single_device_train_step(H, device="cpu")
        armed = TT.make_single_device_train_step(H, device="cpu",
                                                 profile="lm_p",
                                                 runprof=prof)
        # a profile= string names the profile; the timings keep the
        # builder's label, as in JAX
        assert armed.label == "lm_single_device"
        assert armed.step_profile is None
        for _ in range(2):
            want, got = plain(params, x, y), armed(params, x, y)
            assert all(torch.equal(a, b) for a, b in
                       zip(tree_leaves(want), tree_leaves(got)))
        assert len(prof.timings("lm_single_device")) == 2
        assert armed.step_profile.label == "lm_p"


# ------------------------------------------------------ arm-time pre-creation ----

def _engine(reg, prof, **kw):
    from deeplearning4j_tpu_torch.serve import DecodeEngine

    params = lm_params_from_numpy(lm_params_np(0, 31, 8, 2, 2, 16, 1),
                                  "cpu")
    return DecodeEngine(params, 2, n_slots=2, max_len=16, serve_dtype=None,
                        registry=reg, runprof=prof, device="cpu", **kw)


class TestPreArm:
    def test_arm_pre_creates_watched_instruments(self):
        reg = MetricsRegistry()
        RunProfiler(registry=reg).arm("train")
        names = _registry_names(reg)
        assert "runprof_steps_total" in names
        for g in _ARM_GAUGES:
            assert g in names, g
        assert "runprof_measured_mfu" not in names

    def test_engine_arms_at_construction(self):
        reg = MetricsRegistry()
        prof = RunProfiler()  # no registry: adopts the engine's
        _engine(reg, prof)
        names = _registry_names(reg)
        for g in _ARM_GAUGES:
            assert g in names, g
        assert "runprof_measured_mfu" not in names


# ----------------------------------------------------------- DecodeEngine seam ----

class TestEngineSeam:
    def test_decode_ticks_record_timings_and_streams_match(self):
        """One serve_decode timing a decode tick; the armed engine's
        streams equal the unarmed engine's."""
        reg = MetricsRegistry()
        prof = RunProfiler(registry=reg, update_every=1)
        eng = _engine(reg, prof)
        ref = _engine(MetricsRegistry(), False)
        prompts = [[1, 2, 3], [4, 5, 6, 7, 8]]
        got = [eng.submit(p, max_new_tokens=4) for p in prompts]
        want = [ref.submit(p, max_new_tokens=4) for p in prompts]
        eng.run_until_idle()
        ref.run_until_idle()
        assert [r.generated for r in got] == [r.generated for r in want]
        timings = prof.timings("serve_decode")
        assert len(timings) == eng.decode_steps > 0
        for t in timings:
            assert t.wall_ms > 0.0 and t.host_ms >= 0.0
            assert t.device_ms == t.dispatch_ms
            assert t.flops is None
        flat = flat_record(reg, prefixes=("runprof_",))
        assert flat["runprof_steps_total"] == len(timings)
        assert "runprof_measured_mfu" not in flat

    def test_tuned_still_raises_naming_21b(self):
        """``tuned=`` (item 21b) is a seam of the engine now: an explicit
        config lands beside an armed runtime profiler."""
        prof = RunProfiler(registry=MetricsRegistry())
        eng = _engine(MetricsRegistry(), prof, tuned={"slots": 3,
                                                      "min_bucket": 4})
        assert eng.n_slots == 3 and eng._buckets[0] == 4
        assert eng._runprof is prof


# ----------------------------------------------------- measured-MFU cross-check ----

class TestMeasuredMfuCrossCheck:
    def test_lm_step_measured_vs_wall_mfu(self):
        """measured_mfu = FLOPs / device seconds / peak, wall_mfu = FLOPs /
        wall seconds / peak: the device phase is a part of the wall, so
        measured/wall >= ~1; JAX's band [0.8, 8.0] (timer jitter below,
        the host's share of a tiny CPU step above)."""
        from deeplearning4j_tpu_torch.models import transformer_lm as TT
        from deeplearning4j_tpu_torch.telemetry.xprofile import \
            DEFAULT_PEAK_FLOPS

        reg = MetricsRegistry()
        n = 8
        prof = RunProfiler(registry=reg, update_every=n)
        step = TT.make_single_device_train_step(H, runprof=prof,
                                                device="cpu")
        assert isinstance(step, RunProfiledStep)
        params = _lm_params()
        x, y = _tokens()
        for _ in range(n):  # the profiled call, then the first window
            params, _ = step(params, x, y)
        # the gauges' second window is exactly the timed steps
        t0 = time.perf_counter()
        for _ in range(n):
            params, loss = step(params, x, y)
        wall_step_s = (time.perf_counter() - t0) / n
        flat = flat_record(reg, prefixes=("runprof_",))
        measured = flat["runprof_measured_mfu"]
        assert measured > 0.0
        flops = step.step_profile.flops
        assert flops and flops > 0
        wall_mfu = flops / wall_step_s / DEFAULT_PEAK_FLOPS
        assert 0.8 <= measured / wall_mfu <= 8.0, (measured, wall_mfu)


# -------------------------------------------------------------------- sessions ----

class TestSessions:
    def test_lifecycle_final_dump_and_chrome_trace(self, tmp_path):
        prof = RunProfiler(registry=MetricsRegistry(),
                           session_dir=str(tmp_path))
        sid = prof.start_session()
        assert prof.session_active
        for i in range(3):
            prof.record(_timing(flops=1e9 if i == 2 else None))
        with pytest.raises(RuntimeError):
            prof.start_session()
        final = prof.stop_session()
        assert final and final.endswith(f"runprof_{sid}.json")
        assert prof.stop_session() is None
        sess = load_session(final)
        assert sess["partial"] is False and sess["schema"] == SCHEMA
        assert len(sess["steps"]) == 3
        assert sess["summary"]["steps"] == 3
        assert sess["summary"]["measured_mfu"] > 0.0
        phases = {e["name"] for e in sess["chrome_trace"]}
        assert {"s.host", "s.dispatch", "s.device"} <= phases
        assert os.path.isfile(final[:-len(".json")] + ".jsonl")
        assert find_sessions(str(tmp_path))[0]["session"] == sid
        assert prof.snapshot()["sessions_completed"] == [final]

    def test_auto_stop_after_n_steps(self, tmp_path):
        prof = RunProfiler(registry=MetricsRegistry(),
                           session_dir=str(tmp_path))
        prof.start_session(steps=2)
        prof.record(_timing())
        assert prof.session_active
        prof.record(_timing())
        assert not prof.session_active
        assert load_session(prof.sessions_completed[0])["summary"][
            "steps"] == 2

    def test_repeated_start_stop_no_thread_leak(self, tmp_path):
        prof = RunProfiler(registry=MetricsRegistry(),
                           session_dir=str(tmp_path))
        before = threading.active_count()
        for _ in range(10):
            prof.start_session()
            prof.record(_timing())
            prof.stop_session()
        assert threading.active_count() == before
        assert len(prof.sessions_completed) == 10

    def test_trace_id_linkage(self, tmp_path):
        from deeplearning4j_tpu_torch.telemetry import trace as trace_mod

        prof = RunProfiler(registry=MetricsRegistry(),
                           session_dir=str(tmp_path))
        step = RunProfiledStep(lambda x: x * 2, label="tr", profiler=prof)
        tracer = trace_mod.Tracer("test", trace_dir=str(tmp_path / "tr"))
        old = trace_mod.set_tracer(tracer)
        try:
            prof.start_session()
            with trace_mod.maybe_span("train.loop") as sp:
                step(torch.ones((4,)))
                want = sp.trace_id
        finally:
            trace_mod.set_tracer(old)
        final = prof.stop_session()
        assert prof.timings("tr")[0].trace_id == want
        sess = load_session(final)
        assert sess["steps"][0]["trace_id"] == want
        assert any(e["args"].get("trace_id") == want
                   for e in sess["chrome_trace"])

    def test_torn_tail_tolerated_and_counted(self, tmp_path):
        prof = RunProfiler(registry=MetricsRegistry(),
                           session_dir=str(tmp_path))
        prof.start_session()
        prof.record(_timing())
        prof.record(_timing())
        prof.stop_session()
        jsonl = glob.glob(str(tmp_path / "*.jsonl"))[0]
        with open(jsonl, "a") as fh:
            fh.write('{"ev": "step", "wall_')  # killed mid-write
        sess = load_session(jsonl)
        assert sess["partial"] is True
        assert sess["torn_lines"] == 1
        assert len(sess["steps"]) == 2

    def test_kill_minus_nine_reconstructs_partial(self, tmp_path):
        child = tmp_path / "child.py"
        child.write_text(
            "import os, signal, sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "from deeplearning4j_tpu_torch.telemetry.registry import "
            "MetricsRegistry\n"
            "from deeplearning4j_tpu_torch.telemetry.runprof import "
            "RunProfiler, StepTiming\n"
            "prof = RunProfiler(registry=MetricsRegistry(), "
            "session_dir=sys.argv[1])\n"
            "prof.start_session()\n"
            "for i in range(5):\n"
            "    prof.record(StepTiming(label='s', t_unix=1000.0 + i,\n"
            "        wall_ms=2.0, host_ms=0.1, dispatch_ms=0.5,\n"
            "        device_ms=1.5, flops=1e9))\n"
            "os.kill(os.getpid(), signal.SIGKILL)\n")
        sess_dir = tmp_path / "sessions"
        out = subprocess.run([sys.executable, str(child), str(sess_dir)],
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == -signal.SIGKILL, out.stderr
        assert not glob.glob(str(sess_dir / "*.json"))
        (sess,) = find_sessions(str(sess_dir))
        assert sess["partial"] is True
        assert len(sess["steps"]) == 5
        assert sess["summary"]["measured_mfu"] > 0.0
        # the JAX package's reader reconstructs the same session
        (jsess,) = jrp.find_sessions(str(sess_dir))
        for key in ("partial", "torn_lines", "steps", "chrome_trace"):
            assert jsess[key] == sess[key], key


# ------------------------------------------------- readers against JAX ----

def _records(n=12, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        d = _timing(wall=float(rng.uniform(1, 9)),
                    host=float(rng.uniform(0, 1)) * (i % 3 != 0),
                    dispatch=float(rng.uniform(0, 2)),
                    device=float(rng.uniform(0, 5)),
                    flops=1e9 * (i + 1) if i % 2 else None,
                    t_unix=1000.0 + 0.01 * i,
                    trace_id=f"t{i}" if i % 4 == 0 else None).to_dict()
        d["ev"] = "step"
        d["pid"] = 7
        out.append(d)
    out.insert(3, {"ev": "session_start", "session": "x"})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_readers_equal_jax_on_the_same_records(seed):
    recs = _records(seed=seed)
    for peak in (197e12, 989e12):
        assert summarize_session(recs, peak_flops=peak) == \
            jrp.summarize_session(recs, peak_flops=peak)
    assert summarize_session(recs)["measured_mfu"] == \
        jrp.summarize_session(recs, peak_flops=989e12)["measured_mfu"]
    assert chrome_trace_events(recs) == jrp.chrome_trace_events(recs)
    assert summarize_session([]) == jrp.summarize_session([])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_session_files_load_in_the_other_package(tmp_path, writer):
    """A final JSON and a torn write-ahead JSONL written by either package
    load in the other to the same dict (the summary's MFU at the same
    peak)."""
    mod = jrp if writer == "jax" else sys.modules[RunProfiler.__module__]
    if writer == "jax":
        from deeplearning4j_tpu.telemetry.registry import MetricsRegistry \
            as Reg
    else:
        Reg = MetricsRegistry
    prof = mod.RunProfiler(registry=Reg(), session_dir=str(tmp_path),
                           peak_flops=989e12)
    prof.start_session()
    for i in range(4):
        prof.record(mod.StepTiming(label="s", t_unix=1000.0 + i,
                                   wall_ms=2.0 + i, host_ms=0.1,
                                   dispatch_ms=0.5, device_ms=1.5,
                                   flops=1e9))
    final = prof.stop_session()
    ours = load_session(final)
    theirs = jrp.load_session(final)
    assert ours == theirs and ours["partial"] is False
    assert len(ours["steps"]) == 4 and ours["schema"] == SCHEMA
    jsonl = final[:-len(".json")] + ".jsonl"
    with open(jsonl, "a") as fh:
        fh.write('{"ev": "step", "wall_')
    os.unlink(final)
    part, jpart = load_session(final), jrp.load_session(final)
    assert part["torn_lines"] == jpart["torn_lines"] == 1
    assert part["steps"] == jpart["steps"]
    assert part["chrome_trace"] == jpart["chrome_trace"]
    # the summaries differ only by each package's default peak
    s, js = dict(part["summary"]), dict(jpart["summary"])
    assert s.pop("measured_mfu") * 989e12 == pytest.approx(
        js.pop("measured_mfu") * 197e12)
    assert s == js
    assert json.loads(json.dumps(part)) == part


# ------------------------------------------------------------------ seams ----

class TestElasticSeam:
    def test_synthetic_worker_records_steps(self):
        from deeplearning4j_tpu_torch.scaleout.elastic import (
            SyntheticRegressionModel,
        )

        reg = MetricsRegistry()
        prof = RunProfiler(registry=reg, update_every=1)
        kw = dict(d_in=4, d_hidden=8, batch=8, lr=0.05, mesh_devices=1,
                  device="cpu")
        model = SyntheticRegressionModel(profile=True, runprof=prof, **kw)
        plain = SyntheticRegressionModel(**kw)
        p, loss = model.run_steps(model.init_params(), 0, 3, worker_seed=0)
        q, want = plain.run_steps(plain.init_params(), 0, 3, worker_seed=0)
        assert loss == want
        assert all(np.array_equal(a, b) for a, b in
                   zip(tree_leaves(p), tree_leaves(q)))
        timings = prof.timings("elastic_worker")
        assert len(timings) == 3
        assert all(t.wall_ms > 0.0 and t.flops > 0 for t in timings)
        assert model.step_profile.label == "elastic_worker"
        assert plain.step_profile is None
        flat = flat_record(reg, prefixes=("runprof_",))
        assert flat["runprof_steps_total"] == 3.0


class TestReaders:
    def test_summarize_empty_and_percentiles(self):
        assert summarize_session([]) == {"steps": 0}
        recs = [_timing(wall=float(i + 1), t_unix=1000.0 + i).to_dict()
                for i in range(100)]
        for r in recs:
            r["ev"] = "step"
        s = summarize_session(recs)
        assert s["wall_ms"]["p50"] == 50.0
        assert s["wall_ms"]["p95"] == 95.0
        assert s["steps_per_s"] == pytest.approx(1.0)

    def test_chrome_events_skip_zero_phases(self):
        t = _timing(host=0.0, dispatch=0.5, device=1.5, t_unix=1000.0)
        d = t.to_dict()
        d["ev"] = "step"
        names = {e["name"] for e in chrome_trace_events([d])}
        assert names == {"s.dispatch", "s.device"}
