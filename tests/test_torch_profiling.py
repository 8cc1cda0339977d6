"""The port's profiling utilities (deeplearning4j_tpu_torch/utils/profiling.py)
and ``train --profile``: torch.profiler traces written as Chrome JSON, the
listener's window semantics (tests/test_profiling.py's), device memory
stats on the CPU, and a profiled CLI run against an unprofiled one.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import glob
import json

import numpy as np
import pytest

from deeplearning4j_tpu_torch.utils import profiling
from deeplearning4j_tpu_torch.utils.profiling import (
    ProfilerIterationListener,
    annotate,
    device_memory_stats,
    named_scope,
    save_device_memory_profile,
    trace,
)


def _traces(root):
    return sorted(glob.glob(os.path.join(str(root), "*.json")))


def _event_names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_trace_context_writes_a_chrome_trace_with_the_annotation(tmp_path):
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)):
        with annotate("test-block"):
            torch.ones((64, 64)) @ torch.ones((64, 64))
        with named_scope("scoped"):
            torch.ones(8).sum()
    (path,) = _traces(log_dir)
    names = _event_names(path)
    assert {"test-block", "scoped"} <= names
    assert any(n and "mm" in n for n in names)


def test_device_memory_stats_shape():
    stats = device_memory_stats()
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    assert len(stats) == n
    assert all("device" in s for s in stats)
    if not torch.cuda.is_available():
        assert stats == [{"device": "cpu"}]


def test_save_device_memory_profile_raises_on_the_cpu(tmp_path):
    if torch.cuda.is_available():
        path = save_device_memory_profile(str(tmp_path / "mem.pickle"))
        assert os.path.getsize(path) > 0
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        save_device_memory_profile(str(tmp_path / "mem.pickle"))


def test_profiler_iteration_listener_writes_its_window(tmp_path):
    log_dir = tmp_path / "iters"
    listener = ProfilerIterationListener(str(log_dir), start=2, steps=2)
    for i in range(6):
        torch.ones((16, 16)) @ torch.ones((16, 16))
        listener(None, i, 0.0)
    listener.close()
    assert len(_traces(log_dir)) == 1


def _tiny_conf():
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration

    return (NeuralNetConfiguration.Builder()
            .n_in(4).n_out(8).activation_function("tanh").lr(0.1)
            .num_iterations(5).seed(0).list(2)
            .override(1, layer_type="OUTPUT", n_in=8, n_out=3,
                      activation_function="softmax", loss_function="MCXENT")
            .pretrain(False).backward(True).build())


def test_listener_in_real_training(tmp_path):
    """The listener rides the MultiLayerNetwork listener chain during an
    actual fit."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    net = MultiLayerNetwork(_tiny_conf(), device="cpu").init()
    log_dir = tmp_path / "fit-trace"
    listener = ProfilerIterationListener(str(log_dir), start=1, steps=2)
    net.listeners.append(listener)
    rng = np.random.RandomState(0)
    net.fit(rng.rand(12, 4).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.randint(0, 3, 12)])
    listener.close()
    assert len(_traces(log_dir)) == 1


class _TraceSpy:
    """Records the listener's trace starts and stops without running the
    profiler."""

    def __init__(self, monkeypatch):
        self.events = []
        monkeypatch.setattr(
            ProfilerIterationListener, "_start_trace",
            lambda lst: self.events.append(("start", lst.log_dir)))
        monkeypatch.setattr(
            ProfilerIterationListener, "_stop_trace",
            lambda lst: self.events.append(("stop", None)))

    @property
    def starts(self):
        return [e for e in self.events if e[0] == "start"]

    @property
    def stops(self):
        return [e for e in self.events if e[0] == "stop"]


class TestProfilerListenerWindowSemantics:
    """JAX's window contract: a window opened at the ``start``-th callback
    traces callbacks start+1 … start+steps; close() releases a still-open
    trace, idempotently."""

    def test_window_opens_at_start_and_spans_steps(self, monkeypatch,
                                                   tmp_path):
        spy = _TraceSpy(monkeypatch)
        listener = ProfilerIterationListener(str(tmp_path), start=2, steps=3)
        opened_at, closed_at = None, None
        for i in range(8):
            listener(None, i, 0.0)
            if spy.starts and opened_at is None:
                opened_at = i
            if spy.stops and closed_at is None:
                closed_at = i
        assert opened_at == 1
        assert closed_at == 4
        assert len(spy.starts) == 1 and len(spy.stops) == 1
        listener(None, 99, 0.0)
        assert len(spy.starts) == 1

    def test_start_zero_opens_at_first_callback(self, monkeypatch,
                                                tmp_path):
        spy = _TraceSpy(monkeypatch)
        listener = ProfilerIterationListener(str(tmp_path), start=0, steps=1)
        listener(None, 0, 0.0)
        assert len(spy.starts) == 1
        listener(None, 1, 0.0)
        assert len(spy.stops) == 1

    def test_close_releases_still_open_trace(self, monkeypatch, tmp_path):
        spy = _TraceSpy(monkeypatch)
        listener = ProfilerIterationListener(str(tmp_path), start=1, steps=5)
        for i in range(2):
            listener(None, i, 0.0)
        assert len(spy.starts) == 1 and len(spy.stops) == 0
        listener.close()
        assert len(spy.stops) == 1
        listener.close()
        assert len(spy.stops) == 1
        listener(None, 5, 0.0)
        assert len(spy.starts) == 1

    def test_close_before_window_opens_is_noop(self, monkeypatch, tmp_path):
        spy = _TraceSpy(monkeypatch)
        listener = ProfilerIterationListener(str(tmp_path), start=5, steps=2)
        listener.close()
        assert spy.events == []


def test_cli_train_profile_flag_matches_the_unprofiled_run(tmp_path):
    """``train --profile DIR`` writes a trace around fit, and the model it
    saves equals the unprofiled run's."""
    from deeplearning4j_tpu_torch.cli.driver import main

    conf_path = tmp_path / "model.json"
    conf_path.write_text(_tiny_conf().to_json())
    rng = np.random.RandomState(1)
    rows = np.hstack([rng.rand(30, 4), rng.randint(0, 3, (30, 1))])
    csv = tmp_path / "data.csv"
    csv.write_text("\n".join(",".join(f"{v:.4f}" for v in r) for r in rows))
    common = ["train", "--conf", str(conf_path), "--input", str(csv),
              "--labels", "3", "--device", "cpu"]
    prof_dir = tmp_path / "prof"
    assert main(common + ["--model", str(tmp_path / "a.npz"),
                          "--profile", str(prof_dir)]) == 0
    assert main(common + ["--model", str(tmp_path / "b.npz")]) == 0
    assert len(_traces(prof_dir)) == 1
    a = np.load(tmp_path / "a.npz")["params"]
    b = np.load(tmp_path / "b.npz")["params"]
    assert np.array_equal(a, b)
    assert profiling.__name__ == "deeplearning4j_tpu_torch.utils.profiling"
