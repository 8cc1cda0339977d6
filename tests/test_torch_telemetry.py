"""The port's JSONL step log and Prometheus exposition
(deeplearning4j_tpu_torch/telemetry/step_log.py and prometheus.py) held
against the JAX package's: the step-log and Prometheus parts of
tests/test_telemetry.py through the port (write and read, reopen-append,
tensor scalars and non-finite values, the bad line named, non-finite
counts, the wall-time p99 summary, ``MetricsIterationListener
(step_log_path=)`` over a fit, ``tools/telemetry_report.py`` on a port
log), plus JAX's renderer and summarizer giving byte-equal text and
equal summaries for the same registry and records."""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import json
import subprocess
import sys

import numpy as np
import pytest

from deeplearning4j_tpu_torch.telemetry import (
    PROMETHEUS_CONTENT_TYPE,
    MetricsRegistry,
    read_step_log,
    render_prometheus,
    render_snapshot,
    sanitize_name,
    summarize_step_log,
)
from deeplearning4j_tpu_torch.telemetry.step_log import (
    StepLogWriter,
    nonfinite_counts,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fill(reg):
    """One registry's instruments, filled the same way in either
    package."""
    reg.counter("train_steps").inc(3)
    reg.counter("rounds.worker-0").inc()
    reg.counter("tracker_rpcs", {"method": "increment"}).inc(7)
    reg.gauge("train_loss").set(1.5)
    reg.gauge("router_load", {"expert": "0"}).set(0.25)
    reg.gauge("router_load", {"expert": "1"}).set(0.75)
    reg.gauge("g", {"path": 'a"b\nc\\d'}).set(-2.0)
    reg.gauge("big").set(1e16)
    reg.gauge("inf").set(float("inf"))
    h = reg.histogram("step_ms", buckets=(10.0, 100.0))
    h.observe(5.0)
    h.observe(50.0)
    reg.histogram("lat_ms", {"route": "x"}).observe(0.75)
    return reg


# ------------------------------------------------------------ prometheus ----

class TestPrometheus:
    def test_golden_text_format(self):
        reg = MetricsRegistry()
        reg.counter("train_steps").inc(3)
        reg.gauge("train_loss").set(1.5)
        reg.gauge("router_load", {"expert": "0"}).set(0.25)
        reg.gauge("router_load", {"expert": "1"}).set(0.75)
        h = reg.histogram("step_ms", buckets=(10.0, 100.0))
        h.observe(5.0)
        h.observe(50.0)
        expected = (
            "# TYPE train_steps_total counter\n"
            "train_steps_total 3\n"
            "# TYPE router_load gauge\n"
            'router_load{expert="0"} 0.25\n'
            'router_load{expert="1"} 0.75\n'
            "# TYPE train_loss gauge\n"
            "train_loss 1.5\n"
            "# TYPE step_ms histogram\n"
            'step_ms_bucket{le="10"} 1\n'
            'step_ms_bucket{le="100"} 2\n'
            'step_ms_bucket{le="+Inf"} 2\n'
            "step_ms_sum 55\n"
            "step_ms_count 2\n"
        )
        assert render_prometheus(reg) == expected
        assert PROMETHEUS_CONTENT_TYPE == \
            "text/plain; version=0.0.4; charset=utf-8"

    def test_name_sanitization_and_label_escaping(self):
        reg = MetricsRegistry()
        reg.counter("rounds.worker-0").inc()
        reg.gauge("g", {"path": 'a"b\nc'}).set(1)
        txt = render_prometheus(reg)
        assert "rounds_worker_0_total 1" in txt
        assert r'path="a\"b\nc"' in txt
        assert sanitize_name("9lives.x-y") == "_9lives_x_y"
        assert render_prometheus(MetricsRegistry()) == ""

    def test_byte_equal_to_jax_for_the_same_registry(self):
        """One registry filled the same way in both packages renders to
        the same bytes, and either renderer prints the other's snapshot
        (exemplars included) identically."""
        from deeplearning4j_tpu.telemetry.prometheus import (
            render_prometheus as jrender,
            render_snapshot as jrender_snapshot,
        )
        from deeplearning4j_tpu.telemetry.registry import (
            MetricsRegistry as JReg,
        )

        mine = render_prometheus(_fill(MetricsRegistry()))
        theirs = jrender(_fill(JReg()))
        assert mine.encode() == theirs.encode()
        reg = _fill(MetricsRegistry())
        reg.histogram("ex_ms").observe(3.0, exemplar="aa" * 16)
        reg.histogram("ex_ms").observe(700.0, exemplar="bb" * 16)
        snap = reg.snapshot()
        assert render_snapshot(snap).encode() == \
            jrender_snapshot(snap).encode()
        text = render_snapshot(snap)
        line = [ln for ln in text.splitlines()
                if ln.startswith('ex_ms_bucket{le="5"')][0]
        assert f'# {{trace_id="{"aa" * 16}"}} 3' in line

    def test_cluster_snapshot_renders(self):
        """``ClusterAggregator.prometheus_snapshot`` renders through
        ``render_snapshot`` as JAX's renderer prints it."""
        from deeplearning4j_tpu.telemetry.prometheus import (
            render_snapshot as jrender_snapshot,
        )
        from deeplearning4j_tpu_torch.scaleout.statetracker import (
            InMemoryStateTracker,
        )
        from deeplearning4j_tpu_torch.telemetry.federation import (
            ClusterAggregator,
            MetricsPusher,
        )

        tracker = InMemoryStateTracker()
        for name in ("p0", "p1"):
            MetricsPusher(tracker, name,
                          registry=_fill(MetricsRegistry())).push_once()
        snap = ClusterAggregator(tracker, stale_after_s=3600.0,
                                 registry=MetricsRegistry()
                                 ).prometheus_snapshot()
        text = render_snapshot(snap)
        assert text == jrender_snapshot(snap)
        assert "train_steps_total 6" in text  # counters sum
        assert 'federation_process_up{process="p1"} 1' in text


# -------------------------------------------------------------- step log ----

class TestStepLog:
    def test_round_trip(self, tmp_path):
        path = str(tmp_path / "steps.jsonl")
        with StepLogWriter(path, static={"mesh": "dp2xsp2xep2"}) as w:
            w.write(0, wall_ms=None, loss=1.5, router_load=[0.5, 0.5])
            w.write(1, wall_ms=12.5, tokens_per_sec=1000.0, loss=1.25)
        recs = read_step_log(path)
        assert [r["step"] for r in recs] == [0, 1]
        assert recs[0]["mesh"] == "dp2xsp2xep2"
        assert recs[0]["router_load"] == [0.5, 0.5]
        assert "wall_ms" not in recs[0] and recs[1]["wall_ms"] == 12.5
        assert recs[1]["tokens_per_sec"] == 1000.0

    def test_write_after_close_reopens_append(self, tmp_path):
        path = str(tmp_path / "steps.jsonl")
        w = StepLogWriter(path)
        w.write(0, loss=1.0)
        w.close()
        w.write(1, loss=0.5)  # listener chains get closed and reused
        w.close()
        assert len(read_step_log(path)) == 2

    def test_tensor_scalars_and_nonfinite(self, tmp_path):
        path = str(tmp_path / "steps.jsonl")
        with StepLogWriter(path) as w:
            w.write(0, loss=torch.tensor(2.0), load=torch.tensor([0.5, 1.5]),
                    np_loss=np.float32(3.0), bad=float("nan"),
                    worse=torch.tensor(float("inf")))
        rec = read_step_log(path)[0]
        assert rec["loss"] == 2.0 and rec["load"] == [0.5, 1.5]
        assert rec["np_loss"] == 3.0
        assert rec["bad"] == "nan" and rec["worse"] == "inf"

    def test_summarize(self, tmp_path):
        recs = [
            {"step": 0, "loss": 2.0, "grad_norm": 1.0,
             "router_load": [0.4, 0.6]},
            {"step": 1, "wall_ms": 10.0, "tokens_per_sec": 100.0,
             "loss": 1.0, "grad_norm": 0.5, "router_load": [0.6, 0.4]},
        ]
        s = summarize_step_log(recs)
        assert s["steps"] == 2
        assert s["loss"] == {"first": 2.0, "last": 1.0}
        assert s["wall_ms"]["p50"] == 10.0
        assert s["router_load_mean"] == [0.5, 0.5]
        assert summarize_step_log([]) == {"steps": 0}

    def test_read_step_log_names_bad_line(self, tmp_path):
        path = tmp_path / "steps.jsonl"
        path.write_text('{"step": 0}\nnot json\n')
        with pytest.raises(ValueError, match=r"line 2"):
            read_step_log(str(path))

    def test_wall_ms_summary_includes_p99(self, tmp_path):
        path = str(tmp_path / "steps.jsonl")
        with StepLogWriter(path) as w:
            for i in range(100):
                w.write(i, wall_ms=float(i + 1))
        s = summarize_step_log(read_step_log(path))
        assert s["wall_ms"]["p50"] == 50.0
        assert s["wall_ms"]["p95"] == 95.0
        assert s["wall_ms"]["p99"] == 99.0


class TestNonfinite:
    def _write_faulty_log(self, tmp_path):
        path = str(tmp_path / "steps.jsonl")
        with StepLogWriter(path) as w:
            w.write(0, loss=2.0, grad_norm=1.5, nonfinite=0.0, clipped=0.0)
            w.write(1, loss=float("nan"), grad_norm=float("inf"),
                    nonfinite=1.0, clipped=0.0)
            w.write(2, loss=1.8, grad_norm=1.2, nonfinite=0.0, clipped=1.0)
            w.write(3, loss=float("-inf"), grad_norm=1.1, nonfinite=1.0,
                    clipped=0.0)
        return path

    def test_summary_counts_nonfinite_values(self, tmp_path):
        recs = read_step_log(self._write_faulty_log(tmp_path))
        summary = summarize_step_log(recs)
        assert nonfinite_counts(recs) == {"loss": 2, "grad_norm": 1}
        assert summary["nonfinite"] == {"loss": 2, "grad_norm": 1}
        assert summary["skipped_steps"] == 2
        assert summary["clipped_steps"] == 1
        assert summary["loss"] == {"first": 2.0, "last": 1.8}

    def test_summary_counts_raw_float_nonfinite(self):
        summary = summarize_step_log([
            {"ts": 0.0, "step": 0, "loss": 1.0},
            {"ts": 1.0, "step": 1, "loss": float("nan")},
        ])
        assert summary["nonfinite"] == {"loss": 1}

    def test_clean_log_has_no_nonfinite_block(self, tmp_path):
        path = str(tmp_path / "steps.jsonl")
        with StepLogWriter(path) as w:
            w.write(0, loss=2.0)
            w.write(1, loss=1.5)
        summary = summarize_step_log(read_step_log(path))
        assert "nonfinite" not in summary
        assert "skipped_steps" not in summary

    def test_summaries_equal_jax(self, tmp_path):
        """JAX's reader and summarizer give the port's log the port's
        summary, blocks included."""
        from deeplearning4j_tpu.telemetry.step_log import (
            read_step_log as jread,
            summarize_step_log as jsummarize,
        )

        path = self._write_faulty_log(tmp_path)
        with StepLogWriter(path) as w:
            w.write(4, wall_ms=3.0, tokens_per_sec=10.0,
                    router_load=[0.2, 0.8], serve_queue_depth=2.0,
                    alerts_rules=16.0, history_series=3.0)
        assert summarize_step_log(read_step_log(path)) == \
            jsummarize(jread(path))


# ------------------------------------------------------- listener + tool ----

def test_metrics_iteration_listener_writes_the_step_log(tmp_path):
    """``MetricsIterationListener(step_log_path=)`` on a port fit: one
    record a callback, each with the score, plus the registry's
    instruments."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.listeners import (
        MetricsIterationListener,
    )

    conf = (NeuralNetConfiguration.Builder()
            .n_in(4).n_out(8).activation_function("tanh").lr(0.1)
            .num_iterations(3).seed(0).list(2)
            .override(1, layer_type="OUTPUT", n_in=8, n_out=3,
                      activation_function="softmax", loss_function="MCXENT")
            .pretrain(False).backward(True).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    reg = MetricsRegistry()
    path = str(tmp_path / "iters.jsonl")
    net.set_listeners([MetricsIterationListener(registry=reg,
                                                step_log_path=path)])
    rng = np.random.RandomState(0)
    net.fit(rng.rand(12, 4).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.randint(0, 3, 12)])
    assert reg.counter("train_iterations_total").value == 3
    assert reg.gauge("train_score").value > 0
    recs = read_step_log(path)
    assert len(recs) == 3 and all("score" in r for r in recs)
    assert [r["score"] for r in recs][-1] == pytest.approx(
        reg.gauge("train_score").value)


def test_telemetry_report_reads_a_port_log(tmp_path):
    """``tools/telemetry_report.py`` renders a port-written log (table
    and JSON) and names a torn tail's line."""
    path = tmp_path / "steps.jsonl"
    with StepLogWriter(str(path)) as w:
        w.write(0, loss=2.0, grad_norm=1.5, router_load=[0.5, 0.5])
        w.write(1, wall_ms=10.0, tokens_per_sec=6400.0, loss=1.5,
                grad_norm=1.2, router_load=[0.4, 0.6])
        w.write(2, wall_ms=12.0, tokens_per_sec=5333.3,
                loss=torch.tensor(1.2), grad_norm=1.1,
                router_load=[0.6, 0.4])
    tool = os.path.join(REPO, "tools", "telemetry_report.py")
    out = subprocess.run([sys.executable, tool, str(path), "--json"],
                         capture_output=True, text=True, timeout=60,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == summarize_step_log(
        read_step_log(str(path)))
    with open(path, "a") as fh:
        fh.write('{"ts": 3.0, "step": 3, "lo')  # torn tail
    out = subprocess.run([sys.executable, tool, str(path)],
                         capture_output=True, text=True, timeout=60,
                         cwd=REPO)
    assert out.returncode == 3
    assert "truncated or corrupt" in out.stderr and "line 4" in out.stderr
