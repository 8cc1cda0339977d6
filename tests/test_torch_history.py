"""The port's metrics time-series history
(deeplearning4j_tpu_torch/telemetry/history.py) held against the JAX
package's: tests/test_history.py whole through the port (query semantics
on hand-built registries, windowed histogram percentiles and burn
fractions, the write-ahead spill and its torn tail, bounded rings, the
sampler thread's lifecycle), plus a spill written by either package
replayed by the other, and the same queries answered alike by both."""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import json
import threading
import time

import pytest

from deeplearning4j_tpu_torch.telemetry.history import (
    MetricsHistory,
    get_history,
    read_spill,
    replay_spill,
    set_history,
)
from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry


def _hist(reg=None, **kw):
    return MetricsHistory(registry=reg or MetricsRegistry(), **kw)


class TestScalarQueries:
    def test_points_and_last_point(self):
        reg = MetricsRegistry()
        h = _hist(reg)
        reg.gauge("g").set(1.0)
        h.sample_once(now=100.0)
        reg.gauge("g").set(4.0)
        h.sample_once(now=110.0)
        assert h.points("g") == [(100.0, 1.0), (110.0, 4.0)]
        assert h.last_point("g") == (110.0, 4.0)
        assert h.points("g", window_s=5.0, now=112.0) == [(110.0, 4.0)]
        assert h.last_point("missing") is None

    def test_counter_rate_and_window(self):
        reg = MetricsRegistry()
        h = _hist(reg)
        c = reg.counter("c_total")
        for t, inc in ((100.0, 0), (110.0, 5), (120.0, 5)):
            c.inc(inc)
            h.sample_once(now=t)
        assert h.rate("c_total", window_s=60.0, now=120.0) == \
            pytest.approx(0.5)
        # a narrower window sees only the most recent increase
        assert h.rate("c_total", window_s=11.0, now=120.0) == \
            pytest.approx(0.5)
        assert h.rate("c_total", window_s=5.0, now=120.0) is None

    def test_rate_is_reset_safe(self):
        """A counter reset (process restart re-registering the name) must
        never produce a negative rate — the measurement restarts at the
        reset point."""
        h = _hist()
        with h._lock:
            h._ingest(100.0, {"counters": [
                {"name": "c", "labels": {}, "value": 90.0}]})
            h._ingest(110.0, {"counters": [
                {"name": "c", "labels": {}, "value": 2.0}]})
            h._ingest(120.0, {"counters": [
                {"name": "c", "labels": {}, "value": 7.0}]})
        assert h.rate("c", window_s=60.0, now=120.0) == pytest.approx(0.5)

    def test_labels_none_sums_label_sets(self):
        reg = MetricsRegistry()
        h = _hist(reg)
        reg.counter("c", {"w": "a"}).inc(1)
        reg.counter("c", {"w": "b"}).inc(2)
        h.sample_once(now=100.0)
        reg.counter("c", {"w": "a"}).inc(3)
        h.sample_once(now=110.0)
        assert h.points("c") == [(100.0, 3.0), (110.0, 6.0)]
        # explicit labels pin one series
        assert h.points("c", labels={"w": "b"}) == [(100.0, 2.0),
                                                    (110.0, 2.0)]

    def test_gauge_delta_signed(self):
        reg = MetricsRegistry()
        h = _hist(reg)
        reg.gauge("q").set(10.0)
        h.sample_once(now=100.0)
        reg.gauge("q").set(4.0)
        h.sample_once(now=130.0)
        assert h.delta("q", window_s=60.0, now=130.0) == pytest.approx(-6.0)
        assert h.delta("q", window_s=5.0, now=130.0) is None

    def test_last_points_by_label(self):
        reg = MetricsRegistry()
        h = _hist(reg)
        reg.gauge("hb_unix", {"worker": "w1"}).set(100.0)
        reg.gauge("hb_unix", {"worker": "w2"}).set(50.0)
        h.sample_once(now=200.0)
        rows = h.last_points_by_label("hb_unix")
        assert ({"worker": "w1"}, 200.0, 100.0) in rows
        assert ({"worker": "w2"}, 200.0, 50.0) in rows

    def test_ring_is_bounded(self):
        reg = MetricsRegistry()
        h = _hist(reg, window=4)
        for i in range(10):
            reg.gauge("g").set(float(i))
            h.sample_once(now=100.0 + i)
        pts = h.points("g")
        assert len(pts) == 4
        assert pts[0] == (106.0, 6.0)


class TestHistogramWindows:
    def _reg(self):
        reg = MetricsRegistry()
        hist = reg.histogram("lat_ms")
        return reg, hist

    def test_window_delta_percentile(self):
        """The windowed percentile reflects ONLY the window's
        observations — the old latency regime before the window cannot
        mask a fresh regression (the whole point vs all-time)."""
        reg, hist = self._reg()
        h = _hist(reg)
        for _ in range(100):
            hist.observe(3.0)  # an hour of fast requests…
        h.sample_once(now=100.0)
        for _ in range(10):
            hist.observe(2000.0)  # …then a regression
        h.sample_once(now=160.0)
        # all-time p50 is still fast; the window knows better
        assert hist.percentile(50) == 5.0
        assert h.percentile_over("lat_ms", 50, window_s=70.0,
                                 now=160.0) == 2500.0
        win = h.histogram_window("lat_ms", window_s=70.0, now=160.0)
        assert win["count"] == 10 and win["sum"] == pytest.approx(20000.0)

    def test_fraction_over_burn_numerator(self):
        reg, hist = self._reg()
        h = _hist(reg)
        h.sample_once(now=100.0)
        for v in (10.0, 40.0, 300.0, 900.0):
            hist.observe(v)
        h.sample_once(now=130.0)
        assert h.fraction_over("lat_ms", 250.0, window_s=60.0,
                               now=130.0) == pytest.approx(0.5)
        assert h.fraction_over("lat_ms", 250.0, window_s=5.0,
                               now=130.0) is None

    def test_empty_window_is_none(self):
        reg, hist = self._reg()
        h = _hist(reg)
        hist.observe(5.0)
        h.sample_once(now=100.0)
        h.sample_once(now=160.0)
        # no new observations inside the window → None, never 0-division
        assert h.percentile_over("lat_ms", 99, window_s=70.0,
                                 now=160.0) is None


class TestSpill:
    def test_write_ahead_round_trip(self, tmp_path):
        path = str(tmp_path / "spill.jsonl")
        reg = MetricsRegistry()
        h = _hist(reg, spill_path=path)
        reg.counter("c").inc(1)
        h.sample_once(now=100.0)
        reg.counter("c").inc(2)
        h.sample_once(now=110.0)
        h.close()
        recs = read_spill(path)
        assert [r["seq"] for r in recs] == [0, 1]
        replayed = replay_spill(path)
        assert replayed.points("c") == [(100.0, 1.0), (110.0, 3.0)]

    def test_torn_tail_tolerated(self, tmp_path):
        """A process killed mid-write leaves a torn final line; every
        earlier sample is complete by the write-ahead contract and must
        still load."""
        path = str(tmp_path / "spill.jsonl")
        reg = MetricsRegistry()
        h = _hist(reg, spill_path=path)
        reg.gauge("g").set(7.0)
        h.sample_once(now=100.0)
        h.close()
        with open(path, "a") as fh:
            fh.write('{"schema": "dl4j-tpu-history-v1", "ts": 110.0, "sn')
        recs = read_spill(path)
        assert len(recs) == 1 and recs[0]["ts"] == 100.0

    def test_corrupt_middle_line_raises(self, tmp_path):
        path = str(tmp_path / "spill.jsonl")
        with open(path, "w") as fh:
            fh.write("{not json\n")
            fh.write(json.dumps({"schema": "dl4j-tpu-history-v1",
                                 "ts": 1.0, "seq": 0,
                                 "snapshot": {}}) + "\n")
        with pytest.raises(ValueError, match="line 1"):
            read_spill(path)


class TestSamplerThread:
    def test_background_sampler_and_self_metrics(self):
        reg = MetricsRegistry()
        reg.gauge("g").set(1.0)
        h = _hist(reg, interval_s=0.01)
        with h:
            deadline = time.time() + 5.0
            while (reg.counter("history_samples_total").value < 3
                   and time.time() < deadline):
                time.sleep(0.01)
        assert reg.counter("history_samples_total").value >= 3
        assert reg.gauge("history_series").value >= 1
        assert len(h.points("g")) >= 3

    def test_thread_lifecycle_stable_under_repeated_start_stop(self):
        """The sampler neither leaks nor double-starts across repeated
        open/close, stop is idempotent, start-after-stop works."""
        before = threading.active_count()
        h = _hist(interval_s=0.005)
        for _ in range(4):
            h.start()
            h.start()  # idempotent
            time.sleep(0.02)
            h.stop()
            h.stop()  # idempotent
            assert threading.active_count() == before
        h.close()
        assert threading.active_count() == before

    def test_process_global_seam(self):
        prev = set_history(None)
        try:
            assert get_history() is None
            h = _hist()
            assert set_history(h) is None
            assert get_history() is h
        finally:
            set_history(prev)


def test_spill_dir_created(tmp_path):
    path = str(tmp_path / "nested" / "dir" / "spill.jsonl")
    h = _hist(spill_path=path)
    h.sample_once(now=1.0)
    h.close()
    assert os.path.isfile(path)


# ------------------------------------------------------- across packages ----

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_spill_replays_in_the_other_package(tmp_path, writer):
    """A spill is the same JSONL in both packages: each replays the
    other's, to the same points and rates."""
    from deeplearning4j_tpu.telemetry import history as jhist
    from deeplearning4j_tpu.telemetry.registry import MetricsRegistry as JReg
    from deeplearning4j_tpu_torch.telemetry import history as thist

    mods = {"jax": (jhist, JReg), "torch": (thist, MetricsRegistry)}
    wmod, wreg_cls = mods[writer]
    rmod = thist if writer == "jax" else jhist
    path = str(tmp_path / "spill.jsonl")
    wreg = wreg_cls()
    h = wmod.MetricsHistory(registry=wreg, spill_path=path)
    c = wreg.counter("c_total")
    for t, inc in ((100.0, 0), (110.0, 5), (120.0, 5)):
        c.inc(inc)
        h.sample_once(now=t)
    h.close()
    replayed = rmod.replay_spill(path)
    assert replayed.points("c_total") == [(100.0, 0.0), (110.0, 5.0),
                                          (120.0, 10.0)]
    assert replayed.rate("c_total", window_s=60.0, now=120.0) == \
        pytest.approx(0.5)
    assert [r["seq"] for r in rmod.read_spill(path)] == [0, 1, 2]


def test_queries_equal_jax():
    """The same registry history answers every query as JAX's does."""
    from deeplearning4j_tpu.telemetry.history import MetricsHistory as JH
    from deeplearning4j_tpu.telemetry.registry import MetricsRegistry as JReg

    hs = []
    for H, reg in ((MetricsHistory, MetricsRegistry()), (JH, JReg())):
        hist = H(registry=reg)
        c = reg.counter("c_total", {"w": "a"})
        g = reg.gauge("q")
        lat = reg.histogram("lat_ms")
        for i, (inc, q, v) in enumerate(((0, 1.0, 3.0), (5, 4.0, 300.0),
                                         (2, 2.0, 900.0), (7, 9.0, 40.0))):
            c.inc(inc)
            g.set(q)
            lat.observe(v)
            hist.sample_once(now=100.0 + 10.0 * i)
        hs.append(hist)
    t, j = hs
    now = 130.0
    assert t.points("c_total") == j.points("c_total")
    assert t.points("c_total", labels={"w": "a"}) == \
        j.points("c_total", labels={"w": "a"})
    for w in (5.0, 15.0, 60.0):
        assert t.rate("c_total", window_s=w, now=now) == \
            j.rate("c_total", window_s=w, now=now)
        assert t.delta("q", window_s=w, now=now) == \
            j.delta("q", window_s=w, now=now)
        assert t.histogram_window("lat_ms", window_s=w, now=now) == \
            j.histogram_window("lat_ms", window_s=w, now=now)
        for q in (50, 99):
            assert t.percentile_over("lat_ms", q, window_s=w, now=now) == \
                j.percentile_over("lat_ms", q, window_s=w, now=now)
        assert t.fraction_over("lat_ms", 250.0, window_s=w, now=now) == \
            j.fraction_over("lat_ms", 250.0, window_s=w, now=now)
    assert t.last_points_by_label("c_total") == \
        j.last_points_by_label("c_total")
    ts, js = t.snapshot("q"), j.snapshot("q")
    assert ts["points"] == js["points"] and ts["schema"] == js["schema"]
