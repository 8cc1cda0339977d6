"""The port's request tracing (deeplearning4j_tpu_torch/telemetry/trace.py),
histogram exemplars and open-loop load generator, on the CPU.

Mirrors ``tests/test_trace.py`` (span model, JSONL begin/end records,
flight recorder, W3C ``traceparent``) and ``tests/test_serve.py``'s
``TestServeTracing`` and load-generator tests. The engine's spans must
carry the JAX engine's names, parents and attributes for the same request
sequence (ids and times aside), and ``tools/trace_report.py`` must read a
port trace, including the open spans a ``kill -9`` leaves behind. The HTTP
``traceparent`` end-to-end test waits for ``ui/server.py`` (slice 9).
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import json
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_lm_init import lm_params_np
from deeplearning4j_tpu.serve import loadgen as jloadgen
from deeplearning4j_tpu.serve.engine import DecodeEngine as JaxEngine
from deeplearning4j_tpu.telemetry import trace as jtr
from deeplearning4j_tpu.telemetry.registry import (
    MetricsRegistry as JaxRegistry,
)
from deeplearning4j_tpu_torch.interop import lm_params_from_numpy
from deeplearning4j_tpu_torch.serve import (
    DecodeEngine,
    LoadReport,
    arrival_schedule,
    run_open_loop,
    run_open_loop_http,
)
from deeplearning4j_tpu_torch.serve import loadgen as tloadgen
from deeplearning4j_tpu_torch.telemetry import trace as tr
from deeplearning4j_tpu_torch.telemetry.registry import (
    Histogram,
    MetricsRegistry,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools.trace_report import (  # noqa: E402
    load_trace_dir,
    render_serve_text,
    serve_attribution,
)

V, D, H, E, DFF, L = 61, 16, 2, 4, 32, 2
MAXLEN = 32
# span attributes that are times (they differ between any two runs)
_TIMES = {"queue_wait_ms", "prefill_ms", "prefill_cached_ms",
          "prefill_suffix_ms", "decode_ms", "gap_ms", "latency_ms",
          "cached_ms", "suffix_ms", "draft_ms"}


@pytest.fixture(scope="module")
def np_params():
    return lm_params_np(0, V, D, H, E, DFF, L)


@pytest.fixture(scope="module")
def params(np_params):
    return lm_params_from_numpy(np_params, "cpu")


@pytest.fixture
def no_global_tracer():
    prev = tr.set_tracer(None)
    yield
    tr.set_tracer(prev)


@pytest.fixture
def tracer(tmp_path):
    t = tr.Tracer("serve-test", trace_dir=str(tmp_path / "trace"),
                  registry=MetricsRegistry())
    prev = tr.set_tracer(t)
    yield t
    tr.set_tracer(prev)
    t.close()


def _prompts(n, seed=1, lo=3, hi=12):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, V, rng.randint(lo, hi))))
            for _ in range(n)]


def _engine(params, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", MAXLEN)
    kw.setdefault("serve_dtype", None)
    kw.setdefault("registry", MetricsRegistry())
    return DecodeEngine(params, H, device="cpu", **kw)


def _read_records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


# ------------------------------------------------------------ span model ----

class TestSpans:
    def test_nesting_parents_and_jsonl_records(self, tmp_path,
                                               no_global_tracer):
        t = tr.Tracer("p0", trace_dir=str(tmp_path),
                      registry=MetricsRegistry())
        with t.span("outer", attrs={"k": 1}) as outer:
            assert t.current_span() is outer
            with t.span("inner") as inner:
                assert inner.parent_id == outer.span_id
                assert inner.trace_id == outer.trace_id
            assert t.current_span() is outer
        assert t.current_span() is None
        recs = _read_records(tmp_path / "spans_p0.jsonl")
        assert [r["ev"] for r in recs] == ["B", "B", "E", "E"]
        assert recs[0]["name"] == "outer" and recs[1]["name"] == "inner"
        assert recs[2]["name"] == "inner" and recs[2]["status"] == "ok"
        assert recs[2]["dur_ms"] >= 0
        assert recs[0]["schema"] == jtr.SCHEMA

    def test_records_have_the_jax_tracers_fields(self, tmp_path,
                                                 no_global_tracer):
        """The same span through both tracers gives records with the same
        keys, names, statuses, attributes and events."""
        out = []
        for mod, name in ((tr, "port"), (jtr, "jax")):
            t = mod.Tracer(name, trace_dir=str(tmp_path / name),
                           registry=(MetricsRegistry() if mod is tr
                                     else JaxRegistry()))
            with t.span("outer", attrs={"k": 1, "x": [1.5, 2]}) as sp:
                sp.add_event("ev", detail="d", n=3)
                sp.set_attr("late", True)
            t.close()
            out.append(_read_records(
                tmp_path / name / f"spans_{name}.jsonl"))
        for a, b in zip(*out):
            assert set(a) == set(b)
            for key in ("ev", "name", "status", "attrs", "error"):
                assert a.get(key) == b.get(key), key
            assert [{k: v for k, v in e.items() if k != "ts"}
                    for e in a.get("events", [])] == \
                [{k: v for k, v in e.items() if k != "ts"}
                 for e in b.get("events", [])]

    def test_error_status_and_events(self, tmp_path, no_global_tracer):
        t = tr.Tracer("p0", trace_dir=str(tmp_path),
                      registry=MetricsRegistry())
        with pytest.raises(ValueError):
            with t.span("boom") as sp:
                sp.add_event("about_to_fail", detail="x")
                raise ValueError("synthetic")
        end = [r for r in _read_records(tmp_path / "spans_p0.jsonl")
               if r["ev"] == "E"][0]
        assert end["status"] == "error"
        assert "synthetic" in end["error"]
        assert end["events"][0]["name"] == "about_to_fail"
        assert t.registry.counter("trace_spans_error_total").value == 1

    def test_wire_context_parents_across_tracers(self, tmp_path,
                                                 no_global_tracer):
        master = tr.Tracer("master", trace_dir=str(tmp_path),
                           registry=MetricsRegistry())
        worker = tr.Tracer("worker", trace_dir=str(tmp_path),
                           registry=MetricsRegistry())
        root = master.start_span("round", attrs={"round": 0})
        ctx = json.loads(json.dumps(root.context()))
        child = worker.start_span("work", parent=ctx)
        child.end()
        root.end()
        assert child.trace_id == root.trace_id
        assert child.parent_id == root.span_id

    def test_thread_local_current_span(self, tmp_path, no_global_tracer):
        t = tr.Tracer("p0", trace_dir=str(tmp_path),
                      registry=MetricsRegistry())
        seen = {}

        def other_thread():
            seen["current"] = t.current_span()

        with t.span("main-thread"):
            th = threading.Thread(target=other_thread)
            th.start()
            th.join(timeout=10)
            assert not th.is_alive()
        assert seen["current"] is None

    def test_maybe_span_is_noop_without_tracer(self, no_global_tracer):
        assert tr.get_tracer() is None
        with tr.maybe_span("anything", attrs={"x": 1}) as sp:
            assert sp is None
        assert tr.current_trace_context() is None

    def test_configure_installs_the_process_tracer(self, tmp_path,
                                                   no_global_tracer):
        t = tr.configure("cfg", str(tmp_path), crash_hooks=False,
                         registry=MetricsRegistry())
        try:
            assert tr.get_tracer() is t
            with tr.maybe_span("s") as sp:
                assert tr.current_trace_context() == sp.context()
        finally:
            t.close()
        assert os.path.exists(tmp_path / "spans_cfg.jsonl")


class TestFlightRecorder:
    def test_dump_contents(self, tmp_path, no_global_tracer):
        reg = MetricsRegistry()
        reg.counter("workers_failed").inc(2)
        t = tr.Tracer("w0", trace_dir=str(tmp_path), registry=reg)
        with t.span("done-span"):
            pass
        open_span = t.start_span("stuck-span", attrs={"round": 3})
        path = t.dump("SIGTERM", error=RuntimeError("killed"),
                      extra={"note": "test"})
        assert path == str(tmp_path / "flightrec_w0.json")
        dump = json.load(open(path))
        assert dump["reason"] == "SIGTERM"
        assert "killed" in dump["error"]
        assert dump["extra"]["note"] == "test"
        assert [s["name"] for s in dump["open"]] == ["stuck-span"]
        assert dump["open"][0]["open"] is True
        assert any(r["name"] == "done-span" for r in dump["recent"])
        counters = {c["name"]: c["value"]
                    for c in dump["counters"]["counters"]}
        assert counters["workers_failed"] == 2
        # this host has no CUDA: the memory probe reports nothing
        assert dump["device_memory"] == []
        open_span.end()

    def test_checkpoint_rate_limit(self, tmp_path, no_global_tracer):
        t = tr.Tracer("w0", trace_dir=str(tmp_path),
                      registry=MetricsRegistry(),
                      min_checkpoint_interval_s=60.0)
        assert t.flight_checkpoint() is not None
        assert t.flight_checkpoint() is None
        assert t.dump("crash") is not None
        assert json.load(open(t.flight_path))["device_memory"] == []

    def test_dump_never_raises(self, tmp_path, no_global_tracer):
        t = tr.Tracer("w0", trace_dir=str(tmp_path),
                      flight_path="/nonexistent-dir/cannot/write.json",
                      registry=MetricsRegistry())
        assert t.dump("crash") is None


class TestTraceparent:
    def test_format_pads_internal_ids_to_w3c_width(self):
        hdr = tr.format_traceparent({"trace_id": "ab" * 8,
                                     "span_id": "cd" * 4})
        version, trace_id, span_id, flags = hdr.split("-")
        assert version == "00" and flags == "01"
        assert len(trace_id) == 32 and trace_id.endswith("ab" * 8)
        assert len(span_id) == 16 and span_id.endswith("cd" * 4)
        assert hdr == jtr.format_traceparent({"trace_id": "ab" * 8,
                                              "span_id": "cd" * 4})

    def test_parse_format_round_trip(self):
        ctx = {"trace_id": "a" * 32, "span_id": "b" * 16}
        assert tr.parse_traceparent(tr.format_traceparent(ctx)) == ctx

    @pytest.mark.parametrize("bad", [
        None, "", "garbage", "00-short-ffffffffffffffff-01",
        "00-" + "g" * 32 + "-" + "f" * 16 + "-01",
        "00-" + "0" * 32 + "-" + "f" * 16 + "-01",
        "00-" + "f" * 32 + "-" + "0" * 16 + "-01",
        "ff-" + "f" * 32 + "-" + "f" * 16 + "-01",
        "0-" + "f" * 32 + "-" + "f" * 16 + "-01",
        "00-" + "f" * 32 + "-" + "f" * 16,
    ])
    def test_malformed_headers_parse_to_none(self, bad):
        assert tr.parse_traceparent(bad) is None

    def test_future_version_with_extra_fields_accepted(self):
        hdr = "01-" + "a" * 32 + "-" + "b" * 16 + "-01-extra"
        assert tr.parse_traceparent(hdr) == {"trace_id": "a" * 32,
                                             "span_id": "b" * 16}

    def test_remote_trace_id_flows_through_spans(self, tmp_path,
                                                 no_global_tracer):
        tracer = tr.Tracer("srv", trace_dir=str(tmp_path),
                           registry=MetricsRegistry())
        ctx = tr.parse_traceparent("00-" + "a" * 32 + "-" + "b" * 16 + "-01")
        with tracer.span("http.request", parent=ctx) as sp:
            assert sp.trace_id == "a" * 32
            assert sp.parent_id == "b" * 16
            assert tr.format_traceparent(sp.context()) == \
                f"00-{'a' * 32}-{sp.span_id}-01"
        tracer.close()
        recs = _read_records(str(tmp_path / "spans_srv.jsonl"))
        assert recs[0]["trace_id"] == "a" * 32


# ------------------------------------------------------- engine tracing ----

class TestServeTracing:
    def _load(self, tracer):
        return load_trace_dir(os.path.dirname(tracer.path))

    def test_request_span_tree_and_attribution(self, params, tracer):
        eng = _engine(params, weight_version="w-test")
        reqs = [eng.submit(p, max_new_tokens=3)
                for p in _prompts(4, seed=11)]
        eng.run_until_idle()
        assert all(r.done.is_set() for r in reqs)
        spans = self._load(tracer)
        by_name = {}
        for sp in spans.values():
            by_name.setdefault(sp["name"], []).append(sp)
        assert len(by_name["serve.request"]) == 4
        for req_span in by_name["serve.request"]:
            assert req_span.get("end") is not None
            kids = [sp for sp in spans.values()
                    if sp.get("parent_id") == req_span["span_id"]]
            assert sorted(k["name"] for k in kids) == [
                "serve.decode", "serve.prefill", "serve.queue_wait",
                "serve.retire"]
            decode = [k for k in kids if k["name"] == "serve.decode"][0]
            accepts = [e for e in decode["events"] if e["name"] == "accept"]
            assert len(accepts) == 3
            retire = [k for k in kids if k["name"] == "serve.retire"][0]
            assert retire["attrs"]["reason"] == "max_new_tokens"
            assert retire["attrs"]["weight_version"] == "w-test"
        steps = by_name["engine.step"]
        assert steps and all(s.get("end") is not None for s in steps)
        assert sum(s["attrs"].get("admissions", 0) for s in steps) == 4
        assert max(s["attrs"].get("occupancy", 0) for s in steps) == 2
        assert sum(s["attrs"].get("retired", 0) for s in steps) == 4
        rows = serve_attribution(spans)
        assert len(rows) == 4
        for row in rows:
            assert row["status"] == "ok"
            total = (row["queue_wait_ms"] + row["prefill_ms"]
                     + row["decode_ms"] + row["gap_ms"])
            assert abs(total - row["total_ms"]) <= 1.0, row
            assert row["tokens"] == 3
            assert row["weight_version"] == "w-test"

    def test_queue_wait_attributed_under_contention(self, params, tracer):
        eng = _engine(params, n_slots=1)
        for p in _prompts(3, seed=12):
            eng.submit(p, max_new_tokens=4)
        eng.run_until_idle()
        rows = sorted(serve_attribution(self._load(tracer)),
                      key=lambda r: r["rid"])
        assert rows[0]["queue_wait_ms"] < rows[-1]["queue_wait_ms"]
        assert rows[-1]["queue_wait_ms"] > rows[-1]["prefill_ms"]

    def test_greedy_parity_with_tracer_armed(self, params, tracer):
        """Arming the tracer changes nothing about the decode math."""
        prompts = _prompts(3, seed=13)
        traced = _engine(params)
        outs = [traced.generate(p, max_new_tokens=5) for p in prompts]
        prev = tr.set_tracer(None)
        try:
            plain = _engine(params)
            want = [plain.generate(p, max_new_tokens=5) for p in prompts]
        finally:
            tr.set_tracer(prev)
        assert outs == want

    def test_fast_path_attribution_cached_vs_suffix_and_verify(
            self, params, tracer):
        eng = _engine(params, prefix_cache=True, prefix_page_tokens=4,
                      speculative=2)
        prompt = _prompts(1, seed=18, lo=9, hi=10)[0]  # 2 pages = n-1
        want = eng.generate(prompt, max_new_tokens=4)
        assert eng.generate(prompt, max_new_tokens=4) == want
        rows = sorted(serve_attribution(self._load(tracer)),
                      key=lambda r: r["rid"])
        assert len(rows) == 2
        cold, warm = rows
        assert cold["cached_tokens"] == 0
        assert cold["prefill_suffix_ms"] > 0
        assert warm["cached_tokens"] == 8
        assert warm["prefill_cached_ms"] > 0
        assert warm["prefill_suffix_ms"] == 0
        for r in rows:
            assert r["verify_steps"] > 0
            assert 0 <= r["spec_accepted_tokens"] <= r["tokens"]
        text = render_serve_text(rows)
        assert "cached" in text and "acc" in text

    def test_zero_cost_unconfigured(self, params, no_global_tracer):
        eng = _engine(params, n_slots=1)
        req = eng.submit(_prompts(1, seed=14)[0], max_new_tokens=2)
        eng.run_until_idle()
        assert req.span is None and req.queue_span is None
        assert req.decode_span is None and req.prefill_span is None
        assert req.decode_ms == 0.0 and req.trace_id is None
        for name in ("serve_request_ms", "serve_prefill_ms"):
            assert "exemplars" not in \
                eng.registry.histogram(name).snapshot()

    def test_span_tree_equals_jax_engine(self, np_params, params, tmp_path):
        """The same requests through both engines, each with its own
        package's tracer: the same span names, parents, attributes and
        events per request, and the same engine.step sequence; only ids
        and times differ."""
        knobs = dict(n_slots=2, max_len=MAXLEN, serve_dtype=None,
                     prefix_cache=True, prefix_page_tokens=4,
                     prefill_chunk=4, speculative=2,
                     weight_version="w-eq")
        rng = np.random.RandomState(48)
        shared = list(map(int, rng.randint(0, V, 8)))
        prompts = [shared + list(map(int, rng.randint(0, V, w)))
                   for w in (3, 1, 9)] + _prompts(2, seed=49)
        trees = []
        for mod, make in (
                (jtr, lambda: JaxEngine(
                    jax.tree_util.tree_map(jnp.asarray, np_params), H,
                    registry=JaxRegistry(), **knobs)),
                (tr, lambda: DecodeEngine(params, H, device="cpu",
                                          registry=MetricsRegistry(),
                                          **knobs))):
            name = mod.__name__.split(".")[0]
            t = mod.Tracer(name, trace_dir=str(tmp_path / name))
            prev = mod.set_tracer(t)
            try:
                eng = make()
                for p in prompts:
                    eng.submit(p, max_new_tokens=4)
                eng.run_until_idle()
            finally:
                mod.set_tracer(prev)
                t.close()
            trees.append(_normalized(load_trace_dir(str(tmp_path / name))))
        jtree, ttree = trees
        assert len(ttree["requests"]) == len(prompts)
        assert ttree == jtree

    def test_kill9_leaves_open_request_span_reconstructable(self, tmp_path):
        """kill -9 of a serving process leaves open ``serve.request``
        spans the report reconstructs from the eager begin records."""
        import signal

        child = tmp_path / "serve_trace_child.py"
        child.write_text(_CHILD)
        trace_dir = str(tmp_path / "trace")
        proc = subprocess.Popen([sys.executable, str(child), REPO,
                                 trace_dir], stdout=subprocess.PIPE,
                                text=True)
        try:
            line = proc.stdout.readline()
            assert line.strip() == "READY", line
            proc.send_signal(signal.SIGKILL)
        finally:
            proc.wait(timeout=30)
            proc.stdout.close()
        spans = load_trace_dir(trace_dir)
        rows = serve_attribution(spans)
        assert len(rows) == 1
        row = rows[0]
        assert row["status"] == "open"
        assert row["rid"] == 0
        assert row["process"] == "serve-victim"
        open_names = {sp["name"] for sp in spans.values()
                      if sp.get("end") is None}
        assert "serve.request" in open_names
        assert "serve.decode" in open_names


_CHILD = '''
import sys
import time

sys.path.insert(0, sys.argv[1])

import torch

from deeplearning4j_tpu_torch.models.transformer_lm import init_lm_params
from deeplearning4j_tpu_torch.serve import DecodeEngine
from deeplearning4j_tpu_torch.telemetry import trace as tr

tr.configure("serve-victim", sys.argv[2], crash_hooks=False)
params = init_lm_params(torch.Generator().manual_seed(0), 31, 8, 2, 2, 16,
                        n_layers=1, device="cpu")
engine = DecodeEngine(params, 2, n_slots=1, max_len=2048, serve_dtype=None,
                      device="cpu")
engine.start()
req = engine.submit([1, 2, 3], max_new_tokens=1_000_000)
while not req.generated:
    time.sleep(0.01)
print("READY", flush=True)
time.sleep(120)
engine.stop()
'''


def _normalized(spans):
    """A trace with ids and times taken out: per request (by rid) its own
    attributes and its children's names, attributes and events; and the
    engine.step spans' attributes in start order."""
    def attrs(sp):
        return {k: v for k, v in sp.get("attrs", {}).items()
                if k not in _TIMES}

    def events(sp):
        return [{k: v for k, v in e.items() if k != "ts"}
                for e in sp.get("events", [])]

    kids = {}
    for sp in spans.values():
        kids.setdefault(sp.get("parent_id"), []).append(sp)
    requests = {}
    for sp in spans.values():
        if sp["name"] != "serve.request":
            continue
        assert sp.get("parent_id") is None and sp.get("end") is not None
        requests[sp["attrs"]["rid"]] = {
            "attrs": attrs(sp), "status": sp.get("status"),
            "children": sorted(
                ((c["name"], json.dumps(attrs(c), sort_keys=True),
                  json.dumps(events(c), sort_keys=True),
                  len(kids.get(c["span_id"], [])))
                 for c in kids.get(sp["span_id"], [])))}
        assert all(c["trace_id"] == sp["trace_id"]
                   for c in kids.get(sp["span_id"], []))
    steps = sorted((sp for sp in spans.values()
                    if sp["name"] == "engine.step"),
                   key=lambda sp: sp["start"])
    return {"requests": requests,
            "steps": [attrs(sp) for sp in steps],
            "names": sorted({sp["name"] for sp in spans.values()})}


# ------------------------------------------------------------- exemplars ----

class TestExemplars:
    def test_explicit_and_current_span_exemplars(self, tmp_path,
                                                 no_global_tracer):
        h = Histogram(buckets=(1.0, 10.0))
        h.observe(0.5)
        assert "exemplars" not in h.snapshot() and h.exemplars() == []
        h.observe(5.0, exemplar="abc")
        h.observe(50.0, exemplar="def")
        h.observe(6.0, exemplar="ghi")      # latest wins per bucket
        ex = h.exemplars()
        assert [(e["le"], e["trace_id"], e["value"]) for e in ex] == [
            (10.0, "ghi", 6.0), (float("inf"), "def", 50.0)]
        assert h.snapshot()["exemplars"] == ex
        assert h.count == 4
        t = tr.Tracer("ex", trace_dir=str(tmp_path),
                      registry=MetricsRegistry())
        tr.set_tracer(t)
        with t.span("work") as sp:
            h.observe(0.1)
        assert h.exemplars()[0]["trace_id"] == sp.trace_id
        t.close()

    def test_snapshot_shape_matches_jax_registry(self):
        from deeplearning4j_tpu.telemetry.registry import (
            Histogram as JaxHistogram,
        )

        th, jh = Histogram(), JaxHistogram()
        for h in (th, jh):
            h.observe(3.0, exemplar="t1")
            h.observe(3000.0, exemplar="t2")
        ts, js = th.snapshot(), jh.snapshot()
        assert set(ts) == set(js)
        assert ts["buckets"] == js["buckets"]
        strip = [{k: v for k, v in e.items() if k != "ts"}
                 for e in ts["exemplars"]]
        assert strip == [{k: v for k, v in e.items() if k != "ts"}
                         for e in js["exemplars"]]

    def test_engine_attaches_request_trace_ids(self, params, tracer):
        eng = _engine(params, speculative=2)
        reqs = [eng.submit(p, max_new_tokens=4)
                for p in _prompts(2, seed=27)]
        eng.run_until_idle()
        ids = {r.trace_id for r in reqs}
        assert None not in ids and len(ids) == 2
        for name in ("serve_prefill_ms", "serve_verify_step_ms",
                     "serve_spec_accepted_per_verify", "serve_request_ms",
                     "serve_first_token_ms"):
            ex = eng.registry.histogram(name).exemplars()
            assert ex and {e["trace_id"] for e in ex} <= ids, name


# --------------------------------------------------------------- loadgen ----

class TestLoadgen:
    @pytest.mark.parametrize("seed,rate", [(0, 10.0), (3, 0.5), (11, 300.0)])
    def test_arrival_schedule_equals_jax(self, seed, rate):
        got = arrival_schedule(16, rate, seed=seed)
        assert got == jloadgen.arrival_schedule(16, rate, seed=seed)
        assert all(x < y for x, y in zip(got, got[1:]))

    def test_arrival_schedule_deterministic(self):
        a = arrival_schedule(16, 10.0, seed=3)
        assert a == arrival_schedule(16, 10.0, seed=3) and len(a) == 16
        with pytest.raises(ValueError):
            arrival_schedule(4, 0.0)

    def test_percentiles_goodput_and_report_equal_jax(self):
        vals = list(np.random.RandomState(5).exponential(20.0, 37))
        assert tloadgen._percentiles(vals) == jloadgen._percentiles(vals)
        assert tloadgen._percentiles([]) == (0.0, 0.0, 0.0, 0.0)
        for slo in (None, 1e-9, 15.0, 1e9):
            assert tloadgen._goodput(vals, slo, 2.5) == \
                jloadgen._goodput(vals, slo, 2.5)
        import dataclasses

        assert [f.name for f in dataclasses.fields(LoadReport)] == \
            [f.name for f in dataclasses.fields(jloadgen.LoadReport)]

    def test_open_loop_drives_engine_to_completion(self, params):
        eng = _engine(params)
        eng.generate([1] * 5, max_new_tokens=2)  # warm
        rep = run_open_loop(eng, _prompts(6, seed=8), rate_rps=300.0,
                            max_new_tokens=4)
        assert rep.completed == rep.n_requests == 6
        assert rep.tokens_out == 6 * 4
        assert rep.tokens_per_sec > 0
        assert rep.latency_p99_ms >= rep.latency_p95_ms >= \
            rep.latency_p50_ms > 0
        assert rep.first_token_p99_ms >= rep.first_token_p50_ms > 0
        d = rep.to_dict()
        assert d["offered_rps"] == 300.0
        assert d["slo_ms"] is None and d["goodput_rps"] is None

    def test_open_loop_inter_token_percentiles(self, params):
        eng = _engine(params, prefill_chunk=4)
        rep = run_open_loop(eng, _prompts(4, seed=19), rate_rps=300.0,
                            max_new_tokens=4)
        assert rep.completed == 4
        assert rep.inter_token_p99_ms >= rep.inter_token_p50_ms > 0
        rep1 = run_open_loop(_engine(params), _prompts(2, seed=20),
                             rate_rps=300.0, max_new_tokens=1)
        assert rep1.inter_token_p50_ms is None

    def test_open_loop_goodput_under_slo(self, params):
        eng = _engine(params)
        prompts = _prompts(6, seed=8)
        tight = run_open_loop(eng, prompts, rate_rps=300.0,
                              max_new_tokens=4, slo_ms=1e-9)
        assert tight.slo_attainment == 0.0 and tight.goodput_rps == 0.0
        loose = run_open_loop(eng, prompts, rate_rps=300.0,
                              max_new_tokens=4, slo_ms=1e9)
        assert loose.slo_attainment == 1.0
        assert loose.goodput_rps == pytest.approx(
            loose.completed / loose.duration_s)

    def test_open_loop_waits_for_the_schedule(self, params):
        """Arrivals follow the schedule: the run lasts at least until the
        last scheduled arrival, and latency counts from it."""
        eng = _engine(params)
        offsets = arrival_schedule(3, 20.0, seed=4)
        t0 = time.perf_counter()
        rep = run_open_loop(eng, _prompts(3, seed=9), rate_rps=20.0,
                            max_new_tokens=2, seed=4)
        assert time.perf_counter() - t0 >= offsets[-1]
        assert rep.duration_s >= offsets[-1] and rep.completed == 3

    def test_http_driver_names_its_slice(self):
        """The HTTP driver (item 21c; tests/test_torch_ui.py drives it
        against both packages' servers) counts a request whose POST
        finds no server as not completed, as JAX's does."""
        rep = run_open_loop_http("http://127.0.0.1:1", [[1, 2]], 1.0,
                                 timeout_s=10.0)
        assert rep.n_requests == 1 and rep.completed == 0
        assert rep.tokens_out == 0
