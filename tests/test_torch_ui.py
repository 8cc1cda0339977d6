"""The port's UI server (deeplearning4j_tpu_torch/ui/) and HTTP load driver
(``serve.loadgen.run_open_loop_http``) held against the JAX package's:
every case of tests/test_ui.py (``TestTraceparentPropagation`` included)
through the port, the UI cases of test_fleet.py
(``test_uiserver_fleet_surface``), test_federation.py (``TestClusterUi``),
test_runprof.py (``TestUiProfilingRoute``), test_xprofile.py
(``test_ui_serves_api_profile``) and test_alerts.py (``TestAlertUi``),
plus

- the index, the render pages and the ``/api/*`` payloads equal to JAX's
  server's byte for byte for the same uploads (the weight histograms and
  filter tiles of two nets with the same params; activations within
  ``ACT_TOL``, the two forwards summing in other orders);
- ``/api/generate`` tokens equal to JAX's ``UiServer`` over JAX's engine
  from the same params;
- one HTTP wire: the port's ``run_open_loop_http`` against JAX's server,
  and JAX's against the port's, every request answered with the engine's
  tokens.

Greedy f32 tokens are exact; ``ACT_TOL`` (1e-5 of a layer's largest
activation) is the only tolerance.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import http.client
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from deeplearning4j_tpu_torch.interop import (
    lm_params_from_numpy,
    mln_params_from_numpy,
    tree_to_numpy,
)
from deeplearning4j_tpu_torch.scaleout.statetracker import \
    InMemoryStateTracker
from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry
from deeplearning4j_tpu_torch.ui import UiServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACT_TOL = 1e-5
V, D, H, E, DFF = 31, 8, 2, 2, 16


@pytest.fixture
def server(tmp_path):
    s = UiServer(artifact_dir=str(tmp_path))
    (tmp_path / "w.svg").write_text("<svg></svg>")
    words = ["king", "queen", "apple", "banana"]
    vecs = np.array([[1, 0.9, 0], [0.9, 1, 0], [0, 0, 1], [0, 0.1, 1]], float)
    s.upload_word_vectors(words, vecs)
    s.upload_tsne(np.array([[0.0, 1.0], [1.0, 0.0]]), ["a", "b"])
    s.upload_weight_histograms({"layer0_W": {"counts": [1, 2]}})
    s.start(port=0)
    yield s
    s.stop()


def _get(server, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}{path}") as r:
        return r.status, r.read()


def _raw_get(port, path):
    """(status, content type, body) of a GET, error statuses included."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def test_index(server):
    status, body = _get(server, "/")
    assert status == 200 and b"deeplearning4j-tpu" in body


def test_words_endpoint(server):
    status, body = _get(server, "/api/words")
    data = json.loads(body)
    assert data["count"] == 4 and "king" in data["words"]


def test_nearest_neighbours(server):
    _, body = _get(server, "/api/nearest?word=king&n=2")
    names = [h["word"] for h in json.loads(body)["neighbours"]]
    assert names[0] == "queen"
    assert "king" not in names


def test_nearest_unknown_word(server):
    _, body = _get(server, "/api/nearest?word=zzz")
    assert json.loads(body)["neighbours"] == []


def test_tsne_and_weights(server):
    _, body = _get(server, "/api/tsne")
    assert json.loads(body)["labels"] == ["a", "b"]
    _, body = _get(server, "/api/weights")
    assert "layer0_W" in json.loads(body)


def test_artifact_listing_and_file(server):
    _, body = _get(server, "/artifacts/")
    assert b"w.svg" in body
    status, body = _get(server, "/artifacts/w.svg")
    assert status == 200 and body == b"<svg></svg>"


def test_artifact_traversal_blocked(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server, "/artifacts/../../etc/passwd")
    assert e.value.code == 404


def test_unknown_route_404(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server, "/nope")
    assert e.value.code == 404


def test_render_views_serve_html(server):
    for path, marker in [("/render/tsne", b"/api/tsne"),
                         ("/render/weights", b"/api/weights"),
                         ("/render/words", b"/api/nearest")]:
        status, body = _get(server, path)
        assert status == 200
        assert body.startswith(b"<!doctype html>")
        assert marker in body and b"<script>" in body


def _digits_conv_nets():
    """JAX's digits_conv net and the port's from the same params."""
    from deeplearning4j_tpu.models.zoo import digits_conv as j_digits_conv
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu_torch.models.zoo import digits_conv
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    jnet = JNet(j_digits_conv(num_iterations=2)).init()
    # each layer's keys in JAX's order (jax.tree_util would sort them), so
    # payloads that iterate them serialize alike
    params = mln_params_from_numpy(
        [{k: np.asarray(v) for k, v in layer.items()}
         for layer in jnet.params_tree], device="cpu")
    net = MultiLayerNetwork(digits_conv(num_iterations=2), params=params,
                            device="cpu")
    return jnet, net


def test_filters_and_activations_from_trained_conv_net():
    """/render/filters and /render/activations serve artifacts extracted
    from a port conv net after a training step."""
    from deeplearning4j_tpu_torch.models.zoo import digits_conv
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    rng = np.random.RandomState(3)
    x = rng.rand(16, 64).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 16)]
    net = MultiLayerNetwork(digits_conv(num_iterations=2),
                            device="cpu").init()
    net.fit(x, y)

    s = UiServer()
    s.upload_filters(net)
    s.upload_activations(net, x[:8])
    s.start(port=0)
    try:
        _, body = _get(s, "/api/filters")
        grids = json.loads(body)["grids"]
        assert grids, "no filter grids extracted"
        conv = grids[0]
        assert conv["name"] == "layer0/convweights"
        assert conv["width"] == 3 and conv["height"] == 3
        assert len(conv["tiles"]) == 16
        flat = [v for t in conv["tiles"] for row in t for v in row]
        assert max(flat) <= 1.0 and min(flat) >= 0.0
        _, body = _get(s, "/api/activations")
        layers = json.loads(body)["layers"]
        assert len(layers) >= 4  # conv, pool, dense, output
        assert layers[0]["rows"] == 8
        assert all(np.isfinite(L["mean"]) for L in layers)
        for path in ("/render/filters", "/render/activations"):
            status, body = _get(s, path)
            assert status == 200 and b"<script>" in body
    finally:
        s.stop()


def _mlp_conf(mod, n_in, hidden, n_out, layers):
    b = (mod.NeuralNetConfiguration.Builder()
         .n_in(n_in).n_out(hidden).activation_function("tanh")
         .list(layers))
    last = layers - 1
    kw = dict(layer_type="OUTPUT", activation_function="softmax",
              loss_function="MCXENT")
    if layers > 1:
        kw.update(n_in=hidden, n_out=n_out)
    return b.override(last, **kw).pretrain(False).backward(True).build()


def test_mlp_first_layer_filters_square_input():
    from deeplearning4j_tpu_torch.nn import conf as tconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ui.views import filter_grids

    net = MultiLayerNetwork(_mlp_conf(tconf, 64, 12, 3, 2),
                            device="cpu").init()
    grids = filter_grids(net)
    assert grids and grids[0]["name"] == "layer0/W"
    assert grids[0]["width"] == 8 and len(grids[0]["tiles"]) == 12


def test_tsne_view_has_pan_zoom(server):
    _, body = _get(server, "/render/tsne")
    assert b"viewBox" in body and b"wheel" in body and b"dblclick" in body


def test_weight_histograms_helper():
    from deeplearning4j_tpu_torch.nn import conf as tconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ui.views import weight_histograms

    net = MultiLayerNetwork(_mlp_conf(tconf, 4, 3, 3, 1),
                            device="cpu").init()
    hists = weight_histograms(net, bins=10)
    assert "layer0/W" in hists and "layer0/b" in hists
    h = hists["layer0/W"]
    assert len(h["counts"]) == 10 and len(h["edges"]) == 11
    assert sum(h["counts"]) == 4 * 3


def _post(server, path, body: bytes, ctype="application/json"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}{path}", data=body,
        headers={"Content-Type": ctype})
    with urllib.request.urlopen(req) as r:
        return r.status, r.read()


@pytest.fixture(scope="module")
def np_params():
    """The LM's params as numpy, drawn by the port's init (JAX's costs
    seconds of compiles) and handed to both packages."""
    from deeplearning4j_tpu_torch.models.transformer_lm import init_lm_params

    return tree_to_numpy(init_lm_params(torch.Generator().manual_seed(0), V,
                                        D, H, E, DFF, n_layers=1,
                                        device="cpu"))


@pytest.fixture
def lm_engine(np_params):
    from deeplearning4j_tpu_torch.serve import DecodeEngine

    return DecodeEngine(lm_params_from_numpy(np_params, "cpu"), H,
                        n_slots=2, max_len=16, serve_dtype=None,
                        device="cpu")


def test_api_generate_post_and_serve_stats(server, lm_engine):
    server.attach_engine(lm_engine)
    status, body = _post(server, "/api/generate",
                         json.dumps({"prompt": [1, 2, 3],
                                     "max_new_tokens": 4}).encode())
    assert status == 200
    out = json.loads(body)
    assert len(out["tokens"]) == out["n"] == 4
    assert out["prompt_len"] == 3
    assert all(0 <= t < V for t in out["tokens"])
    status, body = _get(server, "/api/serve")
    assert status == 200
    stats = json.loads(body)
    assert stats["slots"] == 2
    assert stats["tokens_total"] == 4
    assert stats["requests_total"] == 1
    assert stats["queue_depth"] == 0


def test_api_generate_without_engine_404(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/api/generate", b"{}")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server, "/api/serve")
    assert e.value.code == 404


def test_post_error_handling(server, lm_engine):
    server.attach_engine(lm_engine)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/api/generate", b"{not json")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/api/generate", b"[1,2]")
    assert e.value.code == 400
    for bad in ({}, {"prompt": []}, {"prompt": "abc"},
                {"prompt": [1, "x"]}, {"prompt": [True]}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, "/api/generate", json.dumps(bad).encode())
        assert e.value.code == 400, bad
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/api/generate",
              json.dumps({"prompt": [500]}).encode())
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/api/generate",
              json.dumps({"prompt": [1], "max_new_tokens": "many"}).encode())
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/api/nearest", b"{}")
    assert e.value.code == 404


def test_post_missing_content_length_411(server, lm_engine):
    server.attach_engine(lm_engine)
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
    try:
        conn.putrequest("POST", "/api/generate", skip_host=False)
        conn.putheader("Content-Type", "application/json")
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 411
        assert b"Content-Length" in resp.read()
    finally:
        conn.close()


def test_api_generate_concurrent_requests_share_slots(server, lm_engine):
    lm_engine.start()
    try:
        server.attach_engine(lm_engine)
        results = [None, None]

        def fire(i):
            _, body = _post(server, "/api/generate",
                            json.dumps({"prompt": [1 + i, 2],
                                        "max_new_tokens": 3}).encode())
            results[i] = json.loads(body)

        ts = [threading.Thread(target=fire, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
        assert all(r is not None and r["n"] == 3 for r in results)
    finally:
        lm_engine.stop()


def test_api_trace_endpoint(server, tmp_path):
    from deeplearning4j_tpu_torch.telemetry import trace as tr

    prev = tr.set_tracer(None)
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(server, "/api/trace")
        assert exc.value.code == 404
        tracer = tr.Tracer("ui-proc", trace_dir=str(tmp_path / "trace"),
                           registry=MetricsRegistry())
        server.attach_tracer(tracer)
        with tracer.span("finished-op", attrs={"round": 1}):
            pass
        open_span = tracer.start_span("live-op", attrs={"round": 2})
        status, body = _get(server, "/api/trace")
        assert status == 200
        snap = json.loads(body)
        assert snap["process"] == "ui-proc"
        assert [s["name"] for s in snap["open"]] == ["live-op"]
        assert snap["open"][0]["dur_ms"] >= 0
        assert any(r["name"] == "finished-op" for r in snap["recent"])
        open_span.end()
        status, body = _get(server, "/api/trace?limit=1")
        assert len(json.loads(body)["recent"]) == 1
    finally:
        tr.set_tracer(prev)


class TestTraceparentPropagation:
    """Raw http.client POSTs pinning the W3C propagation contract of
    /api/generate, as tests/test_ui.py does."""

    @pytest.fixture
    def tracer(self, tmp_path):
        from deeplearning4j_tpu_torch.telemetry import trace as tr

        tracer = tr.Tracer("ui-test", trace_dir=str(tmp_path / "trace"))
        prev = tr.set_tracer(tracer)
        yield tracer
        tr.set_tracer(prev)
        tracer.close()

    def _post_raw(self, server, body: bytes, headers: dict):
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=30)
        try:
            all_headers = {"Content-Type": "application/json",
                           "Content-Length": str(len(body)), **headers}
            conn.request("POST", "/api/generate", body=body,
                         headers=all_headers)
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), resp.read()
        finally:
            conn.close()

    def _spans(self, tracer):
        sys.path.insert(0, REPO)
        from tools.trace_report import load_trace_dir

        return load_trace_dir(os.path.dirname(tracer.path))

    def test_inbound_traceparent_parents_the_tree(self, server, lm_engine,
                                                  tracer):
        server.attach_engine(lm_engine)
        caller_trace, caller_span = "ab" * 16, "cd" * 8
        hdr = f"00-{caller_trace}-{caller_span}-01"
        status, headers, body = self._post_raw(
            server, json.dumps({"prompt": [1, 2], "max_new_tokens": 2}
                               ).encode(), {"traceparent": hdr})
        assert status == 200
        out = json.loads(body)
        assert out["trace_id"] == caller_trace
        resp_tp = {k.lower(): v for k, v in headers.items()}["traceparent"]
        assert resp_tp.startswith(f"00-{caller_trace}-")
        spans = self._spans(tracer)
        http_sp = [sp for sp in spans.values()
                   if sp["name"] == "http.request"][0]
        assert http_sp["trace_id"] == caller_trace
        assert http_sp["parent_id"] == caller_span
        assert http_sp["attrs"]["remote_trace"] is True
        sreq = [sp for sp in spans.values()
                if sp["name"] == "serve.request"][0]
        assert sreq["trace_id"] == caller_trace
        assert sreq["parent_id"] == http_sp["span_id"]

    def test_without_traceparent_fresh_root(self, server, lm_engine,
                                            tracer):
        server.attach_engine(lm_engine)
        status, headers, body = self._post_raw(
            server, json.dumps({"prompt": [1], "max_new_tokens": 2}
                               ).encode(), {})
        assert status == 200
        assert len(json.loads(body)["trace_id"]) == 32
        spans = self._spans(tracer)
        http_sp = [sp for sp in spans.values()
                   if sp["name"] == "http.request"][0]
        assert http_sp["parent_id"] is None
        assert http_sp["attrs"]["remote_trace"] is False

    def test_malformed_traceparent_tolerated_not_400(self, server,
                                                     lm_engine, tracer):
        server.attach_engine(lm_engine)
        for bad in ("garbage", "00-zz-xx-01",
                    "00-" + "0" * 32 + "-" + "1" * 16 + "-01"):
            status, _headers, body = self._post_raw(
                server, json.dumps({"prompt": [1], "max_new_tokens": 1}
                                   ).encode(), {"traceparent": bad})
            assert status == 200, bad
            out = json.loads(body)
            assert out["trace_id"] not in bad
            assert out["n"] == 1

    def test_tracing_off_no_trace_fields(self, server, lm_engine):
        from deeplearning4j_tpu_torch.telemetry import trace as tr

        assert tr.get_tracer() is None
        server.attach_engine(lm_engine)
        status, headers, body = self._post_raw(
            server, json.dumps({"prompt": [1], "max_new_tokens": 1}
                               ).encode(),
            {"traceparent": "00-" + "a" * 32 + "-" + "b" * 16 + "-01"})
        assert status == 200
        assert "trace_id" not in json.loads(body)
        assert "traceparent" not in {k.lower() for k in headers}


def test_api_serve_exposes_in_flight_ages(server, lm_engine):
    server.attach_engine(lm_engine)
    req = lm_engine.submit([1, 2, 3], max_new_tokens=8)
    _, body = _get(server, "/api/serve")
    flight = json.loads(body)["in_flight"]
    assert len(flight) == 1
    assert flight[0]["rid"] == req.rid
    assert flight[0]["state"] == "queued"
    assert flight[0]["queued_s"] >= 0.0
    assert flight[0]["prompt_len"] == 3
    lm_engine.run_until_idle()
    _, body = _get(server, "/api/serve")
    assert json.loads(body)["in_flight"] == []


# ------------------------------------------------ against JAX's server ----

def _same_uploads(ui_cls, tmp_path, hists, grids):
    s = ui_cls(artifact_dir=str(tmp_path))
    s.upload_word_vectors(["king", "queen", "apple", "banana", "pear"],
                          np.array([[1, 0.9, 0], [0.9, 1, 0], [0, 0, 1],
                                    [0, 0.1, 1], [0.2, 0.1, 0.9]]))
    s.upload_tsne(np.array([[0.0, 1.0], [1.0, 0.5], [0.3, 0.2]]),
                  ["a", "<b>", 3])
    s.upload_weight_histograms(hists)
    s._filters = grids
    s.start(port=0)
    return s


_BYTE_PATHS = ("/", "/index.html", "/render/tsne", "/render/weights",
               "/render/words", "/render/filters", "/render/activations",
               "/api/words", "/api/nearest?word=king&n=3",
               "/api/nearest?word=pear&n=10", "/api/nearest?word=zzz",
               "/api/nearest?word=king&n=x", "/api/nearest?word=king&n=0",
               "/api/tsne", "/api/weights", "/api/filters",
               "/api/activations", "/api/telemetry", "/api/cluster",
               "/api/serve", "/api/fleet", "/metrics",
               "/metrics?scope=galaxy", "/artifacts/", "/artifacts/w.svg",
               "/artifacts/../../etc/passwd", "/artifacts/nope", "/nope")


def test_pages_and_payloads_equal_jax_byte_for_byte(tmp_path):
    """The same uploads (the views' payloads of two digits_conv nets with
    the same params) into both servers: every GET answers the same status,
    content type and bytes."""
    from deeplearning4j_tpu.ui import UiServer as JUi
    from deeplearning4j_tpu.ui import views as jviews
    from deeplearning4j_tpu_torch.ui import views

    jnet, net = _digits_conv_nets()
    mine = views.weight_histograms(net), views.filter_grids(net)
    theirs = jviews.weight_histograms(jnet), jviews.filter_grids(jnet)
    assert json.dumps(mine) == json.dumps(theirs)
    x = np.random.RandomState(4).rand(8, 64).astype(np.float32)
    acts, jacts = (views.activation_summaries(net, x),
                   jviews.activation_summaries(jnet, x))
    for a, b in zip(acts, jacts, strict=True):
        assert (a["name"], a["rows"], a["cols"]) == (b["name"], b["rows"],
                                                     b["cols"])
        scale = max(abs(b["min"]), abs(b["max"]), 1e-30)
        for key in ("mean", "std", "min", "max"):
            assert abs(a[key] - b[key]) <= ACT_TOL * scale, key
        np.testing.assert_allclose(a["matrix"], b["matrix"], atol=2e-4)
    (tmp_path / "w.svg").write_text("<svg></svg>")
    ours = _same_uploads(UiServer, tmp_path, *mine)
    jax_srv = _same_uploads(JUi, tmp_path, *theirs)
    try:
        for path in _BYTE_PATHS:
            assert _raw_get(ours.port, path) == \
                _raw_get(jax_srv.port, path), path
    finally:
        ours.stop()
        jax_srv.stop()


@pytest.fixture(scope="module")
def jax_server(np_params):
    """JAX's UiServer over JAX's started engine on the same params, shared
    by the tests that cross the packages (its compiles are paid once)."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.serve import DecodeEngine as JEngine
    from deeplearning4j_tpu.telemetry.registry import MetricsRegistry as JReg
    from deeplearning4j_tpu.ui import UiServer as JUi

    jeng = JEngine(jax.tree_util.tree_map(jnp.asarray, np_params), H,
                   n_slots=2, max_len=16, serve_dtype=None, registry=JReg())
    srv = JUi()
    srv.attach_engine(jeng)
    jeng.start()
    srv.start(port=0)
    yield srv
    srv.stop()
    jeng.stop()


def test_api_generate_tokens_equal_jax_server(jax_server, lm_engine):
    """/api/generate on the port's server over the port's engine answers
    JAX's server over JAX's engine, from the same params."""
    ours = UiServer()
    ours.attach_engine(lm_engine)
    ours.start(port=0)
    try:
        for prompt in ([1, 2, 3], [5], [7, 8, 9, 10, 11, 12]):
            body = json.dumps({"prompt": prompt,
                               "max_new_tokens": 5}).encode()
            assert _post(ours, "/api/generate", body) == \
                _post(jax_server, "/api/generate", body), prompt
    finally:
        ours.stop()


def test_run_open_loop_http_across_both_servers(jax_server, lm_engine):
    """One HTTP wire: the port's driver against JAX's server and JAX's
    driver against the port's; every request is answered with the tokens
    the serving engine gives in process."""
    from deeplearning4j_tpu.serve.loadgen import \
        run_open_loop_http as j_run_http
    from deeplearning4j_tpu_torch.serve.loadgen import run_open_loop_http

    rng = np.random.RandomState(2)
    prompts = [list(map(int, rng.randint(0, V, rng.randint(2, 6))))
               for _ in range(4)]
    want = [lm_engine.generate(p, max_new_tokens=3) for p in prompts]
    ours = UiServer()
    ours.attach_engine(lm_engine)
    lm_engine.start()
    ours.start(port=0)
    try:
        for driver, srv in ((run_open_loop_http, jax_server),
                            (j_run_http, ours)):
            rep = driver(f"http://127.0.0.1:{srv.port}", prompts, 50.0,
                         max_new_tokens=3, seed=1, timeout_s=60.0)
            assert rep.completed == rep.n_requests == 4
            assert rep.tokens_out == sum(len(w) for w in want)
            assert rep.latency_p50_ms > 0
        got = []
        for p in prompts:
            _, body = _post(jax_server, "/api/generate", json.dumps(
                {"prompt": p, "max_new_tokens": 3}).encode())
            got.append(json.loads(body)["tokens"])
        assert got == want
    finally:
        ours.stop()
        lm_engine.stop()


def test_run_open_loop_http_one_trace_a_request(lm_engine, tmp_path):
    """With a process tracer, each request of the HTTP driver is one
    trace: its ``loadgen.request`` root, the server's ``http.request``
    under it, and the engine's ``serve.request`` under that."""
    from deeplearning4j_tpu_torch.serve.loadgen import run_open_loop_http
    from deeplearning4j_tpu_torch.telemetry import trace as tr

    tracer = tr.Tracer("loadgen", trace_dir=str(tmp_path / "trace"))
    prev = tr.set_tracer(tracer)
    srv = UiServer()
    srv.attach_engine(lm_engine)
    lm_engine.start()
    srv.start(port=0)
    try:
        rep = run_open_loop_http(f"http://127.0.0.1:{srv.port}",
                                 [[1, 2], [3], [4, 5, 6]], 50.0,
                                 max_new_tokens=2, timeout_s=60.0)
        assert rep.completed == 3
    finally:
        srv.stop()
        lm_engine.stop()
        tr.set_tracer(prev)
        tracer.close()
    sys.path.insert(0, REPO)
    from tools.trace_report import load_trace_dir

    spans = load_trace_dir(str(tmp_path / "trace"))
    roots = [s for s in spans.values() if s["name"] == "loadgen.request"]
    assert len(roots) == 3
    for root in roots:
        tree = {s["name"]: s for s in spans.values()
                if s["trace_id"] == root["trace_id"]}
        assert tree["http.request"]["parent_id"] == root["span_id"]
        assert tree["serve.request"]["parent_id"] == \
            tree["http.request"]["span_id"]


# ------------------------------------------------------ fleet surface ----

def test_uiserver_fleet_surface(np_params, lm_engine):
    from deeplearning4j_tpu_torch.serve import DecodeEngine, FleetReplica
    from deeplearning4j_tpu_torch.serve.router import FleetRouter

    tracker = InMemoryStateTracker()
    params = lm_params_from_numpy(np_params, "cpu")
    rep = FleetReplica(DecodeEngine(params, H, n_slots=2, max_len=16,
                                    serve_dtype=None, device="cpu",
                                    registry=MetricsRegistry()),
                       tracker, "r1", heartbeat_s=0.05, poll_s=0.005,
                       publish_s=0.1)
    rep.start()
    router = FleetRouter(tracker, registry=MetricsRegistry(),
                         stale_after_s=1.0, dead_after_s=5.0, poll_s=0.005)
    router.start()
    server = UiServer()
    server.attach_fleet(router, generate_timeout_s=60.0)
    server.start(port=0)
    base = f"http://127.0.0.1:{server.port}"
    try:
        prompt = [1, 2, 3, 4]
        body = json.dumps({"prompt": prompt, "max_new_tokens": 4,
                           "session": "sess-a"}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                base + "/api/generate", data=body,
                headers={"Content-Type": "application/json"}),
                timeout=60) as resp:
            out = json.loads(resp.read())
        assert out["tokens"] == lm_engine.generate(prompt, max_new_tokens=4)
        assert out["n"] == 4 and out["prompt_len"] == 4
        with urllib.request.urlopen(base + "/api/fleet",
                                    timeout=10) as resp:
            fleet = json.loads(resp.read())
        assert fleet["alive"] == 1
        assert fleet["affinity"] == {"sess-a": "r1"}
        assert fleet["replicas"][0]["replica_id"] == "r1"
        assert fleet["completed_total"] == 1
        bad = json.dumps({"prompt": prompt, "session": 7}).encode()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(
                base + "/api/generate", data=bad,
                headers={"Content-Type": "application/json"}), timeout=10)
        assert ei.value.code == 400
    finally:
        server.stop()
        router.stop()
        rep.stop()


# ------------------------------------------------- federation surface ----

def _registry(n_reqs: int, queue_depth: float, obs) -> MetricsRegistry:
    reg = MetricsRegistry()
    reg.counter("serve_requests_total").inc(n_reqs)
    reg.counter("serve_completed_total", {"reason": "eos"}).inc(n_reqs)
    reg.gauge("serve_queue_depth").set(queue_depth)
    for v in obs:
        reg.histogram("serve_request_ms").observe(v)
    return reg


class TestClusterUi:
    @pytest.fixture
    def cluster(self):
        from deeplearning4j_tpu_torch.telemetry.federation import (
            ClusterAggregator,
            MetricsPusher,
        )

        tracker = InMemoryStateTracker()
        MetricsPusher(tracker, "replica-0",
                      registry=_registry(3, 2.0, [3.0])).push_once()
        MetricsPusher(tracker, "replica-1",
                      registry=_registry(4, 7.0, [700.0])).push_once()
        agg = ClusterAggregator(tracker, stale_after_s=60.0,
                                registry=MetricsRegistry())
        server = UiServer()
        server.attach_federation(agg)
        server.start(port=0)
        yield server
        server.stop()

    def test_api_cluster_merges_live_processes(self, cluster):
        status, body = _get(cluster, "/api/cluster")
        assert status == 200
        view = json.loads(body)
        assert len(view["processes"]) == 2
        assert not any(p["stale"] for p in view["processes"])
        counters = {r["name"]: r["value"]
                    for r in view["merged"]["counters"] if not r["labels"]}
        assert counters["serve_requests_total"] == 7.0

    def test_metrics_cluster_scope_prometheus(self, cluster):
        status, body = _get(cluster, "/metrics?scope=cluster")
        text = body.decode()
        assert status == 200
        assert "serve_requests_total 7" in text
        assert 'serve_queue_depth{process="replica-0"} 2' in text
        assert 'federation_process_up{process="replica-1"} 1' in text
        assert "# TYPE serve_request_ms histogram" in text

    def test_metrics_unknown_scope_400(self, cluster):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(cluster, "/metrics?scope=galaxy")
        assert e.value.code == 400

    def test_api_cluster_404_without_aggregator(self):
        server = UiServer()
        server.start(port=0)
        try:
            for path in ("/api/cluster", "/metrics?scope=cluster"):
                with pytest.raises(urllib.error.HTTPError) as e:
                    _get(server, path)
                assert e.value.code == 404
        finally:
            server.stop()


# -------------------------------------------------- profiling surface ----

class TestUiProfilingRoute:
    @pytest.fixture
    def server(self, tmp_path, monkeypatch):
        from deeplearning4j_tpu_torch.telemetry.runprof import (
            RunProfiler,
            set_runprof,
        )

        monkeypatch.delenv("DL4J_TPU_RUNPROF", raising=False)
        monkeypatch.delenv("DL4J_TPU_RUNPROF_DIR", raising=False)
        set_runprof(None)
        s = UiServer(artifact_dir=str(tmp_path))
        prof = RunProfiler(registry=MetricsRegistry(),
                           session_dir=str(tmp_path / "sessions"))
        s.attach_runprof(prof)
        s.start(port=0)
        yield s, prof
        s.stop()
        set_runprof(None)

    def _req(self, server, path, body=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}{path}", data=body,
            headers={"Content-Type": "application/json"} if body else {})
        try:
            with urllib.request.urlopen(req) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}")

    def test_start_stop_round_trip(self, server):
        from deeplearning4j_tpu_torch.telemetry.runprof import StepTiming

        ui, prof = server
        status, out = self._req(
            ui, "/api/profiling",
            json.dumps({"action": "start", "steps": 2}).encode())
        assert status == 200 and out["steps"] == 2
        assert prof.session_active
        status, _ = self._req(ui, "/api/profiling",
                              json.dumps({"action": "start"}).encode())
        assert status == 409
        for _ in range(2):  # auto-stop at steps=2
            prof.record(StepTiming(label="s", t_unix=time.time(),
                                   wall_ms=2.0, host_ms=0.1,
                                   dispatch_ms=0.5, device_ms=1.5))
        status, out = self._req(ui, "/api/profiling")
        assert status == 200
        assert out["session"] is None
        assert len(out["sessions_completed"]) == 1
        assert out["labels"]["s"]["steps_total"] == 2
        status, out = self._req(ui, "/api/profiling",
                                json.dumps({"action": "stop"}).encode())
        assert status == 200 and out["stopped"] is None

    def test_bad_action_rejected(self, server):
        ui, _ = server
        status, _ = self._req(ui, "/api/profiling",
                              json.dumps({"action": "dance"}).encode())
        assert status == 400


def test_ui_serves_api_profile():
    from deeplearning4j_tpu_torch.telemetry.xprofile import (
        ProfileStore,
        profile_compiled,
    )

    store = ProfileStore()
    profile_compiled(lambda x: x @ x, torch.ones(4, 4), label="ui_step",
                     store=store)
    server = UiServer()
    server.attach_profiles(store)
    port = server.start(port=0)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/profile") as resp:
            body = json.loads(resp.read())
        assert [p["label"] for p in body["profiles"]] == ["ui_step"]
        assert body["profiles"][0]["flops"] == 128.0
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/profile?label=ui_step") as r:
            assert json.loads(r.read())["label"] == "ui_step"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/profile?label=nope")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/memory") as resp:
            assert json.loads(resp.read()) == {"devices": [{"device": "cpu"}]}
    finally:
        server.stop()


# ---------------------------------------------------- alerts surface ----

T0 = 1_000_000.0


class TestAlertUi:
    @pytest.fixture
    def server(self):
        from deeplearning4j_tpu_torch.telemetry.alerts import AlertEngine
        from deeplearning4j_tpu_torch.telemetry.federation import \
            ClusterAggregator
        from deeplearning4j_tpu_torch.telemetry.history import \
            MetricsHistory

        reg = MetricsRegistry()
        history = MetricsHistory(registry=reg)
        reg.counter("guard_skipped_steps_total").inc(0)
        history.sample_once(now=T0)
        reg.counter("guard_skipped_steps_total").inc(4)
        history.sample_once(now=T0 + 10.0)
        engine = AlertEngine(history, registry=reg, process="ui-test")
        engine.evaluate_once(now=T0 + 10.0, publish=False)
        tracker = InMemoryStateTracker()
        pub = AlertEngine(history, registry=MetricsRegistry(),
                          tracker=tracker, process="remote")
        pub.evaluate_once(now=T0 + 10.0)
        srv = UiServer()
        srv.attach_history(history)
        srv.attach_alerts(engine)
        srv.attach_federation(ClusterAggregator(
            tracker, stale_after_s=3600.0, registry=MetricsRegistry()))
        srv.start(port=0)
        yield srv
        srv.stop()

    def _get(self, server, path):
        status, body = _get(server, path)
        return status, json.loads(body)

    def test_api_alerts_states(self, server):
        status, body = self._get(server, "/api/alerts")
        assert status == 200
        assert body["process"] == "ui-test"
        states = {a["rule"]: a["state"] for a in body["alerts"]}
        assert states["nonfinite_step_rate"] == "firing"
        assert body["firing"] >= 1

    def test_api_alerts_cluster_scope(self, server):
        status, body = self._get(server, "/api/alerts?scope=cluster")
        assert status == 200
        assert [p["process"] for p in body["processes"]] == ["remote"]
        assert any(a["rule"] == "nonfinite_step_rate"
                   and a["state"] == "firing" for a in body["alerts"])

    def test_api_alerts_bad_scope_400(self, server):
        with pytest.raises(urllib.error.HTTPError) as e:
            self._get(server, "/api/alerts?scope=galaxy")
        assert e.value.code == 400

    def test_api_history_index_and_points(self, server):
        status, body = self._get(server, "/api/history")
        assert status == 200
        assert "guard_skipped_steps_total" in {s["name"]
                                               for s in body["series"]}
        status, body = self._get(
            server, "/api/history?name=guard_skipped_steps_total")
        assert body["points"] == [[T0, 0.0], [T0 + 10.0, 4.0]]

    def test_api_history_bad_window_400(self, server):
        with pytest.raises(urllib.error.HTTPError) as e:
            self._get(server, "/api/history?window_s=soon")
        assert e.value.code == 400

    def test_404_without_attachments(self):
        from deeplearning4j_tpu_torch.telemetry.alerts import set_engine
        from deeplearning4j_tpu_torch.telemetry.history import set_history

        prev_h, prev_e = set_history(None), set_engine(None)
        srv = UiServer()
        srv.start(port=0)
        try:
            for path in ("/api/alerts", "/api/history"):
                with pytest.raises(urllib.error.HTTPError) as e:
                    self._get(srv, path)
                assert e.value.code == 404
        finally:
            srv.stop()
            set_history(prev_h)
            set_engine(prev_e)
