"""Counterpart of ``deeplearning4j_tpu/ui/server.py``: the stdlib HTTP
server exposing training artifacts and the live system (ref:
ui/UiServer.java).

Every route, status code and JSON key is JAX's, and ``INDEX_HTML`` is
JAX's page; each ``attach_*`` takes the port's object: ``DecodeEngine``
(``/api/generate``, W3C ``traceparent`` honoured, and ``/api/serve``),
``FleetRouter`` (``/api/fleet`` and routed generation),
``ClusterAggregator`` (``/api/cluster``, ``/metrics?scope=cluster``,
``/api/alerts?scope=cluster``), the metrics registry, the tracer, the
``ProfileStore`` (``/api/profile``), the ``RunProfiler``
(``/api/profiling`` GET and POST), the ``MetricsHistory`` and the alert
engine; ``/api/memory`` reads ``utils.profiling.device_memory_stats``.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from deeplearning4j_tpu_torch.ui import views

INDEX_HTML = """<!doctype html>
<html><head><title>deeplearning4j-tpu ui</title></head><body>
<h1>deeplearning4j-tpu</h1>
<h2>views</h2>
<ul>
<li><a href="/render/tsne">t-SNE scatter (pan/zoom)</a></li>
<li><a href="/render/weights">weight histograms</a></li>
<li><a href="/render/filters">learned filters</a></li>
<li><a href="/render/activations">layer activations</a></li>
<li><a href="/render/words">nearest-neighbour explorer</a></li>
</ul>
<h2>telemetry</h2>
<ul>
<li><a href="/metrics">Prometheus metrics</a></li>
<li><a href="/api/telemetry">telemetry snapshot (JSON)</a></li>
<li><a href="/api/memory">device memory stats</a></li>
<li><a href="/api/trace">live trace spans (open + recent)</a></li>
<li><a href="/api/profile">compiled-step profiles (cost/memory/collectives)</a></li>
<li><a href="/api/history">metrics history (series index; ?name=&window_s=)</a></li>
<li><a href="/api/alerts">alert states (rules, hysteresis, exemplars)</a></li>
<li><a href="/api/profiling">runtime profiler snapshot (step rings, sessions)</a></li>
<li>POST /api/profiling {"action": "start"|"stop", "steps": N} (on-demand capture session)</li>
</ul>
<h2>serving</h2>
<ul>
<li><a href="/api/serve">decode-engine stats (queue, slots, in-flight request ages)</a></li>
<li><a href="/api/fleet">serving-fleet view (per-replica health/load, session affinity)</a></li>
<li>POST /api/generate {"prompt": [ids], "max_new_tokens": N, "temperature": T, "session": S} (traceparent honoured; routed through the fleet when attached)</li>
</ul>
<h2>cluster</h2>
<ul>
<li><a href="/api/cluster">federated cluster metrics (merged registries + staleness)</a></li>
<li><a href="/api/alerts?scope=cluster">cluster-wide alert view (merged per-process alerts)</a></li>
<li><a href="/metrics?scope=cluster">cluster-scope Prometheus metrics</a></li>
</ul>
<h2>api</h2>
<ul>
<li><a href="/api/words">word vectors (count)</a></li>
<li><a href="/api/nearest?word=WORD&n=5">nearest neighbours</a></li>
<li><a href="/api/tsne">t-SNE coords</a></li>
<li><a href="/api/weights">weight histograms</a></li>
<li><a href="/api/filters">filter tiles</a></li>
<li><a href="/api/activations">activation heatmaps</a></li>
<li><a href="/artifacts/">artifact files</a></li>
</ul></body></html>"""


class UiServer:
    """In-process artifact server. Register data, then serve:

        server = UiServer(artifact_dir="plots")
        server.upload_word_vectors(vocab_words, matrix)
        server.upload_tsne(coords, labels)
        server.start(port=0)   # port 0 → ephemeral; .port has the real one
    """

    def __init__(self, artifact_dir: Optional[str] = None):
        self.artifact_dir = artifact_dir
        self._words: List[str] = []
        self._vectors: Optional[np.ndarray] = None
        self._vptree = None
        self._tsne: Optional[Dict] = None
        self._weights: Optional[Dict] = None
        self._filters: Optional[list] = None
        self._activations: Optional[list] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None
        self._metrics_registry = None
        self._tracer = None
        self._profile_store = None
        self._engine = None
        self._fleet = None
        self._federation = None
        self._history = None
        self._alerts = None
        self._runprof = None
        self._generate_timeout_s = 120.0

    # ---- telemetry (Prometheus + JSON export on the UI port) ----
    def attach_metrics(self, registry) -> None:
        """Serve a telemetry.MetricsRegistry at ``/metrics`` (Prometheus
        text format) and ``/api/telemetry`` (JSON snapshot). Live view:
        the registry is read at request time, so a training loop writing
        into it is immediately visible to scrapers."""
        self._metrics_registry = registry

    # ---- tracing (live span view on the UI port) ----
    def attach_tracer(self, tracer) -> None:
        """Serve a telemetry.trace.Tracer's flight-recorder ring at
        ``/api/trace`` (open spans with elapsed-so-far durations + the
        last-N ended spans). Read at request time — a scrape during a
        round shows the round/barrier spans still open. Falls back to the
        process tracer when none is attached explicitly."""
        self._tracer = tracer

    # ---- profiling (live StepProfile view on the UI port) ----
    def attach_profiles(self, store) -> None:
        """Serve a telemetry.xprofile.ProfileStore at ``/api/profile``
        (one record per profiled-step label: the counted call's FLOPs,
        bytes, memory and collectives). Read at request time; falls back
        to the process default store when none is attached — a train step
        built with ``profile=True`` is visible with zero extra wiring."""
        self._profile_store = store

    # ---- serving (the decode engine behind /api/generate) ----
    def attach_engine(self, engine, generate_timeout_s: float = 120.0
                      ) -> None:
        """Serve a serve.DecodeEngine: POST ``/api/generate`` submits a
        generation request (blocking until the request retires — handler
        threads ride the ThreadingHTTPServer, the engine's continuous-
        batching loop interleaves them into slots) and GET ``/api/serve``
        snapshots scheduler stats (queue depth, slot occupancy, token
        throughput). Start the engine's background loop
        (``engine.start()``) for concurrent requests; without it each
        handler drives the scheduler inline."""
        self._engine = engine
        self._generate_timeout_s = float(generate_timeout_s)

    # ---- serving fleet (the router behind /api/generate) ----
    def attach_fleet(self, router, generate_timeout_s: float = 120.0
                     ) -> None:
        """Serve a serve.FleetRouter: POST ``/api/generate`` dispatches
        through the fleet (an optional ``"session"`` string in the
        payload pins the request to its affinity replica) instead of a
        locally attached engine, and GET ``/api/fleet`` snapshots the
        per-replica health/load/affinity tables. Start the router's
        background loop (``router.start()``) so handler threads only
        block on their own request."""
        self._fleet = router
        self._generate_timeout_s = float(generate_timeout_s)

    # ---- watchtower (history + alert verdicts on the UI port) ----
    def attach_history(self, history) -> None:
        """Serve a telemetry.history.MetricsHistory at ``/api/history``:
        the series index, and with ``?name=<metric>[&window_s=N]`` the
        scalar points of one series. Read at request time; falls back to
        the process history (telemetry.history.get_history) when none is
        attached explicitly."""
        self._history = history

    def attach_alerts(self, engine) -> None:
        """Serve a telemetry.alerts.AlertEngine at ``/api/alerts``: every
        rule's current state (inactive/pending/firing/resolved with
        timestamps, measured value, and — for SLO-burn rules — the
        offending exemplar trace ids). ``?scope=cluster`` serves the
        tracker-merged per-process alert view through the attached
        federation aggregator instead. Read at request time; falls back
        to the process engine (telemetry.alerts.get_engine)."""
        self._alerts = engine

    # ---- runtime profiling (runprof control on the UI port) ----
    def attach_runprof(self, profiler) -> None:
        """Serve a telemetry.runprof.RunProfiler: GET ``/api/profiling``
        snapshots the step rings + session state, POST ``/api/profiling``
        with ``{"action": "start", "steps": N}`` opens an on-demand
        capture session (409 when one is already live) and ``{"action":
        "stop"}`` closes it, returning the final dump path. Read at
        request time; falls back to the process default
        (telemetry.runprof.get_runprof)."""
        self._runprof = profiler

    # ---- federation (the cluster view on the UI port) ----
    def attach_federation(self, aggregator) -> None:
        """Serve a telemetry.federation.ClusterAggregator: GET
        ``/api/cluster`` returns the merged cluster view (per-process
        push ages + staleness flags, counters summed, gauges
        per-process-labeled, histograms bucket-merged) and ``GET
        /metrics?scope=cluster`` the same view as Prometheus text with
        ``federation_process_up`` marking lapsed pushers. Collected at
        request time — one tracker read per scrape."""
        self._federation = aggregator

    # ---- uploads (ref ApiResource: the reference POSTs these; in-process
    # registration serves the same purpose without copying through HTTP) ----
    def upload_word_vectors(self, words: List[str], vectors: np.ndarray) -> None:
        from deeplearning4j_tpu_torch.clustering.vptree import VPTree

        self._words = list(words)
        self._vectors = np.asarray(vectors, np.float64)
        self._vptree = VPTree(self._vectors, labels=self._words,
                              similarity="cosine")

    def upload_tsne(self, coords: np.ndarray, labels: List[str]) -> None:
        self._tsne = {
            "coords": np.asarray(coords).tolist(),
            "labels": [str(l) for l in labels],
        }

    def upload_weight_histograms(self, histograms: Dict) -> None:
        self._weights = histograms

    def upload_filters(self, net, max_filters: int = 64) -> None:
        """Extract + register learned-filter tiles from a trained network
        (ref: FilterRenderer.renderFilters fed by NeuralNetPlotter)."""
        self._filters = views.filter_grids(net, max_filters=max_filters)

    def upload_activations(self, net, x) -> None:
        """Register per-layer activation heatmaps for a batch
        (ref: NeuralNetPlotter.plotActivations)."""
        self._activations = views.activation_summaries(net, x)

    # ---- queries ----
    def nearest(self, word: str, n: int = 5) -> List[Dict]:
        if self._vptree is None or word not in self._words:
            return []
        idx = self._words.index(word)
        hits = self._vptree.search(self._vectors[idx], n + 1)
        return [
            {"word": self._words[i], "distance": float(d)}
            for i, d in hits if i != idx
        ][:n]

    # ---- http plumbing ----
    def _handler_class(self):
        ui = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # silence request logging
                pass

            def _send(self, code: int, body: bytes,
                      ctype: str = "application/json",
                      extra_headers=None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj, code: int = 200,
                      extra_headers=None) -> None:
                self._send(code, json.dumps(obj).encode("utf-8"),
                           extra_headers=extra_headers)

            def do_GET(self):
                url = urlparse(self.path)
                q = parse_qs(url.query)
                if url.path in ("/", "/index.html"):
                    self._send(200, INDEX_HTML.encode(), "text/html")
                elif url.path in views.PAGES:
                    self._send(200, views.PAGES[url.path].encode(), "text/html")
                elif url.path == "/metrics":
                    from deeplearning4j_tpu_torch.telemetry.prometheus import (
                        CONTENT_TYPE,
                        render_prometheus,
                        render_snapshot,
                    )

                    scope = q.get("scope", ["process"])[0]
                    if scope == "cluster":
                        # the federated cluster view — merged
                        # per-process registries, stale pushers marked
                        # via federation_process_up
                        if ui._federation is None:
                            self._json({"error": "no federation "
                                        "aggregator attached"}, 404)
                            return
                        self._send(200, render_snapshot(
                            ui._federation.prometheus_snapshot()
                        ).encode("utf-8"), CONTENT_TYPE)
                        return
                    if scope != "process":
                        self._json({"error": "scope must be 'process' or "
                                    "'cluster'"}, 400)
                        return
                    if ui._metrics_registry is None:
                        self._json({"error": "no metrics registry attached"},
                                   404)
                        return
                    self._send(200,
                               render_prometheus(
                                   ui._metrics_registry).encode("utf-8"),
                               CONTENT_TYPE)
                elif url.path == "/api/cluster":
                    if ui._federation is None:
                        self._json({"error": "no federation aggregator "
                                    "attached"}, 404)
                        return
                    self._json(ui._federation.collect())
                elif url.path == "/api/telemetry":
                    snap = (ui._metrics_registry.snapshot()
                            if ui._metrics_registry is not None else {})
                    self._json(snap)
                elif url.path == "/api/memory":
                    from deeplearning4j_tpu_torch.utils.profiling import (
                        device_memory_stats,
                    )

                    self._json({"devices": device_memory_stats()})
                elif url.path == "/api/trace":
                    from deeplearning4j_tpu_torch.telemetry import trace as _trace

                    tracer = ui._tracer or _trace.get_tracer()
                    if tracer is None:
                        self._json({"error": "no tracer attached"}, 404)
                        return
                    try:
                        limit = int(q.get("limit", ["64"])[0])
                    except ValueError:
                        self._json({"error": "limit must be an integer"},
                                   400)
                        return
                    self._json(tracer.snapshot(limit=limit))
                elif url.path == "/api/profile":
                    from deeplearning4j_tpu_torch.telemetry.xprofile import (
                        default_profile_store,
                    )

                    store = ui._profile_store or default_profile_store()
                    label = q.get("label", [None])[0]
                    if label is not None:
                        rec = store.get(label)
                        if rec is None:
                            self._json({"error": f"no profile for label "
                                        f"{label!r}"}, 404)
                            return
                        self._json(rec)
                        return
                    self._json({"profiles": store.snapshot()})
                elif url.path == "/api/history":
                    from deeplearning4j_tpu_torch.telemetry import (
                        history as _history_mod,
                    )

                    hist = ui._history or _history_mod.get_history()
                    if hist is None:
                        self._json({"error": "no metrics history "
                                    "attached"}, 404)
                        return
                    name = q.get("name", [None])[0]
                    try:
                        window_s = (float(q.get("window_s")[0])
                                    if q.get("window_s") else None)
                    except ValueError:
                        self._json({"error": "window_s must be a number"},
                                   400)
                        return
                    self._json(hist.snapshot(name=name, window_s=window_s))
                elif url.path == "/api/alerts":
                    scope = q.get("scope", ["process"])[0]
                    if scope == "cluster":
                        # the tracker-merged cluster alert view
                        # (every process's published AlertEngine payload)
                        if ui._federation is None:
                            self._json({"error": "no federation "
                                        "aggregator attached"}, 404)
                            return
                        self._json(ui._federation.collect_alerts())
                        return
                    if scope != "process":
                        self._json({"error": "scope must be 'process' or "
                                    "'cluster'"}, 400)
                        return
                    from deeplearning4j_tpu_torch.telemetry import (
                        alerts as _alerts_mod,
                    )

                    engine = ui._alerts or _alerts_mod.get_engine()
                    if engine is None:
                        self._json({"error": "no alert engine attached"},
                                   404)
                        return
                    states = engine.states()
                    self._json({
                        "process": engine.process,
                        "firing": sum(a["state"] == "firing"
                                      for a in states),
                        "alerts": states,
                    })
                elif url.path == "/api/profiling":
                    from deeplearning4j_tpu_torch.telemetry import (
                        runprof as _runprof_mod,
                    )

                    prof = ui._runprof or _runprof_mod.get_runprof()
                    if prof is None:
                        self._json({"error": "no runtime profiler "
                                    "attached"}, 404)
                        return
                    self._json(prof.snapshot())
                elif url.path == "/api/serve":
                    if ui._engine is None:
                        self._json({"error": "no decode engine attached"},
                                   404)
                        return
                    self._json(ui._engine.stats())
                elif url.path == "/api/fleet":
                    if ui._fleet is None:
                        self._json({"error": "no fleet router attached"},
                                   404)
                        return
                    self._json(ui._fleet.fleet_snapshot())
                elif url.path == "/api/words":
                    self._json({"count": len(ui._words), "words": ui._words[:200]})
                elif url.path == "/api/nearest":
                    word = q.get("word", [""])[0]
                    try:
                        n = int(q.get("n", ["5"])[0])
                    except ValueError:
                        self._json({"error": "n must be an integer"}, 400)
                        return
                    if n < 1:
                        self._json({"error": "n must be >= 1"}, 400)
                        return
                    self._json({"word": word, "neighbours": ui.nearest(word, n)})
                elif url.path == "/api/tsne":
                    self._json(ui._tsne or {})
                elif url.path == "/api/weights":
                    self._json(ui._weights or {})
                elif url.path == "/api/filters":
                    self._json({"grids": ui._filters or []})
                elif url.path == "/api/activations":
                    self._json({"layers": ui._activations or []})
                elif url.path.startswith("/artifacts/") and ui.artifact_dir:
                    from urllib.parse import unquote

                    rel = unquote(url.path[len("/artifacts/"):])
                    base = os.path.realpath(ui.artifact_dir)
                    if not os.path.isdir(base):
                        self._json({"error": "artifact dir missing"}, 404)
                        return
                    if not rel:
                        files = sorted(os.listdir(base))
                        self._send(200, "\n".join(files).encode(), "text/plain")
                        return
                    full = os.path.realpath(os.path.join(base, rel))
                    # confine to the artifact dir (no ../ escapes)
                    if not full.startswith(base + os.sep) or not os.path.isfile(full):
                        self._json({"error": "not found"}, 404)
                        return
                    ctype = ("image/svg+xml" if full.endswith(".svg")
                             else "text/html" if full.endswith(".html")
                             else "application/json" if full.endswith(".json")
                             else "application/octet-stream")
                    with open(full, "rb") as fh:
                        self._send(200, fh.read(), ctype)
                else:
                    self._json({"error": "not found"}, 404)

            # ---- POST plumbing (the reference's
            # ApiResource accepted uploads over POST; this build needed it
            # for /api/generate — minimal routing with explicit
            # content-length and JSON error handling, pinned in
            # tests/test_torch_ui.py) ----
            _MAX_BODY = 8 << 20  # 8 MiB: a prompt is a token list, not data

            def _read_json_body(self):
                """Parse the request body, answering the error response
                directly on failure (None = already responded): 411 on a
                missing Content-Length, 400 on an invalid one or non-JSON
                body, 413 past the size cap."""
                cl = self.headers.get("Content-Length")
                if cl is None:
                    self._json({"error": "Content-Length required"}, 411)
                    return None
                try:
                    length = int(cl)
                except ValueError:
                    self._json({"error": "invalid Content-Length"}, 400)
                    return None
                if length < 0:
                    self._json({"error": "invalid Content-Length"}, 400)
                    return None
                if length > self._MAX_BODY:
                    self._json({"error": "body too large"}, 413)
                    return None
                raw = self.rfile.read(length)
                try:
                    return json.loads(raw.decode("utf-8"))
                except (UnicodeDecodeError, ValueError):
                    self._json({"error": "body is not valid JSON"}, 400)
                    return None

            def do_POST(self):
                url = urlparse(self.path)
                if url.path == "/api/profiling":
                    self._post_profiling()
                    return
                if url.path != "/api/generate":
                    self._json({"error": "not found"}, 404)
                    return
                if ui._engine is None and ui._fleet is None:
                    self._json({"error": "no decode engine attached"}, 404)
                    return
                payload = self._read_json_body()
                if payload is None:
                    return
                if not isinstance(payload, dict):
                    self._json({"error": "body must be a JSON object"}, 400)
                    return
                prompt = payload.get("prompt")
                if (not isinstance(prompt, list) or not prompt
                        or not all(isinstance(t, int)
                                   and not isinstance(t, bool)
                                   for t in prompt)):
                    self._json({"error": "prompt must be a non-empty list "
                                "of token ids"}, 400)
                    return
                try:
                    max_new = int(payload.get("max_new_tokens", 16))
                    temperature = float(payload.get("temperature", 0.0))
                except (TypeError, ValueError):
                    self._json({"error": "max_new_tokens/temperature must "
                                "be numbers"}, 400)
                    return
                session = payload.get("session")
                if session is not None and not isinstance(session, str):
                    self._json({"error": "session must be a string"}, 400)
                    return
                # W3C trace-context propagation — an inbound
                # ``traceparent`` parents this handler's span (and the
                # engine's serve.request tree under it) beneath the
                # CALLER's trace; a malformed header is IGNORED per the
                # spec (fresh root trace, never a 400). With no process
                # tracer this is one None-check.
                from deeplearning4j_tpu_torch.telemetry import trace as _trace

                ctx = _trace.parse_traceparent(
                    self.headers.get("traceparent"))
                sp = None
                try:
                    with _trace.maybe_span(
                            "http.request",
                            parent=ctx,
                            attrs={"path": url.path,
                                   "prompt_len": len(prompt),
                                   "remote_trace": ctx is not None}) as sp:
                        # the fleet front end wins when
                        # attached — the local engine stays as the
                        # single-process fallback
                        if ui._fleet is not None:
                            tokens = ui._fleet.generate(
                                prompt, max_new_tokens=max_new,
                                temperature=temperature, session=session,
                                timeout=ui._generate_timeout_s)
                        else:
                            tokens = ui._engine.generate(
                                prompt, max_new_tokens=max_new,
                                temperature=temperature,
                                timeout=ui._generate_timeout_s)
                except ValueError as exc:  # engine-side validation
                    self._json({"error": str(exc)}, 400)
                    return
                # the 503 body is the report: the timeout reaches the
                # caller, and the engine's own serve metrics count it
                except TimeoutError:
                    self._json({"error": "generation timed out"}, 503)
                    return
                resp = {"tokens": tokens, "n": len(tokens),
                        "prompt_len": len(prompt)}
                headers = None
                if sp is not None:
                    # the response carries the trace id both ways: JSON
                    # for API clients, traceparent for W3C middleboxes
                    resp["trace_id"] = sp.trace_id
                    headers = {"traceparent":
                               _trace.format_traceparent(sp.context())}
                self._json(resp, extra_headers=headers)

            def _post_profiling(self):
                """on-demand profiling session control. A
                second ``start`` while one session is live is a 409 (the
                profiler enforces one-at-a-time); ``stop`` with no live
                session answers ``{"stopped": null}`` (idempotent, like
                ``RunProfiler.stop_session``)."""
                from deeplearning4j_tpu_torch.telemetry import (
                    runprof as _runprof_mod,
                )

                prof = ui._runprof or _runprof_mod.get_runprof()
                if prof is None:
                    # arm the process default on demand: the operator
                    # POSTing start expects a profiler to exist
                    prof = _runprof_mod.default_runprof()
                payload = self._read_json_body()
                if payload is None:
                    return
                if not isinstance(payload, dict):
                    self._json({"error": "body must be a JSON object"},
                               400)
                    return
                action = payload.get("action")
                if action == "start":
                    try:
                        steps = int(payload.get("steps", 0))
                    except (TypeError, ValueError):
                        self._json({"error": "steps must be an integer"},
                                   400)
                        return
                    if steps < 0:
                        self._json({"error": "steps must be >= 0"}, 400)
                        return
                    try:
                        sid = prof.start_session(steps=steps)
                    except RuntimeError as exc:
                        self._json({"error": str(exc)}, 409)
                        return
                    except OSError as exc:
                        self._json({"error": f"cannot open session "
                                    f"dump: {exc}"}, 500)
                        return
                    self._json({"session": sid, "steps": steps})
                elif action == "stop":
                    self._json({"stopped": prof.stop_session()})
                else:
                    self._json({"error": "action must be 'start' or "
                                "'stop'"}, 400)

        return Handler

    def start(self, port: int = 8080, host: str = "127.0.0.1") -> int:
        if self._httpd is not None:
            raise RuntimeError("UiServer already started")
        self._httpd = ThreadingHTTPServer((host, port), self._handler_class())
        self.port = self._httpd.server_address[1]
        # a short poll: stop() waits for the loop to see the shutdown
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.05},
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            if self._thread is not None:
                # shutdown() returns once serve_forever exits — join is
                # deterministic, and without it interpreter teardown races
                # the server thread's last writes (the PR 10 flake shape)
                self._thread.join(timeout=10)
                self._thread = None
