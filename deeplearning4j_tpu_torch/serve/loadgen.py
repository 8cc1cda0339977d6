"""Counterpart of ``deeplearning4j_tpu/serve/loadgen.py``: the synthetic
open-loop traffic generator for the decode engine.

Open-loop means arrivals follow a fixed schedule (Poisson: exponential
inter-arrival gaps) that does NOT slow down when the server falls behind,
the honest way to measure serving latency: a closed loop (submit → wait →
submit) throttles itself to the server's pace and hides queueing delay.
Latency here is measured from the SCHEDULED arrival, so time spent waiting
in the queue (or for the driver to catch up) counts against the server, as
a user would experience it. ``arrival_schedule`` draws from numpy's
``RandomState``, so a seed gives the JAX package's offsets.

Two drivers:

- :func:`run_open_loop` drives a ``DecodeEngine`` (or a ``FleetRouter``)
  in process: one thread interleaves due submissions with
  ``engine.step()`` calls.
- :func:`run_open_loop_http` drives a ``UiServer`` URL: a thread per
  request POSTs ``/api/generate`` at its scheduled arrival (the
  end-to-end front end, JAX's wire: either package's driver speaks to
  either package's server).

Both return a :class:`LoadReport` with tokens/s and exact (not
bucket-approximated) p50/p95/p99 latency over the recorded per-request
latencies (full request and, in process, first token), and in process the
inter-token percentiles.

Tracing: when a process tracer is configured, the HTTP driver opens one
``loadgen.request`` root span per request and sends its context as a W3C
``traceparent`` header, so the server's ``http.request`` span and the
engine's ``serve.request`` subtree parent under it: one trace tree from
the traffic generator through the HTTP server into the scheduler thread.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import urllib.request
from typing import List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.telemetry import trace as _trace


@dataclasses.dataclass
class LoadReport:
    """One load run's results. Latencies are milliseconds, measured from
    each request's scheduled arrival to its completion."""

    n_requests: int
    completed: int
    duration_s: float
    tokens_out: int
    tokens_per_sec: float
    offered_rps: float
    latency_p50_ms: float
    latency_p95_ms: float
    latency_mean_ms: float
    latency_p99_ms: float = 0.0
    first_token_p50_ms: Optional[float] = None
    first_token_p99_ms: Optional[float] = None
    # goodput under an SLO: with ``slo_ms`` set, how many requests
    # completed WITHIN the objective per second (raw throughput can grow
    # while the SLO-violating tail grows faster; goodput cannot)
    slo_ms: Optional[float] = None
    goodput_rps: Optional[float] = None
    slo_attainment: Optional[float] = None  # fraction within SLO
    # decode-token inter-arrival percentiles: the gap between consecutive
    # accepted tokens WITHIN a request, pooled across requests, the
    # stream smoothness chunked prefill exists to protect (a monolithic
    # long-prompt prefill shows here as a p99 spike long before it moves
    # full-request latency)
    inter_token_p50_ms: Optional[float] = None
    inter_token_p99_ms: Optional[float] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _goodput(lat_ms: List[float], slo_ms: Optional[float],
             duration_s: float) -> tuple:
    """(goodput_rps, slo_attainment) over completed-request latencies: a
    request counts toward goodput only when its latency (from the
    SCHEDULED arrival, queueing included) is <= slo_ms."""
    if slo_ms is None:
        return None, None
    good = sum(1 for v in lat_ms if v <= slo_ms)
    return (good / duration_s if duration_s > 0 else 0.0,
            good / len(lat_ms) if lat_ms else 0.0)


def arrival_schedule(n: int, rate_rps: float, seed: int = 0) -> List[float]:
    """Poisson arrival offsets (seconds from start) for ``n`` requests at
    ``rate_rps`` mean offered load."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n)
    return list(np.cumsum(gaps))


def _percentiles(values_ms: List[float]) -> tuple:
    """(p50, p95, p99, mean) over exact recorded latencies; the p99 tail
    is the number an SLO is written against."""
    if not values_ms:
        return 0.0, 0.0, 0.0, 0.0
    arr = np.asarray(values_ms)
    return (float(np.percentile(arr, 50)), float(np.percentile(arr, 95)),
            float(np.percentile(arr, 99)), float(arr.mean()))


def run_open_loop(engine, prompts: Sequence[Sequence[int]],
                  rate_rps: float, max_new_tokens: int = 16,
                  temperature: float = 0.0, seed: int = 0,
                  timeout_s: float = 300.0,
                  slo_ms: Optional[float] = None,
                  sessions: Optional[Sequence[Optional[str]]] = None
                  ) -> LoadReport:
    """Drive ``engine`` with open-loop arrivals of ``prompts`` (one
    request each, in order) at ``rate_rps``. The engine must NOT be
    running its background loop: this driver owns the step cadence so the
    measurement is single-threaded and reproducible.

    ``engine`` is anything with the driver protocol (``submit`` /
    ``has_work`` / ``step``): a ``DecodeEngine`` or a ``FleetRouter``.
    With ``sessions`` (one key per prompt, None entries allowed), each
    submit carries its session key so fleet runs exercise session
    affinity; engines without session support must be driven with
    ``sessions=None``."""
    if sessions is not None and len(sessions) != len(prompts):
        raise ValueError(
            f"sessions ({len(sessions)}) must match prompts "
            f"({len(prompts)})")
    offsets = arrival_schedule(len(prompts), rate_rps, seed=seed)
    t0 = time.perf_counter()
    deadline = t0 + timeout_s
    pending = list(zip(offsets, prompts,
                       sessions if sessions is not None
                       else [None] * len(prompts)))
    requests = []  # (scheduled_arrival_abs, ServeRequest)
    while pending or engine.has_work():
        now = time.perf_counter()
        if now > deadline:
            raise TimeoutError(
                f"open-loop run exceeded {timeout_s}s with "
                f"{len(pending)} requests unsubmitted")
        while pending and t0 + pending[0][0] <= now:
            offset, prompt, session = pending.pop(0)
            kwargs = {} if session is None else {"session": session}
            req = engine.submit(prompt, max_new_tokens=max_new_tokens,
                                temperature=temperature, **kwargs)
            requests.append((t0 + offset, req))
        if engine.has_work():
            engine.step()
        elif pending:
            time.sleep(min(0.002, t0 + pending[0][0] - now))
    t_end = time.perf_counter()
    lat, first, gaps = [], [], []
    tokens = 0
    done = 0
    for arrival, req in requests:
        if req.t_done is None:
            continue
        done += 1
        tokens += len(req.generated)
        lat.append((req.t_done - arrival) * 1000.0)
        if req.t_first is not None:
            first.append((req.t_first - arrival) * 1000.0)
        stamps = getattr(req, "t_tokens", [])
        gaps.extend((b - a) * 1000.0
                    for a, b in zip(stamps, stamps[1:]))
    p50, p95, p99, mean = _percentiles(lat)
    ft = _percentiles(first) if first else None
    it = _percentiles(gaps) if gaps else None
    duration = t_end - t0
    goodput_rps, attainment = _goodput(lat, slo_ms, duration)
    return LoadReport(
        n_requests=len(prompts), completed=done, duration_s=duration,
        tokens_out=tokens,
        tokens_per_sec=tokens / duration if duration > 0 else 0.0,
        offered_rps=rate_rps, latency_p50_ms=p50, latency_p95_ms=p95,
        latency_p99_ms=p99, latency_mean_ms=mean,
        first_token_p50_ms=ft[0] if ft else None,
        first_token_p99_ms=ft[2] if ft else None,
        slo_ms=slo_ms, goodput_rps=goodput_rps,
        slo_attainment=attainment,
        inter_token_p50_ms=it[0] if it else None,
        inter_token_p99_ms=it[2] if it else None)


def run_open_loop_http(base_url: str, prompts: Sequence[Sequence[int]],
                       rate_rps: float, max_new_tokens: int = 16,
                       temperature: float = 0.0, seed: int = 0,
                       timeout_s: float = 120.0,
                       slo_ms: Optional[float] = None) -> LoadReport:
    """Open-loop arrivals POSTed to ``<base_url>/api/generate`` (the
    UiServer front end; the server-side engine must be ``start()``ed).
    One thread per request fires at its scheduled arrival. A request that
    gets no answer (no server, an error status, a timeout) counts as not
    completed."""
    offsets = arrival_schedule(len(prompts), rate_rps, seed=seed)
    results: List[Optional[dict]] = [None] * len(prompts)
    lat_ms: List[Optional[float]] = [None] * len(prompts)
    t0 = time.perf_counter()

    def fire(i: int, offset: float, prompt):
        delay = t0 + offset - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        body = json.dumps({"prompt": list(map(int, prompt)),
                           "max_new_tokens": max_new_tokens,
                           "temperature": temperature}).encode()
        headers = {"Content-Type": "application/json"}
        tracer = _trace.get_tracer()
        span = (tracer.start_span("loadgen.request", parent=False,
                                  attrs={"i": i, "offset_s": round(offset, 4),
                                         "prompt_len": len(prompt)})
                if tracer is not None else None)
        if span is not None:
            headers["traceparent"] = _trace.format_traceparent(
                span.context())
        req = urllib.request.Request(
            base_url.rstrip("/") + "/api/generate", data=body,
            headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                results[i] = json.loads(resp.read())
            lat_ms[i] = (time.perf_counter() - (t0 + offset)) * 1000.0
        except OSError:
            pass  # not completed: the report counts it out
        finally:
            if span is not None:
                span.end()

    threads = [threading.Thread(target=fire, args=(i, off, p), daemon=True)
               for i, (off, p) in enumerate(zip(offsets, prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout_s)
    t_end = time.perf_counter()
    done = [i for i, r in enumerate(results) if r is not None]
    tokens = sum(len(results[i].get("tokens", [])) for i in done)
    lat = [lat_ms[i] for i in done if lat_ms[i] is not None]
    p50, p95, p99, mean = _percentiles(lat)
    duration = t_end - t0
    goodput_rps, attainment = _goodput(lat, slo_ms, duration)
    return LoadReport(
        n_requests=len(prompts), completed=len(done), duration_s=duration,
        tokens_out=tokens,
        tokens_per_sec=tokens / duration if duration > 0 else 0.0,
        offered_rps=rate_rps, latency_p50_ms=p50, latency_p95_ms=p95,
        latency_p99_ms=p99, latency_mean_ms=mean,
        slo_ms=slo_ms, goodput_rps=goodput_rps,
        slo_attainment=attainment)
