"""Counterpart of ``deeplearning4j_tpu/telemetry/step_log.py``: the JSONL
step-event log, one line per training step.

Each record is a flat JSON object ``{ts, step, wall_ms, tokens_per_sec,
<metric>: <value>, ...}`` — the machine-readable twin of the reference's
ScoreIterationListener log lines, consumable by tools/telemetry_report.py
and by anything that tails a file. Writes are line-buffered and the writer
is append-safe across close/reopen (a listener chain may be closed by one
fit and reused by the next).
"""

from __future__ import annotations

import json
import math
import os
import statistics
import time
from typing import Dict, List, Optional


def _jsonable(v):
    if hasattr(v, "tolist"):  # numpy scalars and arrays, tensors
        v = v.tolist()
    if isinstance(v, float) and not math.isfinite(v):
        return repr(v)  # JSONL stays parseable even on a NaN/inf blow-up
    return v


class StepLogWriter:
    """Append step events to ``path`` as JSONL.

    ``static`` fields (run metadata: mesh shape, attention impl, model dims)
    are merged into every record so each line is self-describing.
    """

    def __init__(self, path: str, static: Optional[Dict] = None):
        self.path = path
        self.static = {k: _jsonable(v) for k, v in (static or {}).items()}
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._fh = open(path, "a", buffering=1)

    def write(self, step: int, wall_ms: Optional[float] = None,
              tokens_per_sec: Optional[float] = None, **metrics) -> Dict:
        rec = {"ts": time.time(), "step": int(step)}
        if wall_ms is not None:
            rec["wall_ms"] = round(float(wall_ms), 3)
        if tokens_per_sec is not None:
            rec["tokens_per_sec"] = round(float(tokens_per_sec), 1)
        rec.update(self.static)
        for k, v in metrics.items():
            rec[k] = _jsonable(v)
        if self._fh is None:  # reopened chain (close() is not terminal)
            self._fh = open(self.path, "a", buffering=1)
        self._fh.write(json.dumps(rec) + "\n")
        return rec

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "StepLogWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_step_log(path: str) -> List[Dict]:
    """Parse a JSONL step log back into records (skips blank lines).

    A malformed line raises ``ValueError`` naming the file and line
    number — a truncated log (writer killed mid-line) or a corrupted one
    is a clear diagnostic for callers (tools/telemetry_report.py turns it
    into a message + nonzero exit), never a bare JSONDecodeError
    traceback pointing at nothing.
    """
    out = []
    with open(path) as fh:
        for lineno, line in enumerate(fh, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as exc:
                raise ValueError(
                    f"step log {path} is truncated or corrupt at line "
                    f"{lineno}: {exc}") from exc
    return out


_NONFINITE_REPRS = ("nan", "inf", "-inf")
_NON_METRIC_KEYS = ("ts", "step")


def _is_nonfinite_value(v) -> bool:
    """A value the writer preserved as a non-finite marker: the repr string
    ``_jsonable`` emits ('nan'/'inf'/'-inf'), or a raw non-finite float
    (records built in-process, never serialized)."""
    if isinstance(v, str):
        return v.strip().lower() in _NONFINITE_REPRS
    return isinstance(v, float) and not math.isfinite(v)


def nonfinite_counts(records: List[Dict]) -> Dict[str, int]:
    """Per-metric count of non-finite values across the log — the
    numerical-fault signal the report must SHOUT about, not silently
    repr (step_log preserves them; this surfaces them)."""
    counts: Dict[str, int] = {}
    for r in records:
        for k, v in r.items():
            if k in _NON_METRIC_KEYS:
                continue
            vals = v if isinstance(v, list) else [v]
            n = sum(1 for vi in vals if _is_nonfinite_value(vi))
            if n:
                counts[k] = counts.get(k, 0) + n
    return counts


def summarize_step_log(records: List[Dict]) -> Dict:
    """Aggregate a step log into the throughput/grad-norm summary the
    bench detail and tools/telemetry_report.py print.

    Returns {steps, wall_ms: {mean, p50, p95, p99}, tokens_per_sec_mean,
    loss: {first, last}, grad_norm: {first, last}, router_load_mean}.
    Absent fields are simply omitted. When any metric carried NaN/Inf
    values a ``nonfinite`` {metric: count} map is included (plus
    ``skipped_steps``/``clipped_steps`` totals when the guardrails
    counters are in the log) — downstream reports flag these loudly.
    """
    if not records:
        return {"steps": 0}
    out: Dict = {"steps": len(records)}

    def series(key):
        return [r[key] for r in records
                if isinstance(r.get(key), (int, float))]

    bad = nonfinite_counts(records)
    if bad:
        out["nonfinite"] = bad
    for key, name in (("nonfinite", "skipped_steps"),
                      ("clipped", "clipped_steps")):
        vals = series(key)
        if vals:
            out[name] = int(sum(v > 0 for v in vals))

    walls = series("wall_ms")
    if walls:
        s = sorted(walls)

        def pct(q):
            return s[min(len(s) - 1, max(0, math.ceil(q / 100 * len(s)) - 1))]

        out["wall_ms"] = {"mean": round(statistics.fmean(walls), 3),
                          "p50": round(pct(50), 3),
                          "p95": round(pct(95), 3),
                          "p99": round(pct(99), 3)}
    tps = series("tokens_per_sec")
    if tps:
        out["tokens_per_sec_mean"] = round(statistics.fmean(tps), 1)
    # moment_norm_* / lamb_trust_ratio: the optimizer-health
    # block (optimize/updaters.opt_update(with_metrics=True)) — absent on
    # plain-SGD runs, so the rows are simply omitted (silent-when-absent
    # pinned both ways in tests/test_updaters.py)
    for key in ("loss", "score", "grad_norm", "param_norm", "update_ratio",
                "moe_dropped_frac", "moment_norm_m", "moment_norm_v",
                "lamb_trust_ratio"):
        vals = series(key)
        if vals:
            out[key] = {"first": round(vals[0], 6), "last": round(vals[-1], 6)}
    loads = [r["router_load"] for r in records
             if isinstance(r.get("router_load"), list)]
    if loads:
        n = len(loads)
        out["router_load_mean"] = [
            round(sum(l[e] for l in loads) / n, 4)
            for e in range(len(loads[0]))
        ]
    # lockwatch hold/contention metrics: records carrying
    # ``lockwatch_*`` keys (utils.lockwatch.metrics_record) surface as
    # one block — values are cumulative/max, so the latest wins. Absent
    # keys mean the watch was off; the block is simply omitted.
    lockwatch: Dict = {}
    for r in records:
        for k, v in r.items():
            if k.startswith("lockwatch_") and isinstance(v, (int, float)):
                lockwatch[k] = v
    if lockwatch:
        out["lockwatch"] = lockwatch
    # serve + federation registry metrics: records carrying
    # ``serve_*`` / ``federation_*`` keys (DecodeEngine.metrics_record /
    # federation metrics_record via registry.flat_record) surface as one
    # block each — cumulative registry values, so the latest record wins;
    # absent keys mean the subsystem never ran and the block is omitted
    # alerts_/history_: the watchtower's own health metrics,
    # same silent-when-absent contract (pinned by the meta-test)
    # runprof_: the runtime profiler's gauges, same contract
    # netwatch_: per-endpoint socket-watch counters
    # (utils.netwatch.metrics_record), same contract
    for prefix, block_key in (("serve_", "serve"),
                              ("federation_", "federation"),
                              ("alerts_", "alerts"),
                              ("history_", "history"),
                              ("runprof_", "runprof"),
                              ("netwatch_", "netwatch")):
        block: Dict = {}
        for r in records:
            for k, v in r.items():
                if k.startswith(prefix) and isinstance(v, (int, float)):
                    block[k] = v
        if block:
            out[block_key] = block
    return out
