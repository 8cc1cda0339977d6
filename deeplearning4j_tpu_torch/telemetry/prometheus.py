"""Counterpart of ``deeplearning4j_tpu/telemetry/prometheus.py``: the
Prometheus text-format exposition of a MetricsRegistry.

Renders exposition format 0.0.4 (the text format every Prometheus scraper
speaks): one ``# TYPE`` header per metric family, ``{label="value"}`` pairs
escaped per the spec, histograms as cumulative ``_bucket{le=...}`` series
plus ``_sum``/``_count``. Counter families get the conventional ``_total``
suffix unless the name already carries it.

Mounted on ui/server.py at ``GET /metrics``; the golden test in
tests/test_telemetry.py pins the exact output.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List

from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_name(name: str) -> str:
    """Legalize a metric name (statetracker counters use dotted keys like
    ``rounds.worker-0`` — dots and dashes become underscores)."""
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _escape_label_value(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _labels_str(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{sanitize_name(k)}="{_escape_label_value(str(v))}"'
             for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(value: float) -> str:
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    if float(value) == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def render_prometheus(registry: MetricsRegistry) -> str:
    """The full exposition page for one registry."""
    return render_snapshot(registry.snapshot())


def render_snapshot(snap: Dict) -> str:
    """Render any registry-snapshot-shaped dict (``{"counters": [...],
    "gauges": [...], "histograms": [...]}``) — the seam that lets the
    federation aggregator's MERGED cluster view (telemetry/federation.py)
    ship over ``/metrics?scope=cluster`` through the exact renderer the
    per-process page uses."""
    lines: List[str] = []
    seen_type: set = set()

    def type_line(family: str, kind: str) -> None:
        if family not in seen_type:
            lines.append(f"# TYPE {family} {kind}")
            seen_type.add(family)

    for row in snap["counters"]:
        family = sanitize_name(row["name"])
        if not family.endswith("_total"):
            family += "_total"
        type_line(family, "counter")
        lines.append(
            f"{family}{_labels_str(row['labels'])} {_fmt(row['value'])}")

    for row in snap["gauges"]:
        family = sanitize_name(row["name"])
        type_line(family, "gauge")
        lines.append(
            f"{family}{_labels_str(row['labels'])} {_fmt(row['value'])}")

    for row in snap["histograms"]:
        family = sanitize_name(row["name"])
        type_line(family, "histogram")
        # trace exemplars: OpenMetrics exemplar syntax appended
        # to the owning bucket's sample line — ``... # {trace_id="…"}
        # <value> <ts>``. Only present when the histogram captured trace
        # ids (a tracer was configured), so a strict text-0.0.4 scrape of
        # an untraced process is byte-identical to the pre-exemplar
        # output (the golden test pins that).
        ex_by_le = {e["le"]: e for e in row.get("exemplars", [])}
        for b in row["buckets"]:
            le_label = 'le="%s"' % _fmt(b["le"])
            labels = _labels_str(row["labels"], le_label)
            line = f"{family}_bucket{labels} {b['count']}"
            ex = ex_by_le.get(b["le"])
            if ex is not None:
                line += (f' # {{trace_id="{_escape_label_value(str(ex["trace_id"]))}"}}'
                         f' {_fmt(ex["value"])} {round(float(ex["ts"]), 3)}')
            lines.append(line)
        lines.append(
            f"{family}_sum{_labels_str(row['labels'])} {_fmt(row['sum'])}")
        lines.append(
            f"{family}_count{_labels_str(row['labels'])} {row['count']}")

    return "\n".join(lines) + ("\n" if lines else "")
