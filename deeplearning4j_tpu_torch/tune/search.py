"""Counterpart of ``deeplearning4j_tpu/tune/search.py``: the two-phase
roofline-guided config search.

Phase 1: every *valid* candidate is profiled through
``telemetry.xprofile.profile_compiled`` and its roofline position derived
via ``attribute``: the implied compute/memory/comm seconds, the binding
resource, peak bytes, and collective wire bytes. JAX's phase 1 compiles
each candidate and executes none; an eager PyTorch step has no compiled
program, so the port's ``profile_compiled`` counts the ops of one REAL
call, and phase 1 RUNS each valid candidate once. Candidates whose cost
vector is strictly dominated by another candidate's (every component >=,
at least one >) are pruned and never reach phase 2; the decisions file
records who dominated whom.

The kernels' analytic costs (``ops/_kernels.py``'s ``*_cost``) do not
depend on their tiles, so the ``flash_attention`` candidates of one
context have equal cost vectors: none dominates another and none is
pruned. The ``serve`` seam's candidates differ in cost (bucket × slots),
and pruning works there as it does in JAX.

Phase 2: only the Pareto frontier is wall-clock measured, with the
paired-median discipline: default and candidate alternate within each
repeat and the per-pair ratio's median is the score, so machine drift
cancels. Every measured candidate's outputs are compared against the
default config's through the seam's ``outputs_match`` predicate; a
candidate that changes numerics cannot win no matter how fast it is. The
default config is always a candidate, so the winner's tuned-vs-default
ratio is >= 1.0 by construction.

The decisions file (``tuning_<seam>.json``, schema ``dl4j-tpu-tuning-v1``,
JAX's) also carries a predicted-vs-measured Spearman rank correlation,
the honesty metric for the cost model itself, rendered by
``tools/tune_report.py``.
"""

from __future__ import annotations

import json
import logging
import os
import statistics
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.telemetry.xprofile import attribute
from deeplearning4j_tpu_torch.tune.space import SearchSpace

__all__ = ["CandidateRecord", "SearchResult", "search", "spearman"]

log = logging.getLogger(__name__)

Config = Dict[str, Any]
# compile_fn(config) -> StepProfile of one call (or None when the seam's
# knobs are host-side only and nothing per config exists to profile)
CompileFn = Callable[[Config], Any]
# measure_fn(config) -> (seconds, outputs) for ONE timed execution;
# the harness owns per-config warmup and step caching
MeasureFn = Callable[[Config], Tuple[float, Any]]
MatchFn = Callable[[Any, Any], bool]

# Cost-vector components, in decisions-file order.
_COST_KEYS = ("implied_compute_s", "implied_memory_s", "implied_comm_s",
              "peak_bytes", "wire_bytes")


@dataclass
class CandidateRecord:
    """Everything the searcher learned about one config."""

    config: Config
    is_default: bool = False
    invalid_reason: Optional[str] = None
    # phase 1
    profiled: bool = False
    cost: Optional[Dict[str, float]] = None
    bound: Optional[str] = None
    arithmetic_intensity: Optional[float] = None
    compile_seconds: Optional[float] = None
    pruned_by: Optional[Config] = None
    pruned_reason: Optional[str] = None
    # phase 2
    measured: bool = False
    ratio_vs_default: Optional[float] = None  # candidate_s / default_s
    numerics_match: Optional[bool] = None
    winner: bool = False

    def predicted_seconds(self) -> Optional[float]:
        if not self.cost:
            return None
        return max(self.cost["implied_compute_s"],
                   self.cost["implied_memory_s"],
                   self.cost["implied_comm_s"])

    def to_dict(self) -> Dict[str, Any]:
        return {
            "config": self.config,
            "is_default": self.is_default,
            "invalid_reason": self.invalid_reason,
            "profiled": self.profiled,
            "cost": self.cost,
            "bound": self.bound,
            "arithmetic_intensity": self.arithmetic_intensity,
            "compile_seconds": self.compile_seconds,
            "predicted_seconds": self.predicted_seconds(),
            "pruned_by": self.pruned_by,
            "pruned_reason": self.pruned_reason,
            "measured": self.measured,
            "ratio_vs_default": self.ratio_vs_default,
            "numerics_match": self.numerics_match,
            "winner": self.winner,
        }


@dataclass
class SearchResult:
    seam: str
    version: int
    context: Dict[str, Any]
    default_config: Config
    winner_config: Config
    tuned_vs_default: float  # default_s / winner_s, >= 1.0 by construction
    candidates: List[CandidateRecord] = field(default_factory=list)
    rank_correlation: Optional[float] = None
    counts: Dict[str, int] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": "dl4j-tpu-tuning-v1",
            "seam": self.seam,
            "space_version": self.version,
            "context": self.context,
            "default_config": self.default_config,
            "winner_config": self.winner_config,
            "tuned_vs_default": self.tuned_vs_default,
            "rank_correlation": self.rank_correlation,
            "counts": self.counts,
            "candidates": [c.to_dict() for c in self.candidates],
        }


def _cost_vector(profile) -> Tuple[Dict[str, float], str, Optional[float]]:
    """Roofline position of one profiled candidate.

    ``attribute`` at a unit step time yields the implied lower-bound
    seconds per resource; peak/wire bytes join the dominance vector so a
    config can't win the clock race while silently costing more HBM or
    interconnect. A device that withholds a field (xprofile's explicit
    ``None``: peak bytes on the CPU) contributes 0 — uniform across
    candidates of one search, so dominance comparisons stay consistent.
    """
    attr = attribute(profile, 1.0)
    implied = attr["implied_seconds"]
    cost = {
        "implied_compute_s": float(implied["compute"]),
        "implied_memory_s": float(implied["memory"]),
        "implied_comm_s": float(implied["comm"]),
        "peak_bytes": float(profile.peak_bytes or 0.0),
        "wire_bytes": float(profile.collective_wire_bytes or 0.0),
    }
    return cost, attr["bound"], attr["arithmetic_intensity"]


def _dominates(a: Dict[str, float], b: Dict[str, float]) -> bool:
    """True when ``a`` is no worse on every component and better on one."""
    return (all(a[k] <= b[k] for k in _COST_KEYS)
            and any(a[k] < b[k] for k in _COST_KEYS))


def _rank(values: List[float]) -> List[float]:
    """Average ranks (1-based) with ties shared."""
    order = sorted(range(len(values)), key=lambda i: values[i])
    ranks = [0.0] * len(values)
    i = 0
    while i < len(order):
        j = i
        while j + 1 < len(order) and values[order[j + 1]] == values[order[i]]:
            j += 1
        r = (i + j) / 2.0 + 1.0
        for k in range(i, j + 1):
            ranks[order[k]] = r
        i = j + 1
    return ranks


def spearman(xs: List[float], ys: List[float]) -> Optional[float]:
    """Spearman rank correlation; None under n<2 or a constant series."""
    if len(xs) != len(ys) or len(xs) < 2:
        return None
    rx, ry = _rank(xs), _rank(ys)
    mx = sum(rx) / len(rx)
    my = sum(ry) / len(ry)
    sxx = sum((a - mx) ** 2 for a in rx)
    syy = sum((b - my) ** 2 for b in ry)
    if sxx == 0 or syy == 0:
        return None
    sxy = sum((a - mx) * (b - my) for a, b in zip(rx, ry))
    return sxy / (sxx * syy) ** 0.5


def _cfg_key(cfg: Config) -> Tuple:
    return tuple(sorted(cfg.items()))


def search(space: SearchSpace, context: Dict[str, Any],
           default_config: Config, compile_fn: CompileFn,
           measure_fn: MeasureFn,
           outputs_match: Optional[MatchFn] = None,
           repeats: int = 5, out_dir: Optional[str] = None) -> SearchResult:
    """Run the two-phase search over ``space`` for one seam instance.

    The default config is injected as a candidate (and exempt from
    pruning — it is the baseline phase 2 pairs against). ``repeats``
    paired (default, candidate) timings per frontier config; the median
    of per-pair ratios is the score. When ``out_dir`` is given the full
    decisions record lands at ``out_dir/tuning_<seam>.json``.
    """
    outputs_match = outputs_match or (lambda a, b: a == b)

    # ---- enumerate (validity predicates run before any profile) ----
    records: List[CandidateRecord] = []
    seen = set()
    default_key = _cfg_key(default_config)
    for cfg, reason in space.configs(context):
        rec = CandidateRecord(config=cfg, invalid_reason=reason,
                              is_default=_cfg_key(cfg) == default_key)
        seen.add(_cfg_key(cfg))
        records.append(rec)
    if default_key not in seen:
        records.insert(0, CandidateRecord(config=dict(default_config),
                                          is_default=True))
    default_rec = next(r for r in records if r.is_default)
    if default_rec.invalid_reason:
        raise ValueError(
            f"default config {default_config} invalid for seam "
            f"{space.seam!r}: {default_rec.invalid_reason}")

    # ---- phase 1: one profiled call each + roofline dominance pruning ----
    for rec in records:
        if rec.invalid_reason:
            continue
        prof = compile_fn(rec.config)
        if prof is None:
            continue  # host-side knob: nothing to profile
        rec.profiled = True
        rec.cost, rec.bound, rec.arithmetic_intensity = _cost_vector(prof)
        rec.compile_seconds = prof.compile_seconds

    profiled = [r for r in records if r.profiled]
    for rec in profiled:
        if rec.is_default:
            continue  # the baseline always runs
        for other in profiled:
            if other is rec or other.pruned_by is not None:
                continue
            if _dominates(other.cost, rec.cost):
                rec.pruned_by = other.config
                rec.pruned_reason = "; ".join(
                    f"{k} {rec.cost[k]:.3e} >= {other.cost[k]:.3e}"
                    for k in _COST_KEYS if rec.cost[k] > other.cost[k])
                break

    frontier = [r for r in records
                if not r.invalid_reason and r.pruned_by is None]

    # ---- phase 2: paired-median wall clock on the frontier only ----
    # Warm the default once; its outputs are the numerics baseline.
    _, default_out = measure_fn(default_config)
    for rec in frontier:
        if rec.is_default:
            rec.measured = True
            rec.ratio_vs_default = 1.0
            rec.numerics_match = True
            continue
        _, out = measure_fn(rec.config)  # warmup (builds on first call)
        rec.numerics_match = bool(outputs_match(default_out, out))
        ratios = []
        for _ in range(max(int(repeats), 3)):
            td, _ = measure_fn(default_config)
            tc, _ = measure_fn(rec.config)
            ratios.append(tc / max(td, 1e-12))
        rec.measured = True
        rec.ratio_vs_default = statistics.median(ratios)
        if not rec.numerics_match:
            log.warning("tune[%s]: candidate %s changes outputs vs default "
                        "— excluded from winning", space.seam, rec.config)

    eligible = [r for r in frontier if r.measured and r.numerics_match]
    winner = min(eligible, key=lambda r: r.ratio_vs_default)
    winner.winner = True
    tuned_vs_default = 1.0 / max(winner.ratio_vs_default, 1e-12)

    # ---- cost-model honesty: predicted vs measured rank correlation ----
    ranked = [r for r in frontier if r.measured
              and r.predicted_seconds() is not None]
    rank_corr = spearman([r.predicted_seconds() for r in ranked],
                         [r.ratio_vs_default for r in ranked])

    result = SearchResult(
        seam=space.seam, version=space.version, context=context,
        default_config=dict(default_config), winner_config=dict(winner.config),
        tuned_vs_default=tuned_vs_default, candidates=records,
        rank_correlation=rank_corr,
        counts={
            "total": len(records),
            "invalid": sum(1 for r in records if r.invalid_reason),
            "profiled": len(profiled),
            "pruned": sum(1 for r in records if r.pruned_by is not None),
            "measured": sum(1 for r in records if r.measured),
        })

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"tuning_{space.seam}.json")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(result.to_dict(), f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    return result
