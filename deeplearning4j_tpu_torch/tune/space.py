"""Counterpart of ``deeplearning4j_tpu/tune/space.py``: the declarative
search spaces of the autotuner, the same four spaces as JAX's.

A :class:`SearchSpace` names the knobs of one tunable seam, their
candidate values, and a validity predicate that rejects configs the seam
cannot run (e.g. ``alltoall_2d`` on a prime expert-axis size — the same
``factor_expert_axis`` check parallel/moe.py raises on, applied here
BEFORE any candidate is profiled). Each space carries a ``version``; the
tuning cache stores it with every entry so a space change invalidates
stale winners loudly (watchtower ``tune_cache_stale``) instead of
silently adopting configs searched under different semantics.

Registered spaces:

- ``flash_attention`` — blockwise ``block_q`` × ``block_k`` tiles (on the
  card they select K3f's key split: ``ops.flash_attention.key_split_for``).
- ``moe``             — ``moe_impl`` dispatch × ``capacity_factor``.
- ``pipeline``        — ``microbatches`` × ``overlap`` schedule.
- ``serve``           — decode ``min_bucket`` × ``slots``.

Validity returns ``None`` for a runnable config or a short human-readable
reason string; invalid configs are recorded in the decisions file but
never profiled or run.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

__all__ = [
    "Knob",
    "SearchSpace",
    "get_space",
    "register_space",
    "space_names",
    "space_version",
]

Config = Dict[str, Any]
# validity(config, context) -> None (valid) or reason string (rejected)
Validity = Callable[[Config, Dict[str, Any]], Optional[str]]


@dataclass(frozen=True)
class Knob:
    """One named knob and its candidate values, in search order."""

    name: str
    candidates: Tuple[Any, ...]


@dataclass(frozen=True)
class SearchSpace:
    """Cartesian product of knobs, filtered by a validity predicate."""

    seam: str
    version: int
    knobs: Tuple[Knob, ...]
    validity: Optional[Validity] = field(default=None, compare=False)

    def configs(self, context: Dict[str, Any]
                ) -> Iterator[Tuple[Config, Optional[str]]]:
        """Yield ``(config, invalid_reason)`` over the full product.

        ``invalid_reason`` is ``None`` for runnable configs. The context
        dict carries the concrete shapes (seq_len, n_devices, batch,
        max_len, ...) the predicate needs; searchers must not profile a
        config whose reason is non-None.
        """
        names = [k.name for k in self.knobs]
        for values in itertools.product(*(k.candidates for k in self.knobs)):
            cfg = dict(zip(names, values))
            reason = self.validity(cfg, context) if self.validity else None
            yield cfg, reason

    def size(self) -> int:
        n = 1
        for k in self.knobs:
            n *= len(k.candidates)
        return n


_SPACES: Dict[str, SearchSpace] = {}


def register_space(space: SearchSpace) -> SearchSpace:
    """Register (or replace) the space for ``space.seam``."""
    _SPACES[space.seam] = space
    return space


def get_space(seam: str) -> SearchSpace:
    try:
        return _SPACES[seam]
    except KeyError:
        raise KeyError(
            f"no search space registered for seam {seam!r}; "
            f"known: {sorted(_SPACES)}") from None


def space_names() -> Tuple[str, ...]:
    return tuple(sorted(_SPACES))


def space_version(seam: str) -> int:
    """Live knob-space version for ``seam`` (cache staleness anchor)."""
    return get_space(seam).version


# ---------------------------------------------------------------------------
# Registered spaces
# ---------------------------------------------------------------------------

def _flash_validity(cfg: Config, ctx: Dict[str, Any]) -> Optional[str]:
    t = int(ctx.get("seq_len", 0))
    for name in ("block_q", "block_k"):
        b = int(cfg[name])
        if b > t:
            return f"{name}={b} exceeds seq_len={t}"
        if t % b != 0:
            return f"{name}={b} does not divide seq_len={t}"
    return None


register_space(SearchSpace(
    seam="flash_attention",
    version=1,
    knobs=(
        Knob("block_q", (64, 128, 256, 512, 1024)),
        Knob("block_k", (64, 128, 256, 512, 1024)),
    ),
    validity=_flash_validity,
))


def _moe_validity(cfg: Config, ctx: Dict[str, Any]) -> Optional[str]:
    impl = cfg["moe_impl"]
    n_dev = int(ctx.get("expert_devices", 1))
    if impl == "alltoall_2d":
        # Same predicate parallel/moe.py raises on at dispatch time:
        # the 2D factorization needs a composite axis >= 4.
        from deeplearning4j_tpu_torch.parallel.moe import factor_expert_axis
        try:
            factor_expert_axis(n_dev)
        except ValueError as e:
            return f"alltoall_2d: {e}"
    if impl != "replicated" and n_dev < 2:
        return f"{impl} needs a sharded expert axis (got {n_dev} device)"
    factor = float(cfg["capacity_factor"])
    if factor < 1.0:
        return f"capacity_factor={factor} would drop tokens vs default"
    return None


register_space(SearchSpace(
    seam="moe",
    version=1,
    knobs=(
        Knob("moe_impl", ("alltoall", "alltoall_2d", "replicated")),
        Knob("capacity_factor", (1.0, 1.25, 1.5, 2.0)),
    ),
    validity=_moe_validity,
))


def _pipeline_validity(cfg: Config, ctx: Dict[str, Any]) -> Optional[str]:
    m = int(cfg["microbatches"])
    batch = int(ctx.get("batch", 0))
    if batch % m != 0:
        return f"microbatches={m} does not divide batch={batch}"
    return None


register_space(SearchSpace(
    seam="pipeline",
    version=1,
    knobs=(
        Knob("microbatches", (2, 4, 8)),
        Knob("overlap", (False, True)),
    ),
    validity=_pipeline_validity,
))


def _serve_validity(cfg: Config, ctx: Dict[str, Any]) -> Optional[str]:
    max_len = int(ctx.get("max_len", 0))
    if int(cfg["min_bucket"]) >= max_len:
        return f"min_bucket={cfg['min_bucket']} >= max_len={max_len}"
    return None


register_space(SearchSpace(
    seam="serve",
    version=1,
    knobs=(
        Knob("min_bucket", (4, 8, 16, 32)),
        Knob("slots", (2, 4, 8)),
    ),
    validity=_serve_validity,
))
