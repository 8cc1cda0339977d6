"""Counterpart of ``deeplearning4j_tpu/serve/speculative.py``: the
speculative-decoding config and the host-side acceptance rule. Framework
free; the port keeps its own copy.

The draft/verify scheme (greedy variant): a cheap draft LM proposes ``k``
tokens per slot, the flagship verifies all ``k`` in ONE
``make_verify_step`` call of width ``k + 1`` (inputs ``[t_pending,
d_1..d_k]`` at positions ``p..p+k``), and the host accepts the longest
prefix of proposals that match the flagship's own greedy choices, plus the
flagship's "bonus" token at the first mismatch. A verify step emits between
1 (zero-accept) and ``k + 1`` (all-accept) tokens for ONE flagship call,
and the emitted greedy stream is exactly the non-speculative one.

Rejected draft positions leave stale K/V in both caches; the engine's
write-then-mask discipline makes that free: the next call's contiguous
writes land at or before every stale position before any query can attend
to it.

Sampling slots (``temperature > 0``) accept only position 0's sampled
token: distribution-correct, no speedup.

The seam defaults OFF: enable per engine with ``speculative=`` (an int
``k``, a :class:`SpeculativeConfig`, or ``True`` for the defaults) or
process-wide with ``DL4J_TPU_SERVE_SPEC`` (``"k"`` or ``"k:draft_layers"``,
e.g. ``DL4J_TPU_SERVE_SPEC=4:1``; empty/``0`` disables), the variable both
packages read.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

ENV_SPEC = "DL4J_TPU_SERVE_SPEC"


@dataclasses.dataclass(frozen=True)
class SpeculativeConfig:
    """``k`` proposals per verify; the draft is either the flagship's
    first ``draft_layers`` blocks (``draft_truncate_params``: no training,
    shares the flagship's tensors) or an explicit ``draft_params`` tree
    (e.g. a ``draft_distill_loss``-trained student)."""

    k: int = 2
    draft_layers: int = 1
    draft_params: Optional[dict] = None

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"speculative k must be >= 1, got {self.k}")
        if self.draft_params is None and self.draft_layers < 1:
            raise ValueError(
                f"draft_layers must be >= 1, got {self.draft_layers}")


def resolve_speculative(speculative=None) -> Optional[SpeculativeConfig]:
    """The engine-knob/env seam: an explicit argument wins; with
    ``speculative=None`` the ``DL4J_TPU_SERVE_SPEC`` env var applies.
    Returns None when speculation is off."""
    if speculative is not None:
        if speculative is False:
            return None
        if speculative is True:
            return SpeculativeConfig()
        if isinstance(speculative, SpeculativeConfig):
            return speculative
        if isinstance(speculative, int):
            return SpeculativeConfig(k=speculative)
        raise TypeError(
            f"speculative= must be bool/int/SpeculativeConfig, got "
            f"{type(speculative).__name__}")
    raw = os.environ.get(ENV_SPEC, "").strip()
    if not raw or raw == "0":
        return None
    parts = raw.split(":")
    try:
        k = int(parts[0])
        layers = int(parts[1]) if len(parts) > 1 else 1
    except ValueError:
        raise ValueError(
            f"{ENV_SPEC} must be 'k' or 'k:draft_layers', got {raw!r}")
    if k < 1:
        return None
    return SpeculativeConfig(k=k, draft_layers=layers)


def accept_longest_prefix(drafts: Sequence[int],
                          verify: Sequence[int]) -> Tuple[int, List[int]]:
    """Greedy acceptance: ``drafts`` are the k proposals, ``verify`` the
    k+1 flagship greedy tokens (``verify[i]`` = the flagship's choice
    AFTER consuming proposals ``drafts[:i]``). Returns ``(a, emitted)``
    where ``a`` is the accepted-proposal count and ``emitted`` the
    ``a + 1`` output tokens: ``verify[:a + 1]``, the accepted run plus the
    flagship's bonus token at the divergence."""
    k = len(drafts)
    if len(verify) != k + 1:
        raise ValueError(
            f"verify must carry k+1={k + 1} tokens, got {len(verify)}")
    a = 0
    while a < k and int(drafts[a]) == int(verify[a]):
        a += 1
    return a, [int(t) for t in verify[:a + 1]]
