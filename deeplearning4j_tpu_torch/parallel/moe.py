"""Counterpart of ``deeplearning4j_tpu/parallel/moe.py``.

Slice 1 ports only ``_routing``, which the single-device ``dense_moe`` of
the transformer LM uses. Expert-parallel dispatch (replicated, all-to-all)
comes with the composed-parallelism slice.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops.activations import softmax


def _top_k_indices(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, ties to the
    lower index first (``jax.lax.top_k``'s order): a stable descending
    sort, where ``torch.topk`` documents no tie order."""
    return torch.sort(logits, dim=-1, descending=True, stable=True)[1][..., :k]


def _routing(logits: torch.Tensor, top_k: int):
    """(N, E) logits → (idx (N,k), gates (N,k)). Gates are softmax probs of
    the chosen experts, renormalized to sum to 1 when k > 1 (GShard)."""
    probs = softmax(logits)
    idx = _top_k_indices(logits, top_k)
    g = torch.gather(probs, 1, idx)
    if top_k > 1:
        g = g / torch.clamp_min(g.sum(-1, keepdim=True), 1e-9)
    return idx, g
