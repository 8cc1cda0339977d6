"""Counterpart of ``deeplearning4j_tpu/parallel/ring_attention.py``.

Slice 1 ports only ``reference_attention``, the materializing oracle behind
``ops.flash_attention.dense_attention``. Ring and Ulysses sequence
parallelism come with the composed-parallelism slice.
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.ops.activations import softmax

_NEG_INF = -1e30


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """Unsharded dense attention over (B, H, T, Dh) for verification. Keeps
    the input dtype throughout, as the JAX oracle does (its ``jnp.sqrt``
    scale is weakly typed, so bf16 scores stay bf16)."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(
        q.shape[-1] * 1.0)
    if causal:
        t = q.shape[2]
        pos = torch.arange(t, device=q.device)
        mask = pos[:, None] >= pos[None, :]
        scores = torch.where(mask[None, None], scores,
                             torch.tensor(_NEG_INF, dtype=scores.dtype,
                                          device=scores.device))
    return torch.einsum("bhqk,bhkd->bhqd", softmax(scores), v)
