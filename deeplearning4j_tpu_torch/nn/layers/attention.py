"""Counterpart of ``deeplearning4j_tpu/nn/layers/attention.py``.

Slice 1 ports only the helpers the transformer LM's decoder blocks share:
the pre-LN layernorm and the head split/merge. The ATTENTION layer itself
comes with the MultiLayerNetwork slices.
"""

from __future__ import annotations

import torch


def _layernorm(x: torch.Tensor, g: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis with the POPULATION variance, as
    ``jnp.var`` computes it (torch's default is the unbiased estimator).
    The rsqrt runs in f32 and rounds once to x's dtype, as XLA's does:
    torch's bf16 rsqrt on the CPU rounds twice and lands one bf16 step
    off for some inputs."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    inv = torch.rsqrt((var + 1e-5).float()).to(x.dtype)
    return (x - mu) * inv * g + b


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, T, D) → (B, H, T, D/H). Returns a transposed VIEW: callers that
    hand it to a kernel pass ``.contiguous()``."""
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, Hd) → (B, T, D)."""
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)
