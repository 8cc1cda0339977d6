"""Counterpart of ``deeplearning4j_tpu/ops/activations.py``.

Slice 1 ports only ``softmax``, which the attention oracle, decode
attention and MoE routing share. The activation registry comes with the
MultiLayerNetwork slices.
"""

from __future__ import annotations

import torch


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis in ``jax.nn.softmax``'s op order: max,
    subtract, exp, sum, divide, each rounding to x's dtype. At bf16 this
    agrees with JAX where ``torch.softmax`` (f32 inside, one rounding at
    the end) lands a bf16 step away on many entries; at f32 the two are
    the same math."""
    unnormalized = torch.exp(x - x.amax(-1, keepdim=True))
    return unnormalized / unnormalized.sum(-1, keepdim=True)
