"""The transformer LM's params for the port's parity tests, as a numpy
tree in the JAX package's keys and layouts.

The parity tests hand the same params to both packages, so where they
come from does not matter to what a test checks: they are drawn here by
the port's ``init_lm_params`` (the JAX package's scales) from a CPU
``torch.Generator``, in milliseconds, where JAX's ``init_lm_params``
compiles its random ops anew for every shape (seconds each).
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.interop import tree_to_numpy
from deeplearning4j_tpu_torch.models.transformer_lm import init_lm_params


def lm_params_np(seed: int, vocab: int, d_model: int, n_heads: int,
                 n_experts: int, d_ff: int, n_layers: int = 1) -> dict:
    """``init_lm_params``' tree from a generator seeded ``seed``, as numpy
    f32 arrays."""
    return tree_to_numpy(init_lm_params(
        torch.Generator().manual_seed(seed), vocab, d_model, n_heads,
        n_experts, d_ff, n_layers=n_layers, device="cpu"))
