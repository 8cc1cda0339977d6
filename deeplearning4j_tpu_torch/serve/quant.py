"""Counterpart of ``deeplearning4j_tpu/serve/quant.py``: the ``serve_dtype=``
seam, serving-precision weight preparation on plain dicts of tensors.

- ``None`` / ``"f32"``: passthrough (the parity precision).
- ``"bf16"``: every float leaf cast to bfloat16 (the serving default).
- ``"int8"``: weight-only quantization of the matmul weights (the
  ``_MATMUL_KEYS`` leaf names): symmetric per-output-channel int8 with an
  f32 scale, held in a :class:`QuantTensor`. Everything else (biases,
  layernorm gains) stays bf16. The int8 and scale tensors are bit-identical
  to the JAX package's (``torch.round`` rounds half to even like
  ``jnp.round``).

The decode/prefill steps take a ``params_transform`` hook and the engine
passes :func:`dequantize_tree`, so the weights rest as int8 and are widened
to bf16 at use.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch._device import tree_leaves, tree_map

SERVE_DTYPES = (None, "f32", "bf16", "int8")


class QuantTensor:
    """An int8-quantized weight + its per-output-channel f32 scale."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    @property
    def shape(self):
        return self.q.shape

    @property
    def nbytes(self) -> int:
        return int(self.q.numel() * self.q.element_size()
                   + self.scale.numel() * self.scale.element_size())

    def dequantize(self) -> torch.Tensor:
        return self.q.to(torch.bfloat16) * self.scale.to(torch.bfloat16)

    def __repr__(self):
        return f"QuantTensor(shape={tuple(self.q.shape)})"


# leaf names that ARE matmul weights in the flagship-LM params tree; the
# last two axes are (contraction, output-channel)
_MATMUL_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "router", "w1", "w2", "dec_w", "embed"})


def _to_bf16(w):
    return w.to(torch.bfloat16) if w.is_floating_point() else w


def _quantize_leaf(path: tuple, w: torch.Tensor):
    """Symmetric per-output-channel int8 for matmul weights: scale over the
    contraction axis (-2). Non-matmul leaves fall back to bf16."""
    key = path[-1] if path else None
    if key not in _MATMUL_KEYS or w.dim() < 2 or not w.is_floating_point():
        return _to_bf16(w)
    amax = torch.amax(torch.abs(w), dim=-2, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QuantTensor(q, scale.to(torch.float32))


def prepare_serve_params(params: dict, serve_dtype: Optional[str]) -> dict:
    """Apply the serving-precision seam to a params tree. Raises on an
    unknown ``serve_dtype``."""
    if serve_dtype not in SERVE_DTYPES:
        raise ValueError(f"unknown serve_dtype {serve_dtype!r}; options: "
                         + ", ".join(str(d) for d in SERVE_DTYPES))
    if serve_dtype in (None, "f32"):
        return params
    if serve_dtype == "bf16":
        return tree_map(lambda _, w: _to_bf16(w), params)
    return tree_map(_quantize_leaf, params)


def dequantize_tree(params: dict) -> dict:
    """Widen every QuantTensor back to a dense bf16 tensor and pass
    everything else through (identity for f32/bf16 trees)."""
    return tree_map(
        lambda _, x: x.dequantize() if isinstance(x, QuantTensor) else x,
        params)


def activation_dtype(serve_dtype: Optional[str]) -> torch.dtype:
    """The dtype decode activations (and so the KV cache) run at: f32 for
    the parity precision, bf16 otherwise."""
    return torch.float32 if serve_dtype in (None, "f32") else torch.bfloat16


def params_nbytes(params: dict) -> int:
    """Total at-rest weight bytes of a (possibly quantized) params tree."""
    return int(sum(
        leaf.nbytes if isinstance(leaf, QuantTensor)
        else leaf.numel() * leaf.element_size()
        for leaf in tree_leaves(params)))
