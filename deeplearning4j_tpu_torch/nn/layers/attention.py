"""Counterpart of ``deeplearning4j_tpu/nn/layers/attention.py``: the
multi-head self-attention block, a sequence head under MultiLayerNetwork
with the LSTM's head contract (the layer owns a decoder projection that
emits per-timestep logits).

Block: pre-LayerNorm multi-head self-attention (causal by conf) with a
residual connection, then the decoder projection n_in → n_out. The
attention core is ``ops.flash_attention.attention_core``: dense at short
T, the flash kernels (K3f forward, K3k and K3q backward) at T >= 1024.
The transformer LM's decoder blocks share the layernorm and head
split/merge helpers. ``forward_ring`` runs the block with the sequence
sharded over a mesh axis (ring attention).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.params import DECODER_BIAS_KEY, \
    DECODER_WEIGHT_KEY

LN_GAIN_KEY = "ln_g"
LN_BIAS_KEY = "ln_b"
Q_KEY, K_KEY, V_KEY, OUT_KEY = "wq", "wk", "wv", "wo"


def _layernorm(x: torch.Tensor, g: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis with the POPULATION variance, as
    ``jnp.var`` computes it (torch's default is the unbiased estimator).
    The rsqrt runs in f32 (f64 for f64 inputs) and rounds once to x's
    dtype, as XLA's does: torch's bf16 rsqrt on the CPU rounds twice and
    lands one bf16 step off for some inputs."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    acc = torch.promote_types(x.dtype, torch.float32)
    inv = torch.rsqrt((var + 1e-5).to(acc)).to(x.dtype)
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


def attend_block(conf: NeuralNetConfiguration,
                 params: Dict[str, torch.Tensor], x: torch.Tensor,
                 attn_core) -> torch.Tensor:
    """Pre-LN MHA + residual; ``attn_core(q, k, v) -> out`` supplies the
    attention math ((B,H,T,Hd) in and out) so every path shares the
    projections."""
    xn = _layernorm(x, params[LN_GAIN_KEY], params[LN_BIAS_KEY])
    return x + attend_heads(params, xn, conf.n_heads, attn_core)


def attend_heads(params: Dict[str, torch.Tensor], xn: torch.Tensor,
                 n_heads: int, attn_core) -> torch.Tensor:
    """The block's attention term of the layernormed input ``xn``: the
    q/k/v projections split into ``n_heads`` heads, ``attn_core``, the
    merge and the output projection. Over a rank's columns of
    ``wq``/``wk``/``wv`` and rows of ``wo`` (its heads) it is the rank's
    partial sum of the term (``parallel.tensor_parallel``)."""
    q = _split_heads(xn @ params[Q_KEY], n_heads)
    k = _split_heads(xn @ params[K_KEY], n_heads)
    v = _split_heads(xn @ params[V_KEY], n_heads)
    return _merge_heads(attn_core(q, k, v)) @ params[OUT_KEY]


def _forward(conf: NeuralNetConfiguration, params: Dict[str, torch.Tensor],
             x: torch.Tensor, attn_core) -> torch.Tensor:
    """Shared 2-D lift + block + decoder head for every attention path."""
    if x.dim() == 2:
        x = x[None]
    hs = attend_block(conf, params, x, attn_core)
    return hs @ params[DECODER_WEIGHT_KEY] + params[DECODER_BIAS_KEY]


def _dense_core(conf: NeuralNetConfiguration):
    # ops/flash_attention dispatches: the flash kernels at long
    # block-aligned T, the materializing reference at short T — the same
    # function
    from deeplearning4j_tpu_torch.ops.flash_attention import attention_core

    return lambda q, k, v: attention_core(q, k, v, causal=conf.causal)


def hidden_sequence(conf: NeuralNetConfiguration,
                    params: Dict[str, torch.Tensor],
                    x: torch.Tensor) -> torch.Tensor:
    """The block output before the decoder: (batch, time, n_in)."""
    if x.dim() == 2:
        x = x[None]
    return attend_block(conf, params, x, _dense_core(conf))


def forward(conf: NeuralNetConfiguration, params: Dict[str, torch.Tensor],
            x: torch.Tensor, *, train: bool = False,
            key: Optional[int] = None,
            drop_connect: bool = False) -> torch.Tensor:
    """Per-timestep logits: (batch, time, n_out)."""
    return _forward(conf, params, x, _dense_core(conf))


def forward_ring(conf: NeuralNetConfiguration,
                 params: Dict[str, torch.Tensor], x: torch.Tensor, mesh,
                 axis: str) -> torch.Tensor:
    """The block with the SEQUENCE axis sharded over ``axis``: attention
    runs as ring attention (``parallel.ring_attention``; K/V blocks
    rotating over the axis, online-softmax merge), so a rank holds O(T/P).
    x: this rank's sequence block (batch, T/P, n_in), the one at its index
    on ``axis``; returns its block of ``forward``'s logits. Every rank of
    the axis calls it."""
    from deeplearning4j_tpu_torch.parallel.ring_attention import \
        ring_attention

    return _forward(
        conf, params, x,
        lambda q, k, v: ring_attention(q, k, v, mesh, axis,
                                       causal=conf.causal))
