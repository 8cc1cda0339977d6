"""Counterpart of ``deeplearning4j_tpu/nn/layers/convolution.py``: the
convolution layer (ref: nn/layers/convolution/ConvolutionLayer.java:115-128,
which loops ``convn(input, filter, VALID)`` per feature map).

The whole layer is one VALID, stride-1 convolution in NCHW / OIHW layout
(``nn/params.py``), by one of two routes that compute the same function:

- ``torch.nn.functional.conv2d`` (cuDNN on the card), where the JAX package
  runs ``lax.conv_general_dilated``, with its weight gradient taken as one
  product over the unfolded patches (``_Conv2d``: cuDNN's f32 weight
  gradient can be a Winograd transform, 5.4e-3 off at conv_wide's
  shapes);
- ``im2col_conv``: the patches unfolded (a strided view) and contracted
  with one product, the JAX package's im2col einsum and the parity
  oracle.

``conv2d`` keeps the JAX package's gate (``_EMITTER_MIN_CONTRACTION``: the
convolution route when C*KH*KW >= 512, im2col below) and its override
``set_conv_emitter``, so the switch means the same in both packages. The
gate was measured on the TPU's compiler; on the card it is kept for
parity, not speed.

f32 convolutions follow ``torch.backends.cudnn.allow_tf32``, which defaults
to True: outside a caller that turns it off, cuDNN rounds f32 operands to
TF32. The layer sets no global flag.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as torch_f

from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.params import CONV_BIAS_KEY, CONV_WEIGHT_KEY
from deeplearning4j_tpu_torch.ops.activations import activation

# A/B switch (None = the shape gate, see conv2d; True forces the
# convolution route, False im2col)
_use_conv_emitter: Optional[bool] = None

# the JAX package's gate: the convolution route when the im2col
# contraction (C*KH*KW) is at least this wide
_EMITTER_MIN_CONTRACTION = 512


def set_conv_emitter(enabled: Optional[bool]) -> None:
    global _use_conv_emitter
    _use_conv_emitter = enabled


def _patches(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """The (B*H'*W', C*KH*KW) patch matrix of x (B,C,H,W): a strided view
    (``Tensor.unfold`` twice: no copy, and one kernel for its backward)
    gathered by one copy. ``torch.nn.functional.unfold`` would launch one
    im2col kernel per example on the card."""
    b, c, h, wd = x.shape
    cols = x.unfold(2, kh, 1).unfold(3, kw, 1)  # (B, C, H', W', KH, KW)
    return cols.permute(0, 2, 3, 1, 4, 5).reshape(
        b * (h - kh + 1) * (wd - kw + 1), c * kh * kw)


def im2col_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID stride-1 conv via im2col: x (B,C,H,W) * w (O,C,KH,KW) ->
    (B,O,H',W'), one product of the patch matrix with the filters; the
    parity oracle for ``conv2d``."""
    o, c, kh, kw = w.shape
    b, _, h, wd = x.shape
    out = _patches(x, kh, kw) @ w.reshape(o, c * kh * kw).T  # (B*H'*W', O)
    return out.reshape(b, h - kh + 1, wd - kw + 1, o).permute(0, 3, 1, 2)


class _Conv2d(torch.autograd.Function):
    """``torch.nn.functional.conv2d`` forward and input gradient (cuDNN's
    implicit-GEMM fprop and dgrad on the card); the weight gradient is one
    product over the patch matrix. At f32 with TF32 off, cuDNN's own
    weight gradient at conv_wide's second layer (C=128, 14x14, 5x5) is its
    non-fused Winograd F(9x9, 5x5), 5.4e-3 of the largest |dW| off a
    float64 reference; the product is 5e-7 off."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch_f.conv2d(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(x.shape, w, g)
        if ctx.needs_input_grad[1]:
            o, c, kh, kw = w.shape
            g2 = g.permute(0, 2, 3, 1).reshape(-1, o)  # (B*H'*W', O)
            dw = (g2.T @ _patches(x, kh, kw)).reshape(w.shape)
        return dx, dw


def conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID stride-1 conv: x (B,C,H,W) * w (O,C,KH,KW) -> (B,O,H',W')."""
    o, c, kh, kw = w.shape
    use_emitter = c * kh * kw >= _EMITTER_MIN_CONTRACTION
    if _use_conv_emitter is not None:
        use_emitter = _use_conv_emitter
    if not use_emitter:
        return im2col_conv(x, w)
    return _Conv2d.apply(x, w)


def forward(conf: NeuralNetConfiguration, params: Dict[str, torch.Tensor],
            x: torch.Tensor, *, train: bool = False,
            key: Optional[int] = None) -> torch.Tensor:
    w = params[CONV_WEIGHT_KEY]
    b = params[CONV_BIAS_KEY]
    # the weights set the compute dtype (bf16 under a bf16 policy)
    out = conv2d(x.to(w.dtype), w)
    out = out + b[None, :, None, None]
    return activation(conf.activation_function)(out)
