"""Counterpart of ``deeplearning4j_tpu/ops/pallas_kernels.py``, which holds
the JAX package's Pallas TPU kernels. The module keeps its name so a reader
finds it; the kernels here are hand-written CUDA for Hopper.

- ``fused_dense``: ``act(x @ W + b)`` with the bias and activation in the
  epilogue of one kernel, ``csrc/fused_dense.cu`` (K1), differentiable
  through ``FusedDense``, a ``torch.autograd.Function`` whose backward is
  the JAX package's lax backward (``_fused_dense_bwd``) in plain torch:
  ``d = g·act'(out)``, ``dx = d Wᵀ``, ``dW = xᵀ d``, ``db = Σd``.
  The JAX package never ran a kernel for that backward either.

``fused_dense_reference`` is the kernel's plain version: f32 accumulation,
bias and activation in f32, one rounding to x's dtype, as the TPU kernel
computes. ``fused_dense_fwd`` uses it only for a tensor on the CPU; on a
CUDA tensor it launches K1 or raises. The TPU kernel's shape gate
(``_dense_shapes_ok``: m % 8, k % 128, n % 128, k <= 4096) is a TPU
layout rule and has no counterpart here: K1 masks its edges and tiles K,
so it takes every shape, those of the MNIST MLP included.

``lstm_gates`` (K2) comes with the LSTM slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops import _kernels
from deeplearning4j_tpu_torch.ops.activations import activation as _activation
from deeplearning4j_tpu_torch.ops.activations import derivative as _derivative

# restricted to activations whose derivative is expressible from the OUTPUT
# (needed by the backward); functions come from the shared registry
_FUSABLE = ("linear", "relu", "tanh", "sigmoid")
_ACTS = {name: _activation(name) for name in _FUSABLE}
# the kernel's activation codes (csrc/fused_dense.cu)
_ACT_CODES = {name: i for i, name in enumerate(_FUSABLE)}
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_INT_MAX = 2**31 - 1

# Fused-dense gating: None = the default (on). The JAX default is
# ``jax.device_count() == 1`` because pallas_call cannot be partitioned by
# GSPMD under a tensor-parallel mesh; a torch process drives one device, so
# the port's default is True. ``set_fused_dense(True/False)`` overrides, as
# in JAX (False sends dense layers through the plain pre_output +
# activation route).
_fused_dense_override: Optional[bool] = None


def set_fused_dense(enabled: Optional[bool]) -> None:
    global _fused_dense_override
    _fused_dense_override = enabled


def use_fused_dense() -> bool:
    if _fused_dense_override is not None:
        return _fused_dense_override
    return True


def _check_activation(act: str) -> None:
    if act not in _ACTS:
        raise ValueError(f"unsupported activation {act!r}; "
                         f"options: {sorted(_ACTS)}")


def fused_dense_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          activation: str = "linear") -> torch.Tensor:
    """Plain torch version of K1: ``act(x @ w + b)`` computed in f32 (f64
    for f64 inputs) and rounded once to x's dtype."""
    _check_activation(activation)
    acc = torch.promote_types(x.dtype, torch.float32)
    y = x.to(acc) @ w.to(acc) + b.to(acc)
    return _ACTS[activation](y).to(x.dtype)


def _check_kernel_inputs(x, w, b) -> None:
    """What K1 takes: x (M, K), w (K, N), b (N,), one dtype (f32 or bf16),
    one CUDA device, contiguous, every dimension below 2**31."""
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError(f"fused_dense takes x (M, K), w (K, N), b (N,); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    m, k = x.shape
    if w.shape[0] != k or b.shape[0] != w.shape[1]:
        raise ValueError(f"fused_dense shapes disagree: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    if max(m, k, w.shape[1]) > _INT_MAX:
        raise ValueError("fused_dense dimensions must be below 2**31")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"fused_dense kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    for name, t in (("w", w), ("b", b)):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"x, w, b must share dtype and device; got x "
                             f"{x.dtype}/{x.device} and {name} "
                             f"{t.dtype}/{t.device}")
    named = (("x", x), ("w", w), ("b", b))
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous; pass .contiguous()")
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}; the kernel takes "
                             "CUDA tensors")


def fused_dense_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    activation: str = "linear") -> torch.Tensor:
    """``act(x @ w + b)``, output in x's dtype, no graph.

    On a CUDA tensor: launches ``csrc/fused_dense.cu`` on the current
    stream (or raises). On a CPU tensor: ``fused_dense_reference``."""
    _check_activation(activation)
    if x.device.type == "cpu":
        return fused_dense_reference(x, w, b, activation)
    _check_kernel_inputs(x, w, b)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _kernels.load("fused_dense")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.dl4j_fused_dense(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                              out.data_ptr(), m, k, n,
                              _ACT_CODES[activation],
                              int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"fused_dense launch failed: CUDA error {rc} at "
                           f"x {tuple(x.shape)} w {tuple(w.shape)}, "
                           f"{x.dtype}")
    _kernels.count_launch("fused_dense")
    return out


class FusedDense(torch.autograd.Function):
    """``act(x @ w + b)`` forward through ``fused_dense_fwd`` (K1 on the
    card); backward from the saved output, as ``_fused_dense_bwd``. The
    same wiring runs on both devices; on CPU tensors the forward is the
    plain version."""

    @staticmethod
    def forward(ctx, x, w, b, activation):
        out = fused_dense_fwd(x, w, b, activation)
        ctx.save_for_backward(x, w, out)
        ctx.activation = activation
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        d = g * _derivative(ctx.activation, out)
        dx = d @ w.T if ctx.needs_input_grad[0] else None
        dw = x.T @ d if ctx.needs_input_grad[1] else None
        db = d.sum(0) if ctx.needs_input_grad[2] else None
        return dx, dw, db, None


def fused_dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                activation: str = "linear") -> torch.Tensor:
    """act(x @ w + b) with the epilogue fused into the kernel's tile;
    differentiable in x, w and b."""
    return FusedDense.apply(x.contiguous(), w.contiguous(), b.contiguous(),
                            activation)
