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

- ``lstm_gates``: the LSTM cell's nonlinearity, ``csrc/lstm_gates.cu``
  (K2): from the (B, 4H) preactivations in gate order i, f, o, g and
  c_prev (B, H), ``c_new = σ(f)·c_prev + σ(i)·tanh(g)`` and
  ``h_new = σ(o)·tanh(c_new)`` in f32, each rounded once to c_prev's
  dtype. Differentiable through ``LSTMGates``, whose backward is
  ``csrc/lstm_gates_bwd.cu`` (K2b): the JAX package's lax backward
  (``_lstm_gates_bwd``, which XLA fuses and no Pallas kernel carries) as
  one hand-written kernel, ``(d_ifog, dc_prev)`` from ifog, c_prev, c_new
  and the grads of c_new and h_new, with the gates recomputed.

``lstm_gates_reference`` is K2's plain version, computed as the TPU
kernel computes it (f32, one rounding; not the JAX package's
``_lstm_gates_ref``, which rounds at every op at bf16), and
``lstm_gates_bwd_reference`` K2b's (f32, one rounding: what XLA's fusion
of ``_lstm_gates_bwd`` computes). ``lstm_gates_fwd`` and
``lstm_gates_bwd`` use them only for a tensor on the CPU; on a CUDA
tensor they launch K2 and K2b or raise. ``set_lstm_gates(False)`` sends
both halves of the cell through the plain versions, on either device.
The TPU kernel's shape gate (h % 128, B % 8, h <= 2048) is a TPU layout
rule: K2 and K2b take every shape.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch._capture import priced
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


def _dense_cost(x, w, b, activation="linear"):
    return _kernels.fused_dense_cost(x.shape[0], x.shape[1], w.shape[1],
                                     activation, x.element_size())


@priced("fused_dense", _dense_cost)
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


# ------------------------------------------------------------- lstm gates ----

# The A/B switch for K2 and K2b: None = the default (on). The JAX default
# is "on where the shape passes the TPU gate"; K2 takes every shape, so the
# port's default is the JAX default minus the gate. ``set_lstm_gates(False)``
# sends the cell through the plain gate math (``lstm_gates_reference`` and
# ``lstm_gates_bwd_reference``), as the JAX bench's
# ``lstm_wide_bf16_nokernels`` stage does.
_lstm_gates_override: Optional[bool] = None


def set_lstm_gates(enabled: Optional[bool]) -> None:
    global _lstm_gates_override
    _lstm_gates_override = enabled


def use_lstm_gates() -> bool:
    if _lstm_gates_override is not None:
        return _lstm_gates_override
    return True


def _gates(ifog: torch.Tensor, h: int):
    """σ(i), σ(f), σ(o), tanh(g) of the (B, 4H) preactivations, in their
    dtype."""
    return (torch.sigmoid(ifog[:, 0 * h:1 * h]),
            torch.sigmoid(ifog[:, 1 * h:2 * h]),
            torch.sigmoid(ifog[:, 2 * h:3 * h]),
            torch.tanh(ifog[:, 3 * h:4 * h]))


def lstm_gates_reference(ifog: torch.Tensor, c_prev: torch.Tensor):
    """Plain torch version of K2: (c_new, h_new), computed in f32 (f64 for
    f64 inputs) from ifog and c_prev upcast, both rounded once to c_prev's
    dtype, as the TPU kernel computes them."""
    acc = torch.promote_types(torch.promote_types(ifog.dtype, c_prev.dtype),
                              torch.float32)
    i, f, o, gg = _gates(ifog.to(acc), c_prev.shape[-1])
    c_new = f * c_prev.to(acc) + i * gg
    h_new = o * torch.tanh(c_new)
    return c_new.to(c_prev.dtype), h_new.to(c_prev.dtype)


def _check_lstm_layout(ifog: torch.Tensor, c_prev: torch.Tensor) -> None:
    """What K2 and K2b take of ifog and c_prev: (B, 4H) and (B, H), each
    float32 or bfloat16, contiguous."""
    if ifog.dim() != 2 or c_prev.dim() != 2:
        raise ValueError(f"lstm_gates takes ifog (B, 4H) and c_prev (B, H); "
                         f"got {tuple(ifog.shape)}, {tuple(c_prev.shape)}")
    b, h = c_prev.shape
    if tuple(ifog.shape) != (b, 4 * h):
        raise ValueError(f"lstm_gates shapes disagree: ifog "
                         f"{tuple(ifog.shape)}, c_prev {tuple(c_prev.shape)}"
                         f" (ifog must be (B, 4H))")
    for name, t in (("ifog", ifog), ("c_prev", c_prev)):
        if t.dtype not in _KERNEL_DTYPES:
            raise ValueError(f"lstm_gates kernel takes float32 or bfloat16, "
                             f"got {name} {t.dtype}")
    for name, t in (("ifog", ifog), ("c_prev", c_prev)):
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous; pass .contiguous()")


def _check_cuda(named) -> None:
    """Every (name, tensor) of ``named`` (None skipped) on one CUDA
    device."""
    named = [(name, t) for name, t in named if t is not None]
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}; the kernel takes "
                             "CUDA tensors")
    (first, t0), *rest = named
    for name, t in rest:
        if t.device != t0.device:
            raise ValueError(f"{first} and {name} must share a device; got "
                             f"{t0.device} and {t.device}")


def _check_lstm_inputs(ifog: torch.Tensor, c_prev: torch.Tensor) -> None:
    """What K2 takes: ifog (B, 4H) and c_prev (B, H), each float32 or
    bfloat16, on one CUDA device, contiguous."""
    _check_lstm_layout(ifog, c_prev)
    _check_cuda((("ifog", ifog), ("c_prev", c_prev)))


def _cell_cost(ifog, c_prev):
    return _kernels.lstm_gates_cost(c_prev.shape[0], c_prev.shape[1],
                                    ifog.element_size(),
                                    c_prev.element_size())


@priced("lstm_gates", _cell_cost)
def lstm_gates_fwd(ifog: torch.Tensor, c_prev: torch.Tensor):
    """(c_new, h_new) in c_prev's dtype, no graph.

    On a CUDA tensor: launches ``csrc/lstm_gates.cu`` on the current
    stream (or raises). On a CPU tensor: ``lstm_gates_reference``."""
    if ifog.device.type == "cpu":
        return lstm_gates_reference(ifog, c_prev)
    _check_lstm_inputs(ifog, c_prev)
    b, h = c_prev.shape
    c_new = torch.empty_like(c_prev)
    h_new = torch.empty_like(c_prev)
    if c_new.numel() == 0:
        return c_new, h_new
    lib = _kernels.load("lstm_gates")
    stream = torch.cuda.current_stream(ifog.device).cuda_stream
    rc = lib.dl4j_lstm_gates(ifog.data_ptr(), c_prev.data_ptr(),
                             c_new.data_ptr(), h_new.data_ptr(), b, h,
                             int(ifog.dtype == torch.bfloat16),
                             int(c_prev.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"lstm_gates launch failed: CUDA error {rc} at "
                           f"ifog {tuple(ifog.shape)} {ifog.dtype}, c_prev "
                           f"{c_prev.dtype}")
    _kernels.count_launch("lstm_gates")
    return c_new, h_new


def lstm_gates_bwd_reference(ifog: torch.Tensor, c_prev: torch.Tensor,
                             c_new: torch.Tensor,
                             dc_new: Optional[torch.Tensor],
                             dh: Optional[torch.Tensor]):
    """Plain torch version of K2b, the JAX package's ``_lstm_gates_bwd``:
    (d_ifog, dc_prev) from the cell's inputs, c_new and the grads of c_new
    and h_new (None reads as zero), computed in f32 (f64 for f64 inputs)
    from upcast inputs with the gates and ``tanh(c_new)`` recomputed, and
    rounded once to ifog's and c_prev's dtypes. At f32 it is the lax
    backward op for op; at bf16 it is what XLA's fusion of it computes,
    not the per-op rounding of eager JAX."""
    acc = torch.promote_types(torch.promote_types(ifog.dtype, c_prev.dtype),
                              torch.float32)
    i, f, o, gg = _gates(ifog.to(acc), c_prev.shape[-1])
    tanh_c = torch.tanh(c_new.to(acc))
    if dh is None:
        dh = torch.zeros_like(tanh_c)
    dh = dh.to(acc)
    do = dh * tanh_c
    dc = dh * o * (1.0 - tanh_c * tanh_c)
    if dc_new is not None:
        dc = dc_new.to(acc) + dc
    di = dc * gg
    df = dc * c_prev.to(acc)
    dgg = dc * i
    dc_prev = dc * f
    d_ifog = torch.cat([di * i * (1.0 - i),
                        df * f * (1.0 - f),
                        do * o * (1.0 - o),
                        dgg * (1.0 - gg * gg)], dim=-1)
    return d_ifog.to(ifog.dtype), dc_prev.to(c_prev.dtype)


def _row_stride(name: str, t: Optional[torch.Tensor], b: int, h: int) -> int:
    """The row stride K2b reads an incoming grad with: (B, H) in c's dtype,
    each row contiguous (a row view of a wider tensor is read in place);
    0 for None (read as zero)."""
    if t is None:
        return 0
    if tuple(t.shape) != (b, h):
        raise ValueError(f"lstm_gates_bwd: {name} is {tuple(t.shape)}, "
                         f"expected {(b, h)}")
    if h > 1 and t.stride(1) != 1:
        raise ValueError(f"lstm_gates_bwd: {name} rows are not contiguous "
                         f"(strides {t.stride()}); pass .contiguous()")
    return t.stride(0)


def _check_lstm_bwd_inputs(ifog, c_prev, c_new, dc_new, dh):
    """What K2b takes: K2's ifog and c_prev, c_new like c_prev, and dc_new
    and dh (B, H) in c's dtype with contiguous rows or None, on one CUDA
    device. Returns their row strides."""
    _check_lstm_layout(ifog, c_prev)
    b, h = c_prev.shape
    named = (("c_new", c_new), ("dc_new", dc_new), ("dh", dh))
    for name, t in named:
        if t is not None and t.dtype != c_prev.dtype:
            raise ValueError(f"lstm_gates_bwd: {name} is {t.dtype}, expected "
                             f"c_prev's {c_prev.dtype}")
    if tuple(c_new.shape) != (b, h):
        raise ValueError(f"lstm_gates_bwd: c_new is {tuple(c_new.shape)}, "
                         f"expected {(b, h)}")
    if not c_new.is_contiguous():
        raise ValueError("c_new is not contiguous; pass .contiguous()")
    strides = (_row_stride("dc_new", dc_new, b, h),
               _row_stride("dh", dh, b, h))
    _check_cuda((("ifog", ifog), ("c_prev", c_prev)) + named)
    return strides


def _cell_bwd_cost(ifog, c_prev, c_new, dc_new, dh):
    return _kernels.lstm_gates_bwd_cost(
        c_prev.shape[0], c_prev.shape[1], ifog.element_size(),
        c_prev.element_size(), dc_new is not None, dh is not None)


@priced("lstm_gates_bwd", _cell_bwd_cost)
def lstm_gates_bwd(ifog: torch.Tensor, c_prev: torch.Tensor,
                   c_new: torch.Tensor, dc_new: Optional[torch.Tensor],
                   dh: Optional[torch.Tensor]):
    """(d_ifog, dc_prev) of the LSTM cell, in ifog's and c_prev's dtypes;
    dc_new or dh may be None (zero).

    On a CUDA tensor: launches ``csrc/lstm_gates_bwd.cu`` (K2b) on the
    current stream (or raises). On a CPU tensor:
    ``lstm_gates_bwd_reference``."""
    if ifog.device.type == "cpu":
        return lstm_gates_bwd_reference(ifog, c_prev, c_new, dc_new, dh)
    dc_stride, dh_stride = _check_lstm_bwd_inputs(ifog, c_prev, c_new,
                                                  dc_new, dh)
    b, h = c_prev.shape
    d_ifog = torch.empty_like(ifog)
    dc_prev = torch.empty_like(c_prev)
    if dc_prev.numel() == 0:
        return d_ifog, dc_prev
    lib = _kernels.load("lstm_gates_bwd")
    stream = torch.cuda.current_stream(ifog.device).cuda_stream
    rc = lib.dl4j_lstm_gates_bwd(
        ifog.data_ptr(), c_prev.data_ptr(), c_new.data_ptr(),
        None if dc_new is None else dc_new.data_ptr(), dc_stride,
        None if dh is None else dh.data_ptr(), dh_stride, d_ifog.data_ptr(),
        dc_prev.data_ptr(), b, h, int(ifog.dtype == torch.bfloat16),
        int(c_prev.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"lstm_gates_bwd launch failed: CUDA error {rc} at "
                           f"ifog {tuple(ifog.shape)} {ifog.dtype}, c_prev "
                           f"{c_prev.dtype}")
    _kernels.count_launch("lstm_gates_bwd")
    return d_ifog, dc_prev


def _rows_contiguous(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A grad as K2b reads it: as it is when its rows are contiguous (row
    views of the (B, T, H) grad of ``torch.stack`` are), else a copy."""
    if t is None or t.shape[1] <= 1 or t.stride(1) == 1:
        return t
    return t.contiguous()


class LSTMGates(torch.autograd.Function):
    """The LSTM cell: forward through ``lstm_gates_fwd`` (K2 on the card),
    backward through ``lstm_gates_bwd`` (K2b on the card), or, with
    ``set_lstm_gates(False)``, both halves through their plain versions on
    either device. Grads are not materialized: an unused output's grad
    reaches the backward as None and K2b reads it as zero, so autograd
    launches no zero-fill for the last timestep's dc_new."""

    @staticmethod
    def forward(ctx, ifog, c_prev):
        ctx.set_materialize_grads(False)
        ctx.kernels = use_lstm_gates()
        fwd = lstm_gates_fwd if ctx.kernels else lstm_gates_reference
        c_new, h_new = fwd(ifog, c_prev)
        ctx.save_for_backward(ifog, c_prev, c_new)
        return c_new, h_new

    @staticmethod
    def backward(ctx, dc_new, dh):
        if dc_new is None and dh is None:
            return None, None
        ifog, c_prev, c_new = ctx.saved_tensors
        if ctx.kernels:
            return lstm_gates_bwd(ifog, c_prev, c_new,
                                  _rows_contiguous(dc_new),
                                  _rows_contiguous(dh))
        return lstm_gates_bwd_reference(ifog, c_prev, c_new, dc_new, dh)


def lstm_gates(ifog: torch.Tensor, c_prev: torch.Tensor):
    """Fused LSTM cell nonlinearity: (c_new, h_new) from (B, 4H) + (B, H);
    differentiable in both."""
    return LSTMGates.apply(ifog.contiguous(), c_prev.contiguous())
