"""Counterpart of ``deeplearning4j_tpu/ops/flash_attention.py``: the
attention-core selection chain, the flash-attention forward and its
backward.

Three cores behind one dispatcher (``attention_core``), chosen by the same
precedence chain as the JAX package (highest wins):

  1. a per-call ``impl=`` argument (the transformer LM's ``attn_impl=``),
  2. ``set_attention_impl(...)``, the process-wide override,
  3. the ``DL4J_TPU_ATTN_IMPL`` environment variable (dense|blockwise|flash),
  4. auto: "blockwise" for T >= 1024 with ``T % min(512, T) == 0``, else
     "dense"; and "dense" for a head dim or dtype the kernels refuse
     (``kernel_takes``), where the JAX package's lax "blockwise" runs.

"flash" and "blockwise" both go through ``FlashAttention``, a
``torch.autograd.Function`` over three hand-written Hopper kernels: the
forward ``csrc/flash_attention_fwd.cu`` (``flash_attention_fwd``) and the
backward pair ``csrc/flash_attention_bwd_dkv.cu`` (dK, dV) and
``csrc/flash_attention_bwd_dq.cu`` (dQ). In the JAX package the two impls
were the same function split only by how the TPU scheduled them. "dense"
stays plain torch (``parallel.ring_attention.reference_attention``) and is
differentiated by autograd.

``flash_attention_reference`` and ``flash_attention_bwd_reference`` are the
kernels' plain versions: the same math with a single block spanning every
key. A wrapper uses its plain version only for a tensor on the CPU; on a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops import _kernels
from deeplearning4j_tpu_torch.parallel.ring_attention import (
    reference_attention,
)

_NEG_INF = -1e30

# dispatcher override: None = auto; "flash" | "blockwise" | "dense" force one
_impl_override: Optional[str] = None

ATTN_IMPL_ENV = "DL4J_TPU_ATTN_IMPL"

_IMPLS = ("flash", "blockwise", "dense")

# dense path below this length: at small T the (T,T) buffer is cheap
_BLOCKWISE_MIN_T = 1024
_DEFAULT_BLOCK = 512

# what the kernel takes: its element types and head widths
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_MAX_HEAD_DIM = 128


def set_attention_impl(impl: Optional[str]) -> None:
    """Force the attention core: "flash" or "blockwise" (the CUDA kernel),
    "dense" (materializing reference), or None for auto."""
    if impl not in (None,) + _IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; "
                         "options: flash, blockwise, dense, None")
    global _impl_override
    _impl_override = impl


def get_attention_impl() -> Optional[str]:
    """The effective global override: set_attention_impl's value, else the
    ``DL4J_TPU_ATTN_IMPL`` environment variable, else None (auto)."""
    if _impl_override is not None:
        return _impl_override
    env = os.environ.get(ATTN_IMPL_ENV)
    if env:
        if env not in _IMPLS:
            raise ValueError(
                f"{ATTN_IMPL_ENV}={env!r}; options: " + ", ".join(_IMPLS))
        return env
    return None


def kernel_takes(head_dim: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None) -> bool:
    """Whether the flash kernels take this head dim and element type (a
    multiple of 8 up to 128; f32 or bf16). None stands for any."""
    return ((head_dim is None
             or (head_dim % 8 == 0 and 8 <= head_dim <= _MAX_HEAD_DIM))
            and (dtype is None or dtype in _KERNEL_DTYPES))


def resolve_attention_impl(t: Optional[int] = None,
                           head_dim: Optional[int] = None,
                           dtype: Optional[torch.dtype] = None
                           ) -> Optional[str]:
    """Collapse the precedence chain to the impl that will run: override >
    env var > (given a sequence length) the auto shape gate. Returns None
    only when no override is set AND no ``t`` was supplied. Given the head
    dim or dtype too, auto takes "dense" where the kernels refuse them; an
    override is returned as it is (the kernels then raise, naming the
    limit). With ``t`` alone it is the JAX package's chain."""
    impl = get_attention_impl()
    if impl is None and t is not None:
        if (t >= _BLOCKWISE_MIN_T and t % min(_DEFAULT_BLOCK, t) == 0
                and kernel_takes(head_dim, dtype)):
            impl = "blockwise"
        else:
            impl = "dense"
    return impl


def default_block_policy(t: int) -> int:
    """The JAX package's blockwise tile for sequence length ``t``: the
    largest tile <= 512 that divides ``t``, else ``t`` itself. The CUDA
    kernel tiles by 64 rows whatever ``t`` is; the policy is kept for the
    tuner's block space in a later slice."""
    blk = min(_DEFAULT_BLOCK, t)
    return blk if t % blk == 0 else t


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Materializing reference (the math of
    parallel.ring_attention.reference_attention)."""
    return reference_attention(q, k, v, causal=causal)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel: (o, lse) over (B, H, T, Dh).

    One online-softmax step over a block holding every key: f32 scores,
    -1e30 mask, P rounded to V's dtype before the PV product, the row sum
    guarded by max(l, 1e-30). ``o`` has q's dtype, ``lse`` is f32 (B,H,T).
    A float64 input computes in float64 (gradcheck's precision)."""
    acc = _acc_dtype(q.dtype)
    s = _scores(q, k, causal)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp_min(p.sum(-1), 1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).to(acc), v.to(acc))
    return (o / l[..., None]).to(q.dtype), m + torch.log(l)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulation type: f32 for f32 and bf16 inputs, f64 for f64."""
    return torch.promote_types(dtype, torch.float32)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """q·kᵀ/√Dh in the accumulation type, masked to -1e30 above the
    diagonal when ``causal``."""
    acc = _acc_dtype(q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * (
        1.0 / (q.shape[-1] ** 0.5))
    if causal:
        pos = torch.arange(q.shape[2], device=q.device)
        s = s.masked_fill(pos[:, None] < pos[None, :], _NEG_INF)
    return s


def _bwd_p_ds(q, k, v, lse, do, delta, causal):
    """The backward's recomputed P = exp(s - lse) and dS = P·(dP - delta),
    dP = do·vᵀ, all in the accumulation type (``_blockwise_vjp_bwd``'s
    ``p_block`` and ``ds``)."""
    acc = _acc_dtype(q.dtype)
    p = torch.exp(_scores(q, k, causal) - lse[..., None].to(acc))
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(acc), v.to(acc))
    return p, p * (dp - delta[..., None].to(acc))


def _bwd_dkv_plain(q, k, v, lse, do, delta, causal):
    acc = _acc_dtype(q.dtype)
    p, ds = _bwd_p_ds(q, k, v, lse, do, delta, causal)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.to(acc))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(acc)) * (
        1.0 / (q.shape[-1] ** 0.5))
    return dk.to(k.dtype), dv.to(v.dtype)


def _bwd_dq_plain(q, k, v, lse, do, delta, causal):
    acc = _acc_dtype(q.dtype)
    _, ds = _bwd_p_ds(q, k, v, lse, do, delta, causal)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.to(acc)) * (
        1.0 / (q.shape[-1] ** 0.5))
    return dq.to(q.dtype)


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do·o) over (B, H, T) in the accumulation type: the
    dL/d(softmax normalizer) term, computed outside the kernels as the JAX
    VJP and the library's backward compute ``di``."""
    acc = _acc_dtype(o.dtype)
    return (do.to(acc) * o.to(acc)).sum(-1)


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor,
                                  causal: bool = False) -> Tuple[
                                      torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Plain torch version of the backward kernels: (dq, dk, dv) of
    ``o = softmax(q·kᵀ/√Dh)·v`` for the upstream gradient ``do``, from the
    forward's ``o`` and ``lse``. ``_blockwise_vjp_bwd`` with one block
    spanning every key: delta = rowsum(do·o), P = exp(s - lse) under the
    -1e30 mask, dv = Pᵀ·do, dS = P·(do·vᵀ - delta), dq = dS·k/√Dh,
    dk = dSᵀ·q/√Dh, every product in f32 on upcast inputs; the results
    come back in q/k/v's dtype."""
    delta = attention_delta(o, do)
    dk, dv = _bwd_dkv_plain(q, k, v, lse, do, delta, causal)
    return _bwd_dq_plain(q, k, v, lse, do, delta, causal), dk, dv


def _check_kernel_inputs(q, k, v, **more) -> None:
    """What the kernels take: q, k, v of one shape, dtype and device, f32 or
    bf16, with a head dim that is a multiple of 8 up to 128; ``more``
    (the backward's ``do``, ``lse``, ``delta``) checked by
    ``_check_bwd_values``. Shapes and types first, then contiguity and the
    device of every tensor."""
    if q.dim() != 4:
        raise ValueError(f"expected (B, H, T, Dh) tensors, got {q.dim()}-D")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash kernel takes float32 or bfloat16, "
                         f"got {q.dtype}")
    d = q.shape[-1]
    if d % 8 or not 8 <= d <= _MAX_HEAD_DIM:
        raise ValueError(f"flash kernel takes a head dim that is a multiple "
                         f"of 8 up to {_MAX_HEAD_DIM}, got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != q.dtype or x.shape != q.shape or x.device != q.device:
            raise ValueError("q, k, v must share shape, dtype and device; "
                             f"got {tuple(q.shape)}/{q.dtype}/{q.device} "
                             f"and {name} {tuple(x.shape)}/{x.dtype}/"
                             f"{x.device}")
    if more:
        _check_bwd_values(q, **more)
    named = (("q", q), ("k", k), ("v", v), *more.items())
    for name, x in named:
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous; pass .contiguous() "
                             "(the head split returns a transposed view)")
    for name, x in named:
        if not x.is_cuda:
            raise ValueError(f"{name} is on {x.device}; the kernel takes "
                             "CUDA tensors")


def _check_bwd_values(q, do, lse, delta) -> None:
    """``do`` like q; ``lse`` and ``delta`` f32 (B, H, T) on q's device."""
    if do.dtype != q.dtype or do.shape != q.shape or do.device != q.device:
        raise ValueError(f"do must share q's shape, dtype and device; got "
                         f"{tuple(do.shape)}/{do.dtype}/{do.device}")
    want = tuple(q.shape[:3])
    for name, x in (("lse", lse), ("delta", delta)):
        if (x.dtype != torch.float32 or tuple(x.shape) != want
                or x.device != q.device):
            raise ValueError(f"{name} must be float32 {want} on {q.device}, "
                             f"got {tuple(x.shape)}/{x.dtype}/{x.device}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(q·kᵀ/√Dh)·v and its logsumexp over (B, H, T, Dh).

    On a CUDA tensor: launches ``csrc/flash_attention_fwd.cu`` on the
    current stream (or raises); q, k, v must be contiguous. On a CPU
    tensor: ``flash_attention_reference``."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal)
    _check_kernel_inputs(q, k, v)
    b, h, t, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    lib = _kernels.load("flash_attention_fwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.dl4j_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b * h, t, d, int(bool(causal)), 1.0 / (d ** 0.5),
        int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{rc} at shape {tuple(q.shape)}, {q.dtype}")
    _kernels.count_launch("flash_attention_fwd")
    return o, lse


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lse: torch.Tensor,
                            do: torch.Tensor, delta: torch.Tensor,
                            causal: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of the attention over (B, H, T, Dh), from the forward's
    ``lse`` and ``delta = rowsum(do·o)`` (both f32 (B, H, T)).

    On a CUDA tensor: launches ``csrc/flash_attention_bwd_dkv.cu`` on the
    current stream (or raises). On a CPU tensor: the plain version's dk and
    dv."""
    if q.device.type == "cpu":
        return _bwd_dkv_plain(q, k, v, lse, do, delta, causal)
    _check_kernel_inputs(q, k, v, do=do, lse=lse, delta=delta)
    b, h, t, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _kernels.load("flash_attention_bwd_dkv")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.dl4j_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
        do.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b * h, t, d, int(bool(causal)), 1.0 / (d ** 0.5),
        int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_dkv launch failed: CUDA "
                           f"error {rc} at shape {tuple(q.shape)}, {q.dtype}")
    _kernels.count_launch("flash_attention_bwd_dkv")
    return dk, dv


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lse: torch.Tensor,
                           do: torch.Tensor, delta: torch.Tensor,
                           causal: bool = False) -> torch.Tensor:
    """dq of the attention over (B, H, T, Dh), from the forward's ``lse``
    and ``delta = rowsum(do·o)`` (both f32 (B, H, T)).

    On a CUDA tensor: launches ``csrc/flash_attention_bwd_dq.cu`` on the
    current stream (or raises). On a CPU tensor: the plain version's dq."""
    if q.device.type == "cpu":
        return _bwd_dq_plain(q, k, v, lse, do, delta, causal)
    _check_kernel_inputs(q, k, v, do=do, lse=lse, delta=delta)
    b, h, t, d = q.shape
    dq = torch.empty_like(q)
    lib = _kernels.load("flash_attention_bwd_dq")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.dl4j_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
        do.data_ptr(), delta.data_ptr(), dq.data_ptr(), b * h, t, d,
        int(bool(causal)), 1.0 / (d ** 0.5), int(q.dtype == torch.bfloat16),
        stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_dq launch failed: CUDA "
                           f"error {rc} at shape {tuple(q.shape)}, {q.dtype}")
    _kernels.count_launch("flash_attention_bwd_dq")
    return dq


class FlashAttention(torch.autograd.Function):
    """``o = softmax(q·kᵀ/√Dh)·v`` over contiguous (B, H, T, Dh) with the
    flash kernels on both passes: the forward saves (q, k, v, o, lse); the
    backward computes ``delta`` with one torch reduction and calls the dK/dV
    and dQ wrappers. The same wiring runs on both devices; on CPU tensors
    the wrappers compute the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = attention_delta(o, do)
        dk, dv = flash_attention_bwd_dkv(q, k, v, lse, do, delta, ctx.causal)
        dq = flash_attention_bwd_dq(q, k, v, lse, do, delta, ctx.causal)
        return dq, dk, dv, None


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False,
                   impl: Optional[str] = None) -> torch.Tensor:
    """The attention core over (B, H, T, Dh). ``impl`` forces a core for
    THIS call; otherwise the set_attention_impl/env/auto chain decides, by
    T, head dim and dtype.
    Every core computes the same function (tests/test_torch_flash_attention.py
    holds them against the JAX package)."""
    if impl is not None and impl not in _IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; "
                         "options: " + ", ".join(_IMPLS))
    impl = impl or resolve_attention_impl(q.shape[2], q.shape[-1], q.dtype)
    if impl in ("flash", "blockwise"):
        return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal)
    return dense_attention(q, k, v, causal)
