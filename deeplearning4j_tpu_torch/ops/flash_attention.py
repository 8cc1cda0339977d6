"""Counterpart of ``deeplearning4j_tpu/ops/flash_attention.py``: the
attention-core selection chain and the flash-attention forward.

Three cores behind one dispatcher (``attention_core``), chosen by the same
precedence chain as the JAX package (highest wins):

  1. a per-call ``impl=`` argument (the transformer LM's ``attn_impl=``),
  2. ``set_attention_impl(...)``, the process-wide override,
  3. the ``DL4J_TPU_ATTN_IMPL`` environment variable (dense|blockwise|flash),
  4. auto: "blockwise" for T >= 1024 with ``T % min(512, T) == 0``, else
     "dense".

On a CUDA tensor both "flash" and "blockwise" launch the hand-written
Hopper kernel (``csrc/flash_attention_fwd.cu``) through
``flash_attention_fwd``: in the JAX package the two were the same function
split only by how the TPU scheduled them. "dense" stays plain torch
(``parallel.ring_attention.reference_attention``).

``flash_attention_reference`` is the kernel's plain version: the same
online-softmax math with a single block spanning every key. The wrapper
uses it only for a tensor on the CPU; on a CUDA tensor it launches the
kernel or raises.
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


def resolve_attention_impl(t: Optional[int] = None) -> Optional[str]:
    """Collapse the precedence chain to the impl that will run: override >
    env var > (given a sequence length) the auto shape gate. Returns None
    only when no override is set AND no ``t`` was supplied."""
    impl = get_attention_impl()
    if impl is None and t is not None:
        if t >= _BLOCKWISE_MIN_T and t % min(_DEFAULT_BLOCK, t) == 0:
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
    guarded by max(l, 1e-30). ``o`` has q's dtype, ``lse`` is f32 (B,H,T)."""
    d = q.shape[-1]
    scale = 1.0 / (d ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        t = q.shape[2]
        pos = torch.arange(t, device=q.device)
        s = s.masked_fill(pos[:, None] < pos[None, :], _NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp_min(p.sum(-1), 1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return (o / l[..., None]).to(q.dtype), m + torch.log(l)


def _check_kernel_inputs(q, k, v) -> None:
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
        if not x.is_cuda:
            raise ValueError(f"{name} is on {x.device}; the kernel takes "
                             "CUDA tensors")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous; pass .contiguous() "
                             "(the head split returns a transposed view)")


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


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False,
                   impl: Optional[str] = None) -> torch.Tensor:
    """The attention core over (B, H, T, Dh). ``impl`` forces a core for
    THIS call; otherwise the set_attention_impl/env/auto chain decides.
    Every core computes the same function (tests/test_torch_flash_attention.py
    holds them against the JAX package)."""
    if impl is not None and impl not in _IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; "
                         "options: " + ", ".join(_IMPLS))
    impl = impl or resolve_attention_impl(q.shape[2])
    if impl in ("flash", "blockwise"):
        o, _ = flash_attention_fwd(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal)
        return o
    return dense_attention(q, k, v, causal)
