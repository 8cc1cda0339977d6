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
     (``kernel_takes``: above 256, or not f32/bf16), where the JAX
     package's lax "blockwise" runs.

"flash" and "blockwise" both go through ``FlashAttention``, a
``torch.autograd.Function`` over three hand-written Hopper kernels: the
forward ``csrc/flash_attention_fwd.cu`` (``flash_attention_fwd``) and the
backward pair ``csrc/flash_attention_bwd_dkv.cu`` (dK, dV) and
``csrc/flash_attention_bwd_dq.cu`` (dQ), each for head dims up to 128, and
their wide twins (``*_wide.cu``) for head dims above 128 up to 256. In the
JAX package the two impls were the same function split only by how the TPU
scheduled them. "dense" stays plain torch
(``parallel.ring_attention.reference_attention``) and is differentiated by
autograd.

The blockwise core's tiles (``block_q``/``block_k``, the autotuner's
``flash_attention`` knobs) map to the one tile size of the kernels that
is chosen at run time, K3f's key split (``key_split_for``).

``flash_attention_reference`` and ``flash_attention_bwd_reference`` are the
kernels' plain versions: the same math with a single block spanning every
key. A wrapper uses its plain version only for a tensor on the CPU; on a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch._capture import priced
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

# what the kernels take: their element types and head widths; head dims
# above _NARROW_HEAD_DIM run the wide twins (``*_wide.cu``)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_MAX_HEAD_DIM = 256
_NARROW_HEAD_DIM = 128


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
    multiple of 8 up to 256; f32 or bf16). None stands for any."""
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
    largest tile <= 512 that divides ``t``, else ``t`` itself: the
    autotuner's default ``flash_attention`` config (``tune/seams.py``)."""
    blk = min(_DEFAULT_BLOCK, t)
    return blk if t % blk == 0 else t


# the flash_attention search space's smallest key tile (tune/space.py)
_SMALLEST_BLOCK_K = 64


def key_split_for(block_q: Optional[int] = None,
                  block_k: Optional[int] = None) -> int:
    """K3f's key split for the blockwise tiles: 0 (the kernel's own rule)
    when ``block_k`` is None, 1 (4 warps a block, each warp walking every
    key of its 16 rows) at the space's smallest key tile, 64, and 2 (8
    warps, the two of each 16 rows taking the halves of every K/V tile)
    for a larger one. ``block_q`` selects nothing: K3f's query tile is 64
    rows (4 row warps) and the backward pair's tiles are constants of
    ``csrc/flash_tiles.cuh``. Every split computes the same function in
    another order of its sums."""
    if block_k is None:
        return 0
    return 1 if int(block_k) <= _SMALLEST_BLOCK_K else 2


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Materializing reference (the math of
    parallel.ring_attention.reference_attention)."""
    return reference_attention(q, k, v, causal=causal)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              shift: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel: (o, lse) of q (B, H, Tq, Dh)
    against k, v (B, H, Tk, Dh).

    One online-softmax step over a block holding every key: f32 scores,
    -1e30 mask (under ``causal``, key j is seen by row i iff j <= i +
    ``shift``), P rounded to V's dtype before the PV product, the row sum
    guarded by max(l, 1e-30). ``o`` has q's dtype, ``lse`` is f32
    (B, H, Tq). A row that sees no key (``shift`` < 0) comes out as the
    kernel's (o = 0, lse = -1e30). A float64 input computes in float64
    (gradcheck's precision)."""
    acc = _acc_dtype(q.dtype)
    s = _scores(q, k, causal, shift)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp_min(p.sum(-1), 1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).to(acc), v.to(acc))
    o, lse = (o / l[..., None]).to(q.dtype), m + torch.log(l)
    if causal and shift < 0:
        blind = torch.arange(q.shape[2], device=q.device) + shift < 0
        o = o.masked_fill(blind[:, None], 0.0)
        lse = lse.masked_fill(blind, _NEG_INF)
    return o, lse


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulation type: f32 for f32 and bf16 inputs, f64 for f64."""
    return torch.promote_types(dtype, torch.float32)


def _hidden(q: torch.Tensor, k: torch.Tensor, shift: int) -> torch.Tensor:
    """(Tq, Tk) True where the causal mask hides key j from row i: j >
    i + ``shift``."""
    qp = torch.arange(q.shape[2], device=q.device) + shift
    kp = torch.arange(k.shape[2], device=q.device)
    return qp[:, None] < kp[None, :]


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            shift: int = 0) -> torch.Tensor:
    """q·kᵀ/√Dh in the accumulation type, masked to -1e30 above the
    diagonal shifted by ``shift`` when ``causal`` (key j seen by row i
    iff j <= i + shift)."""
    acc = _acc_dtype(q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * (
        1.0 / (q.shape[-1] ** 0.5))
    if causal:
        s = s.masked_fill(_hidden(q, k, shift), _NEG_INF)
    return s


def _bwd_p_ds(q, k, v, lse, do, delta, causal, shift=0):
    """The backward's recomputed P = exp(s - lse) and dS = P·(dP - delta),
    dP = do·vᵀ, all in the accumulation type (``_blockwise_vjp_bwd``'s
    ``p_block`` and ``ds``), q (Tq rows) against k, v (Tk rows) at the
    causal diagonal's ``shift``. A masked element of P is selected to 0,
    as the kernels do: a row that sees no key (lse = -1e30) would give
    exp(-1e30 + 1e30) = 1 on every key, and gets zero gradient instead."""
    acc = _acc_dtype(q.dtype)
    p = torch.exp(_scores(q, k, causal, shift) - lse[..., None].to(acc))
    if causal:
        p = p.masked_fill(_hidden(q, k, shift), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(acc), v.to(acc))
    return p, p * (dp - delta[..., None].to(acc))


def _bwd_dkv_plain(q, k, v, lse, do, delta, causal, shift=0):
    acc = _acc_dtype(q.dtype)
    p, ds = _bwd_p_ds(q, k, v, lse, do, delta, causal, shift)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.to(acc))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(acc)) * (
        1.0 / (q.shape[-1] ** 0.5))
    return dk.to(k.dtype), dv.to(v.dtype)


def _bwd_dq_plain(q, k, v, lse, do, delta, causal, shift=0):
    acc = _acc_dtype(q.dtype)
    _, ds = _bwd_p_ds(q, k, v, lse, do, delta, causal, shift)
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
    """What the kernels take: q (B, H, Tq, Dh) and k, v (B, H, Tk, Dh) of
    one dtype and device, f32 or bf16, with a head dim that is a multiple
    of 8 up to 256; ``more`` (the backward's ``do``, ``lse``, ``delta``)
    checked by ``_check_bwd_values``. Shapes and types first, then
    contiguity and the device of every tensor."""
    if q.dim() != 4:
        raise ValueError(f"expected (B, H, T, Dh) tensors, got {q.dim()}-D")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash kernel takes float32 or bfloat16, "
                         f"got {q.dtype}")
    d = q.shape[-1]
    if d % 8 or not 8 <= d <= _MAX_HEAD_DIM:
        raise ValueError(f"flash kernel takes a head dim that is a multiple "
                         f"of 8 up to {_MAX_HEAD_DIM}, got {d}")
    for name, x in (("k", k), ("v", v)):
        if (x.dtype != q.dtype or x.device != q.device or x.dim() != 4
                or x.shape != k.shape
                or (x.shape[:2], x.shape[3]) != (q.shape[:2], q.shape[3])):
            raise ValueError("q, k, v must share dtype, device, batch, heads "
                             "and head dim, k and v their length too; got "
                             f"q {tuple(q.shape)}/{q.dtype}/{q.device}, k "
                             f"{tuple(k.shape)} and {name} {tuple(x.shape)}/"
                             f"{x.dtype}/{x.device}")
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
    """``do`` like q; ``lse`` and ``delta`` f32 (B, H, Tq) on q's
    device."""
    if do.dtype != q.dtype or do.shape != q.shape or do.device != q.device:
        raise ValueError(f"do must share q's shape, dtype and device; got "
                         f"{tuple(do.shape)}/{do.dtype}/{do.device}")
    want = tuple(q.shape[:3])
    for name, x in (("lse", lse), ("delta", delta)):
        if (x.dtype != torch.float32 or tuple(x.shape) != want
                or x.device != q.device):
            raise ValueError(f"{name} must be float32 {want} on {q.device}, "
                             f"got {tuple(x.shape)}/{x.dtype}/{x.device}")


def _library(name: str, head_dim: int) -> str:
    """The library of kernel ``name`` for a head dim: its own source up to
    128, its wide twin (``csrc/<name>_wide.cu``) above."""
    return name if head_dim <= _NARROW_HEAD_DIM else f"{name}_wide"


def _fwd_cost(q, k, v, causal=False, key_split=0, shift=0):
    return _kernels.flash_attention_fwd_cost(*q.shape, bool(causal),
                                             q.element_size(),
                                             tk=k.shape[2], shift=shift)


def _bwd_cost(cost):
    def of(q, k, v, lse, do, delta, causal=False, shift=0):
        return cost(*q.shape, bool(causal), q.element_size(), tk=k.shape[2],
                    shift=shift if causal else 0)

    return of


@priced("flash_attention_fwd", _fwd_cost)
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, key_split: int = 0,
                        shift: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(q·kᵀ/√Dh)·v and its logsumexp, q (B, H, Tq, Dh) against
    k, v (B, H, Tk, Dh); under ``causal`` key j is seen by row i iff
    j <= i + ``shift`` (0 for one sequence; a pair's q_offset - k_offset),
    and a row that sees no key comes out as (o = 0, lse = -1e30).

    On a CUDA tensor: launches ``csrc/flash_attention_fwd.cu`` (Dh up to
    128) or ``csrc/flash_attention_fwd_wide.cu`` (above) on the current
    stream, or raises; q, k, v must be contiguous. ``key_split`` picks the
    launch: 0 the kernel's own rule, 1 a 4-warp block, 2 an 8-warp block
    that splits each K/V tile's keys (``key_split_for``). On a CPU tensor:
    ``flash_attention_reference`` (the split changes no value there)."""
    if key_split not in (0, 1, 2):
        raise ValueError(f"key_split is 0, 1 or 2, got {key_split!r}")
    shift = int(shift) if causal else 0
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, shift)
    _check_kernel_inputs(q, k, v)
    b, h, t, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    name = _library("flash_attention_fwd", d)
    entry = getattr(_kernels.load(name), f"dl4j_{name}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               lse.data_ptr(), b * h, t, k.shape[2], d, int(bool(causal)),
               shift, 1.0 / (d ** 0.5), int(q.dtype == torch.bfloat16),
               int(key_split), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{rc} at q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype}, shift {shift}, "
                           f"key split {key_split}")
    _kernels.count_launch("flash_attention_fwd")
    return o, lse


def _bwd_launch(name: str, q, k, v, lse, do, delta, outs, causal: bool,
                shift: int) -> None:
    """Launch backward kernel ``name`` (``dkv``: outs (dk, dv); ``dq``:
    outs (dq,)) at Tq rows against Tk keys and the causal ``shift``, after
    the input checks; raises on a failed launch and counts one."""
    _check_kernel_inputs(q, k, v, do=do, lse=lse, delta=delta)
    b, h, tq, d = q.shape
    lib = _library(name, d)
    entry = getattr(_kernels.load(lib), f"dl4j_{lib}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
               do.data_ptr(), delta.data_ptr(), *(x.data_ptr() for x in outs),
               b * h, tq, k.shape[2], d, int(bool(causal)), shift,
               1.0 / (d ** 0.5), int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} at q "
                           f"{tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"{q.dtype}, shift {shift}")
    _kernels.count_launch(name)


@priced("flash_attention_bwd_dkv",
        _bwd_cost(_kernels.flash_attention_bwd_dkv_cost))
def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lse: torch.Tensor,
                            do: torch.Tensor, delta: torch.Tensor,
                            causal: bool = False, shift: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of the attention of q (B, H, Tq, Dh) over k, v (B, H, Tk,
    Dh), from the forward's ``lse`` and ``delta`` (both f32 (B, H, Tq);
    delta = rowsum(do·o), less the lse's cotangent where the caller has
    one); under ``causal`` key j is seen by row i iff j <= i + ``shift``.

    On a CUDA tensor: launches ``csrc/flash_attention_bwd_dkv.cu`` (Dh up
    to 128) or its ``_wide`` twin on the current stream, or raises. On a
    CPU tensor: the plain version's dk and dv."""
    shift = int(shift) if causal else 0
    if q.device.type == "cpu":
        return _bwd_dkv_plain(q, k, v, lse, do, delta, causal, shift)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _bwd_launch("flash_attention_bwd_dkv", q, k, v, lse, do, delta,
                (dk, dv), causal, shift)
    return dk, dv


@priced("flash_attention_bwd_dq",
        _bwd_cost(_kernels.flash_attention_bwd_dq_cost))
def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lse: torch.Tensor,
                           do: torch.Tensor, delta: torch.Tensor,
                           causal: bool = False,
                           shift: int = 0) -> torch.Tensor:
    """dq of the attention of q (B, H, Tq, Dh) over k, v (B, H, Tk, Dh),
    from the forward's ``lse`` and ``delta`` (as ``flash_attention_bwd_dkv``
    takes them) at the causal ``shift``.

    On a CUDA tensor: launches ``csrc/flash_attention_bwd_dq.cu`` (Dh up
    to 128) or its ``_wide`` twin on the current stream, or raises. On a
    CPU tensor: the plain version's dq."""
    shift = int(shift) if causal else 0
    if q.device.type == "cpu":
        return _bwd_dq_plain(q, k, v, lse, do, delta, causal, shift)
    dq = torch.empty_like(q)
    _bwd_launch("flash_attention_bwd_dq", q, k, v, lse, do, delta, (dq,),
                causal, shift)
    return dq


class FlashAttention(torch.autograd.Function):
    """``o = softmax(q·kᵀ/√Dh)·v`` over contiguous (B, H, T, Dh) with the
    flash kernels on both passes: the forward (K3f at ``key_split``) saves
    (q, k, v, o, lse); the backward computes ``delta`` with one torch
    reduction and calls the dK/dV and dQ wrappers. The same wiring runs on
    both devices; on CPU tensors the wrappers compute the plain
    versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, key_split=0):
        o, lse = flash_attention_fwd(q, k, v, causal, key_split=key_split)
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
        return dq, dk, dv, None, None


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, block_q: Optional[int] = None,
                        block_k: Optional[int] = None) -> torch.Tensor:
    """softmax(q·kᵀ/√Dh)·v over (B, H, T, Dh) without materializing (T, T):
    the "blockwise" core, ``FlashAttention`` (K3f forward, K3k and K3q
    backward on the card). The tiles that set the JAX package's lax tiling
    select K3f's key split here (``key_split_for``: none given, the
    kernel's own rule); a split reorders the forward's sums. On the CPU the
    plain versions run and the tiles change no value."""
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal,
                                key_split_for(block_q, block_k))


class BlockPartials(torch.autograd.Function):
    """One pair's ``(o_norm, lse)`` (both f32) at the causal ``shift``, with
    the flash kernels on both passes: the forward is one K3f launch and
    saves (q, k, v, o, lse); the backward takes the cotangents of both
    outputs. With lse = logsumexp(s) and o = P·v, dS = P·(dP - delta) +
    P·dlse, so K3k and K3q run unchanged on delta' = rowsum(do·o) - dlse,
    one launch each at the pair's shift. A row that sees no key has P = 0
    and zero gradient. On CPU tensors the wrappers compute the plain
    versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, shift):
        o, lse = flash_attention_fwd(q, k, v, causal, shift=shift)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.shift = causal, shift
        return o.to(_acc_dtype(o.dtype)), lse

    @staticmethod
    def backward(ctx, do, dlse):
        # an output without a cotangent arrives as zeros (autograd
        # materializes them)
        q, k, v, o, lse = ctx.saved_tensors
        delta = (attention_delta(o, do) - dlse).contiguous()
        do = do.to(q.dtype).contiguous()
        dk, dv = flash_attention_bwd_dkv(q, k, v, lse, do, delta, ctx.causal,
                                         ctx.shift)
        dq = flash_attention_bwd_dq(q, k, v, lse, do, delta, ctx.causal,
                                    ctx.shift)
        return dq, dk, dv, None, None


def blockwise_block_partials(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, q_offset: int = 0,
                             k_offset: int = 0, causal: bool = False,
                             block_q: Optional[int] = None,
                             block_k: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online softmax over ONE Q-shard × K/V-shard pair at GLOBAL sequence
    offsets: ``(o_norm, lse)``, both f32 (B, H, Tq, ·), the pair's
    softmax-normalized output and logsumexp, for any Tq, Tk and offsets.
    Shards merge exactly by logsumexp weights, ``o = Σ_j o_norm_j ·
    exp(lse_j − LSE)``: ring attention's online merge with (m=lse, l=1).

    ``BlockPartials`` at the diagonal shift ``q_offset - k_offset`` (a
    causal K block wholly before the Q block runs causal=0, the launch of a
    pair without a mask): on a CUDA tensor one K3f launch, on a CPU tensor
    its plain version. A causal K block wholly after the Q block calls
    nothing. Differentiable in q, k and v through both outputs, as the JAX
    package's lax version: K3k and K3q once each at the same shift.

    A row that sees no key of the pair comes out as (o = 0, lse = -1e30)
    with zero gradient on both devices, with zero weight in any merge. The
    JAX package's additive mask gives such a row mean(v) instead (every
    score -1e30, so p = 1 on every key) at the same lse ≈ -1e30, so weight
    0 too: the merged output and its gradient are the same, the row's
    o_norm and its own gradient are not. ``block_q``/``block_k`` set the
    JAX package's tiling and change no value here."""
    tq, tk = q.shape[2], k.shape[2]
    q_offset, k_offset = int(q_offset), int(k_offset)
    if causal and k_offset >= q_offset + tq:
        b, h, _, d = q.shape
        return (torch.zeros((b, h, tq, v.shape[-1]), dtype=torch.float32,
                            device=q.device),
                torch.full((b, h, tq), _NEG_INF, dtype=torch.float32,
                           device=q.device))
    causal = causal and k_offset + tk > q_offset
    return BlockPartials.apply(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal,
                               q_offset - k_offset if causal else 0)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False, impl: Optional[str] = None,
                   block_q: Optional[int] = None,
                   block_k: Optional[int] = None) -> torch.Tensor:
    """The attention core over (B, H, T, Dh). ``impl`` forces a core for
    THIS call; otherwise the set_attention_impl/env/auto chain decides, by
    T, head dim and dtype. ``block_q``/``block_k`` (the autotuner's knob)
    reach the "blockwise" core only, as in JAX: there they pick K3f's key
    split (``key_split_for``); "flash" and "dense" ignore them.
    Every core computes the same function (tests/test_torch_flash_attention.py
    holds them against the JAX package)."""
    if impl is not None and impl not in _IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; "
                         "options: " + ", ".join(_IMPLS))
    impl = impl or resolve_attention_impl(q.shape[2], q.shape[-1], q.dtype)
    if impl == "blockwise":
        return blockwise_attention(q, k, v, causal, block_q, block_k)
    if impl == "flash":
        return blockwise_attention(q, k, v, causal)
    return dense_attention(q, k, v, causal)
