"""Counterpart of ``deeplearning4j_tpu/parallel/ring_attention.py``:
sequence parallelism, ring attention and Ulysses all-to-all.

One process per rank: each rank holds its shard of the sequence, q/k/v of
shape (B_local, H, T/P, Dh), and calls the same functions as every other
rank of the axis (a collective call).

- ``ring_attention``: K/V blocks rotate around the axis (the mesh's ring
  shift, ``i → i+1``) while an online softmax merges the blocks' partials
  in f32 ``(o, l, m)`` accumulators. A ``torch.autograd.Function`` runs it:
  the forward takes P steps and skips the last exchange; the backward runs
  the ring again from the merged output's logsumexp and ``delta =
  rowsum(do·o)``, each attended pair adding to dQ and to its K/V block's
  dK/dV, and the dK/dV accumulators travel with their block and come home
  with one more shift. Under a causal mask the pairs above the diagonal
  are skipped in both directions.
- ``ulysses_attention``: an all-to-all from sequence to heads, the local
  ``attention_core`` over the whole sequence on H/P heads, and the
  all-to-all back; the backward is the inverse all-to-all.

The per-pair core is the attention seam (``attn_impl`` > override > env >
auto on the LOCAL length; "flash" runs as "blockwise"): "blockwise" is
``ops.flash_attention.blockwise_block_partials``, one K3f launch a pair on
the card, with K3k and K3q in the backward; "dense" is plain torch, the
JAX package's lax block. The ring's body takes its rotation as a callable,
so ``ring_attention_in_process`` runs the same body over P shards held in
one process (the ring's kernel work on one card).

``reference_attention`` is the materializing oracle behind
``ops.flash_attention.dense_attention``.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch

from deeplearning4j_tpu_torch.ops.activations import softmax

_NEG_INF = -1e30

# rotate(items) -> wait() -> items: the list of what each held shard sends
# (a list of tensors per shard), back as what each received
Rotate = Callable[[list], Callable[[], list]]


def _block_attn(q, k, v, bias):
    """One (q-block, k-block) pair: (scores max, exp sums, exp-weighted
    values), in the inputs' dtype as the JAX package's lax block."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(
        q.shape[-1] * 1.0)
    if bias is not None:
        scores = scores + bias
    m = scores.amax(-1)
    p = torch.exp(scores - m[..., None])
    return m, p.sum(-1), torch.einsum("bhqk,bhkd->bhqd", p, v)


def _ring_block_core(q, k_cur, v_cur, q_offset: int, k_offset: int,
                     causal: bool, impl: str):
    """The attention seam inside the ring: one (Q shard, K/V shard) pair
    → online-softmax partials (bm, bl, bo). "blockwise" reports the
    normalized form (m=lse, l=1, o=o_norm), the same merge."""
    if impl == "blockwise":
        from deeplearning4j_tpu_torch.ops import flash_attention as fa

        o_norm, lse = fa.blockwise_block_partials(
            q, k_cur, v_cur, q_offset=q_offset, k_offset=k_offset,
            causal=causal)
        return lse, torch.ones_like(lse), o_norm
    bias = None
    if causal:
        qp = q_offset + torch.arange(q.shape[2], device=q.device)
        kp = k_offset + torch.arange(k_cur.shape[2], device=q.device)
        bias = torch.where(qp[:, None] >= kp[None, :], 0.0,
                           _NEG_INF).to(q.dtype)
    return _block_attn(q, k_cur, v_cur, bias)


def _attended(my: int, src: int, causal: bool) -> bool:
    """Whether shard ``my``'s queries see block ``src`` at all: under a
    causal mask the blocks of later shards are fully masked."""
    return not causal or src <= my


def _ring_forward(qs: List[torch.Tensor], ks: List[torch.Tensor],
                  vs: List[torch.Tensor], idxs: Sequence[int], n: int,
                  rotate: Rotate, causal: bool, impl: str,
                  prefetch: bool = True):
    """The ring's per-rank forward over the shards this process holds
    (``idxs`` their axis indices; one on a real ring): ``(os, lses)``,
    each shard's output in q's dtype and its logsumexp (f32; f64 for f64
    inputs). P steps; at
    step s a shard attends the block from ``(my - s) mod P``, then the
    blocks rotate, the last exchange skipped. ``prefetch`` issues the
    rotation before the attend; the values are the same either way."""
    t_l = qs[0].shape[2]
    acc = torch.promote_types(qs[0].dtype, torch.float32)
    o = [torch.zeros(q.shape, dtype=acc, device=q.device) for q in qs]
    l = [torch.zeros(q.shape[:3], dtype=acc, device=q.device) for q in qs]
    m = [torch.full(q.shape[:3], _NEG_INF, dtype=acc, device=q.device)
         for q in qs]
    kv = [[k, v] for k, v in zip(ks, vs)]
    for step in range(n):
        last = step == n - 1
        pending = rotate(kv) if prefetch and not last else None
        for j, my in enumerate(idxs):
            src = (my - step) % n
            if not _attended(my, src, causal):
                continue
            bm, bl, bo = _ring_block_core(qs[j], kv[j][0], kv[j][1],
                                          my * t_l, src * t_l, causal, impl)
            bm, bl, bo = bm.to(acc), bl.to(acc), bo.to(acc)
            new_m = torch.maximum(m[j], bm)
            scale_old = torch.exp(m[j] - new_m)
            scale_new = torch.exp(bm - new_m)
            o[j] = o[j] * scale_old[..., None] + bo * scale_new[..., None]
            l[j] = l[j] * scale_old + bl * scale_new
            m[j] = new_m
        if not last:
            kv = pending() if prefetch else rotate(kv)()
    # a row masked in every block has l == 0: the guard keeps it finite
    lg = [torch.clamp_min(x, 1e-30) for x in l]
    os_ = [(oj / lj[..., None]).to(q.dtype) for oj, lj, q in zip(o, lg, qs)]
    lses = [mj + torch.log(lj) for mj, lj in zip(m, lg)]
    return os_, lses


def _pair_bwd(q, k, v, lse, do, delta, causal_pair: bool, impl: str):
    """(dq, dk, dv) of one attended pair from the GLOBAL lse and delta:
    K3q and K3k on the card for "blockwise", plain torch for "dense"."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    if impl == "blockwise":
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, do, delta,
                                            causal_pair)
        dq = fa.flash_attention_bwd_dq(q, k, v, lse, do, delta, causal_pair)
        return dq, dk, dv
    dk, dv = fa._bwd_dkv_plain(q, k, v, lse, do, delta, causal_pair)
    return fa._bwd_dq_plain(q, k, v, lse, do, delta, causal_pair), dk, dv


def _ring_backward(qs, ks, vs, os_, lses, dos, idxs: Sequence[int], n: int,
                   rotate: Rotate, causal: bool, impl: str):
    """The ring's per-rank backward: ``(dqs, dks, dvs)`` in the inputs'
    dtypes. The pairs of the forward, attended again in the same order;
    dQ accumulates at home, each block's dK/dV accumulators ride with it
    and one more shift after the last step brings them home."""
    from deeplearning4j_tpu_torch.ops.flash_attention import attention_delta

    acc = torch.promote_types(qs[0].dtype, torch.float32)
    qs = [q.contiguous() for q in qs]
    dos = [d.contiguous() for d in dos]
    deltas = [attention_delta(o, d) for o, d in zip(os_, dos)]
    dq = [torch.zeros(q.shape, dtype=acc, device=q.device) for q in qs]
    carry = [[k.contiguous(), v.contiguous(),
              torch.zeros(k.shape, dtype=acc, device=k.device),
              torch.zeros(v.shape, dtype=acc, device=v.device)]
             for k, v in zip(ks, vs)]
    for step in range(n):
        for j, my in enumerate(idxs):
            src = (my - step) % n
            if not _attended(my, src, causal):
                continue
            kc, vc, dk_acc, dv_acc = carry[j]
            dqp, dkp, dvp = _pair_bwd(qs[j], kc, vc, lses[j], dos[j],
                                      deltas[j], causal and src == my, impl)
            dq[j] = dq[j] + dqp.to(acc)
            carry[j][2] = dk_acc + dkp.to(acc)
            carry[j][3] = dv_acc + dvp.to(acc)
        if step < n - 1:
            carry = rotate(carry)()
        else:
            carry = [c[:2] + r for c, r in
                     zip(carry, rotate([c[2:] for c in carry])())]
    return ([d.to(q.dtype) for d, q in zip(dq, qs)],
            [c[2].to(k.dtype) for c, k in zip(carry, ks)],
            [c[3].to(v.dtype) for c, v in zip(carry, vs)])


def _mesh_rotate(mesh, axis: str) -> Rotate:
    """The rotation of a real ring: this rank's one shard, shifted by the
    mesh's ring shift over ``axis``."""
    def rotate(items):
        (tensors,) = items
        wait = mesh.ring_shift(tensors, axis)
        return lambda: [list(wait())]

    return rotate


def _list_rotate(n: int) -> Rotate:
    """The rotation of P shards held in one process: shard i receives what
    shard i-1 held."""
    def rotate(items):
        return lambda: [items[(i - 1) % n] for i in range(n)]

    return rotate


class _Ring(torch.autograd.Function):
    """The ring over a mesh axis, forward and backward (module
    docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, impl, prefetch):
        n, my = mesh.axis_size(axis), mesh.axis_index(axis)
        (o,), (lse,) = _ring_forward([q], [k], [v], [my], n,
                                     _mesh_rotate(mesh, axis), causal, impl,
                                     prefetch)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (mesh, axis, causal, impl)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        mesh, axis, causal, impl = ctx.args
        n, my = mesh.axis_size(axis), mesh.axis_index(axis)
        (dq,), (dk,), (dv,) = _ring_backward(
            [q], [k], [v], [o], [lse], [do], [my], n,
            _mesh_rotate(mesh, axis), causal, impl)
        return dq, dk, dv, None, None, None, None, None


class _RingInProcess(torch.autograd.Function):
    """The ring's per-rank body over P sequence shards of one process."""

    @staticmethod
    def forward(ctx, q, k, v, n, causal, impl, prefetch):
        split = [x.chunk(n, dim=2) for x in (q, k, v)]
        os_, lses = _ring_forward(*split, range(n), n, _list_rotate(n),
                                  causal, impl, prefetch)
        ctx.save_for_backward(q, k, v, *os_, *lses)
        ctx.args = (n, causal, impl)
        return torch.cat(os_, dim=2)

    @staticmethod
    def backward(ctx, do):
        n, causal, impl = ctx.args
        q, k, v = ctx.saved_tensors[:3]
        os_ = list(ctx.saved_tensors[3:3 + n])
        lses = list(ctx.saved_tensors[3 + n:])
        dqs, dks, dvs = _ring_backward(
            *(list(x.chunk(n, dim=2)) for x in (q, k, v)), os_, lses,
            list(do.chunk(n, dim=2)), range(n), n, _list_rotate(n), causal,
            impl)
        return (torch.cat(dqs, dim=2), torch.cat(dks, dim=2),
                torch.cat(dvs, dim=2), None, None, None, None)


def _resolve_impl(t_local: int, q: torch.Tensor,
                  attn_impl: Optional[str]) -> str:
    from deeplearning4j_tpu_torch.ops.flash_attention import \
        resolve_attention_impl

    impl = attn_impl or resolve_attention_impl(t_local, q.shape[-1],
                                               q.dtype)
    if impl not in ("flash", "blockwise", "dense"):
        raise ValueError(f"unknown attention impl {impl!r}; "
                         "options: flash, blockwise, dense")
    # the fused kernel's per-block form is the blockwise partials
    return "blockwise" if impl == "flash" else impl


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis: str, causal: bool = False,
                   batch_axis: Optional[str] = None,
                   attn_impl: Optional[str] = None,
                   prefetch: bool = True) -> torch.Tensor:
    """Multi-head attention with the SEQUENCE axis sharded over ``axis``.

    q/k/v: this rank's shard (B_local, H, T/P, Dh) of the global (B, H, T,
    Dh), the sequence block at its index on ``axis``; returns its shard of
    the output. Every rank of the axis calls it. ``batch_axis`` names the
    axis the batch rows are split over (dp×sp: each data-parallel row runs
    its own ring); the rows are this rank's already, so it only has to be
    on the mesh. ``attn_impl`` forces the per-pair core ("blockwise" |
    "dense"; "flash" runs as "blockwise"); None resolves on the LOCAL
    length T/P. ``prefetch`` starts the rotation of the next block before
    this block's attend; the values are identical either way."""
    if batch_axis is not None and batch_axis not in mesh.axis_names:
        raise ValueError(f"batch axis {batch_axis!r} is not on the mesh "
                         f"{mesh.axis_names}")
    impl = _resolve_impl(q.shape[2], q, attn_impl)
    return _Ring.apply(q, k, v, mesh, axis, causal, impl, prefetch)


def ring_attention_in_process(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, n_shards: int,
                              causal: bool = False,
                              attn_impl: Optional[str] = None,
                              prefetch: bool = True) -> torch.Tensor:
    """The ring's per-rank body driven over ``n_shards`` sequence shards
    of the global (B, H, T, Dh) q/k/v held in ONE process, the rotation a
    shift of the list: the same pairs, kernels and merges as a ring of
    ``n_shards`` ranks, differentiable. The impl resolves on T/n_shards."""
    if q.shape[2] % n_shards:
        raise ValueError(f"sequence length {q.shape[2]} does not split "
                         f"into {n_shards} shards")
    impl = _resolve_impl(q.shape[2] // n_shards, q, attn_impl)
    return _RingInProcess.apply(q, k, v, int(n_shards), causal, impl,
                                prefetch)


def _seq_to_heads(mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """(B, H, T/P, D) → (B, H/P, T, D) by one all-to-all over ``axis``."""
    from deeplearning4j_tpu_torch.parallel.mesh import all_to_all_ad

    n = mesh.axis_size(axis)
    b, h, t, d = x.shape
    send = x.reshape(b, n, h // n, t, d).permute(1, 0, 2, 3, 4)
    got = all_to_all_ad(mesh, send, axis)            # (src, B, H/P, T/P, D)
    return got.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * t, d)


def _heads_to_seq(mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """(B, H/P, T, D) → (B, H, T/P, D), the inverse all-to-all."""
    from deeplearning4j_tpu_torch.parallel.mesh import all_to_all_ad

    n = mesh.axis_size(axis)
    b, hp, t, d = x.shape
    send = x.reshape(b, hp, n, t // n, d).permute(2, 0, 1, 3, 4)
    got = all_to_all_ad(mesh, send, axis)            # (src, B, H/P, T/P, D)
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * hp, t // n, d)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, axis: str, causal: bool = False,
                      attn_impl: Optional[str] = None) -> torch.Tensor:
    """DeepSpeed-Ulysses sequence parallelism: all-to-all to head
    sharding, the local ``attention_core`` on the whole sequence
    (``attn_impl`` forces it; default: override/env/auto on the full
    length), all-to-all back. q/k/v as in ``ring_attention``; H must be
    divisible by the axis size."""
    from deeplearning4j_tpu_torch.ops.flash_attention import attention_core

    n = mesh.axis_size(axis)
    if q.shape[1] % n != 0:
        raise ValueError(
            f"ulysses needs heads ({q.shape[1]}) divisible by axis size "
            f"({n}); use ring_attention instead")
    qh, kh, vh = (_seq_to_heads(mesh, x, axis) for x in (q, k, v))
    out = attention_core(qh, kh, vh, causal=causal, impl=attn_impl)
    return _heads_to_seq(mesh, out, axis)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """Unsharded dense attention over (B, H, T, Dh) for verification. Keeps
    the input dtype throughout, as the JAX oracle does (its ``jnp.sqrt``
    scale is weakly typed, so bf16 scores stay bf16)."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(
        q.shape[-1] * 1.0)
    if causal:
        t = q.shape[2]
        pos = torch.arange(t, device=q.device)
        mask = pos[:, None] >= pos[None, :]
        scores = torch.where(mask[None, None], scores,
                             torch.tensor(_NEG_INF, dtype=scores.dtype,
                                          device=scores.device))
    return torch.einsum("bhqk,bhkd->bhqd", softmax(scores), v)


def sequence_sharding(mesh, axis: str) -> tuple:
    """The spec placing the sequence axis of (B, H, T, Dh) on ``axis``
    (``P(None, None, axis, None)``)."""
    return (None, None, axis, None)
