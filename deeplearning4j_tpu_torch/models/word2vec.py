"""Counterpart of ``deeplearning4j_tpu/models/word2vec.py``: Word2Vec
skip-gram with negative sampling (SGNS, per-pair or group-shared
negatives) and hierarchical softmax (HS), on one device or data-parallel
over the ranks of a ``parallel.mesh`` mesh.

Parity surface: ref models/word2vec/Word2Vec.java — fit() builds the vocab
(Huffman coding via Word2Vec.java:353), then trains skip-gram with
hierarchical softmax and/or negative sampling
(InMemoryLookupTable.iterate, InMemoryLookupTable.java:165-236), with
lr decay by words processed (:85) and frequent-word subsampling (:224).

The JAX package runs a whole epoch as one ``lax.scan``. Here an epoch is a
Python loop over its steps that keeps everything on the device: the
indexed corpus is uploaded once per vocab build, each epoch's subsampling
draw, stable compaction and reduced-window draw run on the device, and
every step builds its skip-gram pair block, draws its negatives and applies
collision-normalized updates with ``index_add_`` (JAX's ``.at[].add``).
The kept-word count stays a tensor, so no step reads the device; the one
host read of a fit is its trained pair count.

The epoch's random draws sit behind three module-level functions
(``_keep_uniforms``, ``_window_draws``, ``_neg_slots``) that take an
``ops.rng`` key; the keys are split as JAX splits its own
(``_sgns_device_epoch``, ``_epoch_setup``), so tests can put JAX's draws
in at those points. Collisions between duplicate indices in one step
resolve by addition; on the card ``index_add_`` sums them with atomics in
no fixed order, so results there agree with the CPU to a tolerance, not
bit for bit.

With ``mesh=`` (``Word2Vec(mesh=...)``, ``make_sharded_sgns_step``,
``make_sharded_hs_step``) every rank runs the same loop over the same
host-generated global pair batches and takes its contiguous rows; it
builds its scatter-added gradients and collision counts, ONE flat
all-reduce sums them over the ranks, and every rank applies the identical
collision-normalized update. Each rank draws its negatives from the step
key folded with its shard index (``rng.fold_in``), as JAX's ``shard_map``
step does.
"""

from __future__ import annotations

import hashlib
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from deeplearning4j_tpu_torch._device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.models.embeddings import (
    InMemoryLookupTable,
    cosine_nearest,
    cosine_sim,
)
from deeplearning4j_tpu_torch.ops import rng
from deeplearning4j_tpu_torch.text.sentence_iterator import SentenceIterator
from deeplearning4j_tpu_torch.text.tokenization import DefaultTokenizerFactory, TokenizerFactory
from deeplearning4j_tpu_torch.text.vocab import VocabCache, build_huffman

_EPS = 1e-7
DATA_AXIS = "data"


# ------------------------------------------------------------ draw points ----

def _keep_uniforms(key: int, n: int, device) -> Tensor:
    """(n,) float32 uniforms in [0, 1) for the subsampling keep draw."""
    return torch.rand(n, generator=rng.generator(key, device), device=device)


def _window_draws(key: int, n: int, window: int, device) -> Tensor:
    """(n,) int64 reduced-window sizes in [1, window]."""
    return torch.randint(1, window + 1, (n,),
                         generator=rng.generator(key, device), device=device)


def _neg_slots(key: int, shape: Tuple[int, int], slots: int,
               device) -> Tensor:
    """int64 slots of the negative-sampling table, uniform in [0, slots)."""
    return torch.randint(0, slots, shape,
                         generator=rng.generator(key, device), device=device)


# ------------------------------------------------------------- step bodies ----

def _scatter_normalized(table: Tensor, idx: Tensor, rows: Tensor,
                        w: Tensor, lr) -> None:
    """``table[idx] += -lr * rows / max(count, 1)`` in place, where a row's
    count is the summed weight of its duplicates in ``idx``."""
    cnt = torch.zeros(table.shape[0], dtype=table.dtype,
                      device=table.device).index_add_(0, idx, w)
    table.index_add_(0, idx, -lr * rows / cnt.clamp(min=1.0)[idx, None])


def _sgns_grads(syn0, syn1neg, centers, contexts, weights, negs):
    """Shared SGNS gradient math: returns (grad_v, u_idx, u_grad, u_w, loss).
    grad rows are pre-weighted by the 0/1 padding mask."""
    v = syn0[centers]                       # (B,D)
    u_pos = syn1neg[contexts]               # (B,D)
    u_neg = syn1neg[negs]                   # (B,K,D)
    negative = negs.shape[1]

    pos_score = torch.sigmoid((v * u_pos).sum(-1))                   # (B,)
    neg_score = torch.sigmoid(
        torch.bmm(u_neg, v[:, :, None])[..., 0])                      # (B,K)

    g_pos = (pos_score - 1.0) * weights                              # (B,)
    g_neg = neg_score * weights[:, None]                             # (B,K)

    grad_v = g_pos[:, None] * u_pos + torch.bmm(g_neg[:, None, :],
                                                u_neg)[:, 0]
    grad_u_pos = g_pos[:, None] * v
    grad_u_neg = g_neg[..., None] * v[:, None, :]

    u_idx = torch.cat([contexts, negs.reshape(-1)])
    u_grad = torch.cat(
        [grad_u_pos, grad_u_neg.reshape(-1, grad_u_neg.shape[-1])])
    u_w = torch.cat([weights, weights.repeat_interleave(negative)])
    loss = -(torch.log(pos_score + _EPS) * weights).sum() - (
        torch.log(1.0 - neg_score + _EPS) * weights[:, None]).sum()
    return grad_v, u_idx, u_grad, u_w, loss


def _sgns_grads_shared(syn0, syn1neg, centers, contexts, weights, negs_g,
                       v=None):
    """Group-shared-negative twin of ``_sgns_grads`` (same return contract)
    for flat (B,) pairs with negs_g (G,K) shared per group of P = B/G pairs:
    the negative gradients become per-group batched products and the
    output-table rows drop from B*(1+K) to B + G*K. ``v``: optional
    precomputed (B,D) center rows (then ``centers`` is not read)."""
    b = contexts.shape[0]
    g, k = negs_g.shape
    p = b // g
    if v is None:
        v = syn0[centers]                   # (B,D)
    u_pos = syn1neg[contexts]               # (B,D)
    u_neg = syn1neg[negs_g]                 # (G,K,D)
    vg = v.reshape(g, p, -1)
    wg = weights.reshape(g, p)

    pos_score = torch.sigmoid((v * u_pos).sum(-1))                   # (B,)
    neg_score = torch.sigmoid(torch.bmm(vg, u_neg.transpose(1, 2)))  # (G,P,K)

    g_pos = (pos_score - 1.0) * weights                              # (B,)
    g_neg = neg_score * wg[..., None]                                # (G,P,K)

    grad_v = (g_pos[:, None] * u_pos
              + torch.bmm(g_neg, u_neg).reshape(b, -1))
    grad_u_pos = g_pos[:, None] * v
    grad_u_neg = torch.bmm(g_neg.transpose(1, 2), vg)                # (G,K,D)

    u_idx = torch.cat([contexts, negs_g.reshape(-1)])
    u_grad = torch.cat([grad_u_pos, grad_u_neg.reshape(g * k, -1)])
    u_w = torch.cat([weights, wg.sum(1)[:, None].expand(g, k).reshape(-1)])
    loss = -(torch.log(pos_score + _EPS) * weights).sum() - (
        torch.log(1.0 - neg_score + _EPS) * wg[..., None]).sum()
    return grad_v, u_idx, u_grad, u_w, loss


def _sgns_update(syn0, syn1neg, centers, contexts, weights, negs, lr):
    """SGNS step with per-pair negatives: gradient + collision-normalized
    scatter update. Updates ``syn0`` and ``syn1neg`` in place (JAX donates
    them) and returns (syn0, syn1neg, loss)."""
    grad_v, u_idx, u_grad, u_w, loss = _sgns_grads(
        syn0, syn1neg, centers, contexts, weights, negs)
    _scatter_normalized(syn0, centers, grad_v, weights, lr)
    _scatter_normalized(syn1neg, u_idx, u_grad, u_w, lr)
    return syn0, syn1neg, loss


def _sgns_update_shared(syn0, syn1neg, ctr, ctx, wmat, negs_g, lr):
    """SGNS step on a skip-gram block with negatives shared per group of
    pairs and window-reduced center rows. ctr: (block,) centers,
    ctx/wmat: (block, 2W) contexts + 0/1 validity, negs_g: (G, K) shared
    negatives for B = block*2W pairs. A block's pair centers are its
    positions each repeated 2W times, so the center table is gathered and
    scattered at (block,) rows; summing grad_v over the window first is
    exact because a position's collision count is the same across its
    repeats. Updates in place, returns (syn0, syn1neg, loss)."""
    block, two_w = ctx.shape
    v = syn0[ctr].repeat_interleave(two_w, dim=0)     # (B,D) broadcast
    grad_v, u_idx, u_grad, u_w, loss = _sgns_grads_shared(
        syn0, syn1neg, None, ctx.reshape(-1), wmat.reshape(-1), negs_g, v=v)
    gv_row = grad_v.reshape(block, two_w, -1).sum(1)
    _scatter_normalized(syn0, ctr, gv_row, wmat.sum(1), lr)
    _scatter_normalized(syn1neg, u_idx, u_grad, u_w, lr)
    return syn0, syn1neg, loss


def _hs_update(syn0, syn1, centers, points, codes, mask, weights, lr):
    """HS step body (collision-normalized scatter update), in place;
    returns (syn0, syn1, loss)."""
    v = syn0[centers]                       # (B,D)
    u = syn1[points]                        # (B,L,D)
    score = torch.sigmoid(torch.bmm(u, v[:, :, None])[..., 0])       # (B,L)
    labels = 1.0 - codes
    g = (score - labels) * mask * weights[:, None]   # (B,L)

    grad_v = torch.bmm(g[:, None, :], u)[:, 0]
    grad_u = g[..., None] * v[:, None, :]

    _scatter_normalized(syn0, centers, grad_v, weights, lr)
    # collision counts weighted by the padding mask too — a padded row
    # (weight 0) must not inflate the denominator for its path nodes
    _scatter_normalized(syn1, points.reshape(-1),
                        grad_u.reshape(-1, grad_u.shape[-1]),
                        (mask * weights[:, None]).reshape(-1), lr)
    loss = -(
        (labels * torch.log(score + _EPS)
         + (1 - labels) * torch.log(1 - score + _EPS))
        * mask * weights[:, None]
    ).sum()
    return syn0, syn1, loss


def neg_group_size(bsz: int, cap: int) -> int:
    """Largest divisor of the step's pair count ``bsz`` that is <= ``cap``
    (the shared update reshapes (B,) -> (G, P) so the group size must divide
    B; degrades to 1 — per-pair-equivalent semantics — when bsz is prime)."""
    return next(g for g in range(min(cap, bsz), 0, -1) if bsz % g == 0)


def build_neg_table(probs: np.ndarray, slots: int = 1 << 20,
                    device: DeviceLike = None) -> Tensor:
    """Device-resident inverse-CDF sampling table over unigram^0.75 probs
    (ref: the precomputed ``table`` in InMemoryLookupTable.java): slot t
    holds the word whose cumulative probability covers (t+0.5)/T. int64,
    the index dtype of the gathers it feeds."""
    probs = np.asarray(probs, np.float64)
    cum = np.cumsum(probs / probs.sum())
    table = np.searchsorted(cum, (np.arange(slots) + 0.5) / slots)
    return torch.from_numpy(table.astype(np.int64)).to(resolve_device(device))


def _sample_negs(key, neg_table: Tensor, b: int, negative: int) -> Tensor:
    """(b, negative) negatives: a gather of the unigram^0.75 table at
    uniform slots, O(1) per sample."""
    slots = _neg_slots(key, (b, negative), neg_table.shape[0],
                       neg_table.device)
    return neg_table[slots]


def _sgns_step(syn0, syn1neg, centers, contexts, weights, neg_table, lr, key,
               negative: int):
    """One negative-sampling step on an arbitrary pair batch.
    centers/contexts: (B,), weights: (B,) 0/1 mask for padding."""
    negs = _sample_negs(key, neg_table, centers.shape[0], negative)
    return _sgns_update(syn0, syn1neg, centers, contexts, weights, negs, lr)


# ------------------------------------------------- device-side pair stream ----

def _pair_block(flatc, sidc, b, n_kept, pos0: int, block: int, window: int):
    """Skip-gram pairs for compacted-corpus positions [pos0, pos0+block).

    Returns centers (block,), contexts (block, 2W), weights (block, 2W);
    weights fold the reference's validity rules: in-corpus, same sentence,
    and |offset| <= b_center (the center's reduced window draw,
    ref Word2Vec.skipGram 'b' at Word2Vec.java:303-331). ``n_kept`` may be
    a device scalar."""
    n = flatc.shape[0]
    w = window
    dev = flatc.device
    pos = pos0 + torch.arange(block, device=dev)
    posc = pos.clamp(0, n - 1)
    ctr = flatc[posc]
    offs = torch.cat([torch.arange(-w, 0, device=dev),
                      torch.arange(1, w + 1, device=dev)])      # (2W,)
    cpos = pos[:, None] + offs[None, :]
    in_bounds = (cpos >= 0) & (cpos < n_kept) & (pos[:, None] < n_kept)
    cposc = cpos.clamp(0, n - 1)
    ctx = flatc[cposc]
    same_sent = sidc[cposc] == sidc[posc][:, None]
    in_window = offs.abs()[None, :] <= b[posc][:, None]
    weights = (in_bounds & same_sent & in_window).to(torch.float32)
    return ctr, ctx, weights


def _epoch_setup(flat, sid, keep, key, window: int):
    """Per-epoch randomness on the device: subsample draw + stable-sort
    compaction (kept words first, corpus order preserved — windows span
    removed words exactly like the reference, which deletes them from the
    sentence before windowing), plus the per-position reduced-window draw.
    Returns (flat, sid) compacted, the draws b and the kept count as a
    device scalar."""
    n = flat.shape[0]
    ka, kb = rng.split(key)
    keep_mask = _keep_uniforms(ka, n, flat.device) < keep[flat]
    n_kept = keep_mask.sum()
    order = torch.argsort((~keep_mask).to(torch.uint8), stable=True)
    b = _window_draws(kb, n, window, flat.device)
    return flat[order], sid[order], b, n_kept


def _sgns_device_epoch(syn0, syn1neg, flat, sid, keep, neg_table, lrs, key,
                       *, window: int, negative: int, block: int,
                       n_steps: int, neg_group: int = 0):
    """One whole SGNS epoch on the device: subsample, pair generation and
    ``n_steps`` updates. Trains ``syn0``/``syn1neg`` in place and returns
    (syn0, syn1neg, losses, pairs_trained), the last two device tensors.

    ``neg_group``: pairs per shared-negative group (must divide the step's
    pair count; 0 = classic per-pair negatives) — see _sgns_update_shared."""
    kse, ksc = rng.split(key)
    flatc, sidc, b, n_kept = _epoch_setup(flat, sid, keep, kse, window)
    keys = rng.split(ksc, n_steps)
    bsz = block * 2 * window
    losses, wsums = [], []
    for step in range(n_steps):
        ctr, ctx, w = _pair_block(flatc, sidc, b, n_kept, step * block,
                                  block, window)
        if neg_group:
            negs_g = _sample_negs(keys[step], neg_table, bsz // neg_group,
                                  negative)
            syn0, syn1neg, loss = _sgns_update_shared(
                syn0, syn1neg, ctr, ctx, w, negs_g, lrs[step])
        else:
            c = ctr[:, None].expand(ctx.shape).reshape(-1)
            negs = _sample_negs(keys[step], neg_table, bsz, negative)
            syn0, syn1neg, loss = _sgns_update(
                syn0, syn1neg, c, ctx.reshape(-1), w.reshape(-1), negs,
                lrs[step])
        losses.append(loss)
        wsums.append(w.sum())
    return syn0, syn1neg, torch.stack(losses), torch.stack(wsums).sum()


def _hs_device_epoch(syn0, syn1, flat, sid, keep, pts, cds, msk, lrs, key,
                     *, window: int, block: int, n_steps: int):
    """Hierarchical-softmax twin of _sgns_device_epoch."""
    flatc, sidc, b, n_kept = _epoch_setup(flat, sid, keep, key, window)
    losses, wsums = [], []
    for step in range(n_steps):
        ctr, ctx, w = _pair_block(flatc, sidc, b, n_kept, step * block,
                                  block, window)
        c = ctr[:, None].expand(ctx.shape).reshape(-1)
        t = ctx.reshape(-1)
        syn0, syn1, loss = _hs_update(
            syn0, syn1, c, pts[t], cds[t], msk[t], w.reshape(-1), lrs[step])
        losses.append(loss)
        wsums.append(w.sum())
    return syn0, syn1, torch.stack(losses), torch.stack(wsums).sum()


# ----------------------------------------------------- sharded (DP) steps ----

def _data_axis(mesh) -> Tuple[int, int]:
    """(ranks, this rank's index) on the mesh's "data" axis."""
    if DATA_AXIS not in mesh.axis_names:
        raise ValueError(f"data-parallel Word2Vec needs a {DATA_AXIS!r} mesh "
                         f"axis; the mesh has {tuple(mesh.axis_names)}")
    return int(mesh.shape[DATA_AXIS]), int(mesh.coords[DATA_AXIS])


def _rows(a, n: int, r: int, device) -> Tensor:
    """Rank ``r``'s contiguous block of the global batch ``a`` (rows a
    multiple of ``n``), on ``device``."""
    if a.shape[0] % n:
        raise ValueError(f"a batch of {a.shape[0]} rows does not split over "
                         f"the {n} ranks of the {DATA_AXIS!r} axis")
    b = a.shape[0] // n
    part = a[r * b:(r + 1) * b]
    if not isinstance(part, Tensor):
        part = torch.from_numpy(np.ascontiguousarray(part))
    return part.to(device)


def _reduce_and_apply(mesh, tables, grads, counts, loss, lr):
    """One flat all-reduce of every (grad, count) pair and the loss, then
    the collision-normalized update of each table, in place."""
    from deeplearning4j_tpu_torch.parallel.mesh import flat_all_reduce

    k = len(tables)
    out = flat_all_reduce(mesh, list(grads) + list(counts) + [loss])
    for table, g, c in zip(tables, out[:k], out[k:2 * k]):
        table.sub_(lr * g / c.clamp(min=1.0)[:, None])
    return out[-1]


def make_sharded_sgns_step(mesh, negative: int, neg_group: int = 0):
    """Data-parallel SGNS step over the mesh's "data" axis:
    ``step(syn0, syn1neg, centers, contexts, weights, neg_table, lr, key)
    -> (syn0, syn1neg, loss)``, the tables updated in place.

    ``centers``/``contexts``/``weights`` are the GLOBAL pair batch, the
    same on every rank; each rank takes its rows, draws its negatives with
    the step key folded with its shard index, builds its scatter-added
    gradients and collision counts ``(g0, c0, g1, c1, loss)``, and one flat
    all-reduce sums them; every rank then applies the identical
    collision-normalized update — numerically the single-device
    ``_sgns_step`` on the concatenated global batch (negatives drawn per
    shard). ``neg_group``: pairs per shared-negative group within each
    shard (must divide the per-shard pair count; 0 = per-pair draws)."""
    n, r = _data_axis(mesh)

    def step(syn0, syn1neg, centers, contexts, weights, neg_table, lr, key):
        dev = syn0.device
        centers, contexts, weights = (_rows(a, n, r, dev) for a in
                                      (centers, contexts, weights))
        key = rng.fold_in(key, r)
        b_local = centers.shape[0]
        if neg_group:
            negs_g = _sample_negs(key, neg_table, b_local // neg_group,
                                  negative)
            grad_v, u_idx, u_grad, u_w, loss = _sgns_grads_shared(
                syn0, syn1neg, centers, contexts, weights, negs_g)
        else:
            negs = _sample_negs(key, neg_table, b_local, negative)
            grad_v, u_idx, u_grad, u_w, loss = _sgns_grads(
                syn0, syn1neg, centers, contexts, weights, negs)
        g0 = torch.zeros_like(syn0).index_add_(0, centers, grad_v)
        c0 = syn0.new_zeros(syn0.shape[0]).index_add_(0, centers, weights)
        g1 = torch.zeros_like(syn1neg).index_add_(0, u_idx, u_grad)
        c1 = syn0.new_zeros(syn1neg.shape[0]).index_add_(0, u_idx, u_w)
        loss = _reduce_and_apply(mesh, (syn0, syn1neg), (g0, g1), (c0, c1),
                                 loss, lr)
        return syn0, syn1neg, loss

    return step


def make_sharded_hs_step(mesh):
    """Data-parallel hierarchical-softmax step (see
    ``make_sharded_sgns_step``): ``step(syn0, syn1, centers, points,
    codes, mask, weights, lr) -> (syn0, syn1, loss)``, the global batch's
    Huffman paths given per pair.

    A copy of the JAX package's step AS IT IS: syn1's collision counts
    add the path mask alone (``p_msk = mask.reshape(-1)``), where the
    single-device ``_hs_update`` weights them by the pair weight. So a
    padded pair (weight 0) still counts toward its path nodes'
    denominators, and a padded tail's updates of those nodes come out
    smaller than ``_hs_update``'s. tests/test_torch_word2vec_mesh.py pins
    the difference; ROADMAP Queue 3 carries it."""
    n, r = _data_axis(mesh)

    def step(syn0, syn1, centers, points, codes, mask, weights, lr):
        dev = syn0.device
        centers, points, codes, mask, weights = (
            _rows(a, n, r, dev) for a in (centers, points, codes, mask,
                                          weights))
        v = syn0[centers]
        u = syn1[points]
        score = torch.sigmoid(torch.bmm(u, v[:, :, None])[..., 0])
        labels = 1.0 - codes
        g = (score - labels) * mask * weights[:, None]
        grad_v = torch.bmm(g[:, None, :], u)[:, 0]
        grad_u = g[..., None] * v[:, None, :]
        p_idx = points.reshape(-1)
        p_msk = mask.reshape(-1)
        g0 = torch.zeros_like(syn0).index_add_(0, centers, grad_v)
        c0 = syn0.new_zeros(syn0.shape[0]).index_add_(0, centers, weights)
        g1 = torch.zeros_like(syn1).index_add_(
            0, p_idx, grad_u.reshape(-1, grad_u.shape[-1]))
        c1 = syn0.new_zeros(syn1.shape[0]).index_add_(0, p_idx, p_msk)
        loss = -(
            (labels * torch.log(score + _EPS)
             + (1 - labels) * torch.log(1 - score + _EPS))
            * mask * weights[:, None]
        ).sum()
        loss = _reduce_and_apply(mesh, (syn0, syn1), (g0, g1), (c0, c1),
                                 loss, lr)
        return syn0, syn1, loss

    return step


# ----------------------------------------------------------------- model ----

class Word2Vec:
    """Word2Vec on one device: CUDA unless ``device="cpu"``; without a card
    it raises. With ``mesh=`` (a ``parallel.mesh`` mesh with a "data"
    axis) it trains data-parallel over the mesh's ranks on each rank's
    device (``_fit_host_pairs``); ``batch_size`` rounds up to a multiple
    of the data axis."""

    def __init__(
        self,
        sentence_iterator: Optional[SentenceIterator] = None,
        tokenizer_factory: Optional[TokenizerFactory] = None,
        layer_size: int = 50,
        window: int = 5,
        min_word_frequency: int = 1,
        negative: int = 5,
        use_hierarchic_softmax: bool = False,
        lr: float = 0.025,
        min_lr: float = 1e-4,
        iterations: int = 1,
        sample: float = 1e-3,
        batch_size: int = 2048,
        seed: int = 123,
        mesh=None,
        shared_negatives: int = 25,
        device: DeviceLike = None,
    ):
        if mesh is not None and getattr(mesh, "device", None) is not None:
            self.device = mesh.device
        else:
            self.device = resolve_device(device)
        self.sentence_iterator = sentence_iterator
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.layer_size = layer_size
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.negative = negative
        self.use_hs = use_hierarchic_softmax
        if not use_hierarchic_softmax and negative <= 0:
            raise ValueError("need negative sampling and/or hierarchical softmax")
        self.lr = lr
        self.min_lr = min_lr
        self.iterations = iterations
        self.sample = sample
        self.batch_size = batch_size
        self.seed = seed
        # pairs per shared-negative group on the device-epoch path (0 =
        # classic per-pair draws, the reference's posture)
        self.shared_negatives = shared_negatives
        # data-parallel training: pair batches split over the mesh's data
        # axis, embedding updates all-reduced (make_sharded_sgns_step)
        self.mesh = mesh
        if mesh is not None:
            d = _data_axis(mesh)[0]
            if self.batch_size % d:
                self.batch_size += d - self.batch_size % d  # round up to shard evenly
        self.vocab = VocabCache()
        self._lookup_table: Optional[InMemoryLookupTable] = None
        self.total_words_trained = 0
        self.last_fit_timings: dict = {}
        self._flat = np.zeros(0, np.int32)  # cached indexed corpus
        self._sid = np.zeros(0, np.int32)
        self._corpus_dev = None  # device-resident copy, uploaded once
        # Device-resident embeddings carried across fit() calls: the device
        # copy is authoritative after training and the host table syncs
        # lazily on first read (``lookup_table``); ``_host_digest`` records
        # the host arrays' content at the last sync/upload so an external
        # write to the host table between fits is detected and wins (it
        # re-uploads).
        self._syn_dev = None
        self._host_digest = None
        self._table_stale = False  # True: device ahead of host table
        self._neg_table_dev = None   # unigram^0.75 table, uploaded once
        self._hs_tabs_dev = None     # Huffman path tables, uploaded once

    def block_until_ready(self) -> None:
        """Timing fence: block until all pending device-side training on the
        embedding tables has completed (without downloading them — reading
        ``lookup_table`` does that)."""
        if self._syn_dev is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def lookup_table(self) -> Optional[InMemoryLookupTable]:
        """The host-side embedding table (ref: Word2Vec.lookupTable). Reading
        it syncs any pending device-side training first."""
        if self._table_stale:
            self._download_table()
        return self._lookup_table

    @lookup_table.setter
    def lookup_table(self, table: Optional[InMemoryLookupTable]) -> None:
        self._lookup_table = table
        self._table_stale = False
        self._syn_dev = None
        self._host_digest = None

    @staticmethod
    def _to_host(t: Tensor) -> np.ndarray:
        """A read-only host copy (never a view of the trained tensor)."""
        arr = t.detach().to("cpu", copy=True).numpy()
        arr.flags.writeable = False
        return arr

    def _download_table(self) -> None:
        table = self._lookup_table
        syn0, syn1, syn1neg = self._syn_dev
        # download only what the objective trained
        table.syn0 = self._to_host(syn0)
        if self.use_hs:
            table.syn1 = self._to_host(syn1)
        if self.negative > 0:
            table.syn1neg = self._to_host(syn1neg)
        self._table_stale = False
        self._host_digest = self._digest(
            (table.syn0, table.syn1, table.syn1neg))

    # ---- vocab ----
    def build_vocab(self) -> None:
        """Tokenize all sentences, count, prune, Huffman-code
        (ref: Word2Vec.fit vocab phase + Huffman.java), and index the corpus
        once into flat vocab-index arrays."""
        assert self.sentence_iterator is not None, "no sentence iterator configured"
        # When the native fast path is possible (cheap non-consuming
        # guards), materialize the corpus once and feed the same list to
        # both the native attempt and the fallback, so a one-shot iterable
        # is never half consumed by a native attempt that then bails (e.g.
        # on non-ASCII text).
        native = None
        if self._native_path_possible():
            sentences = list(self.sentence_iterator)
            native = self._native_vocab_index(sentences)
        else:
            sentences = self.sentence_iterator
        if native is not None:
            words, counts, self._flat, self._sid = native
            for w, c in zip(words, counts):
                self.vocab.add_token(w, by=int(c))
            self.vocab.finish(self.min_word_frequency)
        else:
            corpus_tokens: List[List[str]] = []
            for sentence in sentences:
                toks = self.tokenizer_factory.create(sentence).get_tokens()
                corpus_tokens.append(toks)
                for tok in toks:
                    self.vocab.add_token(tok)
            self.vocab.finish(self.min_word_frequency)
            # index the cached corpus: one flat array + sentence ids
            index_of = self.vocab.index_of
            sents = []
            for toks in corpus_tokens:
                idx = np.array(
                    [i for i in (index_of(t) for t in toks) if i >= 0],
                    dtype=np.int32)
                if idx.size >= 2:
                    sents.append(idx)
            if sents:
                self._flat = np.concatenate(sents)
                self._sid = np.repeat(np.arange(len(sents), dtype=np.int32),
                                      [s.size for s in sents])
            else:
                self._flat = np.zeros(0, np.int32)
                self._sid = np.zeros(0, np.int32)
        build_huffman(self.vocab)
        self.lookup_table = InMemoryLookupTable(
            self.vocab, self.layer_size, seed=self.seed,
            use_hs=self.use_hs, negative=self.negative,
        )
        self._corpus_dev = None   # new corpus index → re-upload on next fit
        self._neg_table_dev = None  # vocab changed → rebuild sampling tables
        self._hs_tabs_dev = None

    def _native_path_possible(self) -> bool:
        """Non-consuming preconditions for the C++ vocab path: plain
        whitespace tokenizer with no pre-processor and a fresh vocab. The
        native library is built here at first use; a failed build
        raises."""
        from deeplearning4j_tpu_torch.native.lib import native_available

        if type(self.tokenizer_factory) is not DefaultTokenizerFactory:
            return False
        if self.tokenizer_factory.pre_processor is not None:
            return False
        if not self.vocab.is_empty():
            return False  # accumulating into an existing vocab: python path
        return native_available()

    def _native_vocab_index(self, sentences=None):
        """C++ tokenize+count+index fast path (native/text.cpp via
        native/lib.py corpus_index). Applies only when it is provably
        equivalent to the Python path (see _native_path_possible, plus ASCII
        text: byte-wise split/sort == str semantics); returns None otherwise
        and the Python path runs. ``sentences`` is the materialized corpus
        from build_vocab (defaults to the configured iterator for direct
        probing in tests)."""
        from deeplearning4j_tpu_torch.native.lib import corpus_index

        if not self._native_path_possible():
            return None
        if sentences is None:
            sentences = self.sentence_iterator
        try:
            text = "\n".join(
                s.replace("\n", " ") for s in sentences
            ).encode("utf-8", errors="strict")
        except UnicodeEncodeError:
            return None
        return corpus_index(text, self.min_word_frequency)

    @staticmethod
    def _digest(arrays) -> tuple:
        """Cheap content fingerprint of the embedding tables (sha1 over raw
        bytes + shapes) — equality means the host tables are unchanged since
        the last download, so the device copies can be reused."""
        h = hashlib.sha1()
        shapes = []
        for a in arrays:
            a = np.ascontiguousarray(a)
            shapes.append(a.shape)
            h.update(a.tobytes())
        return (h.hexdigest(), tuple(shapes))

    # ---- pair generation (host side) ----
    def _keep_probs(self) -> np.ndarray:
        """Subsampling keep-probability per word (ref: Word2Vec.java:224)."""
        counts = self.vocab.counts()
        if self.sample <= 0:
            return np.ones_like(counts, dtype=np.float64)
        freq = counts / max(self.vocab.total_word_count(), 1)
        return np.minimum(1.0, np.sqrt(self.sample / np.maximum(freq, 1e-12)))

    def _skipgram_pairs(self, sents: Sequence[np.ndarray],
                        rng_: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        """Host (center, context) generation over whole sentences, the
        oracle of the device pair blocks."""
        if not sents:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        flat = np.concatenate(sents).astype(np.int32)
        sid = np.repeat(np.arange(len(sents)), [s.size for s in sents])
        return self._pairs_from_flat(flat, sid, rng_)

    def _pairs_from_flat(self, flat: np.ndarray, sid: np.ndarray,
                         rng_: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        if flat.size < 2:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        # random reduced window per position (word2vec/ref behavior)
        b = rng_.integers(1, self.window + 1, size=flat.size)
        centers: List[np.ndarray] = []
        contexts: List[np.ndarray] = []
        for d in range(1, self.window + 1):
            same = sid[:-d] == sid[d:]  # positions i, i+d in the same sentence
            fwd = same & (b[:-d] >= d)   # i's window reaches i+d
            bwd = same & (b[d:] >= d)    # (i+d)'s window reaches i
            centers.append(flat[:-d][fwd])
            contexts.append(flat[d:][fwd])
            centers.append(flat[d:][bwd])
            contexts.append(flat[:-d][bwd])
        return np.concatenate(centers), np.concatenate(contexts)

    def _neg_table(self) -> Tensor:
        """Device-resident sampling table, built once per vocab."""
        if self._neg_table_dev is None:
            self._neg_table_dev = build_neg_table(
                self._lookup_table.unigram_probs(), device=self.device)
        return self._neg_table_dev

    def _huffman_tables(self):
        """Padded Huffman path matrices (V, L) for the HS objective,
        device-resident, built once per vocab."""
        if self._hs_tabs_dev is not None:
            return self._hs_tabs_dev
        max_len = max((len(w.code) for w in self.vocab.words()), default=1)
        n = self.vocab.num_words()
        pts = np.zeros((n, max_len), np.int64)
        cds = np.zeros((n, max_len), np.float32)
        msk = np.zeros((n, max_len), np.float32)
        for w in self.vocab.words():
            path_len = len(w.code)
            pts[w.index, :path_len] = w.points
            cds[w.index, :path_len] = w.code
            msk[w.index, :path_len] = 1.0
        self._hs_tabs_dev = tuple(torch.from_numpy(a).to(self.device)
                                  for a in (pts, cds, msk))
        return self._hs_tabs_dev

    def _upload(self, a: np.ndarray) -> Tensor:
        """A device tensor of its own (training writes it in place)."""
        return torch.from_numpy(np.array(a, np.float32)).to(self.device)

    # ---- training ----
    def fit(self) -> None:
        """Train. Fills ``last_fit_timings`` with the host-vs-device split:
        host_pairgen_s (host pair generation: 0 on one device, where pairs
        are generated on the device; the mesh path's numpy pair stream),
        host_batch_prep_s (uploads + enqueueing the epochs' device work),
        device_drain_s (time blocked on the final pair count — device work
        not already overlapped with host prep), total_s, n_pairs,
        n_dispatches (device epochs; mesh steps)."""
        if self._lookup_table is None:
            self.build_vocab()
        table = self._lookup_table  # raw: a stale host table must NOT sync
        key = int(self.seed)
        t_fit0 = time.perf_counter()
        self._timings = {"pairgen": 0.0, "prep": 0.0, "dispatches": 0}

        # reuse the previous fit's device-resident embeddings when the host
        # table still matches the content last synced/uploaded; any external
        # change — serializer load, reset_weights, re-assignment — falls
        # back to a fresh upload of the host arrays
        cur = (table.syn0, table.syn1, table.syn1neg)
        if self._syn_dev is not None and self._host_digest is not None and (
            self._digest(cur) == self._host_digest
        ):
            syn0, syn1, syn1neg = self._syn_dev
        else:
            syn0, syn1, syn1neg = (self._upload(a) for a in cur)
            self._host_digest = self._digest(cur)
        # from here a failure loses un-synced device training (the same
        # contract as a crashed in-memory trainer); the table must come back
        # readable either way, so the host table — content as of the last
        # sync/upload — becomes authoritative again
        self._syn_dev = None
        self._table_stale = False
        if self.mesh is None:
            syn0, syn1, syn1neg, pairs_seen = self._fit_device(
                syn0, syn1, syn1neg, key)
        else:
            syn0, syn1, syn1neg, pairs_seen = self._fit_host_pairs(
                syn0, syn1, syn1neg, key)

        t0 = time.perf_counter()
        pairs_seen = int(pairs_seen)  # the fit's one host read: drains the queue
        # the trained tables stay on the device; the host table syncs
        # lazily on the first lookup_table read
        self._syn_dev = (syn0, syn1, syn1neg)
        self._table_stale = True
        # freeze the now-stale host arrays: an in-place write through a
        # retained reference would bypass the property's sync and silently
        # shadow the device-side training — make it fail loudly instead
        for arr in (table.syn0, table.syn1, table.syn1neg):
            if isinstance(arr, np.ndarray) and arr.flags.owndata:
                arr.flags.writeable = False
        t_drain = time.perf_counter() - t0
        self.last_fit_timings = {
            "host_pairgen_s": round(self._timings["pairgen"], 4),
            "host_batch_prep_s": round(self._timings["prep"], 4),
            "device_drain_s": round(t_drain, 4),
            "total_s": round(time.perf_counter() - t_fit0, 4),
            "n_pairs": pairs_seen,
            "n_dispatches": self._timings["dispatches"],
        }
        self.total_words_trained = pairs_seen

    def _fit_device(self, syn0, syn1, syn1neg, key):
        """Every epoch runs on the device over the corpus index uploaded
        once per vocab build; per-epoch host-to-device traffic is the
        (n_steps,) lr schedule."""
        n = int(self._flat.size)
        if n < 2:
            return syn0, syn1, syn1neg, 0
        t0 = time.perf_counter()
        if self._corpus_dev is None:
            self._corpus_dev = tuple(
                torch.from_numpy(a.astype(np.int64)).to(self.device)
                for a in (self._flat, self._sid))
        flat_d, sid_d = self._corpus_dev
        keep_d = torch.from_numpy(
            self._keep_probs().astype(np.float32)).to(self.device)
        neg_table = self._neg_table() if self.negative > 0 else None
        hs_tabs = self._huffman_tables() if self.use_hs else None
        window = self.window
        block = max(-(-self.batch_size // (2 * window)), 1)
        n_steps = -(-n // block)
        iters = max(self.iterations, 1)
        bsz = block * 2 * window
        neg_group = 0
        if self.shared_negatives and self.negative > 0:
            neg_group = neg_group_size(bsz, self.shared_negatives)
        self._timings["prep"] += time.perf_counter() - t0

        pairs_total = None
        for e in range(iters):
            t0 = time.perf_counter()
            # linear lr decay by corpus-position fraction — the device-side
            # equivalent of the reference's words-processed decay
            # (Word2Vec.java:85); positions are words here
            frac = (e * n + np.arange(n_steps) * block) / max(n * iters, 1)
            lrs = np.maximum(self.min_lr,
                             self.lr * (1.0 - np.minimum(frac, 1.0))
                             ).astype(np.float32)
            lrs = torch.from_numpy(lrs).to(self.device)
            if self.negative > 0:
                key, sub = rng.split(key)
                syn0, syn1neg, _, wtot = _sgns_device_epoch(
                    syn0, syn1neg, flat_d, sid_d, keep_d, neg_table, lrs,
                    sub, window=window, negative=self.negative, block=block,
                    n_steps=n_steps, neg_group=neg_group)
                self._timings["dispatches"] += 1
            if self.use_hs:
                key, sub = rng.split(key)
                syn0, syn1, _, wtot = _hs_device_epoch(
                    syn0, syn1, flat_d, sid_d, keep_d, *hs_tabs, lrs, sub,
                    window=window, block=block, n_steps=n_steps)
                self._timings["dispatches"] += 1
            pairs_total = wtot if pairs_total is None else pairs_total + wtot
            self._timings["prep"] += time.perf_counter() - t0
        return syn0, syn1, syn1neg, (0 if pairs_total is None else pairs_total)

    def _subsampled_flat(self, rng_: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        """Per-epoch frequent-word subsampling, vectorized over the cached
        corpus index (ref: Word2Vec.java:224)."""
        flat, sid = self._flat, self._sid
        if self.sample > 0 and flat.size:
            keep = self._keep_probs()
            m = rng_.random(flat.size) < keep[flat]
            flat, sid = flat[m], sid[m]
        return flat, sid

    def _fit_host_pairs(self, syn0, syn1, syn1neg, key):
        """Mesh-sharded training: host-side numpy pair generation from
        ``np.random.default_rng(self.seed)`` (the same stream in both
        packages), the same global batches on every rank, each split over
        the data axis, and the all-reduced updates of
        ``make_sharded_sgns_step`` / ``make_sharded_hs_step``. The tail
        batch is padded with weight 0; lr decays linearly in pairs over
        the whole run; the key splits once per SGNS step."""
        rng_ = np.random.default_rng(self.seed)
        b_local = self.batch_size // _data_axis(self.mesh)[0]
        ng = (neg_group_size(b_local, self.shared_negatives)
              if (self.shared_negatives and self.negative > 0 and b_local)
              else 0)
        sgns_step = make_sharded_sgns_step(self.mesh, self.negative,
                                           neg_group=ng)
        hs_step = make_sharded_hs_step(self.mesh)
        neg_table = self._neg_table() if self.negative > 0 else None
        if self.use_hs:
            pts_d, cds_d, msk_d = self._huffman_tables()

        total_pairs = None  # set from the first epoch's pair count so the
        pairs_seen = 0      # linear decay spans the whole run in PAIR units
        bsz = self.batch_size

        for _ in range(max(self.iterations, 1)):
            t0 = time.perf_counter()
            flat, sid = self._subsampled_flat(rng_)
            centers, contexts = self._pairs_from_flat(flat, sid, rng_)
            n_pairs = centers.shape[0]
            if n_pairs:
                perm = rng_.permutation(n_pairs)
                centers, contexts = centers[perm], contexts[perm]
            self._timings["pairgen"] += time.perf_counter() - t0
            if total_pairs is None:
                total_pairs = max(n_pairs, 1) * max(self.iterations, 1)

            for start in range(0, max(n_pairs, 1), bsz):
                t0 = time.perf_counter()
                c = centers[start:start + bsz]
                t = contexts[start:start + bsz]
                n_real = c.shape[0]
                if n_real == 0:
                    break
                w = np.ones(n_real, np.float32)
                if n_real < bsz:  # pad the tail, mask the padding
                    pad = bsz - n_real
                    c = np.concatenate([c, np.zeros(pad, np.int32)])
                    t = np.concatenate([t, np.zeros(pad, np.int32)])
                    w = np.concatenate([w, np.zeros(pad, np.float32)])
                frac = min(pairs_seen / max(total_pairs, 1), 1.0)
                lr = float(np.float32(max(self.min_lr,
                                          self.lr * (1.0 - frac))))
                cd, td, wd = (torch.from_numpy(a).to(self.device)
                              for a in (c.astype(np.int64),
                                        t.astype(np.int64), w))
                if self.negative > 0:
                    key, sub = rng.split(key)
                    syn0, syn1neg, _ = sgns_step(
                        syn0, syn1neg, cd, td, wd, neg_table, lr, sub)
                if self.use_hs:
                    syn0, syn1, _ = hs_step(
                        syn0, syn1, cd, pts_d[td], cds_d[td], msk_d[td], wd,
                        lr)
                pairs_seen += n_real
                self._timings["prep"] += time.perf_counter() - t0
                self._timings["dispatches"] += 1
        return syn0, syn1, syn1neg, pairs_seen

    # ---- query API (ref: WordVectors interface) ----
    def word_vector(self, word: str) -> Optional[np.ndarray]:
        return self.lookup_table.vector(word) if self.lookup_table else None

    def has_word(self, word: str) -> bool:
        return self.vocab.contains(word)

    def similarity(self, w1: str, w2: str) -> float:
        return cosine_sim(self.word_vector(w1), self.word_vector(w2))

    def words_nearest(self, word: str, n: int = 10) -> List[str]:
        v = self.word_vector(word)
        if v is None:
            return []
        idx = cosine_nearest(self.lookup_table.syn0, v, n,
                             exclude=self.vocab.index_of(word))
        return [self.vocab.word_at(i) for i in idx]
