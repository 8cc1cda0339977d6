"""Counterpart of ``deeplearning4j_tpu/models/rntn.py``: the Recursive
Neural Tensor Network (Socher-style sentiment).

Parity with ref models/rntn/RNTN.java:81-99,250-285,366-400 (1,412 LoC):
binary tensor composition p = f([l;r]ᵀ V [l;r] + W [l;r]), per-node softmax
classification, per-parameter AdaGrad, ``fit(List[Tree])`` over parse trees,
and RNTNEval-style per-node accuracy.

Every tree is linearized (nn/tree.py) into fixed-shape (leaf_ids, merges,
labels) arrays padded to power-of-two buckets, exactly as in the JAX
package. A bucket evaluates as one host loop over its merge steps; each
step is batched over the bucket's trees (what JAX's ``vmap`` of a
``lax.scan`` computes) and writes the node buffer out of place, so
autograd sees every step's input unmodified. No Pallas kernel lies on
this path in the JAX package, and none is written here: a merge step is
a handful of torch operations. The loss is differentiated
with autograd and AdaGrad runs on the device. Init is numpy-seeded, so
both packages start from the same parameters. Runs on CUDA unless
``device="cpu"``; without a card it raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.nn.tree import Tree, linearize

UNK = "*UNK*"
PARAM_KEYS = ("emb", "V", "W", "b", "Ws", "bs")
_ADAGRAD_EPS = 1e-8


def _forward_tree(params, leaf_ids, merges, merge_mask,
                  n_leaves_max: int) -> torch.Tensor:
    """Node states of a bucket of trees: (B, S, D) with
    S = n_leaves_max + merges.shape[1].

    ``leaf_ids`` (B, n_leaves_max), ``merges`` (B, M, 3) rows of
    [left, right, out] slots, ``merge_mask`` (B, M) False on padded
    merges (which point at slot 0 and leave it as it was).

    The buffer is one (B·S + 1, D) matrix, tree-major. A merge step reads
    both children of every tree with one ``index_select`` (rows ordered
    left, right per tree, so the (B, 2D) view is ``[l; r]``) and writes
    its outputs with an out-of-place ``index_copy``; a padded merge writes
    to the extra last row, which nothing reads, so slot 0 keeps its
    value. Both ops' backward passes are index ops without a sort."""
    emb, V, W, b = params["emb"], params["V"], params["W"], params["b"]
    n_trees, n_merges = merges.shape[0], merges.shape[1]
    d = emb.shape[1]
    n_slots = n_leaves_max + n_merges
    buf = torch.cat([emb[leaf_ids[:, :n_leaves_max]],
                     emb.new_zeros((n_trees, n_merges, d))], dim=1)
    flat = torch.cat([buf.reshape(n_trees * n_slots, d),
                      emb.new_zeros((1, d))])
    base = (torch.arange(n_trees, device=emb.device) * n_slots)[:, None]
    trash = n_trees * n_slots
    # (M, 2B) child rows and (M, B) output rows, one contiguous row a step
    children = (base[:, :, None] + merges[:, :, :2]).transpose(0, 1)
    children = children.reshape(n_merges, 2 * n_trees).contiguous()
    outs = torch.where(merge_mask, base + merges[:, :, 2], trash)
    outs = outs.transpose(0, 1).contiguous()
    # V as one (2D, D·2D) matrix: tensor_d = lr · (V_d lr)
    v_mat = V.permute(1, 0, 2).reshape(2 * d, d * 2 * d)
    for s in range(n_merges):
        lr = flat.index_select(0, children[s]).view(n_trees, 2 * d)
        tensor = ((lr @ v_mat).view(n_trees, d, 2 * d)
                  * lr[:, None, :]).sum(-1)
        p = torch.tanh(tensor + lr @ W.T + b)
        flat = flat.index_copy(0, outs[s], p)  # out of place
    return flat[:trash].view(n_trees, n_slots, d)


def _bucket_nll(params, leaf_ids, merges, merge_mask, labels, slot_mask):
    """(sum of per-node softmax cross-entropies over the bucket's labelled
    slots, number of labelled slots)."""
    buf = _forward_tree(params, leaf_ids, merges, merge_mask,
                        leaf_ids.shape[1])
    logits = buf @ params["Ws"] + params["bs"]  # (B, S, C)
    logp = torch.log_softmax(logits, dim=-1)
    safe = labels.clamp_min(0).long()
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    mask = slot_mask & (labels >= 0)
    return (nll * mask).sum(), mask.sum()


def _rntn_batch_step(params, hist, leaf_ids, merges, merge_mask, labels,
                     slot_mask, lr: float, l2: float):
    """One AdaGrad step on a bucket of trees: ``(new_params, new_hist,
    loss)``, the loss a 0-dim tensor on the device."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        total, n = _bucket_nll(leaves, leaf_ids, merges, merge_mask, labels,
                               slot_mask)
        reg = sum((leaves[k] * leaves[k]).sum() for k in ("V", "W", "Ws"))
        loss = total / n.clamp_min(1) + 0.5 * l2 * reg
        keys = list(leaves)
        grads = dict(zip(keys, torch.autograd.grad(
            loss, [leaves[k] for k in keys], allow_unused=True,
            materialize_grads=True)))
    new_params, new_hist = {}, {}
    with torch.no_grad():
        # per-parameter AdaGrad (ref RNTN uses AdaGrad per param,
        # RNTN.java:250+); the epsilon sits inside the square root. Python
        # scalars take the params' dtype, as JAX's weakly typed ones do
        for k in keys:
            g = grads[k]
            h = hist[k] + g * g
            new_params[k] = params[k] - lr * g / torch.sqrt(
                h + _ADAGRAD_EPS)
            new_hist[k] = h
    return new_params, new_hist, loss.detach()


class RNTN:
    """Recursive neural tensor network over binarized parse trees."""

    def __init__(
        self,
        num_hidden: int = 25,
        num_classes: int = 5,
        lr: float = 0.1,
        l2: float = 1e-4,
        iterations: int = 10,
        seed: int = 123,
        device: DeviceLike = None,
    ):
        self.d = num_hidden
        self.num_classes = num_classes
        self.lr = lr
        self.l2 = l2
        self.iterations = iterations
        self.seed = seed
        self.device = resolve_device(device)
        self.word_index: Dict[str, int] = {UNK: 0}
        self.params: Optional[Dict[str, np.ndarray]] = None
        self.losses: List[float] = []

    # ---- vocab ----
    def _build_vocab(self, trees: Sequence[Tree]) -> None:
        for t in trees:
            for w in t.yield_words():
                if w not in self.word_index:
                    self.word_index[w] = len(self.word_index)

    def _init_params(self) -> Dict[str, np.ndarray]:
        """The JAX package's draws: numpy-seeded, host arrays."""
        d, c, v = self.d, self.num_classes, len(self.word_index)
        rng = np.random.default_rng(self.seed)

        def u(*shape, scale):
            return ((rng.random(shape) - 0.5) * 2 * scale).astype(np.float32)

        return {
            "emb": u(v, d, scale=0.1),
            "V": u(d, 2 * d, 2 * d, scale=1.0 / (2 * d)),
            "W": u(d, 2 * d, scale=1.0 / np.sqrt(2 * d)),
            "b": np.zeros((d,), np.float32),
            "Ws": u(d, c, scale=1.0 / np.sqrt(d)),
            "bs": np.zeros((c,), np.float32),
        }

    # ---- bucketing ----
    @staticmethod
    def _bucket(n: int) -> int:
        b = 4
        while b < n:
            b *= 2
        return b

    def _prepare(self, trees: Sequence[Tree]):
        """Linearize + pad each tree; group by (leaf_bucket, merge_bucket).
        Host arrays, as the JAX package builds them."""
        buckets: Dict[Tuple[int, int], List] = {}
        for t in trees:
            bt = t.binarize()
            leaf_ids, merges, labels = linearize(
                bt, self.word_index, unk_index=0
            )
            nl, nm = len(leaf_ids), len(merges)
            lb, mb = self._bucket(nl), self._bucket(max(nm, 1))
            pl = np.zeros(lb, np.int32)
            pl[:nl] = leaf_ids
            pm = np.zeros((mb, 3), np.int32)  # padded rows hit slot 0, masked
            mm = np.zeros(mb, bool)
            mm[:nm] = True
            slots = lb + mb
            lbl = np.full(slots, -1, np.int32)
            sm = np.zeros(slots, bool)
            # real slots: leaves 0..nl-1 and merge outputs lb..lb+nm-1
            lbl[:nl] = labels[:nl]
            lbl[lb : lb + nm] = labels[nl : nl + nm]
            sm[:nl] = True
            sm[lb : lb + nm] = True
            # remap merge child/out indices past the leaf padding
            if nm:
                pm[:nm] = np.where(merges >= nl, merges - nl + lb, merges)
            buckets.setdefault((lb, mb), []).append((pl, pm, mm, lbl, sm))
        out = []
        for key, items in sorted(buckets.items()):
            leaf = np.stack([i[0] for i in items])
            mrg = np.stack([i[1] for i in items])
            mmask = np.stack([i[2] for i in items])
            lbls = np.stack([i[3] for i in items])
            smask = np.stack([i[4] for i in items])
            out.append((leaf, mrg, mmask, lbls, smask))
        return out

    def _on_device(self, batch) -> Tuple[torch.Tensor, ...]:
        leaf, mrg, mmask, lbls, smask = batch
        dev = self.device
        return (torch.from_numpy(leaf).long().to(dev),
                torch.from_numpy(mrg).long().to(dev),
                torch.from_numpy(mmask).to(dev),
                torch.from_numpy(lbls).to(dev),
                torch.from_numpy(smask).to(dev))

    # ---- training ----
    def fit(self, trees: Sequence[Tree]) -> None:
        from deeplearning4j_tpu_torch.interop import rntn_params_from_numpy

        self._build_vocab(trees)
        params = rntn_params_from_numpy(self._init_params(), self.device)
        hist = {k: torch.zeros_like(v) for k, v in params.items()}
        # every bucket goes to the device once, before the first epoch
        batches = [self._on_device(b) for b in self._prepare(trees)]
        self.losses = []
        for _ in range(self.iterations):
            # the epoch loss is summed on the device: one host read per
            # epoch, not one per bucket, so the steps queue without waiting
            epoch = None
            for leaf, mrg, mmask, lbls, smask in batches:
                params, hist, loss = _rntn_batch_step(
                    params, hist, leaf, mrg, mmask, lbls, smask,
                    self.lr, self.l2,
                )
                epoch = loss if epoch is None else epoch + loss
            self.losses.append(0.0 if epoch is None else float(epoch))
        self.params = {k: v.cpu().numpy() for k, v in params.items()}

    # ---- inference ----
    def predict_nodes(self, tree: Tree) -> Tuple[np.ndarray, np.ndarray]:
        """(predicted labels, gold labels) for every labeled slot of the tree,
        leaves first then merges bottom-up (RNTNEval surface)."""
        from deeplearning4j_tpu_torch.interop import rntn_params_from_numpy

        assert self.params is not None, "fit first"
        bt = tree.binarize()
        leaf_ids, merges, labels = linearize(bt, self.word_index, 0)
        params = rntn_params_from_numpy(self.params, self.device)
        pm = merges if len(merges) else np.zeros((1, 3), np.int32)
        mm = np.full(len(pm), len(merges) > 0)
        dev = self.device
        with torch.no_grad():
            buf = _forward_tree(
                params, torch.from_numpy(leaf_ids[None]).long().to(dev),
                torch.from_numpy(pm[None]).long().to(dev),
                torch.from_numpy(mm[None]).to(dev), len(leaf_ids))[0]
            logits = (buf @ params["Ws"] + params["bs"]).cpu().numpy()
        n_real = len(leaf_ids) + len(merges)
        preds = logits[:n_real].argmax(1)
        return preds, labels

    def predict_root(self, tree: Tree) -> int:
        preds, _ = self.predict_nodes(tree)
        return int(preds[-1])


class RNTNEval:
    """Per-node and root accuracy over a tree set (ref RNTNEval.java)."""

    def __init__(self):
        self.node_correct = 0
        self.node_total = 0
        self.root_correct = 0
        self.root_total = 0

    def eval(self, model: RNTN, trees: Sequence[Tree]) -> None:
        for t in trees:
            preds, gold = model.predict_nodes(t)
            mask = gold >= 0
            self.node_correct += int((preds[mask] == gold[mask]).sum())
            self.node_total += int(mask.sum())
            if t.label is not None:
                self.root_total += 1
                self.root_correct += int(preds[-1] == t.label)

    def node_accuracy(self) -> float:
        return self.node_correct / max(self.node_total, 1)

    def root_accuracy(self) -> float:
        return self.root_correct / max(self.root_total, 1)

    def stats(self) -> str:
        return (f"RNTN eval: node acc {self.node_accuracy():.4f} "
                f"({self.node_correct}/{self.node_total}), root acc "
                f"{self.root_accuracy():.4f} ({self.root_correct}/{self.root_total})")
