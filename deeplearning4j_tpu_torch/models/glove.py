"""Counterpart of ``deeplearning4j_tpu/models/glove.py``: GloVe, global
vectors from co-occurrence statistics.

Parity with ref models/glove/ — CoOccurrences (windowed symmetric counts,
CoOccurrences.java), GloveWeightLookupTable (word + bias params with
per-element AdaGrad), Glove.train over the shuffled co-occurrence list
(Glove.java:59,128-158).

The epoch is chunked into fixed-size batches; each batch is one step on
the device — gather both embedding blocks, compute the weighted
least-squares gradient as batched vector math, and apply per-element
AdaGrad with per-row collision normalization through ``index_add_`` (the
same discipline as word2vec). Init and shuffling are numpy-seeded, as in
the JAX package, so the two follow each other to float rounding. Runs on
CUDA unless ``device="cpu"``; without a card it raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.models.embeddings import cosine_nearest, cosine_sim
from deeplearning4j_tpu_torch.text.sentence_iterator import SentenceIterator
from deeplearning4j_tpu_torch.text.tokenization import DefaultTokenizerFactory, TokenizerFactory
from deeplearning4j_tpu_torch.text.vocab import VocabCache


class CoOccurrences:
    """Symmetric windowed co-occurrence counts with 1/distance weighting
    (ref models/glove/CoOccurrences.java)."""

    def __init__(self, window: int = 15):
        self.window = window
        self.counts: Dict[Tuple[int, int], float] = {}

    def add_sentence(self, indices: List[int]) -> None:
        for i, wi in enumerate(indices):
            lo = max(0, i - self.window)
            for j in range(lo, i):
                wj = indices[j]
                weight = 1.0 / (i - j)
                key = (wi, wj) if wi <= wj else (wj, wi)
                self.counts[key] = self.counts.get(key, 0.0) + weight

    def to_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        n = len(self.counts)
        rows = np.empty(n, np.int32)
        cols = np.empty(n, np.int32)
        vals = np.empty(n, np.float32)
        for k, ((i, j), v) in enumerate(self.counts.items()):
            rows[k], cols[k], vals[k] = i, j, v
        return rows, cols, vals


def _glove_step(w, b, hw, hb, rows, cols, logx, fx, weights, lr):
    """One AdaGrad batch for J = Σ f(X)(wᵢ·wⱼ + bᵢ + bⱼ − log X)².
    w: (V,D) vectors, b: (V,) biases, hw/hb: AdaGrad accumulators, all
    updated in place; returns (w, b, hw, hb, loss)."""
    vi, vj = w[rows], w[cols]                       # (B,D)
    diff = (vi * vj).sum(-1) + b[rows] + b[cols] - logx
    g = fx * diff * weights                          # (B,)

    grad_i = g[:, None] * vj
    grad_j = g[:, None] * vi

    idx = torch.cat([rows, cols])
    grads = torch.cat([grad_i, grad_j])
    gb = torch.cat([g, g])
    cnt = torch.zeros(w.shape[0], dtype=w.dtype, device=w.device).index_add_(
        0, idx, torch.cat([weights, weights]))
    norm = cnt.clamp(min=1.0)[idx, None]

    # per-element AdaGrad (ref GloveWeightLookupTable uses AdaGrad); the
    # step reads the accumulators after this batch's add
    hw.index_add_(0, idx, (grads / norm) ** 2)
    hb.index_add_(0, idx, (gb / norm[:, 0]) ** 2)
    w.index_add_(0, idx, -lr * grads / norm / torch.sqrt(hw[idx] + 1e-8))
    b.index_add_(0, idx, -lr * gb / norm[:, 0] / torch.sqrt(hb[idx] + 1e-8))
    loss = 0.5 * (fx * diff * diff * weights).sum()
    return w, b, hw, hb, loss


class Glove:
    """GloVe model (ref models/glove/Glove.java builder surface: layerSize,
    xMax, alpha, learningRate, iterations, window via CoOccurrences)."""

    def __init__(
        self,
        sentence_iterator: Optional[SentenceIterator] = None,
        tokenizer_factory: Optional[TokenizerFactory] = None,
        layer_size: int = 50,
        window: int = 15,
        min_word_frequency: int = 1,
        x_max: float = 100.0,
        alpha: float = 0.75,
        lr: float = 0.05,
        iterations: int = 5,
        batch_size: int = 4096,
        seed: int = 123,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.sentence_iterator = sentence_iterator
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.layer_size = layer_size
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.x_max = x_max
        self.alpha = alpha
        self.lr = lr
        self.iterations = iterations
        self.batch_size = batch_size
        self.seed = seed
        self.vocab = VocabCache()
        self.co = CoOccurrences(window=window)
        self.syn0: Optional[np.ndarray] = None
        self.bias: Optional[np.ndarray] = None
        self.losses: List[float] = []

    def _tokenize(self, sentence: str) -> List[str]:
        return self.tokenizer_factory.create(sentence).get_tokens()

    def build_vocab_and_cooccurrences(self) -> None:
        assert self.sentence_iterator is not None
        sentences = list(self.sentence_iterator)
        for s in sentences:
            for tok in self._tokenize(s):
                self.vocab.add_token(tok)
        self.vocab.finish(self.min_word_frequency)
        for s in sentences:
            idx = [self.vocab.index_of(t) for t in self._tokenize(s)]
            self.co.add_sentence([i for i in idx if i >= 0])

    def fit(self) -> None:
        if self.vocab.num_words() == 0:
            self.build_vocab_and_cooccurrences()
        v, d = self.vocab.num_words(), self.layer_size
        dev = self.device
        rng = np.random.default_rng(self.seed)
        w = torch.from_numpy(
            (rng.random((v, d), np.float32) - 0.5) / d).to(dev)
        b = torch.zeros(v, dtype=torch.float32, device=dev)
        hw = torch.zeros((v, d), dtype=torch.float32, device=dev)
        hb = torch.zeros(v, dtype=torch.float32, device=dev)

        rows, cols, vals = self.co.to_arrays()
        logx = np.log(np.maximum(vals, 1e-12)).astype(np.float32)
        fx = np.minimum((vals / self.x_max) ** self.alpha, 1.0).astype(np.float32)
        n = len(rows)
        bsz = min(self.batch_size, max(n, 1))
        lr = float(np.float32(self.lr))

        def up(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(dev)

        shuffle_rng = np.random.default_rng(self.seed + 1)
        self.losses = []
        for _ in range(self.iterations):
            perm = shuffle_rng.permutation(n)
            # the epoch loss accumulates on the device: one host read an
            # epoch, not one a batch
            epoch_loss = None
            for start in range(0, n, bsz):
                sl = perm[start : start + bsz]
                wt = np.ones(len(sl), np.float32)
                if len(sl) < bsz:
                    pad = bsz - len(sl)
                    sl = np.concatenate([sl, np.zeros(pad, np.int64)])
                    wt = np.concatenate([wt, np.zeros(pad, np.float32)])
                w, b, hw, hb, loss = _glove_step(
                    w, b, hw, hb,
                    up(rows[sl].astype(np.int64)),
                    up(cols[sl].astype(np.int64)),
                    up(logx[sl]), up(fx[sl]), up(wt), lr,
                )
                epoch_loss = loss if epoch_loss is None else epoch_loss + loss
            self.losses.append(
                0.0 if epoch_loss is None else float(epoch_loss))
        self.syn0 = w.cpu().numpy()
        self.bias = b.cpu().numpy()

    # ---- query API ----
    def word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        return None if i < 0 or self.syn0 is None else self.syn0[i]

    def similarity(self, w1: str, w2: str) -> float:
        return cosine_sim(self.word_vector(w1), self.word_vector(w2))

    def words_nearest(self, word: str, n: int = 10) -> List[str]:
        v = self.word_vector(word)
        if v is None:
            return []
        idx = cosine_nearest(self.syn0, v, n, exclude=self.vocab.index_of(word))
        return [self.vocab.word_at(i) for i in idx]
