"""Counterpart of ``deeplearning4j_tpu/models/paragraph_vectors.py``:
ParagraphVectors (doc2vec, PV-DBOW).

Parity with ref models/paragraphvectors/ParagraphVectors.java:55,167-204 —
extends Word2Vec; after (optional) word training, dbow() trains one vector
per document label to predict the words the document contains.

(doc, word) pairs batch through Word2Vec's negative-sampling step
(``word2vec._sgns_step``, per-pair negatives through its draw point
``_neg_slots``), with the doc-vector matrix standing in for syn0; the word
output embeddings syn1neg are shared with the word model, trained jointly
during the doc phase as the reference does, and written back to the
lookup table after dbow. Keys split as JAX's do (``seed + 11``, one split
a batch).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.embeddings import cosine_nearest, cosine_sim
from deeplearning4j_tpu_torch.models.word2vec import Word2Vec, _sgns_step
from deeplearning4j_tpu_torch.ops import rng
from deeplearning4j_tpu_torch.text.sentence_iterator import CollectionSentenceIterator


class ParagraphVectors(Word2Vec):
    """PV-DBOW over labeled documents. ``documents`` is a sequence of
    (label, text) pairs (ref LabelledDocument + LabelsSource)."""

    def __init__(self, documents: Sequence[Tuple[str, str]],
                 train_words: bool = True, **kwargs):
        self.documents = list(documents)
        self.train_words = train_words
        self.labels: List[str] = [lab for lab, _ in self.documents]
        self.doc_vectors: Optional[np.ndarray] = None
        kwargs.setdefault("negative", 5)
        super().__init__(
            sentence_iterator=CollectionSentenceIterator(
                [text for _, text in self.documents]
            ),
            **kwargs,
        )
        if not self.negative:
            raise ValueError("PV-DBOW here requires negative sampling")

    def fit(self) -> None:
        if self.lookup_table is None:
            self.build_vocab()
        if self.train_words:
            super().fit()  # skip-gram word phase (ref trainWordVectors flag)
        self._dbow()

    def _dbow(self) -> None:
        """PV-DBOW: each document's vector predicts its words
        (ref ParagraphVectors.dbow, :167-204)."""
        rng_np = np.random.default_rng(self.seed + 7)
        n_docs = len(self.documents)
        d = self.layer_size
        doc_vecs = self._upload(
            ((rng_np.random((n_docs, d)) - 0.5) / d).astype(np.float32))
        syn1neg = self._upload(self.lookup_table.syn1neg)
        neg_table = self._neg_table()  # shared with the word phase

        # (doc, word) pairs
        docs_idx: List[int] = []
        words_idx: List[int] = []
        for di, (_, text) in enumerate(self.documents):
            for tok in self.tokenizer_factory.create(text).get_tokens():
                wi = self.vocab.index_of(tok)
                if wi >= 0:
                    docs_idx.append(di)
                    words_idx.append(wi)
        centers = np.asarray(docs_idx, np.int64)
        contexts = np.asarray(words_idx, np.int64)
        n_pairs = len(centers)
        if n_pairs == 0:
            self.doc_vectors = self._to_host(doc_vecs)
            return
        bsz = min(self.batch_size, n_pairs)

        def up(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(self.device)

        key = self.seed + 11
        total = n_pairs * max(self.iterations, 1)
        seen = 0
        for _ in range(max(self.iterations, 1)):
            perm = rng_np.permutation(n_pairs)
            for start in range(0, n_pairs, bsz):
                sl = perm[start : start + bsz]
                c, t = centers[sl], contexts[sl]
                w = np.ones(len(sl), np.float32)
                if len(sl) < bsz:
                    pad = bsz - len(sl)
                    c = np.concatenate([c, np.zeros(pad, np.int64)])
                    t = np.concatenate([t, np.zeros(pad, np.int64)])
                    w = np.concatenate([w, np.zeros(pad, np.float32)])
                lr = float(np.float32(
                    max(self.min_lr, self.lr * (1.0 - seen / total))))
                key, sub = rng.split(key)
                doc_vecs, syn1neg, _ = _sgns_step(
                    doc_vecs, syn1neg, up(c), up(t), up(w), neg_table, lr,
                    sub, self.negative,
                )
                seen += int(w.sum())
        self.doc_vectors = self._to_host(doc_vecs)
        self.lookup_table.syn1neg = self._to_host(syn1neg)

    # ---- query API ----
    def doc_vector(self, label: str) -> Optional[np.ndarray]:
        try:
            return self.doc_vectors[self.labels.index(label)]
        except (ValueError, TypeError):
            return None

    def similarity_docs(self, l1: str, l2: str) -> float:
        return cosine_sim(self.doc_vector(l1), self.doc_vector(l2))

    def nearest_docs(self, label: str, n: int = 5) -> List[str]:
        v = self.doc_vector(label)
        if v is None:
            return []
        idx = cosine_nearest(self.doc_vectors, v, n,
                             exclude=self.labels.index(label))
        return [self.labels[i] for i in idx]
