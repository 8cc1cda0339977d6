"""Counterpart of ``deeplearning4j_tpu/text/vectorizers.py``, copied whole
(numpy only).

Bag-of-words and TF-IDF text vectorizers.

Parity with ref bagofwords/vectorizer/ — BagOfWordsVectorizer (term counts)
and TfidfVectorizer (tf·idf weights), both producing (docs × vocab) matrices
plus a label column for classifier training (ref TextVectorizer.vectorize).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.text.tokenization import DefaultTokenizerFactory, TokenizerFactory
from deeplearning4j_tpu_torch.text.vocab import VocabCache


class BagOfWordsVectorizer:
    """Counts-per-term document vectors (ref BagOfWordsVectorizer.java)."""

    def __init__(self, tokenizer_factory: Optional[TokenizerFactory] = None,
                 min_word_frequency: int = 1):
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.min_word_frequency = min_word_frequency
        self.vocab = VocabCache()

    def _tokens(self, text: str) -> List[str]:
        return self.tokenizer_factory.create(text).get_tokens()

    def fit(self, documents: Sequence[str]) -> "BagOfWordsVectorizer":
        # tokenize each document exactly once; the lists are reused by the
        # tf-idf subclass's df pass and by fit_transform, then released
        self._fit_tokens = [self._tokens(doc) for doc in documents]
        for toks in self._fit_tokens:
            for tok in toks:
                self.vocab.add_token(tok)
        self.vocab.finish(self.min_word_frequency)
        return self

    def _count_matrix(self, token_lists: Sequence[List[str]]) -> np.ndarray:
        out = np.zeros((len(token_lists), self.vocab.num_words()), np.float32)
        for r, toks in enumerate(token_lists):
            for tok in toks:
                i = self.vocab.index_of(tok)
                if i >= 0:
                    out[r, i] += 1.0
        return out

    def _postprocess(self, counts: np.ndarray) -> np.ndarray:
        return counts

    def transform(self, documents: Sequence[str]) -> np.ndarray:
        return self._postprocess(
            self._count_matrix([self._tokens(d) for d in documents])
        )

    def fit_transform(self, documents: Sequence[str]) -> np.ndarray:
        self.fit(documents)
        m = self._postprocess(self._count_matrix(self._fit_tokens))
        self._fit_tokens = None  # release the cached corpus
        return m

    def vectorize(self, text: str, label: Optional[int] = None,
                  num_labels: Optional[int] = None
                  ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Single-document vector + optional one-hot label
        (ref TextVectorizer.vectorize(String, String))."""
        features = self.transform([text])[0]
        if label is None:
            return features, None
        onehot = np.zeros(num_labels or (label + 1), np.float32)
        onehot[label] = 1.0
        return features, onehot


class TfidfVectorizer(BagOfWordsVectorizer):
    """tf·idf document vectors (ref TfidfVectorizer.java). idf uses the
    smoothed log(N / (1 + df)) variant."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.idf: Optional[np.ndarray] = None

    def fit(self, documents: Sequence[str]) -> "TfidfVectorizer":
        super().fit(documents)
        v = self.vocab.num_words()
        df = np.zeros(v, np.float64)
        for toks in self._fit_tokens:
            seen = {self.vocab.index_of(t) for t in toks}
            for i in seen:
                if i >= 0:
                    df[i] += 1.0
        self.idf = np.log(len(documents) / (1.0 + df)).astype(np.float32) + 1.0
        return self

    def _postprocess(self, counts: np.ndarray) -> np.ndarray:
        assert self.idf is not None, "fit first"
        totals = np.maximum(counts.sum(axis=1, keepdims=True), 1.0)
        return (counts / totals) * self.idf[None, :]
