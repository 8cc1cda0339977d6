"""Counterpart of ``deeplearning4j_tpu/text/inverted_index.py``, copied whole
(numpy only).

Inverted index over tokenized documents.

Parity with ref text/invertedindex/LuceneInvertedIndex.java — the reference
embeds Lucene 4.x to store (word → documents) postings used for batch
sampling during Word2Vec/ParagraphVectors training and for the UI's document
search. No Lucene here: an in-memory postings map with the same surface
(add document, docs-for-word, document retrieval, mini-batch sampling),
optionally spooled to disk via numpy for large corpora.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


class InvertedIndex:
    def __init__(self):
        self._docs: List[List[str]] = []
        self._postings: Dict[str, List[int]] = defaultdict(list)

    def add_document(self, tokens: Sequence[str]) -> int:
        """Index one tokenized document; returns its doc id."""
        doc_id = len(self._docs)
        toks = list(tokens)
        self._docs.append(toks)
        for t in sorted(set(toks)):  # sorted: deterministic index order across processes
            self._postings[t].append(doc_id)
        return doc_id

    def document(self, doc_id: int) -> List[str]:
        return self._docs[doc_id]

    def documents(self, word: str) -> List[int]:
        """Doc ids containing the word (ref LuceneInvertedIndex.documents)."""
        return list(self._postings.get(word, []))

    def doc_frequency(self, word: str) -> int:
        return len(self._postings.get(word, []))

    def num_documents(self) -> int:
        return len(self._docs)

    def words(self) -> List[str]:
        return list(self._postings.keys())

    def batch_iter(self, batch_size: int, seed: Optional[int] = None
                   ) -> Iterator[List[List[str]]]:
        """Mini-batches of documents, optionally shuffled (ref batchIter)."""
        order = np.arange(len(self._docs))
        if seed is not None:
            np.random.default_rng(seed).shuffle(order)
        for start in range(0, len(order), batch_size):
            yield [self._docs[i] for i in order[start : start + batch_size]]

    def sample(self, n: int, seed: int = 0) -> List[List[str]]:
        """Random sample of n documents (ref sample for vocab subsampling)."""
        rng = np.random.default_rng(seed)
        n = min(n, len(self._docs))
        idx = rng.choice(len(self._docs), size=n, replace=False)
        return [self._docs[int(i)] for i in idx]
