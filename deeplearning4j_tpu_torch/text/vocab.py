"""Counterpart of ``deeplearning4j_tpu/text/vocab.py``, copied whole
(numpy only).

Vocabulary cache + Huffman coding.

Parity with ref: models/word2vec/wordstore/ (VocabCache/InMemoryLookupCache —
word→index, counts) and models/word2vec/Huffman.java (binary Huffman tree over
word frequencies producing per-word codes and inner-node point paths for
hierarchical softmax).
"""

from __future__ import annotations

import heapq
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np


class VocabWord:
    """(ref: models/word2vec/VocabWord — word, count, huffman code/points)."""

    __slots__ = ("word", "count", "index", "code", "points")

    def __init__(self, word: str, count: int = 0, index: int = -1):
        self.word = word
        self.count = count
        self.index = index
        self.code: List[int] = []
        self.points: List[int] = []

    def __repr__(self):
        return f"VocabWord({self.word!r}, count={self.count}, index={self.index})"


class VocabCache:
    """Word store, sorted by descending frequency (index 0 = most frequent)."""

    def __init__(self):
        self._words: Dict[str, VocabWord] = {}
        self._index: List[VocabWord] = []

    def add_token(self, word: str, by: int = 1) -> None:
        vw = self._words.get(word)
        if vw is None:
            vw = VocabWord(word)
            self._words[word] = vw
        vw.count += by

    def finish(self, min_word_frequency: int = 1) -> None:
        """Prune rare words, assign indices by descending count."""
        kept = [w for w in self._words.values() if w.count >= min_word_frequency]
        kept.sort(key=lambda w: (-w.count, w.word))
        self._words = {w.word: w for w in kept}
        self._index = kept
        for i, w in enumerate(kept):
            w.index = i

    def contains(self, word: str) -> bool:
        return word in self._words

    def is_empty(self) -> bool:
        """True when no tokens have been added (finished or not)."""
        return not self._words and not self._index

    def word_for(self, word: str) -> Optional[VocabWord]:
        return self._words.get(word)

    def index_of(self, word: str) -> int:
        vw = self._words.get(word)
        return vw.index if vw else -1

    def word_at(self, index: int) -> str:
        return self._index[index].word

    def num_words(self) -> int:
        return len(self._index)

    def words(self) -> List[VocabWord]:
        return list(self._index)

    def total_word_count(self) -> int:
        return sum(w.count for w in self._index)

    def counts(self) -> np.ndarray:
        return np.array([w.count for w in self._index], dtype=np.float64)


def build_huffman(vocab: VocabCache) -> None:
    """Assign Huffman codes/points to every vocab word
    (ref: models/word2vec/Huffman.java buildTree; called from Word2Vec.java:353).

    code[i] ∈ {0,1} per tree level; points = inner-node indices along the path
    (offsets into syn1 for hierarchical softmax).
    """
    words = vocab.words()
    n = len(words)
    if n == 0:
        return
    # heap of (count, tiebreak, node_id); leaves are 0..n-1, inner n..2n-2
    heap: List[Tuple[int, int, int]] = [(w.count, i, i) for i, w in enumerate(words)]
    heapq.heapify(heap)
    parent = np.zeros(2 * n, dtype=np.int64)
    binary = np.zeros(2 * n, dtype=np.int8)
    next_id = n
    while len(heap) > 1:
        c1, _, n1 = heapq.heappop(heap)
        c2, _, n2 = heapq.heappop(heap)
        parent[n1] = next_id
        parent[n2] = next_id
        binary[n2] = 1
        heapq.heappush(heap, (c1 + c2, next_id, next_id))
        next_id += 1
    root = next_id - 1
    for i, w in enumerate(words):
        code: List[int] = []
        points: List[int] = []
        node = i
        while node != root:
            code.append(int(binary[node]))
            node = int(parent[node])
            points.append(node - n)  # inner-node index (syn1 row)
        w.code = code[::-1]
        w.points = points[::-1]
