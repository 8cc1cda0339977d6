"""Counterpart of ``deeplearning4j_tpu/models/embeddings.py``, copied
whole (numpy only): the numpy-seeded init gives the same ``syn0`` as
JAX's, and files written by either package load in the other.

Embedding lookup table + serialization.

Parity with ref: models/embeddings/inmemory/InMemoryLookupTable.java:51-66
(syn0/syn1 for hierarchical softmax, syn1neg + unigram table for negative
sampling) and models/embeddings/loader/WordVectorSerializer.java (word2vec
text format round-trip).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.text.vocab import VocabCache, VocabWord

UNIGRAM_TABLE_SIZE = 1 << 20
UNIGRAM_POWER = 0.75

class InMemoryLookupTable:
    """Host-resident master copy of the embedding matrices; device copies are
    made per training run and carried across fits (models.word2vec)."""

    def __init__(self, vocab: VocabCache, layer_size: int, seed: int = 123,
                 use_hs: bool = True, negative: int = 0):
        self.vocab = vocab
        self.layer_size = layer_size
        self.use_hs = use_hs
        self.negative = negative
        rng = np.random.default_rng(seed)
        n = vocab.num_words()
        # ref resetWeights: syn0 ~ U(-0.5,0.5)/layerSize, syn1 zeros.
        # Only the matrices the chosen objective needs are allocated (a
        # 1M-word vocab at D=300 would waste ~1.2 GB otherwise).
        self.syn0 = ((rng.random((n, layer_size)) - 0.5) / layer_size).astype(np.float32)
        self.syn1 = (np.zeros((max(n - 1, 1), layer_size), dtype=np.float32)
                     if use_hs else np.zeros((1, layer_size), dtype=np.float32))
        self.syn1neg = (np.zeros((n, layer_size), dtype=np.float32)
                        if negative > 0 else np.zeros((1, layer_size), dtype=np.float32))
        self._unigram: Optional[np.ndarray] = None

    def unigram_probs(self) -> np.ndarray:
        """Unigram^0.75 sampling distribution (ref: InMemoryLookupTable table)."""
        if self._unigram is None:
            counts = self.vocab.counts() ** UNIGRAM_POWER
            self._unigram = (counts / counts.sum()).astype(np.float32)
        return self._unigram

    def vector(self, word: str) -> Optional[np.ndarray]:
        idx = self.vocab.index_of(word)
        return None if idx < 0 else self.syn0[idx]

# ------------------------------------------------------------ serializer ----

def write_word_vectors(table: InMemoryLookupTable, path: str) -> None:
    """word2vec text format: header 'V D', then 'word f f f ...'
    (ref: WordVectorSerializer.writeWordVectors)."""
    with open(path, "w", encoding="utf-8") as f:
        n, d = table.syn0.shape
        f.write(f"{n} {d}\n")
        for i in range(n):
            vec = " ".join(f"{x:.6f}" for x in table.syn0[i])
            f.write(f"{table.vocab.word_at(i)} {vec}\n")

def load_word_vectors(path: str) -> Tuple[VocabCache, np.ndarray]:
    """(ref: WordVectorSerializer.loadTxtVectors). Vocab indices follow file
    order (which write_word_vectors emits in index order)."""
    vocab = VocabCache()
    vecs: List[np.ndarray] = []
    with open(path, "r", encoding="utf-8") as f:
        header = f.readline().split()
        n, d = int(header[0]), int(header[1])
        for i, line in enumerate(f):
            # split from the right: the last d tokens are floats, the rest is
            # the word (which may itself contain spaces, e.g. n-gram tokens)
            parts = line.rstrip().split(" ")
            word = " ".join(parts[: len(parts) - d])
            vw = VocabWord(word, count=1, index=i)
            vocab._words[vw.word] = vw
            vocab._index.append(vw)
            vecs.append(np.array([float(x) for x in parts[len(parts) - d:]], np.float32))
    mat = np.stack(vecs) if vecs else np.zeros((0, d), np.float32)
    assert mat.shape == (n, d), f"header {(n, d)} vs data {mat.shape}"
    return vocab, mat

def write_word_vectors_binary(table: InMemoryLookupTable, path: str) -> None:
    """Classic word2vec binary format: ascii header 'V D\\n', then per word
    'word ' + D little-endian float32 + '\\n'
    (ref: WordVectorSerializer binary path, loadGoogleModel)."""
    n, d = table.syn0.shape
    with open(path, "wb") as f:
        f.write(f"{n} {d}\n".encode("utf-8"))
        for i in range(n):
            word = table.vocab.word_at(i)
            if " " in word or "\n" in word:
                raise ValueError(
                    f"binary word2vec format cannot represent token {word!r} "
                    "(contains whitespace); use write_word_vectors (text) instead"
                )
            f.write(word.encode("utf-8") + b" ")
            f.write(table.syn0[i].astype("<f4").tobytes())
            f.write(b"\n")

def load_word_vectors_binary(path: str) -> Tuple[VocabCache, np.ndarray]:
    """Load the word2vec binary format (ref: WordVectorSerializer.loadGoogleModel
    with binary=true)."""
    vocab = VocabCache()
    with open(path, "rb") as f:
        header = f.readline().decode("utf-8").split()
        n, d = int(header[0]), int(header[1])
        mat = np.empty((n, d), np.float32)
        for i in range(n):
            # skip any leading whitespace, then scan the word up to ' ' —
            # tolerates files both with and without per-record newlines
            # (gensim writes none)
            chars = bytearray()
            while True:
                ch = f.read(1)
                if ch == b"":
                    break
                if ch in (b"\n", b"\r", b" ") and not chars:
                    continue
                if ch == b" ":
                    break
                chars.extend(ch)
            word = chars.decode("utf-8")
            mat[i] = np.frombuffer(f.read(4 * d), dtype="<f4")
            vw = VocabWord(word, count=1, index=i)
            vocab._words[vw.word] = vw
            vocab._index.append(vw)
    return vocab, mat

def cosine_nearest(matrix: np.ndarray, query: np.ndarray, n: int,
                   exclude: int = -1) -> List[int]:
    """Indices of the n rows of matrix most cosine-similar to query,
    optionally excluding one row (the query's own index)."""
    normed = matrix / np.maximum(np.linalg.norm(matrix, axis=1, keepdims=True), 1e-12)
    sims = normed @ (query / max(np.linalg.norm(query), 1e-12))
    order = [int(i) for i in np.argsort(-sims) if i != exclude]
    return order[:n]

def cosine_sim(v1: Optional[np.ndarray], v2: Optional[np.ndarray]) -> float:
    if v1 is None or v2 is None:
        return float("nan")
    denom = np.linalg.norm(v1) * np.linalg.norm(v2)
    return float(np.dot(v1, v2) / denom) if denom else 0.0
