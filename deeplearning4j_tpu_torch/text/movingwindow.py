"""Counterpart of ``deeplearning4j_tpu/text/movingwindow.py``, copied whole
(numpy only).

Context windows over token sequences.

Parity with ref text/movingwindow/ — Windows.windows(tokens, windowSize)
produces fixed-width context windows with edge padding, Window holds the
tokens + focus word, and WindowConverter turns a window into one input
vector by concatenating word vectors (used by the windowed sequence
classifiers, e.g. Viterbi-decoded PoS tagging).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

PAD = "<PAD>"


class Window:
    def __init__(self, tokens: Sequence[str], focus_index: int):
        self.tokens = list(tokens)
        self.focus_index = focus_index

    @property
    def focus_word(self) -> str:
        return self.tokens[self.focus_index]

    def __repr__(self) -> str:
        marked = [f"[{t}]" if i == self.focus_index else t
                  for i, t in enumerate(self.tokens)]
        return " ".join(marked)


def windows(tokens: Sequence[str], window_size: int = 5) -> List[Window]:
    """One window per token, padded at the edges (ref Windows.windows).
    window_size is the full width and must be odd."""
    if window_size % 2 == 0:
        raise ValueError("window_size must be odd")
    half = window_size // 2
    padded = [PAD] * half + list(tokens) + [PAD] * half
    return [Window(padded[i : i + window_size], half)
            for i in range(len(tokens))]


class WindowConverter:
    """Window → concatenated word-vector input (ref WindowConverter.asInput:
    lookup each token's vector, unknown/pad → zeros)."""

    def __init__(self, lookup):
        """lookup: object with .vector(word) -> Optional[np.ndarray] and
        .layer_size (e.g. InMemoryLookupTable or a Word2Vec model)."""
        self.lookup = lookup
        self.dim = getattr(lookup, "layer_size")

    def as_input(self, window: Window) -> np.ndarray:
        parts = []
        for tok in window.tokens:
            v = self.lookup.vector(tok) if tok != PAD else None
            parts.append(np.zeros(self.dim, np.float32) if v is None
                         else np.asarray(v, np.float32))
        return np.concatenate(parts)

    def as_matrix(self, wins: Sequence[Window]) -> np.ndarray:
        return np.stack([self.as_input(w) for w in wins])
