"""Counterpart of ``deeplearning4j_tpu/utils/viterbi.py``
(a copy: host code).

Viterbi decoder for windowed sequence labeling.

Parity with ref util/Viterbi.java: decode the most likely label sequence
given per-step label scores and a transition structure. Vectorized over the
time axis with numpy (the per-step max is the only sequential dependency).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class Viterbi:
    """Max-product decoding over a label lattice.

    emissions: (T, L) per-step label log-scores;
    transitions: (L, L) log-score of label[t-1]→label[t] (uniform if None).
    """

    def __init__(self, num_labels: int,
                 transitions: Optional[np.ndarray] = None):
        self.num_labels = num_labels
        if transitions is None:
            transitions = np.zeros((num_labels, num_labels))
        self.transitions = np.asarray(transitions, np.float64)
        if self.transitions.shape != (num_labels, num_labels):
            raise ValueError(
                f"transitions must be ({num_labels},{num_labels}), "
                f"got {self.transitions.shape}"
            )

    def decode(self, emissions) -> Tuple[np.ndarray, float]:
        """(best label path (T,), its total log-score)."""
        em = np.asarray(emissions, np.float64)
        t_len, n = em.shape
        if n != self.num_labels:
            raise ValueError(f"expected {self.num_labels} labels, got {n}")
        delta = em[0].copy()  # (L,)
        back = np.zeros((t_len, n), np.int64)
        for t in range(1, t_len):
            # (prev L, next L) score matrix; argmax over prev per next label
            scores = delta[:, None] + self.transitions
            back[t] = scores.argmax(0)
            delta = scores.max(0) + em[t]
        path = np.zeros(t_len, np.int64)
        path[-1] = int(delta.argmax())
        for t in range(t_len - 1, 0, -1):
            path[t - 1] = back[t, path[t]]
        return path, float(delta.max())
