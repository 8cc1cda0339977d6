"""Counterpart of ``deeplearning4j_tpu/utils/moving_window.py``, copied
whole (numpy only): MovingWindowMatrix (ref util/MovingWindowMatrix.java): sliding windows
over a 2-D matrix, optionally with rotations appended — used by the moving-
window sequence pipeline. Vectorized via stride tricks."""

from __future__ import annotations

from typing import List

import numpy as np


class MovingWindowMatrix:
    def __init__(self, to_slice: np.ndarray, window_rows: int,
                 window_cols: int, add_rotate: bool = False):
        self.matrix = np.asarray(to_slice)
        self.window_rows = window_rows
        self.window_cols = window_cols
        self.add_rotate = add_rotate
        if (window_rows > self.matrix.shape[0]
                or window_cols > self.matrix.shape[1]):
            raise ValueError(
                f"window {(window_rows, window_cols)} larger than matrix "
                f"{self.matrix.shape}"
            )

    def windows(self) -> List[np.ndarray]:
        """All contiguous (window_rows, window_cols) sub-matrices, row-major
        order; with add_rotate, each is followed by its three 90° rotations
        (ref MovingWindowMatrix.windows(boolean))."""
        view = np.lib.stride_tricks.sliding_window_view(
            self.matrix, (self.window_rows, self.window_cols)
        )
        out: List[np.ndarray] = []
        for i in range(view.shape[0]):
            for j in range(view.shape[1]):
                w = view[i, j].copy()
                out.append(w)
                if self.add_rotate:
                    r = w
                    for _ in range(3):
                        r = np.rot90(r)
                        out.append(r.copy())
        return out
