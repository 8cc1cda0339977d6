"""Counterpart of ``deeplearning4j_tpu/datasets/fetchers.py``: only
``synthetic_mnist`` so far, a bit-identical copy (numpy-seeded), which the
MLP slice trains on. The IDX/Iris fetchers come with a later slice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_mnist(num_examples: int, seed: int = 7, image_side: int = 28
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic MNIST-shaped surrogate: each class is a fixed pattern of
    bright rectangles plus pixel noise — linearly separable enough to verify
    convergence, dense enough to exercise real conv/matmul shapes."""
    rng = np.random.default_rng(seed)
    d = image_side
    prototypes = np.zeros((10, d, d), dtype=np.float32)
    proto_rng = np.random.default_rng(1234)  # fixed prototypes across calls
    for c in range(10):
        for _ in range(3):
            r0, c0 = proto_rng.integers(2, d - 8, size=2)
            h, w = proto_rng.integers(3, 7, size=2)
            prototypes[c, r0:r0 + h, c0:c0 + w] = 1.0
    y = rng.integers(0, 10, size=num_examples)
    x = prototypes[y] * rng.uniform(0.6, 1.0, size=(num_examples, 1, 1)).astype(np.float32)
    x = x + rng.normal(0.0, 0.15, size=x.shape).astype(np.float32)
    x = np.clip(x, 0.0, 1.0).reshape(num_examples, d * d)
    return x, y
