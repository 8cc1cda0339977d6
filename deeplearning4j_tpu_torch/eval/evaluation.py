"""Counterpart of ``deeplearning4j_tpu/eval/evaluation.py``: classifier
evaluation metrics, numpy on the host; ``eval`` also takes tensors (a
network's output on the card), copied to the host at the call.

Parity with ref: eval/Evaluation.java:48 (eval(realOutcomes, guesses),
stats(), per-class precision/recall/f1, accuracy at :99-270) and
eval/ConfusionMatrix.java. Accumulates across batches like the reference.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional, Sequence

import numpy as np


def _host(x) -> np.ndarray:
    """An array, list or tensor (on any device) as a host array."""
    if hasattr(x, "detach"):  # a torch tensor
        x = x.detach().cpu()
        if x.dtype.is_floating_point:
            x = x.float()  # numpy has no bfloat16
        return x.numpy()
    return np.asarray(x)


class ConfusionMatrix:
    """Counts of (actual, predicted) pairs (ref: eval/ConfusionMatrix.java)."""

    def __init__(self, classes: Optional[Sequence[int]] = None):
        self.matrix: Dict[int, Dict[int, int]] = defaultdict(lambda: defaultdict(int))
        self.classes = set(classes or ())

    def add(self, actual: int, predicted: int, count: int = 1) -> None:
        self.matrix[actual][predicted] += count
        self.classes.add(actual)
        self.classes.add(predicted)

    def count(self, actual: int, predicted: int) -> int:
        return self.matrix[actual][predicted]

    def actual_total(self, actual: int) -> int:
        return sum(self.matrix[actual].values())

    def predicted_total(self, predicted: int) -> int:
        return sum(row[predicted] for row in self.matrix.values())

    def to_array(self) -> np.ndarray:
        classes = sorted(self.classes)
        idx = {c: i for i, c in enumerate(classes)}
        out = np.zeros((len(classes), len(classes)), dtype=np.int64)
        for a, row in self.matrix.items():
            for p, n in row.items():
                out[idx[a], idx[p]] = n
        return out


class Evaluation:
    """Accumulating classifier evaluation (ref: eval/Evaluation.java)."""

    def __init__(self):
        self.confusion = ConfusionMatrix()

    def eval(self, real_outcomes, guesses) -> None:
        """Add a batch. Both args are (batch, n_classes) probability/one-hot
        matrices, matching the reference's signature (Evaluation.java:48)."""
        real = _host(real_outcomes)
        guess = _host(guesses)
        actual = real.argmax(axis=-1)
        predicted = guess.argmax(axis=-1)
        for a, p in zip(actual, predicted):
            self.confusion.add(int(a), int(p))

    def eval_classes(self, actual_classes, predicted_classes) -> None:
        for a, p in zip(_host(actual_classes).ravel(),
                        _host(predicted_classes).ravel()):
            self.confusion.add(int(a), int(p))

    # ---- metrics ----
    def true_positives(self, cls: int) -> int:
        return self.confusion.count(cls, cls)

    def false_positives(self, cls: int) -> int:
        return self.confusion.predicted_total(cls) - self.true_positives(cls)

    def false_negatives(self, cls: int) -> int:
        return self.confusion.actual_total(cls) - self.true_positives(cls)

    def precision(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            denom = self.confusion.predicted_total(cls)
            return self.true_positives(cls) / denom if denom else 0.0
        vals = [self.precision(c) for c in sorted(self.confusion.classes)]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            denom = self.confusion.actual_total(cls)
            return self.true_positives(cls) / denom if denom else 0.0
        vals = [self.recall(c) for c in sorted(self.confusion.classes)]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) > 0 else 0.0

    def accuracy(self) -> float:
        total = sum(self.confusion.actual_total(c) for c in self.confusion.classes)
        correct = sum(self.true_positives(c) for c in self.confusion.classes)
        return correct / total if total else 0.0

    def stats(self) -> str:
        """Text report (ref: Evaluation.stats())."""
        lines = ["==========================Scores=====================================".rstrip()]
        for c in sorted(self.confusion.classes):
            lines.append(
                f" Class {c}: tp={self.true_positives(c)} fp={self.false_positives(c)} "
                f"fn={self.false_negatives(c)} precision={self.precision(c):.4f} "
                f"recall={self.recall(c):.4f} f1={self.f1(c):.4f}"
            )
        lines.append(f" Accuracy:  {self.accuracy():.4f}")
        lines.append(f" Precision: {self.precision():.4f}")
        lines.append(f" Recall:    {self.recall():.4f}")
        lines.append(f" F1 Score:  {self.f1():.4f}")
        return "\n".join(lines)
