"""Counterpart of ``deeplearning4j_tpu/datasets/dataset.py``, copied whole
(numpy only): DataSet — (features, labels) pair.

Parity with ND4J's ``DataSet`` (used throughout the reference, e.g.
MultiLayerNetwork.fit at MultiLayerNetwork.java:936-956). Stored as host
numpy; conversion to device tensors happens at the train step, so the input
pipeline stays off the card.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np


class DataSet:
    def __init__(self, features, labels=None):
        self.features = np.asarray(features, dtype=np.float32)
        self.labels = None if labels is None else np.asarray(labels, dtype=np.float32)

    # reference accessor names (DataSet.getFeatureMatrix/getLabels)
    def get_feature_matrix(self) -> np.ndarray:
        return self.features

    def get_labels(self) -> np.ndarray:
        return self.labels

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def split_test_and_train(self, n_train: int) -> Tuple["DataSet", "DataSet"]:
        train = DataSet(self.features[:n_train], None if self.labels is None else self.labels[:n_train])
        test = DataSet(self.features[n_train:], None if self.labels is None else self.labels[n_train:])
        return train, test

    def shuffle(self, seed: int = 0) -> "DataSet":
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self.num_examples())
        return DataSet(
            self.features[perm], None if self.labels is None else self.labels[perm]
        )

    def batch_by(self, batch_size: int, drop_last: bool = False) -> List["DataSet"]:
        out = []
        n = self.num_examples()
        for start in range(0, n, batch_size):
            end = start + batch_size
            if end > n and drop_last:
                break
            out.append(
                DataSet(
                    self.features[start:end],
                    None if self.labels is None else self.labels[start:end],
                )
            )
        return out

    def __iter__(self) -> Iterator["DataSet"]:
        for i in range(self.num_examples()):
            yield DataSet(
                self.features[i : i + 1],
                None if self.labels is None else self.labels[i : i + 1],
            )

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        feats = np.concatenate([d.features for d in datasets], axis=0)
        if all(d.labels is not None for d in datasets):
            labels = np.concatenate([d.labels for d in datasets], axis=0)
        else:
            labels = None
        return DataSet(feats, labels)
