"""Counterpart of ``deeplearning4j_tpu/datasets/vectorizer.py``, copied
whole (numpy only): a DataSet file written by either package loads in the
other.

Vectorizers: raw inputs → DataSet, plus DataSet persistence.

Parity with ref: datasets/vectorizer/ — `Vectorizer` SPI and
`ImageVectorizer` (image file + label → DataSet) — and
datasets/creator/MnistDataSetCreator (materializes a fetched dataset to
disk for later iteration). Java serialization becomes npz.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class Vectorizer:
    """SPI (ref: datasets/vectorizer/Vectorizer.java)."""

    def vectorize(self) -> DataSet:
        raise NotImplementedError


class ImageVectorizer(Vectorizer):
    """One image file + its label → a one-row DataSet
    (ref: datasets/vectorizer/ImageVectorizer.java)."""

    def __init__(self, image_path: str, num_labels: int, label: int,
                 width: Optional[int] = None, height: Optional[int] = None):
        self.image_path = image_path
        self.num_labels = num_labels
        self.label = label
        self.width = width
        self.height = height

    def vectorize(self) -> DataSet:
        from deeplearning4j_tpu_torch.datasets.records import load_image

        img = load_image(self.image_path)
        if self.width is not None and self.height is not None:
            h, w = img.shape[:2]
            ys = (np.arange(self.height) * h // self.height).clip(0, h - 1)
            xs = (np.arange(self.width) * w // self.width).clip(0, w - 1)
            img = img[np.ix_(ys, xs)]
        x = np.asarray(img, np.float32).reshape(1, -1)
        y = np.zeros((1, self.num_labels), np.float32)
        y[0, self.label] = 1.0
        return DataSet(x, y)


class DirectoryImageVectorizer(Vectorizer):
    """Directory tree (class-per-subdir) → one DataSet — the batch analogue
    the LFW/MNIST creators build (ref: datasets/creator/MnistDataSetCreator
    drives a fetcher; here the image reader)."""

    def __init__(self, root: str, width: Optional[int] = None,
                 height: Optional[int] = None, max_examples: Optional[int] = None):
        self.root = root
        self.width = width
        self.height = height
        self.max_examples = max_examples

    def vectorize(self) -> DataSet:
        from itertools import islice

        from deeplearning4j_tpu_torch.datasets.records import ImageRecordReader

        reader = ImageRecordReader(self.root, width=self.width,
                                   height=self.height, append_label=True)
        rows = list(islice(reader, self.max_examples)) if self.max_examples \
            else list(reader)
        if not rows:
            raise ValueError(f"no readable images under {self.root!r}")
        mat = np.asarray(rows, np.float32)
        x, y_idx = mat[:, :-1], mat[:, -1].astype(np.int64)
        n_classes = len(reader.labels)
        y = np.zeros((x.shape[0], n_classes), np.float32)
        y[np.arange(x.shape[0]), y_idx] = 1.0
        return DataSet(x, y)


def save_dataset(path: str, dataset: DataSet) -> str:
    """Materialize a DataSet to disk (ref: MnistDataSetCreator.main —
    fetch + SerializationUtils.saveObject)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    if dataset.labels is None:
        np.savez(path, features=dataset.features)
    else:
        np.savez(path, features=dataset.features, labels=dataset.labels)
    return path


def load_dataset(path: str) -> DataSet:
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as z:
        return DataSet(z["features"],
                       z["labels"] if "labels" in z.files else None)
