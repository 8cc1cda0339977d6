"""Counterpart of ``deeplearning4j_tpu/datasets/records.py``, copied whole
(numpy only).

Record readers — the Canova (datavec ancestor) ingestion seam.

Parity with ref: canova-api's RecordReader consumed via
datasets/canova/RecordReaderDataSetIterator.java (259 LoC). Readers yield
per-example records (lists of values); RecordReaderDataSetIterator assembles
them into DataSet batches with one-hot labels.

Readers: CSV (ref CSVRecordReader), SVMLight (ref svmLight test resources),
Line, ListString, and image files (PGM/PPM binary formats + .npy arrays —
this image path replaces the reference's javax.imageio ImageLoader).
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator


class RecordReader:
    """Iterable of records; each record is a list of float values (features,
    possibly with the label among them)."""

    def __iter__(self) -> Iterator[List[float]]:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class CSVRecordReader(RecordReader):
    """Comma/deliminated text, one record per line (ref CSVRecordReader:
    skipNumLines + delimiter)."""

    def __init__(self, path: str, skip_lines: int = 0, delimiter: str = ","):
        self.path = path
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def __iter__(self) -> Iterator[List[float]]:
        with open(self.path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                if i < self.skip_lines:
                    continue
                line = line.strip()
                if not line:
                    continue
                yield [float(v) for v in line.split(self.delimiter)]


class SVMLightRecordReader(RecordReader):
    """``label idx:val idx:val ...`` sparse format (ref svmLight resources;
    indices are 1-based as in libsvm). num_features fixes the dense width."""

    def __init__(self, path: str, num_features: int, zero_based: bool = False):
        self.path = path
        self.num_features = num_features
        self.zero_based = zero_based

    def __iter__(self) -> Iterator[List[float]]:
        with open(self.path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                parts = line.split()
                label = float(parts[0])
                dense = np.zeros(self.num_features, np.float32)
                for item in parts[1:]:
                    idx_s, val_s = item.split(":")
                    idx = int(idx_s) - (0 if self.zero_based else 1)
                    dense[idx] = float(val_s)
                yield dense.tolist() + [label]


class ListStringRecordReader(RecordReader):
    """In-memory records (ref ListStringRecordReader for tests)."""

    def __init__(self, records: Sequence[Sequence[float]]):
        self.records = [list(map(float, r)) for r in records]

    def __iter__(self) -> Iterator[List[float]]:
        return iter(self.records)


def read_pnm(path: str) -> np.ndarray:
    """Read binary PGM (P5) / PPM (P6) or ascii P2/P3 into (H,W[,3]) floats
    in [0,1]. Pure-python replacement for the reference's ImageLoader."""
    with open(path, "rb") as f:
        data = f.read()
    # header tokens: magic, width, height, maxval (comments start with #)
    tokens: List[bytes] = []
    pos = 0
    while len(tokens) < 4:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos : pos + 1] != b"\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        tokens.append(data[start:pos])
    magic = tokens[0].decode()
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    pos += 1  # single whitespace after maxval
    channels = 3 if magic in ("P3", "P6") else 1
    count = w * h * channels
    if magic in ("P5", "P6"):
        # Netpbm stores 16-bit samples most-significant-byte first
        dtype = np.dtype(">u2") if maxval > 255 else np.dtype(np.uint8)
        arr = np.frombuffer(data, dtype=dtype, count=count, offset=pos)
    elif magic in ("P2", "P3"):
        arr = np.array(data[pos:].split()[:count], dtype=np.float64)
    else:
        raise ValueError(f"unsupported PNM magic {magic!r} in {path}")
    arr = arr.reshape((h, w, 3) if channels == 3 else (h, w))
    return (arr / maxval).astype(np.float32)


def load_image(path: str) -> np.ndarray:
    """Image file → float array. Supports .pgm/.ppm/.pnm and .npy."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        return np.load(path).astype(np.float32)
    if ext in (".pgm", ".ppm", ".pnm"):
        return read_pnm(path)
    raise ValueError(
        f"unsupported image format {ext!r} (supported: .pgm/.ppm/.pnm/.npy)"
    )


class ImageRecordReader(RecordReader):
    """Walks a directory tree where each subdirectory is a class label
    (ref ImageRecordReader + LFW directory layout). Emits flattened pixels
    + label index; ``labels`` lists classes in index order."""

    def __init__(self, root: str, width: Optional[int] = None,
                 height: Optional[int] = None, append_label: bool = True):
        self.root = root
        self.width = width
        self.height = height
        self.append_label = append_label
        self.labels = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        )

    def _resize(self, img: np.ndarray) -> np.ndarray:
        if self.width is None or self.height is None:
            return img
        # nearest-neighbour resample (host-side; the reference rescales via
        # java.awt — exact filter parity is not required)
        h, w = img.shape[:2]
        ys = (np.arange(self.height) * h // self.height).clip(0, h - 1)
        xs = (np.arange(self.width) * w // self.width).clip(0, w - 1)
        return img[np.ix_(ys, xs)]

    def __iter__(self) -> Iterator[List[float]]:
        for li, label in enumerate(self.labels):
            directory = os.path.join(self.root, label)
            for name in sorted(os.listdir(directory)):
                path = os.path.join(directory, name)
                try:
                    img = load_image(path)
                except ValueError:
                    continue
                flat = self._resize(img).ravel().tolist()
                yield flat + [float(li)] if self.append_label else flat


class RecordReaderDataSetIterator(DataSetIterator):
    """Batches records into DataSets (ref RecordReaderDataSetIterator.java).

    label_index: position of the label within each record (-1 = last);
    num_possible_labels: one-hot width; None → regression (raw label column).
    """

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: int = -1,
                 num_possible_labels: Optional[int] = None):
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_possible_labels = num_possible_labels
        self._it: Optional[Iterator[List[float]]] = None
        self._pending: Optional[List[float]] = None
        self._count = 0
        self._columns: Optional[int] = None

    def reset(self) -> None:
        self.reader.reset()
        self._it = None
        self._pending = None
        self._count = 0

    def _pull(self) -> Optional[List[float]]:
        """Next record via the one-slot lookahead buffer (has_next must be
        idempotent: the base __iter__ calls it before every next())."""
        if self._pending is not None:
            rec, self._pending = self._pending, None
            return rec
        if self._it is None:
            self._it = iter(self.reader)
        return next(self._it, None)

    def has_next(self) -> bool:
        if self._pending is None:
            if self._it is None:
                self._it = iter(self.reader)
            self._pending = next(self._it, None)
        return self._pending is not None

    def next(self, num: Optional[int] = None) -> DataSet:
        want = num if num is not None else self.batch_size
        records: List[List[float]] = []
        while len(records) < want:
            rec = self._pull()
            if rec is None:
                break
            records.append(rec)
        if not records:
            raise StopIteration
        self._count += len(records)
        mat = np.asarray(records, np.float32)
        self._columns = mat.shape[1] - 1
        li = self.label_index if self.label_index >= 0 else mat.shape[1] - 1
        labels_col = mat[:, li]
        features = np.delete(mat, li, axis=1)
        if self.num_possible_labels is None:
            labels = labels_col[:, None]
        else:
            idx = labels_col.astype(int)
            if idx.min() < 0 or idx.max() >= self.num_possible_labels:
                raise ValueError(
                    f"label value out of range [0, {self.num_possible_labels}): "
                    f"min={idx.min()}, max={idx.max()}"
                )
            labels = np.zeros((len(records), self.num_possible_labels), np.float32)
            labels[np.arange(len(records)), idx] = 1.0
        return DataSet(features, labels)

    def batch(self) -> int:
        return self.batch_size

    def total_examples(self) -> int:
        return self._count

    def input_columns(self) -> int:
        return self._columns if self._columns is not None else -1

    def total_outcomes(self) -> int:
        return self.num_possible_labels if self.num_possible_labels else 1
