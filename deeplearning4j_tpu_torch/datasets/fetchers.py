"""Counterpart of ``deeplearning4j_tpu/datasets/fetchers.py``, copied whole
(numpy only; ``digits_data`` imports scikit-learn when called).

Dataset fetchers.

Parity with ref: datasets/fetchers/ — BaseDataFetcher SPI (cursor/fetch/next),
MnistDataFetcher (download+binarize, MnistDataFetcher.java:39-85), IrisDataFetcher.
The environment has no egress, so:
- MNIST loads from a local IDX directory (env ``MNIST_DIR`` or ``~/MNIST``,
  same layout/filenames the reference downloads) when present, else falls back
  to a deterministic synthetic MNIST-shaped set (class-conditional strokes) —
  good enough for convergence smoke tests and throughput benchmarks;
- Iris ships embedded (the canonical 150-sample Fisher data is public domain).
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class BaseDataFetcher:
    """Cursor-based fetcher SPI (ref: datasets/fetchers/BaseDataFetcher.java)."""

    def __init__(self, features: np.ndarray, labels: np.ndarray):
        self._features = features
        self._labels = labels
        self._cursor = 0
        self._current: Optional[DataSet] = None

    def total_examples(self) -> int:
        return int(self._features.shape[0])

    def input_columns(self) -> int:
        return int(self._features.shape[-1])

    def total_outcomes(self) -> int:
        return int(self._labels.shape[-1])

    def cursor(self) -> int:
        return self._cursor

    def has_more(self) -> bool:
        return self._cursor < self.total_examples()

    def fetch(self, num: int) -> None:
        end = min(self._cursor + num, self.total_examples())
        self._current = DataSet(self._features[self._cursor:end], self._labels[self._cursor:end])
        self._cursor = end

    def next(self) -> DataSet:
        if self._current is None:
            raise RuntimeError("fetch() must be called before next()")
        return self._current

    def reset(self) -> None:
        self._cursor = 0
        self._current = None


def _one_hot(y: np.ndarray, n_classes: int) -> np.ndarray:
    out = np.zeros((y.shape[0], n_classes), dtype=np.float32)
    out[np.arange(y.shape[0]), y.astype(np.int64)] = 1.0
    return out


# ---------------------------------------------------------------- MNIST ----

def _read_idx(path: str) -> np.ndarray:
    """IDX format reader (parity with ref: datasets/mnist/MnistImageFile.java /
    MnistLabelFile.java raw readers)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find_mnist_dir() -> Optional[str]:
    for cand in (os.environ.get("MNIST_DIR"), os.path.expanduser("~/MNIST")):
        if cand and os.path.isdir(cand):
            return cand
    return None


def _load_mnist_idx(directory: str, train: bool) -> Tuple[np.ndarray, np.ndarray]:
    img_names = ["train-images-idx3-ubyte", "train-images.idx3-ubyte"] if train else [
        "t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"]
    lbl_names = ["train-labels-idx1-ubyte", "train-labels.idx1-ubyte"] if train else [
        "t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"]

    def find(names):
        for n in names:
            for suffix in ("", ".gz"):
                p = os.path.join(directory, n + suffix)
                if os.path.exists(p):
                    return p
        raise FileNotFoundError(f"None of {names} found in {directory}")

    images = _read_idx(find(img_names)).astype(np.float32) / 255.0
    labels = _read_idx(find(lbl_names))
    return images.reshape(images.shape[0], -1), labels


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


class MnistDataFetcher(BaseDataFetcher):
    """MNIST fetcher (ref: MnistDataFetcher.java:39-85). ``binarize`` matches
    the reference's thresholding at >30/255."""

    NUM_EXAMPLES = 60000

    def __init__(self, binarize: bool = True, train: bool = True,
                 num_examples: Optional[int] = None, synthetic: Optional[bool] = None):
        directory = _find_mnist_dir()
        if synthetic is None:
            synthetic = directory is None
        self.synthetic = synthetic
        if synthetic:
            n = num_examples or 10000
            x, y = synthetic_mnist(n)
            if binarize:
                x = (x > (30.0 / 255.0)).astype(np.float32)
        else:
            x, y = _load_mnist_idx(directory, train)
            if binarize:
                x = (x > (30.0 / 255.0)).astype(np.float32)
            if num_examples:
                x, y = x[:num_examples], y[:num_examples]
        super().__init__(x.astype(np.float32), _one_hot(y, 10))


# ----------------------------------------------------------------- Iris ----

# Fisher's Iris data (public domain; same data the reference ships as
# iris.dat in dl4j-test-resources). 150 rows: sl, sw, pl, pw, class.
_IRIS_RAW = """
5.1,3.5,1.4,0.2,0;4.9,3.0,1.4,0.2,0;4.7,3.2,1.3,0.2,0;4.6,3.1,1.5,0.2,0;5.0,3.6,1.4,0.2,0;
5.4,3.9,1.7,0.4,0;4.6,3.4,1.4,0.3,0;5.0,3.4,1.5,0.2,0;4.4,2.9,1.4,0.2,0;4.9,3.1,1.5,0.1,0;
5.4,3.7,1.5,0.2,0;4.8,3.4,1.6,0.2,0;4.8,3.0,1.4,0.1,0;4.3,3.0,1.1,0.1,0;5.8,4.0,1.2,0.2,0;
5.7,4.4,1.5,0.4,0;5.4,3.9,1.3,0.4,0;5.1,3.5,1.4,0.3,0;5.7,3.8,1.7,0.3,0;5.1,3.8,1.5,0.3,0;
5.4,3.4,1.7,0.2,0;5.1,3.7,1.5,0.4,0;4.6,3.6,1.0,0.2,0;5.1,3.3,1.7,0.5,0;4.8,3.4,1.9,0.2,0;
5.0,3.0,1.6,0.2,0;5.0,3.4,1.6,0.4,0;5.2,3.5,1.5,0.2,0;5.2,3.4,1.4,0.2,0;4.7,3.2,1.6,0.2,0;
4.8,3.1,1.6,0.2,0;5.4,3.4,1.5,0.4,0;5.2,4.1,1.5,0.1,0;5.5,4.2,1.4,0.2,0;4.9,3.1,1.5,0.2,0;
5.0,3.2,1.2,0.2,0;5.5,3.5,1.3,0.2,0;4.9,3.6,1.4,0.1,0;4.4,3.0,1.3,0.2,0;5.1,3.4,1.5,0.2,0;
5.0,3.5,1.3,0.3,0;4.5,2.3,1.3,0.3,0;4.4,3.2,1.3,0.2,0;5.0,3.5,1.6,0.6,0;5.1,3.8,1.9,0.4,0;
4.8,3.0,1.4,0.3,0;5.1,3.8,1.6,0.2,0;4.6,3.2,1.4,0.2,0;5.3,3.7,1.5,0.2,0;5.0,3.3,1.4,0.2,0;
7.0,3.2,4.7,1.4,1;6.4,3.2,4.5,1.5,1;6.9,3.1,4.9,1.5,1;5.5,2.3,4.0,1.3,1;6.5,2.8,4.6,1.5,1;
5.7,2.8,4.5,1.3,1;6.3,3.3,4.7,1.6,1;4.9,2.4,3.3,1.0,1;6.6,2.9,4.6,1.3,1;5.2,2.7,3.9,1.4,1;
5.0,2.0,3.5,1.0,1;5.9,3.0,4.2,1.5,1;6.0,2.2,4.0,1.0,1;6.1,2.9,4.7,1.4,1;5.6,2.9,3.6,1.3,1;
6.7,3.1,4.4,1.4,1;5.6,3.0,4.5,1.5,1;5.8,2.7,4.1,1.0,1;6.2,2.2,4.5,1.5,1;5.6,2.5,3.9,1.1,1;
5.9,3.2,4.8,1.8,1;6.1,2.8,4.0,1.3,1;6.3,2.5,4.9,1.5,1;6.1,2.8,4.7,1.2,1;6.4,2.9,4.3,1.3,1;
6.6,3.0,4.4,1.4,1;6.8,2.8,4.8,1.4,1;6.7,3.0,5.0,1.7,1;6.0,2.9,4.5,1.5,1;5.7,2.6,3.5,1.0,1;
5.5,2.4,3.8,1.1,1;5.5,2.4,3.7,1.0,1;5.8,2.7,3.9,1.2,1;6.0,2.7,5.1,1.6,1;5.4,3.0,4.5,1.5,1;
6.0,3.4,4.5,1.6,1;6.7,3.1,4.7,1.5,1;6.3,2.3,4.4,1.3,1;5.6,3.0,4.1,1.3,1;5.5,2.5,4.0,1.3,1;
5.5,2.6,4.4,1.2,1;6.1,3.0,4.6,1.4,1;5.8,2.6,4.0,1.2,1;5.0,2.3,3.3,1.0,1;5.6,2.7,4.2,1.3,1;
5.7,3.0,4.2,1.2,1;5.7,2.9,4.2,1.3,1;6.2,2.9,4.3,1.3,1;5.1,2.5,3.0,1.1,1;5.7,2.8,4.1,1.3,1;
6.3,3.3,6.0,2.5,2;5.8,2.7,5.1,1.9,2;7.1,3.0,5.9,2.1,2;6.3,2.9,5.6,1.8,2;6.5,3.0,5.8,2.2,2;
7.6,3.0,6.6,2.1,2;4.9,2.5,4.5,1.7,2;7.3,2.9,6.3,1.8,2;6.7,2.5,5.8,1.8,2;7.2,3.6,6.1,2.5,2;
6.5,3.2,5.1,2.0,2;6.4,2.7,5.3,1.9,2;6.8,3.0,5.5,2.1,2;5.7,2.5,5.0,2.0,2;5.8,2.8,5.1,2.4,2;
6.4,3.2,5.3,2.3,2;6.5,3.0,5.5,1.8,2;7.7,3.8,6.7,2.2,2;7.7,2.6,6.9,2.3,2;6.0,2.2,5.0,1.5,2;
6.9,3.2,5.7,2.3,2;5.6,2.8,4.9,2.0,2;7.7,2.8,6.7,2.0,2;6.3,2.7,4.9,1.8,2;6.7,3.3,5.7,2.1,2;
7.2,3.2,6.0,1.8,2;6.2,2.8,4.8,1.8,2;6.1,3.0,4.9,1.8,2;6.4,2.8,5.6,2.1,2;7.2,3.0,5.8,1.6,2;
7.4,2.8,6.1,1.9,2;7.9,3.8,6.4,2.0,2;6.4,2.8,5.6,2.2,2;6.3,2.8,5.1,1.5,2;6.1,2.6,5.6,1.4,2;
7.7,3.0,6.1,2.3,2;6.3,3.4,5.6,2.4,2;6.4,3.1,5.5,1.8,2;6.0,3.0,4.8,1.8,2;6.9,3.1,5.4,2.1,2;
6.7,3.1,5.6,2.4,2;6.9,3.1,5.1,2.3,2;5.8,2.7,5.1,1.9,2;6.8,3.2,5.9,2.3,2;6.7,3.3,5.7,2.5,2;
6.7,3.0,5.2,2.3,2;6.3,2.5,5.0,1.9,2;6.5,3.0,5.2,2.0,2;6.2,3.4,5.4,2.3,2;5.9,3.0,5.1,1.8,2
""".replace("\n", "")


def iris_data(normalize: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    rows = [r for r in _IRIS_RAW.split(";") if r]
    data = np.array([[float(v) for v in r.split(",")] for r in rows], dtype=np.float32)
    x, y = data[:, :4], data[:, 4].astype(np.int64)
    if normalize:
        x = (x - x.mean(axis=0)) / x.std(axis=0)
    return x, y


class IrisDataFetcher(BaseDataFetcher):
    """Iris fetcher (ref: datasets/fetchers/IrisDataFetcher.java)."""

    def __init__(self, normalize: bool = True, shuffle_seed: Optional[int] = 42):
        x, y = iris_data(normalize)
        if shuffle_seed is not None:
            perm = np.random.default_rng(shuffle_seed).permutation(x.shape[0])
            x, y = x[perm], y[perm]
        super().__init__(x, _one_hot(y, 3))


def digits_data(normalize: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Real handwritten-digit data: scikit-learn's bundled UCI ``digits`` set
    (1,797 genuine 8x8 grayscale scans, Alpaydin & Kaynak 1998). The closest
    real MNIST-class data available without network egress; used for the
    real-data accuracy gates (ACCURACY_r*.json) that the reference satisfies
    by downloading MNIST (ref: datasets/fetchers/MnistDataFetcher.java:39-85).

    Raises ImportError when scikit-learn is absent.
    """
    from sklearn.datasets import load_digits

    bunch = load_digits()
    x = bunch.data.astype(np.float32)
    if normalize:
        x /= 16.0  # pixel range is 0..16
    return x, bunch.target.astype(np.int64)


class DigitsDataFetcher(BaseDataFetcher):
    """Fetcher over the real sklearn digits set (see :func:`digits_data`)."""

    def __init__(self, normalize: bool = True, shuffle_seed: Optional[int] = 42):
        x, y = digits_data(normalize)
        if shuffle_seed is not None:
            perm = np.random.default_rng(shuffle_seed).permutation(x.shape[0])
            x, y = x[perm], y[perm]
        super().__init__(x, _one_hot(y, 10))


class CurvesDataFetcher(BaseDataFetcher):
    """Synthetic smooth-curves set (the reference downloads a curves.ser blob,
    ref: datasets/fetchers/CurvesDataFetcher.java; regenerated here as random
    smooth 1-D curves for autoencoder pretraining tests)."""

    def __init__(self, num_examples: int = 1000, dim: int = 784, seed: int = 3):
        rng = np.random.default_rng(seed)
        t = np.linspace(0, 2 * np.pi, dim, dtype=np.float32)
        freqs = rng.uniform(0.5, 4.0, size=(num_examples, 3)).astype(np.float32)
        phases = rng.uniform(0, 2 * np.pi, size=(num_examples, 3)).astype(np.float32)
        amps = rng.uniform(0.2, 1.0, size=(num_examples, 3)).astype(np.float32)
        x = sum(
            amps[:, i: i + 1] * np.sin(freqs[:, i: i + 1] * t[None, :] + phases[:, i: i + 1])
            for i in range(3)
        )
        x = (x - x.min()) / (x.max() - x.min())
        super().__init__(x.astype(np.float32), x.astype(np.float32).copy())


def synthetic_faces(num_examples: int, num_people: int = 5, width: int = 28,
                    height: int = 28, seed: int = 11
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """LFW-shaped surrogate (faces → person id): per-class smooth 'face'
    prototype (blurred blobs) + noise. Used when the real LFW archive is
    unavailable (zero-egress environments)."""
    rng = np.random.default_rng(seed)
    proto_rng = np.random.default_rng(4321)
    protos = np.zeros((num_people, height, width), np.float32)
    yy, xx = np.mgrid[0:height, 0:width]
    for p in range(num_people):
        for _ in range(4):
            cy = proto_rng.uniform(4, max(height - 4, 5))
            cx = proto_rng.uniform(4, max(width - 4, 5))
            sig = proto_rng.uniform(2.0, 5.0)
            protos[p] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig**2))
        protos[p] /= protos[p].max()
    y = rng.integers(0, num_people, num_examples)
    x = protos[y] + rng.normal(0, 0.1, (num_examples, height, width)).astype(np.float32)
    return np.clip(x, 0, 1).reshape(num_examples, height * width), y


class LFWDataFetcher(BaseDataFetcher):
    """Labeled-Faces-in-the-Wild fetcher (ref: LFWDataFetcher/LFWLoader —
    downloads+scales the lfw archive). Reads an already-extracted LFW-style
    directory tree (person-name subdirs of .pgm/.ppm/.npy images) when
    ``path`` is given; otherwise falls back to a synthetic face set
    (no network egress here, ref downloads from vis-www.cs.umass.edu)."""

    def __init__(self, num_examples: int = 500, path: Optional[str] = None,
                 width: int = 28, height: int = 28):
        if path is not None:
            from itertools import islice

            from deeplearning4j_tpu_torch.datasets.records import ImageRecordReader

            reader = ImageRecordReader(path, width=width, height=height,
                                       append_label=True)
            rows = list(islice(reader, num_examples))
            if not rows:
                raise ValueError(
                    f"no readable images under {path!r} — ImageRecordReader "
                    "supports .pgm/.ppm/.pnm/.npy files (convert .jpg LFW "
                    "archives first, e.g. with `mogrify -format ppm`)"
                )
            mat = np.asarray(rows, np.float32)
            x, y = mat[:, :-1], mat[:, -1].astype(np.int64)
            self.num_people = len(reader.labels)
        else:
            self.num_people = 5
            x, y = synthetic_faces(num_examples, self.num_people,
                                   width=width, height=height)
        super().__init__(x[:num_examples],
                         _one_hot(y[:num_examples], self.num_people))
