"""Counterpart of ``deeplearning4j_tpu/datasets/iterator.py``, copied whole
(numpy only): the DataSetIterator protocol + base implementations.

Parity with ref: datasets/iterator/DataSetIterator.java:52 (hasNext/next/
reset/batch/totalExamples/inputColumns/totalOutcomes) and
BaseDatasetIterator / ListDataSetIterator / SamplingDataSetIterator /
MultipleEpochsIterator (datasets/iterator/).

Python-idiomatic: iterators are also iterable; the Java hasNext/next pair is
kept for API parity with the reference call sites.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class DataSetIterator:
    """Abstract iterator over mini-batches (DataSet instances)."""

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self, num: Optional[int] = None) -> DataSet:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def batch(self) -> int:
        raise NotImplementedError

    def total_examples(self) -> int:
        raise NotImplementedError

    def input_columns(self) -> int:
        raise NotImplementedError

    def total_outcomes(self) -> int:
        raise NotImplementedError

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        while self.has_next():
            yield self.next()


class BaseDatasetIterator(DataSetIterator):
    """Batched iteration over a fetcher (ref: BaseDatasetIterator.java)."""

    def __init__(self, batch_size: int, num_examples: int, fetcher):
        self._batch = batch_size
        self._num_examples = num_examples if num_examples > 0 else fetcher.total_examples()
        self.fetcher = fetcher

    def has_next(self) -> bool:
        return self.fetcher.has_more() and self.fetcher.cursor() < self._num_examples

    def next(self, num: Optional[int] = None) -> DataSet:
        n = num if num is not None else self._batch
        n = min(n, self._num_examples - self.fetcher.cursor())
        self.fetcher.fetch(n)
        return self.fetcher.next()

    def reset(self) -> None:
        self.fetcher.reset()

    def batch(self) -> int:
        return self._batch

    def total_examples(self) -> int:
        return self._num_examples

    def input_columns(self) -> int:
        return self.fetcher.input_columns()

    def total_outcomes(self) -> int:
        return self.fetcher.total_outcomes()


class ListDataSetIterator(DataSetIterator):
    """Iterate a pre-materialized list of examples (ref: ListDataSetIterator.java)."""

    def __init__(self, data: "DataSet | Sequence[DataSet]", batch_size: int = 10):
        if isinstance(data, DataSet):
            self._data = data
        else:
            self._data = DataSet.merge(list(data))
        self._batch = batch_size
        self._cursor = 0

    def has_next(self) -> bool:
        return self._cursor < self._data.num_examples()

    def next(self, num: Optional[int] = None) -> DataSet:
        n = num if num is not None else self._batch
        end = min(self._cursor + n, self._data.num_examples())
        ds = DataSet(
            self._data.features[self._cursor : end],
            None if self._data.labels is None else self._data.labels[self._cursor : end],
        )
        self._cursor = end
        return ds

    def reset(self) -> None:
        self._cursor = 0

    def batch(self) -> int:
        return self._batch

    def total_examples(self) -> int:
        return self._data.num_examples()

    def input_columns(self) -> int:
        return int(self._data.features.shape[-1])

    def total_outcomes(self) -> int:
        return 0 if self._data.labels is None else int(self._data.labels.shape[-1])


class SamplingDataSetIterator(DataSetIterator):
    """Sample batches with replacement (ref: SamplingDataSetIterator.java)."""

    def __init__(self, sample_from: DataSet, batch_size: int, total_number_samples: int, seed: int = 0):
        self._data = sample_from
        self._batch = batch_size
        self._total = total_number_samples
        self._sampled = 0
        self._rng = np.random.default_rng(seed)

    def has_next(self) -> bool:
        return self._sampled < self._total

    def next(self, num: Optional[int] = None) -> DataSet:
        n = num if num is not None else self._batch
        idx = self._rng.integers(0, self._data.num_examples(), size=n)
        self._sampled += n
        return DataSet(
            self._data.features[idx],
            None if self._data.labels is None else self._data.labels[idx],
        )

    def reset(self) -> None:
        self._sampled = 0

    def batch(self) -> int:
        return self._batch

    def total_examples(self) -> int:
        return self._total

    def input_columns(self) -> int:
        return int(self._data.features.shape[-1])

    def total_outcomes(self) -> int:
        return 0 if self._data.labels is None else int(self._data.labels.shape[-1])


class MultipleEpochsIterator(DataSetIterator):
    """Repeat an underlying iterator N times (ref: MultipleEpochsIterator.java)."""

    def __init__(self, num_epochs: int, underlying: DataSetIterator):
        self.num_epochs = num_epochs
        self.underlying = underlying
        self._epoch = 0

    def has_next(self) -> bool:
        if self.underlying.has_next():
            return True
        if self._epoch + 1 < self.num_epochs:
            self._epoch += 1
            self.underlying.reset()
            return self.underlying.has_next()
        return False

    def next(self, num: Optional[int] = None) -> DataSet:
        return self.underlying.next(num)

    def reset(self) -> None:
        self._epoch = 0
        self.underlying.reset()

    def batch(self) -> int:
        return self.underlying.batch()

    def total_examples(self) -> int:
        return self.underlying.total_examples() * self.num_epochs

    def input_columns(self) -> int:
        return self.underlying.input_columns()

    def total_outcomes(self) -> int:
        return self.underlying.total_outcomes()


class ReconstructionDataSetIterator(DataSetIterator):
    """Labels replaced by the features themselves — autoencoder targets
    (ref: datasets/iterator/ReconstructionDataSetIterator.java)."""

    def __init__(self, backing: DataSetIterator):
        self.backing = backing

    def has_next(self) -> bool:
        return self.backing.has_next()

    def next(self, num: Optional[int] = None) -> DataSet:
        ds = self.backing.next(num)
        return DataSet(ds.features, ds.features)

    def reset(self) -> None:
        self.backing.reset()

    def batch(self) -> int:
        return self.backing.batch()

    def total_examples(self) -> int:
        return self.backing.total_examples()

    def input_columns(self) -> int:
        return self.backing.input_columns()

    def total_outcomes(self) -> int:
        return self.backing.input_columns()


class MovingWindowDataSetIterator(DataSetIterator):
    """Batches of sliding windows over a (rows, cols) matrix, each window
    flattened (ref: datasets/iterator/MovingWindowBaseDataSetIterator +
    util/MovingWindowMatrix)."""

    def __init__(self, batch_size: int, data, labels, window_rows: int,
                 window_cols: int):
        import numpy as _np

        from deeplearning4j_tpu_torch.utils.moving_window import (
            MovingWindowMatrix,
        )

        data = _np.asarray(data)
        windows = MovingWindowMatrix(data, window_rows, window_cols).windows()
        feats = _np.stack([w.ravel() for w in windows]).astype(_np.float32)
        labels = _np.asarray(labels, _np.float32)
        if labels.ndim == 1:
            # 1-D input: per-window scalars if the length matches the window
            # count, otherwise a single label row shared by every window
            if len(labels) == len(feats):
                labels = labels[:, None]
            else:
                labels = labels[None, :]
        # every window comes from the same source matrix, so either one label
        # row (broadcast to all windows) or one per window is meaningful
        if len(labels) == 1:
            labels = _np.repeat(labels, len(feats), axis=0)
        elif len(labels) != len(feats):
            raise ValueError(
                f"labels must have 1 row or one per window ({len(feats)}), "
                f"got {len(labels)}"
            )
        self._inner = ListDataSetIterator(DataSet(feats, labels), batch_size)

    def has_next(self) -> bool:
        return self._inner.has_next()

    def next(self, num: Optional[int] = None) -> DataSet:
        return self._inner.next(num)

    def reset(self) -> None:
        self._inner.reset()

    def batch(self) -> int:
        return self._inner.batch()

    def total_examples(self) -> int:
        return self._inner.total_examples()

    def input_columns(self) -> int:
        return self._inner.input_columns()

    def total_outcomes(self) -> int:
        return self._inner.total_outcomes()
