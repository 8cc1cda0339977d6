"""Counterpart of ``deeplearning4j_tpu/datasets/impl.py``, copied whole.

Concrete dataset iterators (ref: datasets/iterator/impl/)."""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.datasets.fetchers import (
    CurvesDataFetcher,
    IrisDataFetcher,
    MnistDataFetcher,
)
from deeplearning4j_tpu_torch.datasets.iterator import BaseDatasetIterator


class MnistDataSetIterator(BaseDatasetIterator):
    """(ref: datasets/iterator/impl/MnistDataSetIterator.java)"""

    def __init__(self, batch: int, num_examples: int, binarize: bool = True,
                 train: bool = True, synthetic: Optional[bool] = None):
        super().__init__(
            batch, num_examples,
            MnistDataFetcher(binarize=binarize, train=train,
                             num_examples=num_examples, synthetic=synthetic),
        )


class IrisDataSetIterator(BaseDatasetIterator):
    """(ref: datasets/iterator/impl/IrisDataSetIterator.java)"""

    def __init__(self, batch: int, num_examples: int = 150):
        super().__init__(batch, num_examples, IrisDataFetcher())


class CurvesDataSetIterator(BaseDatasetIterator):
    def __init__(self, batch: int, num_examples: int = 1000):
        super().__init__(batch, num_examples, CurvesDataFetcher(num_examples))


class LFWDataSetIterator(BaseDatasetIterator):
    """ref: datasets/iterator/impl/LFWDataSetIterator.java"""

    def __init__(self, batch: int, num_examples: int = 500,
                 path=None, width: int = 28, height: int = 28):
        from deeplearning4j_tpu_torch.datasets.fetchers import LFWDataFetcher

        super().__init__(batch, num_examples,
                         LFWDataFetcher(num_examples, path=path,
                                        width=width, height=height))
