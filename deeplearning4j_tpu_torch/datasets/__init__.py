"""Counterpart of ``deeplearning4j_tpu/datasets``: DataSet, iterators,
fetchers and record readers, numpy on the host."""

from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: F401
from deeplearning4j_tpu_torch.datasets.iterator import (  # noqa: F401
    BaseDatasetIterator,
    DataSetIterator,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.records import (  # noqa: F401
    CSVRecordReader,
    ImageRecordReader,
    ListStringRecordReader,
    RecordReader,
    RecordReaderDataSetIterator,
    SVMLightRecordReader,
)
