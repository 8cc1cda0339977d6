"""Counterpart of ``deeplearning4j_tpu/text``: the text pipeline
(ref: deeplearning4j-nlp text/ packages), numpy and the standard library
only."""

from deeplearning4j_tpu_torch.text.tokenization import DefaultTokenizerFactory, NGramTokenizerFactory  # noqa: F401
from deeplearning4j_tpu_torch.text.sentence_iterator import (  # noqa: F401
    CollectionSentenceIterator,
    FileSentenceIterator,
    LineSentenceIterator,
)
from deeplearning4j_tpu_torch.text.vocab import VocabCache, VocabWord  # noqa: F401
