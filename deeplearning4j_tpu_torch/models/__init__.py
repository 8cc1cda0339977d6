"""Counterpart of ``deeplearning4j_tpu/models``: the transformer LM, the
zoo's confs, and the embedding models (Word2Vec, GloVe,
ParagraphVectors)."""

from deeplearning4j_tpu_torch.models.glove import Glove  # noqa: F401
from deeplearning4j_tpu_torch.models.paragraph_vectors import ParagraphVectors  # noqa: F401
from deeplearning4j_tpu_torch.models.word2vec import Word2Vec  # noqa: F401
