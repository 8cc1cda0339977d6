"""Counterpart of ``deeplearning4j_tpu/models``: the transformer LM, the
zoo's confs, the embedding models (Word2Vec, GloVe, ParagraphVectors) and
the RNTN."""

from deeplearning4j_tpu_torch.models.glove import Glove  # noqa: F401
from deeplearning4j_tpu_torch.models.paragraph_vectors import ParagraphVectors  # noqa: F401
from deeplearning4j_tpu_torch.models.rntn import RNTN, RNTNEval  # noqa: F401
from deeplearning4j_tpu_torch.models.word2vec import Word2Vec  # noqa: F401
