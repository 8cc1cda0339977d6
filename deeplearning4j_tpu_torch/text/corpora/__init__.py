"""Counterpart of ``deeplearning4j_tpu/text/corpora/__init__.py``, copied.

Corpora pipeline: sentences → labeled binary parse trees for RNTN.

Parity surface (ref: deeplearning4j-nlp text/corpora/ + text/annotator/):
- PoS tagging (annotator/PoStagger.java — UIMA/OpenNLP there, a
  self-contained rule tagger here; zero-egress, no model downloads)
- SWN3 sentiment scoring (corpora/sentiwordnet/SWN3.java)
- Penn-treebank reading, unary collapse, binarization, head finding,
  shallow parsing, tree vectorization (corpora/treeparser/)
"""

from deeplearning4j_tpu_torch.text.corpora.pos import PosTagger
from deeplearning4j_tpu_torch.text.corpora.sentiwordnet import SWN3
from deeplearning4j_tpu_torch.text.corpora.treeparser import (
    ConstituencyTree,
    HeadWordFinder,
    PennTreeReader,
    TreeIterator,
    TreeParser,
    TreeVectorizer,
    binarize,
    collapse_unaries,
    to_rntn_tree,
)

__all__ = [
    "PosTagger",
    "SWN3",
    "ConstituencyTree",
    "HeadWordFinder",
    "PennTreeReader",
    "TreeIterator",
    "TreeParser",
    "TreeVectorizer",
    "binarize",
    "collapse_unaries",
    "to_rntn_tree",
]
