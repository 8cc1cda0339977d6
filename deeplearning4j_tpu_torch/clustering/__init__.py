"""Counterpart of ``deeplearning4j_tpu/clustering/``.

Only ``VPTree`` (``vptree.py``, the UI server's nearest-neighbour index)
is ported so far; k-means, the cluster sets and the KD, quad and SP trees
come with ROADMAP item 21d.
"""

from deeplearning4j_tpu_torch.clustering.vptree import VPTree

__all__ = ["VPTree"]
