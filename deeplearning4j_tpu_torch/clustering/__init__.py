"""Counterpart of ``deeplearning4j_tpu/clustering/``: the same exports.

k-means runs its Lloyd iterations on the card (``kmeans.py``, plain
torch); the cluster containers and the KD, VP, quad and SP trees are host
numpy copies of the JAX package's.
"""

from deeplearning4j_tpu_torch.clustering.cluster import Cluster, ClusterSet, \
    Point
from deeplearning4j_tpu_torch.clustering.kdtree import KDTree
from deeplearning4j_tpu_torch.clustering.kmeans import KMeansClustering
from deeplearning4j_tpu_torch.clustering.quadtree import QuadTree
from deeplearning4j_tpu_torch.clustering.sptree import SpTree
from deeplearning4j_tpu_torch.clustering.vptree import VPTree

__all__ = [
    "Cluster",
    "ClusterSet",
    "Point",
    "KMeansClustering",
    "KDTree",
    "VPTree",
    "QuadTree",
    "SpTree",
]
