"""Counterpart of ``deeplearning4j_tpu/plot/``: the same exports.

Exact t-SNE runs on the card (``tsne.py``, plain torch); Barnes-Hut t-SNE
(over the port's ``SpTree`` and ``VPTree``), the artifact renderers and
the plotting iteration listener are host code copied from the JAX
package.
"""

from deeplearning4j_tpu_torch.plot.barnes_hut_tsne import BarnesHutTsne
from deeplearning4j_tpu_torch.plot.renderers import (
    FilterRenderer,
    NeuralNetPlotter,
)
from deeplearning4j_tpu_torch.plot.tsne import Tsne

__all__ = ["Tsne", "BarnesHutTsne", "NeuralNetPlotter", "FilterRenderer"]
