"""Counterpart of ``deeplearning4j_tpu/plot/``.

Only the artifact renderers (``renderers.py``: ``NeuralNetPlotter``,
``FilterRenderer`` and the histogram payload the UI's views share) are
ported so far; t-SNE, Barnes-Hut t-SNE and the plotting iteration
listener come with ROADMAP item 21d.
"""

from deeplearning4j_tpu_torch.plot.renderers import (
    FilterRenderer,
    NeuralNetPlotter,
)

__all__ = ["NeuralNetPlotter", "FilterRenderer"]
