"""Counterpart of ``deeplearning4j_tpu/plot/iteration_listener.py``
(a copy: host code over the port's ``plot.renderers``).

Plotting iteration listener.

Parity with ref: plot/iterationlistener/NeuralNetPlotterIterationListener.java
— every N iterations, render the network's weight histograms (and optionally
activations) as artifacts through NeuralNetPlotter. Where the reference
shells out to matplotlib, the renderer writes self-contained JSON + SVG.
"""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.plot.renderers import NeuralNetPlotter


class PlotterIterationListener:
    """Drop into MultiLayerNetwork.set_listeners([...]) alongside the score
    and timing listeners (same callable contract: (model, iteration, score)).
    """

    def __init__(self, frequency: int = 10, out_dir: str = "plots",
                 plotter: Optional[NeuralNetPlotter] = None,
                 renders: int = 0):
        if frequency < 1:
            raise ValueError("frequency must be >= 1")
        self.frequency = frequency
        self.plotter = plotter or NeuralNetPlotter(out_dir=out_dir)
        self.renders = renders  # cap total renders; 0 = unlimited
        self._rendered = 0
        self.paths = []  # artifact paths written, latest last

    def __call__(self, model, iteration: int, score: float) -> None:
        if iteration % self.frequency != 0:
            return
        if self.renders and self._rendered >= self.renders:
            return
        self.paths.append(self.plotter.plot_weight_histograms(model, iteration))
        self._rendered += 1
