"""Counterpart of ``deeplearning4j_tpu/plot/renderers.py``: artifact
renderers — NeuralNetPlotter / FilterRenderer equivalents, over numpy;
the port's networks hand their tensors over as numpy arrays (``_numpy``).

Parity with ref plot/NeuralNetPlotter.java (weight/gradient histograms,
activation renders — which shelled out to ``python /tmp/plot.py`` with
matplotlib, NeuralNetPlotter.java:175) and FilterRenderer.java (filter
weight images). This build has no matplotlib; renderers emit self-contained
artifacts instead: JSON histograms and standalone SVG/HTML files a browser
(or the ui server) renders directly.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch


def _numpy(x) -> np.ndarray:
    """A tensor (on any device, bf16 widened to f32) or array as numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _histogram(data: np.ndarray, bins: int = 50) -> Dict:
    counts, edges = np.histogram(np.asarray(data).ravel(), bins=bins)
    return {
        "counts": counts.tolist(),
        "edges": [float(e) for e in edges],
        "mean": float(np.mean(data)),
        "std": float(np.std(data)),
        "min": float(np.min(data)),
        "max": float(np.max(data)),
    }


def _svg_histogram(hist: Dict, title: str, width: int = 480, height: int = 240) -> str:
    counts = hist["counts"]
    peak = max(max(counts), 1)
    n = len(counts)
    bar_w = (width - 40) / n
    bars = []
    for i, c in enumerate(counts):
        h = (height - 50) * c / peak
        x = 20 + i * bar_w
        y = height - 30 - h
        bars.append(
            f'<rect x="{x:.1f}" y="{y:.1f}" width="{max(bar_w - 1, 1):.1f}" '
            f'height="{h:.1f}" fill="#4878d0"/>'
        )
    lo, hi = hist["edges"][0], hist["edges"][-1]
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" height="{height}">'
        f'<text x="{width / 2}" y="16" text-anchor="middle" '
        f'font-family="sans-serif" font-size="13">{title}</text>'
        + "".join(bars)
        + f'<text x="20" y="{height - 12}" font-family="sans-serif" '
        f'font-size="10">{lo:.3g}</text>'
        f'<text x="{width - 20}" y="{height - 12}" text-anchor="end" '
        f'font-family="sans-serif" font-size="10">{hi:.3g}</text>'
        "</svg>"
    )


class NeuralNetPlotter:
    """Writes per-layer weight/bias/gradient histograms and activation
    snapshots into an output directory (ref NeuralNetPlotter.plotNetworkGradient
    / plotWeightHistograms / plotActivations)."""

    def __init__(self, out_dir: str = "plots"):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    def plot_weight_histograms(self, network, iteration: int = 0) -> str:
        """network: MultiLayerNetwork (uses params_tree)."""
        report = {}
        svgs = []
        for i, layer_params in enumerate(network.params_tree):
            for name, arr in layer_params.items():
                key = f"layer{i}_{name}"
                hist = _histogram(_numpy(arr))
                report[key] = hist
                svgs.append(_svg_histogram(hist, key))
        path = os.path.join(self.out_dir, f"weights_iter{iteration}")
        with open(path + ".json", "w", encoding="utf-8") as f:
            json.dump(report, f)
        with open(path + ".html", "w", encoding="utf-8") as f:
            f.write("<html><body>" + "\n".join(svgs) + "</body></html>")
        return path + ".html"

    def plot_activations(self, network, x, iteration: int = 0) -> str:
        acts = network.feed_forward(x)
        report = {f"activation_layer{i}": _histogram(_numpy(a))
                  for i, a in enumerate(acts)}
        path = os.path.join(self.out_dir, f"activations_iter{iteration}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(report, f)
        return path

    def plot_score_history(self, scores, iteration: int = 0) -> str:
        path = os.path.join(self.out_dir, "score_history.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"iteration": iteration,
                       "scores": [float(s) for s in scores]}, f)
        return path


class FilterRenderer:
    """Renders a weight matrix as a grid of filter tiles (ref
    FilterRenderer.renderFilters) — emitted as an SVG of grayscale cells."""

    def render_filters(self, w: np.ndarray, path: str, patch_width: int,
                       patch_height: int, cols: int = 10) -> str:
        w = _numpy(w)
        n_filters = w.shape[1]
        cell = 4
        rows = (n_filters + cols - 1) // cols
        tile_w, tile_h = patch_width * cell, patch_height * cell
        parts = [
            f'<svg xmlns="http://www.w3.org/2000/svg" '
            f'width="{cols * (tile_w + 4)}" height="{rows * (tile_h + 4)}">'
        ]
        for f_idx in range(n_filters):
            col, row = f_idx % cols, f_idx // cols
            ox, oy = col * (tile_w + 4), row * (tile_h + 4)
            patch = w[: patch_width * patch_height, f_idx]
            lo, hi = patch.min(), patch.max()
            norm = (patch - lo) / (hi - lo + 1e-12)
            for p, v in enumerate(norm):
                px, py = p % patch_width, p // patch_width
                g = int(v * 255)
                parts.append(
                    f'<rect x="{ox + px * cell}" y="{oy + py * cell}" '
                    f'width="{cell}" height="{cell}" fill="rgb({g},{g},{g})"/>'
                )
        parts.append("</svg>")
        with open(path, "w", encoding="utf-8") as f:
            f.write("".join(parts))
        return path
