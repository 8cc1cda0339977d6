"""Counterpart of ``deeplearning4j_tpu/ui/``: the UI server,
browser-inspectable training artifacts and the live system's routes.

Parity with ref deeplearning4j-ui (UiServer.java, Dropwizard 0.8 app with
d3/React assets): REST endpoints for uploaded word vectors with
VPTree-backed nearest-neighbour queries (ref NearestNeighborsResource),
t-SNE coordinates (ref TsneResource), and weight histograms
(ref WeightResource). Implemented on the stdlib http.server — no web
framework dependency — serving JSON plus the self-contained SVG/HTML
artifacts written by plot/renderers.py.
"""

from deeplearning4j_tpu_torch.ui.server import UiServer

__all__ = ["UiServer"]
