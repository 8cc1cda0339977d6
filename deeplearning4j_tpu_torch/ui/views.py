"""Counterpart of ``deeplearning4j_tpu/ui/views.py``: the browser render
views for the UI server (the pages are JAX's byte for byte), and the
payloads of the port's ``MultiLayerNetwork`` (its tensors taken to numpy).

The reference ships a d3/React webapp rendering t-SNE scatters, weight
histograms and nearest-neighbour queries (ref: ui/UiServer.java +
deeplearning4j-ui/src/main/resources/assets/). This build serves the same
views as self-contained HTML pages with inline JS — no build step, no
external assets (zero-egress friendly): each page fetches the corresponding
/api/* JSON endpoint and renders SVG client-side.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from deeplearning4j_tpu_torch.plot.renderers import _histogram, _numpy

# Corpus-derived strings (tokens, labels) are untrusted: escape before any
# innerHTML/SVG interpolation (stored-XSS guard; injected into every page).
_ESC_JS = """
const esc = s => String(s).replace(/[&<>"']/g, c => ({
  '&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));
"""

_STYLE = """
body{font-family:system-ui,sans-serif;margin:24px;color:#1a1a2e}
h1{font-size:20px} .muted{color:#777;font-size:13px}
svg{background:#fafafa;border:1px solid #ddd;border-radius:4px}
table{border-collapse:collapse} td,th{padding:4px 10px;border:1px solid #ccc}
input,button{font-size:14px;padding:4px 8px}
.bar{fill:#4c72b0} .bar:hover{fill:#dd8452}
text{font-size:10px;fill:#333}
"""

TSNE_HTML = """<!doctype html>
<html><head><title>t-SNE</title><style>__STYLE__</style></head><body>
<h1>t-SNE embedding</h1>
<p class="muted">rendered from <a href="/api/tsne">/api/tsne</a> —
drag to pan, scroll to zoom, double-click to reset</p>
<div id="plot">loading…</div>
<script>__ESC__
fetch('/api/tsne').then(r => r.json()).then(d => {
  const el = document.getElementById('plot');
  if (!d.coords || !d.coords.length) { el.textContent = 'no t-SNE uploaded'; return; }
  const W = 760, H = 560, PAD = 30;
  const xs = d.coords.map(c => c[0]), ys = d.coords.map(c => c[1]);
  const xmin = Math.min(...xs), xmax = Math.max(...xs);
  const ymin = Math.min(...ys), ymax = Math.max(...ys);
  const sx = v => PAD + (v - xmin) / (xmax - xmin || 1) * (W - 2 * PAD);
  const sy = v => H - PAD - (v - ymin) / (ymax - ymin || 1) * (H - 2 * PAD);
  const hue = s => { let h = 0; for (const ch of String(s)) h = (h * 31 + ch.charCodeAt(0)) % 360; return h; };
  let body = '';
  d.coords.forEach((c, i) => {
    const label = d.labels[i] ?? '';
    body += `<circle cx="${sx(c[0])}" cy="${sy(c[1])}" r="3.5"
      fill="hsl(${hue(label)},65%,45%)"><title>${esc(label)}</title></circle>`;
    if (d.coords.length <= 300)
      body += `<text x="${sx(c[0]) + 5}" y="${sy(c[1]) + 3}">${esc(label)}</text>`;
  });
  el.innerHTML = `<svg id="tsvg" width="${W}" height="${H}" viewBox="0 0 ${W} ${H}">` + body + '</svg>';
  // pan/zoom on the viewBox (ref webapp: d3.behavior.zoom in assets/render.js)
  const svg = document.getElementById('tsvg');
  let vb = {x: 0, y: 0, w: W, h: H};
  const apply = () => svg.setAttribute('viewBox', `${vb.x} ${vb.y} ${vb.w} ${vb.h}`);
  svg.addEventListener('wheel', e => {
    e.preventDefault();
    const k = e.deltaY < 0 ? 0.8 : 1.25;
    const r = svg.getBoundingClientRect();
    const mx = vb.x + (e.clientX - r.left) / r.width * vb.w;
    const my = vb.y + (e.clientY - r.top) / r.height * vb.h;
    vb = {x: mx - (mx - vb.x) * k, y: my - (my - vb.y) * k, w: vb.w * k, h: vb.h * k};
    apply();
  });
  let drag = null;
  svg.addEventListener('mousedown', e => { drag = {x: e.clientX, y: e.clientY}; });
  window.addEventListener('mousemove', e => {
    if (!drag) return;
    const r = svg.getBoundingClientRect();
    vb.x -= (e.clientX - drag.x) / r.width * vb.w;
    vb.y -= (e.clientY - drag.y) / r.height * vb.h;
    drag = {x: e.clientX, y: e.clientY};
    apply();
  });
  window.addEventListener('mouseup', () => { drag = null; });
  svg.addEventListener('dblclick', () => { vb = {x: 0, y: 0, w: W, h: H}; apply(); });
});
</script></body></html>""".replace("__STYLE__", _STYLE).replace("__ESC__", _ESC_JS)

WEIGHTS_HTML = """<!doctype html>
<html><head><title>weight histograms</title><style>__STYLE__</style></head><body>
<h1>Weight histograms</h1>
<p class="muted">rendered from <a href="/api/weights">/api/weights</a></p>
<div id="plots">loading…</div>
<script>__ESC__
fetch('/api/weights').then(r => r.json()).then(d => {
  const el = document.getElementById('plots');
  const names = Object.keys(d);
  if (!names.length) { el.textContent = 'no histograms uploaded'; return; }
  el.innerHTML = '';
  for (const name of names) {
    const h = d[name];
    if (!h.counts) continue;
    const W = 420, H = 180, PAD = 24;
    const maxc = Math.max(...h.counts, 1);
    const bw = (W - 2 * PAD) / h.counts.length;
    let svg = `<h3>${esc(name)}</h3><svg width="${W}" height="${H}">`;
    h.counts.forEach((c, i) => {
      const bh = c / maxc * (H - 2 * PAD);
      const lo = h.edges ? h.edges[i].toPrecision(3) : i;
      const hi = h.edges ? h.edges[i + 1].toPrecision(3) : i + 1;
      svg += `<rect class="bar" x="${PAD + i * bw}" y="${H - PAD - bh}"
        width="${Math.max(bw - 1, 1)}" height="${bh}">
        <title>[${lo}, ${hi}): ${c}</title></rect>`;
    });
    if (h.edges) svg += `<text x="${PAD}" y="${H - 6}">${h.edges[0].toPrecision(3)}</text>
      <text x="${W - PAD - 30}" y="${H - 6}">${h.edges[h.edges.length - 1].toPrecision(3)}</text>`;
    el.innerHTML += svg + '</svg>';
  }
});
</script></body></html>""".replace("__STYLE__", _STYLE).replace("__ESC__", _ESC_JS)

WORDS_HTML = """<!doctype html>
<html><head><title>nearest words</title><style>__STYLE__</style></head><body>
<h1>Nearest-neighbour explorer</h1>
<p class="muted">queries <a href="/api/nearest?word=&n=10">/api/nearest</a>
over the uploaded word vectors (VPTree cosine search)</p>
<input id="w" placeholder="word"> <button onclick="go()">search</button>
<div id="out"></div>
<script>__ESC__
function go() {
  const w = document.getElementById('w').value;
  fetch('/api/nearest?word=' + encodeURIComponent(w) + '&n=10')
    .then(r => r.json()).then(d => {
      const rows = (d.neighbours || []).map(n =>
        `<tr><td>${esc(n.word)}</td><td>${n.distance.toFixed(4)}</td></tr>`).join('');
      document.getElementById('out').innerHTML = rows
        ? `<table><tr><th>word</th><th>cosine distance</th></tr>${rows}</table>`
        : 'no neighbours (word not in vocab?)';
    });
}
document.getElementById('w').addEventListener('keydown',
  e => { if (e.key === 'Enter') go(); });
</script></body></html>""".replace("__STYLE__", _STYLE).replace("__ESC__", _ESC_JS)

FILTERS_HTML = """<!doctype html>
<html><head><title>learned filters</title><style>__STYLE__</style></head><body>
<h1>Learned filters</h1>
<p class="muted">rendered from <a href="/api/filters">/api/filters</a>
(ref: FilterRenderer.renderFilters — grayscale per-filter weight tiles)</p>
<div id="grids">loading…</div>
<script>__ESC__
fetch('/api/filters').then(r => r.json()).then(d => {
  const el = document.getElementById('grids');
  if (!d.grids || !d.grids.length) { el.textContent = 'no filters uploaded'; return; }
  el.innerHTML = '';
  for (const g of d.grids) {
    const cell = Math.max(3, Math.floor(48 / Math.max(g.width, g.height)));
    const cols = Math.min(g.tiles.length, 10);
    const rows = Math.ceil(g.tiles.length / cols);
    const tw = g.width * cell + 4, th = g.height * cell + 4;
    const cv = document.createElement('canvas');
    cv.width = cols * tw; cv.height = rows * th;
    const ctx = cv.getContext('2d');
    g.tiles.forEach((tile, f) => {
      const ox = (f % cols) * tw, oy = Math.floor(f / cols) * th;
      tile.forEach((rowv, y) => rowv.forEach((v, x) => {
        const gr = Math.round(v * 255);
        ctx.fillStyle = `rgb(${gr},${gr},${gr})`;
        ctx.fillRect(ox + x * cell, oy + y * cell, cell, cell);
      }));
    });
    const h3 = document.createElement('h3');
    h3.textContent = `${g.name} — ${g.tiles.length} filters ${g.width}x${g.height}`;
    el.appendChild(h3); el.appendChild(cv);
  }
});
</script></body></html>""".replace("__STYLE__", _STYLE).replace("__ESC__", _ESC_JS)

ACTIVATIONS_HTML = """<!doctype html>
<html><head><title>activations</title><style>__STYLE__</style></head><body>
<h1>Layer activations</h1>
<p class="muted">rendered from <a href="/api/activations">/api/activations</a>
(ref: NeuralNetPlotter.plotActivations — batch x unit heatmap per layer)</p>
<div id="maps">loading…</div>
<script>__ESC__
fetch('/api/activations').then(r => r.json()).then(d => {
  const el = document.getElementById('maps');
  if (!d.layers || !d.layers.length) { el.textContent = 'no activations uploaded'; return; }
  el.innerHTML = '';
  for (const L of d.layers) {
    const cell = Math.max(2, Math.floor(480 / Math.max(L.cols, L.rows)));
    const cv = document.createElement('canvas');
    cv.width = L.cols * cell; cv.height = L.rows * cell;
    const ctx = cv.getContext('2d');
    L.matrix.forEach((rowv, y) => rowv.forEach((v, x) => {
      // blue(low) -> white -> red(high) diverging map
      const t = Math.max(0, Math.min(1, v));
      const r = Math.round(t < .5 ? 60 + 390 * t : 255);
      const b = Math.round(t > .5 ? 255 - 390 * (t - .5) : 255);
      const g = Math.round(t < .5 ? 100 + 310 * t : 255 - 310 * (t - .5));
      ctx.fillStyle = `rgb(${r},${g},${b})`;
      ctx.fillRect(x * cell, y * cell, cell, cell);
    }));
    const h3 = document.createElement('h3');
    h3.textContent = `${L.name} — ${L.rows} examples x ${L.cols} units, `
      + `mean ${L.mean.toFixed(4)}, std ${L.std.toFixed(4)}`;
    el.appendChild(h3); el.appendChild(cv);
  }
});
</script></body></html>""".replace("__STYLE__", _STYLE).replace("__ESC__", _ESC_JS)

PAGES = {
    "/render/tsne": TSNE_HTML,
    "/render/weights": WEIGHTS_HTML,
    "/render/words": WORDS_HTML,
    "/render/filters": FILTERS_HTML,
    "/render/activations": ACTIVATIONS_HTML,
}


def _norm_tile(patch: np.ndarray) -> list:
    lo, hi = float(patch.min()), float(patch.max())
    return np.round((patch - lo) / (hi - lo + 1e-12), 4).tolist()


def filter_grids(net, max_filters: int = 64) -> list:
    """Per-layer filter tiles in the shape /render/filters expects:
    [{name, width, height, tiles: [[row][col] in 0..1]}].

    Conv layers contribute their kernels (in-channel-averaged); a square
    first dense layer contributes per-unit input-weight images — the same
    two cases the reference renders (ref: plot/FilterRenderer.java
    renderFilters; called on conv weights and on RBM/dense W columns).
    """
    grids = []
    for i, layer in enumerate(net.params_tree):
        if "convweights" in layer:
            w = _numpy(layer["convweights"])  # (out, in, kh, kw)
            o, _, kh, kw = w.shape
            tiles = [_norm_tile(w[f].mean(axis=0)) for f in range(min(o, max_filters))]
            grids.append({"name": f"layer{i}/convweights",
                          "width": int(kw), "height": int(kh), "tiles": tiles})
        elif i == 0 and "W" in layer:
            w = _numpy(layer["W"])  # (n_in, n_out)
            side = int(round(np.sqrt(w.shape[0])))
            if side * side == w.shape[0]:
                tiles = [_norm_tile(w[:, f].reshape(side, side))
                         for f in range(min(w.shape[1], max_filters))]
                grids.append({"name": "layer0/W", "width": side,
                              "height": side, "tiles": tiles})
    return grids


def activation_summaries(net, x, max_rows: int = 64, max_cols: int = 96) -> list:
    """Per-layer activation heatmaps for /render/activations (ref:
    NeuralNetPlotter.plotActivations): each layer's (batch, units) activation
    matrix, strided down to ≤ max_rows×max_cols and min-max normalized,
    plus raw stats."""
    acts = net.feed_forward(x)
    layers = []
    for i, a in enumerate(acts):
        a = _numpy(a)
        m = a.reshape(a.shape[0], -1)
        rs = max(1, -(-m.shape[0] // max_rows))
        cs = max(1, -(-m.shape[1] // max_cols))
        sub = m[::rs, ::cs]
        layers.append({
            "name": f"layer{i}",
            "rows": int(sub.shape[0]), "cols": int(sub.shape[1]),
            "matrix": _norm_tile(sub),
            "mean": float(m.mean()), "std": float(m.std()),
            "min": float(m.min()), "max": float(m.max()),
        })
    return layers


def weight_histograms(net, bins: int = 50) -> Dict[str, Dict]:
    """Per-parameter histograms from a MultiLayerNetwork, in the shape the
    /render/weights view expects: {layerN/key: {counts, edges, ...}}.
    Payload built by plot/renderers._histogram — one histogram contract for
    both the artifact and UI paths."""
    out: Dict[str, Dict] = {}
    for i, layer in enumerate(net.params_tree):
        for key, arr in layer.items():
            out[f"layer{i}/{key}"] = _histogram(_numpy(arr), bins=bins)
    return out
