"""The port's plot package held against the JAX package's (mirroring
``tests/test_plot.py`` and ``test_aux_components.py``'s plotter
listener): exact t-SNE in torch (here on the CPU, ``device="cpu"``),
Barnes-Hut t-SNE, the renderers and the plotting iteration listener (host
copies).

Exact t-SNE is held to JAX from the same inputs with JAX's initial draw
put at the port's draw point (``plot.tsne._initial_y``): P within 1e-6 of
its max at the default perplexity, and the embedding and the costs within
``Y_TOL`` of max|y| and ``COST_TOL`` of each cost (f32 sums in other
orders, pinned once). The gains follow sign(grad) == sign(vel), so a
last-bit difference in a gradient element near 0 flips a gain, and the
descent amplifies it: at the default learning rate (500) two f32 runs
part within tens of iterations at small N. The descent is held over the
first 10 iterations at the defaults and over 50 at a learning rate (20)
whose steps stay small. Barnes-Hut is host numpy in both and is held
within 1e-12."""

import json
import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deeplearning4j_tpu.plot as jp
import deeplearning4j_tpu_torch.plot as tp
from deeplearning4j_tpu.plot import tsne as jtsne
from deeplearning4j_tpu_torch.plot import tsne as ttsne

CPU = "cpu"
P_TOL = 1e-6  # of max(P)
Y_TOL = 1e-3  # of max|y|
COST_TOL = 1e-4  # of each iteration's cost
TOL = 1e-12


def _clusters(n_per=25, d=10, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randn(n_per, d) * 0.3
    b = rng.randn(n_per, d) * 0.3 + 5.0
    return (np.concatenate([a, b]).astype(np.float32),
            np.array([0] * n_per + [1] * n_per))


def _separation(y, labels):
    d = np.linalg.norm(y[:, None] - y[None], axis=-1)
    iu = np.triu_indices(len(y), 1)
    same = labels[:, None] == labels[None]
    return d[iu][same[iu]].mean(), d[iu][~same[iu]].mean()


def _jax_y0(seed, n, k, device):
    y0 = jax.random.normal(jax.random.PRNGKey(seed), (n, k),
                           jnp.float32) * 1e-4
    return torch.from_numpy(np.array(y0)).to(device)


def test_exports_match_jax():
    assert tp.__all__ == jp.__all__


def test_exact_tsne_separates_clusters():
    x, labels = _clusters()
    tsne = tp.Tsne(max_iter=500, perplexity=10.0, learning_rate=100.0,
                   seed=7, device=CPU)
    y = tsne.calculate(x)
    assert y.shape == (50, 2) and np.all(np.isfinite(y))
    same, cross = _separation(y, labels)
    assert cross > 2 * same, (same, cross)
    assert tsne.costs[-1] < tsne.costs[260]


def test_tsne_plot_writes_coords(tmp_path):
    x, labels = _clusters(n_per=10)
    path = str(tmp_path / "coords.csv")
    y = tp.Tsne(max_iter=50, device=CPU).plot(x, 2, labels, path)
    lines = open(path).read().strip().split("\n")
    assert len(lines) == 20 and len(lines[0].split(",")) == 3
    assert y.shape == (20, 2)


def test_tsne_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.Tsne()


def test_affinities_match_jax():
    """_d2p's 50-step bisection over every row at once against JAX's
    vmapped scan, at the default perplexity."""
    x = np.random.RandomState(3).randn(100, 12).astype(np.float32)
    got = ttsne._d2p(ttsne._pairwise_sq_dists(torch.from_numpy(x)),
                     30.0).numpy()
    want = np.asarray(jtsne._d2p(jtsne._pairwise_sq_dists(jnp.asarray(x)),
                                 30.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=P_TOL * want.max())
    assert abs(got.sum() - 1.0) < 1e-5


@pytest.mark.parametrize("perplexity", [5.0, 30.0])
def test_affinities_within_f32_of_float64(perplexity):
    """The f32 affinities within 1e-6 of their max of the same code in
    float64 (at perplexity 5 the port's and JAX's f32 P, each rounded in
    its own order, part by a little more than 1e-6 of the max, so JAX is
    held at the default perplexity above)."""
    x = np.random.RandomState(3).randn(60, 12)
    got = ttsne._d2p(ttsne._pairwise_sq_dists(
        torch.from_numpy(x.astype(np.float32))), perplexity).double()
    exact = ttsne._d2p(ttsne._pairwise_sq_dists(torch.from_numpy(x)),
                       perplexity)
    assert ((got - exact).abs().max() / exact.max()).item() <= P_TOL


@pytest.mark.parametrize("n,lr,iters", [(200, 500.0, 10), (60, 20.0, 50)])
def test_descent_matches_jax(monkeypatch, n, lr, iters):
    """From JAX's initial draw: the embedding and every iteration's cost,
    inside early exaggeration and (at 50 iterations) across the momentum
    switch at 25."""
    monkeypatch.setattr(ttsne, "_initial_y", _jax_y0)
    x = np.random.RandomState(4).randn(n, 8 if iters == 50 else 16)
    kw = dict(max_iter=iters, perplexity=8.0 if iters == 50 else 30.0,
              learning_rate=lr, seed=11, switch_momentum_iteration=25)
    t = tp.Tsne(device=CPU, **kw)
    j = jp.Tsne(**kw)
    y, want = t.calculate(x), j.calculate(x)
    np.testing.assert_allclose(y, want, rtol=0,
                               atol=Y_TOL * np.abs(want).max())
    np.testing.assert_allclose(t.costs, j.costs, rtol=COST_TOL)


def test_barnes_hut_tsne_separates_clusters():
    x, labels = _clusters(n_per=20)
    bh = tp.BarnesHutTsne(theta=0.5, perplexity=8.0, max_iter=300,
                          learning_rate=100.0, seed=7)
    y = bh.fit_transform(x)
    assert y.shape == (40, 2) and np.all(np.isfinite(y))
    same, cross = _separation(y, labels)
    assert cross > 1.5 * same, (same, cross)


def test_barnes_hut_matches_jax():
    x, _ = _clusters(n_per=12, seed=2)
    kw = dict(theta=0.5, perplexity=5.0, max_iter=40, learning_rate=100.0,
              seed=3)
    np.testing.assert_allclose(tp.BarnesHutTsne(**kw).fit_transform(x),
                               jp.BarnesHutTsne(**kw).fit_transform(x),
                               rtol=TOL, atol=TOL)


def test_barnes_hut_theta_zero_matches_exact_gradient():
    from deeplearning4j_tpu.plot.barnes_hut_tsne import \
        _knn_affinities as j_knn
    from deeplearning4j_tpu_torch.plot.barnes_hut_tsne import \
        _knn_affinities

    rng = np.random.RandomState(1)
    y = rng.randn(15, 2)
    x = rng.randn(15, 4)
    rows, cols, vals = _knn_affinities(x, k=5, perplexity=3.0)
    for a, b in zip((rows, cols, vals), j_knn(x, k=5, perplexity=3.0)):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    g = tp.BarnesHutTsne(theta=0.0).gradient(rows, cols, vals, y)
    n = len(y)
    p = np.zeros((n, n))
    for i in range(n):
        for ptr in range(rows[i], rows[i + 1]):
            p[i, cols[ptr]] = vals[ptr]
    d = ((y[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    num = 1.0 / (1.0 + d)
    np.fill_diagonal(num, 0.0)
    z = num.sum()
    diff = y[:, None, :] - y[None, :, :]
    pos = ((p * num)[..., None] * diff).sum(1)
    neg = ((num ** 2)[..., None] * diff).sum(1) / z
    np.testing.assert_allclose(g, pos - neg, atol=1e-8)


def _tiny_conf(mod, num_iterations=1):
    return (mod.NeuralNetConfiguration.Builder()
            .n_in(4).n_out(3).activation_function("tanh").lr(0.1)
            .num_iterations(num_iterations).list(1)
            .override(0, layer_type="OUTPUT", activation_function="softmax",
                      loss_function="MCXENT")
            .pretrain(False).backward(True).build())


def test_neural_net_plotter(tmp_path):
    from deeplearning4j_tpu_torch.nn import conf as tconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (tconf.NeuralNetConfiguration.Builder()
            .n_in(4).n_out(8).num_iterations(1).list(2)
            .override(0, layer_type="DENSE")
            .override(1, layer_type="OUTPUT", n_in=8, n_out=3,
                      activation_function="softmax", loss_function="MCXENT")
            .build())
    net = MultiLayerNetwork(conf, device=CPU).init()
    plotter = tp.NeuralNetPlotter(out_dir=str(tmp_path))
    html = plotter.plot_weight_histograms(net)
    assert os.path.exists(html)
    data = json.load(open(html.replace(".html", ".json")))
    assert "layer0_W" in data and "counts" in data["layer0_W"]
    act_path = plotter.plot_activations(net, np.zeros((5, 4), np.float32))
    assert "activation_layer0" in json.load(open(act_path))


def test_filter_renderer(tmp_path):
    w = np.random.RandomState(0).randn(16, 6)
    path = str(tmp_path / "filters.svg")
    tp.FilterRenderer().render_filters(w, path, 4, 4, cols=3)
    svg = open(path).read()
    assert svg.startswith("<svg") and svg.count("<rect") == 16 * 6


class TestPlotterIterationListener:
    def test_renders_on_frequency(self, tmp_path):
        from deeplearning4j_tpu_torch.nn import conf as tconf
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        from deeplearning4j_tpu_torch.plot.iteration_listener import \
            PlotterIterationListener

        net = MultiLayerNetwork(_tiny_conf(tconf, 7), device=CPU).init()
        listener = PlotterIterationListener(frequency=3,
                                            out_dir=str(tmp_path / "plots"))
        net.set_listeners([listener])
        x = np.random.default_rng(0).random((12, 4)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[np.arange(12) % 3]
        net.fit(x, labels=y)  # 7 iterations → renders at 3 and 6
        assert len(listener.paths) == 2
        for p in listener.paths:
            assert os.path.exists(p + ".json") or os.path.exists(p)

    def test_bad_frequency_rejected(self):
        from deeplearning4j_tpu_torch.plot.iteration_listener import \
            PlotterIterationListener

        with pytest.raises(ValueError):
            PlotterIterationListener(frequency=0)
