"""The port's clustering held against the JAX package's (mirroring
``tests/test_clustering.py``): k-means with its Lloyd iterations in torch
(here on the CPU, ``device="cpu"``), and the host copies of the KD, VP,
quad and SP trees.

The k-means++ seeding is the same host numpy in both, so the seeded
centers are equal bit for bit; a run's centers and costs agree at f32
(``KM_TOL``: both sum ~N f32 terms a center in other orders) and the
assignments are equal. The trees are copies: equal, or within 1e-12 in
float64."""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import numpy as np
import pytest

import deeplearning4j_tpu.clustering as jc
import deeplearning4j_tpu_torch.clustering as tc

CPU = "cpu"
KM_TOL = 1e-5  # of the largest |center| and of each cost
TOL = 1e-12


def _blobs(n_per=30, seed=0):
    rng = np.random.RandomState(seed)
    centers = np.array([[0.0, 0.0], [10.0, 10.0], [-10.0, 10.0]])
    pts = np.concatenate([c + rng.randn(n_per, 2)
                          for c in centers]).astype(np.float32)
    return pts, np.repeat(np.arange(3), n_per)


def test_exports_match_jax():
    assert tc.__all__ == jc.__all__


class TestKMeans:
    def test_separable_blobs(self):
        pts, labels = _blobs()
        km = tc.KMeansClustering.setup(3, max_iterations=50, seed=3,
                                       device=CPU)
        cs = km.apply_to(pts)
        assert len(cs.clusters) == 3
        assign = np.array([np.argmin(np.linalg.norm(cs.centers - p, axis=1))
                           for p in pts])
        for lab in range(3):
            assert len(set(assign[labels == lab])) == 1
        assert km.iteration_costs[-1] <= km.iteration_costs[0]

    def test_convergence_mode_stops_early(self):
        pts, _ = _blobs()
        km = tc.KMeansClustering.setup_convergence(3, 1e-4,
                                                   max_iterations=500,
                                                   seed=3, device=CPU)
        km.apply_to(pts)
        assert len(km.iteration_costs) < 500

    def test_cosine_distance(self):
        rng = np.random.RandomState(1)
        a = rng.rand(20, 5) + np.array([10, 0, 0, 0, 0])
        b = rng.rand(20, 5) + np.array([0, 10, 0, 0, 0])
        km = tc.KMeansClustering.setup(2, 20, distance="cosine", device=CPU)
        cs = km.apply_to(np.concatenate([a, b]).astype(np.float32))
        assert sorted(len(c.points) for c in cs.clusters) == [20, 20]

    def test_classify_point(self):
        pts, _ = _blobs()
        cs = tc.KMeansClustering.setup(3, 30, device=CPU).apply_to(pts)
        c = cs.classify_point(tc.Point(np.array([10.0, 10.0])), add=False)
        assert np.linalg.norm(c.center - [10, 10]) < 2.0

    def test_default_device_is_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            tc.KMeansClustering(3)

    def test_seeding_equals_jax_bit_for_bit(self):
        rng = np.random.RandomState(8)
        data = rng.randn(500, 16).astype(np.float32)
        for k, seed in ((8, 123), (17, 5)):
            got = tc.KMeansClustering(k, seed=seed, device=CPU)._kpp_init(
                data)
            want = jc.KMeansClustering(k, seed=seed)._kpp_init(data)
            assert np.array_equal(got, want)

    @pytest.mark.parametrize("distance", ["euclidean", "cosine",
                                          "manhattan"])
    @pytest.mark.parametrize("rate", [None, 1e-3])
    def test_run_matches_jax(self, distance, rate):
        """Fixed-iteration and convergence runs: centers, costs and the
        members of every cluster against JAX's."""
        rng = np.random.RandomState(9)
        data = np.concatenate([rng.randn(60, 8) + 4 * rng.randn(1, 8)
                               for _ in range(5)]).astype(np.float32)
        kw = dict(k=5, max_iterations=12, distance=distance, seed=4,
                  min_variation_rate=rate)
        tk = tc.KMeansClustering(device=CPU, **kw)
        jk = jc.KMeansClustering(**kw)
        ts, js = tk.apply_to(data), jk.apply_to(data)
        scale = np.abs(js.centers).max()
        np.testing.assert_allclose(ts.centers, js.centers, rtol=0,
                                   atol=KM_TOL * scale)
        np.testing.assert_allclose(tk.iteration_costs, jk.iteration_costs,
                                   rtol=KM_TOL)
        for a, b in zip(ts.clusters, js.clusters):
            assert [p.array.tobytes() for p in a.points] == [
                p.array.tobytes() for p in b.points]


def _tree_points(tree, q, k):
    return [(np.asarray(p).tolist(), d) for p, d in tree.knn(q, k)]


class TestKDTree:
    def test_nn_matches_bruteforce(self):
        rng = np.random.RandomState(0)
        data = rng.rand(200, 3)
        tree = tc.KDTree(3)
        for row in data:
            tree.insert(row)
        assert tree.size == 200
        for _ in range(20):
            q = rng.rand(3)
            _, d = tree.nn(q)
            assert d == pytest.approx(np.linalg.norm(data - q, axis=1).min())

    def test_knn(self):
        rng = np.random.RandomState(1)
        data = rng.rand(100, 2)
        tree = tc.KDTree(2)
        for row in data:
            tree.insert(row)
        q = np.array([0.5, 0.5])
        brute = np.sort(np.linalg.norm(data - q, axis=1))[:5]
        assert np.allclose([d for _, d in tree.knn(q, 5)], brute)

    def test_range_search(self):
        tree = tc.KDTree(2)
        for row in np.array([[i, j] for i in range(5) for j in range(5)],
                            float):
            tree.insert(row)
        assert len(tree.range_search([1, 1], [3, 3])) == 9

    def test_queries_match_jax(self):
        rng = np.random.RandomState(2)
        data = rng.rand(120, 3)
        trees = []
        for mod in (tc, jc):
            t = mod.KDTree(3)
            for row in data:
                t.insert(row)
            trees.append(t)
        for _ in range(5):
            q = rng.rand(3)
            assert _tree_points(trees[0], q, 6) == _tree_points(trees[1], q,
                                                                6)
        a, b = (t.range_search([0.2] * 3, [0.7] * 3) for t in trees)
        assert [np.asarray(p).tolist() for p in a] == [
            np.asarray(p).tolist() for p in b]


class TestVPTree:
    def test_knn_matches_bruteforce(self):
        rng = np.random.RandomState(2)
        data = rng.rand(150, 4)
        tree = tc.VPTree(data)
        for _ in range(10):
            q = rng.rand(4)
            brute = np.argsort(np.linalg.norm(data - q, axis=1))[:7]
            assert {i for i, _ in tree.search(q, 7)} == set(brute.tolist())

    def test_labels(self):
        tree = tc.VPTree(np.eye(4), labels=["a", "b", "c", "d"])
        res = tree.search(np.array([1.0, 0.1, 0, 0]), 1)
        assert tree.word_for(res[0][0]) == "a"

    def test_cosine(self):
        data = np.array([[1, 0], [0, 1], [0.9, 0.1]], float)
        tree = tc.VPTree(data, similarity="cosine")
        assert {i for i, _ in tree.search(np.array([1.0, 0.0]), 2)} == {0, 2}


class TestQuadTree:
    def test_invariants(self):
        data = np.random.RandomState(3).randn(64, 2)
        tree = tc.QuadTree(data)
        assert tree.is_correct()
        assert tree.cum_size == 64
        assert np.allclose(tree.center_of_mass, data.mean(0))

    def test_non_edge_forces_nonzero(self):
        data = np.random.RandomState(4).randn(32, 2)
        neg_f = np.zeros(2)
        z = tc.QuadTree(data).compute_non_edge_forces(0, data[0], theta=0.5,
                                                      neg_f=neg_f)
        assert z > 0 and np.linalg.norm(neg_f) > 0

    def test_forces_match_jax(self):
        data = np.random.RandomState(10).randn(80, 2)
        t, j = tc.QuadTree(data), jc.QuadTree(data)
        np.testing.assert_allclose(t.center_of_mass, j.center_of_mass,
                                   rtol=TOL, atol=TOL)
        for i in (0, 17, 79):
            fa, fb = np.zeros(2), np.zeros(2)
            za = t.compute_non_edge_forces(i, data[i], 0.5, fa)
            zb = j.compute_non_edge_forces(i, data[i], 0.5, fb)
            assert abs(za - zb) <= TOL * abs(zb)
            np.testing.assert_allclose(fa, fb, rtol=TOL, atol=TOL)


class TestSpTree:
    def test_invariants_3d(self):
        data = np.random.RandomState(5).randn(50, 3)
        tree = tc.SpTree(data)
        assert tree.is_correct()
        assert tree.cum_size == 50
        assert np.allclose(tree.center_of_mass, data.mean(0))

    def test_theta_zero_matches_exact_repulsion(self):
        y = np.random.RandomState(6).randn(20, 2)
        i = 3
        neg_f = np.zeros(2)
        z = tc.SpTree(y).compute_non_edge_forces(i, y[i], theta=0.0,
                                                 neg_f=neg_f)
        diff = y[i] - np.delete(y, i, axis=0)
        q = 1.0 / (1.0 + (diff * diff).sum(1))
        assert z == pytest.approx(q.sum(), rel=1e-9)
        assert np.allclose(neg_f, (q[:, None] ** 2 * diff).sum(0))

    def test_edge_forces(self):
        y = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
        rows, cols = np.array([0, 2, 3, 4]), np.array([1, 2, 0, 0])
        vals = np.array([0.5, 0.5, 1.0, 1.0])
        pos_f = tc.SpTree.compute_edge_forces(rows, cols, vals, y)
        assert pos_f.shape == (3, 2)
        assert np.allclose(pos_f[0], 0.5 * (y[0] - y[1]) / 2
                           + 0.5 * (y[0] - y[2]) / 2)

    def test_forces_match_jax(self):
        rng = np.random.RandomState(11)
        y = rng.randn(60, 3)
        t, j = tc.SpTree(y), jc.SpTree(y)
        for i in (0, 31, 59):
            fa, fb = np.zeros(3), np.zeros(3)
            za = t.compute_non_edge_forces(i, y[i], 0.5, fa)
            zb = j.compute_non_edge_forces(i, y[i], 0.5, fb)
            assert abs(za - zb) <= TOL * abs(zb)
            np.testing.assert_allclose(fa, fb, rtol=TOL, atol=TOL)
        rows = np.arange(0, 61, 1)
        cols = rng.randint(0, 60, 60)
        vals = rng.rand(60)
        np.testing.assert_allclose(
            tc.SpTree.compute_edge_forces(rows, cols, vals, y),
            jc.SpTree.compute_edge_forces(rows, cols, vals, y), rtol=TOL,
            atol=TOL)
