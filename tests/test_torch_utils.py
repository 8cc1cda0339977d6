"""The port's host utilities held against the JAX package's: ``Viterbi``,
the counters, ``MovingWindowMatrix``, the math helpers and
``DiskBasedQueue`` (mirroring ``tests/test_utils.py``, with its cases of
the scaleout ``ConfigurationRegistry`` and the reconstruction and
moving-window iterators)
and ``StringGrid``, ``FingerPrintKeyer`` and ``sloppy_math`` (mirroring
``tests/test_string_utils.py``). They are copies, so every function is
also run on the same inputs through both packages: equal, or within
1e-12 in float64."""

import math
import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import numpy as np
import pytest

import deeplearning4j_tpu.utils as ju
import deeplearning4j_tpu_torch.utils as tu
from deeplearning4j_tpu.utils import sloppy_math as jsm
from deeplearning4j_tpu.utils import string_grid as jsg
from deeplearning4j_tpu_torch.utils import sloppy_math as tsm
from deeplearning4j_tpu_torch.utils import string_grid as tsg

TOL = 1e-12


def test_exports_match_jax():
    assert tu.__all__ == ju.__all__


class TestViterbi:
    def test_emission_only_argmax(self):
        em = np.log(np.array([[0.9, 0.1], [0.2, 0.8], [0.7, 0.3]]))
        path, score = tu.Viterbi(2).decode(em)
        assert path.tolist() == [0, 1, 0]
        assert score == pytest.approx(np.log(0.9) + np.log(0.8)
                                      + np.log(0.7))

    def test_transitions_enforce_smoothness(self):
        em = np.log(np.array([[0.9, 0.1], [0.45, 0.55], [0.9, 0.1]]))
        sticky = np.log(np.array([[0.95, 0.05], [0.05, 0.95]]))
        path, _ = tu.Viterbi(2, transitions=sticky).decode(em)
        assert path.tolist() == [0, 0, 0]

    def test_shape_validation(self):
        with pytest.raises(ValueError):
            tu.Viterbi(3).decode(np.zeros((4, 2)))
        with pytest.raises(ValueError):
            tu.Viterbi(2, transitions=np.zeros((3, 3)))

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_decode_matches_jax(self, seed):
        rng = np.random.RandomState(seed)
        em, tr = rng.randn(40, 6), rng.randn(6, 6)
        tp, ts = tu.Viterbi(6, tr).decode(em)
        jp, js = ju.Viterbi(6, tr).decode(em)
        assert tp.tolist() == jp.tolist()
        assert abs(ts - js) <= TOL * max(1.0, abs(js))


class TestCounter:
    def test_basic_counts(self):
        c = tu.Counter()
        for w in ["a", "b", "a", "c", "a"]:
            c.increment_count(w)
        assert c.get_count("a") == 3.0
        assert c.arg_max() == "a"
        assert c.total_count() == 5.0
        assert c.sorted_keys()[0] == "a"

    def test_normalize(self):
        c = tu.Counter()
        c.increment_count("x", 3)
        c.increment_count("y", 1)
        c.normalize()
        assert c.get_count("x") == pytest.approx(0.75)
        assert c.total_count() == pytest.approx(1.0)

    def test_empty_argmax_raises(self):
        with pytest.raises(ValueError):
            tu.Counter().arg_max()

    def test_counter_map(self):
        cm = tu.CounterMap()
        cm.increment_count("the", "cat", 2)
        cm.increment_count("the", "dog", 1)
        cm.increment_count("a", "cat", 1)
        assert cm.get_count("the", "cat") == 2.0
        assert cm.get_count("nope", "cat") == 0.0
        assert cm.total_count() == 4.0
        assert cm.total_size() == 3
        assert cm.get_counter("the").arg_max() == "cat"


class TestMovingWindowMatrix:
    def test_window_count_and_content(self):
        w = tu.MovingWindowMatrix(np.arange(16).reshape(4, 4), 2, 2).windows()
        assert len(w) == 9
        np.testing.assert_array_equal(w[0], [[0, 1], [4, 5]])
        np.testing.assert_array_equal(w[-1], [[10, 11], [14, 15]])

    def test_rotations(self):
        m = np.arange(4).reshape(2, 2)
        w = tu.MovingWindowMatrix(m, 2, 2, add_rotate=True).windows()
        assert len(w) == 4
        np.testing.assert_array_equal(w[1], np.rot90(m))

    def test_oversized_window_rejected(self):
        with pytest.raises(ValueError):
            tu.MovingWindowMatrix(np.zeros((2, 2)), 3, 1)


class TestMathUtils:
    def test_entropy(self):
        assert tu.entropy([0.5, 0.5]) == pytest.approx(np.log(2))
        assert tu.entropy([1.0, 0.0]) == 0.0

    def test_information_gain_perfect_split(self):
        gain = tu.information_gain([5, 5], [[5, 0], [0, 5]])
        assert gain == pytest.approx(np.log(2))

    def test_normalize_to_range(self):
        assert tu.normalize_to_range([0, 5, 10], 0, 1).tolist() == [
            0.0, 0.5, 1.0]
        assert tu.normalize_to_range([3, 3]).tolist() == [0.0, 0.0]

    def test_clamp_and_sos(self):
        assert tu.clamp(5, 0, 3) == 3
        assert tu.clamp(-1, 0, 3) == 0
        assert tu.sum_of_squares([3, 4]) == 25.0

    def test_every_helper_matches_jax(self):
        rng = np.random.RandomState(3)
        v = rng.rand(17)
        p = v / v.sum()
        kids = [rng.randint(0, 9, 4) for _ in range(3)]
        for name, args in (("sigmoid", (rng.randn(9),)),
                           ("entropy", (p,)),
                           ("information_gain", (sum(kids), kids)),
                           ("normalize_to_range", (v, -2.0, 3.0)),
                           ("sum_of_squares", (v,)),
                           ("rounded", (float(v[0]), 3)),
                           ("clamp", (float(v[1]), 0.2, 0.4))):
            np.testing.assert_allclose(getattr(tu, name)(*args),
                                       getattr(ju, name)(*args), rtol=TOL,
                                       atol=TOL, err_msg=name)
        assert tu.uniform(np.random.default_rng(5), 1.0, 2.0) == ju.uniform(
            np.random.default_rng(5), 1.0, 2.0)


class TestDiskBasedQueue:
    def test_fifo_round_trip(self, tmp_path):
        q = tu.DiskBasedQueue(str(tmp_path / "spool"))
        q.add({"a": 1})
        q.add([1, 2, 3])
        assert len(q) == 2
        assert q.peek() == {"a": 1}
        assert q.poll() == {"a": 1}
        assert q.poll() == [1, 2, 3]
        assert q.poll() is None
        assert q.is_empty()

    def test_items_survive_on_disk(self, tmp_path):
        spool = str(tmp_path / "spool")
        q = tu.DiskBasedQueue(spool)
        q.add(np.arange(5))
        assert len(os.listdir(spool)) == 1
        np.testing.assert_array_equal(q.poll(), np.arange(5))
        assert os.listdir(spool) == []

    def test_clear(self, tmp_path):
        q = tu.DiskBasedQueue(str(tmp_path / "s"))
        for i in range(5):
            q.add(i)
        q.clear()
        assert q.is_empty()

    def test_spool_files_match_jax(self, tmp_path):
        """The same items spool to the same file names and bytes, and each
        package's queue reads the other's files."""
        items = [{"a": 1}, np.arange(3.0), "x"]
        tq = tu.DiskBasedQueue(str(tmp_path / "t"))
        jq = ju.DiskBasedQueue(str(tmp_path / "j"))
        for it in items:
            tq.add(it)
            jq.add(it)
        names = sorted(os.listdir(tmp_path / "t"))
        assert names == sorted(os.listdir(tmp_path / "j"))
        for n in names:
            assert (tmp_path / "t" / n).read_bytes() == (
                tmp_path / "j" / n).read_bytes()


class TestFingerPrintKeyer:
    def test_normalizes_case_punct_order(self):
        k = tsg.FingerPrintKeyer()
        assert k.key("Hello, World!") == k.key("world hello")
        assert k.key("  Acme Corp. ") == k.key("acme corp")

    def test_accents_stripped(self):
        k = tsg.FingerPrintKeyer()
        assert k.key("café") == k.key("cafe")

    def test_dedup_tokens(self):
        assert tsg.FingerPrintKeyer().key("a a b") == "a b"

    def test_keys_match_jax(self):
        for s in ("Hello, World!", "  Acme Corp. ", "café Ünïcode b a",
                  "a a b", "", "x-y_z 1 2"):
            assert tsg.FingerPrintKeyer().key(s) == \
                jsg.FingerPrintKeyer().key(s)


def _grid(mod):
    return mod.StringGrid(sep=",", data=["Acme Corp,NY,100",
                                         "acme corp.,NY,200",
                                         "Beta LLC,SF,300"])


class TestStringGrid:
    def test_columns(self):
        g = _grid(tsg)
        assert g.get_num_columns() == 3
        assert g.get_column(1) == ["NY", "NY", "SF"]

    def test_ragged_row_rejected(self):
        with pytest.raises(ValueError):
            _grid(tsg).append_line("only,two")

    def test_dedupe_by_cluster(self):
        g = _grid(tsg)
        g.dedupe_by_cluster(0)
        assert len(g) == 2
        assert g[0][0] == "Acme Corp" and g[1][0] == "Beta LLC"

    def test_cluster_column(self):
        clusters = _grid(tsg).cluster_column(0)
        assert sorted(map(len, clusters.values())) == [1, 2]
        assert clusters == _grid(jsg).cluster_column(0)

    def test_select_and_filter(self):
        g = _grid(tsg)
        assert len(g.select(1, "NY")) == 2
        assert g.filter_rows_by_column(1, {"SF"}) == [2]

    def test_remove_columns_and_merge(self):
        g = _grid(tsg)
        g.merge(0, 1)
        assert g[0][0] == "Acme Corp NY" and g.get_num_columns() == 2

    def test_split_column(self):
        g = tsg.StringGrid(sep="|", data=["a b|x", "c|y"])
        g.split(0, " ")
        assert g[0] == ["a", "b", "x"] and g[1] == ["c", "", "y"]

    def test_similarity_filter(self):
        data = ["Acme Corp,acme corp", "Acme Corp,zebra"]
        g = tsg.StringGrid(sep=",", data=data)
        similar = g.get_all_with_similarity(0.9, 0, 1)
        assert len(similar) == 1 and similar[0][1] == "acme corp"
        assert similar == jsg.StringGrid(sep=",", data=data) \
            .get_all_with_similarity(0.9, 0, 1)
        g.filter_by_similarity(0.9, 0, 1)
        assert len(g) == 1 and g[0][1] == "zebra"

    def test_file_round_trip_reads_jax_files(self, tmp_path):
        g = _grid(tsg)
        p = str(tmp_path / "g.csv")
        g.write_lines_to(p)
        assert list(tsg.StringGrid.from_file(p, sep=",")) == list(g)
        _grid(jsg).write_lines_to(str(tmp_path / "j.csv"))
        assert (tmp_path / "j.csv").read_bytes() == (
            tmp_path / "g.csv").read_bytes()


class TestSloppyMath:
    def test_log_add_matches_naive(self):
        for lx, ly in [(-1.0, -2.0), (0.0, 0.0), (-700.0, -701.0),
                       (5.0, -40.0)]:
            assert tsm.log_add(lx, ly) == pytest.approx(
                math.log(math.exp(lx) + math.exp(ly)), rel=1e-9)

    def test_log_add_extremes(self):
        assert tsm.log_add(float("-inf"), float("-inf")) == float("-inf")
        assert tsm.log_add(-1000.0, 0.0) == 0.0
        assert tsm.log_add(800.0, 800.0) == pytest.approx(800.0
                                                           + math.log(2))

    def test_log_add_all_and_normalize(self):
        v = [-1.0, -2.0, -3.0]
        assert tsm.log_add_all(v) == pytest.approx(
            math.log(sum(math.exp(x) for x in v)))
        assert np.exp(tsm.log_normalize(v)).sum() == pytest.approx(1.0)
        assert tsm.log_add_all([]) == float("-inf")

    def test_predicates(self):
        assert tsm.is_dangerous(0.0) and tsm.is_dangerous(float("nan"))
        assert not tsm.is_dangerous(1.0)
        assert tsm.is_discrete_prob(1.0) and not tsm.is_discrete_prob(1.1)
        assert tsm.relative_difference(1.0, 2.0) == pytest.approx(0.5)

    def test_lambert(self):
        w = tsm.lambert(1.0, 0.5)
        assert w * math.exp(w) == pytest.approx(math.exp(0.5), rel=1e-9)

    def test_every_function_matches_jax(self):
        rng = np.random.RandomState(7)
        v = rng.randn(11) * 30
        for name, args in (("log_add", (v[0], v[1])),
                           ("log_add", (-1000.0, 3.0)),
                           ("log_add_all", (v,)),
                           ("log_normalize", (v,)),
                           ("relative_difference", (v[2], v[3])),
                           ("lambert", (2.5, -0.3)),
                           ("is_dangerous", (v[4],)),
                           ("is_very_dangerous", (float("inf"),)),
                           ("is_discrete_prob", (0.3,))):
            np.testing.assert_allclose(getattr(tsm, name)(*args),
                                       getattr(jsm, name)(*args), rtol=TOL,
                                       atol=TOL, err_msg=name)


class TestConfigurationRegistry:
    def test_register_retrieve_round_trip(self, tmp_path):
        from deeplearning4j_tpu_torch.scaleout.registry import \
            ConfigurationRegistry

        reg = ConfigurationRegistry(str(tmp_path))
        conf = {"lr": 0.1, "layers": [4, 8, 3]}
        reg.register("cluster1", "net-a", conf)
        assert reg.retrieve("cluster1", "net-a") == conf
        assert reg.retrieve("cluster1", "missing") is None
        assert reg.list_ids("cluster1") == ["net-a"]
        assert reg.delete("cluster1", "net-a")
        assert not reg.delete("cluster1", "net-a")

    def test_registry_rejects_traversal(self, tmp_path):
        from deeplearning4j_tpu_torch.scaleout.registry import \
            ConfigurationRegistry

        reg = ConfigurationRegistry(str(tmp_path / "root"))
        with pytest.raises(ValueError):
            reg.register("..", "x", {})
        with pytest.raises(ValueError):
            reg.delete("ns", "..")
        with pytest.raises(ValueError):
            reg.list_ids("..")


class TestExtraIterators:
    def test_reconstruction_iterator(self):
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet
        from deeplearning4j_tpu_torch.datasets.iterator import (
            ListDataSetIterator, ReconstructionDataSetIterator)

        x = np.random.RandomState(0).rand(10, 4).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[np.zeros(10, int)]
        it = ReconstructionDataSetIterator(ListDataSetIterator(DataSet(x, y),
                                                               5))
        it.reset()
        ds = it.next()
        np.testing.assert_array_equal(ds.features, ds.labels)

    def test_moving_window_iterator(self):
        from deeplearning4j_tpu_torch.datasets.iterator import \
            MovingWindowDataSetIterator

        data = np.arange(16).reshape(4, 4)
        it = MovingWindowDataSetIterator(4, data, np.array([1.0]), 2, 2)
        it.reset()
        ds = it.next()
        assert ds.features.shape == (4, 4)
        assert 4 + sum(b.num_examples() for b in [it.next(), it.next()]) == 9

    def test_moving_window_labels(self):
        from deeplearning4j_tpu_torch.datasets.iterator import \
            MovingWindowDataSetIterator

        data = np.arange(16).reshape(4, 4)
        with pytest.raises(ValueError, match="labels"):
            MovingWindowDataSetIterator(4, data, np.ones((4, 1)), 2, 2)
        it = MovingWindowDataSetIterator(4, data, np.ones((9, 1)), 2, 2)
        assert it.total_examples() == 9
        it = MovingWindowDataSetIterator(9, data, np.arange(9, dtype=float),
                                         2, 2)
        ds = it.next()
        assert ds.labels.shape == (9, 1)
        assert np.asarray(ds.labels)[:, 0].tolist() == list(range(9))
