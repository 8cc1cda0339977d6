"""The port's binding of the native host library (deeplearning4j_tpu_torch/
native/lib.py, built by ``g++`` from the repo's native/*.cpp into the
package's ``_build/``) held against the JAX package's binding of the same
sources, and tests/test_native.py's checks through the port: the CSV
parser, the prefetching loader, the buffer pool, the async iterators, the
native CSV DataSet iterator feeding a MultiLayerNetwork, and the corpus
index behind Word2Vec's vocab fast path with its content fallbacks.

Every comparison with the JAX package is exact: both bind one C++ source.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import async_iterator as j_async
from deeplearning4j_tpu.models.word2vec import Word2Vec as JWord2Vec
from deeplearning4j_tpu.native import lib as jlib
from deeplearning4j_tpu.text.sentence_iterator import \
    CollectionSentenceIterator as JSents
from deeplearning4j_tpu_torch.datasets.async_iterator import (
    AsyncDataSetIterator,
    NativeCSVDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
from deeplearning4j_tpu_torch.models.word2vec import Word2Vec
from deeplearning4j_tpu_torch.native import (
    BufferPool,
    NativeCSVLoader,
    load_csv,
    native_available,
)
from deeplearning4j_tpu_torch.native import lib as tlib
from deeplearning4j_tpu_torch.text.sentence_iterator import \
    CollectionSentenceIterator
from deeplearning4j_tpu_torch.text.tokenization import (
    CommonPreprocessor,
    DefaultTokenizerFactory,
)

CPU = "cpu"


@pytest.fixture
def csv_path(tmp_path):
    p = tmp_path / "d.csv"
    rows = [f"{i},{i*2},{i%3}" for i in range(20)]
    p.write_text("\n".join(rows) + "\n")
    return str(p)


def test_native_library_builds_into_the_package_build_dir():
    assert native_available()
    path = tlib.library_path()
    assert path.exists() and path.parent == tlib.BUILD_DIR
    assert path.name.startswith("libdl4j_native_")
    assert tlib.NATIVE_DIR.name == "native"
    assert sorted(p.name for p in tlib.NATIVE_DIR.glob("*.cpp")) == \
        sorted(tlib.SOURCES)


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    for name in tlib.SOURCES:
        (tmp_path / name).write_bytes((tlib.NATIVE_DIR / name).read_bytes())
    monkeypatch.setattr(tlib, "NATIVE_DIR", tmp_path)
    same = tlib.library_path()
    (tmp_path / "text.cpp").write_bytes(
        (tmp_path / "text.cpp").read_bytes() + b"\n// edited\n")
    assert tlib.library_path() != same


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """A source that does not compile raises, naming the compiler's error;
    nothing falls back and nothing is left in the build directory."""
    for name in tlib.SOURCES:
        (tmp_path / name).write_text("int broken( {\n")
    build = tmp_path / "build"
    monkeypatch.setattr(tlib, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(tlib, "BUILD_DIR", build)
    monkeypatch.setattr(tlib, "_lib", None)
    with pytest.raises(RuntimeError, match="native library build failed"
                       "(.|\n)*error"):
        tlib.native_available()
    assert not any(build.glob("*.so")) and not any(build.glob("*.tmp"))
    with pytest.raises(RuntimeError, match="native library build failed"):
        load_csv("unused.csv")


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(tlib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tlib, "_lib", None)
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="not found"):
        tlib.native_available()


class TestLoadCSV:
    def test_parse(self, csv_path):
        tlib.reset_calls()
        arr = load_csv(csv_path)
        assert tlib.CALLS["load_csv"] == 1
        assert arr.shape == (20, 3)
        assert arr[3].tolist() == [3.0, 6.0, 0.0]

    def test_skip_lines(self, tmp_path):
        p = tmp_path / "h.csv"
        p.write_text("header,line\n1,2\n")
        assert load_csv(str(p), skip_lines=1).tolist() == [[1.0, 2.0]]

    def test_missing_file(self):
        with pytest.raises(ValueError):
            load_csv("/definitely/not/here.csv")

    def test_ragged_rows(self, tmp_path):
        p = tmp_path / "r.csv"
        p.write_text("1,2\n3\n")
        with pytest.raises(ValueError, match="ragged|parse"):
            load_csv(str(p))

    def test_matches_numpy_and_jax(self, csv_path):
        native = load_csv(csv_path)
        ref = np.loadtxt(csv_path, delimiter=",", dtype=np.float32, ndmin=2)
        np.testing.assert_array_equal(native, ref)
        np.testing.assert_array_equal(native, jlib.load_csv(csv_path))


class TestNativeLoader:
    def test_batches(self, csv_path):
        ld = NativeCSVLoader(csv_path, batch=8)
        assert ld.native
        tlib.reset_calls()
        sizes = [b.shape for b in ld]
        assert sizes == [(8, 3), (8, 3), (4, 3)]
        assert tlib.CALLS["loader_batch"] == 3
        ld.close()
        with pytest.raises(RuntimeError, match="closed"):
            next(iter(ld))

    def test_drop_last(self, csv_path):
        ld = NativeCSVLoader(csv_path, batch=8, drop_last=True)
        assert [b.shape[0] for b in ld] == [8, 8]
        ld.close()

    def test_shuffle_covers_epoch(self, csv_path):
        ld = NativeCSVLoader(csv_path, batch=6, shuffle_seed=9)
        first_col = sorted(int(v) for b in ld for v in b[:, 0])
        assert first_col == list(range(20))
        ld.close()

    def test_shuffle_deterministic(self, csv_path):
        def run():
            ld = NativeCSVLoader(csv_path, batch=20, shuffle_seed=7)
            out = next(iter(ld)).copy()
            ld.close()
            return out

        np.testing.assert_array_equal(run(), run())

    @pytest.mark.parametrize("kw", [dict(batch=6), dict(batch=6,
                                    shuffle_seed=9), dict(batch=8,
                                    drop_last=True, shuffle_seed=3)])
    def test_batches_equal_jax(self, csv_path, kw):
        ld, jd = NativeCSVLoader(csv_path, **kw), jlib.NativeCSVLoader(
            csv_path, **kw)
        got, want = list(ld), list(jd)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        ld.close()
        jd.close()


class TestBufferPool:
    def test_acquire_release_cycle(self):
        pool = BufferPool(1024, 2)
        assert pool.native
        a, b = pool.acquire(), pool.acquire()
        assert a is not None and b is not None
        assert pool.acquire() is None
        assert pool.available() == 0
        pool.release(a)
        assert pool.available() == 1
        c = pool.acquire()
        assert c is not None and c.array.dtype == np.float32
        pool.close()
        with pytest.raises(RuntimeError, match="closed"):
            pool.acquire()

    def test_buffer_is_writable(self):
        pool = BufferPool(256, 1)
        buf = pool.acquire()
        buf.array[:] = 7.0
        assert buf.array.sum() == 7.0 * buf.array.size
        pool.release(buf)
        pool.close()


class TestAsyncIterator:
    def _backing(self, n=30, batch=7):
        rng = np.random.RandomState(0)
        ds = DataSet(rng.rand(n, 4).astype(np.float32),
                     np.eye(2, dtype=np.float32)[rng.randint(0, 2, n)])
        return ListDataSetIterator(ds, batch)

    def test_same_batches_as_backing(self):
        sync = list(iter(self._backing()))
        async_it = AsyncDataSetIterator(self._backing(), capacity=2)
        got = []
        while async_it.has_next():
            got.append(async_it.next())
        assert len(got) == len(sync)
        for a, b in zip(got, sync):
            np.testing.assert_array_equal(a.features, b.features)

    def test_reset_mid_epoch(self):
        it = AsyncDataSetIterator(self._backing(), capacity=2)
        it.next()
        it.reset()
        total = 0
        while it.has_next():
            total += it.next().num_examples()
        assert total == 30

    def test_multiple_epochs(self):
        it = AsyncDataSetIterator(self._backing(), capacity=3)
        for _ in range(3):
            assert sum(b.num_examples() for b in iter(it)) == 30


class TestNativeCSVDataSetIterator:
    def test_one_hot_and_epoch(self, csv_path):
        it = NativeCSVDataSetIterator(csv_path, 8, num_possible_labels=3)
        assert it.native
        assert it.input_columns() == 2
        total = 0
        while it.has_next():
            ds = it.next()
            assert ds.features.shape[1] == 2
            assert ds.labels.shape[1] == 3
            total += ds.num_examples()
        assert total == 20
        it.reset()
        assert it.has_next()
        it.close()

    @pytest.mark.parametrize("kw", [dict(num_possible_labels=3),
                                    dict(shuffle_seed=5),
                                    dict(num_possible_labels=20,
                                         label_index=0, shuffle_seed=2)])
    def test_batches_equal_jax(self, csv_path, kw):
        it = NativeCSVDataSetIterator(csv_path, 6, **kw)
        jt = j_async.NativeCSVDataSetIterator(csv_path, 6, **kw)
        n = 0
        while jt.has_next():
            assert it.has_next()
            g, w = it.next(), jt.next()
            np.testing.assert_array_equal(g.features, w.features)
            np.testing.assert_array_equal(g.labels, w.labels)
            n += 1
        assert n > 0 and not it.has_next()
        it.close()
        jt.close()

    def test_trains_network(self, tmp_path):
        """The native pipeline feeding a MultiLayerNetwork fit through the
        port, as tests/test_native.py does through JAX."""
        from deeplearning4j_tpu_torch.datasets.fetchers import iris_data
        from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        x, y = iris_data()
        p = tmp_path / "iris.csv"
        p.write_text("\n".join(
            ",".join(f"{v:.4f}" for v in row) + f",{int(lab)}"
            for row, lab in zip(x, y)) + "\n")
        it = NativeCSVDataSetIterator(str(p), 150, num_possible_labels=3,
                                      shuffle_seed=3)
        conf = (NeuralNetConfiguration.Builder()
                .n_in(4).n_out(8).activation_function("tanh").lr(0.1)
                .momentum(0.9).use_ada_grad(True).num_iterations(60).seed(42)
                .weight_init("VI").list(2)
                .override(0, layer_type="DENSE")
                .override(1, layer_type="OUTPUT", n_in=8, n_out=3,
                          activation_function="softmax", loss_function="MCXENT")
                .pretrain(False).backward(True).build())
        net = MultiLayerNetwork(conf, device=CPU).init()
        tlib.reset_calls()
        net.fit(it)
        assert tlib.CALLS["loader_batch"] >= 1
        preds = net.predict(x.astype(np.float32))
        assert (preds == y).mean() > 0.9
        it.close()


class TestNativeCorpusIndex:
    """native/text.cpp tokenize+count+index against the Python path and
    against the JAX package's binding."""

    CORPUS = [
        "the quick brown fox jumps over the lazy dog",
        "the dog barks",
        "lonely",          # 1 kept token -> dropped from the index
        "quick quick fox the",
        "zebra apple apple the",
    ]

    def _python_reference(self, sentences, min_count):
        w = Word2Vec(sentence_iterator=CollectionSentenceIterator(sentences),
                     layer_size=8, min_word_frequency=min_count, seed=1,
                     device=CPU)
        w._native_path_possible = lambda: False
        w.build_vocab()
        return w

    @pytest.mark.parametrize("min_count", [1, 2])
    def test_parity_with_python_path_and_jax(self, min_count):
        ref = self._python_reference(self.CORPUS, min_count)
        text = "\n".join(self.CORPUS).encode()
        tlib.reset_calls()
        words, counts, flat, sids = tlib.corpus_index(text, min_count)
        assert tlib.CALLS["corpus_index"] == 1
        assert words == [vw.word for vw in ref.vocab.words()]
        assert counts.tolist() == [vw.count for vw in ref.vocab.words()]
        np.testing.assert_array_equal(flat, ref._flat)
        np.testing.assert_array_equal(sids, ref._sid)
        jwords, jcounts, jflat, jsids = jlib.corpus_index(text, min_count)
        assert words == jwords
        for a, b in ((counts, jcounts), (flat, jflat), (sids, jsids)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    def test_zipf_corpus_index_equals_jax(self):
        rng = np.random.default_rng(0)
        ids = np.minimum(rng.zipf(1.2, size=(300, 15)), 400)
        sents = [" ".join(f"t{i}" for i in row[: rng.integers(1, 16)])
                 for row in ids]
        text = "\n".join(sents).encode()
        for min_count in (1, 3):
            got = tlib.corpus_index(text, min_count)
            want = jlib.corpus_index(text, min_count)
            assert got[0] == want[0]
            for a, b in zip(got[1:], want[1:]):
                np.testing.assert_array_equal(a, b)

    def test_word2vec_uses_native_path_equivalently(self):
        ref = self._python_reference(self.CORPUS, 1)
        nat = Word2Vec(sentence_iterator=CollectionSentenceIterator(self.CORPUS),
                       layer_size=8, min_word_frequency=1, seed=1, device=CPU)
        tlib.reset_calls()
        nat.build_vocab()
        assert tlib.CALLS["corpus_index"] == 1
        assert [w.word for w in nat.vocab.words()] == [
            w.word for w in ref.vocab.words()]
        np.testing.assert_array_equal(nat._flat, ref._flat)
        np.testing.assert_array_equal(nat._sid, ref._sid)
        for a, b in zip(nat.vocab.words(), ref.vocab.words()):
            assert a.code == b.code and a.points == b.points
        jvec = JWord2Vec(sentence_iterator=JSents(self.CORPUS), layer_size=8,
                         min_word_frequency=1, seed=1)
        jvec.build_vocab()
        np.testing.assert_array_equal(nat._flat, jvec._flat)
        np.testing.assert_array_equal(nat._sid, jvec._sid)

    def test_non_ascii_falls_back(self):
        sents = ["café au lait", "café noir s'il vous plaît"]
        w = Word2Vec(sentence_iterator=CollectionSentenceIterator(sents),
                     layer_size=8, seed=1, device=CPU)
        tlib.reset_calls()
        assert w._native_vocab_index() is None  # unicode -> python path
        assert tlib.corpus_index("café".encode(), 1) is None
        assert tlib.CALLS["corpus_index"] == 0
        w.build_vocab()  # iterator re-iterates fine after the probe
        assert w.vocab.contains("café")
        jw = JWord2Vec(sentence_iterator=JSents(sents), layer_size=8, seed=1)
        assert jw._native_vocab_index() is None
        jw.build_vocab()
        assert [v.word for v in w.vocab.words()] == \
            [v.word for v in jw.vocab.words()]
        np.testing.assert_array_equal(w._flat, jw._flat)

    def test_preprocessor_falls_back(self):
        w = Word2Vec(
            sentence_iterator=CollectionSentenceIterator(["The DOG. barks!"]),
            tokenizer_factory=DefaultTokenizerFactory(CommonPreprocessor()),
            layer_size=8, seed=1, device=CPU,
        )
        assert w._native_vocab_index() is None
        w.build_vocab()
        assert w.vocab.contains("dog")  # lowercased + punctuation stripped

    def test_accumulating_vocab_takes_the_python_path(self):
        w = Word2Vec(sentence_iterator=CollectionSentenceIterator(["a b a"]),
                     layer_size=8, seed=1, device=CPU)
        w.vocab.add_token("seed")
        assert not w._native_path_possible()
