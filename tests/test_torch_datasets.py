"""The port's datasets and evaluation (deeplearning4j_tpu_torch/datasets,
eval) held against the JAX package's, on the CPU, and the ``digits_mlp``
accuracy gate through the port.

The readers, fetchers, iterators and vectorizer are numpy on both sides:
the same files and seeds must give the same arrays exactly (tolerance 0),
and ``Evaluation.stats()`` the same text. The gate runs
accuracy_gates.py's protocol (``gate_digits_mlp``: sklearn's bundled
digits, a seeded 1500/297 split, ``fit_epochs`` for 40 epochs at batch 128)
with the port's network on the CPU, and must reach its threshold, 0.96.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import struct

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import async_iterator as j_async
from deeplearning4j_tpu.datasets import fetchers as j_fetchers
from deeplearning4j_tpu.datasets import impl as j_impl
from deeplearning4j_tpu.datasets import records as j_records
from deeplearning4j_tpu.datasets import vectorizer as j_vectorizer
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.eval import evaluation as j_eval
from deeplearning4j_tpu_torch.datasets import async_iterator as t_async
from deeplearning4j_tpu_torch.datasets import fetchers as t_fetchers
from deeplearning4j_tpu_torch.datasets import impl as t_impl
from deeplearning4j_tpu_torch.datasets import records as t_records
from deeplearning4j_tpu_torch.datasets import vectorizer as t_vectorizer
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
from deeplearning4j_tpu_torch.eval import evaluation as t_eval


def _batches(it):
    it.reset()
    out = []
    while it.has_next():
        ds = it.next()
        out.append((ds.features, ds.labels))
    return out


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype
        np.testing.assert_array_equal(gx, wx)
        if wy is None:
            assert gy is None
        else:
            np.testing.assert_array_equal(gy, wy)


# --------------------------------------------------------------- readers ----

@pytest.fixture
def csv_file(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.standard_normal((23, 5)).round(4)
    y = rng.randint(0, 4, 23)
    p = tmp_path / "d.csv"
    p.write_text("h1;h2;h3;h4;h5;y\n\n" + "\n".join(
        f"{int(l)};" + ";".join(f"{v:.4f}" for v in r)
        for r, l in zip(x, y)) + "\n")
    return str(p)


@pytest.mark.parametrize("label_index,labels,batch", [
    (0, 4, 5),      # label first, a remainder batch of 3
    (0, None, 7),   # regression: the raw label column
    (-1, None, 23), # the last column as the label, one batch
])
def test_csv_iterator_matches_jax(csv_file, label_index, labels, batch):
    it = {}
    for name, mod in (("port", t_records), ("jax", j_records)):
        reader = mod.CSVRecordReader(csv_file, skip_lines=1, delimiter=";")
        it[name] = mod.RecordReaderDataSetIterator(
            reader, batch, label_index=label_index,
            num_possible_labels=labels)
    got, want = _batches(it["port"]), _batches(it["jax"])
    _same_batches(got, want)
    assert [b[0].shape[0] for b in got][-1] == 23 - batch * (
        (23 - 1) // batch)
    # reset, and a second pass gives the same batches
    _same_batches(_batches(it["port"]), want)
    for attr in ("batch", "total_examples", "input_columns",
                 "total_outcomes"):
        assert getattr(it["port"], attr)() == getattr(it["jax"], attr)()
    # has_next is idempotent (one-record lookahead)
    it["port"].reset()
    assert it["port"].has_next() and it["port"].has_next()
    assert it["port"].next(2).features.shape[0] == 2


def test_csv_label_out_of_range_raises_like_jax(csv_file):
    for mod in (t_records, j_records):
        it = mod.RecordReaderDataSetIterator(
            mod.CSVRecordReader(csv_file, skip_lines=1, delimiter=";"), 50,
            label_index=0, num_possible_labels=3)
        with pytest.raises(ValueError, match="label value out of range"):
            it.next()


def test_svmlight_and_list_readers_match_jax(tmp_path):
    p = tmp_path / "d.svm"
    p.write_text("1 1:0.5 3:2.0 # a comment\n\n0 2:-1.5\n2 4:3.25 1:1\n")
    for zero_based in (False, True):
        n = 5 if zero_based else 4
        got = list(t_records.SVMLightRecordReader(str(p), n, zero_based))
        want = list(j_records.SVMLightRecordReader(str(p), n, zero_based))
        assert got == want and len(got) == 3
    rows = [[1, 2.5, 0], [3, 4, 1], ["5", "6", "0"]]
    assert list(t_records.ListStringRecordReader(rows)) == \
        list(j_records.ListStringRecordReader(rows))
    it = t_records.RecordReaderDataSetIterator(
        t_records.ListStringRecordReader(rows), 2, num_possible_labels=2)
    jt = j_records.RecordReaderDataSetIterator(
        j_records.ListStringRecordReader(rows), 2, num_possible_labels=2)
    _same_batches(_batches(it), _batches(jt))


def _write_pnm(path, magic, w, h, maxval, pixels):
    header = f"{magic}\n# a comment\n{w} {h}\n{maxval}\n".encode()
    if magic in ("P2", "P3"):
        body = " ".join(str(int(v)) for v in pixels.ravel()).encode()
    elif maxval > 255:
        body = pixels.astype(">u2").tobytes()
    else:
        body = pixels.astype(np.uint8).tobytes()
    path.write_bytes(header + body)


@pytest.fixture
def image_tree(tmp_path):
    """Two classes of small images in every supported format, and one file
    the readers skip."""
    rng = np.random.RandomState(1)
    root = tmp_path / "faces"
    for ci, person in enumerate(("ann", "bob")):
        d = root / person
        d.mkdir(parents=True)
        _write_pnm(d / "a.pgm", "P5", 6, 4, 255, rng.randint(0, 256, (4, 6)))
        _write_pnm(d / "b.pgm", "P2", 6, 4, 15, rng.randint(0, 16, (4, 6)))
        _write_pnm(d / "c.pgm", "P5", 6, 4, 1023,
                   rng.randint(0, 1024, (4, 6)))
        np.save(d / "d.npy", rng.random_sample((4, 6)).astype(np.float32))
        (d / "notes.txt").write_text("not an image")
        _write_pnm(root / f"rgb{ci}.ppm", "P6", 3, 2, 255,
                   rng.randint(0, 256, (2, 3, 3)))
    _write_pnm(root / "rgb.pnm", "P3", 3, 2, 255,
               rng.randint(0, 256, (2, 3, 3)))
    return root


def test_image_readers_match_jax(image_tree):
    for name in ("rgb0.ppm", "rgb.pnm", "ann/a.pgm", "ann/b.pgm",
                 "ann/c.pgm", "bob/d.npy"):
        got = t_records.load_image(str(image_tree / name))
        want = j_records.load_image(str(image_tree / name))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unsupported image format"):
        t_records.load_image(str(image_tree / "ann" / "notes.txt"))
    for size in ((None, None), (3, 5)):
        got = t_records.ImageRecordReader(str(image_tree), *size)
        want = j_records.ImageRecordReader(str(image_tree), *size)
        assert got.labels == want.labels == ["ann", "bob"]
        assert list(got) == list(want) and len(list(got)) == 8


# ------------------------------------------------------------ evaluation ----

def test_evaluation_and_confusion_matrix_match_jax():
    rng = np.random.RandomState(2)
    ev, jev = t_eval.Evaluation(), j_eval.Evaluation()
    for n in (17, 40):
        real = np.eye(5, dtype=np.float32)[rng.randint(0, 5, n)]
        guess = rng.random_sample((n, 5)).astype(np.float32)
        ev.eval(torch.from_numpy(real), torch.from_numpy(guess))
        jev.eval(real, guess)
    ev.eval_classes([0, 1, 6], np.array([1, 1, 6]))
    jev.eval_classes([0, 1, 6], np.array([1, 1, 6]))
    assert ev.stats() == jev.stats()
    assert "Accuracy:" in ev.stats()
    np.testing.assert_array_equal(ev.confusion.to_array(),
                                  jev.confusion.to_array())
    for c in range(7):
        assert ev.precision(c) == jev.precision(c)
        assert ev.recall(c) == jev.recall(c)
        assert ev.f1(c) == jev.f1(c)
    assert (ev.accuracy(), ev.precision(), ev.recall(), ev.f1()) == \
        (jev.accuracy(), jev.precision(), jev.recall(), jev.f1())
    cm, jcm = t_eval.ConfusionMatrix([0, 3]), j_eval.ConfusionMatrix([0, 3])
    for a, p, k in ((0, 1, 2), (3, 3, 1)):
        cm.add(a, p, k)
        jcm.add(a, p, k)
    np.testing.assert_array_equal(cm.to_array(), jcm.to_array())
    assert t_eval.Evaluation().stats() == j_eval.Evaluation().stats()
    bf = t_eval.Evaluation()
    bf.eval(torch.eye(3), torch.eye(3, dtype=torch.bfloat16))
    assert bf.accuracy() == 1.0


# -------------------------------------------------------------- fetchers ----

def _fetcher_batches(f, n):
    f.reset()
    out = []
    while f.has_more():
        f.fetch(n)
        ds = f.next()
        out.append((ds.features, ds.labels))
    return out


@pytest.mark.parametrize("make", [
    lambda m: m.IrisDataFetcher(),
    lambda m: m.IrisDataFetcher(normalize=False, shuffle_seed=None),
    lambda m: m.DigitsDataFetcher(),
    lambda m: m.MnistDataFetcher(num_examples=300, synthetic=True),
    lambda m: m.MnistDataFetcher(binarize=False, num_examples=64,
                                 synthetic=True),
    lambda m: m.CurvesDataFetcher(num_examples=50, dim=32),
    lambda m: m.LFWDataFetcher(40, width=12, height=10),
], ids=["iris", "iris_raw", "digits", "mnist_synthetic", "mnist_gray",
        "curves", "lfw_synthetic"])
def test_fetchers_match_jax(make):
    got, want = make(t_fetchers), make(j_fetchers)
    assert (got.total_examples(), got.input_columns(),
            got.total_outcomes()) == (want.total_examples(),
                                      want.input_columns(),
                                      want.total_outcomes())
    _same_batches(_fetcher_batches(got, 64), _fetcher_batches(want, 64))
    with pytest.raises(RuntimeError, match="fetch"):
        got.reset() or got.next()


def test_raw_data_functions_match_jax():
    for fn, kw in (("iris_data", {}), ("iris_data", {"normalize": False}),
                   ("digits_data", {}), ("digits_data", {"normalize": False}),
                   ("synthetic_mnist", {"num_examples": 33, "seed": 5}),
                   ("synthetic_faces", {"num_examples": 9, "num_people": 3,
                                        "width": 7, "height": 5})):
        for got, want in zip(getattr(t_fetchers, fn)(**kw),
                             getattr(j_fetchers, fn)(**kw)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def _write_idx(path, arr):
    dims = arr.shape
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | len(dims)))
        for d in dims:
            f.write(struct.pack(">I", d))
        f.write(arr.astype(np.uint8).tobytes())


def test_mnist_idx_reader_matches_jax(tmp_path, monkeypatch):
    rng = np.random.RandomState(3)
    _write_idx(tmp_path / "train-images-idx3-ubyte",
               rng.randint(0, 256, (20, 28, 28)))
    _write_idx(tmp_path / "train-labels-idx1-ubyte", rng.randint(0, 10, 20))
    monkeypatch.setenv("MNIST_DIR", str(tmp_path))
    got = t_fetchers.MnistDataFetcher(num_examples=15)
    want = j_fetchers.MnistDataFetcher(num_examples=15)
    assert not got.synthetic and not want.synthetic
    _same_batches(_fetcher_batches(got, 8), _fetcher_batches(want, 8))


def test_lfw_fetcher_reads_a_directory_like_jax(image_tree, tmp_path):
    root = tmp_path / "lfw"
    for person in ("ann", "bob"):
        (root / person).mkdir(parents=True)
        for name in ("a.pgm", "d.npy"):
            src = image_tree / person / name
            (root / person / name).write_bytes(src.read_bytes())
    got = t_fetchers.LFWDataFetcher(10, path=str(root), width=4, height=3)
    want = j_fetchers.LFWDataFetcher(10, path=str(root), width=4, height=3)
    assert got.num_people == want.num_people == 2
    _same_batches(_fetcher_batches(got, 3), _fetcher_batches(want, 3))
    (tmp_path / "empty" / "x").mkdir(parents=True)
    with pytest.raises(ValueError, match="no readable images"):
        t_fetchers.LFWDataFetcher(5, path=str(tmp_path / "empty"))


@pytest.mark.parametrize("make", [
    lambda m: m.IrisDataSetIterator(32),
    lambda m: m.MnistDataSetIterator(50, 120, synthetic=True),
    lambda m: m.CurvesDataSetIterator(16, 40),
    lambda m: m.LFWDataSetIterator(7, 20, width=9, height=9),
], ids=["iris", "mnist", "curves", "lfw"])
def test_impl_iterators_match_jax(make):
    got, want = make(t_impl), make(j_impl)
    _same_batches(_batches(got), _batches(want))
    assert got.total_examples() == want.total_examples()


# ------------------------------------------------------------ vectorizer ----

@pytest.mark.parametrize("labels", [True, False])
def test_dataset_files_cross_packages(tmp_path, labels):
    rng = np.random.RandomState(4)
    x = rng.standard_normal((6, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.randint(0, 2, 6)] if labels else None
    p1 = t_vectorizer.save_dataset(str(tmp_path / "port"), DataSet(x, y))
    p2 = j_vectorizer.save_dataset(str(tmp_path / "jax"), JDataSet(x, y))
    assert p1.endswith(".npz") and p2.endswith(".npz")
    for got in (j_vectorizer.load_dataset(p1), t_vectorizer.load_dataset(p2),
                t_vectorizer.load_dataset(str(tmp_path / "port"))):
        np.testing.assert_array_equal(got.features, x)
        if labels:
            np.testing.assert_array_equal(got.labels, y)
        else:
            assert got.labels is None


def test_image_vectorizers_match_jax(image_tree):
    for kw in ({}, {"width": 3, "height": 2}):
        got = t_vectorizer.ImageVectorizer(
            str(image_tree / "ann" / "a.pgm"), 4, 2, **kw).vectorize()
        want = j_vectorizer.ImageVectorizer(
            str(image_tree / "ann" / "a.pgm"), 4, 2, **kw).vectorize()
        _same_batches([(got.features, got.labels)],
                      [(want.features, want.labels)])
    got = t_vectorizer.DirectoryImageVectorizer(
        str(image_tree), 4, 4, max_examples=5).vectorize()
    want = j_vectorizer.DirectoryImageVectorizer(
        str(image_tree), 4, 4, max_examples=5).vectorize()
    _same_batches([(got.features, got.labels)],
                  [(want.features, want.labels)])
    with pytest.raises(NotImplementedError):
        t_vectorizer.Vectorizer().vectorize()


# -------------------------------------------------------- async iterator ----

def test_async_iterator_yields_its_base_batches(csv_file):
    def base():
        return t_records.RecordReaderDataSetIterator(
            t_records.CSVRecordReader(csv_file, skip_lines=1, delimiter=";"),
            4, label_index=0, num_possible_labels=4)

    want = _batches(base())
    it = t_async.AsyncDataSetIterator(base(), capacity=2)
    _same_batches(_batches(it), want)
    _same_batches([(b.features, b.labels) for b in it], want)  # re-iterable
    assert (it.batch(), it.total_outcomes()) == (4, 4)
    jt = j_async.AsyncDataSetIterator(
        j_records.RecordReaderDataSetIterator(
            j_records.CSVRecordReader(csv_file, skip_lines=1, delimiter=";"),
            4, label_index=0, num_possible_labels=4), capacity=2)
    _same_batches(_batches(it), _batches(jt))
    with pytest.raises(StopIteration):
        it.next()


def test_async_iterator_surfaces_its_producer_error(csv_file):
    bad = t_records.RecordReaderDataSetIterator(
        t_records.CSVRecordReader(csv_file, skip_lines=1, delimiter=";"),
        4, label_index=0, num_possible_labels=2)
    it = t_async.AsyncDataSetIterator(bad)
    with pytest.raises(ValueError, match="label value out of range"):
        while it.has_next():
            it.next()


def test_native_csv_iterator_raises_naming_its_slice(csv_file):
    """The iterator raised until slice 6 bound the native library; now it
    runs over the native loader and yields the JAX package's batches, and
    the test keeps its name."""
    kw = dict(num_possible_labels=4, label_index=0, delimiter=";",
              skip_lines=1)
    it = t_async.NativeCSVDataSetIterator(csv_file, 4, **kw)
    jt = j_async.NativeCSVDataSetIterator(csv_file, 4, **kw)
    assert it.native
    assert (it.total_examples(), it.input_columns(), it.total_outcomes()) \
        == (23, 5, 4)
    _same_batches(_batches(it), _batches(jt))
    it.close()
    jt.close()


# ------------------------------------------------------- the digits gate ----

def test_digits_mlp_gate_through_the_port():
    """accuracy_gates.gate_digits_mlp's protocol through the port."""
    from accuracy_gates import _split

    from deeplearning4j_tpu_torch.datasets.fetchers import digits_data
    from deeplearning4j_tpu_torch.models.zoo import digits_mlp
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    x, y = digits_data()
    (xtr, ytr), (xte, yte) = _split(x, y, 1500)
    assert (xtr.shape[0], xte.shape[0]) == (1500, 297)
    net = MultiLayerNetwork(digits_mlp(), device="cpu").init()
    net.fit_epochs(ListDataSetIterator(
        DataSet(xtr, np.eye(10, dtype=np.float32)[ytr]), 128), num_epochs=40)
    assert net._iteration == 40 * 12
    ev = t_eval.Evaluation()
    ev.eval(np.eye(10, dtype=np.float32)[yte], net.label_probabilities(xte))
    assert ev.accuracy() >= 0.96, ev.stats()
