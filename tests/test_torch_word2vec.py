"""The port's Word2Vec (deeplearning4j_tpu_torch/models/word2vec.py) held
against the JAX package's on the CPU: the pair blocks, the SGNS (per-pair
and group-shared negatives) and HS step bodies, whole device epochs, whole
fits through the native and the Python vocab paths, the lookup table's
lazy sync, the serializers across packages, and the learning checks of
tests/test_word2vec.py through the port.

Random draws are JAX's, put in at the port's draw points with its key
splits replayed (tests/_torch_nlp_draws.py); the numpy-seeded embedding
init needs no injection.

Tolerances, stated once for this module: pair blocks, negative tables,
group sizes, keep probabilities, Huffman tables and pair counts exactly;
one update step within 1e-6 of the table's max |value|; device epochs and
whole fits within 1e-5 absolute on every table (the tables' values are a
few tenths at most).
"""

import os
import types

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.models import embeddings as jemb
from deeplearning4j_tpu.models import word2vec as jw2v
from deeplearning4j_tpu.text.sentence_iterator import \
    CollectionSentenceIterator as JSents
from deeplearning4j_tpu_torch.models import embeddings as temb
from deeplearning4j_tpu_torch.models import word2vec as tw2v
from deeplearning4j_tpu_torch.native import lib as tlib
from deeplearning4j_tpu_torch.text.sentence_iterator import \
    CollectionSentenceIterator

from _torch_nlp_draws import inject_jax_draws

STEP_TOL = 1e-6     # of the table's max |value|
EPOCH_TOL = 1e-5    # absolute
CPU = "cpu"


def _t(a, dtype=None):
    a = np.asarray(a)
    if dtype is not None:
        a = a.astype(dtype)
    return torch.from_numpy(a.copy())


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close_to_max(got, want, tol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: {err} > {bound}"


def _toy_corpus():
    # two topic clusters, as tests/test_word2vec.py builds them
    fruit = "apple banana cherry fruit sweet juice"
    tech = "cpu gpu chip silicon compute memory"
    sents = []
    rng = np.random.default_rng(0)
    for _ in range(200):
        sents.append(" ".join(rng.permutation(fruit.split()).tolist()))
        sents.append(" ".join(rng.permutation(tech.split()).tolist()))
    return sents


def _zipf_corpus(n_sents=60, words=12, vocab=300, seed=0):
    """Sentences over a zipf vocabulary: many ties in the counts, frequent
    words that subsampling thins."""
    rng = np.random.default_rng(seed)
    ids = np.minimum(rng.zipf(1.3, size=(n_sents, words)), vocab) - 1
    return [" ".join(f"w{i}" for i in row) for row in ids]


# ---------------------------------------------------------- host helpers ----

def test_neg_group_size_matches_jax():
    for bsz in list(range(1, 200)) + [65540, 8190, 2050]:
        for cap in (1, 5, 25):
            assert tw2v.neg_group_size(bsz, cap) == \
                jw2v.neg_group_size(bsz, cap)
    for batch_size, window, cap in [(2048, 5, 25), (100, 3, 25),
                                    (7, 1, 25), (8192, 5, 25),
                                    (65536, 5, 25)]:
        block = max(-(-batch_size // (2 * window)), 1)
        bsz = block * 2 * window
        g = tw2v.neg_group_size(bsz, cap)
        assert bsz % g == 0 and 1 <= g <= cap


@pytest.mark.parametrize("slots", [1 << 10, 1 << 14])
def test_build_neg_table_matches_jax(slots):
    probs = np.random.default_rng(3).random(97) ** 3
    got = tw2v.build_neg_table(probs, slots=slots, device=CPU)
    want = np.asarray(jw2v.build_neg_table(probs, slots=slots))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(_np(got), want)


def test_word2vec_requires_objective():
    with pytest.raises(ValueError):
        tw2v.Word2Vec(negative=0, use_hierarchic_softmax=False, device=CPU)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_entry_point_raises_without_cuda():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tw2v.Word2Vec(sentence_iterator=CollectionSentenceIterator(["a b"]))


def test_mesh_and_sharded_steps_raise_naming_item_18():
    """The mesh path is ported (tests/test_torch_word2vec_mesh.py holds it
    against JAX's): a mesh without the "data" axis it splits over raises,
    naming the axis, where JAX's would fail on the missing key."""
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh

    no_data = Mesh(("model",), (1,))
    with pytest.raises(ValueError, match="'data'"):
        tw2v.Word2Vec(mesh=no_data, device=CPU)
    with pytest.raises(ValueError, match="'data'"):
        tw2v.make_sharded_sgns_step(no_data, 5)
    with pytest.raises(ValueError, match="'data'"):
        tw2v.make_sharded_hs_step(no_data)
    one = Mesh(("data",), (1,))
    vec = tw2v.Word2Vec(sentence_iterator=CollectionSentenceIterator(["a b"]),
                        mesh=one, batch_size=7, device=CPU)
    assert vec.mesh is one and vec.batch_size == 7


def test_vectorized_pairs_match_bruteforce():
    """The port's host pair generator (the oracle of the device pair blocks)
    equals the per-position definition: pair (center i, context j) exists
    iff 0<|i-j|<=b_i within a sentence."""
    vec = tw2v.Word2Vec(sentence_iterator=CollectionSentenceIterator(["x"]),
                        window=3, negative=1, device=CPU)
    sents = [np.array([1, 2, 3, 4, 5], np.int32),
             np.array([6, 7], np.int32),
             np.array([8, 9, 10], np.int32)]

    class FixedRng:
        def integers(self, lo, hi, size):
            return b[:size]

    b = np.array([1, 3, 2, 1, 2, 1, 2, 3, 1, 2], np.int64)
    c, t = vec._skipgram_pairs(sents, FixedRng())
    got = set(zip(c.tolist(), t.tolist()))
    flat = np.concatenate(sents)
    sid = np.repeat(np.arange(3), [5, 2, 3])
    want = set()
    for i in range(flat.size):
        for j in range(flat.size):
            if i != j and sid[i] == sid[j] and abs(i - j) <= b[i]:
                want.add((int(flat[i]), int(flat[j])))
    assert got == want


@pytest.mark.parametrize("n_kept", [10, 7])
def test_pair_block_matches_jax_pair_by_pair(n_kept):
    """Over a padded tail (and, at n_kept 7, past the kept count), every
    center, context and weight equals JAX's; the weighted pairs are the host
    oracle's multiset."""
    flat = np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], np.int32)
    sid = np.array([0, 0, 0, 0, 0, 1, 1, 2, 2, 2], np.int32)
    b = np.array([1, 3, 2, 1, 2, 1, 2, 3, 1, 2], np.int64)
    block, window = 4, 3
    dev_pairs = []
    for pos0 in range(0, flat.size + block, block):  # overrun on purpose
        got = tw2v._pair_block(_t(flat, np.int64), _t(sid, np.int64),
                               _t(b), torch.tensor(n_kept), pos0, block,
                               window)
        want = jw2v._pair_block(jnp.asarray(flat), jnp.asarray(sid),
                                jnp.asarray(b), jnp.asarray(n_kept), pos0,
                                block, window)
        for g, w, name in zip(got, want, ("ctr", "ctx", "weights")):
            np.testing.assert_array_equal(_np(g), np.asarray(w),
                                          err_msg=f"{name} at {pos0}")
        ctr, ctx, w = (_np(x) for x in got)
        for i in range(block):
            for j in range(ctx.shape[1]):
                if w[i, j] > 0:
                    dev_pairs.append((int(ctr[i]), int(ctx[i, j])))

    vec = tw2v.Word2Vec(sentence_iterator=CollectionSentenceIterator(["x"]),
                        window=window, negative=1, device=CPU)

    class FixedRng:
        def integers(self, lo, hi, size):
            return b[:size]

    hc, ht = vec._pairs_from_flat(flat[:n_kept], sid[:n_kept], FixedRng())
    assert sorted(dev_pairs) == sorted(zip(hc.tolist(), ht.tolist()))


# ------------------------------------------------------------ step bodies ----

def _tables(v, d, seed):
    rng = np.random.default_rng(seed)
    syn0 = ((rng.random((v, d)) - 0.5) / d).astype(np.float32)
    syn1 = (rng.normal(size=(v, d)) * 0.1).astype(np.float32)
    return syn0, syn1


def test_sgns_update_matches_jax():
    v, d, b, k = 23, 16, 48, 4   # small V: many colliding rows
    syn0, syn1neg = _tables(v, d, 0)
    rng = np.random.default_rng(1)
    centers = rng.integers(0, v, b).astype(np.int32)
    contexts = rng.integers(0, v, b).astype(np.int32)
    negs = rng.integers(0, v, (b, k)).astype(np.int32)
    weights = (rng.random(b) < 0.8).astype(np.float32)  # padding mask
    lr = np.float32(0.05)
    want = jw2v._sgns_update(jnp.asarray(syn0), jnp.asarray(syn1neg),
                             jnp.asarray(centers), jnp.asarray(contexts),
                             jnp.asarray(weights), jnp.asarray(negs), lr)
    got = tw2v._sgns_update(_t(syn0), _t(syn1neg), _t(centers, np.int64),
                            _t(contexts, np.int64), _t(weights),
                            _t(negs, np.int64), torch.tensor(lr))
    for g, w, name in zip(got, want, ("syn0", "syn1neg", "loss")):
        _close_to_max(g, w, STEP_TOL, name)


def test_sgns_update_shared_matches_jax():
    v, d, block, window, k, group = 19, 16, 10, 2, 5, 8
    syn0, syn1neg = _tables(v, d, 2)
    rng = np.random.default_rng(3)
    ctr = rng.integers(0, v, block).astype(np.int32)
    ctx = rng.integers(0, v, (block, 2 * window)).astype(np.int32)
    wmat = (rng.random((block, 2 * window)) < 0.7).astype(np.float32)
    negs_g = rng.integers(0, v, (block * 2 * window // group, k)) \
        .astype(np.int32)
    lr = np.float32(0.025)
    want = jw2v._sgns_update_shared(
        jnp.asarray(syn0), jnp.asarray(syn1neg), jnp.asarray(ctr),
        jnp.asarray(ctx), jnp.asarray(wmat), jnp.asarray(negs_g), lr)
    got = tw2v._sgns_update_shared(
        _t(syn0), _t(syn1neg), _t(ctr, np.int64), _t(ctx, np.int64),
        _t(wmat), _t(negs_g, np.int64), torch.tensor(lr))
    for g, w, name in zip(got, want, ("syn0", "syn1neg", "loss")):
        _close_to_max(g, w, STEP_TOL, name)


def test_shared_grads_reduce_to_per_pair_at_group_one():
    """_sgns_grads_shared with one pair per group equals _sgns_grads, in
    the port as in JAX."""
    v, d, b, k = 50, 8, 12, 3
    syn0, syn1neg = _tables(v, d, 4)
    rng = np.random.default_rng(5)
    centers = _t(rng.integers(0, v, b), np.int64)
    contexts = _t(rng.integers(0, v, b), np.int64)
    weights = torch.tensor([1.0] * 10 + [0.0] * 2)
    negs = _t(rng.integers(0, v, (b, k)), np.int64)
    ref = tw2v._sgns_grads(_t(syn0), _t(syn1neg), centers, contexts,
                           weights, negs)
    shared = tw2v._sgns_grads_shared(_t(syn0), _t(syn1neg), centers,
                                     contexts, weights, negs)
    for a, s, name in zip(ref, shared,
                          ("grad_v", "u_idx", "u_grad", "u_w", "loss")):
        np.testing.assert_allclose(_np(s), _np(a), atol=1e-6, err_msg=name)


def test_hs_update_matches_jax():
    v, d, b, depth = 21, 16, 40, 6
    syn0, syn1 = _tables(v, d, 6)
    rng = np.random.default_rng(7)
    centers = rng.integers(0, v, b).astype(np.int32)
    points = rng.integers(0, v - 1, (b, depth)).astype(np.int32)
    codes = rng.integers(0, 2, (b, depth)).astype(np.float32)
    mask = (rng.random((b, depth)) < 0.8).astype(np.float32)
    weights = (rng.random(b) < 0.85).astype(np.float32)
    lr = np.float32(0.05)
    want = jw2v._hs_update(jnp.asarray(syn0), jnp.asarray(syn1),
                           jnp.asarray(centers), jnp.asarray(points),
                           jnp.asarray(codes), jnp.asarray(mask),
                           jnp.asarray(weights), lr)
    got = tw2v._hs_update(_t(syn0), _t(syn1), _t(centers, np.int64),
                          _t(points, np.int64), _t(codes), _t(mask),
                          _t(weights), torch.tensor(lr))
    for g, w, name in zip(got, want, ("syn0", "syn1", "loss")):
        _close_to_max(g, w, STEP_TOL, name)


# --------------------------------------------------------- device epochs ----

def _epoch_inputs(seed=0, n=90, v=40, d=16):
    rng = np.random.default_rng(seed)
    flat = np.minimum(rng.zipf(1.4, n), v) - 1
    sid = np.repeat(np.arange(n // 9), 9)[:n]
    keep = np.minimum(1.0, 0.3 + rng.random(v)).astype(np.float32)
    syn0, syn1 = _tables(v, d, seed + 1)
    return flat.astype(np.int32), sid.astype(np.int32), keep, syn0, syn1


@pytest.mark.parametrize("neg_group", [0, 4])
def test_sgns_device_epoch_matches_jax(monkeypatch, neg_group):
    inject_jax_draws(monkeypatch)
    flat, sid, keep, syn0, syn1neg = _epoch_inputs()
    window, block, negative = 2, 7, 3
    n_steps = -(-flat.size // block)
    lrs = np.linspace(0.05, 0.01, n_steps).astype(np.float32)
    probs = np.random.default_rng(9).random(syn0.shape[0])
    key = jax.random.PRNGKey(42)
    want = jw2v._sgns_device_epoch(
        jnp.asarray(syn0), jnp.asarray(syn1neg), jnp.asarray(flat),
        jnp.asarray(sid), jnp.asarray(keep),
        jw2v.build_neg_table(probs, slots=1 << 12), jnp.asarray(lrs), key,
        window=window, negative=negative, block=block, n_steps=n_steps,
        neg_group=neg_group)
    got = tw2v._sgns_device_epoch(
        _t(syn0), _t(syn1neg), _t(flat, np.int64), _t(sid, np.int64),
        _t(keep), tw2v.build_neg_table(probs, slots=1 << 12, device=CPU),
        _t(lrs), key, window=window, negative=negative, block=block,
        n_steps=n_steps, neg_group=neg_group)
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]),
                               atol=EPOCH_TOL, rtol=0)
    np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]),
                               atol=EPOCH_TOL, rtol=0)
    assert float(got[3]) == float(want[3]) > 0
    assert float(np.abs(_np(got[0]) - syn0).max()) > 0  # params moved


def test_hs_device_epoch_matches_jax(monkeypatch):
    inject_jax_draws(monkeypatch)
    flat, sid, keep, syn0, syn1 = _epoch_inputs(seed=3)
    v, depth = syn0.shape[0], 7
    rng = np.random.default_rng(11)
    pts = rng.integers(0, v - 1, (v, depth)).astype(np.int32)
    cds = rng.integers(0, 2, (v, depth)).astype(np.float32)
    msk = (rng.random((v, depth)) < 0.7).astype(np.float32)
    window, block = 3, 5
    n_steps = -(-flat.size // block)
    lrs = np.linspace(0.05, 0.01, n_steps).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jw2v._hs_device_epoch(
        jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(flat),
        jnp.asarray(sid), jnp.asarray(keep), jnp.asarray(pts),
        jnp.asarray(cds), jnp.asarray(msk), jnp.asarray(lrs), key,
        window=window, block=block, n_steps=n_steps)
    got = tw2v._hs_device_epoch(
        _t(syn0), _t(syn1), _t(flat, np.int64), _t(sid, np.int64), _t(keep),
        _t(pts, np.int64), _t(cds), _t(msk), _t(lrs), key, window=window,
        block=block, n_steps=n_steps)
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]),
                               atol=EPOCH_TOL, rtol=0)
    np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]),
                               atol=EPOCH_TOL, rtol=0)
    assert float(got[3]) == float(want[3]) > 0


# ------------------------------------------------------------ whole fits ----

FIT_CASES = {
    "native-shared": dict(native=True, shared_negatives=25),
    "python-shared": dict(native=False, shared_negatives=25),
    "native-per-pair": dict(native=True, shared_negatives=0),
    "native-hs-and-sgns": dict(native=True, shared_negatives=25,
                               use_hierarchic_softmax=True),
}


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_two_epoch_fit_matches_jax(monkeypatch, case):
    inject_jax_draws(monkeypatch)
    opts = dict(FIT_CASES[case])
    native = opts.pop("native")
    kw = dict(layer_size=16, window=3, negative=4, iterations=2, lr=0.05,
              sample=1e-2, batch_size=96, seed=9, min_word_frequency=2,
              **opts)
    sents = _zipf_corpus()
    jvec = jw2v.Word2Vec(sentence_iterator=JSents(sents), **kw)
    tvec = tw2v.Word2Vec(sentence_iterator=CollectionSentenceIterator(sents),
                         device=CPU, **kw)
    if not native:
        jvec._native_path_possible = lambda: False
        tvec._native_path_possible = lambda: False
    tlib.reset_calls()
    jvec.fit()
    tvec.fit()
    assert tlib.CALLS["corpus_index"] == (1 if native else 0)
    assert [w.word for w in tvec.vocab.words()] == \
        [w.word for w in jvec.vocab.words()]
    np.testing.assert_array_equal(tvec._flat, jvec._flat)
    np.testing.assert_array_equal(tvec._sid, jvec._sid)
    assert tvec.total_words_trained == jvec.total_words_trained > 0
    jt, tt = jvec.lookup_table, tvec.lookup_table
    for name in ("syn0", "syn1", "syn1neg"):
        np.testing.assert_allclose(getattr(tt, name), np.asarray(
            getattr(jt, name)), atol=EPOCH_TOL, rtol=0, err_msg=name)
    assert set(tvec.last_fit_timings) == set(jvec.last_fit_timings)
    assert tvec.last_fit_timings["n_dispatches"] == \
        jvec.last_fit_timings["n_dispatches"]


def test_vocab_tables_match_jax():
    sents = _zipf_corpus(seed=4)
    kw = dict(layer_size=8, window=2, negative=2, sample=1e-2, seed=3,
              use_hierarchic_softmax=True)
    jvec = jw2v.Word2Vec(sentence_iterator=JSents(sents), **kw)
    tvec = tw2v.Word2Vec(sentence_iterator=CollectionSentenceIterator(sents),
                         device=CPU, **kw)
    jvec.build_vocab()
    tvec.build_vocab()
    np.testing.assert_array_equal(tvec._keep_probs(), jvec._keep_probs())
    for g, w in zip(tvec._huffman_tables(), jvec._huffman_tables()):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    np.testing.assert_array_equal(_np(tvec._neg_table()),
                                  np.asarray(jvec._neg_table()))
    np.testing.assert_array_equal(tvec.lookup_table.syn0,
                                  jvec.lookup_table.syn0)


# ----------------------------------------------------------- lookup table ----

def _small_vec(**kw):
    opts = dict(layer_size=8, window=2, negative=2, iterations=1, lr=0.1,
                sample=0, batch_size=64, seed=1)
    opts.update(kw)
    return tw2v.Word2Vec(
        sentence_iterator=CollectionSentenceIterator(_toy_corpus()),
        device=CPU, **opts)


def test_lookup_table_readable_after_failed_fit(monkeypatch):
    vec = _small_vec()
    vec.fit()
    _ = vec.word_vector("apple")  # sync once so the host has trained values
    host_before = np.array(vec.lookup_table.syn0)

    def boom(*a, **k):
        raise RuntimeError("injected epoch failure")

    monkeypatch.setattr(tw2v, "_sgns_device_epoch", boom)
    with pytest.raises(RuntimeError, match="injected"):
        vec.fit()
    assert vec.word_vector("apple") is not None  # must not raise
    np.testing.assert_array_equal(vec.lookup_table.syn0, host_before)


def test_stale_host_table_rejects_inplace_writes():
    vec = _small_vec()
    vec.build_vocab()
    retained = vec._lookup_table  # grabbed before training, bypasses sync
    vec.fit()
    with pytest.raises(ValueError):
        retained.syn0[0, 0] = 123.0
    synced = vec.lookup_table.syn0  # the post-sync arrays are read-only
    with pytest.raises(ValueError):
        synced[0, 0] = 1.0


def test_continued_fit_reuses_device_tables_and_external_edit_wins():
    vec = _small_vec()
    vec.fit()
    dev = vec._syn_dev[0]
    vec.fit()  # host table unchanged since upload: training continues
    assert vec._syn_dev[0] is dev
    trained = np.array(vec.lookup_table.syn0)
    table = vec.lookup_table
    table.syn0 = np.zeros_like(trained)  # wholesale re-assignment
    vec.fit()
    assert vec._syn_dev[0] is not dev
    # trained from zeros: a different table from continuing the first one
    assert not np.allclose(vec.lookup_table.syn0, trained)


# ------------------------------------------------------------ serializers ----

def test_serializers_round_trip_across_packages(tmp_path):
    vec = tw2v.Word2Vec(
        sentence_iterator=CollectionSentenceIterator(["a b c", "b c d"] * 5),
        layer_size=8, negative=2, iterations=1, sample=0, batch_size=64,
        device=CPU)
    vec.fit()
    table = vec.lookup_table
    txt, binp = str(tmp_path / "v.txt"), str(tmp_path / "v.bin")
    temb.write_word_vectors(table, txt)
    temb.write_word_vectors_binary(table, binp)
    for load in ("load_word_vectors", "load_word_vectors_binary"):
        path = txt if load == "load_word_vectors" else binp
        jvocab, jmat = getattr(jemb, load)(path)
        tvocab, tmat = getattr(temb, load)(path)
        assert [w.word for w in tvocab.words()] == \
            [w.word for w in jvocab.words()]
        np.testing.assert_array_equal(tmat, jmat)
        for w in vec.vocab.words():
            np.testing.assert_allclose(tmat[tvocab.index_of(w.word)],
                                       table.syn0[w.index], atol=1e-5)
    # and what the JAX package writes, the port reads
    jtable = types.SimpleNamespace(syn0=np.array(table.syn0),
                                   vocab=vec.vocab)
    jemb.write_word_vectors(jtable, txt)
    jemb.write_word_vectors_binary(jtable, binp)
    np.testing.assert_array_equal(temb.load_word_vectors_binary(binp)[1],
                                  table.syn0)
    np.testing.assert_array_equal(temb.load_word_vectors(txt)[1],
                                  jemb.load_word_vectors(txt)[1])


# ------------------------------------------------------- learning checks ----

def test_word2vec_sgns_learns_topics():
    vec = tw2v.Word2Vec(
        sentence_iterator=CollectionSentenceIterator(_toy_corpus()),
        layer_size=16, window=3, negative=5, iterations=10,
        lr=0.05, sample=0, batch_size=128, seed=1, device=CPU,
    )
    vec.fit()
    assert vec.has_word("apple")
    same = vec.similarity("apple", "banana")
    cross = vec.similarity("apple", "gpu")
    assert same > cross, (same, cross)
    nearest = vec.words_nearest("cpu", 5)
    tech_words = {"gpu", "chip", "silicon", "compute", "memory"}
    assert len(tech_words & set(nearest)) >= 3, nearest


def test_word2vec_classic_per_pair_negatives_learns():
    vec = tw2v.Word2Vec(
        sentence_iterator=CollectionSentenceIterator(_toy_corpus()),
        layer_size=16, window=3, negative=5, iterations=10,
        lr=0.1, sample=0, batch_size=128, seed=1, shared_negatives=0,
        device=CPU,
    )
    vec.fit()
    assert vec.similarity("apple", "banana") > vec.similarity("apple", "gpu")


def test_word2vec_hierarchical_softmax_learns():
    vec = tw2v.Word2Vec(
        sentence_iterator=CollectionSentenceIterator(_toy_corpus()),
        layer_size=16, window=3, negative=0, use_hierarchic_softmax=True,
        iterations=10, lr=0.1, sample=0, batch_size=128, seed=1, device=CPU,
    )
    vec.fit()
    assert vec.similarity("banana", "cherry") > vec.similarity("banana", "chip")


def test_device_epoch_counts_and_trains():
    v, d = 20, 8
    flat = np.arange(10) % v
    syn0_np = (np.random.default_rng(0).normal(size=(v, d)) * 0.01) \
        .astype(np.float32)
    block, window = 4, 2
    n_steps = -(-10 // block)
    s0, _, losses, wtot = tw2v._sgns_device_epoch(
        _t(syn0_np), torch.zeros(v, d), _t(flat, np.int64),
        torch.zeros(10, dtype=torch.int64), torch.ones(v),
        tw2v.build_neg_table(np.ones(v) / v, slots=1 << 10, device=CPU),
        torch.full((n_steps,), 0.05), 0, window=window, negative=2,
        block=block, n_steps=n_steps)
    full = sum(1 for i in range(10) for j in range(10)
               if i != j and abs(i - j) <= window)
    minimal = sum(1 for i in range(10) for j in range(10)
                  if i != j and abs(i - j) <= 1)
    assert minimal <= int(wtot) <= full
    assert torch.isfinite(losses).all()
    assert float(np.abs(_np(s0) - syn0_np).max()) > 0


# -------------------------------------------- the real-corpus NLP checks ----

# the reference's test fixtures, where tests/test_real_corpus_nlp.py
# finds them, and its skip when they are not mounted
from test_real_corpus_nlp import RES, needs_fixtures  # noqa: E402


@needs_fixtures
def test_load_reference_golden_vec_bin():
    vocab, mat = temb.load_word_vectors_binary(os.path.join(RES, "vec.bin"))
    assert mat.shape == (4, 100)
    assert [vocab.word_at(i) for i in range(4)] == \
        ["</s>", "Adam", "is", "awesome."]
    assert np.isfinite(mat).all()


@needs_fixtures
def test_binary_round_trip_matches_reference_format(tmp_path):
    vocab, mat = temb.load_word_vectors_binary(os.path.join(RES, "vec.bin"))
    path = str(tmp_path / "out.bin")
    temb.write_word_vectors_binary(
        types.SimpleNamespace(syn0=mat, vocab=vocab), path)
    vocab2, mat2 = temb.load_word_vectors_binary(path)
    assert [vocab2.word_at(i) for i in range(4)] == \
        [vocab.word_at(i) for i in range(4)]
    np.testing.assert_array_equal(mat2, mat)


@needs_fixtures
def test_word2vec_on_real_english_corpus():
    with open(os.path.join(RES, "raw_sentences.txt")) as f:
        sents = [line.strip() for line in f][:20000]
    vec = tw2v.Word2Vec(sentence_iterator=CollectionSentenceIterator(sents),
                        layer_size=64, window=5, negative=5, iterations=3,
                        min_word_frequency=5, sample=1e-3, batch_size=2048,
                        lr=0.05, seed=7, device=CPU)
    vec.build_vocab()
    assert vec.vocab.num_words() > 200
    vec.fit()
    near_two = set(vec.words_nearest("two", 10))
    assert near_two & {"three", "four", "five", "six", "ten", "Two",
                       "Three"}, near_two


def test_word2vec_real_corpus_gate_through_the_port():
    """accuracy_gates.gate_word2vec_real_corpus through the port: the
    corpus is the reference's raw_sentences.txt; where it is not mounted
    the gate reports itself skipped, and so does this test."""
    import accuracy_gates

    path = os.path.join(RES, "raw_sentences.txt")
    if not os.path.exists(path):
        assert accuracy_gates.gate_word2vec_real_corpus(iterations=1)[
            "skipped"] == "reference fixtures not mounted"
        pytest.skip("reference fixtures not mounted")
    from deeplearning4j_tpu_torch.text.sentence_iterator import \
        LineSentenceIterator

    vec = tw2v.Word2Vec(sentence_iterator=LineSentenceIterator(path),
                        layer_size=100, window=5, negative=5, iterations=5,
                        min_word_frequency=5, sample=1e-3, batch_size=2048,
                        lr=0.05, seed=7, device=CPU)
    vec.fit()
    near_two = set(vec.words_nearest("two", 10))
    near_day = set(vec.words_nearest("day", 10))
    assert near_two & {"three", "four", "five", "six", "ten", "Two", "Three"}
    assert near_day & {"night", "week", "year", "time", "season",
                       "morning", "days", "Today", "today", "every"}
