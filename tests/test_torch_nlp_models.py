"""The port's GloVe and ParagraphVectors (deeplearning4j_tpu_torch/models/
glove.py, paragraph_vectors.py) held against the JAX package's on the
CPU, and the learning checks of tests/test_nlp_models.py through the port.

GloVe's init and shuffling are numpy-seeded in both packages, so nothing
is injected. ParagraphVectors draws its negatives through Word2Vec's draw
point; JAX's draws are put in there with its key splits replayed
(tests/_torch_nlp_draws.py).

Tolerances, stated once for this module: co-occurrence counts exactly;
GloVe's vectors and biases, ParagraphVectors' doc vectors and output table
within 1e-6 absolute (their values are a few tenths at most); GloVe's
epoch losses within 1e-6 relative.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import numpy as np
import pytest

from deeplearning4j_tpu.models import glove as jglove
from deeplearning4j_tpu.models import paragraph_vectors as jpv
from deeplearning4j_tpu.text.sentence_iterator import \
    CollectionSentenceIterator as JSents
from deeplearning4j_tpu_torch.models import Glove, ParagraphVectors
from deeplearning4j_tpu_torch.models import glove as tglove
from deeplearning4j_tpu_torch.models import paragraph_vectors as tpv
from deeplearning4j_tpu_torch.text.sentence_iterator import \
    CollectionSentenceIterator

from _torch_nlp_draws import inject_jax_draws

TOL = 1e-6
CPU = "cpu"


def _topic_corpus():
    fruit = "apple banana cherry fruit sweet juice"
    tech = "cpu gpu chip silicon compute memory"
    rng = np.random.default_rng(0)
    sents = []
    for _ in range(150):
        sents.append(" ".join(rng.permutation(fruit.split()).tolist()))
        sents.append(" ".join(rng.permutation(tech.split()).tolist()))
    return sents


def _zipf_corpus(n_sents=50, words=10, vocab=200, seed=1):
    rng = np.random.default_rng(seed)
    ids = np.minimum(rng.zipf(1.3, size=(n_sents, words)), vocab) - 1
    return [" ".join(f"w{i}" for i in row) for row in ids]


class TestCoOccurrences:
    def test_window_weighting(self):
        co = tglove.CoOccurrences(window=2)
        co.add_sentence([0, 1, 2])
        assert co.counts[(0, 1)] == pytest.approx(1.0)
        assert co.counts[(1, 2)] == pytest.approx(1.0)
        assert co.counts[(0, 2)] == pytest.approx(0.5)

    def test_symmetric_key(self):
        co = tglove.CoOccurrences(window=3)
        co.add_sentence([5, 2])
        co.add_sentence([2, 5])
        assert co.counts[(2, 5)] == pytest.approx(2.0)

    @pytest.mark.parametrize("window", [1, 4, 15])
    def test_counts_and_arrays_equal_jax(self, window):
        rng = np.random.default_rng(window)
        sents = [rng.integers(0, 30, rng.integers(1, 20)).tolist()
                 for _ in range(40)]
        tco, jco = tglove.CoOccurrences(window), jglove.CoOccurrences(window)
        for s in sents:
            tco.add_sentence(s)
            jco.add_sentence(s)
        assert tco.counts == jco.counts
        for a, b in zip(tco.to_arrays(), jco.to_arrays()):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("batch_size", [64, 4096])
def test_glove_fit_matches_jax(batch_size):
    """At batch 64 the co-occurrence list spans many batches with a padded
    tail; at 4096 one batch holds it all (every row collides)."""
    sents = _zipf_corpus()
    kw = dict(layer_size=12, window=4, lr=0.1, iterations=4, x_max=10.0,
              seed=5, batch_size=batch_size, min_word_frequency=2)
    jg = jglove.Glove(sentence_iterator=JSents(sents), **kw)
    tg = Glove(sentence_iterator=CollectionSentenceIterator(sents),
               device=CPU, **kw)
    jg.fit()
    tg.fit()
    assert [w.word for w in tg.vocab.words()] == \
        [w.word for w in jg.vocab.words()]
    np.testing.assert_allclose(tg.syn0, np.asarray(jg.syn0), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(tg.bias, np.asarray(jg.bias), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(tg.losses, jg.losses, rtol=TOL)
    assert float(np.abs(tg.syn0).max()) > 0


def test_glove_step_matches_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    v, d, b = 17, 8, 40
    w = ((rng.random((v, d)) - 0.5) / d).astype(np.float32)
    bias = (rng.normal(size=v) * 0.1).astype(np.float32)
    hw = rng.random((v, d)).astype(np.float32)
    hb = rng.random(v).astype(np.float32)
    rows = rng.integers(0, v, b)
    cols = rng.integers(0, v, b)
    logx = rng.normal(size=b).astype(np.float32)
    fx = rng.random(b).astype(np.float32)
    wt = (rng.random(b) < 0.9).astype(np.float32)
    want = jglove._glove_step(
        *(jnp.asarray(a) for a in (w, bias, hw, hb, rows.astype(np.int32),
                                   cols.astype(np.int32), logx, fx, wt)),
        jnp.float32(0.05))
    got = tglove._glove_step(
        *(torch.from_numpy(a.copy()) for a in (w, bias, hw, hb, rows, cols,
                                               logx, fx, wt)),
        float(np.float32(0.05)))
    for g, j, name in zip(got, want, ("w", "b", "hw", "hb", "loss")):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=TOL,
                                   rtol=TOL, err_msg=name)


class TestGlove:
    def test_learns_topics(self):
        glove = Glove(
            sentence_iterator=CollectionSentenceIterator(_topic_corpus()),
            layer_size=16, window=5, lr=0.1, iterations=25,
            x_max=10.0, seed=2, device=CPU,
        )
        glove.fit()
        assert glove.losses[-1] < glove.losses[0]
        same = glove.similarity("apple", "banana")
        cross = glove.similarity("apple", "gpu")
        assert same > cross, (same, cross)
        nearest = glove.words_nearest("cpu", 5)
        tech = {"gpu", "chip", "silicon", "compute", "memory"}
        assert len(tech & set(nearest)) >= 3, nearest

    def test_unknown_word(self):
        glove = Glove(
            sentence_iterator=CollectionSentenceIterator(["a b c"] * 3),
            layer_size=4, iterations=1, device=CPU,
        )
        glove.fit()
        assert glove.word_vector("zzz") is None
        assert np.isnan(glove.similarity("a", "zzz"))

    @pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
    def test_raises_without_cuda(self):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Glove(sentence_iterator=CollectionSentenceIterator(["a b"]))


def _docs():
    fruit = [(f"fruit_{i}", "apple banana cherry sweet juice fruit "
              "banana apple juice") for i in range(10)]
    tech = [(f"tech_{i}", "cpu gpu chip silicon compute memory "
             "gpu cpu compute") for i in range(10)]
    return fruit + tech


@pytest.mark.parametrize("train_words", [True, False])
def test_paragraph_vectors_match_jax(monkeypatch, train_words):
    inject_jax_draws(monkeypatch, tpv)
    kw = dict(layer_size=12, window=3, negative=4, iterations=3, lr=0.1,
              sample=0, batch_size=32, seed=3, min_word_frequency=1,
              train_words=train_words)
    jp = jpv.ParagraphVectors(documents=_docs(), **kw)
    tp = ParagraphVectors(documents=_docs(), device=CPU, **kw)
    jp.fit()
    tp.fit()
    np.testing.assert_allclose(tp.doc_vectors, np.asarray(jp.doc_vectors),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(tp.lookup_table.syn1neg,
                               np.asarray(jp.lookup_table.syn1neg),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(tp.lookup_table.syn0,
                               np.asarray(jp.lookup_table.syn0),
                               atol=TOL, rtol=0)


class TestParagraphVectors:
    def test_doc_vectors_separate_topics(self):
        pv = ParagraphVectors(
            documents=_docs(), layer_size=16, window=3, negative=5,
            iterations=30, lr=0.25, sample=0, batch_size=128, seed=3,
            min_word_frequency=1, device=CPU,
        )
        pv.fit()
        assert pv.doc_vectors.shape == (20, 16)
        same = pv.similarity_docs("fruit_0", "fruit_1")
        cross = pv.similarity_docs("fruit_0", "tech_0")
        assert same > cross, (same, cross)
        near = pv.nearest_docs("tech_0", 5)
        assert sum(1 for lab in near if lab.startswith("tech_")) >= 4, near

    def test_doc_vector_lookup(self):
        pv = ParagraphVectors(
            documents=[("d1", "a b c"), ("d2", "b c d")],
            layer_size=8, iterations=1, min_word_frequency=1, device=CPU,
        )
        pv.fit()
        assert pv.doc_vector("d1") is not None
        assert pv.doc_vector("nope") is None

    def test_requires_negative_sampling(self):
        with pytest.raises(ValueError):
            ParagraphVectors(documents=[("d", "a b")], negative=0,
                             use_hierarchic_softmax=True, device=CPU)


class TestBinarySerializer:
    def test_binary_round_trip(self, tmp_path):
        from deeplearning4j_tpu_torch.models.embeddings import (
            InMemoryLookupTable,
            load_word_vectors_binary,
            write_word_vectors_binary,
        )
        from deeplearning4j_tpu_torch.text.vocab import VocabCache

        vocab = VocabCache()
        for w in ["alpha", "beta", "gamma"]:
            for _ in range(3):
                vocab.add_token(w)
        vocab.finish(1)
        table = InMemoryLookupTable(vocab, layer_size=7, negative=1)
        path = str(tmp_path / "vec.bin")
        write_word_vectors_binary(table, path)
        vocab2, mat = load_word_vectors_binary(path)
        assert vocab2.num_words() == 3
        for w in ["alpha", "beta", "gamma"]:
            np.testing.assert_array_equal(
                mat[vocab2.index_of(w)], table.syn0[vocab.index_of(w)]
            )

    def test_lookup_table_init_equals_jax(self):
        from deeplearning4j_tpu.models.embeddings import \
            InMemoryLookupTable as JTable
        from deeplearning4j_tpu.text.vocab import VocabCache as JVocab
        from deeplearning4j_tpu_torch.models.embeddings import \
            InMemoryLookupTable
        from deeplearning4j_tpu_torch.text.vocab import VocabCache

        tv, jv = VocabCache(), JVocab()
        for i, w in enumerate("a b c d e f g".split()):
            tv.add_token(w, by=i + 1)
            jv.add_token(w, by=i + 1)
        tv.finish()
        jv.finish()
        for hs, neg in ((True, 0), (False, 5), (True, 5)):
            t = InMemoryLookupTable(tv, 9, seed=4, use_hs=hs, negative=neg)
            j = JTable(jv, 9, seed=4, use_hs=hs, negative=neg)
            for name in ("syn0", "syn1", "syn1neg"):
                np.testing.assert_array_equal(getattr(t, name),
                                              getattr(j, name))
            np.testing.assert_array_equal(t.unigram_probs(),
                                          j.unigram_probs())
