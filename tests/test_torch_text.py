"""The port's text pipeline (deeplearning4j_tpu_torch/text/) held against
the JAX package's: tokenizers, sentence and document iterators, the vocab
cache and its Huffman codes, the bag-of-words and TF-IDF vectorizers, the
inverted index and the moving windows, with the checks of
tests/test_word2vec.py:21-75, tests/test_text_extras.py and the
vectorizer class of tests/test_nlp_models.py through the port.

Every comparison is exact: the modules are numpy and the standard library
only. Huffman codes and points index syn1, so ties must break as JAX's do.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import numpy as np
import pytest

from deeplearning4j_tpu.text import document_iterator as j_docs
from deeplearning4j_tpu.text import inverted_index as j_index
from deeplearning4j_tpu.text import movingwindow as j_window
from deeplearning4j_tpu.text import sentence_iterator as j_sents
from deeplearning4j_tpu.text import tokenization as j_tok
from deeplearning4j_tpu.text import vectorizers as j_vec
from deeplearning4j_tpu.text import vocab as j_vocab
import deeplearning4j_tpu.text as j_text
import deeplearning4j_tpu_torch.text as t_text
from deeplearning4j_tpu_torch.text import document_iterator as t_docs
from deeplearning4j_tpu_torch.text import inverted_index as t_index
from deeplearning4j_tpu_torch.text import movingwindow as t_window
from deeplearning4j_tpu_torch.text import sentence_iterator as t_sents
from deeplearning4j_tpu_torch.text import tokenization as t_tok
from deeplearning4j_tpu_torch.text import vectorizers as t_vec
from deeplearning4j_tpu_torch.text import vocab as t_vocab

TEXTS = ["To be or not to be", "Hello, World!  (it's) a [test]; ok?",
         "  spaced\tout\nlines  ", "", "café au lait", "a b c d e"]


# ------------------------------------------------------------ tokenizers ----

def test_default_tokenizer():
    t = t_tok.DefaultTokenizerFactory().create("To be or not to be")
    assert t.get_tokens() == ["To", "be", "or", "not", "to", "be"]
    assert t.count_tokens() == 6
    assert t.has_more_tokens()
    assert t.next_token() == "To"


def test_tokenizer_preprocessor():
    t = t_tok.DefaultTokenizerFactory(t_tok.CommonPreprocessor()).create(
        "Hello, World!")
    assert t.get_tokens() == ["hello", "world"]


def test_ngram_tokenizer():
    t = t_tok.NGramTokenizerFactory(t_tok.DefaultTokenizerFactory(), 1,
                                    2).create("a b c")
    assert t.get_tokens() == ["a", "b", "c", "a b", "b c"]


@pytest.mark.parametrize("kind", ["default", "preprocessed", "ngram"])
def test_tokenizers_equal_jax(kind):
    def factory(mod):
        base = mod.DefaultTokenizerFactory()
        if kind == "preprocessed":
            return mod.DefaultTokenizerFactory(mod.CommonPreprocessor())
        if kind == "ngram":
            return mod.NGramTokenizerFactory(base, 1, 3)
        return base

    tf, jf = factory(t_tok), factory(j_tok)
    for text in TEXTS:
        t, j = tf.create(text), jf.create(text)
        assert t.get_tokens() == j.get_tokens()
        assert t.count_tokens() == j.count_tokens()
        while j.has_more_tokens():
            assert t.next_token() == j.next_token()
        assert not t.has_more_tokens()


# ------------------------------------------------------------- iterators ----

def _drain(it):
    out = []
    it.reset()
    while it.has_next():
        out.append(it.next_sentence())
    return out


def test_sentence_iterators_equal_jax(tmp_path):
    (tmp_path / "b.txt").write_text("second file\n\nlast line\n")
    (tmp_path / "a.txt").write_text("First line\n  \nSecond Line\n")
    pre = str.lower
    pairs = [
        (t_sents.CollectionSentenceIterator(TEXTS),
         j_sents.CollectionSentenceIterator(TEXTS)),
        (t_sents.CollectionSentenceIterator(TEXTS, pre),
         j_sents.CollectionSentenceIterator(TEXTS, pre)),
        (t_sents.LineSentenceIterator(str(tmp_path / "a.txt")),
         j_sents.LineSentenceIterator(str(tmp_path / "a.txt"))),
        (t_sents.FileSentenceIterator(str(tmp_path), pre),
         j_sents.FileSentenceIterator(str(tmp_path), pre)),
        (t_sents.FileSentenceIterator(str(tmp_path / "b.txt")),
         j_sents.FileSentenceIterator(str(tmp_path / "b.txt"))),
    ]
    for t, j in pairs:
        got = _drain(t)
        assert got == _drain(j) and got
        assert list(t) == got  # __iter__ resets


def test_document_iterators_equal_jax(tmp_path):
    sub = tmp_path / "sub"
    sub.mkdir()
    (tmp_path / "one.txt").write_text("doc one\nline two\n")
    (sub / "two.txt").write_text("\n  doc two  \n\nend\n")
    docs = ["first doc\nsecond sentence", "", "third\n\n fourth "]
    pairs = [(t_docs.CollectionDocumentIterator(docs),
              j_docs.CollectionDocumentIterator(docs)),
             (t_docs.FileDocumentIterator(str(tmp_path)),
              j_docs.FileDocumentIterator(str(tmp_path))),
             (t_docs.FileDocumentIterator(str(tmp_path / "one.txt")),
              j_docs.FileDocumentIterator(str(tmp_path / "one.txt")))]
    for t, j in pairs:
        assert list(t) == list(j)
        ts, js = t_docs.DocumentSentenceIterator(t), \
            j_docs.DocumentSentenceIterator(j)
        assert _drain(ts) == _drain(js)
    with pytest.raises(NotImplementedError):
        t_docs.DocumentIterator().has_next()


# ------------------------------------------------------- vocab + Huffman ----

def test_vocab_ordering_and_pruning():
    v = t_vocab.VocabCache()
    for w in ["a"] * 5 + ["b"] * 3 + ["c"]:
        v.add_token(w)
    v.finish(min_word_frequency=2)
    assert v.num_words() == 2
    assert v.word_at(0) == "a"  # most frequent first
    assert v.index_of("c") == -1


def test_huffman_codes_prefix_free():
    v = t_vocab.VocabCache()
    for w, n in [("a", 40), ("b", 30), ("c", 20), ("d", 10)]:
        v.add_token(w, by=n)
    v.finish()
    t_vocab.build_huffman(v)
    codes = {w.word: "".join(map(str, w.code)) for w in v.words()}
    for w1, c1 in codes.items():
        for w2, c2 in codes.items():
            if w1 != w2:
                assert not c2.startswith(c1), codes
    assert len(codes["a"]) <= len(codes["d"])
    for w in v.words():
        assert all(0 <= p < v.num_words() - 1 for p in w.points)
        assert len(w.points) == len(w.code)


def _both_vocabs(counts, min_freq):
    tv, jv = t_vocab.VocabCache(), j_vocab.VocabCache()
    for word, c in counts:
        tv.add_token(word, by=c)
        jv.add_token(word, by=c)
    tv.finish(min_freq)
    jv.finish(min_freq)
    return tv, jv


@pytest.mark.parametrize("seed,n_words,min_freq", [(0, 300, 1), (1, 500, 3),
                                                   (2, 2, 1), (3, 1, 1)])
def test_vocab_and_huffman_equal_jax(seed, n_words, min_freq):
    """Zipf counts with many ties (and equal-count merges inside the
    tree): order, pruning, counts, codes and points equal JAX's."""
    rng = np.random.default_rng(seed)
    counts = [(f"w{i}", int(c)) for i, c in
              enumerate(np.minimum(rng.zipf(1.5, n_words), 50))]
    tv, jv = _both_vocabs(counts, min_freq)
    t_vocab.build_huffman(tv)
    j_vocab.build_huffman(jv)
    assert tv.num_words() == jv.num_words()
    assert tv.total_word_count() == jv.total_word_count()
    np.testing.assert_array_equal(tv.counts(), jv.counts())
    for a, b in zip(tv.words(), jv.words()):
        assert (a.word, a.count, a.index, a.code, a.points) == \
            (b.word, b.count, b.index, b.code, b.points)
        assert tv.index_of(a.word) == jv.index_of(b.word)
    assert tv.index_of("absent") == jv.index_of("absent") == -1
    assert tv.is_empty() == jv.is_empty()


def test_package_exports_equal_jax():
    names = {"DefaultTokenizerFactory", "NGramTokenizerFactory",
             "CollectionSentenceIterator", "FileSentenceIterator",
             "LineSentenceIterator", "VocabCache", "VocabWord"}
    for name in names:
        assert getattr(t_text, name).__name__ == getattr(j_text, name).__name__


# ------------------------------------------------------------ vectorizers ----

DOCS = ["the cat sat on the mat", "the dog sat on the log",
        "cats and dogs are animals"]


class TestVectorizers:
    def test_bow_counts(self):
        bow = t_vec.BagOfWordsVectorizer()
        m = bow.fit_transform(DOCS)
        assert m.shape[0] == 3
        the = bow.vocab.index_of("the")
        assert m[0, the] == 2.0
        assert m[2, the] == 0.0

    def test_bow_vectorize_with_label(self):
        bow = t_vec.BagOfWordsVectorizer().fit(DOCS)
        features, onehot = bow.vectorize("the cat", label=1, num_labels=3)
        assert features[bow.vocab.index_of("cat")] == 1.0
        assert onehot.tolist() == [0.0, 1.0, 0.0]

    def test_tfidf_downweights_common_terms(self):
        tv = t_vec.TfidfVectorizer()
        m = tv.fit_transform(DOCS)
        the = tv.vocab.index_of("the")
        cat = tv.vocab.index_of("cat")
        assert m[0, cat] > 0
        assert tv.idf[cat] > tv.idf[the]

    def test_transform_unseen_word_ignored(self):
        tv = t_vec.TfidfVectorizer().fit(DOCS)
        m = tv.transform(["unseen words only"])
        assert m.shape == (1, tv.vocab.num_words())
        assert m.sum() == 0.0

    @pytest.mark.parametrize("cls", ["BagOfWordsVectorizer",
                                     "TfidfVectorizer"])
    def test_matrices_equal_jax(self, cls):
        rng = np.random.default_rng(5)
        words = [f"w{i}" for i in range(40)]
        docs = [" ".join(rng.choice(words, rng.integers(1, 30)))
                for _ in range(25)] + DOCS
        kw = dict(min_word_frequency=2)
        t, j = getattr(t_vec, cls)(**kw), getattr(j_vec, cls)(**kw)
        np.testing.assert_array_equal(t.fit_transform(docs),
                                      j.fit_transform(docs))
        np.testing.assert_array_equal(t.transform(DOCS), j.transform(DOCS))
        tf, tl = t.vectorize(docs[0], label=2, num_labels=4)
        jf, jl = j.vectorize(docs[0], label=2, num_labels=4)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tl, jl)
        if cls == "TfidfVectorizer":
            np.testing.assert_array_equal(t.idf, j.idf)


# --------------------------------------------------------- inverted index ----

class TestInvertedIndex:
    def _index(self, mod=t_index):
        idx = mod.InvertedIndex()
        idx.add_document("the cat sat".split())
        idx.add_document("the dog ran".split())
        idx.add_document("cat and dog".split())
        return idx

    def test_postings(self):
        idx = self._index()
        assert idx.documents("cat") == [0, 2]
        assert idx.documents("the") == [0, 1]
        assert idx.documents("zzz") == []
        assert idx.doc_frequency("dog") == 2
        assert idx.num_documents() == 3

    def test_duplicate_tokens_counted_once(self):
        idx = t_index.InvertedIndex()
        idx.add_document(["a", "a", "b"])
        assert idx.documents("a") == [0]

    def test_batch_iter_covers_all(self):
        idx = self._index()
        docs = [d for batch in idx.batch_iter(2, seed=1) for d in batch]
        assert len(docs) == 3
        assert sorted(map(tuple, docs)) == sorted(
            map(tuple, [idx.document(i) for i in range(3)]))

    def test_sample(self):
        assert len(self._index().sample(2, seed=0)) == 2

    def test_equals_jax(self):
        rng = np.random.default_rng(8)
        words = [f"w{i}" for i in range(30)]
        t, j = t_index.InvertedIndex(), j_index.InvertedIndex()
        for _ in range(40):
            doc = list(rng.choice(words, rng.integers(1, 12)))
            assert t.add_document(doc) == j.add_document(doc)
        assert t.words() == j.words()
        for w in words + ["absent"]:
            assert t.documents(w) == j.documents(w)
            assert t.doc_frequency(w) == j.doc_frequency(w)
        for seed in (None, 3):
            assert list(t.batch_iter(7, seed=seed)) == \
                list(j.batch_iter(7, seed=seed))
        assert t.sample(9, seed=4) == j.sample(9, seed=4)


# ---------------------------------------------------------- moving window ----

class _Lookup:
    layer_size = 2

    def vector(self, w):
        return {"a": np.array([1.0, 2.0]), "b": np.array([3.0, 4.0])}.get(w)


class TestWindows:
    def test_padding_and_focus(self):
        ws = t_window.windows("a b c".split(), window_size=3)
        assert len(ws) == 3
        assert ws[0].tokens == [t_window.PAD, "a", "b"]
        assert ws[0].focus_word == "a"
        assert ws[2].tokens == ["b", "c", t_window.PAD]

    def test_even_window_rejected(self):
        with pytest.raises(ValueError):
            t_window.windows(["a"], window_size=4)

    def test_converter_concatenates_vectors(self):
        ws = t_window.windows(["a", "b"], window_size=3)
        m = t_window.WindowConverter(_Lookup()).as_matrix(ws)
        assert m.shape == (2, 6)
        np.testing.assert_array_equal(m[0], [0, 0, 1, 2, 3, 4])

    @pytest.mark.parametrize("size", [1, 3, 5])
    def test_equal_jax(self, size):
        toks = "a b c a x b".split()
        tw = t_window.windows(toks, window_size=size)
        jw = j_window.windows(toks, window_size=size)
        assert [(w.tokens, w.focus_index, w.focus_word, repr(w))
                for w in tw] == [(w.tokens, w.focus_index, w.focus_word,
                                  repr(w)) for w in jw]
        np.testing.assert_array_equal(
            t_window.WindowConverter(_Lookup()).as_matrix(tw),
            j_window.WindowConverter(_Lookup()).as_matrix(jw))
