"""The port's trees and corpora pipeline (deeplearning4j_tpu_torch/nn/tree.py,
text/corpora/) held against the JAX package's, on the CPU.

Every test of tests/test_corpora.py and tests/test_rntn.py's TestTree runs
here through the port. On top of that the same sentences and
s-expressions go through both packages, and what comes out must be EQUAL:
trees (as s-expressions), ``linearize`` arrays, POS tags and SWN scores.
The modules are copies, so there is no tolerance.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import numpy as np
import pytest

from deeplearning4j_tpu.nn import tree as jtree
from deeplearning4j_tpu.text import corpora as jcorpora
from deeplearning4j_tpu.text.corpora import pos as jpos
from deeplearning4j_tpu_torch.nn.tree import Tree, linearize
from deeplearning4j_tpu_torch.text.corpora import (
    SWN3,
    ConstituencyTree,
    HeadWordFinder,
    PennTreeReader,
    PosTagger,
    TreeIterator,
    TreeParser,
    TreeVectorizer,
    binarize,
    collapse_unaries,
    to_rntn_tree,
)
from deeplearning4j_tpu_torch.text.corpora import pos as tpos

SENTENCES = (
    "the cat sat on the mat . an excellent wonderful movie . "
    "a terrible awful mess . she quickly painted 3 beautiful houses . "
    "then Alice spoke to perfection . dogs never bark loudly at night . "
    "this film is not good but never boring . "
    "we walked to the old brown house with our friends .")

SEXPRS = [
    "(3 (2 good) (3 (2 great) (2 movie)))",
    "(1 (0 a) (0 b) (0 c))",
    "(1 (0 (0 very) (0 bad)) (0 movie) (2 (2 and) (1 slow)))",
    "(4 (4 wow))",
    "(2 (1 (0 x) (1 (0 y) (0 z))) (3 w))",
]


def _sexpr(t) -> str:
    """An RNTN tree (nn.tree.Tree of either package) as an s-expression
    that keeps every label, including None."""
    if t.is_leaf():
        return f"({t.label} {t.word})"
    return f"({t.label} " + " ".join(_sexpr(c) for c in t.children) + ")"


# ------------------------------------- tests/test_rntn.py TestTree ----

class TestTree:
    def test_parse_and_structure(self):
        t = Tree.parse("(3 (2 good) (3 (2 great) (2 movie)))")
        assert t.label == 3
        assert t.yield_words() == ["good", "great", "movie"]
        assert t.num_nodes() == 5
        assert t.depth() == 2
        assert [n.label for n in t.preorder()] == [3, 2, 3, 2, 2]

    def test_parse_rejects_trailing(self):
        with pytest.raises(AssertionError):
            Tree.parse("(1 a) (2 b)")

    def test_binarize_nary(self):
        t = Tree.parse("(1 (0 a) (0 b) (0 c))")
        b = t.binarize()
        assert all(len(n.children) in (0, 2) for n in b.preorder())
        assert b.yield_words() == ["a", "b", "c"]

    def test_linearize(self):
        t = Tree.parse("(3 (1 bad) (2 movie))").binarize()
        vocab = {"bad": 1, "movie": 2}
        leaf_ids, merges, labels = linearize(t, vocab)
        assert leaf_ids.tolist() == [1, 2]
        assert merges.tolist() == [[0, 1, 2]]
        assert labels.tolist() == [1, 2, 3]

    def test_linearize_unknown_word(self):
        t = Tree.parse("(1 (0 known) (0 zzz))").binarize()
        leaf_ids, _, _ = linearize(t, {"known": 1}, unk_index=0)
        assert leaf_ids.tolist() == [1, 0]


# ------------------------------------------ tests/test_corpora.py ----

class TestPennTreeReader:
    def test_round_trip(self):
        s = "(S (NP (DT the) (NN cat)) (VP (VBD sat) (PP (IN on) (NP (DT the) (NN mat)))))"
        t = PennTreeReader.parse(s)
        assert t.to_sexpr() == s
        assert t.yield_words() == ["the", "cat", "sat", "on", "the", "mat"]

    def test_multiple_trees_and_root_unwrap(self):
        text = "(ROOT (S (NP (NN dogs)) (VP (VBP bark))))\n(S (NP (NN cats)) (VP (VBP meow)))"
        trees = list(PennTreeReader(text))
        assert len(trees) == 2
        assert trees[0].tag == "S"  # ROOT unwrapped
        assert trees[1].yield_words() == ["cats", "meow"]

    def test_malformed_raises(self):
        with pytest.raises((AssertionError, IndexError, ValueError)):
            list(PennTreeReader("(S (NP"))


class TestTransformers:
    def test_collapse_unaries(self):
        t = PennTreeReader.parse("(S (NP (NX (DT the) (NN cat))) (VP (VBD sat)))")
        c = collapse_unaries(t)
        assert c.children[0].tag == "NP"
        assert [k.tag for k in c.children[0].children] == ["DT", "NN"]
        assert c.yield_words() == t.yield_words()

    def test_binarize_left_factored(self):
        t = PennTreeReader.parse("(NP (DT the) (JJ big) (JJ red) (NN dog))")
        b = binarize(t)

        def check(n):
            assert len(n.children) in (0, 2)
            for c in n.children:
                check(c)

        check(b)
        assert b.yield_words() == ["the", "big", "red", "dog"]
        assert b.tag == "NP"
        assert any(n for n in b.children if n.tag.startswith("@NP"))

    def test_binarize_leaves_binary_tree_alone(self):
        t = PennTreeReader.parse("(S (NP (NN x)) (VP (VBP y)))")
        b = binarize(t)
        assert b.to_sexpr() == t.to_sexpr()


class TestHeadWordFinder:
    def test_np_head_is_noun(self):
        t = PennTreeReader.parse("(NP (DT the) (JJ big) (NN dog))")
        assert HeadWordFinder().find_head(t).word == "dog"

    def test_s_head_through_vp(self):
        t = PennTreeReader.parse(
            "(S (NP (DT the) (NN cat)) (VP (VBD sat) (PP (IN on) (NP (NN mat)))))")
        assert HeadWordFinder().find_head(t).word == "sat"


class TestPosTagger:
    def test_basic_sentence(self):
        tags = PosTagger().tag_sentence("the cat sat on the mat .")
        assert tags == ["DT", "NN", "VBD", "IN", "DT", "NN", "."]

    def test_suffix_and_shape_rules(self):
        tags = PosTagger().tag(["she", "quickly", "painted", "3",
                                "beautiful", "houses"])
        assert tags == ["PRP", "RB", "VBD", "CD", "JJ", "NNS"]

    def test_capitalized_mid_sentence_is_nnp(self):
        assert PosTagger().tag(["then", "Alice", "spoke"])[1] == "NNP"


class TestSWN3:
    def test_polarity_signs(self):
        swn = SWN3()
        assert swn.score("an excellent wonderful movie") > 0.5
        assert swn.score("a terrible awful mess") < -0.5
        assert swn.score("the chair is wooden") == 0.0

    def test_negation_flips(self):
        swn = SWN3()
        assert swn.score("not good") < 0
        assert swn.score("never boring") > 0

    def test_buckets_partition(self):
        swn = SWN3()
        for score, name in ((0.9, "strong_positive"), (0.4, "positive"),
                            (0.1, "weak_positive"), (0.0, "neutral"),
                            (-0.1, "weak_negative"), (-0.4, "negative"),
                            (-0.9, "strong_negative")):
            assert swn.class_for_score(score) == name
        assert swn.classify("an excellent superb masterpiece") == \
            "strong_positive"

    def test_sentiment_class_5way(self):
        swn = SWN3()
        assert swn.sentiment_class(-0.9) == 0
        assert swn.sentiment_class(0.0) == 2
        assert swn.sentiment_class(0.9) == 4


def _all_nodes(t):
    out = [t]
    for c in t.children:
        out.extend(_all_nodes(c))
    return out


class TestTreeParser:
    def test_parse_structure(self):
        t = TreeParser().get_trees("the cat sat on the mat .")[0]
        assert t.tag == "S"
        assert t.yield_words() == ["the", "cat", "sat", "on", "the", "mat",
                                   "."]
        tags = {n.tag for n in _all_nodes(t)}
        assert "NP" in tags and "VP" in tags

    def test_sentence_splitting(self):
        trees = TreeParser().get_trees("dogs bark . cats meow .")
        assert len(trees) == 2
        assert trees[1].yield_words() == ["cats", "meow", "."]


class TestTreeVectorizer:
    def test_labeled_binary_trees(self):
        trees = TreeVectorizer().get_trees_with_labels(
            "this movie is an excellent masterpiece .")
        assert len(trees) == 1
        t = trees[0]
        for n in t.preorder():
            assert len(n.children) in (0, 2)
            assert 0 <= n.label <= 4
        assert t.label >= 3

    def test_tree_iterator_batches(self):
        from deeplearning4j_tpu_torch.text.sentence_iterator import (
            CollectionSentenceIterator,
        )

        it = TreeIterator(
            CollectionSentenceIterator(["good movie .", "bad movie .",
                                        "great fun ."]),
            TreeVectorizer(), batch_size=2)
        batches = list(it)
        assert sum(len(b) for b in batches) == 3
        assert all(isinstance(t, Tree) for b in batches for t in b)


class TestAdviceRegressions:
    def test_penn_reader_empty_label_wrapper(self):
        t = PennTreeReader.parse(
            "( (S (NP (DT the) (NN cat)) (VP (VBD sat))) )")
        assert t.tag == "S"
        assert t.yield_words() == ["the", "cat", "sat"]

    def test_binarized_tree_sexpr_reparses(self):
        b = binarize(PennTreeReader.parse(
            "(NP (DT the) (JJ big) (JJ red) (NN cat))"))
        rt = PennTreeReader.parse(b.to_sexpr())
        assert rt.yield_words() == ["the", "big", "red", "cat"]

    def test_to_infinitive_tagged_verb(self):
        assert PosTagger().tag(["to", "walk"]) == ["TO", "VB"]
        assert PosTagger().tag(["to", "run"]) == ["TO", "VB"]
        assert PosTagger().tag(["to", "perfection"]) == ["TO", "NN"]

    def test_head_finder_through_binarized_nodes(self):
        t = binarize(PennTreeReader.parse(
            "(VP (RB quickly) (VB run) (RB away))"))
        assert HeadWordFinder().find_head(t).word == "run"


# ------------------------------------------- side by side with JAX ----

@pytest.mark.parametrize("s", SEXPRS)
def test_trees_and_linearize_equal_jax(s):
    t, j = Tree.parse(s), jtree.Tree.parse(s)
    assert _sexpr(t) == _sexpr(j)
    assert _sexpr(t.binarize()) == _sexpr(j.binarize())
    assert (t.depth(), t.num_nodes(), t.yield_words()) == \
        (j.depth(), j.num_nodes(), j.yield_words())
    vocab = {w: i + 1 for i, w in enumerate(sorted(set(t.yield_words())))}
    vocab.pop(t.yield_words()[-1])  # one unknown word
    for a, b in zip(linearize(t.binarize(), vocab, unk_index=0),
                    jtree.linearize(j.binarize(), vocab, unk_index=0)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_pipeline_equals_jax_on_the_same_text():
    """Tagging, tokenizing, SWN scores, parse trees (collapsed, binarized,
    labelled) and their linearized arrays, from the same sentences."""
    jparser, tparser = jcorpora.TreeParser(), TreeParser()
    jt, tt = jparser.get_trees(SENTENCES), tparser.get_trees(SENTENCES)
    assert [t.to_sexpr() for t in tt] == [t.to_sexpr() for t in jt]
    assert len(tt) == 8
    for a, b in zip(tt, jt):
        assert binarize(collapse_unaries(a)).to_sexpr() == \
            jcorpora.binarize(jcorpora.collapse_unaries(b)).to_sexpr()
        assert binarize(a, factor="right").to_sexpr() == \
            jcorpora.binarize(b, factor="right").to_sexpr()
        head, jhead = HeadWordFinder().find_head(a), \
            jcorpora.HeadWordFinder().find_head(b)
        assert (head.tag, head.word) == (jhead.tag, jhead.word)
    for sent in SENTENCES.split(" . "):
        assert tpos.word_tokenize(sent) == jpos.word_tokenize(sent)
        assert PosTagger().tag_sentence(sent) == \
            jcorpora.PosTagger().tag_sentence(sent)
        assert SWN3().score(sent) == jcorpora.SWN3().score(sent)
        assert SWN3().classify(sent) == jcorpora.SWN3().classify(sent)
    tv = TreeVectorizer().get_trees_with_labels(SENTENCES)
    jv = jcorpora.TreeVectorizer().get_trees_with_labels(SENTENCES)
    assert [_sexpr(t) for t in tv] == [_sexpr(t) for t in jv]
    assert [_sexpr(to_rntn_tree(t)) for t in tt] == \
        [_sexpr(jcorpora.to_rntn_tree(t)) for t in jt]
    vocab = {}
    for t in tv:
        for w in t.yield_words():
            vocab.setdefault(w, len(vocab) + 1)
    for a, b in zip(tv, jv):
        for x, y in zip(linearize(a.binarize(), vocab),
                        jtree.linearize(b.binarize(), vocab)):
            np.testing.assert_array_equal(x, y)


def test_tree_iterator_equals_jax():
    from deeplearning4j_tpu.text.sentence_iterator import (
        CollectionSentenceIterator as JSentences,
    )
    from deeplearning4j_tpu_torch.text.sentence_iterator import (
        CollectionSentenceIterator,
    )

    sents = [s + " ." for s in SENTENCES.split(" . ")]
    got = list(TreeIterator(CollectionSentenceIterator(sents),
                            TreeVectorizer(), batch_size=3))
    want = list(jcorpora.TreeIterator(JSentences(sents),
                                      jcorpora.TreeVectorizer(),
                                      batch_size=3))
    assert [[_sexpr(t) for t in b] for b in got] == \
        [[_sexpr(t) for t in b] for b in want]


def test_constituency_tree_is_the_ports_own():
    t = PennTreeReader.parse("(S (NP (NN x)) (VP (VBP y)))")
    assert isinstance(t, ConstituencyTree)
    assert not isinstance(t, jcorpora.ConstituencyTree)
