"""Counterpart of ``deeplearning4j_tpu/text/corpora/treeparser.py``, copied.

Constituency trees: reading, transforming, shallow parsing, vectorizing.

Parity with ref: text/corpora/treeparser/ —
- TreeFactory / TreeIterator → PennTreeReader / TreeIterator
- CollapseUnaries.java → collapse_unaries
- BinarizeTreeTransformer.java → binarize (left-factored, joined labels,
  horizontal markovization cap)
- HeadWordFinder.java → HeadWordFinder (category→head-tag priority table)
- TreeParser.java → TreeParser. The reference parses with a downloaded
  OpenNLP chunking parser behind UIMA; this environment ships no model
  files and has no egress, so TreeParser here is a deterministic shallow
  parser: rule-tagged PoS → NP/VP/PP chunks → clause tree. Structure is
  real constituency (not a degenerate chain), labels use the same Penn
  categories, and every downstream consumer (binarize/collapse/RNTN) is
  exercised identically.
- TreeVectorizer.java → TreeVectorizer (parse → binarize → collapse →
  sentiment-labeled RNTN trees; labels from SWN3 instead of caller-supplied
  label strings, since no treebank is available offline).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

from deeplearning4j_tpu_torch.nn.tree import Tree
from deeplearning4j_tpu_torch.text.corpora.pos import PosTagger, word_tokenize
from deeplearning4j_tpu_torch.text.corpora.sentiwordnet import SWN3


@dataclass
class ConstituencyTree:
    """Parse-tree node with a string category tag (the reference reuses its
    recursive-AE Tree with string labels; this package keeps syntax trees
    (str tags) separate from RNTN trees (int labels) — see to_rntn_tree)."""

    tag: str
    word: Optional[str] = None
    children: List["ConstituencyTree"] = field(default_factory=list)

    def is_leaf(self) -> bool:
        return not self.children

    def leaves(self) -> List["ConstituencyTree"]:
        if self.is_leaf():
            return [self]
        out: List[ConstituencyTree] = []
        for c in self.children:
            out.extend(c.leaves())
        return out

    def yield_words(self) -> List[str]:
        return [l.word for l in self.leaves() if l.word is not None]

    def to_sexpr(self) -> str:
        if self.is_leaf():
            return f"({self.tag} {self.word})"
        return "(" + self.tag + " " + " ".join(c.to_sexpr() for c in self.children) + ")"


class PennTreeReader:
    """Penn-treebank s-expression reader, e.g.
    ``(S (NP (DT the) (NN cat)) (VP (VBD sat)))``.
    Iterates every complete tree in the input string/file."""

    def __init__(self, text: str):
        self.text = text

    @staticmethod
    def parse(s: str) -> ConstituencyTree:
        trees = list(PennTreeReader(s))
        if len(trees) != 1:
            raise ValueError(f"expected exactly one tree, found {len(trees)}")
        return trees[0]

    @classmethod
    def from_file(cls, path: str) -> "PennTreeReader":
        with open(path) as f:
            return cls(f.read())

    def __iter__(self) -> Iterator[ConstituencyTree]:
        toks = self.text.replace("(", " ( ").replace(")", " ) ").split()
        i = 0

        def read(pos: int):
            assert toks[pos] == "(", f"expected '(' at token {pos}"
            pos += 1
            if pos < len(toks) and toks[pos] == "(":
                # PTB empty-label wrapper "( (S ...) )": synthesize a ROOT
                # node so the ROOT/TOP unwrap below strips it uniformly
                node = ConstituencyTree(tag="ROOT")
                while pos < len(toks) and toks[pos] == "(":
                    child, pos = read(pos)
                    node.children.append(child)
                assert toks[pos] == ")", f"expected ')' at token {pos}"
                return node, pos + 1
            tag = toks[pos]
            pos += 1
            node = ConstituencyTree(tag=tag)
            if pos < len(toks) and toks[pos] == "(":
                while pos < len(toks) and toks[pos] == "(":
                    child, pos = read(pos)
                    node.children.append(child)
            elif toks[pos] != ")":
                node.word = toks[pos]
                pos += 1
            assert toks[pos] == ")", f"expected ')' at token {pos}"
            return node, pos + 1

        while i < len(toks):
            if toks[i] != "(":
                raise ValueError(f"unexpected token {toks[i]!r}")
            tree, i = read(i)
            # unwrap single-child wrappers: explicit (ROOT ...)/(TOP ...) and
            # the synthesized ROOT from PTB's unlabeled "( (S ..) )" form
            if tree.tag in ("ROOT", "TOP") and len(tree.children) == 1:
                tree = tree.children[0]
            yield tree


def collapse_unaries(t: ConstituencyTree) -> ConstituencyTree:
    """Remove unary chains, keeping the top label (ref: CollapseUnaries.java:
    X→Y→children becomes X→children; pre-terminals keep their tag)."""
    node = t
    while len(node.children) == 1 and not node.children[0].is_leaf():
        node = node.children[0]
    if node.is_leaf():
        return ConstituencyTree(tag=t.tag, word=node.word)
    return ConstituencyTree(
        tag=t.tag, children=[collapse_unaries(c) for c in node.children]
    )


def binarize(t: ConstituencyTree, factor: str = "left",
             horizontal_markov: int = 999) -> ConstituencyTree:
    """Left-factored binarization (ref: BinarizeTreeTransformer.java —
    Stanford-style): n-ary nodes become nested binary nodes whose
    fabricated labels join the absorbed children's labels, capped at
    ``horizontal_markov`` context tags."""
    if t.is_leaf():
        return ConstituencyTree(tag=t.tag, word=t.word)
    kids = [binarize(c, factor, horizontal_markov) for c in t.children]
    if len(kids) <= 2:
        return ConstituencyTree(tag=t.tag, children=kids)
    if factor == "left":
        node = kids[0]
        for i in range(1, len(kids) - 1):
            ctx = [k.tag for k in kids[max(0, i - horizontal_markov + 1): i + 1]]
            node = ConstituencyTree(tag=f"@{t.tag}|{'-'.join(ctx)}",
                                    children=[node, kids[i]])
        return ConstituencyTree(tag=t.tag, children=[node, kids[-1]])
    node = kids[-1]
    for i in range(len(kids) - 2, 0, -1):
        ctx = [k.tag for k in kids[i: min(len(kids), i + horizontal_markov)]]
        node = ConstituencyTree(tag=f"@{t.tag}|{'-'.join(ctx)}",
                                children=[kids[i], node])
    return ConstituencyTree(tag=t.tag, children=[kids[0], node])


def _base_tag(tag: str) -> str:
    """Strip binarization ('@X|ctx') and PTB function ('NP-SBJ') decorations."""
    return tag.lstrip("@").split("|")[0].split("-")[0]


class HeadWordFinder:
    """Category → head-child priority rules (ref: HeadWordFinder.java, a
    condensed Collins table: for each parent category, which child
    categories can be its head, in priority order)."""

    _RULES = {
        "ADJP": ["JJ", "JJR", "JJS", "VBN", "RB", "ADJP"],
        "ADVP": ["RB", "RBR", "RBS", "ADVP"],
        "NP": ["NNS", "NN", "PRP", "NNPS", "NNP", "POS", "NP", "CD", "JJ"],
        "NX": ["NNS", "NN", "PRP", "NNPS", "NNP", "NP", "CD", "JJ"],
        "PP": ["IN", "TO", "RP", "PP"],
        "PRT": ["RP"],
        "S": ["VP", "S", "SBAR", "ADJP", "NP"],
        "SBAR": ["IN", "WHNP", "S", "SQ"],
        "SINV": ["VP", "VBZ", "VBD", "VBP", "VB", "S"],
        "SQ": ["MD", "VBZ", "VBD", "VBP", "VB", "VP", "SQ"],
        "VP": ["VB", "VBZ", "VBP", "VBG", "VBN", "VBD", "TO", "MD", "VP", "NN"],
        "WHNP": ["WP", "WDT", "WP$", "WHNP"],
        "WHPP": ["IN", "TO"],
    }

    def find_head(self, t: ConstituencyTree) -> Optional[ConstituencyTree]:
        """Head LEAF of the subtree (ref: HeadWordFinder.findHead)."""
        node = t
        while not node.is_leaf():
            node = self.find_head_child(node)
        return node

    def find_head_child(self, t: ConstituencyTree) -> ConstituencyTree:
        if t.is_leaf():
            return t
        prios = self._RULES.get(_base_tag(t.tag))
        if prios:
            for want in prios:
                for c in t.children:
                    if _base_tag(c.tag) == want:
                        return c
        # default: rightmost child for VP-ish, leftmost otherwise (Collins
        # default direction condensed)
        return t.children[-1] if t.tag in ("VP", "S", "SINV", "SQ") else t.children[0]


# ------------------------------------------------------------- parsing ----

_NP_TAGS = {"DT", "PRP$", "JJ", "JJR", "JJS", "NN", "NNS", "NNP", "NNPS",
            "CD", "PRP", "EX", "WP", "WDT"}
_VP_TAGS = {"VB", "VBZ", "VBP", "VBD", "VBG", "VBN", "MD", "TO", "RB"}
_PUNCT_TAGS = {".", ",", ":", "''", "-LRB-", "-RRB-"}


class TreeParser:
    """Sentence(s) → constituency trees (ref: TreeParser.java API —
    get_trees / get_trees_with_labels). Shallow chunking parser; see module
    docstring for the deviation rationale."""

    def __init__(self, tagger: Optional[PosTagger] = None):
        self.tagger = tagger or PosTagger()

    @staticmethod
    def _split_sentences(text: str) -> List[str]:
        out, cur = [], []
        for tok in word_tokenize(text):
            cur.append(tok)
            if tok in (".", "!", "?"):
                out.append(cur)
                cur = []
        if cur:
            out.append(cur)
        return out

    def parse_tokens(self, tokens: Sequence[str]) -> ConstituencyTree:
        tags = self.tagger.tag(tokens)
        leaves = [ConstituencyTree(tag=t, word=w) for w, t in zip(tokens, tags)]
        # chunk into NP / VP / PP / X runs
        chunks: List[ConstituencyTree] = []
        i = 0
        while i < len(leaves):
            tag = tags[i]
            if tag in _PUNCT_TAGS:
                chunks.append(leaves[i])
                i += 1
            elif tag == "IN":
                # PP = IN + following NP run
                j = i + 1
                np = []
                while j < len(leaves) and tags[j] in _NP_TAGS:
                    np.append(leaves[j])
                    j += 1
                if np:
                    np_node = np[0] if len(np) == 1 else ConstituencyTree("NP", children=np)
                    chunks.append(ConstituencyTree("PP", children=[leaves[i], np_node]))
                else:
                    chunks.append(leaves[i])
                i = j if np else i + 1
            elif tag in _NP_TAGS:
                j = i
                run = []
                while j < len(leaves) and tags[j] in _NP_TAGS:
                    run.append(leaves[j])
                    j += 1
                chunks.append(ConstituencyTree("NP", children=run))
                i = j
            elif tag in _VP_TAGS:
                j = i
                run = []
                while j < len(leaves) and tags[j] in _VP_TAGS:
                    run.append(leaves[j])
                    j += 1
                chunks.append(ConstituencyTree("VP", children=run))
                i = j
            else:
                chunks.append(leaves[i])
                i += 1
        # attach post-verbal chunks under VP (S → NP VP rather than a flat run)
        merged: List[ConstituencyTree] = []
        for c in chunks:
            if (merged and merged[-1].tag == "VP"
                    and c.tag in ("NP", "PP", "ADJP", "JJ")):
                merged[-1] = ConstituencyTree(
                    "VP", children=list(merged[-1].children) + [c])
            else:
                merged.append(c)
        if len(merged) == 1 and not merged[0].is_leaf():
            return ConstituencyTree("S", children=merged[0].children) \
                if merged[0].tag == "S" else ConstituencyTree("S", children=merged)
        return ConstituencyTree("S", children=merged)

    def get_trees(self, text: str) -> List[ConstituencyTree]:
        return [self.parse_tokens(s) for s in self._split_sentences(text)]


class TreeIterator:
    """Batched tree iteration over a sentence iterator
    (ref: TreeIterator.java)."""

    def __init__(self, sentence_iterator, vectorizer: "TreeVectorizer",
                 batch_size: int = 32):
        self.it = sentence_iterator
        self.vectorizer = vectorizer
        self.batch_size = batch_size

    def __iter__(self) -> Iterator[List[Tree]]:
        self.it.reset()
        batch: List[Tree] = []
        while self.it.has_next():
            batch.extend(self.vectorizer.get_trees_with_labels(self.it.next_sentence()))
            if len(batch) >= self.batch_size:
                yield batch
                batch = []
        if batch:
            yield batch


# -------------------------------------------------------- vectorization ----

def to_rntn_tree(t: ConstituencyTree, swn: Optional[SWN3] = None,
                 num_classes: int = 5) -> Tree:
    """Syntax tree → RNTN-ready nn.tree.Tree: every node gets an int
    sentiment label from the SWN3 lexicon over its span (the offline stand-in
    for treebank gold labels; ref getTreesWithLabels attaches caller labels).
    """
    swn = swn or SWN3()

    def convert(node: ConstituencyTree) -> Tree:
        label = swn.sentiment_class(swn.score_tokens(node.yield_words()),
                                    num_classes)
        if node.is_leaf():
            return Tree(label=label, word=node.word)
        return Tree(label=label, children=[convert(c) for c in node.children])

    return convert(t)


class TreeVectorizer:
    """sentences → binarized, unary-collapsed, sentiment-labeled trees
    (ref: TreeVectorizer.java getTrees/getTreesWithLabels)."""

    def __init__(self, parser: Optional[TreeParser] = None,
                 swn: Optional[SWN3] = None, num_classes: int = 5):
        self.parser = parser or TreeParser()
        self.swn = swn or SWN3()
        self.num_classes = num_classes

    def _transform(self, t: ConstituencyTree) -> ConstituencyTree:
        return collapse_unaries(binarize(t))

    def get_trees(self, sentences: str) -> List[ConstituencyTree]:
        return [self._transform(t) for t in self.parser.get_trees(sentences)]

    def get_trees_with_labels(self, sentences: str) -> List[Tree]:
        return [
            to_rntn_tree(t, self.swn, self.num_classes)
            for t in self.get_trees(sentences)
        ]
