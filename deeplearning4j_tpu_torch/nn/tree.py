"""Counterpart of ``deeplearning4j_tpu/nn/tree.py``, copied: parse trees
for recursive models (RNTN, recursive autoencoder).

Parity with ref rntn/Tree usage and nn/layers/feedforward/recursive/Tree.java
(485 LoC): children/label/value accessors, leaves, pre-order traversal, plus
an s-expression parser for Stanford-sentiment-style strings like
``(3 (2 good) (3 (2 great) (2 movie)))``.

``linearize`` flattens a binary tree into arrays of merge steps (left,
right, out indices), so a bucket of trees evaluates as one loop over merge
steps batched across the trees instead of per-node Python recursion.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class Tree:
    label: Optional[int] = None  # gold class (e.g. sentiment 0..4)
    word: Optional[str] = None  # set on leaves
    children: List["Tree"] = field(default_factory=list)

    def is_leaf(self) -> bool:
        return not self.children

    def leaves(self) -> List["Tree"]:
        if self.is_leaf():
            return [self]
        out: List[Tree] = []
        for c in self.children:
            out.extend(c.leaves())
        return out

    def preorder(self) -> List["Tree"]:
        out = [self]
        for c in self.children:
            out.extend(c.preorder())
        return out

    def depth(self) -> int:
        if self.is_leaf():
            return 0
        return 1 + max(c.depth() for c in self.children)

    def num_nodes(self) -> int:
        return len(self.preorder())

    def yield_words(self) -> List[str]:
        return [leaf.word for leaf in self.leaves()]

    @staticmethod
    def parse(s: str) -> "Tree":
        """Parse an s-expression: ``(label child child)`` | ``(label word)``."""
        tokens = s.replace("(", " ( ").replace(")", " ) ").split()
        pos = [0]

        def read() -> Tree:
            assert tokens[pos[0]] == "(", f"expected '(' at {pos[0]}"
            pos[0] += 1
            label = tokens[pos[0]]
            pos[0] += 1
            node = Tree(label=int(label) if label.lstrip("-").isdigit() else None)
            if tokens[pos[0]] == "(":
                while tokens[pos[0]] == "(":
                    node.children.append(read())
            else:
                node.word = tokens[pos[0]]
                pos[0] += 1
            assert tokens[pos[0]] == ")", f"expected ')' at {pos[0]}"
            pos[0] += 1
            return node

        tree = read()
        assert pos[0] == len(tokens), "trailing tokens"
        return tree

    def binarize(self) -> "Tree":
        """Left-branching binarization of n-ary nodes (merge steps need
        exactly two children)."""
        if self.is_leaf():
            return Tree(label=self.label, word=self.word)
        kids = [c.binarize() for c in self.children]
        if len(kids) == 1:
            # collapse unary chains, keep the top label
            only = kids[0]
            return Tree(label=self.label, word=only.word,
                        children=list(only.children))
        node = kids[0]
        # fabricated intermediate nodes carry NO gold label — only the real
        # top node keeps self.label (labeling invented spans would train the
        # model on supervision no annotator provided)
        for k in kids[1:-1]:
            node = Tree(label=None, children=[node, k])
        return Tree(label=self.label, children=[node, kids[-1]])


def linearize(tree: Tree, word_index, unk_index: int = 0
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flatten a binarized tree into scan-ready arrays.

    Returns (leaf_ids, merges, labels):
    - leaf_ids: (L,) vocab index per leaf (slots 0..L-1 of the node buffer)
    - merges: (M,3) [left_slot, right_slot, out_slot] in bottom-up order;
      out slots are L..L+M-1
    - labels: (L+M,) gold label per buffer slot (-1 where unlabeled)
    """
    leaves: List[int] = []
    merges: List[Tuple[int, int, int]] = []

    def slot_of(node: Tree) -> int:
        if node.is_leaf():
            idx = word_index(node.word) if callable(word_index) else \
                word_index.get(node.word, unk_index)
            if idx is None or idx < 0:
                idx = unk_index
            leaves.append(idx)
            return len(leaves) - 1
        assert len(node.children) == 2, "linearize requires a binarized tree"
        l = slot_of(node.children[0])
        r = slot_of(node.children[1])
        out = -(len(merges) + 1)  # placeholder, patched below
        merges.append((l, r, out))
        return out

    slot_of(tree)
    n_leaves = len(leaves)
    # patch merge output slots (and child refs to merge outputs) to be
    # offset past the leaves; labels were appended leaf-interleaved, so
    # rebuild them in slot order
    fixed = []
    for l, r, out in merges:
        fix = lambda s: n_leaves + (-s - 1) if s < 0 else s
        fixed.append((fix(l), fix(r), fix(out)))
    # walk again assigning labels in slot order (same DFS as slot_of)
    slot_labels = np.full(n_leaves + len(merges), -1, np.int32)
    li = 0
    mi = 0

    def assign(node: Tree) -> int:
        nonlocal li, mi
        if node.is_leaf():
            s = li
            li += 1
            slot_labels[s] = node.label if node.label is not None else -1
            return s
        assign(node.children[0])
        assign(node.children[1])
        s = n_leaves + mi
        mi += 1
        slot_labels[s] = node.label if node.label is not None else -1
        return s

    assign(tree)
    return (np.asarray(leaves, np.int32),
            np.asarray(fixed, np.int32).reshape(-1, 3),
            slot_labels)
