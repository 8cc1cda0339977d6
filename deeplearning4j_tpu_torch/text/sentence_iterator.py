"""Counterpart of ``deeplearning4j_tpu/text/sentence_iterator.py``, copied whole
(standard library only).

Sentence iterators (ref: text/sentenceiterator/ — SentenceIterator,
CollectionSentenceIterator, FileSentenceIterator, LineSentenceIterator,
SentencePreProcessor hook)."""

from __future__ import annotations

import os
from typing import Callable, Iterator, List, Optional


class SentenceIterator:
    def __init__(self, pre_processor: Optional[Callable[[str], str]] = None):
        self.pre_processor = pre_processor

    def _apply(self, s: str) -> str:
        return self.pre_processor(s) if self.pre_processor else s

    def has_next(self) -> bool:
        raise NotImplementedError

    def next_sentence(self) -> str:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self) -> Iterator[str]:
        self.reset()
        while self.has_next():
            yield self.next_sentence()


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences: List[str], pre_processor=None):
        super().__init__(pre_processor)
        self._sentences = list(sentences)
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._sentences)

    def next_sentence(self) -> str:
        s = self._apply(self._sentences[self._pos])
        self._pos += 1
        return s

    def reset(self) -> None:
        self._pos = 0


class LineSentenceIterator(SentenceIterator):
    """One sentence per line of a file (ref: LineSentenceIterator)."""

    def __init__(self, path: str, pre_processor=None):
        super().__init__(pre_processor)
        self.path = path
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            self._lines = [line.rstrip("\n") for line in f if line.strip()]
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._lines)

    def next_sentence(self) -> str:
        s = self._apply(self._lines[self._pos])
        self._pos += 1
        return s

    def reset(self) -> None:
        self._pos = 0


class FileSentenceIterator(SentenceIterator):
    """All files under a directory, one sentence per line
    (ref: FileSentenceIterator)."""

    def __init__(self, root: str, pre_processor=None):
        super().__init__(pre_processor)
        self._lines: List[str] = []
        if os.path.isdir(root):
            names = sorted(os.listdir(root))
            paths = [os.path.join(root, n) for n in names]
        else:
            paths = [root]
        for p in paths:
            if os.path.isfile(p):
                with open(p, "r", encoding="utf-8", errors="replace") as f:
                    self._lines.extend(line.rstrip("\n") for line in f if line.strip())
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._lines)

    def next_sentence(self) -> str:
        s = self._apply(self._lines[self._pos])
        self._pos += 1
        return s

    def reset(self) -> None:
        self._pos = 0
