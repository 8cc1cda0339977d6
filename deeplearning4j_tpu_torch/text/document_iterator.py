"""Counterpart of ``deeplearning4j_tpu/text/document_iterator.py``, copied whole
(standard library only).

Document iteration (whole documents, vs sentence_iterator's sentences).

Parity with ref: text/documentiterator/ — `DocumentIterator` SPI
(nextDocument/hasNext/reset, returning InputStreams) and
`FileDocumentIterator` (each file under a directory is one document).
Streams become strings; a document-level iterator feeds ParagraphVectors
and the bag-of-words vectorizers.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence


class DocumentIterator:
    """SPI (ref: documentiterator/DocumentIterator.java)."""

    def has_next(self) -> bool:
        raise NotImplementedError

    def next_document(self) -> str:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self) -> Iterator[str]:
        self.reset()
        while self.has_next():
            yield self.next_document()


class CollectionDocumentIterator(DocumentIterator):
    def __init__(self, documents: Sequence[str]):
        self.documents = list(documents)
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self.documents)

    def next_document(self) -> str:
        doc = self.documents[self._pos]
        self._pos += 1
        return doc

    def reset(self) -> None:
        self._pos = 0


class FileDocumentIterator(DocumentIterator):
    """Each file under ``path`` (recursively, sorted) is one document
    (ref: documentiterator/FileDocumentIterator.java)."""

    def __init__(self, path: str, encoding: str = "utf-8"):
        if os.path.isfile(path):
            self.files: List[str] = [path]
        else:
            self.files = sorted(
                os.path.join(root, name)
                for root, _, names in os.walk(path)
                for name in names
            )
        self.encoding = encoding
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self.files)

    def next_document(self) -> str:
        path = self.files[self._pos]
        self._pos += 1
        with open(path, "r", encoding=self.encoding, errors="replace") as f:
            return f.read()

    def reset(self) -> None:
        self._pos = 0


class DocumentSentenceIterator:
    """Adapter: documents → the SentenceIterator surface (split on blank
    lines / newlines), so document sources feed Word2Vec etc. directly."""

    def __init__(self, docs: DocumentIterator):
        self.docs = docs
        self._buffer: List[str] = []

    def _fill(self) -> None:
        while not self._buffer and self.docs.has_next():
            doc = self.docs.next_document()
            self._buffer = [s.strip() for s in doc.splitlines() if s.strip()]

    def has_next(self) -> bool:
        self._fill()
        return bool(self._buffer)

    def next_sentence(self) -> str:
        self._fill()
        return self._buffer.pop(0)

    def reset(self) -> None:
        self.docs.reset()
        self._buffer = []
