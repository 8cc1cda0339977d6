"""Counterpart of ``deeplearning4j_tpu/text/tokenization.py``, copied whole
(standard library only).

Tokenizers + factories.

Parity with ref: text/tokenization/ — Tokenizer (hasMoreTokens/nextToken/
getTokens), TokenizerFactory, DefaultTokenizer (java StringTokenizer
semantics: whitespace split), NGramTokenizerFactory, and the
TokenPreProcess hook (e.g. lowercasing/strip-punct EndingPreProcessor).
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional


class Tokenizer:
    def __init__(self, tokens: List[str]):
        self._tokens = tokens
        self._pos = 0

    def has_more_tokens(self) -> bool:
        return self._pos < len(self._tokens)

    def next_token(self) -> str:
        tok = self._tokens[self._pos]
        self._pos += 1
        return tok

    def count_tokens(self) -> int:
        return len(self._tokens)

    def get_tokens(self) -> List[str]:
        return list(self._tokens)


class TokenPreProcess:
    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation (ref: text/tokenization/tokenizer/
    preprocessor/)."""

    _PUNCT = re.compile(r"[\.,!?;:\"'()\[\]{}<>]")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token.lower())


class TokenizerFactory:
    def create(self, text: str) -> Tokenizer:
        raise NotImplementedError


class DefaultTokenizerFactory(TokenizerFactory):
    """Whitespace tokenizer (ref: DefaultTokenizer via StringTokenizer)."""

    def __init__(self, pre_processor: Optional[TokenPreProcess] = None):
        self.pre_processor = pre_processor

    def create(self, text: str) -> Tokenizer:
        tokens = text.split()
        if self.pre_processor is not None:
            tokens = [self.pre_processor.pre_process(t) for t in tokens]
            tokens = [t for t in tokens if t]
        return Tokenizer(tokens)


class NGramTokenizerFactory(TokenizerFactory):
    """Emit n-grams of the base tokens (ref: NGramTokenizerFactory)."""

    def __init__(self, base: TokenizerFactory, min_n: int, max_n: int):
        self.base = base
        self.min_n = min_n
        self.max_n = max_n

    def create(self, text: str) -> Tokenizer:
        base_tokens = self.base.create(text).get_tokens()
        out: List[str] = []
        for n in range(self.min_n, self.max_n + 1):
            for i in range(len(base_tokens) - n + 1):
                out.append(" ".join(base_tokens[i : i + n]))
        return Tokenizer(out)
