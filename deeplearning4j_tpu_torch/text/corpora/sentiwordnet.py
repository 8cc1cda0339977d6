"""Counterpart of ``deeplearning4j_tpu/text/corpora/sentiwordnet.py``, copied.

SentiWordNet-style sentiment scoring.

Parity with ref: text/corpora/sentiwordnet/SWN3.java — score(words) in
[-1, 1], classForScore buckets, classify(text). The reference loads the
SentiWordNet 3.0 database from classpath resources; this build embeds a
compact polarity lexicon instead (no egress, no 20 MB database), keeping
the same API and bucket names so downstream code is interchangeable.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

# word → polarity in [-1, 1]. Inflections are resolved by suffix stripping.
_POLARITY: Dict[str, float] = {
    # strong positive
    "excellent": 1.0, "outstanding": 1.0, "superb": 1.0, "magnificent": 1.0,
    "perfect": 0.9, "brilliant": 0.9, "amazing": 0.9, "wonderful": 0.9,
    "fantastic": 0.9, "awesome": 0.9, "best": 0.9, "masterpiece": 0.9,
    "delightful": 0.8, "beautiful": 0.8, "great": 0.8, "terrific": 0.8,
    "love": 0.8, "loved": 0.8, "superior": 0.7, "remarkable": 0.7,
    # positive
    "good": 0.6, "nice": 0.5, "enjoyable": 0.6, "pleasant": 0.5,
    "happy": 0.6, "fun": 0.5, "funny": 0.5, "charming": 0.6, "solid": 0.4,
    "like": 0.4, "liked": 0.4, "likable": 0.5, "fresh": 0.4, "clever": 0.5,
    "smart": 0.5, "strong": 0.4, "better": 0.4, "win": 0.5, "winner": 0.5,
    "recommend": 0.6, "recommended": 0.6, "impressive": 0.6, "enjoy": 0.5,
    "interesting": 0.4, "engaging": 0.5, "compelling": 0.5, "success": 0.5,
    "successful": 0.5, "favorite": 0.6, "gem": 0.6, "thrilling": 0.5,
    # weak positive
    "fine": 0.2, "okay": 0.1, "ok": 0.1, "decent": 0.2, "watchable": 0.2,
    "adequate": 0.1, "fair": 0.1,
    # weak negative
    "slow": -0.2, "long": -0.1, "cheap": -0.2, "odd": -0.1, "weird": -0.2,
    "predictable": -0.2, "mediocre": -0.3, "bland": -0.3, "forgettable": -0.3,
    # negative
    "bad": -0.6, "poor": -0.5, "boring": -0.5, "dull": -0.5, "weak": -0.4,
    "tired": -0.4, "mess": -0.5, "flawed": -0.4, "disappointing": -0.6,
    "disappointment": -0.6, "annoying": -0.5, "stupid": -0.5, "silly": -0.3,
    "hate": -0.6, "hated": -0.6, "dislike": -0.5, "fail": -0.5, "fails": -0.5,
    "failure": -0.6, "worse": -0.5, "problem": -0.3, "lacking": -0.4,
    "lame": -0.5, "waste": -0.6, "wasted": -0.6, "ugly": -0.5,
    # strong negative
    "terrible": -0.9, "awful": -0.9, "horrible": -0.9, "dreadful": -0.9,
    "worst": -1.0, "atrocious": -1.0, "abysmal": -1.0, "garbage": -0.9,
    "disaster": -0.8, "disgusting": -0.8, "unwatchable": -0.9,
    "pathetic": -0.8, "painful": -0.7, "insulting": -0.7,
}

_NEGATORS = {"not", "no", "never", "n't", "nothing", "neither", "nor",
             "hardly", "barely"}

_SUFFIXES = ("ing", "ed", "ly", "es", "s", "er", "est")


def _lookup(word: str) -> float:
    w = word.lower()
    if w in _POLARITY:
        return _POLARITY[w]
    for suf in _SUFFIXES:
        if w.endswith(suf) and w[: -len(suf)] in _POLARITY:
            return _POLARITY[w[: -len(suf)]]
    return 0.0


class SWN3:
    """Lexicon sentiment scorer (ref: sentiwordnet/SWN3.java)."""

    def score_tokens(self, tokens: Sequence[str]) -> float:
        """Mean polarity of sentiment-bearing tokens, with single-step
        negation flipping ("not good" → negative)."""
        total, n = 0.0, 0
        negate = False
        for tok in tokens:
            low = tok.lower()
            if low in _NEGATORS:
                negate = True
                continue
            p = _lookup(low)
            if p != 0.0:
                total += -p if negate else p
                n += 1
            if low not in _NEGATORS:
                negate = False
        return total / n if n else 0.0

    def score(self, words: str) -> float:
        from deeplearning4j_tpu_torch.text.corpora.pos import word_tokenize

        return self.score_tokens(word_tokenize(words))

    def class_for_score(self, score: float) -> str:
        """Bucket names per ref SWN3.classForScore (the reference's
        stated intent — its literal if-chain has unreachable branches;
        here the thresholds partition [-1, 1])."""
        if score >= 0.75:
            return "strong_positive"
        if score > 0.25:
            return "positive"
        if score > 0:
            return "weak_positive"
        if score == 0:
            return "neutral"
        if score >= -0.25:
            return "weak_negative"
        if score > -0.75:
            return "negative"
        return "strong_negative"

    def classify(self, text: str) -> str:
        return self.class_for_score(self.score(text))

    def sentiment_class(self, score: float, num_classes: int = 5) -> int:
        """Integer class for tree labeling (Stanford-sentiment style:
        0=very negative .. 4=very positive for 5 classes)."""
        if num_classes == 2:
            return int(score >= 0)
        edges = [-0.5, -0.05, 0.05, 0.5]  # 5-way partition of [-1, 1]
        c = 0
        for e in edges:
            if score > e:
                c += 1
        return c
