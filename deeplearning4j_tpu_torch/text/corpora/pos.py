"""Counterpart of ``deeplearning4j_tpu/text/corpora/pos.py``, copied.

Part-of-speech tagging.

Parity with ref: text/annotator/PoStagger.java, which wraps a downloaded
OpenNLP maxent model behind UIMA. This environment has no egress and ships
no model files, so the tagger here is a self-contained rule-based tagger:
a closed-class lexicon plus ordered suffix/shape rules (the classic Brill
baseline tagger shape). It emits the same Penn tagset the reference's
pipeline consumes downstream (HeadWordFinder/TreeParser category rules).
"""

from __future__ import annotations

import re
from typing import List, Sequence

# Closed-class words: these the lexicon gets right regardless of context.
_LEXICON = {
    # determiners
    "the": "DT", "a": "DT", "an": "DT", "this": "DT", "that": "DT",
    "these": "DT", "those": "DT", "every": "DT", "some": "DT", "no": "DT",
    "any": "DT", "each": "DT", "all": "DT", "both": "DT",
    # pronouns
    "i": "PRP", "you": "PRP", "he": "PRP", "she": "PRP", "it": "PRP",
    "we": "PRP", "they": "PRP", "me": "PRP", "him": "PRP", "her": "PRP",
    "us": "PRP", "them": "PRP", "myself": "PRP", "itself": "PRP",
    "my": "PRP$", "your": "PRP$", "his": "PRP$", "its": "PRP$",
    "our": "PRP$", "their": "PRP$",
    # prepositions / subordinators
    "in": "IN", "on": "IN", "at": "IN", "by": "IN", "with": "IN",
    "from": "IN", "of": "IN", "for": "IN", "about": "IN", "into": "IN",
    "over": "IN", "under": "IN", "after": "IN", "before": "IN",
    "between": "IN", "against": "IN", "during": "IN", "without": "IN",
    "through": "IN", "if": "IN", "because": "IN", "while": "IN",
    "although": "IN", "than": "IN", "as": "IN",
    "to": "TO",
    # conjunctions
    "and": "CC", "or": "CC", "but": "CC", "nor": "CC", "yet": "CC",
    # modals
    "can": "MD", "could": "MD", "will": "MD", "would": "MD", "shall": "MD",
    "should": "MD", "may": "MD", "might": "MD", "must": "MD",
    # auxiliaries / common verbs
    "am": "VBP", "is": "VBZ", "are": "VBP", "was": "VBD", "were": "VBD",
    "be": "VB", "been": "VBN", "being": "VBG",
    "have": "VBP", "has": "VBZ", "had": "VBD", "having": "VBG",
    "do": "VBP", "does": "VBZ", "did": "VBD", "doing": "VBG", "done": "VBN",
    "not": "RB", "n't": "RB", "never": "RB", "very": "RB", "too": "RB",
    "also": "RB", "just": "RB", "so": "RB", "really": "RB", "quite": "RB",
    "there": "EX",
    # wh-words
    "who": "WP", "whom": "WP", "whose": "WP$", "which": "WDT", "what": "WP",
    "when": "WRB", "where": "WRB", "why": "WRB", "how": "WRB",
    # common irregular verbs (base forms are the usual rule-tagger misses)
    "go": "VB", "goes": "VBZ", "went": "VBD", "gone": "VBN", "going": "VBG",
    "get": "VB", "got": "VBD", "make": "VB", "made": "VBD", "say": "VB",
    "said": "VBD", "see": "VB", "saw": "VBD", "seen": "VBN", "know": "VB",
    "knew": "VBD", "take": "VB", "took": "VBD", "come": "VB", "came": "VBD",
    "think": "VB", "thought": "VBD", "give": "VB", "gave": "VBD",
    "run": "VB", "ran": "VBD", "sat": "VBD", "ate": "VBD", "eat": "VB",
    "like": "VBP", "likes": "VBZ", "liked": "VBD", "love": "VBP",
    "loves": "VBZ", "loved": "VBD", "hate": "VBP", "hates": "VBZ",
    "hated": "VBD", "want": "VBP", "wants": "VBZ", "wanted": "VBD",
    "feel": "VBP", "feels": "VBZ", "felt": "VBD", "seem": "VBP",
    "seems": "VBZ", "seemed": "VBD",
}

# Ordered (pattern, tag) suffix/shape rules, applied when the lexicon misses.
_RULES = [
    (re.compile(r"^\d+(\.\d+)?$"), "CD"),
    (re.compile(r"^[\$£€]\d"), "CD"),
    (re.compile(r".*ly$"), "RB"),
    (re.compile(r".*ing$"), "VBG"),
    (re.compile(r".*ed$"), "VBD"),
    (re.compile(r".*ness$"), "NN"),
    (re.compile(r".*ment$"), "NN"),
    (re.compile(r".*tion$"), "NN"),
    (re.compile(r".*ity$"), "NN"),
    (re.compile(r".*(ous|ful|ive|able|ible|al|ish|ic)$"), "JJ"),
    (re.compile(r".*est$"), "JJS"),
    (re.compile(r".*er$"), "JJR"),
    (re.compile(r".*s$"), "NNS"),
]

_PUNCT = {".": ".", ",": ",", "!": ".", "?": ".", ";": ":", ":": ":",
          "(": "-LRB-", ")": "-RRB-", '"': "''", "'": "''"}


class PosTagger:
    """Rule-based Penn-tagset tagger (ref: text/annotator/PoStagger.java).

    tag(tokens) → one tag per token. Context repairs: a token after a
    determiner/adjective that a verb rule caught is retagged nominal
    ("the running" → NN); capitalized non-initial tokens become NNP.
    """

    def tag(self, tokens: Sequence[str]) -> List[str]:
        tags: List[str] = []
        fallback: set = set()  # indices tagged NN only because nothing matched
        for i, tok in enumerate(tokens):
            low = tok.lower()
            if tok in _PUNCT:
                tags.append(_PUNCT[tok])
                continue
            if low in _LEXICON:
                tags.append(_LEXICON[low])
                continue
            if i > 0 and tok[:1].isupper():
                tags.append("NNP")
                continue
            for pat, t in _RULES:
                if pat.match(low):
                    tags.append(t)
                    break
            else:
                fallback.add(i)
                tags.append("NN")
        # context repair pass
        for i in range(1, len(tags)):
            prev = tags[i - 1]
            if prev in ("DT", "JJ", "PRP$") and tags[i] in ("VB", "VBP", "VBG", "VBD"):
                tags[i] = "NN"
            # infinitival "to <unknown>" prefers the verb reading ("to walk").
            # Only the no-rule fallback NNs qualify: suffix-rule NNs
            # (.*tion/.*ness/...) after prepositional "to" ("to perfection")
            # are genuine nouns and must keep their tag.
            elif prev == "TO" and tags[i] == "NN" and i in fallback:
                tags[i] = "VB"
        return tags

    def tag_sentence(self, sentence: str) -> List[str]:
        return self.tag(word_tokenize(sentence))


_TOKEN_RE = re.compile(r"\w+(?:'\w+)?|[^\w\s]")


def word_tokenize(sentence: str) -> List[str]:
    """Word/punct tokenizer for the parsing pipeline (splits trailing
    punctuation, unlike the whitespace DefaultTokenizer used for vectors)."""
    return _TOKEN_RE.findall(sentence)
