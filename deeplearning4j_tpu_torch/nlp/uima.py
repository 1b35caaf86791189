"""Sentence segmentation + POS tagging (UIMA-module equivalent).

Reference ``deeplearning4j-nlp-uima`` (``text/uima/UimaResource.java`` +
UIMA-wrapped tokenizer/sentence/POS annotators).  UIMA is JVM
infrastructure; this build provides the two capabilities the pipeline
actually consumes — abbreviation-aware sentence segmentation and a
suffix/lexicon heuristic POS tagger — behind the same iterator/factory
surfaces.
"""
from __future__ import annotations

import re
from typing import Iterable, List, Optional, Sequence, Tuple

from .sentence_iterator import SentenceIterator
from .tokenization import DefaultTokenizerFactory, TokenizerFactory

__all__ = ["SentenceSegmenter", "UimaSentenceIterator", "PosTagger"]

_ABBREV = {"dr", "mr", "mrs", "ms", "prof", "sr", "jr", "st", "vs", "etc",
           "e.g", "i.e", "fig", "al", "inc", "ltd", "co", "dept", "est",
           "approx", "no", "vol", "p", "pp", "a.m", "p.m", "u.s"}

_BOUNDARY = re.compile(r"([.!?]+)(\s+|$)")


class SentenceSegmenter:
    """Rule-based splitter: ., !, ? boundaries, abbreviation + decimal +
    initial suppression (the UIMA sentence annotator's role)."""

    def __init__(self, extra_abbreviations: Iterable[str] = ()):
        self.abbrev = _ABBREV | {a.lower().rstrip(".")
                                 for a in extra_abbreviations}

    def segment(self, text: str) -> List[str]:
        out: List[str] = []
        start = 0
        for m in _BOUNDARY.finditer(text):
            end = m.end(1)
            before = text[start:m.start(1)].rstrip()
            word = before.rsplit(None, 1)[-1].lower() if before else ""
            if m.group(1) == ".":
                # decimals ("3.14") never match _BOUNDARY — no whitespace
                # follows their period — so only abbreviations and initials
                # need suppression here
                if word.rstrip(".") in self.abbrev:
                    continue           # "Dr." — not a boundary
                if len(word) == 1 and word.isalpha():
                    continue           # "J. Smith" initial
            sent = text[start:end].strip()
            if sent:
                out.append(sent)
            start = m.end()
        tail = text[start:].strip()
        if tail:
            out.append(tail)
        return out


class UimaSentenceIterator(SentenceIterator):
    """Sentence stream over raw documents (reference
    ``UimaSentenceIterator.java``)."""

    def __init__(self, documents: Sequence[str],
                 segmenter: Optional[SentenceSegmenter] = None,
                 pre_processor=None):
        super().__init__(pre_processor)
        self.documents = list(documents)
        self.segmenter = segmenter or SentenceSegmenter()

    def _raw(self):
        for doc in self.documents:
            yield from self.segmenter.segment(doc)


_POS_SUFFIX: List[Tuple[str, str]] = [
    ("ing", "VBG"), ("ed", "VBD"), ("ly", "RB"), ("ness", "NN"),
    ("ment", "NN"), ("tion", "NN"), ("sion", "NN"), ("ity", "NN"),
    ("ous", "JJ"), ("ful", "JJ"), ("ive", "JJ"), ("able", "JJ"),
    ("ible", "JJ"), ("al", "JJ"), ("er", "NN"), ("est", "JJS"),
    ("s", "NNS"),
]

_POS_LEXICON = {
    "the": "DT", "a": "DT", "an": "DT", "this": "DT", "that": "DT",
    "i": "PRP", "you": "PRP", "he": "PRP", "she": "PRP", "it": "PRP",
    "we": "PRP", "they": "PRP", "is": "VBZ", "are": "VBP", "was": "VBD",
    "were": "VBD", "be": "VB", "been": "VBN", "am": "VBP", "has": "VBZ",
    "have": "VBP", "had": "VBD", "do": "VBP", "does": "VBZ", "did": "VBD",
    "will": "MD", "would": "MD", "can": "MD", "could": "MD", "shall": "MD",
    "should": "MD", "may": "MD", "might": "MD", "must": "MD",
    "and": "CC", "or": "CC", "but": "CC", "not": "RB",
    "in": "IN", "on": "IN", "at": "IN", "by": "IN", "for": "IN",
    "with": "IN", "from": "IN", "to": "TO", "of": "IN", "as": "IN",
    "very": "RB", "quickly": "RB",
}


class PosTagger:
    """Lexicon + suffix heuristic tagger emitting Penn-Treebank-style tags
    (the UIMA POS annotator's role; accuracy scales with the supplied
    lexicon)."""

    def __init__(self, lexicon: Optional[dict] = None,
                 tokenizer_factory: Optional[TokenizerFactory] = None):
        self.lexicon = dict(_POS_LEXICON)
        if lexicon:
            self.lexicon.update({k.lower(): v for k, v in lexicon.items()})
        self.tokenizer_factory = tokenizer_factory or \
            DefaultTokenizerFactory()

    def tag_token(self, token: str) -> str:
        low = token.lower()
        if low in self.lexicon:
            return self.lexicon[low]
        if re.fullmatch(r"[-+]?\d[\d.,]*", token):
            return "CD"
        if token[:1].isupper() and low not in self.lexicon:
            return "NNP"
        for suffix, tag in _POS_SUFFIX:
            if len(low) > len(suffix) + 2 and low.endswith(suffix):
                return tag
        return "NN"

    def tag(self, sentence: str) -> List[Tuple[str, str]]:
        tokens = self.tokenizer_factory.create(sentence).get_tokens()
        return [(t, self.tag_token(t)) for t in tokens]
