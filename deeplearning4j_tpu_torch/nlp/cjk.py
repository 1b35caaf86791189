"""CJK tokenizer factories (Chinese / Japanese / Korean).

Reference ``deeplearning4j-nlp-chinese`` (vendored ansj segmenter),
``deeplearning4j-nlp-japanese`` (vendored kuromoji), and
``deeplearning4j-nlp-korean`` TokenizerFactory wrappers.  The reference
vendors full morphological analyzers (~20k LoC of dictionaries each); the
port carries a small bundled high-frequency lexicon (``lexicons.py``)
and segments by **unigram Viterbi lattice**: best[i] maximizes the summed
word log-probabilities over any tiling of the text, with per-character OOV
fallbacks and same-script-run candidates (so unknown katakana/latin words
stay whole).  This resolves the classic ambiguities a greedy matcher gets
wrong (e.g. 研究/生命/科学 vs 研究生/命/科学).  Users extend coverage by
passing a ``dictionary`` — their entries outrank the bundled lexicon.

The lattice DP is a host-side Viterbi over text positions with variable
arcs (one per candidate word); ``utils/viterbi.py`` stays the accelerator
path for fixed-state HMM decoding, which this deliberately is not — token
emission is host work feeding the device pipeline.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional

from .lexicons import _OOV_CHAR, CHINESE_LEXICON, JAPANESE_LEXICON
from .tokenization import TokenPreProcess, Tokenizer, TokenizerFactory

__all__ = ["ChineseTokenizerFactory", "JapaneseTokenizerFactory",
           "KoreanTokenizerFactory", "lattice_segment"]

_USER_WORD_LOGP = -3.5   # user-dictionary entries outrank bundled words
# Bigram transition weight for the Japanese lattice: selected with the
# bigram count floor on a dev split carved from INSIDE the Botchan train
# spans (fit 90% / dev 10%; beta 0.75 + count floor 1 won).  The
# held-out/decompound gold never touched the choice.
_JA_BIGRAM_BETA = 0.75


def lattice_segment(text: str, lexicon: Dict[str, float], *,
                    max_len: int = 8, oov_logp: float = _OOV_CHAR,
                    run_candidates: bool = False,
                    bigrams: Optional[Dict[tuple, float]] = None,
                    beta: float = 1.0) -> List[str]:
    """Viterbi word lattice: choose the tiling of ``text`` that maximizes
    the summed word log-probabilities.  Candidates per position: every
    lexicon word starting there, a single-character OOV fallback, and
    (``run_candidates``) the maximal same-script katakana/latin/digit
    run — scored slightly above the equivalent chain of OOV chars so
    unknown transliterations/numbers stay one token.

    ``bigrams`` upgrades the unigram DP to a word-state Viterbi with
    transition scores (the ansj ``NgramLibrary.java:16-31`` / kuromoji
    ``ViterbiSearcher`` mechanism): an edge whose ``(prev_word, word)``
    pair is in the table earns ``beta`` x its positive-PMI bonus
    (``"<s>"`` = run-initial); unseen pairs stay pure unigram, so valid
    rare transitions are never penalized."""
    if bigrams is not None:
        return _lattice_segment_bigram(text, lexicon, bigrams,
                                       max_len=max_len, oov_logp=oov_logp,
                                       run_candidates=run_candidates,
                                       beta=beta)
    n = len(text)
    NEG = float("-inf")
    best = [0.0] + [NEG] * n
    back = [0] * (n + 1)
    for i in range(n):
        if best[i] == NEG:
            continue
        for j, _w, sc in _candidates(text, i, lexicon, max_len, oov_logp,
                                     run_candidates):
            if best[i] + sc > best[j]:
                best[j] = best[i] + sc
                back[j] = i
    out: List[str] = []
    i = n
    while i > 0:
        out.append(text[back[i]:i])
        i = back[i]
    return out[::-1]


def _candidates(text: str, i: int, lexicon: Dict[str, float],
                max_len: int, oov_logp: float, run_candidates: bool):
    """Candidate (end, word, base_score) arcs starting at position ``i`` —
    THE arc set (both DP variants iterate this; do not fork it)."""
    n = len(text)
    out = []
    top = min(max_len, n - i)
    for ln in range(1, top + 1):
        w = text[i:i + ln]
        sc = lexicon.get(w)
        if sc is not None:
            out.append((i + ln, w, sc))
    if lexicon.get(text[i]) is None:
        out.append((i + 1, text[i], oov_logp))
    if run_candidates:
        k = _script(text[i])
        if k in ("kata", "latin"):
            j = i + 1
            while j < n and _script(text[j]) == k:
                j += 1
            if j - i > 1:
                out.append((j, text[i:j], oov_logp * (j - i) * 0.6))
        elif k == "han" and i + 2 <= n and _script(text[i + 1]) == "han":
            # unknown kanji compounds decompose into 2-char units (the
            # dominant Sino-Japanese word shape; kuromoji's search-mode
            # heuristic makes the same bet) — scored just above two OOV
            # singles so any real lexicon word still outranks it
            w = text[i:i + 2]
            if lexicon.get(w) is None:
                out.append((i + 2, w, oov_logp * 1.9))
    return out


def _lattice_segment_bigram(text: str, lexicon: Dict[str, float],
                            bigrams: Dict[tuple, float], *, max_len: int,
                            oov_logp: float, run_candidates: bool,
                            beta: float) -> List[str]:
    """Word-state Viterbi: ``nodes[i][word] = (score, backpointer)`` for
    every word ending at ``i``, so transition bonuses can condition on the
    actual previous word (a position-indexed DP cannot).  Arc count per
    position is <= max_len + 2, so this stays O(n * max_len^2) host work."""
    n = len(text)
    nodes: List[Dict[str, tuple]] = [{} for _ in range(n + 1)]
    nodes[0]["<s>"] = (0.0, None)
    for i in range(n):
        if not nodes[i]:
            continue
        for j, w, base in _candidates(text, i, lexicon, max_len, oov_logp,
                                      run_candidates):
            for pw, (psc, _) in nodes[i].items():
                bonus = bigrams.get((pw, w))
                sc = psc + base + (beta * bonus if bonus else 0.0)
                cur = nodes[j].get(w)
                if cur is None or sc > cur[0]:
                    nodes[j][w] = (sc, (i, pw))
    out: List[str] = []
    i, w = n, max(nodes[n], key=lambda k: nodes[n][k][0])
    while i > 0:
        out.append(w)
        i, w = nodes[i][w][1]
    return out[::-1]


def _is_han(ch: str) -> bool:
    return "一" <= ch <= "鿿" or "㐀" <= ch <= "䶿"


def _is_hiragana(ch: str) -> bool:
    return "぀" <= ch <= "ゟ"


def _is_katakana(ch: str) -> bool:
    return "゠" <= ch <= "ヿ"


def _is_hangul(ch: str) -> bool:
    return "가" <= ch <= "힯" or "ᄀ" <= ch <= "ᇿ"


def _script(ch: str) -> str:
    if _is_han(ch):
        return "han"
    if _is_hiragana(ch):
        return "hira"
    if _is_katakana(ch):
        return "kata"
    if _is_hangul(ch):
        return "hangul"
    if ch.isalnum():
        return "latin"
    if ch.isspace():
        return "space"
    return "punct"


_MAX_WORD_CACHE: Dict[int, int] = {}


def _factory_lexicon(base: Dict[str, float], dictionary):
    """Share the module-level lexicon (38k+ entries with the bundled data
    tiers — copying per factory would be an O(lexicon) tax on every
    instantiation) unless a user dictionary extends it; the max word
    length is cached per base dict."""
    if dictionary:
        lex = dict(base)
        for w in dictionary:
            lex[w] = _USER_WORD_LOGP
        return lex, max((len(w) for w in lex), default=1)
    key = id(base)
    if key not in _MAX_WORD_CACHE:
        _MAX_WORD_CACHE[key] = max((len(w) for w in base), default=1)
    return base, _MAX_WORD_CACHE[key]


class ChineseTokenizerFactory(TokenizerFactory):
    """Reference ``ChineseTokenizerFactory.java`` (ansj).  Han runs are
    segmented by the bundled-lexicon Viterbi lattice; an optional user
    ``dictionary`` merges in with priority.  Non-Han runs tokenize like
    the default whitespace tokenizer."""

    def __init__(self, pre_processor: Optional[TokenPreProcess] = None,
                 dictionary: Optional[Iterable[str]] = None):
        super().__init__(pre_processor)
        self.lexicon, self._max_word = _factory_lexicon(CHINESE_LEXICON,
                                                        dictionary)

    def create(self, sentence: str) -> Tokenizer:
        tokens: List[str] = []
        run = ""
        run_kind = None  # 'han' | 'other'

        def flush():
            nonlocal run
            if not run:
                return
            if run_kind == "han":
                tokens.extend(lattice_segment(run, self.lexicon,
                                              max_len=self._max_word))
            else:
                tokens.extend(run.split())
            run = ""

        for ch in sentence:
            kind = "han" if _is_han(ch) else "other"
            if kind != run_kind:
                flush()
                run_kind = kind
            run += ch
        flush()
        return Tokenizer([t for t in tokens if t.strip()], self._pre)


class JapaneseTokenizerFactory(TokenizerFactory):
    """Reference ``JapaneseTokenizerFactory.java`` (kuromoji).  The whole
    sentence (minus spaces/punctuation) runs through the bundled-lexicon
    Viterbi lattice: particles/auxiliaries split off content words, known
    kanji compounds stay whole, unknown katakana/latin runs survive as
    single tokens.  A user ``dictionary`` merges in with priority."""

    def __init__(self, pre_processor: Optional[TokenPreProcess] = None,
                 dictionary: Optional[Iterable[str]] = None,
                 bigram_beta: float = _JA_BIGRAM_BETA):
        super().__init__(pre_processor)
        self.lexicon, self._max_word = _factory_lexicon(JAPANESE_LEXICON,
                                                        dictionary)
        from .lexicons import JAPANESE_BIGRAMS
        # beta 0 (or an empty table) opts back into the unigram lattice
        self.bigrams = JAPANESE_BIGRAMS if bigram_beta > 0 else None
        self.bigram_beta = bigram_beta

    def create(self, sentence: str) -> Tokenizer:
        tokens: List[str] = []

        def flush(run):
            # merge per lattice run: single-char kata fallbacks must not
            # fuse across punctuation/space boundaries
            tokens.extend(_merge_kata_singles(lattice_segment(
                run, self.lexicon, max_len=self._max_word,
                run_candidates=True, bigrams=self.bigrams or None,
                beta=self.bigram_beta)))

        run = ""
        for ch in sentence:
            if _script(ch) in ("space", "punct"):
                if run:
                    flush(run)
                    run = ""
            else:
                run += ch
        if run:
            flush(run)
        return Tokenizer(tokens, self._pre)


def _merge_kata_singles(tokens: List[str]) -> List[str]:
    """Fuse runs of adjacent single-character katakana fallbacks into one
    token: when a lexicon word consumes the head of a katakana compound
    (ソフト|ウ|ェ|ア...), the orphaned chars are one unknown loanword, not
    letters — kuromoji's unknown-word grouping does the same."""
    out: List[str] = []
    run = ""
    for t in tokens:
        if len(t) == 1 and (_is_katakana(t) or t == "ー"):
            run += t
        else:
            if run:
                out.append(run)
                run = ""
            out.append(t)
    if run:
        out.append(run)
    return out


_KO_PARTICLES = ("은", "는", "이", "가", "을", "를", "의", "에", "에서",
                 "으로", "로", "와", "과", "도", "만", "께서", "까지")


class KoreanTokenizerFactory(TokenizerFactory):
    """Reference ``KoreanTokenizerFactory.java`` (KOMORAN wrapper role).

    Korean spaces between phrasal units (eojeol); each eojeol runs through
    the bundled-lexicon Viterbi lattice so nouns split from their trailing
    particles (josa) and the copula splits 입니|다 — the granularity of the
    reference's own KoreanTokenizerTest gold.  Runs of unknown single
    syllables inside one eojeol merge back into one token (an unknown stem
    is a word, not letters).  ``morphological=False`` restores the earlier
    behavior (whitespace tokens with trailing particles stripped) — and so
    does passing ``strip_particles`` explicitly, so existing callers of the
    legacy knob keep their output."""

    def __init__(self, pre_processor: Optional[TokenPreProcess] = None,
                 strip_particles: Optional[bool] = None,
                 morphological: Optional[bool] = None,
                 dictionary: Optional[Iterable[str]] = None):
        super().__init__(pre_processor)
        if morphological is None:
            # an explicit strip_particles request is a legacy-mode opt-in
            morphological = strip_particles is None
        self.strip_particles = (True if strip_particles is None
                                else strip_particles)
        self.morphological = morphological
        from .lexicons import KOREAN_LEXICON
        self.lexicon, self._max_word = _factory_lexicon(KOREAN_LEXICON,
                                                        dictionary)

    def create(self, sentence: str) -> Tokenizer:
        words = re.findall(r"[\w가-힯]+", sentence)
        if self.morphological:
            tokens: List[str] = []
            for w in words:
                if not _is_hangul(w[0]):
                    tokens.append(w)
                    continue
                tokens.extend(self._merge_unknown_singles(lattice_segment(
                    w, self.lexicon, max_len=self._max_word)))
            return Tokenizer(tokens, self._pre)
        if self.strip_particles:
            out = []
            for w in words:
                for p in sorted(_KO_PARTICLES, key=len, reverse=True):
                    if len(w) > len(p) and w.endswith(p) and \
                            _is_hangul(w[0]):
                        w = w[: -len(p)]
                        break
                out.append(w)
            words = out
        return Tokenizer(words, self._pre)

    def _merge_unknown_singles(self, tokens: List[str]) -> List[str]:
        """Adjacent single-syllable OOV fallbacks fuse into one unknown
        word; lexicon singles (particles, endings) stay separate."""
        out: List[str] = []
        run = ""
        for t in tokens:
            if len(t) == 1 and t not in self.lexicon and _is_hangul(t):
                run += t
            else:
                if run:
                    out.append(run)
                    run = ""
                out.append(t)
        if run:
            out.append(run)
        return out
