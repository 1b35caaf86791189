"""Moving-window text utilities (reference ``text/movingwindow/``:
``Windows.java`` sliding context windows with sentence padding,
``Window.java`` the window carrier, ``WindowConverter.java`` window →
feature arrays via word vectors, ``ContextLabelRetriever.java``
``<LABEL> ... </LABEL>`` span extraction) — the pre-SequenceVectors
window-classification pipeline (sequence labeling over word2vec features).
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Window", "windows", "WindowConverter", "ContextLabelRetriever"]

_BEGIN_LABEL = re.compile(r"<([A-Z]+\d*)>")
_END_LABEL = re.compile(r"</([A-Z]+\d*)>")


class Window:
    """One centered word context (reference ``Window.java``): ``words`` of
    length ``window_size`` (padded with <s>/</s> at sentence bounds), the
    focus word at the median position, an optional label."""

    def __init__(self, words: Sequence[str], window_size: int,
                 begin: int, end: int, n_tokens: Optional[int] = None):
        self.words = list(words)
        self.window_size = window_size
        self.begin = begin       # token index of the window's first slot
        self.end = end           # token index of the window's last slot
        self.n_tokens = n_tokens  # sentence length (boundary detection)
        self.median = len(self.words) // 2
        self.label = "NONE"

    def focus_word(self) -> str:
        return self.words[self.median]

    def is_begin_label(self) -> bool:
        """Window touches the sentence start (contains <s> padding)."""
        return self.begin < 0

    def is_end_label(self) -> bool:
        """Window touches the sentence end (contains </s> padding).  Index
        based when ``n_tokens`` is known (a literal '</s>' input token must
        not fake a boundary); directly-built windows without it fall back to
        the sentinel check."""
        if self.n_tokens is not None:
            return self.end >= self.n_tokens
        return "</s>" in self.words

    def __repr__(self):
        return f"Window({' '.join(self.words)} @ {self.focus_word()})"


def windows(text_or_tokens, window_size: int = 5,
            tokenizer_factory=None, word_vectors=None) -> List[Window]:
    """Sliding windows over a sentence with <s>/</s> padding
    (``Windows.windows``).  ``word_vectors``: when given, tokens without a
    vector are skipped (the reference's UNK-handling branch,
    Windows.java:103-118)."""
    if isinstance(text_or_tokens, str):
        if tokenizer_factory is not None:
            tokens = tokenizer_factory.create(text_or_tokens).get_tokens()
        else:
            tokens = text_or_tokens.split()
    else:
        tokens = list(text_or_tokens)
    if word_vectors is not None:
        tokens = [t for t in tokens
                  if word_vectors.get_word_vector(t) is not None]
    if not tokens:
        raise ValueError("No tokens found for windows")
    if window_size % 2 == 0:
        raise ValueError(f"window_size must be odd (a centered window); "
                         f"got {window_size}")
    half = window_size // 2
    out = []
    for i in range(len(tokens)):
        ctx = []
        for j in range(i - half, i + half + 1):
            if j < 0:
                ctx.append("<s>")
            elif j >= len(tokens):
                ctx.append("</s>")
            else:
                ctx.append(tokens[j])
        out.append(Window(ctx, window_size, i - half, i + half,
                          n_tokens=len(tokens)))
    return out


class WindowConverter:
    """Window → feature arrays via a fitted word-vector model
    (``WindowConverter.java``)."""

    @staticmethod
    def as_example_matrix(window: Window, vec) -> np.ndarray:
        """[window_size, layer_size] matrix of the window's word vectors;
        padding/unknown words map to zero rows."""
        vectors = [vec.get_word_vector(w) for w in window.words]
        if hasattr(vec, "lookup_table"):
            dim = int(np.asarray(vec.lookup_table.syn0).shape[1])
        else:
            known = [v for v in vectors if v is not None]
            if not known:
                raise ValueError(
                    "cannot infer vector dimension: no word in the window "
                    "has a vector and the model has no lookup_table")
            dim = len(known[0])
        return np.stack([np.zeros(dim, np.float32) if v is None
                         else np.asarray(v, np.float32) for v in vectors])

    @staticmethod
    def as_example_array(window: Window, vec, normalize: bool = False
                         ) -> np.ndarray:
        """Concatenated window vectors, the classifier input layout
        (WindowConverter.java:58)."""
        m = WindowConverter.as_example_matrix(window, vec)
        flat = m.reshape(-1)
        if normalize:
            n = np.linalg.norm(flat)
            if n > 0:
                flat = flat / n
        return flat


class ContextLabelRetriever:
    """Strip ``<LABEL> words </LABEL>`` markup, returning the plain text and
    the labeled spans (``ContextLabelRetriever.stringWithLabels``)."""

    @staticmethod
    def string_with_labels(sentence: str, tokenizer_factory=None
                           ) -> Tuple[str, Dict[str, List[Tuple[int, int]]]]:
        """Returns (stripped_text, {label: [(start_token, end_token), ...]})
        with token indices into the stripped text.  Spans are lists: a label
        can occur several times per sentence (the reference returns a
        multimap for the same reason)."""
        tokens = (tokenizer_factory.create(sentence).get_tokens()
                  if tokenizer_factory is not None else sentence.split())
        out_tokens: List[str] = []
        spans: Dict[str, List[Tuple[int, int]]] = {}
        current: Optional[str] = None
        start = 0
        for tok in tokens:
            mb = _BEGIN_LABEL.fullmatch(tok)
            me = _END_LABEL.fullmatch(tok)
            if mb is not None:
                if current is not None:
                    raise ValueError(
                        f"nested label '{mb.group(1)}' inside '{current}'")
                current, start = mb.group(1), len(out_tokens)
            elif me is not None:
                if current != me.group(1):
                    raise ValueError(
                        f"mismatched close tag '{me.group(1)}' "
                        f"(open: '{current}')")
                spans.setdefault(current, []).append((start, len(out_tokens)))
                current = None
            else:
                out_tokens.append(tok)
        if current is not None:
            raise ValueError(f"unclosed label '{current}'")
        return " ".join(out_tokens), spans
