"""Legacy Vectorizer API (port of ``data/vectorizer.py``; reference
``datasets/vectorizer/Vectorizer.java:33``
— "takes an input source and converts it to a matrix for neural network
consumption": a one-method contract, ``vectorize() -> DataSet``).

Superseded in practice by the RecordReader iterators (``records.py``) and the
NLP vectorizers (``nlp/vectorizer.py``); kept for API completeness, with a
text-corpus adapter bridging the modern pieces back to the legacy shape.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from .dataset import DataSet

__all__ = ["Vectorizer", "CallableVectorizer", "TextCorpusVectorizer"]


class Vectorizer:
    """``vectorize() -> DataSet`` contract (Vectorizer.java:39)."""

    def vectorize(self) -> DataSet:
        raise NotImplementedError


class CallableVectorizer(Vectorizer):
    """Adapter: any zero-arg callable returning (features, labels)."""

    def __init__(self, fn: Callable[[], tuple]):
        self._fn = fn

    def vectorize(self) -> DataSet:
        features, labels = self._fn()
        return DataSet(np.asarray(features, np.float32),
                       np.asarray(labels, np.float32))


class TextCorpusVectorizer(Vectorizer):
    """Docs + labels -> one DataSet via a fitted bag-of-words/TF-IDF
    vectorizer (the role the legacy API played before
    ``bagofwords/vectorizer`` replaced it)."""

    def __init__(self, docs: Sequence[str], labels: Sequence[int],
                 n_classes: int, tfidf: bool = True):
        if len(docs) != len(labels):
            raise ValueError(f"{len(docs)} docs but {len(labels)} labels")
        bad = [l for l in labels if not 0 <= int(l) < n_classes]
        if bad:
            raise ValueError(f"labels out of range [0, {n_classes}): {bad}")
        self.docs = list(docs)
        self.labels = list(labels)
        self.n_classes = n_classes
        self.tfidf = tfidf

    def vectorize(self) -> DataSet:
        from ..nlp.vectorizer import BagOfWordsVectorizer, TfidfVectorizer
        vec = (TfidfVectorizer() if self.tfidf else BagOfWordsVectorizer())
        feats = np.asarray(vec.fit_transform(self.docs), np.float32)
        onehot = np.eye(self.n_classes, dtype=np.float32)[
            np.asarray(self.labels, np.int64)]
        return DataSet(feats, onehot)
