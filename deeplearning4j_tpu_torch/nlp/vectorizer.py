"""Text vectorizers: bag-of-words counts and TF-IDF.

Reference ``bagofwords/vectorizer/``: ``BagOfWordsVectorizer.java``,
``TfidfVectorizer.java`` (Lucene-backed in the reference; a host dict +
numpy matrix here — the vectors feed straight into DataSet batches).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .tokenization import DefaultTokenizerFactory, TokenizerFactory
from .vocab import VocabCache, VocabConstructor


class BagOfWordsVectorizer:
    def __init__(self, tokenizer_factory: Optional[TokenizerFactory] = None,
                 min_word_frequency: int = 1):
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.min_word_frequency = min_word_frequency
        self.vocab: Optional[VocabCache] = None

    def _tokens(self, docs: Sequence[str]) -> List[List[str]]:
        return [self.tokenizer_factory.create(d).get_tokens() for d in docs]

    def fit(self, docs: Sequence[str]) -> "BagOfWordsVectorizer":
        self.vocab = VocabConstructor(self.min_word_frequency).build(
            self._tokens(docs))
        return self

    def transform(self, docs: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(docs), self.vocab.num_words()), dtype=np.float32)
        for r, toks in enumerate(self._tokens(docs)):
            for t in toks:
                idx = self.vocab.index_of(t)
                if idx >= 0:
                    out[r, idx] += 1.0
        return out

    def fit_transform(self, docs: Sequence[str]) -> np.ndarray:
        return self.fit(docs).transform(docs)


class TfidfVectorizer(BagOfWordsVectorizer):
    """TF-IDF weighting: tf × log(N / df) (``TfidfVectorizer.java``)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.idf: Optional[np.ndarray] = None

    def fit(self, docs: Sequence[str]) -> "TfidfVectorizer":
        super().fit(docs)
        n_docs = max(len(docs), 1)
        df = np.zeros(self.vocab.num_words(), dtype=np.float64)
        for toks in self._tokens(docs):
            for idx in {self.vocab.index_of(t) for t in toks}:
                if idx >= 0:
                    df[idx] += 1
        self.idf = np.log(n_docs / np.maximum(df, 1.0)).astype(np.float32)
        return self

    def transform(self, docs: Sequence[str]) -> np.ndarray:
        return super().transform(docs) * self.idf
