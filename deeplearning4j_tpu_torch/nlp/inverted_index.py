"""In-memory inverted index + TF-IDF keyword extraction.

Reference ``text/invertedindex/InvertedIndex.java`` (Lucene-backed in the
reference) and the keyword-extraction role of the TF-IDF vectorizer
(``bagofwords/vectorizer/TfidfVectorizer.java``).  Host-side text
machinery: a posting-list dict; scoring is vectorized numpy over the
postings (the corpus-statistics math the reference delegates to Lucene).
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Dict, Iterable, List, Optional, Tuple

from .tokenization import DefaultTokenizerFactory, TokenizerFactory

__all__ = ["InvertedIndex", "KeywordExtractor"]


class InvertedIndex:
    """token -> [(doc_id, positions)] posting lists with doc lookup and
    batch-of-docs iteration (the reference's ``InvertedIndex<T>`` contract:
    addWordsToDoc / document / documents / numDocuments / totalWords)."""

    def __init__(self, tokenizer_factory: Optional[TokenizerFactory] = None):
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self._docs: List[List[str]] = []
        self._postings: Dict[str, Dict[int, List[int]]] = {}

    # -- construction --------------------------------------------------------
    def add_document(self, text_or_tokens) -> int:
        """Index one document; returns its doc id (reference
        ``addWordsToDoc``)."""
        if isinstance(text_or_tokens, str):
            tokens = self.tokenizer_factory.create(
                text_or_tokens).get_tokens()
        else:
            tokens = list(text_or_tokens)
        doc_id = len(self._docs)
        self._docs.append(tokens)
        for pos, t in enumerate(tokens):
            self._postings.setdefault(t, {}).setdefault(doc_id, []).append(pos)
        return doc_id

    def add_documents(self, docs: Iterable) -> List[int]:
        return [self.add_document(d) for d in docs]

    # -- queries -------------------------------------------------------------
    def document(self, doc_id: int) -> List[str]:
        return list(self._docs[doc_id])

    def documents(self, token: str) -> List[int]:
        """Doc ids containing the token (posting list order = insertion)."""
        return list(self._postings.get(token, {}))

    def positions(self, token: str, doc_id: int) -> List[int]:
        return list(self._postings.get(token, {}).get(doc_id, ()))

    def num_documents(self) -> int:
        return len(self._docs)

    def total_words(self) -> int:
        return sum(len(d) for d in self._docs)

    def document_frequency(self, token: str) -> int:
        return len(self._postings.get(token, {}))

    def term_frequency(self, token: str, doc_id: int) -> int:
        return len(self._postings.get(token, {}).get(doc_id, ()))

    def search(self, *tokens: str) -> List[int]:
        """Conjunctive (AND) search; ranked by summed term frequency."""
        if not tokens:
            return []
        sets = [set(self.documents(t)) for t in tokens]
        hits = set.intersection(*sets) if all(sets) else set()
        return sorted(hits, key=lambda d: -sum(
            self.term_frequency(t, d) for t in tokens))

    # -- eager iteration for trainers ---------------------------------------
    def __iter__(self):
        return iter(self._docs)


class KeywordExtractor:
    """TF-IDF keyword ranking over an InvertedIndex (the reference exposes
    this as ``TfidfVectorizer`` + index statistics)."""

    def __init__(self, index: InvertedIndex):
        self.index = index

    def keywords(self, doc_id: int, top_n: int = 10
                 ) -> List[Tuple[str, float]]:
        """Top-n (token, tfidf) for one document."""
        idx = self.index
        n_docs = max(idx.num_documents(), 1)
        counts = Counter(idx.document(doc_id))
        total = max(sum(counts.values()), 1)
        scored = [
            (t, (c / total) * math.log(n_docs / max(
                idx.document_frequency(t), 1)))
            for t, c in counts.items()]
        scored.sort(key=lambda kv: (-kv[1], kv[0]))
        return scored[:top_n]

    def corpus_keywords(self, top_n: int = 10) -> List[Tuple[str, float]]:
        """Top-n tokens by summed TF-IDF across all documents."""
        agg: Counter = Counter()
        for d in range(self.index.num_documents()):
            for t, s in self.keywords(d, top_n=10 ** 9):
                agg[t] += s
        out = sorted(agg.items(), key=lambda kv: (-kv[1], kv[0]))
        return out[:top_n]
