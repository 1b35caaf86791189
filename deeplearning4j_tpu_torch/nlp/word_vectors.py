"""WordVectors query API: similarity, nearest words, analogy arithmetic
(port of ``nlp/word_vectors.py``).

Reference ``models/embeddings/wordvectors/WordVectors.java`` /
``WordVectorsImpl.java`` (similarity, wordsNearest, wordsNearestSum).
The queries run on the device that holds the tables: a nearest-neighbour
query is one normalized matrix-vector product over the vocabulary, in
float64 (no TF32 on the card), as the JAX package computes it on the host.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


class WordVectors:
    """Mixin over (vocab, lookup_table), both set by the owning model."""

    vocab = None          # VocabCache
    lookup_table = None   # InMemoryLookupTable

    def has_word(self, word: str) -> bool:
        return self.vocab.contains_word(word)

    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        return self.lookup_table.vector(word)

    def get_word_vector_matrix(self, word: str):
        return self.get_word_vector(word)

    def _normed(self) -> torch.Tensor:
        w = self.lookup_table.syn0.to(torch.float64)
        norm = torch.linalg.vector_norm(w, dim=1, keepdim=True)
        return w / torch.clamp(norm, min=1e-12)

    def similarity(self, a: str, b: str) -> float:
        """Cosine similarity (``WordVectorsImpl.similarity``), on the
        device, in the table's dtype."""
        ia, ib = self.vocab.index_of(a), self.vocab.index_of(b)
        syn0 = self.lookup_table.syn0
        if ia < 0 or ib < 0 or syn0 is None:
            return float("nan")
        va, vb = syn0[ia], syn0[ib]
        va = va / torch.clamp(torch.linalg.vector_norm(va), min=1e-12)
        vb = vb / torch.clamp(torch.linalg.vector_norm(vb), min=1e-12)
        return float(torch.dot(va, vb))

    def words_nearest(self, positive, negative: Sequence[str] = (),
                      top_n: int = 10) -> List[str]:
        """Nearest words to positive - negative (analogy support,
        ``WordVectorsImpl.wordsNearest``).  Also accepts the reference's
        two-arg overload ``words_nearest(word, n)``: an int in the second
        position is the result count."""
        if isinstance(negative, int):
            negative, top_n = (), negative
        if isinstance(positive, str):
            positive = [positive]
        normed = self._normed()
        query = torch.zeros(normed.shape[1], dtype=normed.dtype,
                            device=normed.device)
        exclude = set()
        for w in positive:
            idx = self.vocab.index_of(w)
            if idx >= 0:
                query += normed[idx]
                exclude.add(idx)
        for w in negative:
            idx = self.vocab.index_of(w)
            if idx >= 0:
                query -= normed[idx]
                exclude.add(idx)
        n = float(torch.linalg.vector_norm(query))
        if n < 1e-12:
            return []
        sims = normed @ (query / n)
        if exclude:
            sims[torch.tensor(sorted(exclude), device=sims.device)] = \
                -float("inf")
        # numpy's argsort of -sims (ties broken by the lower index), as the
        # JAX package orders them
        order = torch.sort(-sims, stable=True).indices[:top_n]
        keep = torch.isfinite(sims[order]).tolist()
        return [self.vocab.word_at_index(i)
                for i, ok in zip(order.tolist(), keep) if ok]

    def word_frequency(self, word: str) -> int:
        return self.vocab.word_frequency(word)
