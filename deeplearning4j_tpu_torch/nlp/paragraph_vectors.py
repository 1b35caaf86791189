"""ParagraphVectors (doc2vec): DBOW and DM over labelled documents (port
of ``nlp/paragraph_vectors.py``).

Reference ``models/paragraphvectors/ParagraphVectors.java:47``: document
labels join the vocab as special elements; DBOW trains the label row with
skip-gram pairs (label → each word), DM includes the label row in the CBOW
context average.  ``inferVector`` runs the same update against frozen output
weights, touching only the new document's vector (SkipGram.java isInference
branch).

``infer_vector`` seeds its starting vector from ``abs(hash(text))``, as the
JAX package does.  Python salts string hashes per process
(``PYTHONHASHSEED``), so both packages agree inside one process and
neither repeats its own result in another.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..utils import _random
from .elements import infer_step
from .sentence_iterator import LabelAwareIterator, LabelledDocument
from .sequence_vectors import SequenceVectors, _label_arrays, _to_device
from .tokenization import DefaultTokenizerFactory, TokenizerFactory


class ParagraphVectors(SequenceVectors):
    def __init__(self, iterator: Optional[LabelAwareIterator] = None,
                 documents: Optional[Sequence[LabelledDocument]] = None,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 sequence_algorithm: str = "dbow", **kwargs):
        if sequence_algorithm not in ("dbow", "dm"):
            raise ValueError(f"unknown sequence algorithm {sequence_algorithm}")
        # DBOW ≙ skip-gram pair emission, DM ≙ CBOW emission with the label
        kwargs["elements_algorithm"] = (
            "skipgram" if sequence_algorithm == "dbow" else "cbow")
        super().__init__(**kwargs)
        self.sequence_algorithm = sequence_algorithm
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        if iterator is not None:
            docs = list(iterator)
        elif documents is not None:
            docs = list(documents)
        else:
            docs = []
        self._docs: List[LabelledDocument] = docs
        self._tokens: List[List[str]] = [
            self.tokenizer_factory.create(d.content).get_tokens()
            for d in self._docs]
        self.labels = sorted({l for d in self._docs for l in d.labels})

    # -- corpus hooks --------------------------------------------------------
    def _sequences(self) -> Iterable[List[str]]:
        return iter(self._tokens)

    def _raw_sentences(self):
        """Raw document contents for the native corpus indexer — only when
        tokenization is exactly ``str.split`` (plain DefaultTokenizerFactory,
        no pre-processor), mirroring the Word2Vec gate."""
        if (type(self.tokenizer_factory) is DefaultTokenizerFactory
                and self.tokenizer_factory._pre is None):
            return [d.content for d in self._docs]
        return None

    def _sequence_labels(self, seq_index: int) -> Sequence[str]:
        return self._docs[seq_index].labels

    def _bulk_label_width(self) -> int:
        """Docs are materialized up front, so the corpus-constant label
        width the bulk path needs is known — labeled fits ride the same
        corpus-level fast path as Word2Vec (DBOW via bulk skip-gram with
        label→word pairs, DM via bulk CBOW with label columns)."""
        return max((len(d.labels) for d in self._docs), default=0)

    def _label_indices(self, seq_index: int) -> np.ndarray:
        idx = (self.vocab.index_of(l)
               for l in self._docs[seq_index].labels)
        return np.array([i for i in idx if i >= 0], dtype=np.int64)

    def build_vocab(self, extra_labels: Sequence[str] = ()) -> None:
        super().build_vocab(extra_labels=tuple(self.labels) + tuple(extra_labels))

    # -- queries -------------------------------------------------------------
    def get_label_vector(self, label: str) -> Optional[np.ndarray]:
        return self.lookup_table.vector(label)

    def similarity_to_label(self, text: str, label: str) -> float:
        v = self.infer_vector(text)
        lv = self.get_label_vector(label)
        if lv is None:
            return float("nan")
        v = v / max(np.linalg.norm(v), 1e-12)
        lv = lv / max(np.linalg.norm(lv), 1e-12)
        return float(np.dot(v, lv))

    def infer_vector(self, text: str, iterations: int = 10,
                     learning_rate: Optional[float] = None) -> np.ndarray:
        """Gradient-fit a fresh vector for unseen text against frozen tables
        (reference ``ParagraphVectors.inferVector``)."""
        lr = learning_rate if learning_rate is not None else self.learning_rate
        toks = self.tokenizer_factory.create(text).get_tokens()
        idxs = np.array([i for i in (self.vocab.index_of(t) for t in toks)
                         if i >= 0], dtype=np.int32)
        lt = self.lookup_table
        dev = self.device
        rng = np.random.default_rng(self.seed)
        key = _random.prng_key(abs(hash(text)) % (2 ** 31), dev)
        vec = ((_random.uniform(key, (self.layer_size,)) - 0.5)
               / self.layer_size)
        if idxs.size == 0:
            return vec.cpu().numpy()
        vocab_words = self.vocab.vocab_words()
        code_len = max((vw.code_length for vw in vocab_words), default=1)
        code_len = min(max(code_len, 1), self.max_code_length)
        syn1 = lt.syn1 if lt.syn1 is not None else torch.zeros_like(lt.syn0)
        syn1neg = (lt.syn1neg if lt.syn1neg is not None
                   else torch.zeros_like(lt.syn0))
        B = int(idxs.size)
        _c, pts, cds, cm, neg, nl, nm = _label_arrays(
            idxs, B, B, code_len, self.negative, vocab_words, lt.table, rng)
        pts, neg = (_to_device(a, dev).long() for a in (pts, neg))
        cds, cm, nl, nm = (_to_device(a, dev) for a in (cds, cm, nl, nm))
        vec = vec.to(lt.syn0.dtype)
        for it in range(iterations):
            alpha = max(self.min_learning_rate,
                        lr * (1.0 - it / max(iterations, 1)))
            vec = infer_step(vec, syn1, syn1neg, pts, cds, cm, neg, nl, nm,
                             float(np.float32(alpha)))
        return vec.cpu().numpy()
