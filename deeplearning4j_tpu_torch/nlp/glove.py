"""GloVe: global cooccurrence-matrix embeddings (port of ``nlp/glove.py``).

Reference ``models/glove/Glove.java:31`` + cooccurrence counting in
``models/glove/count/`` (RoundCount/CoOccurrenceCounter shard files on disk;
our corpora fit in a host dict).  Training is AdaGrad on the weighted
least-squares objective, run as batches of row updates on the device
(``elements.glove_epoch``) instead of the reference's per-pair
``iterateSample``.  Final vectors are w + w~ (the symmetric-context
convention of the paper).

The tables' ``dtype`` is an argument, float32 by default (the JAX package
takes its dtype from the x64 flag: float32 in production, float64 under
its tests).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .elements import glove_epoch
from .lookup_table import InMemoryLookupTable
from .sentence_iterator import CollectionSentenceIterator, SentenceIterator
from .sequence_vectors import _to_device
from .tokenization import DefaultTokenizerFactory, TokenizerFactory
from .vocab import VocabConstructor
from .word_vectors import WordVectors


class Glove(WordVectors):
    def __init__(self, sentence_iterator: Optional[SentenceIterator] = None,
                 sentences: Optional[Sequence[str]] = None,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 layer_size: int = 100, window: int = 5,
                 learning_rate: float = 0.05, epochs: int = 5,
                 min_word_frequency: int = 1, x_max: float = 100.0,
                 alpha: float = 0.75, symmetric: bool = True,
                 batch_size: int = 1024, seed: int = 123,
                 dtype=torch.float32, device="cuda"):
        if sentence_iterator is None and sentences is not None:
            sentence_iterator = CollectionSentenceIterator(sentences)
        self.sentence_iterator = sentence_iterator
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.layer_size = layer_size
        self.window = window
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.min_word_frequency = min_word_frequency
        self.x_max = x_max
        self.alpha = alpha
        self.symmetric = symmetric
        self.batch_size = batch_size
        self.seed = seed
        self.dtype = dtype
        self.device = resolve_device(device)
        self.vocab = None
        self.lookup_table: Optional[InMemoryLookupTable] = None

    def _sequences(self) -> Iterable[List[str]]:
        for sentence in self.sentence_iterator:
            toks = self.tokenizer_factory.create(sentence).get_tokens()
            if toks:
                yield toks

    def count_cooccurrences(self) -> Dict[Tuple[int, int], float]:
        """Distance-weighted window counts (1/d), symmetric if configured —
        reference ``models/glove/count/`` pipeline."""
        counts: Dict[Tuple[int, int], float] = {}
        for toks in self._sequences():
            idxs = [self.vocab.index_of(t) for t in toks]
            for i, wi in enumerate(idxs):
                if wi < 0:
                    continue
                for j in range(max(0, i - self.window), i):
                    wj = idxs[j]
                    if wj < 0:
                        continue
                    inc = 1.0 / (i - j)
                    counts[(wi, wj)] = counts.get((wi, wj), 0.0) + inc
                    if self.symmetric:
                        counts[(wj, wi)] = counts.get((wj, wi), 0.0) + inc
        return counts

    def fit(self) -> None:
        ctor = VocabConstructor(self.min_word_frequency)
        self.vocab = ctor.build(self._sequences())
        n, d = self.vocab.num_words(), self.layer_size
        self.lookup_table = InMemoryLookupTable(
            self.vocab, d, seed=self.seed, use_hs=False, negative=0,
            dtype=self.dtype, device=self.device)
        cooc = self.count_cooccurrences()
        if not cooc:
            self.lookup_table.reset_weights()
            return
        rows = np.array([k[0] for k in cooc], dtype=np.int32)
        cols = np.array([k[1] for k in cooc], dtype=np.int32)
        xij = np.array(list(cooc.values()), dtype=np.float32)
        rng = np.random.default_rng(self.seed)
        dev, dt = self.device, self.dtype
        w = torch.as_tensor((rng.random((n, d)) - 0.5) / d).to(dev, dt)
        wc = torch.as_tensor((rng.random((n, d)) - 0.5) / d).to(dev, dt)
        b, bc, hb, hbc = (torch.zeros(n, dtype=dt, device=dev)
                          for _ in range(4))
        hw, hwc = (torch.zeros((n, d), dtype=dt, device=dev)
                   for _ in range(2))
        B = self.batch_size
        n_pairs = len(xij)
        # up to `chunk` batches per call, the JAX package's blocks: device
        # memory for the index arrays stays bounded (~chunk*B*12 bytes) and
        # every call has the same (chunk, B) shape via padding
        chunk = min(256, max(1, -(-n_pairs // B)))
        stride = B * chunk
        pad = (-n_pairs) % stride
        # the hyperparameters as f32 values, as the JAX package passes them
        lr_s = float(np.float32(self.learning_rate))
        xmax_s = float(np.float32(self.x_max))
        alpha_s = float(np.float32(self.alpha))
        for _epoch in range(self.epochs):
            order = rng.permutation(n_pairs)
            pr = np.concatenate([rows[order], np.zeros(pad, np.int32)])
            pc = np.concatenate([cols[order], np.zeros(pad, np.int32)])
            # padded entries carry xij≈0 → weight (x/xmax)^α ≈ 0 → no gradient
            px = np.concatenate([xij[order], np.full(pad, 1e-8, np.float32)])
            for s in range(0, n_pairs + pad, stride):
                rb, cb = (_to_device(a[s:s + stride].reshape(chunk, B),
                                     dev).long() for a in (pr, pc))
                xb = _to_device(px[s:s + stride].reshape(chunk, B), dev)
                w, wc, b, bc, hw, hwc, hb, hbc, _losses = glove_epoch(
                    w, wc, b, bc, hw, hwc, hb, hbc, rb, cb, xb,
                    lr_s, xmax_s, alpha_s)
        self.lookup_table.syn0 = w + wc
