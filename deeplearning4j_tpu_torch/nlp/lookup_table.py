"""In-memory embedding lookup table (port of ``nlp/lookup_table.py``).

Reference ``models/embeddings/inmemory/InMemoryLookupTable.java:56``:
holds ``syn0`` (word vectors), ``syn1`` (hierarchical-softmax
internal-node weights), ``syn1neg`` (negative-sampling output weights),
the exp table and the unigram table.  Here the tables are tensors on the
table's device; the exp table is unnecessary (the device computes the
sigmoid) and the unigram table stays a host numpy array, shipped to the
device by the trainer that samples from it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import _random
from ..utils.device import resolve_device
from .vocab import VocabCache, make_unigram_table


class InMemoryLookupTable:
    def __init__(self, vocab: VocabCache, vector_length: int,
                 seed: int = 123, use_hs: bool = True, negative: float = 0.0,
                 dtype=torch.float32, device="cuda"):
        self.vocab = vocab
        self.vector_length = vector_length
        self.seed = seed
        self.use_hs = use_hs
        self.negative = negative
        self.dtype = dtype
        self.device = resolve_device(device)
        self.syn0: Optional[torch.Tensor] = None
        self.syn1: Optional[torch.Tensor] = None
        self.syn1neg: Optional[torch.Tensor] = None
        self.table: Optional[np.ndarray] = None

    def reset_weights(self) -> None:
        """syn0 ~ U(-0.5, 0.5)/dim, syn1* zero: the word2vec init
        (``InMemoryLookupTable.resetWeights``), from the threefry stream of
        ``seed`` in f32, bit for bit with the JAX package."""
        n, d = self.vocab.num_words(), self.vector_length
        u = _random.uniform(_random.prng_key(self.seed, self.device), (n, d))
        self.syn0 = ((u - 0.5) / d).to(self.dtype)
        if self.use_hs:
            self.syn1 = torch.zeros((n, d), dtype=self.dtype,
                                    device=self.device)
        if self.negative > 0:
            self.init_negative()

    def init_negative(self) -> None:
        n, d = self.vocab.num_words(), self.vector_length
        self.syn1neg = torch.zeros((n, d), dtype=self.dtype,
                                   device=self.device)
        self.table = make_unigram_table(self.vocab)

    # -- queries -------------------------------------------------------------
    def vector(self, word: str) -> Optional[np.ndarray]:
        idx = self.vocab.index_of(word)
        if idx < 0 or self.syn0 is None:
            return None
        return self.syn0[idx].cpu().numpy()

    def get_weights(self) -> np.ndarray:
        return self.syn0.cpu().numpy()

    def set_weights(self, w) -> None:
        self.syn0 = torch.as_tensor(np.asarray(w), dtype=self.dtype,
                                    device=self.device)
