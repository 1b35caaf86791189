"""DeepWalk: skip-gram embeddings over random graph walks (port of
``graph/deepwalk.py``).

Reference ``graph/models/deepwalk/DeepWalk.java:31`` (fit :95-152) +
``GraphHuffman.java`` (Huffman over vertex degrees) + ``GraphVectors`` query
API (``models/embeddings/GraphVectorsImpl.java``).  Rides the NLP
SequenceVectors engine: walks become token sequences, the Huffman tree is
built from vertex degrees (not corpus counts), and training is the bulk
hierarchical-softmax skip-gram path on the device.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..nlp.lookup_table import InMemoryLookupTable
from ..nlp.sequence_vectors import SequenceVectors
from ..nlp.vocab import VocabCache, VocabWord, build_huffman
from .graph import Graph, GraphWalkIterator, RandomWalkIterator


class DeepWalk(SequenceVectors):
    """GraphVectors trainer (reference ``DeepWalk.java``).

    ``initialize(graph)`` builds the degree-based Huffman vocab;
    ``fit(walk_iterator)`` trains on one pass of walks (call repeatedly or
    pass ``epochs>1`` for more).
    """

    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 learning_rate: float = 0.025, seed: int = 123,
                 batch_size: int = 512, epochs: int = 1, device="cuda"):
        super().__init__(layer_size=vector_size, window=window_size,
                         learning_rate=learning_rate, negative=0,
                         use_hierarchic_softmax=True, epochs=epochs,
                         batch_size=batch_size, seed=seed, device=device)
        self.graph: Optional[Graph] = None
        self._walks: Optional[GraphWalkIterator] = None

    @property
    def vector_size(self) -> int:
        return self.layer_size

    # -- setup ---------------------------------------------------------------
    def initialize(self, graph: Graph) -> None:
        """Degree-based vocab + Huffman (reference ``GraphHuffman``: codes
        weighted by vertex degree so hub vertices get short paths)."""
        self.graph = graph
        degrees = graph.degrees()
        cache = VocabCache()
        # vertex i <-> token str(i); index order preserved (no frequency sort
        # — GraphVectors queries are by vertex index)
        for i in range(graph.num_vertices()):
            cache.add_token(VocabWord(str(i), count=max(int(degrees[i]), 1)))
        cache.total_word_count = int(np.maximum(degrees, 1).sum())
        build_huffman(cache.vocab_words())
        self.vocab = cache
        self.lookup_table = InMemoryLookupTable(
            cache, self.layer_size, seed=self.seed, use_hs=True, negative=0,
            device=self.device)
        self.lookup_table.reset_weights()

    # -- training ------------------------------------------------------------
    def _sequences(self):
        for walk in self._walks:
            yield [str(v) for v in walk]

    def fit(self, walks=None, walk_length: int = 40) -> None:
        """Train on a walk iterator; a bare Graph gets a default
        RandomWalkIterator (reference ``fit(IGraph, int)`` overload)."""
        if isinstance(walks, Graph):
            if self.graph is None:
                self.initialize(walks)
            walks = RandomWalkIterator(walks, walk_length, seed=self.seed)
        if walks is not None:
            self._walks = walks
        if self.vocab is None:
            raise ValueError("call initialize(graph) before fit()")
        if self._walks is None:
            raise ValueError("no walk iterator provided")
        super().fit()

    # -- GraphVectors query API ----------------------------------------------
    def get_vertex_vector(self, idx: int) -> np.ndarray:
        return self.lookup_table.syn0[idx].cpu().numpy()

    def similarity_vertices(self, a: int, b: int) -> float:
        return self.similarity(str(a), str(b))

    def vertices_nearest(self, idx: int, top_n: int = 10) -> List[int]:
        return [int(w) for w in self.words_nearest(str(idx), top_n=top_n)]

    def num_vertices(self) -> int:
        return self.vocab.num_words()
