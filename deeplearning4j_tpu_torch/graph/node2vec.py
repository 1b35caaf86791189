"""Node2Vec: biased second-order random walks + skip-gram embeddings (port
of ``graph/node2vec.py``).

Reference ``deeplearning4j-nlp-parent/.../models/node2vec/`` (Node2Vec atop
the SequenceVectors engine).  The walk bias follows the node2vec paper
(Grover & Leskovec 2016): from edge (t -> v), the unnormalized probability
of stepping to x is

    w(v,x)/p  if x == t            (return)
    w(v,x)    if x adjacent to t   (BFS-ish)
    w(v,x)/q  otherwise            (DFS-ish)

Walk generation is host-side (feeds the vocab/batcher pipeline); training
is DeepWalk's hierarchical-softmax skip-gram path on the device.
"""
from __future__ import annotations

from typing import Iterator, List

import numpy as np

from .deepwalk import DeepWalk
from .graph import Graph, GraphWalkIterator, NoEdgeHandling, NoEdgesException

__all__ = ["Node2Vec", "Node2VecWalkIterator"]


class Node2VecWalkIterator(GraphWalkIterator):
    """Second-order biased walks (p = return parameter, q = in-out
    parameter; p = q = 1 degenerates to RandomWalkIterator)."""

    def __init__(self, graph: Graph, walk_length: int, p: float = 1.0,
                 q: float = 1.0,
                 no_edge_handling: str = NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED,
                 seed: int = 123):
        super().__init__(graph, walk_length, no_edge_handling, seed)
        if p <= 0 or q <= 0:
            raise ValueError(f"p and q must be positive, got p={p} q={q}")
        self.p = float(p)
        self.q = float(q)
        # each vertex's out-edges as arrays (targets, weights), and a
        # scratch mask for the "is x adjacent to t" test: a step is a few
        # numpy calls, not a Python loop over a hub's edges.  The weights
        # are the same float64 values in the same order as the JAX
        # package's loop builds them, so the draws (and walks) are equal.
        n = graph.num_vertices()
        self._to = [np.array([e.to for e in graph.get_edges_out(i)],
                             np.int64) for i in range(n)]
        self._wt = [np.array([e.weight for e in graph.get_edges_out(i)],
                             np.float64) for i in range(n)]
        self._adj = np.zeros(n, bool)

    def _step(self, prev: int, cur: int, rng) -> int:
        to, wt = self._to[cur], self._wt[cur]
        if len(to) == 1:
            return int(to[0])
        self._adj[self._to[prev]] = True
        w = np.where(to == prev, wt / self.p,
                     np.where(self._adj[to], wt, wt / self.q))
        self._adj[self._to[prev]] = False
        s = w.sum()
        if s <= 0:
            return int(to[int(rng.integers(0, len(to)))])
        return int(to[int(rng.choice(len(to), p=w / s))])

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng((self.seed, self._epoch))
        self._epoch += 1
        g = self.graph
        for start in rng.permutation(g.num_vertices()):
            cur = int(start)
            walk = [cur]
            prev = -1
            for _ in range(self.walk_length):
                deg = g.get_vertex_degree(cur)
                if deg == 0:
                    if self.no_edge_handling == \
                            NoEdgeHandling.EXCEPTION_ON_DISCONNECTED:
                        raise NoEdgesException(
                            f"vertex {cur} has no edges mid-walk")
                    walk.append(cur)
                    continue
                if prev < 0:  # first step: uniform/weight-proportional
                    nxt = g.get_random_connected_vertex(cur, rng)
                else:
                    nxt = self._step(prev, cur, rng)
                prev, cur = cur, int(nxt)
                walk.append(cur)
            yield walk


class Node2Vec(DeepWalk):
    """Node2Vec trainer: DeepWalk with p/q-biased walk generation
    (reference ``models/node2vec/Node2Vec.java``)."""

    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 p: float = 1.0, q: float = 1.0,
                 learning_rate: float = 0.025, seed: int = 123,
                 batch_size: int = 512, epochs: int = 1, device="cuda"):
        super().__init__(vector_size=vector_size, window_size=window_size,
                         learning_rate=learning_rate, seed=seed,
                         batch_size=batch_size, epochs=epochs, device=device)
        self.p = p
        self.q = q

    def fit(self, walks=None, walk_length: int = 40) -> None:
        if isinstance(walks, Graph):
            if self.graph is None:
                self.initialize(walks)
            walks = Node2VecWalkIterator(walks, walk_length, p=self.p,
                                         q=self.q, seed=self.seed)
        super().fit(walks, walk_length)
