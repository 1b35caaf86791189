"""In-memory graph structure + walk iterators (port of ``graph/graph.py``).

Reference ``deeplearning4j-graph``: ``graph/api/{IGraph,Vertex,Edge,
NoEdgeHandling}.java``, ``graph/graph/Graph.java`` (adjacency-list graph),
``graph/iterator/{RandomWalkIterator,WeightedRandomWalkIterator}.java``, and
the edge-list loaders in ``graph/data/impl/``.

Walk generation is host-side (it feeds the vocab/batcher pipeline); the
device only sees the resulting index batches via DeepWalk's skip-gram.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Generic, Iterator, List, Optional, Sequence, TypeVar

import numpy as np

T = TypeVar("T")


class NoEdgesException(Exception):
    """Walk hit a vertex with no outgoing edges under EXCEPTION handling
    (reference ``graph/exception/NoEdgesException.java``)."""


@dataclass
class Vertex(Generic[T]):
    """Reference ``graph/api/Vertex.java``: index + attached value."""
    idx: int
    value: Optional[T] = None


@dataclass
class Edge(Generic[T]):
    """Reference ``graph/api/Edge.java``."""
    frm: int
    to: int
    value: Optional[T] = None
    directed: bool = False

    @property
    def weight(self) -> float:
        return 1.0 if self.value is None else float(self.value)


class NoEdgeHandling:
    """Reference ``graph/api/NoEdgeHandling.java``."""
    SELF_LOOP_ON_DISCONNECTED = "self_loop"
    EXCEPTION_ON_DISCONNECTED = "exception"


class Graph(Generic[T]):
    """Adjacency-list graph (reference ``graph/graph/Graph.java``)."""

    def __init__(self, n_vertices: int = 0,
                 allow_multiple_edges: bool = True,
                 vertices: Optional[Sequence[Vertex]] = None):
        if vertices is not None:
            self._vertices = list(vertices)
        else:
            self._vertices = [Vertex(i) for i in range(n_vertices)]
        self.allow_multiple_edges = allow_multiple_edges
        self._edges: List[List[Edge]] = [[] for _ in self._vertices]

    # -- construction --------------------------------------------------------
    def add_vertex(self, value: Optional[T] = None) -> Vertex:
        v = Vertex(len(self._vertices), value)
        self._vertices.append(v)
        self._edges.append([])
        return v

    def add_edge(self, frm: int, to: int, value=None,
                 directed: bool = False) -> None:
        e = Edge(frm, to, value, directed)
        if not self.allow_multiple_edges and any(
                x.to == to for x in self._edges[frm]):
            return
        self._edges[frm].append(e)
        if not directed and frm != to:
            self._edges[to].append(Edge(to, frm, value, directed))

    # -- queries -------------------------------------------------------------
    def num_vertices(self) -> int:
        return len(self._vertices)

    def get_vertex(self, idx: int) -> Vertex:
        return self._vertices[idx]

    def get_edges_out(self, idx: int) -> List[Edge]:
        return list(self._edges[idx])

    def get_vertex_degree(self, idx: int) -> int:
        return len(self._edges[idx])

    def get_connected_vertex_indices(self, idx: int) -> List[int]:
        return [e.to for e in self._edges[idx]]

    def get_random_connected_vertex(self, idx: int, rng) -> int:
        edges = self._edges[idx]
        if not edges:
            raise NoEdgesException(f"vertex {idx} has no outgoing edges")
        return edges[int(rng.integers(0, len(edges)))].to

    def degrees(self) -> np.ndarray:
        return np.array([len(e) for e in self._edges], dtype=np.int64)


# ---------------------------------------------------------------------------
# walk iterators
# ---------------------------------------------------------------------------

class GraphWalkIterator:
    """Stream of vertex-index walks (reference ``GraphWalkIterator.java``).
    Restartable: each ``__iter__`` regenerates walks with a fresh sub-seed."""

    def __init__(self, graph: Graph, walk_length: int,
                 no_edge_handling: str = NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED,
                 seed: int = 123):
        self.graph = graph
        self.walk_length = walk_length
        self.no_edge_handling = no_edge_handling
        self.seed = seed
        self._epoch = 0

    def _next_vertex(self, cur: int, rng) -> int:
        raise NotImplementedError

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng((self.seed, self._epoch))
        self._epoch += 1
        order = rng.permutation(self.graph.num_vertices())
        for start in order:
            walk = [int(start)]
            cur = int(start)
            for _ in range(self.walk_length):
                if self.graph.get_vertex_degree(cur) == 0:
                    if self.no_edge_handling == \
                            NoEdgeHandling.EXCEPTION_ON_DISCONNECTED:
                        raise NoEdgesException(
                            f"vertex {cur} has no edges mid-walk")
                    walk.append(cur)  # self loop
                    continue
                cur = self._next_vertex(cur, rng)
                walk.append(cur)
            yield walk


class RandomWalkIterator(GraphWalkIterator):
    """Uniform random walks (reference ``RandomWalkIterator.java``)."""

    def _next_vertex(self, cur: int, rng) -> int:
        return self.graph.get_random_connected_vertex(cur, rng)


class WeightedRandomWalkIterator(GraphWalkIterator):
    """Edge-weight-proportional walks (``WeightedRandomWalkIterator.java``)."""

    def _next_vertex(self, cur: int, rng) -> int:
        edges = self.graph.get_edges_out(cur)
        weights = np.array([e.weight for e in edges], dtype=np.float64)
        if (weights < 0).any():
            raise ValueError(
                f"vertex {cur} has negative edge weights; weighted walks "
                "need non-negative weights")
        s = weights.sum()
        if s <= 0:
            return edges[int(rng.integers(0, len(edges)))].to
        return edges[int(rng.choice(len(edges), p=weights / s))].to


# ---------------------------------------------------------------------------
# loaders (reference graph/data/impl/)
# ---------------------------------------------------------------------------

def load_edge_list(path: str, n_vertices: Optional[int] = None,
                   delimiter: str = ",", directed: bool = False,
                   weighted: bool = False) -> Graph:
    """Edge-list file → Graph (reference ``DelimitedEdgeLineProcessor`` /
    ``WeightedEdgeLineProcessor`` + ``GraphLoader``).  Lines starting with
    ``//`` or ``#`` are comments."""
    edges = []
    max_idx = -1
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("//", "#")):
                continue
            parts = [p.strip() for p in line.split(delimiter)]
            frm, to = int(parts[0]), int(parts[1])
            w = float(parts[2]) if weighted and len(parts) > 2 else None
            edges.append((frm, to, w))
            max_idx = max(max_idx, frm, to)
    g = Graph(n_vertices if n_vertices is not None else max_idx + 1)
    for frm, to, w in edges:
        g.add_edge(frm, to, w, directed=directed)
    return g
