"""Graph embeddings: in-memory graph, walk iterators, DeepWalk, Node2Vec
(port of the JAX package's ``graph``; reference ``deeplearning4j-graph``).
Walks are drawn on the host from the same numpy streams as the JAX
package's; the embeddings train on the device through the bulk
hierarchical-softmax skip-gram path of ``nlp``.
"""
from .deepwalk import DeepWalk
from .node2vec import Node2Vec, Node2VecWalkIterator
from .graph import (Edge, Graph, GraphWalkIterator, NoEdgeHandling,
                    NoEdgesException, RandomWalkIterator, Vertex,
                    WeightedRandomWalkIterator, load_edge_list)

__all__ = ["DeepWalk", "Node2Vec", "Node2VecWalkIterator", "Edge", "Graph",
           "GraphWalkIterator", "NoEdgeHandling", "NoEdgesException",
           "RandomWalkIterator", "Vertex", "WeightedRandomWalkIterator",
           "load_edge_list"]
