"""The port's graph embeddings (``graph/graph``, ``deepwalk``,
``node2vec``) against the JAX package's, on graphs made with numpy from
seeds, on the CPU.

Walks are drawn on the host from ``default_rng((seed, epoch))`` in both
packages: bitwise equal.  DeepWalk and Node2Vec train their degree-Huffman
tables through the bulk hierarchical-softmax skip-gram path on both sides
(JAX with x64 off), the same rows in the same order with f32 dot products
and duplicate sums in other orders: tables within 2e-6 (measured ~4e-9 on
entries ~0.1).  The bulk blocks are shrunk to 2**11 rows in both
packages, as in ``test_torch_word2vec.py``.
"""
import jax
import numpy as np
import pytest

import deeplearning4j_tpu.graph as jg
import deeplearning4j_tpu_torch.graph as tg
from deeplearning4j_tpu.nlp import sequence_vectors as jsv
from deeplearning4j_tpu_torch.nlp import sequence_vectors as tsv

TOL_FIT = 2e-6


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    for cls in (jsv.SequenceVectors, tsv.SequenceVectors):
        monkeypatch.setattr(cls, "_BULK_PAIRS_PER_DISPATCH", 1 << 11)


def _graph(pkg, n=30, m=80, seed=1, weighted=False, isolated=True):
    g = pkg.Graph(n)
    rng = np.random.default_rng(seed)
    for _ in range(m):
        a, b = (int(x) for x in rng.integers(0, n - 1 if isolated else n, 2))
        g.add_edge(a, b, float(rng.integers(1, 5)) if weighted else None)
    return g


def test_graph_structure_is_equal():
    gt, gj = _graph(tg), _graph(jg)
    assert (gt.degrees() == gj.degrees()).all()
    for v in range(gt.num_vertices()):
        assert gt.get_connected_vertex_indices(v) == \
            gj.get_connected_vertex_indices(v)
    one_t, one_j = tg.Graph(3, allow_multiple_edges=False), \
        jg.Graph(3, allow_multiple_edges=False)
    for g in (one_t, one_j):
        g.add_edge(0, 1)
        g.add_edge(0, 1)
        g.add_edge(1, 2, directed=True)
    assert (one_t.degrees() == one_j.degrees()).all()


@pytest.mark.parametrize("kind", ["random", "weighted", "node2vec"])
def test_walks_are_bitwise_equal(kind):
    gt = _graph(tg, weighted=kind != "random")
    gj = _graph(jg, weighted=kind != "random")
    make = {"random": lambda p, g: p.RandomWalkIterator(g, 12, seed=4),
            "weighted": lambda p, g: p.WeightedRandomWalkIterator(g, 12,
                                                                  seed=4),
            "node2vec": lambda p, g: p.Node2VecWalkIterator(
                g, 12, p=0.5, q=2.0, seed=4)}[kind]
    it_t, it_j = make(tg, gt), make(jg, gj)
    for _epoch in range(2):          # each pass draws from (seed, epoch)
        assert list(it_t) == list(it_j)


def test_disconnected_vertex_handling_is_equal():
    gt, gj = _graph(tg), _graph(jg)       # vertex 29 has no edge
    for p, g in ((tg, gt), (jg, gj)):
        it = p.RandomWalkIterator(
            g, 5, no_edge_handling=p.NoEdgeHandling.EXCEPTION_ON_DISCONNECTED)
        with pytest.raises(p.NoEdgesException):
            list(it)
    walks = [list(p.RandomWalkIterator(g, 5, seed=2)) for p, g in
             ((tg, gt), (jg, gj))]
    assert walks[0] == walks[1]
    assert [29] * 6 in walks[0]
    with pytest.raises(ValueError):
        tg.Node2Vec(p=0, device="cpu").fit(gt)


def test_edge_list_loader(tmp_path):
    path = tmp_path / "edges.csv"
    path.write_text("# a comment\n0,1,2.5\n1,2,1\n// another\n3,0,4\n")
    for weighted in (False, True):
        gt = tg.load_edge_list(str(path), weighted=weighted)
        gj = jg.load_edge_list(str(path), weighted=weighted)
        assert [[(e.to, e.weight) for e in gt.get_edges_out(v)]
                for v in range(gt.num_vertices())] == \
            [[(e.to, e.weight) for e in gj.get_edges_out(v)]
             for v in range(gj.num_vertices())]


@pytest.mark.parametrize("model", ["DeepWalk", "Node2Vec"])
def test_graph_embeddings_match_jax(model):
    kw = dict(vector_size=8, window_size=3, seed=5, epochs=2)
    if model == "Node2Vec":
        kw.update(p=0.5, q=2.0)
    with jax.enable_x64(False):
        j = getattr(jg, model)(**kw)
        j.fit(_graph(jg, isolated=False), walk_length=10)
        want = np.asarray(j.lookup_table.syn0)
        want_hs = np.asarray(j.lookup_table.syn1)
    t = getattr(tg, model)(device="cpu", **kw)
    t.fit(_graph(tg, isolated=False), walk_length=10)
    assert [vw.codes for vw in t.vocab.vocab_words()] == \
        [vw.codes for vw in j.vocab.vocab_words()]
    np.testing.assert_allclose(t.lookup_table.syn0.numpy(), want, rtol=0,
                               atol=TOL_FIT)
    np.testing.assert_allclose(t.lookup_table.syn1.numpy(), want_hs, rtol=0,
                               atol=TOL_FIT)
    np.testing.assert_allclose(t.get_vertex_vector(3), j.get_vertex_vector(3),
                               atol=TOL_FIT)
    assert t.vertices_nearest(3, 4) == j.vertices_nearest(3, 4)
    assert abs(t.similarity_vertices(1, 2) - j.similarity_vertices(1, 2)) \
        < 1e-5
    assert t.num_vertices() == j.num_vertices() == 30
