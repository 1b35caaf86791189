"""The port's nearest-neighbour indexes and server against the JAX
package's: ``BruteForceNN`` (the distance product and ``topk`` in torch),
``VPTree`` and ``KDTree`` give the JAX indexes' neighbours (indices exact,
distances within 1e-5: float32 distances from the same expansion in
another summation order) for every metric the brute index takes; the
``/knn`` and ``/knnindex`` routes over both index kinds, ``/health`` with
the JAX server's keys, ``/metrics``, and bad requests as 400s.  Every wait
has its own timeout of at most 30 s."""
import urllib.error

import numpy as np
import pytest

from deeplearning4j_tpu.clustering import neighbors as jnb
from deeplearning4j_tpu.serving import nn_server as jnn
from deeplearning4j_tpu_torch.clustering import neighbors as tnb
from deeplearning4j_tpu_torch.observability import MetricsRegistry
from deeplearning4j_tpu_torch.serving import nn_server as tnn

WAIT_S = 30.0
TOL = 1e-5


def _points(seed, n=200, d=8):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "manhattan",
                                    "dot"])
def test_brute_force_matches_the_jax_index(metric):
    pts, qs = _points(0), _points(1, n=16)
    d, i = tnb.BruteForceNN(pts, metric=metric, device="cpu").query(qs, k=7)
    jd, ji = jnb.BruteForceNN(pts, metric=metric).query(qs, k=7)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(d, jd, rtol=0, atol=TOL)
    # k is clamped to the number of points
    d, i = tnb.BruteForceNN(pts[:5], device="cpu").query(qs[0], k=9)
    assert i.shape == (1, 5) and sorted(i[0]) == list(range(5))


def test_pairwise_distance_matches_the_jax_function():
    import torch
    a, b = _points(2, n=6), _points(3, n=9)
    for metric in ("euclidean", "cosine", "manhattan", "dot"):
        mine = tnb.pairwise_distance(torch.as_tensor(a), torch.as_tensor(b),
                                     metric).numpy()
        np.testing.assert_allclose(
            mine, np.asarray(jnb.pairwise_distance(a, b, metric)), rtol=0,
            atol=TOL)
    with pytest.raises(ValueError, match="unknown metric"):
        tnb.pairwise_distance(torch.as_tensor(a), torch.as_tensor(b), "l7")


@pytest.mark.parametrize("tree", ["VPTree", "KDTree"])
def test_trees_match_the_jax_trees(tree):
    pts = _points(4, n=120, d=3)
    mine, ref = getattr(tnb, tree)(pts), getattr(jnb, tree)(pts)
    brute = tnb.BruteForceNN(pts, device="cpu")
    for q in _points(5, n=10, d=3):
        d, i = mine.query(q, k=5)
        jd, ji = ref.query(q, k=5)
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_allclose(d, jd, rtol=0, atol=TOL)
        _, bi = brute.query(q, k=5)
        np.testing.assert_array_equal(i, bi[0])


@pytest.mark.parametrize("index", ["brute", "vptree"])
def test_knn_routes_match_the_jax_server(index):
    pts = _points(3, n=50, d=4)
    reg = MetricsRegistry()
    tsrv = tnn.NearestNeighborsServer(pts, index=index, device="cpu",
                                      registry=reg).start()
    jsrv = jnn.NearestNeighborsServer(pts, index=index).start()
    try:
        tc = tnn.NearestNeighborsClient(f"http://127.0.0.1:{tsrv.port}",
                                        timeout=WAIT_S)
        jc = jnn.NearestNeighborsClient(f"http://127.0.0.1:{jsrv.port}",
                                        timeout=WAIT_S)
        for q in (pts[7], _points(8, n=1, d=4)[0]):
            mine, ref = tc.knn(q, k=3), jc.knn(q, k=3)
            assert [r["index"] for r in mine] == [r["index"] for r in ref]
            np.testing.assert_allclose([r["distance"] for r in mine],
                                       [r["distance"] for r in ref],
                                       rtol=0, atol=TOL)
        res = tc.knn(pts[7], k=3)
        assert res[0]["index"] == 7 and res[0]["distance"] < 1e-3
        by_index = tc.knn_by_index(7, k=3)
        assert [r["index"] for r in by_index] == [
            r["index"] for r in jc.knn_by_index(7, k=3)]
        assert all(r["index"] != 7 for r in by_index)
        h, jh = tc.get("/health"), jc.get("/health")
        assert set(h) == set(jh)
        assert h["model"] == jh["model"] == f"knn[{index},n=50,d=4]"
        assert h["platform"] == "cpu"
        assert h["seconds_since_last_query"] >= 0
        text = tc.get_text("/metrics")
        assert 'http_request_seconds_bucket{route="/knn",le="+Inf"} 3' \
            in text
    finally:
        tsrv.stop()
        jsrv.stop()


def test_bad_requests_are_client_errors():
    server = tnn.NearestNeighborsServer(np.zeros((5, 2), np.float32),
                                        device="cpu",
                                        registry=MetricsRegistry()).start()
    try:
        client = tnn.NearestNeighborsClient(
            f"http://127.0.0.1:{server.port}", timeout=WAIT_S)
        for route, body in (("/knnindex", {"index": 99, "k": 1}),
                            ("/knn", {"k": 1}),
                            ("/knn", {"ndarray": [[1.0], [2.0, 3.0]]}),
                            ("/knn", {"ndarray": [1.0, 2.0], "k": "x"})):
            with pytest.raises(urllib.error.HTTPError) as ei:
                client.post(route, body)
            assert ei.value.code == 400, (route, body)
        with pytest.raises(urllib.error.HTTPError) as ei:
            client.post("/elsewhere", {})
        assert ei.value.code == 404
        assert client.get("/health")["seconds_since_last_query"] is None
    finally:
        server.stop()
    with pytest.raises(ValueError, match="unknown index"):
        tnn.NearestNeighborsServer(np.zeros((2, 2)), index="ball",
                                   device="cpu")
