"""The port's clustering (``clustering/kmeans``, ``algorithm``,
``sptree``, ``tsne``) and ``ml.py``'s estimators against the JAX
package's, on points made with numpy from seeds, on the CPU.

Tolerances:

* KMeans and the strategy framework: centers are means of f32 points
  summed in another order (one-hot matrix products in XLA and in torch):
  1e-5 of the largest |center|; an assignment may differ only where the
  point's two distances are within 1e-4 (checked by value, in f64); the
  argmin takes the first index on exact ties, as ``jnp.argmin``.
  A cluster's mean distance is a one-hot matrix product, which the XLA
  CPU backend sums to ~1e-5 relative (3e-5 from the f64 sum of 80
  distances where torch's is 1e-6), and the refreshed centers carry
  that on: 1e-3 relative, for the set-level distance variance too.
* ``SPTree`` is the same numpy on both sides: equal.
* Exact t-SNE: P (the bisection, softmax and entropy in f32) within 1e-5
  of its largest entry.  The initial embedding is the threefry normal,
  equal to JAX's within f32 rounding of ``erfinv``; the gains update
  branches on the sign of grad vs vel, so an element whose gradient is
  within rounding of 0 may take the other branch (a gain of 0.8x instead
  of +0.2) and move by lr x gain x |grad| with |grad| at the rounding
  level: the embedding within 1e-4 of its largest |y| after 30
  iterations, KL within 1e-4 relative.
* Barnes-Hut: the kNN on the device and P calibrated in f32 as the JAX
  package's, the iterations the same float64 numpy: 1e-6 of the largest
  |y|.
* Estimators: ``fit`` of the same f32 network from the same params, the
  products summed in another order: probabilities within 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.clustering import algorithm as ja
from deeplearning4j_tpu.clustering import kmeans as jk
from deeplearning4j_tpu.clustering import sptree as js
from deeplearning4j_tpu.clustering import tsne as jt
from deeplearning4j_tpu import ml as jml
from deeplearning4j_tpu.nn import multilayer as jmln
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import pretrain as jpre
import deeplearning4j_tpu_torch.clustering as tclust
from deeplearning4j_tpu_torch import ml as tml
from deeplearning4j_tpu_torch.clustering import algorithm as ta
from deeplearning4j_tpu_torch.clustering import kmeans as tk
from deeplearning4j_tpu_torch.clustering import sptree as ts
from deeplearning4j_tpu_torch.clustering import tsne as tt
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

TOL_CENTERS, TOL_TIE, TOL_AVG_DISTANCE = 1e-5, 1e-4, 1e-3
TOL_P, TOL_Y, TOL_KL = 1e-5, 1e-4, 1e-4
TOL_BH = 1e-6
TOL_EST = 2e-5


def _blobs(n=300, d=5, k=4, seed=0, wide=False):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * 4
    which = rng.integers(0, k, n)
    width = np.where(which < k // 2, 1.0, 2.0)[:, None] if wide else 1.0
    return (centers[which] + width * rng.standard_normal((n, d))).astype(
        np.float32)


def _same_clusters(pts, got, want):
    """Centers within TOL_CENTERS, assignments equal outside ties."""
    assert got.centers.shape == want.centers.shape
    scale = np.abs(want.centers).max()
    np.testing.assert_allclose(got.centers, want.centers, rtol=0,
                               atol=TOL_CENTERS * scale)
    a, b = np.asarray(got.assignments), np.asarray(want.assignments)
    diff = np.flatnonzero(a != b)
    c = np.asarray(want.centers, np.float64)
    p = pts[diff].astype(np.float64)
    gap = np.abs(np.linalg.norm(p - c[a[diff]], axis=1)
                 - np.linalg.norm(p - c[b[diff]], axis=1))
    assert (gap <= TOL_TIE).all(), gap
    assert got.iterations == want.iterations
    assert got.cost == pytest.approx(want.cost, rel=TOL_CENTERS)


def test_assignment_ties_take_the_first_index():
    pts = np.array([[0.0, 0.0], [2.0, 0.0], [1.0, 3.0]], np.float32)
    centers = np.array([[1.0, 0.0], [-1.0, 0.0], [1.0, 0.0]], np.float32)
    jd, ja_, _, jc, jnew = jk._assign_refresh(jnp.asarray(pts),
                                              jnp.asarray(centers),
                                              "euclidean")
    td_, ta_, _, tc, tnew = tk._assign_refresh(torch.as_tensor(pts),
                                               torch.as_tensor(centers),
                                               "euclidean")
    # point 0 ties centers 0 and 1, point 1 ties 0 and 2: first index
    assert np.asarray(ja_).tolist() == ta_.tolist() == [0, 0, 0]
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tnew.numpy(), np.asarray(jnew))


@pytest.mark.parametrize("kw", [dict(), dict(tol=0.0, max_iterations=8),
                                dict(tol=0.0, init="random", seed=3,
                                     metric="cosine")],
                         ids=["default", "tol0", "random-cosine"])
def test_kmeans_matches_jax(kw):
    pts = _blobs()
    got = tk.KMeans(4, device="cpu", **kw).fit(pts)
    want = jk.KMeans(4, **kw).fit(pts)
    _same_clusters(pts, got, want)
    np.testing.assert_array_equal(
        tk.ClusterSet(got.centers, got.assignments, got.cost, 1)
        .nearest_cluster(pts[:20], device="cpu"),
        want.nearest_cluster(pts[:20]))


def _jax_lloyd(pts, centers, iters):
    """The JAX package's ``KMeans.fit`` loop over its jitted
    ``_lloyd_step`` (tol 0), with the reseed written into a writable copy:
    its own ``fit`` writes into ``np.asarray`` of a device array, which is
    read-only, and raises at the first empty cluster."""
    c = jnp.asarray(centers)
    prev = np.inf
    for it in range(1, iters + 1):
        c, assign, counts, cost, far = jk._lloyd_step(jnp.asarray(pts), c,
                                                      "euclidean")
        counts = np.asarray(counts)
        if (counts == 0).any():
            host = np.array(c)
            host[np.flatnonzero(counts == 0)[0]] = pts[int(far)]
            c = jnp.asarray(host)
            continue
        cost = float(cost)
        if abs(prev - cost) <= 0.0:
            prev = cost
            break
        prev = cost
    return np.asarray(c), np.asarray(assign), prev, it


def test_kmeans_reseeds_an_empty_cluster():
    # 20 points on 4 sites; the random init picks two rows of one site,
    # so a cluster is empty after the first step and is reseeded
    pts = np.repeat(_blobs(4, 3, 4, seed=2), 5, axis=0)
    got = tk.KMeans(3, tol=0.0, max_iterations=6, init="random", seed=0,
                    device="cpu").fit(pts)
    init = pts[np.random.default_rng(0).choice(20, 3, replace=False)]
    assert len({tuple(r) for r in init}) < 3        # the scenario holds
    with pytest.raises(ValueError, match="read-only"):
        jk.KMeans(3, tol=0.0, max_iterations=6, init="random",
                  seed=0).fit(pts)
    centers, assign, cost, it = _jax_lloyd(pts, init, 6)
    np.testing.assert_allclose(got.centers, centers, rtol=0,
                               atol=TOL_CENTERS * np.abs(centers).max())
    np.testing.assert_array_equal(got.assignments, assign)
    assert got.iterations == it
    assert got.cost == pytest.approx(cost, rel=TOL_CENTERS)
    assert len(set(got.assignments.tolist())) == 3


def test_kmeanspp_init_and_refusals_match_jax():
    pts = _blobs(200, 3, 5, seed=4)
    got = tk.kmeanspp_init(pts, 5, np.random.default_rng(9), device="cpu")
    want = jk.kmeanspp_init(pts, 5, np.random.default_rng(9))
    np.testing.assert_array_equal(got, want)
    same = np.ones((6, 2), np.float32)      # every distance 0: uniform picks
    np.testing.assert_array_equal(
        tk.kmeanspp_init(same, 3, np.random.default_rng(1), device="cpu"),
        jk.kmeanspp_init(same, 3, np.random.default_rng(1)))
    for fn in (lambda: tk.kmeanspp_init(pts[:3], 4, np.random.default_rng(0),
                                        device="cpu"),
               lambda: jk.kmeanspp_init(pts[:3], 4, np.random.default_rng(0))):
        with pytest.raises(ValueError, match="k=4 clusters requested"):
            fn()
    if not torch.cuda.is_available():
        for make in (lambda: tk.KMeans(3), lambda: tt.Tsne(),
                     lambda: ta.KMeansClustering.setup(3)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()


def _strategies(m):
    """Each strategy and condition of ``m`` (either package's
    ``algorithm``), as (name, algorithm factory) pairs."""
    out = [("fixed", lambda **d: m.KMeansClustering.setup(4, 5, seed=2,
                                                           **d)),
           ("convergence", lambda **d: m.KMeansClustering
            .setup_with_convergence(4, 0.02, seed=2, **d))]
    for t, v in ((m.ClusteringOptimizationType
                  .MINIMIZE_AVERAGE_POINT_TO_CENTER_DISTANCE, 2.5),
                 (m.ClusteringOptimizationType
                  .MINIMIZE_MAXIMUM_POINT_TO_CENTER_DISTANCE, 6.0),
                 (m.ClusteringOptimizationType
                  .MINIMIZE_AVERAGE_POINT_TO_POINT_DISTANCE, 5.0),
                 (m.ClusteringOptimizationType
                  .MINIMIZE_MAXIMUM_POINT_TO_POINT_DISTANCE, 12.0),
                 (m.ClusteringOptimizationType
                  .MINIMIZE_PER_CLUSTER_POINT_COUNT, 60)):
        def make(t=t, v=v, **d):
            s = m.OptimisationStrategy.setup(3).optimize(t, v)
            s.optimize_when_iteration_count_multiple_of(2)
            s.end_when_iteration_count_equals(6)
            return m.BaseClusteringAlgorithm.setup(s, seed=1,
                                                   max_iterations=6, **d)
        out.append((t.value, make))

    def variance(**d):
        s = m.FixedClusterCountStrategy.setup(4, allow_empty_clusters=True)
        s.termination_condition = \
            m.VarianceVariationCondition.variance_variation_less_than(
                0.05, 2)
        return m.BaseClusteringAlgorithm(s, seed=5, max_iterations=20, **d)
    out.append(("variance", variance))
    return out


@pytest.mark.parametrize("index", range(8))
def test_strategies_and_conditions_match_jax(index):
    pts = _blobs(240, 4, 4, seed=7, wide=True)
    name, make_t = _strategies(ta)[index]
    _, make_j = _strategies(ja)[index]
    at, aj = make_t(device="cpu"), make_j()
    got, want = at.apply_to(pts), aj.apply_to(pts)
    _same_clusters(pts, got, want)
    assert at.history.iteration_count == aj.history.iteration_count
    for i, ij in aj.history.iterations.items():
        it = at.history.get(i)
        assert it.strategy_applied == ij.strategy_applied, (name, i)
        a, b = it.cluster_set_info, ij.cluster_set_info
        np.testing.assert_array_equal(a.counts, b.counts)
        assert a.point_location_change == b.point_location_change
        np.testing.assert_allclose(a.max_distance, b.max_distance,
                                   rtol=TOL_CENTERS, atol=TOL_CENTERS)
        np.testing.assert_allclose(a.avg_distance, b.avg_distance,
                                   rtol=TOL_AVG_DISTANCE)
        assert a.point_distance_from_cluster_variance() == pytest.approx(
            b.point_distance_from_cluster_variance(), rel=TOL_AVG_DISTANCE)


def test_conditions_on_a_given_history_match_jax():
    def history(m, variances, changes):
        h = m.IterationHistory()
        for i, (v, c) in enumerate(zip(variances, changes), 1):
            info = m.ClusterSetInfo(np.array([5.0, 5.0]), np.ones(2),
                                    np.ones(2), np.full(2, v), 1.0, c)
            h.iterations[i] = m.IterationInfo(i, info)
        return h

    cases = [([1.0, 0.99, 0.985, 0.984], [10, 3, 0, 0]),
             ([1.0, 0.5, 0.49], [10, 1, 1]), ([2.0], [4]),
             ([1.0, 0.0, 0.0], [0, 0, 0])]
    for variances, changes in cases:
        for make in (lambda m: m.ConvergenceCondition(0.2),
                     lambda m: m.FixedIterationCountCondition(3),
                     lambda m: m.VarianceVariationCondition(0.02, 2)):
            assert make(ta).is_satisfied(history(ta, variances, changes)) \
                == make(ja).is_satisfied(history(ja, variances, changes))
    h = history(ta, [1.0], [0])
    assert h.most_recent().index == 1 and ta.IterationHistory() \
        .most_recent() is None


def test_sptree_matches_jax():
    rng = np.random.default_rng(8)
    for pts in (rng.standard_normal((60, 2)), rng.standard_normal((40, 3)),
                np.repeat(rng.standard_normal((10, 2)), 3, axis=0)):
        a, b = ts.SPTree(pts), js.SPTree(pts)
        for theta in (0.0, 0.5):
            for i in range(len(pts)):
                fa, za = a.compute_non_edge_forces(i, theta)
                fb, zb = b.compute_non_edge_forces(i, theta)
                np.testing.assert_array_equal(fa, fb)
                assert za == zb


def _tsne_kw():
    return dict(perplexity=5.0, max_iter=30, stop_lying_iteration=10,
                switch_momentum_iteration=15, seed=3)


def test_exact_tsne_matches_jax():
    x = np.random.default_rng(9).standard_normal((40, 6)).astype(np.float32)
    port = tt.Tsne(device="cpu", **_tsne_kw())
    with jax.enable_x64(False):
        ref = jt.Tsne(**_tsne_kw())
        want_p = np.asarray(ref._input_probabilities(jnp.asarray(x)))
        want = ref.fit(x)
    got_p = port._input_probabilities(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got_p, want_p, rtol=0,
                               atol=TOL_P * want_p.max())
    got = port.fit(x)
    assert got.dtype == np.float32 and got.shape == (40, 2)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL_Y * np.abs(want).max())
    assert port.kl_divergence == pytest.approx(ref.kl_divergence,
                                               rel=TOL_KL)
    # the initial embedding: the JAX package's draw within f32 rounding
    with jax.enable_x64(False):
        y0 = 1e-4 * np.asarray(jax.random.normal(jax.random.PRNGKey(3),
                                                 (40, 2), jnp.float32))
    np.testing.assert_allclose(port._initial(40).numpy(), y0, rtol=1e-6,
                               atol=1e-12)


def test_barnes_hut_tsne_matches_jax():
    x = np.random.default_rng(10).standard_normal((50, 4)).astype(
        np.float32)
    kw = dict(perplexity=5.0, max_iter=6, stop_lying_iteration=3, seed=4)
    port = tt.BarnesHutTsne(theta=0.5, device="cpu", **kw)
    with jax.enable_x64(False):
        ref = jt.BarnesHutTsne(theta=0.5, **kw)
        want = ref.fit(x)
    got = port.fit(x)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL_BH * np.abs(want).max())
    assert port.kl_divergence == pytest.approx(ref.kl_divergence, rel=1e-5)
    # theta 0 is the exact path
    exact = tt.BarnesHutTsne(theta=0.0, device="cpu", **kw).fit(x)
    np.testing.assert_array_equal(exact, tt.Tsne(device="cpu", **kw).fit(x))


def test_clustering_exports_match_jax():
    import deeplearning4j_tpu.clustering as jclust
    assert sorted(tclust.__all__) == sorted(jclust.__all__)


# ------------------------------------------------------------ ml.py stages
def _jconf(kind):
    b = JNNC.builder().seed(4).updater(JSgd(learning_rate=0.1)).list()
    if kind == "ae":
        b = b.layer(jpre.AutoEncoder(n_out=3, corruption_level=0.0,
                                     activation="sigmoid"))
    else:
        b = b.layer(jff.DenseLayer(n_out=8, activation="tanh"))
    return (b.layer(jff.OutputLayer(n_out=3, activation="softmax",
                                    loss="mcxent"))
            .set_input_type(JIT.feed_forward(5)).build())


def _install(monkeypatch, kind):
    """The JAX package's ``MultiLayerNetwork.init`` patched to take the
    port's seeded params for ``kind`` (its own draws are JAX's), so both
    estimators train the same network."""
    tconf = MultiLayerConfiguration.from_json(_jconf(kind).to_json())
    net = MultiLayerNetwork(tconf, device="cpu").init()
    tree = {k: {n: p.detach().numpy().copy() for n, p in g.items()}
            for k, g in net.params.items()}

    def init(self):
        self.params = {k: {n: jnp.asarray(v) for n, v in g.items()}
                       for k, g in tree.items()}
        self.state = {k: {} for k in tree}
        self._tx = self._build_tx()
        self.opt_state = self._tx.init(self.params)
        return self

    monkeypatch.setattr(jmln.MultiLayerNetwork, "init", init)
    return lambda: MultiLayerConfiguration.from_json(_jconf(kind).to_json())


def test_estimators_match_jax(monkeypatch):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((37, 5)).astype(np.float32)
    y = rng.integers(0, 3, 37)
    tconf = _install(monkeypatch, "dense")
    with jax.enable_x64(False):
        jmodel = jml.NetworkEstimator(lambda: _jconf("dense"), epochs=3,
                                      batch_size=8).fit(x, y)
        want = jmodel.predict_proba(x)
        want_score = jmodel.score(x, np.eye(3)[y])
    est = tml.NetworkEstimator(tconf, epochs=3, batch_size=8, device="cpu")
    model = est.fit(x, y)
    got = model.predict_proba(x)
    assert got.shape == (37, 3) and isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_EST)
    np.testing.assert_array_equal(model.predict(x), np.argmax(want, -1))
    assert model.score(x, np.eye(3)[y]) == want_score
    np.testing.assert_array_equal(model.transform(x), got)
    assert est.get_params() == {"epochs": 3, "batch_size": 8,
                                "num_classes": None, "device": "cpu"}
    assert est.set_params(epochs=1).epochs == 1
    for e in (est, jml.NetworkEstimator(lambda: None)):
        with pytest.raises(ValueError, match="unknown param 'lr'"):
            e.set_params(lr=1)
        with pytest.raises(ValueError, match="needs labels y"):
            e.fit(x)
    # the autoencoder stage: pretrain, then the encoded representation
    tconf = _install(monkeypatch, "ae")
    with jax.enable_x64(False):
        want = jml.AutoEncoderEstimator(lambda: _jconf("ae"), epochs=2,
                                        batch_size=8, encode_layer=0
                                        ).fit(x).transform(x)
    got = tml.AutoEncoderEstimator(tconf, epochs=2, batch_size=8,
                                   encode_layer=0, device="cpu"
                                   ).fit(x).transform(x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_EST)
