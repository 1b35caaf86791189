"""Early stopping and ``fit_on_device`` in the port against the JAX
package, and ``utils/_random.permutation`` against
``jax.random.permutation``.

The networks draw DropConnect and dropout from the threefry stream, so
the JAX side runs under ``jax.enable_x64(False)`` (the conftest turns
x64 on, and then JAX draws other Bernoulli masks) and trains with
Nesterovs, whose arithmetic is the same without x64; params then agree
within float32 rounding of the same sums.
"""
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import earlystopping as jes
from deeplearning4j_tpu.nn.computation_graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.conf import dropout as jdrop
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.train import listeners as jlis
from deeplearning4j_tpu_torch import earlystopping as tes
from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf import dropout as tdrop
from deeplearning4j_tpu_torch.nn.conf import updaters as tupd
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType as TIT
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import feedforward as tff
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.train import listeners as tlis
from deeplearning4j_tpu_torch.utils import _random
from deeplearning4j_tpu_torch.utils.model_serializer import params_from_jax

# float32 sums of a few hundred terms over a few steps, in another order
RTOL, ATOL = 2e-5, 1e-6

JAX = dict(nnc=JNNC, it=JIT, ff=jff, upd=jupd, drop=jdrop)
PORT = dict(nnc=NeuralNetConfiguration, it=TIT, ff=tff, upd=tupd,
            drop=tdrop)


def _conf(m, lr=0.05):
    return (m["nnc"].builder().seed(21)
            .updater(m["upd"].Nesterovs(learning_rate=lr, momentum=0.9))
            .activation("tanh").list()
            .layer(m["ff"].DenseLayer(n_out=8,
                                      weight_noise=m["drop"].DropConnect(0.8)))
            .layer(m["ff"].DenseLayer(n_out=6, dropout=0.9))
            .layer(m["ff"].OutputLayer(n_out=3, activation="softmax",
                                       loss="mcxent"))
            .set_input_type(m["it"].feed_forward(5)).build())


def _pair(lr=0.05):
    with jax.enable_x64(False):
        jn = JMLN(_conf(JAX, lr)).init()
        params = jax.tree_util.tree_map(np.asarray, jn.params)
    tn = params_from_jax(MultiLayerNetwork(_conf(PORT, lr), device="cpu"),
                         params)
    return jn, tn


def _close(tn, jn):
    for k, g in jn.params.items():
        for n, a in g.items():
            np.testing.assert_allclose(tn.params[k][n].detach().numpy(),
                                       np.asarray(a), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{k}/{n}")


def _data(rng, n):
    x = rng.standard_normal((n, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


class _Batches:
    def __init__(self, batches):
        self.batches = batches

    def reset(self):
        pass

    def __iter__(self):
        return iter(self.batches)


@pytest.mark.parametrize("n", [1, 7, 128, 1000, 60000])
def test_permutation_is_bit_equal_to_jax(n):
    for seed in (0, 12345):
        want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
        got = _random.permutation(_random.prng_key(seed), n)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("patience", [1, 3])
def test_early_stopping_matches_jax(patience):
    rng = np.random.default_rng(patience)
    train = [_data(rng, 8) for _ in range(3)]
    held = [_data(rng, 8) for _ in range(2)]
    results = {}
    for side, (es, lis) in (("jax", (jes, jlis)), ("port", (tes, tlis))):
        jn, tn = _pair(lr=0.5)
        net = jn if side == "jax" else tn
        coll = lis.CollectScoresIterationListener()
        net.set_listeners(coll)
        conf = (es.EarlyStoppingConfiguration.builder()
                .score_calculator(es.DataSetLossCalculator(_Batches(held)))
                .model_saver(es.InMemoryModelSaver())
                .epoch_termination_conditions(
                    es.MaxEpochsTerminationCondition(6),
                    es.ScoreImprovementEpochTerminationCondition(patience))
                .iteration_termination_conditions(
                    es.InvalidScoreIterationTerminationCondition())
                .build())
        cls = es.EarlyStoppingTrainer
        if side == "jax":
            with jax.enable_x64(False):
                res = cls(conf, net, _Batches(train)).fit()
        else:
            res = cls(conf, net, _Batches(train)).fit()
        results[side] = (res, net, coll.scores)
    (jr, jn, jsc), (tr, tn, tsc) = results["jax"], results["port"]
    assert tr.termination_reason == jr.termination_reason
    assert tr.termination_details == jr.termination_details
    assert tr.best_model_epoch == jr.best_model_epoch
    assert tr.total_epochs == jr.total_epochs
    assert sorted(tr.score_vs_epoch) == sorted(jr.score_vs_epoch)
    for e, s in jr.score_vs_epoch.items():
        np.testing.assert_allclose(tr.score_vs_epoch[e], s, rtol=RTOL)
    np.testing.assert_allclose([s for _, s in tsc], [s for _, s in jsc],
                               rtol=RTOL)
    # the saver's clones split the key stream as the JAX package's do:
    # the trained nets and the best models agree
    _close(tn, jn)
    _close(tr.best_model, jr.best_model)
    np.testing.assert_array_equal(tn._rng.numpy(),
                                  np.asarray(jn._rng).astype(np.int64))


def test_accuracy_calculator_and_iteration_termination():
    rng = np.random.default_rng(9)
    train = [_data(rng, 8) for _ in range(3)]
    _, tn = _pair()
    conf = (tes.EarlyStoppingConfiguration.builder()
            .score_calculator(tes.AccuracyScoreCalculator(_Batches(train)))
            .epoch_termination_conditions(
                tes.BestScoreEpochTerminationCondition(2.0))
            .iteration_termination_conditions(
                tes.MaxScoreIterationTerminationCondition(1e-9))
            .save_last_model().build())
    res = tes.EarlyStoppingTrainer(conf, tn, _Batches(train)).fit()
    assert res.termination_reason == "IterationTerminationCondition"
    assert res.termination_details == "MaxScoreIterationTerminationCondition"
    assert conf.model_saver.get_latest_model() is not None


@pytest.mark.parametrize("path", ["fused", "per_epoch"])
def test_fit_on_device_matches_jax(path):
    """The fused path (2 epochs, no tail, no listener) and the per-epoch
    path (a ragged tail of 2 and a listener) give the JAX package's
    permutations, keys and params."""
    rng = np.random.default_rng(5)
    n = 16 if path == "fused" else 18
    x, y = _data(rng, n)
    jn, tn = _pair()
    if path == "per_epoch":
        jr, tr = jlis.CollectScoresIterationListener(), \
            tlis.CollectScoresIterationListener()
        jn.set_listeners(jr)
        tn.set_listeners(tr)
    with jax.enable_x64(False):
        jn.fit_on_device(x, y, batch_size=4, epochs=2, shuffle=True)
    tn.fit_on_device(x, y, batch_size=4, epochs=2, shuffle=True)
    assert tn.iteration == jn.iteration and tn.epoch == jn.epoch == 2
    assert isinstance(tn._score, float)
    np.testing.assert_allclose(tn.get_score(), jn.get_score(), rtol=RTOL)
    _close(tn, jn)
    np.testing.assert_array_equal(tn._rng.numpy(),
                                  np.asarray(jn._rng).astype(np.int64))
    assert len(tn.last_permutations) == 2
    if path == "per_epoch":
        # once per epoch, plus once for the tail's step
        assert [i for i, _ in tr.scores] == [i for i, _ in jr.scores] == \
            [4, 5, 9, 10]
        np.testing.assert_allclose([s for _, s in tr.scores],
                                   [s for _, s in jr.scores], rtol=RTOL)


def test_graph_fit_on_device_matches_jax():
    def build(m):
        g = (m["nnc"].builder().seed(2)
             .updater(m["upd"].Sgd(learning_rate=0.1)).graph_builder())
        g.add_inputs("in").set_input_types(m["it"].feed_forward(5))
        g.add_layer("h", m["ff"].DenseLayer(n_out=4, activation="tanh",
                                            dropout=0.8), "in")
        g.add_layer("out", m["ff"].OutputLayer(n_out=3, activation="softmax",
                                               loss="mcxent"), "h")
        return g.set_outputs("out").build()
    rng = np.random.default_rng(6)
    x, y = _data(rng, 12)
    with jax.enable_x64(False):
        jg = JCG(build(JAX)).init()
        params = jax.tree_util.tree_map(np.asarray, jg.params)
        jg.fit_on_device(x, y, batch_size=4, epochs=3, shuffle=True)
    tg = params_from_jax(ComputationGraph(build(PORT), device="cpu"), params)
    tg.fit_on_device(x, y, batch_size=4, epochs=3, shuffle=True)
    _close(tg, jg)
    with pytest.raises(ValueError, match="exceeds dataset"):
        tg.fit_on_device(x, y, batch_size=64)
    with pytest.raises(ValueError, match="same leading dimension"):
        tg.fit_on_device(x, y[:5], batch_size=4)
