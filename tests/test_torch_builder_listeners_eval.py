"""The port's builder DSL, listeners and evaluation against the JAX
package: a configuration built here writes the JSON the JAX builder
writes and reads back there; listeners fire in the same order with the
same counts in ``fit`` and tBPTT; ``Evaluation``, ``RegressionEvaluation``
and ``ROC`` agree on the same arrays and through ``net.evaluate``,
3-D time series with masks included."""
import json
import logging

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.evaluation import classification as jcls
from deeplearning4j_tpu.evaluation import regression as jreg
from deeplearning4j_tpu.evaluation import roc as jroc
from deeplearning4j_tpu.nn.computation_graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.conf import (constraints as jcons,
                                        distribution as jdist,
                                        dropout as jdrop,
                                        schedules as jsched,
                                        updaters as jupd)
from deeplearning4j_tpu.nn.conf.computation_graph import \
    ComputationGraphConfiguration as JCGC
from deeplearning4j_tpu.nn.conf.computation_graph import MergeVertex as JMV
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import \
    MultiLayerConfiguration as JMLC
from deeplearning4j_tpu.nn.conf.multi_layer import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import convolution as jconv
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.train import listeners as jlis
from deeplearning4j_tpu_torch.evaluation import classification as tcls
from deeplearning4j_tpu_torch.evaluation import regression as treg
from deeplearning4j_tpu_torch.evaluation import roc as troc
from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf import (constraints as tcons,
                                              distribution as tdist,
                                              dropout as tdrop,
                                              schedules as tsched,
                                              updaters as tupd)
from deeplearning4j_tpu_torch.nn.conf.computation_graph import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.computation_graph import \
    MergeVertex as TMV
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType as TIT
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import convolution as tconv
from deeplearning4j_tpu_torch.nn.layers import feedforward as tff
from deeplearning4j_tpu_torch.nn.layers import normalization as tnorm
from deeplearning4j_tpu_torch.nn.layers import recurrent as trec
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.train import listeners as tlis
from deeplearning4j_tpu_torch.utils.model_serializer import params_from_jax

JAX = dict(nnc=JNNC, it=JIT, ff=jff, rec=jrec, conv=jconv, norm=jnorm,
           upd=jupd, sched=jsched, cons=jcons, drop=jdrop, dist=jdist,
           mv=JMV)
PORT = dict(nnc=NeuralNetConfiguration, it=TIT, ff=tff, rec=trec,
            conv=tconv, norm=tnorm, upd=tupd, sched=tsched, cons=tcons,
            drop=tdrop, dist=tdist, mv=TMV)


def _dense(m):
    return (m["nnc"].builder().seed(7).activation("relu")
            .weight_init("relu").updater(m["upd"].Nadam(
                learning_rate=m["sched"].ExponentialSchedule(1e-2, 0.9)))
            .l2(1e-4).bias_init(0.1).gradient_normalization(
                "ClipL2PerLayer", 2.0)
            .list()
            .layer(m["ff"].DenseLayer(n_out=8, dropout=0.9))
            .layer(m["ff"].DenseLayer(n_out=6, activation="tanh",
                                      updater=m["upd"].AdaGrad(0.05)))
            .layer(m["ff"].OutputLayer(n_out=3, activation="softmax",
                                       loss="mcxent"))
            .set_input_type(m["it"].feed_forward(5)).build())


def _rnn(m):
    return (m["nnc"].builder().seed(3)
            .updater(m["upd"].RmsProp(learning_rate=m["sched"].StepSchedule(
                2e-3, 0.5, 8)))
            .weight_init("distribution",
                         m["dist"].TruncatedNormalDistribution(0.0, 0.2))
            .list()
            .layer(m["rec"].LSTM(n_out=6, activation="tanh",
                                 weight_noise=m["drop"].DropConnect(0.9)))
            .layer(m["rec"].RnnOutputLayer(
                n_out=4, activation="softmax", loss="mcxent",
                constraints=[m["cons"].MaxNormConstraint(max_norm=1.0)]))
            .backprop_type("tbptt", 3, 3)
            .set_input_type(m["it"].recurrent(4, 6)).build())


def _cnn(m):
    return (m["nnc"].builder().seed(1).updater(m["upd"].AdamW(1e-3))
            .list()
            .layer(m["conv"].ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                              activation="identity"))
            .layer(m["norm"].BatchNormalization(activation="relu"))
            .layer(m["conv"].SubsamplingLayer(kernel_size=(2, 2),
                                              stride=(2, 2)))
            .layer(m["ff"].OutputLayer(n_out=3, activation="softmax",
                                       loss="mcxent"))
            .set_input_type(m["it"].convolutional(8, 8, 2)).build())


def _graph(m):
    g = (m["nnc"].builder().seed(5).updater(m["upd"].Lion(1e-3))
         .graph_builder())
    g.add_inputs("a", "b").set_input_types(m["it"].feed_forward(3),
                                           m["it"].feed_forward(2))
    g.add_layer("da", m["ff"].DenseLayer(n_out=4, activation="tanh"), "a")
    g.add_layer("db", m["ff"].DenseLayer(n_out=4, activation="tanh"), "b")
    g.add_vertex("merge", m["mv"](), "da", "db")
    g.add_layer("out", m["ff"].OutputLayer(n_out=2, activation="softmax",
                                           loss="mcxent"), "merge")
    return g.set_outputs("out").build()


@pytest.mark.parametrize("which", [_dense, _rnn, _cnn, _graph],
                         ids=["dense", "rnn", "cnn", "graph"])
def test_builder_json_equals_the_jax_builder_and_reads_back(which):
    jconf, tconf = which(JAX), which(PORT)
    js, ts = jconf.to_json(), tconf.to_json()
    assert json.loads(ts) == json.loads(js)
    assert ts == js
    # JAX reads the port's JSON into the same network (same JSON again)
    jcls_ = JCGC if which is _graph else JMLC
    assert jcls_.from_json(ts).to_json() == js
    # and the port reads its own back
    tcls_ = ComputationGraphConfiguration if which is _graph \
        else MultiLayerConfiguration
    assert tcls_.from_json(ts).to_json() == ts
    assert tcls_.from_yaml(tconf.to_yaml()).to_json() == ts


def test_builder_validates_names_and_builds_without_input_type():
    with pytest.raises(ValueError, match="not ported|Unknown"):
        (NeuralNetConfiguration.builder().list()
         .layer(tff.OutputLayer(n_in=2, n_out=2, loss="bogus")).build())
    conf = (NeuralNetConfiguration.builder().list()
            .layer(tff.DenseLayer(n_in=3, n_out=4))
            .layer(tff.OutputLayer(n_in=4, n_out=2, activation="softmax"))
            .build())
    # as in the JAX package: no type for layer 0, then the chain resumes
    # from the first layer's output type
    assert conf.layer_input_types[0] is None and \
        conf.layer_input_types[1].size == 4
    net = MultiLayerNetwork(conf, device="cpu").init()
    assert tuple(net.output(np.zeros((2, 3), np.float32)).shape) == (2, 2)
    b = NeuralNetConfiguration.builder()
    with pytest.raises(ValueError):
        b.cache_mode("bogus")
    with pytest.raises(ValueError):
        b.scan_layers(1)
    with pytest.raises(ValueError, match="out of range"):
        b.list().layer(tff.DenseLayer(n_in=1, n_out=1), index=3)


def _recorder(base):
    class Rec(base):
        def __init__(self):
            self.events = []

        def iteration_done(self, model, iteration, epoch):
            self.events.append(("it", iteration, epoch))

        def on_epoch_start(self, model):
            self.events.append(("start", model.iteration, model.epoch))

        def on_epoch_end(self, model):
            self.events.append(("end", model.iteration, model.epoch))
    return Rec()


class _Batches:
    """A DataSetIterator: ``reset()`` and iteration over 4-tuples."""

    def __init__(self, batches):
        self.batches = batches

    def reset(self):
        pass

    def __iter__(self):
        return iter(self.batches)


def test_listener_hook_order_and_counts_match_jax():
    rng = np.random.default_rng(0)
    jn = JMLN(_dense(JAX)).init()
    tn = params_from_jax(MultiLayerNetwork(_dense(PORT), device="cpu"),
                         jax.tree_util.tree_map(np.asarray, jn.params))
    batches = [(rng.standard_normal((4, 5)).astype(np.float32),
                np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)])
               for _ in range(3)]
    jr, tr = _recorder(jlis.TrainingListener), _recorder(tlis.TrainingListener)
    jc, tc = jlis.CollectScoresIterationListener(), \
        tlis.CollectScoresIterationListener()
    jn.set_listeners(jr, jc)
    tn.set_listeners(tr).add_listeners(tc)
    jn.fit(_Batches(batches), epochs=2)
    tn.fit(_Batches(batches), epochs=2)
    assert tr.events == jr.events and len(tr.events) == 10
    assert [i for i, _ in tc.scores] == [i for i, _ in jc.scores]
    # dropout 0.9 draws the same masks from the same stream (x64 on: the
    # JAX package draws f64 uniforms, so only the first-layer-free loss
    # matches exactly; compare the scores loosely)
    assert all(np.isfinite(s) for _, s in tc.scores)

    # tBPTT: one iteration_done per chunk, as the JAX package
    jr2, tr2 = _recorder(jlis.TrainingListener), \
        _recorder(tlis.TrainingListener)
    jrn = JMLN(_rnn(JAX)).init().set_listeners(jr2)
    trn = MultiLayerNetwork(_rnn(PORT), device="cpu").init() \
        .set_listeners(tr2)
    x = rng.standard_normal((2, 6, 4)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (2, 6))]
    jrn.fit(x, y)
    trn.fit(x, y)
    assert tr2.events == jr2.events and \
        [e[0] for e in tr2.events] == ["start", "it", "it", "end"]


def test_stock_listeners(caplog, tmp_path):
    rng = np.random.default_rng(1)
    tn = MultiLayerNetwork(_cnn(PORT), device="cpu").init()
    x = rng.standard_normal((4, 8, 8, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    perf = tlis.PerformanceListener(frequency=1, report_score=True)
    pg = tlis.ParamAndGradientIterationListener(iterations=1)
    conv = tlis.ConvolutionalIterationListener(x[:1], frequency=2,
                                               output_dir=str(tmp_path))
    ev = tlis.EvaluativeListener(_Batches([(x, y)]), frequency=3,
                                 print_report=False)
    comp = tlis.ComposableIterationListener(tlis.ScoreIterationListener(1),
                                            tlis.SleepyTrainingListener())
    tn.set_listeners(perf, pg, conv, ev, comp,
                     tlis.TimeIterationListener(10, frequency=1))
    with caplog.at_level(logging.INFO, "deeplearning4j_tpu_torch.train"):
        tn.fit(x, y, epochs=3)
    assert np.isfinite(perf.samples_per_sec) and perf.last_batch_size == 4
    assert len(pg.rows) == 3 and "grad_norm" in pg.rows[0] and \
        "l2_layer_0.W" in pg.rows[0]
    assert len(conv.rendered) == 1 and "<svg" in conv.rendered[0]
    assert len(list(tmp_path.iterdir())) == 1
    assert ev.last_evaluation is not None and \
        ev.last_evaluation.confusion.total() == 4
    assert any("Score at iteration 3" in r.message for r in caplog.records)


def test_evaluation_classes_agree_on_the_same_arrays():
    rng = np.random.default_rng(2)
    lab = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 50)]
    pred = rng.random((50, 4)).astype(np.float32)
    je, te = jcls.Evaluation(), tcls.Evaluation()
    je.eval(lab, pred)
    te.eval(torch.tensor(lab), torch.tensor(pred))
    np.testing.assert_array_equal(te.confusion.matrix, je.confusion.matrix)
    for f in ("accuracy", "precision", "recall", "f1"):
        assert getattr(te, f)() == getattr(je, f)()
    assert te.stats() == je.stats()
    reg_l = rng.standard_normal((30, 3))
    reg_p = reg_l + 0.1 * rng.standard_normal((30, 3))
    jr, tr = jreg.RegressionEvaluation(), treg.RegressionEvaluation()
    jr.eval(reg_l, reg_p)
    tr.eval(torch.tensor(reg_l), torch.tensor(reg_p))
    for c in range(3):
        assert tr.mean_squared_error(c) == jr.mean_squared_error(c)
        assert tr.r_squared(c) == jr.r_squared(c)
    b_l = (rng.random(40) > 0.5).astype(np.float32)
    b_p = np.clip(b_l * 0.3 + rng.random(40) * 0.7, 0, 1)
    for steps in (0, 10):
        jo, to = jroc.ROC(steps), troc.ROC(steps)
        jo.eval(b_l, b_p)
        to.eval(torch.tensor(b_l), torch.tensor(b_p))
        assert to.calculate_auc() == jo.calculate_auc()
        assert to.calculate_auprc() == jo.calculate_auprc()


def test_net_evaluate_matches_jax_including_masked_time_series():
    rng = np.random.default_rng(3)
    jn = JMLN(_dense(JAX)).init()
    tn = params_from_jax(MultiLayerNetwork(_dense(PORT), device="cpu"),
                         jax.tree_util.tree_map(np.asarray, jn.params))
    batches = [(rng.standard_normal((6, 5)).astype(np.float32),
                np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)])
               for _ in range(2)]
    je, te = jn.evaluate(_Batches(batches)), tn.evaluate(_Batches(batches))
    np.testing.assert_array_equal(te.confusion.matrix, je.confusion.matrix)
    x, y = batches[0]
    assert tn.evaluate_regression(x, y).average_mean_squared_error() == \
        pytest.approx(jn.evaluate_regression(x, y)
                      .average_mean_squared_error(), rel=1e-5)
    # time series: [b, t, c] outputs, a labels mask drops padded steps
    jr = JMLN(_rnn(JAX)).init()
    tr = params_from_jax(MultiLayerNetwork(_rnn(PORT), device="cpu"),
                         jax.tree_util.tree_map(np.asarray, jr.params))
    xs = rng.standard_normal((3, 6, 4)).astype(np.float32)
    ys = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (3, 6))]
    lm = np.ones((3, 6), np.float32)
    lm[1, 4:] = lm[2, 2:] = 0
    te = tr.evaluate(_Batches([(xs, ys, None, lm)]))
    je = jcls.Evaluation()
    je.eval(ys, np.asarray(jr.output(xs)), mask=lm)
    np.testing.assert_array_equal(te.confusion.matrix, je.confusion.matrix)
    assert te.confusion.total() == int(lm.sum())



def test_graph_evaluate_and_clone():
    rng = np.random.default_rng(4)
    jg = JCG(_graph(JAX)).init()
    tg = params_from_jax(ComputationGraph(_graph(PORT), device="cpu"),
                         jax.tree_util.tree_map(np.asarray, jg.params))
    a = rng.standard_normal((5, 3)).astype(np.float32)
    b = rng.standard_normal((5, 2)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 5)]
    np.testing.assert_array_equal(tg.evaluate([a, b], [y]).confusion.matrix,
                                  jg.evaluate([a, b], [y]).confusion.matrix)
    assert tg.evaluate_roc([a, b], [y]).calculate_auc() == pytest.approx(
        jg.evaluate_roc([a, b], [y]).calculate_auc(), abs=1e-12)
    tg.fit([a, b], [y])
    c = tg.clone()
    rng0 = tg._rng.clone()
    assert c.iteration == tg.iteration == 1
    assert c.opt_state["count"] == tg.opt_state["count"]
    for k, g in tg.params.items():
        for n, p in g.items():
            assert torch.equal(c.params[k][n], p)
            assert c.params[k][n].data_ptr() != p.data_ptr()
    c.fit([a, b], [y])
    assert not torch.equal(c.params["da"]["W"], tg.params["da"]["W"])
    assert torch.equal(tg._rng, rng0)
