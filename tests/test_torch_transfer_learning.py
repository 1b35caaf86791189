"""Transfer learning in the port against the JAX package: the MLN
``TransferLearning.Builder`` (fine-tune, feature extractor, output layer
removed and added, ``n_out_replace``), the graph ``GraphBuilder``
(feature extractor, ``remove_vertex_and_connections``, a new output
layer) and ``TransferLearningHelper``.  New layers draw their init from
different generators in the two packages, so the port loads the JAX
package's post-build params; then both train and must agree, and the
frozen params must not move at all."""
import jax
import numpy as np
import torch

from deeplearning4j_tpu.nn.computation_graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.transfer_learning import (
    TransferLearning as JTL, TransferLearningHelper as JTLH)
from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf import updaters as tupd
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType as TIT
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import feedforward as tff
from deeplearning4j_tpu_torch.nn.layers import normalization as tnorm
from deeplearning4j_tpu_torch.nn.layers.misc import FrozenLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.transfer_learning import (
    TransferLearning, TransferLearningHelper)
from deeplearning4j_tpu_torch.utils.model_serializer import (
    params_from_jax, state_from_jax)

RTOL, ATOL = 2e-5, 1e-6
JAX = dict(nnc=JNNC, it=JIT, ff=jff, norm=jnorm, upd=jupd, mln=JMLN,
           cg=JCG, tl=JTL, tlh=JTLH)
PORT = dict(nnc=NeuralNetConfiguration, it=TIT, ff=tff, norm=tnorm,
            upd=tupd, tl=TransferLearning, tlh=TransferLearningHelper)


def _tree(net):
    return jax.tree_util.tree_map(np.asarray, net.params)


def _close(tn, jn, exact=()):
    for k, g in jn.params.items():
        for n, a in g.items():
            got = tn.params[k][n].detach().numpy()
            if k in exact:
                np.testing.assert_array_equal(got, np.asarray(a))
            else:
                np.testing.assert_allclose(got, np.asarray(a), rtol=RTOL,
                                           atol=ATOL, err_msg=f"{k}/{n}")


def _mln(m):
    return (m["nnc"].builder().seed(8).activation("tanh")
            .updater(m["upd"].Sgd(learning_rate=0.1)).list()
            .layer(m["ff"].DenseLayer(n_out=6))
            .layer(m["norm"].BatchNormalization())
            .layer(m["ff"].DenseLayer(n_out=5))
            .layer(m["ff"].OutputLayer(n_out=3, activation="softmax",
                                       loss="mcxent"))
            .set_input_type(m["it"].feed_forward(4)).build())


def _data(rng, n, k):
    return (rng.standard_normal((n, 4)).astype(np.float32),
            np.eye(k, dtype=np.float32)[rng.integers(0, k, n)])


def _edit_mln(m, net):
    return (m["tl"].Builder(net)
            .fine_tune_configuration(updater=m["upd"].Nadam(learning_rate=0.01))
            .set_feature_extractor(1)
            .n_out_replace(2, 7)
            .remove_output_layer()
            .add_layer(m["ff"].OutputLayer(n_out=2, activation="softmax",
                                           loss="mcxent"))
            .build())


def test_mln_transfer_learning_matches_jax():
    rng = np.random.default_rng(0)
    x, y = _data(rng, 8, 3)
    jsrc = JMLN(_mln(JAX)).init()
    jsrc.fit(x, y)
    tsrc = params_from_jax(MultiLayerNetwork(_mln(PORT), device="cpu"),
                           _tree(jsrc))
    state_from_jax(tsrc, jax.tree_util.tree_map(np.asarray, jsrc.state))
    jn, tn = _edit_mln(JAX, jsrc), _edit_mln(PORT, tsrc)
    assert tn.conf.to_json() == jn.conf.to_json()
    assert [type(lc).__name__ for lc in tn.conf.layers] == \
        ["FrozenLayer", "FrozenLayer", "DenseLayer", "OutputLayer"]
    # retained layers carry the source's params; fresh ones are fresh
    np.testing.assert_array_equal(tn.params["layer_0"]["W"].detach().numpy(),
                                  np.asarray(jsrc.params["layer_0"]["W"]))
    assert tuple(tn.params["layer_2"]["W"].shape) == (6, 7)
    params_from_jax(tn, _tree(jn))
    frozen = {k: {n: p.detach().clone() for n, p in tn.params[k].items()}
              for k in ("layer_0", "layer_1")}
    x2, y2 = _data(rng, 8, 2)
    for _ in range(3):
        jn.fit(x2, y2)
        tn.fit(x2, y2)
        np.testing.assert_allclose(tn.get_score(), jn.get_score(),
                                   rtol=RTOL)
    _close(tn, jn, exact=("layer_0", "layer_1"))
    for k, g in frozen.items():
        for n, p in g.items():
            assert torch.equal(tn.params[k][n], p)
    assert torch.equal(tn.state["layer_1"]["mean"],
                       torch.tensor(np.asarray(jsrc.state["layer_1"]["mean"])))


def test_transfer_learning_helper_matches_jax():
    rng = np.random.default_rng(1)
    x, y = _data(rng, 8, 3)
    jsrc = JMLN(_mln(JAX)).init()
    tsrc = params_from_jax(MultiLayerNetwork(_mln(PORT), device="cpu"),
                           _tree(jsrc))
    jn = JTL.Builder(jsrc).set_feature_extractor(1).build()
    tn = TransferLearning.Builder(tsrc).set_feature_extractor(1).build()
    params_from_jax(tn, _tree(jn))
    jh, th = JTLH(jn), TransferLearningHelper(tn)
    assert th.frozen_until == jh.frozen_until == 1
    jf, tf = np.asarray(jh.featurize(x)), th.featurize(x)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=RTOL, atol=ATOL)
    jh.fit_featurized(jf, y, epochs=2)
    th.fit_featurized(tf, y, epochs=2)
    _close(tn, jn, exact=("layer_0", "layer_1"))
    assert isinstance(tn.conf.layers[0], FrozenLayer)


def _graph(m):
    g = (m["nnc"].builder().seed(4).activation("relu")
         .updater(m["upd"].Sgd(learning_rate=0.1)).graph_builder())
    g.add_inputs("in").set_input_types(m["it"].feed_forward(4))
    g.add_layer("h1", m["ff"].DenseLayer(n_out=6), "in")
    g.add_layer("bn", m["norm"].BatchNormalization(), "h1")
    g.add_layer("h2", m["ff"].DenseLayer(n_out=5), "bn")
    g.add_layer("out", m["ff"].OutputLayer(n_out=3, activation="softmax",
                                           loss="mcxent"), "h2")
    return g.set_outputs("out").build()


def _edit_graph(m, net):
    return (m["tl"].GraphBuilder(net)
            .fine_tune_configuration(updater=m["upd"].Nadam(learning_rate=0.01))
            .set_feature_extractor("bn")
            .remove_vertex_and_connections("out")
            .add_layer("out", m["ff"].OutputLayer(n_out=2, activation="softmax",
                                                  loss="mcxent"), "h2")
            .set_outputs("out")
            .build())


def test_graph_transfer_learning_matches_jax():
    rng = np.random.default_rng(2)
    x, y = _data(rng, 8, 3)
    jsrc = JCG(_graph(JAX)).init()
    jsrc.fit(x, y)
    tsrc = params_from_jax(ComputationGraph(_graph(PORT), device="cpu"),
                           _tree(jsrc))
    state_from_jax(tsrc, jax.tree_util.tree_map(np.asarray, jsrc.state))
    jn, tn = _edit_graph(JAX, jsrc), _edit_graph(PORT, tsrc)
    assert tn.conf.to_json() == jn.conf.to_json()
    assert tn._tx.labels["h1"] == {"W": "frozen", "b": "frozen"}
    assert tuple(tn.params["out"]["W"].shape) == (5, 2)
    params_from_jax(tn, _tree(jn))
    before = {k: {n: p.detach().clone() for n, p in tn.params[k].items()}
              for k in ("h1", "bn")}
    bn_state = {n: t.clone() for n, t in tn.state["bn"].items()}
    x2, y2 = _data(rng, 8, 2)
    for _ in range(3):
        jn.fit(x2, y2)
        tn.fit(x2, y2)
        np.testing.assert_allclose(tn.get_score(), jn.get_score(),
                                   rtol=RTOL)
    _close(tn, jn, exact=("h1", "bn"))
    for k, g in before.items():
        for n, p in g.items():
            assert torch.equal(tn.params[k][n], p)
    for n, t in bn_state.items():        # frozen BN: running stats fixed
        assert torch.equal(tn.state["bn"][n], t)
