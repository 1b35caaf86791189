"""``nn/fold.fold_batch_norms`` and the ``nn/conf/modules`` blocks against
the JAX package: the same blocks build the same configuration JSON; a
network folded by the port holds the JAX fold's params bit for bit (both
fold in float64 and round to f32), its configuration has the JAX fold's
layers, and its outputs agree with the JAX fold's and with the unfolded
network's within ``ATOL_FOLD``.  f32 on the CPU.
"""
import jax
import numpy as np
import pytest

from deeplearning4j_tpu.nn.computation_graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.conf import computation_graph as jcg
from deeplearning4j_tpu.nn.conf import modules as jmod
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.updaters import Nesterovs as JNesterovs
from deeplearning4j_tpu.nn.fold import fold_batch_norms as jfold
from deeplearning4j_tpu.nn.layers import convolution as jconv
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.layers import pooling as jpool
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf import computation_graph as tcg
from deeplearning4j_tpu_torch.nn.conf import modules as tmod
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.updaters import Nesterovs
from deeplearning4j_tpu_torch.nn.fold import fold_batch_norms
from deeplearning4j_tpu_torch.nn.layers import feedforward as tff
from deeplearning4j_tpu_torch.nn.layers import pooling as tpool
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.model_serializer import (params_from_jax,
                                                             state_from_jax)

# A folded conv sums W*scale products where the unfolded net sums W
# products and then scales: f32 reassociation through a few layers, 1e-5
# abs at outputs of order 1 (the JAX package validates its fold the same
# way).
ATOL_FOLD = 1e-5


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_state(jnet, seed):
    """Running statistics other than the initial 0/1, the same on both
    sides."""
    rng = np.random.default_rng(seed)
    jnet.state = {k: {"mean": (rng.standard_normal(np.shape(g["mean"])) * 0.3)
                      .astype(np.float32),
                      "var": rng.uniform(0.5, 2.0, np.shape(g["var"]))
                      .astype(np.float32)} if "mean" in g else g
                  for k, g in jnet.state.items()}
    jnet.params = {k: {n: (np.asarray(v) + rng.standard_normal(np.shape(v))
                           .astype(np.float32) * 0.1) if n in ("gamma", "beta")
                       else v for n, v in g.items()}
                   for k, g in jnet.params.items()}
    return jnet


def _port_of(jnet, cls, conf_cls):
    tnet = cls(conf_cls.from_json(jnet.conf.to_json()), device="cpu")
    params_from_jax(tnet, _host(jnet.params))
    return state_from_jax(tnet, _host(jnet.state))


def _check_fold(jnet, tnet, xs):
    jf, tf = jfold(jnet), fold_batch_norms(tnet)
    assert tf is not tnet
    for k, g in jf.params.items():
        assert sorted(g) == sorted(tf.params[k]) if k in tf.params else \
            not g, k
        for n, a in g.items():
            assert np.array_equal(np.asarray(a), tf.params[k][n].detach()
                                  .numpy()), (k, n)
    assert {k: sorted(g) for k, g in jf.state.items() if g} == \
        {k: sorted(g) for k, g in tf.state.items() if g}
    jy = np.asarray(jf.output(*xs))
    ty = tf.output(*xs).numpy()
    np.testing.assert_allclose(ty, jy, atol=ATOL_FOLD, rtol=0)
    np.testing.assert_allclose(ty, tnet.output(*xs).numpy(), atol=ATOL_FOLD,
                               rtol=0)
    return jf, tf


def test_fold_mln_matches_jax():
    conf = (JNNC.builder().seed(3).updater(JNesterovs(learning_rate=0.1))
            .list()
            .layer(jconv.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                          convolution_mode="same",
                                          activation="identity",
                                          has_bias=False))
            .layer(jnorm.BatchNormalization(activation="relu"))
            .layer(jconv.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(jnorm.BatchNormalization())          # after a pool: kept
            .layer(jff.DenseLayer(n_out=6, activation="identity"))
            .layer(jnorm.BatchNormalization(activation="tanh"))
            .layer(jff.DenseLayer(n_out=5, activation="relu"))
            .layer(jnorm.BatchNormalization())          # nonlinear prev: kept
            .layer(jff.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(JIT.convolutional(6, 6, 2)).build())
    jnet = _random_state(JMLN(conf).init(), 1)
    tnet = _port_of(jnet, MultiLayerNetwork, MultiLayerConfiguration)
    x = np.random.default_rng(2).standard_normal((4, 6, 6, 2)).astype(
        np.float32)
    jf, tf = _check_fold(jnet, tnet, [x])
    assert [type(l).__name__ for l in tf.conf.layers] == \
        [type(l).__name__ for l in jf.conf.layers]
    assert [type(l).__name__ for l in tf.conf.layers].count(
        "BatchNormalization") == 2
    assert tf.conf.layers[0].has_bias and tf.conf.layers[1].activation == \
        "relu"
    # the folded copy trains and the original is untouched
    y = np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]
    tf.fit(x, y)
    assert np.isfinite(tf.get_score())
    assert type(tnet.conf.layers[1]).__name__ == "BatchNormalization"


def _block_graph(lib, blocks):
    cg, mod, it = (jcg, jmod, JIT) if lib == "jax" else (tcg, tmod,
                                                         InputType)
    upd = JNesterovs(learning_rate=0.1) if lib == "jax" else \
        Nesterovs(learning_rate=0.1)
    ff = jff if lib == "jax" else tff
    pool = jpool if lib == "jax" else tpool
    g = cg.GraphBuilder({"activation": "relu", "weight_init": "relu",
                         "updater": upd}, seed=9)
    g.add_inputs("in").set_input_types(it.convolutional(8, 8, 3))
    x = "in"
    for i, (name, args, kwargs) in enumerate(blocks):
        x = getattr(mod, name)(*args, **kwargs).add_layers(g, f"blk{i}", x)
    g.add_layer("gap", pool.GlobalPoolingLayer(pooling_type="avg"), x)
    g.add_layer("out", ff.OutputLayer(n_out=3, activation="softmax",
                                      loss="mcxent"), "gap")
    return g.set_outputs("out").build()


BLOCKS = {
    "conv_bn": [("ConvBnBlock", (4,), {"kernel": (3, 3), "stride": (2, 2)}),
                ("ConvBnBlock", (5,), {"activation": "tanh",
                                       "mode": "truncate"})],
    "residual": [("ConvBnBlock", (6,), {}),
                 ("ResidualBlock", ((2, 2, 6),), {}),
                 ("ResidualBlock", ((2, 3, 8),), {"stride": (2, 2),
                                                  "project": True})],
    "inception": [("ConvBnBlock", (4,), {}),
                  ("InceptionBlock", (2, 2, 3, 1, 2, 2), {})],
}


@pytest.mark.parametrize("case", list(BLOCKS))
def test_modules_build_the_jax_graph_and_fold_as_jax(case):
    jconf = _block_graph("jax", BLOCKS[case])
    tconf = _block_graph("torch", BLOCKS[case])
    assert tconf.to_json() == jconf.to_json()
    assert issubclass(tmod.ResidualBlock, tmod.GraphBuilderModule)
    with pytest.raises(NotImplementedError):
        tmod.GraphBuilderModule().add_layers(None, "x", "in")
    jnet = _random_state(JCG(jconf).init(), 5)
    tnet = _port_of(jnet, ComputationGraph,
                    tcg.ComputationGraphConfiguration)
    x = np.random.default_rng(6).standard_normal((3, 8, 8, 3)).astype(
        np.float32)
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=ATOL_FOLD,
                               rtol=0)
    jf, tf = _check_fold(jnet, tnet, [x])
    kinds = {n: type(getattr(v, "layer", v)).__name__
             for n, v in tf.conf.vertices.items()}
    assert kinds == {n: type(getattr(v, "layer", v)).__name__
                     for n, v in jf.conf.vertices.items()}
    assert "BatchNormalization" not in kinds.values()


def test_fold_refuses_other_types():
    with pytest.raises(TypeError, match="cannot fold"):
        fold_batch_norms(type("Other", (), {"clone": lambda self: self})())
