"""The port's convolution, pooling, activation and BatchNormalization
layers, a Dense->BN->Output MultiLayerNetwork and a small residual
ComputationGraph, each against the JAX package on the same inputs and
params (numpy, from a seed).  Everything is float32 on the CPU.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import computation_graph as jcg_net
from deeplearning4j_tpu.nn import weights as jweights
from deeplearning4j_tpu.nn.computation_graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.conf import computation_graph as jcg
from deeplearning4j_tpu.nn.conf.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.conf.multi_layer import NeuralNetConfiguration
from deeplearning4j_tpu.nn.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.nn.layers import convolution as jconv
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.layers import pooling as jpool
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch.nn import computation_graph as tcg_net
from deeplearning4j_tpu_torch.nn.conf import computation_graph as tcg
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.updaters import Sgd
from deeplearning4j_tpu_torch.nn.layers import base as tbase
from deeplearning4j_tpu_torch.nn.layers import convolution as tconv
from deeplearning4j_tpu_torch.nn.layers import feedforward as tff
from deeplearning4j_tpu_torch.nn.layers import normalization as tnorm
from deeplearning4j_tpu_torch.nn.layers import pooling as tpool
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import pallas_bn
from deeplearning4j_tpu_torch.utils.model_serializer import (params_from_jax,
                                                             state_from_jax)

# Conv outputs: f32 sums over kh·kw·c_in <= 147 products of |x|, |w| <~ 3
# in another order (XLA's conv against oneDNN's): 1e-5 abs plus 1e-5
# relative.  Pools are exact (max) or sums of <= 9 terms: 1e-6.
ATOL_CONV, RTOL_CONV, ATOL_POOL = 1e-5, 1e-5, 1e-6
# BN layer (f32): statistics over 64 rows in another order; y, |y| <~ 5,
# within a few ulps: 2e-6 abs; running stats 1e-6 relative.
ATOL_BN, RTOL_STATE = 2e-6, 1e-6
# MLN, 4 Sgd steps at lr 0.05: losses (~1.1, a mean over 64 rows) within
# 1e-5 relative; params move by lr·|g| per step and agree within 1e-5
# abs; running stats within 1e-5 relative.
RTOL_LOSS, ATOL_PARAMS, RTOL_RUNNING = 1e-5, 1e-5, 1e-5
# Small graph, step-0 gradients (f32, 64-256 rows per BN channel): per
# parameter 1e-4 of its largest |g| plus 1e-6 of the net's largest |g|
# (conv biases before a BN have gradient 0 in exact arithmetic: noise).
RTOL_GRAD, ATOL_GRAD_NET = 1e-4, 1e-6


def _jax_apply(layer, params, x, state=None, train=False):
    return layer.apply({"params": jax.tree_util.tree_map(jnp.asarray, params),
                        "state": state or {}}, jnp.asarray(x), train=train)


def _t(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _conv_params(rng, k, cin, cout):
    return {"W": (rng.standard_normal((k, k, cin, cout)) *
                  (2.0 / (k * k * cin)) ** 0.5).astype(np.float32),
            "b": (0.1 * rng.standard_normal(cout)).astype(np.float32)}


# (kernel, stride, mode, padding, dilation, size, c_in, batch)
CONV_CASES = [(7, 2, "same", 0, 1, 16, 3, 2),     # SAME pads (2, 3)
              (7, 2, "same", 0, 1, 224, 3, 1),    # the ResNet50 stem
              (3, 1, "same", 0, 1, 9, 8, 2),
              (3, 2, "same", 0, 1, 8, 8, 2),      # SAME pads (0, 1)
              (1, 2, "same", 0, 1, 9, 8, 2),
              (3, 2, "truncate", 1, 1, 10, 4, 2),
              (5, 1, "truncate", 0, 2, 12, 4, 2)]


@pytest.mark.parametrize("k,s,mode,pad,dil,size,cin,batch", CONV_CASES)
def test_convolution_matches_jax(k, s, mode, pad, dil, size, cin, batch):
    rng = np.random.default_rng(k * 100 + s * 10 + size)
    kw = dict(n_in=cin, n_out=4, kernel_size=(k, k), stride=(s, s),
              padding=(pad, pad), dilation=(dil, dil), convolution_mode=mode,
              activation="identity")
    p = _conv_params(rng, k, cin, 4)
    x = rng.standard_normal((batch, size, size, cin)).astype(np.float32)
    want, _ = _jax_apply(jconv.ConvolutionLayer(**kw), p, x)
    layer = tconv.ConvolutionLayer(**kw)
    got = layer.apply(_t(p), torch.tensor(x))
    assert tuple(got.shape) == want.shape
    it = layer.output_type(InputType.convolutional(size, size, cin))
    assert it.shape(batch) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_CONV,
                               rtol=RTOL_CONV)


def test_same_pads_follow_xla():
    assert tconv.same_pads(224, 7, 2) == (2, 3)
    assert tconv.same_pads(112, 3, 2) == (0, 1)
    assert tconv.same_pads(56, 3, 1) == (1, 1)
    assert tconv.same_pads(56, 1, 2) == (0, 0)


# (type, kernel, stride, mode, size, batch)
POOL_CASES = [("max", 3, 2, "same", 112, 1),   # the ResNet50 pool, (0, 1)
              ("max", 3, 2, "same", 7, 2),
              ("max", 2, 2, "truncate", 7, 2),
              ("avg", 3, 2, "same", 7, 2),     # padded zeros count
              ("avg", 2, 2, "truncate", 8, 2),
              ("sum", 3, 1, "same", 6, 2)]


@pytest.mark.parametrize("pt,k,s,mode,size,batch", POOL_CASES)
def test_subsampling_matches_jax(pt, k, s, mode, size, batch):
    rng = np.random.default_rng(size + k)
    kw = dict(pooling_type=pt, kernel_size=(k, k), stride=(s, s),
              convolution_mode=mode)
    x = rng.standard_normal((batch, size, size, 4)).astype(np.float32)
    want, _ = _jax_apply(jconv.SubsamplingLayer(**kw), {}, x)
    layer = tconv.SubsamplingLayer(**kw)
    got = layer.apply({}, torch.tensor(x))
    assert layer.output_type(InputType.convolutional(size, size, 4)).shape(
        batch) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_POOL,
                               rtol=0)


def test_max_pool_gradient_routes_like_jax():
    rng = np.random.default_rng(5)
    kw = dict(pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
              convolution_mode="same")
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    dy = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    jlayer = jconv.SubsamplingLayer(**kw)
    want = jax.grad(lambda a: jnp.sum(_jax_apply(jlayer, {}, a)[0] * dy))(
        jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    y = tconv.SubsamplingLayer(**kw).apply({}, tx)
    got, = torch.autograd.grad((y * torch.tensor(dy)).sum(), tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_POOL,
                               rtol=0)


@pytest.mark.parametrize("pt", ["avg", "max", "sum", "pnorm"])
def test_global_pooling_and_activation_layer_match_jax(pt):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 5, 5, 6)).astype(np.float32)
    want, _ = _jax_apply(jpool.GlobalPoolingLayer(pooling_type=pt), {}, x)
    got = tpool.GlobalPoolingLayer(pooling_type=pt).apply({},
                                                          torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)
    want, _ = _jax_apply(jff.ActivationLayer(activation="relu"), {}, x)
    layer = tff.ActivationLayer(activation="relu")
    np.testing.assert_array_equal(layer.apply({}, torch.tensor(x)).numpy(),
                                  np.asarray(want))
    assert layer.init(torch.Generator(), None, "cpu") == {}
    # pnorm window pooling, refused before the conv zoo slice, is ported
    want, _ = _jax_apply(jconv.SubsamplingLayer(pooling_type="pnorm"), {}, x)
    got = tconv.SubsamplingLayer(pooling_type="pnorm").apply({},
                                                             torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)


@pytest.mark.parametrize("shape", [(5,), (8, 16), (7, 7, 3, 64),
                                   (3, 3, 64, 128), (5, 4, 16)])
def test_fans_are_the_jax_fans(shape):
    assert tbase._fans(shape) == jweights._fans(shape)


@pytest.mark.parametrize("scheme,shape", [("relu", (3, 3, 64, 128)),
                                          ("relu", (7, 7, 3, 64)),
                                          ("xavier", (3, 3, 64, 128)),
                                          ("xavier", (256, 512))])
def test_weight_init_statistics(scheme, shape):
    layer = tconv.ConvolutionLayer(weight_init=scheme)
    w = layer.make_weight(torch.Generator().manual_seed(0), shape, "cpu")
    fan_in, fan_out = jweights._fans(shape)
    want = (2.0 / fan_in) ** 0.5 if scheme == "relu" else \
        (2.0 / (fan_in + fan_out)) ** 0.5
    # >= 9408 draws: the sample std is within ~1.5% at 2 sigma
    assert abs(w.std().item() / want - 1) < 0.03
    assert abs(w.mean().item()) < 0.05 * want
    # every scheme is ported since the rest-of-training slice: uniform
    # draws within +-sqrt(1/fan_in); a name the JAX package does not know
    # raises there and here
    u = tconv.ConvolutionLayer(weight_init="uniform").make_weight(
        torch.Generator().manual_seed(0), shape, "cpu")
    assert u.abs().max().item() <= (1.0 / fan_in) ** 0.5
    with pytest.raises(ValueError, match="Unknown weight init"):
        tconv.ConvolutionLayer(weight_init="bogus").make_weight(
            torch.Generator(), shape, "cpu")


def test_conv_layer_init_is_hwio():
    layer = tconv.ConvolutionLayer(n_out=8, kernel_size=(3, 5))
    layer.set_n_in(InputType.convolutional(9, 9, 4))
    p = layer.init(torch.Generator().manual_seed(1), None, "cpu")
    assert p["W"].shape == (3, 5, 4, 8) and p["b"].shape == (8,)
    with pytest.raises(ValueError, match="CNN input"):
        tconv.ConvolutionLayer(n_out=8).set_n_in(InputType.feed_forward(4))


@pytest.mark.parametrize("act", ["relu", "identity"])
@pytest.mark.parametrize("helper", [None, "pallas"])
def test_batch_norm_train_and_eval_match_jax(helper, act):
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((4, 4, 4, 32)) * 1.5 + 0.3).astype(np.float32)
    p = {"gamma": rng.standard_normal(32).astype(np.float32),
         "beta": rng.standard_normal(32).astype(np.float32)}
    s = {"mean": (0.1 * rng.standard_normal(32)).astype(np.float32),
         "var": (1 + 0.1 * rng.random(32)).astype(np.float32)}
    kw = dict(n_out=32, activation=act, helper=helper, decay=0.8)
    assert pallas_bn.supports(activation=act, shape=x.shape)
    jlayer, tlayer = jnorm.BatchNormalization(**kw), \
        tnorm.BatchNormalization(**kw)
    jy, jstate = _jax_apply(jlayer, p, x, state=s, train=True)
    ty, tstate = tlayer.forward(_t(p), _t(s), torch.tensor(x), train=True)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=ATOL_BN, rtol=0)
    for k in ("mean", "var"):
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]),
                                   rtol=RTOL_STATE, atol=1e-7)
        assert not tstate[k].requires_grad
    # evaluation normalises with the running statistics
    jy, _ = _jax_apply(jlayer, p, x, state=jax.tree_util.tree_map(
        np.asarray, jstate))
    ty, same = tlayer.forward(_t(p), tstate, torch.tensor(x))
    assert same is tstate
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL_BN,
                               rtol=0)
    st = tlayer.init_state(None, "cpu")
    assert torch.equal(st["mean"], torch.zeros(32)) and \
        torch.equal(st["var"], torch.ones(32))
    with pytest.raises(NotImplementedError):
        tlayer.apply(_t(p), torch.tensor(x))     # BN needs its state


def _jax_mln(helper, width):
    conf = (NeuralNetConfiguration.builder().seed(5).activation("relu")
            .weight_init("xavier").updater(JSgd(learning_rate=0.05))
            .list()
            .layer(jff.DenseLayer(n_out=width))
            .layer(jnorm.BatchNormalization(helper=helper))
            .layer(jff.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(JInputType.feed_forward(8)).build())
    return JMLN(conf).init()


@pytest.mark.parametrize("width", [64, 96])
def test_dense_bn_output_network_trains_like_jax(width):
    """The port's counterpart of the JAX package's
    ``test_pallas_bn_layer_wiring``: width 64 takes the fused path on both
    sides (32 rows per lane tile), width 96 falls back to the unfused
    path; four Sgd steps of each against JAX."""
    rng = np.random.default_rng(2)
    X = rng.standard_normal((64, 8)).astype(np.float32)
    Y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)]
    jn = _jax_mln("pallas", width)
    tn = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jn.conf.to_json()), device="cpu")
    params_from_jax(tn, jax.tree_util.tree_map(np.asarray, jn.params))
    state_from_jax(tn, jax.tree_util.tree_map(np.asarray, jn.state))
    assert tn.layer_confs[1].helper == "pallas"
    assert pallas_bn.supports(activation="relu",
                              shape=(64, width)) == (width == 64)
    for _ in range(4):
        jn.fit(X, Y)
        tn.fit(X, Y)
        np.testing.assert_allclose(tn.get_score(), jn.get_score(),
                                   rtol=RTOL_LOSS)
    for k, group in jn.params.items():
        for n, a in group.items():
            np.testing.assert_allclose(tn.params[k][n].detach().numpy(),
                                       np.asarray(a), atol=ATOL_PARAMS,
                                       rtol=0, err_msg=f"{k}/{n}")
    for n in ("mean", "var"):
        np.testing.assert_allclose(tn.state["layer_1"][n].numpy(),
                                   np.asarray(jn.state["layer_1"][n]),
                                   rtol=RTOL_RUNNING, atol=1e-7)
    np.testing.assert_allclose(tn.output(X).numpy(), np.asarray(jn.output(X)),
                               atol=1e-5, rtol=0)


def _small_graph(pkg, helper="pallas"):
    """A stem conv+BN, one projecting and one identity bottleneck, global
    average pooling and a softmax head, built with either package's
    classes (``pkg``: cg conf module, conv, ff, norm, pool modules,
    InputType, Sgd)."""
    cgc, conv, ff, norm, pool, itype, sgd = pkg
    g = cgc.GraphBuilder({"activation": "relu", "weight_init": "relu",
                          "updater": sgd(learning_rate=0.05)}, seed=3)
    g.add_inputs("in").set_input_types(itype.convolutional(8, 8, 16))

    def conv_bn(name, inp, n_out, k, stride=(1, 1), act="relu"):
        g.add_layer(name, conv.ConvolutionLayer(
            n_out=n_out, kernel_size=(k, k), stride=stride,
            convolution_mode="same", activation="identity"), inp)
        g.add_layer(f"{name}_bn", norm.BatchNormalization(activation=act,
                                                          helper=helper),
                    name)
        return f"{name}_bn"

    def bottleneck(name, inp, stride, project):
        x = conv_bn(f"{name}_a", inp, 16, 1, stride)
        x = conv_bn(f"{name}_b", x, 16, 3)
        x = conv_bn(f"{name}_c", x, 64, 1, act="identity")
        sc = conv_bn(f"{name}_sc", inp, 64, 1, stride, act="identity") \
            if project else inp
        g.add_vertex(f"{name}_add", cgc.ElementWiseVertex(op="add"), x, sc)
        g.add_layer(f"{name}_out", ff.ActivationLayer(activation="relu"),
                    f"{name}_add")
        return f"{name}_out"

    x = conv_bn("stem", "in", 32, 3)
    x = bottleneck("p", x, (2, 2), True)
    x = bottleneck("i", x, (1, 1), False)
    g.add_layer("pool", pool.GlobalPoolingLayer(pooling_type="avg"), x)
    g.add_layer("out", ff.OutputLayer(n_out=5, activation="softmax",
                                      loss="mcxent"), "pool")
    g.set_outputs("out")
    return g.build()


JAX_PKG = (jcg, jconv, jff, jnorm, jpool, JInputType, JSgd)
PORT_PKG = (tcg, tconv, tff, tnorm, tpool, InputType, Sgd)


def test_residual_graph_step0_gradients_match_jax():
    jn = JCG(_small_graph(JAX_PKG)).init()
    conf = tcg.ComputationGraphConfiguration.from_json(jn.conf.to_json())
    built = _small_graph(PORT_PKG)
    assert built.topological_order == jn.conf.topological_order
    tn = tcg_net.ComputationGraph(conf, device="cpu")
    params_from_jax(tn, jax.tree_util.tree_map(np.asarray, jn.params))
    state_from_jax(tn, jax.tree_util.tree_map(np.asarray, jn.state))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 8, 8, 16)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 4)]
    jv, jg = jax.value_and_grad(lambda p: jcg_net._graph_loss(
        jn.conf, p, jn.state, [jnp.asarray(x)], [jnp.asarray(y)],
        train=True, key=jax.random.PRNGKey(0))[0])(jn.params)
    params = tn._param_tree()
    keys = [(k, n) for k in params for n in params[k]]
    tv, new_state = tcg_net._graph_loss(conf, params, tn.state,
                                        [torch.tensor(x)], [torch.tensor(y)],
                                        train=True)
    tg = torch.autograd.grad(tv, [params[k][n] for k, n in keys])
    np.testing.assert_allclose(tv.item(), float(jv), rtol=RTOL_LOSS)
    net_max = max(float(jnp.abs(g).max())
                  for g in jax.tree_util.tree_leaves(jg))
    for (k, n), g in zip(keys, tg):
        want = np.asarray(jg[k][n])
        np.testing.assert_allclose(
            g.numpy(), want, rtol=0, err_msg=f"{k}/{n}",
            atol=RTOL_GRAD * np.abs(want).max() + ATOL_GRAD_NET * net_max)
    # the identity block's input feeds two vertices: its gradient is the
    # sum of both paths, which autograd accumulates
    assert conf.vertex_inputs["i_add"][1] == "p_out"
    assert new_state["stem_bn"]["mean"].shape == (32,)


@pytest.mark.parametrize("op", ["add", "subtract", "product", "average",
                                "max"])
def test_element_wise_vertex_matches_jax(op):
    rng = np.random.default_rng(9)
    n = 2 if op == "subtract" else 3
    xs = [rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
          for _ in range(n)]
    want, _ = jcg.ElementWiseVertex(op=op).apply(
        {"params": {}, "state": {}}, [jnp.asarray(a) for a in xs])
    got, st = tcg.ElementWiseVertex(op=op).forward(
        {}, {}, [torch.tensor(a) for a in xs])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    assert st == {} and tcg.ElementWiseVertex(op=op).n_inputs()[0] == 2


def test_graph_json_the_port_cannot_run_raises():
    jn = JCG(_small_graph(JAX_PKG, helper=None)).init()
    d = json.loads(jn.conf.to_json())
    # every vertex and preprocessor class is ported (the conv zoo slice),
    # and the YOLOv2 head since the pretraining and detection slice: it
    # reads back as itself; a class the port still lacks (a UI chart
    # component) raises when read
    merged = json.loads(json.dumps(d))
    merged["vertices"]["p_add"] = {"@class": "LayerVertex", "layer": {
        "@class": "Yolo2OutputLayer"}}
    read = tcg.ComputationGraphConfiguration.from_json(json.dumps(merged))
    assert type(read.vertices["p_add"].layer).__name__ == "Yolo2OutputLayer"
    merged["vertices"]["p_add"]["layer"] = {"@class": "ChartLine"}
    with pytest.raises(ValueError, match="not ported"):
        tcg.ComputationGraphConfiguration.from_json(json.dumps(merged))
    # every updater is ported since the rest-of-training slice: RmsProp
    # reads back as itself; so does a precision policy since the
    # precision and memory slice, and a pretraining layer's class since
    # the pretraining and detection slice
    pre = json.loads(json.dumps(d))
    pre["vertices"]["stem"]["layer"]["updater"] = {"@class": "RmsProp"}
    read = tcg.ComputationGraphConfiguration.from_json(json.dumps(pre))
    assert type(read.vertices["stem"].layer.updater).__name__ == "RmsProp"
    pre["defaults"]["precision"] = {"@class": "PrecisionPolicy"}
    read = tcg.ComputationGraphConfiguration.from_json(json.dumps(pre))
    assert type(read.defaults["precision"]).__name__ == "PrecisionPolicy"
    pre["vertices"]["stem"]["layer"]["updater"] = {"@class": "AutoEncoder"}
    read = tcg.ComputationGraphConfiguration.from_json(json.dumps(pre))
    assert type(read.vertices["stem"].layer.updater).__name__ == \
        "AutoEncoder"
    # a layer vertex with a preprocessor reshapes before its layer: NHWC
    # flattened in (h, w, c) order
    v = tcg.LayerVertex(layer=tff.ActivationLayer(activation="identity"),
                        preprocessor=tcg.auto_preprocessor(
                            tcg.InputType.convolutional(2, 3, 4),
                            tff.DenseLayer()))
    xi = torch.arange(48.0).reshape(2, 2, 3, 4)
    y, _ = v.forward({}, {}, [xi])
    assert torch.equal(y, xi.reshape(2, 24))
    cyc = tcg.ComputationGraphConfiguration.from_json(json.dumps(d))
    cyc.vertex_inputs["stem"] = ["i_out"]
    with pytest.raises(ValueError, match="cycle"):
        cyc.resolve()
