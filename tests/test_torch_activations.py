"""The port's activation registry and the small API gaps of the
activations slice, against the JAX package: every activation name and
parameterized form, values and gradients in f32 and f64 on a grid that
holds the kinks (0, ±1, ±2.5, 6 and the thresholds), the tie gradients
exactly, the error texts; ``utils/log_once``, ``serde.lookup_class``,
``InputType``'s dict, inference and 3-D kind, ``params_flat`` and
``param_bytes``, ``output_single``, ``n_params``/``has_params``,
``vertex_output_type`` and the ``DL4J_TPU_FLASH_MIN_SEQ`` override.
"""
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import activations as jact
from deeplearning4j_tpu.nn.computation_graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.conf import computation_graph as jcg
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.utils import log_once as jlog_once
from deeplearning4j_tpu.utils import serde as jserde
from deeplearning4j_tpu_torch.nn import activations as tact
from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf import computation_graph as tcg
from deeplearning4j_tpu_torch.nn.conf.computation_graph import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import feedforward as tff
from deeplearning4j_tpu_torch.nn.layers import misc as tmisc
from deeplearning4j_tpu_torch.nn.layers import recurrent as trec
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils import log_once as tlog_once
from deeplearning4j_tpu_torch.utils import serde as tserde
from deeplearning4j_tpu_torch.utils.model_serializer import params_from_jax

# The grid: the kinks of every function (relu/leaky at 0, hardtanh at ±1,
# hardsigmoid at ±2.5, relu6 at 6, thresholdedrelu at 1 and the
# parameterized thresholds 0.5 and -0.25) and points between them.
GRID = np.array([-8, -6, -3, -2.5, -2, -1.5, -1, -0.7, -0.5, -0.25, -1e-3,
                 0, 1e-3, 0.25, 0.5, 0.7, 1, 1.5, 2, 2.5, 3, 5.5, 6, 6.5,
                 8])
PARAMETERIZED = ["leakyrelu:0.3", "lrelu:0.2", "elu:0.7",
                 "thresholdedrelu:0.5", "thresholdedrelu:-0.25"]
ALL = tact.names() + PARAMETERIZED
# The port writes each function as the JAX composition; transcendental
# kernels (exp, tanh, log1p) of the two libraries round differently by a
# few ulps.  Gradients are taken of sum(f(x) * w), w = 1..25: ~25 x a few
# ulps of terms of order 1.
TOL = {np.float32: (1e-6, 5e-5), np.float64: (1e-14, 2e-13)}


def _value_and_grad(fn, x, w, lib):
    if lib == "jax":
        xj = jnp.asarray(x)
        v = np.asarray(fn(xj))
        g = np.asarray(jax.grad(lambda a: jnp.sum(fn(a) * w))(xj))
        return v, g
    xt = torch.tensor(x, requires_grad=True)
    y = fn(xt)
    assert y.dtype == xt.dtype
    (y * torch.from_numpy(w)).sum().backward()
    return y.detach().numpy(), xt.grad.numpy()


def test_registry_has_every_jax_name():
    assert tact.names() == jact.names()
    assert sorted(tact._PARAMETERIZED) == sorted(jact._PARAMETERIZED)
    for name in ALL:
        assert callable(tact.get(name.upper()))


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", ALL)
def test_activation_values_and_gradients_match_jax(name, dtype):
    x = GRID.astype(dtype)
    if name in ("softmax", "logsoftmax"):
        x = np.stack([x, x[::-1] * 0.5])
    w = np.arange(1, x.size + 1, dtype=dtype).reshape(x.shape)
    jv, jg = _value_and_grad(jact.get(name), x, w, "jax")
    tv, tg = _value_and_grad(tact.get(name), x, w, "torch")
    tol_v, tol_g = TOL[dtype]
    np.testing.assert_allclose(tv, jv, atol=tol_v, rtol=tol_v)
    np.testing.assert_allclose(tg, jg, atol=tol_g, rtol=tol_g)


# (name, x, the gradient JAX gives there): ties of minimum/maximum split
# 0.5/0.5 (torch.clamp would give 1, F.hardtanh 0, F.relu6 0; at ±2.5
# hardsigmoid's tie gives 0.5 x its slope 0.2, rounded in the dtype),
# leaky_relu's where(x >= 0) gives 1 at 0 (F.leaky_relu gives the slope),
# strict thresholds give 0 at the threshold.
TIES = [("hardtanh", 1.0, 0.5), ("hardtanh", -1.0, 0.5),
        ("hardsigmoid", 2.5, (0.5, 0.2)), ("hardsigmoid", -2.5, (0.5, 0.2)),
        ("relu6", 6.0, 0.5), ("relu", 0.0, 0.0), ("leakyrelu", 0.0, 1.0),
        ("leakyrelu:0.3", 0.0, 1.0), ("rrelu", 0.0, 1.0),
        ("thresholdedrelu", 1.0, 0.0), ("thresholdedrelu:0.5", 0.5, 0.0),
        ("elu", 0.0, 1.0), ("softsign", 0.0, 1.0)]


@pytest.mark.parametrize("name,x0,want", TIES,
                         ids=[f"{n}@{x}" for n, x, _ in TIES])
def test_tie_gradients_are_jaxs_exactly(name, x0, want):
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.float64, jnp.float64)):
        exact = want if not isinstance(want, tuple) else \
            (torch.tensor(want[1], dtype=dt) * want[0]).item()
        x = torch.tensor([x0], dtype=dt, requires_grad=True)
        tact.get(name)(x).sum().backward()
        assert x.grad.item() == exact
        jg = jax.grad(lambda a: jnp.sum(jact.get(name)(a)))(
            jnp.asarray([x0], jdt))
        assert float(jg[0]) == exact


@pytest.mark.parametrize("bad", ["bogus", "leakyrelu:abc", "foo:0.3"])
def test_error_texts_are_the_jax_ones(bad):
    with pytest.raises(ValueError) as jerr:
        jact.get(bad)
    with pytest.raises(ValueError) as terr:
        tact.get(bad)
    assert str(terr.value) == str(jerr.value)
    assert ("Unknown" in str(terr.value)) or ("Bad parameter" in
                                              str(terr.value))


def test_register_and_register_parameterized():
    tact.register("halve_for_test")(lambda x: x * 0.5)
    tact.register_parameterized("scale_for_test")(lambda a: lambda x: a * x)
    try:
        assert "halve_for_test" in tact.names()
        assert tact.get("HALVE_FOR_TEST")(torch.tensor(4.0)).item() == 2.0
        assert tact.get("scale_for_test:3")(torch.tensor(2.0)).item() == 6.0
    finally:
        tact._REGISTRY.pop("halve_for_test")
        tact._PARAMETERIZED.pop("scale_for_test")


def test_log_once_and_lookup_class(caplog):
    logger = logging.getLogger("dl4j_torch_log_once_test")
    for mod in (tlog_once, jlog_once):
        mod.reset_once()
        with caplog.at_level(logging.INFO, logger=logger.name):
            got = [mod.warn_once(logger, "w %d", 1),
                   mod.warn_once(logger, "w %d", 1),
                   mod.info_once(logger, "w %d", 1)]
        assert got == [True, False, True]
        mod.reset_once()
        assert mod.warn_once(logger, "w %d", 1)
    assert [r.getMessage() for r in caplog.records].count("w 1") == 6
    assert tserde.lookup_class("InputType") is InputType
    assert tserde.lookup_class("LSTM") is trec.LSTM
    assert tserde.lookup_class("NoSuchClass") is None
    assert jserde.lookup_class("NoSuchClass") is None


def test_input_type_dict_infer_and_3d_match_jax():
    cases = [((2, 5), False), ((2, 7, 3), False), ((2, 6, 5, 3), False),
             ((2, 4, 6, 5, 3), False), ((2, 7, 3), True)]
    for shape, rec in cases:
        x = np.zeros(shape, np.float32)
        ti, ji = InputType.infer(x, rec), JIT.infer(x, rec)
        assert ti.to_dict() == ji.to_dict()
        assert InputType.infer(torch.zeros(shape), rec) == ti
        assert InputType.from_dict(ji.to_dict()) == ti
        assert ti.shape(4) == ji.shape(4)
        assert ti.flat_size() == ji.flat_size()
    with pytest.raises(ValueError, match="recurrent"):
        InputType.infer(np.zeros((2, 3)), True)
    with pytest.raises(ValueError, match="cannot infer"):
        InputType.infer(np.zeros((2,)))
    t3, j3 = InputType.convolutional_3d(4, 6, 5, 3), \
        JIT.convolutional_3d(4, 6, 5, 3)
    assert t3.to_dict() == j3.to_dict() and t3.flat_size() == 360


def _nets():
    """A Dense -> BN -> LSTM -> RnnOutput stack, JAX and port, same
    params."""
    jconf = (JNNC.builder().seed(4).updater(JSgd(learning_rate=0.1)).list()
             .layer(jff.DenseLayer(n_out=6, activation="tanh"))
             .layer(jnorm.BatchNormalization())
             .layer(jrec.LSTM(n_out=5, activation="tanh"))
             .layer(jrec.RnnOutputLayer(n_out=3, activation="softmax",
                                        loss="mcxent"))
             .set_input_type(JIT.recurrent(4, 3)).build())
    jnet = JMLN(jconf).init()
    tnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu")
    params_from_jax(tnet, jax.tree_util.tree_map(np.asarray, jnet.params))
    return jnet, tnet


def test_params_flat_and_param_bytes_match_jax():
    jnet, tnet = _nets()
    np.testing.assert_array_equal(tnet.params_flat(), jnet.params_flat())
    assert tnet.param_bytes() == jnet.param_bytes() == \
        tnet.param_bytes(per_device=True) == \
        jnet.param_bytes(per_device=True)
    assert tnet.param_bytes() == 4 * tnet.num_params()


def test_n_params_and_has_params_match_jax():
    jnet, tnet = _nets()
    for jl, tl, it in zip(jnet.conf.layers, tnet.conf.layers,
                          tnet.conf.layer_input_types):
        assert tl.has_params() == jl.has_params()
        jit_ = JIT.from_dict(it.to_dict())
        assert tl.n_params(it) == jl.n_params(jit_)
    assert not tff.ActivationLayer().has_params()
    assert not tff.LossLayer().has_params()
    assert tff.DenseLayer(n_in=3, n_out=2).n_params(
        InputType.feed_forward(3)) == 8
    lts = trec.LastTimeStep(underlying=trec.LSTM(n_in=2, n_out=3))
    assert lts.has_params()
    assert tmisc.FrozenLayer(underlying=tff.ActivationLayer()).has_params() \
        is False
    assert trec.Bidirectional(fwd=trec.LSTM(n_in=2, n_out=3)).has_params()


def _graph(lib):
    cg = jcg if lib == "jax" else tcg
    ff = jff if lib == "jax" else tff
    it = JIT if lib == "jax" else InputType
    g = cg.GraphBuilder({"updater": JSgd(learning_rate=0.1)}
                        if lib == "jax" else {}, seed=2)
    g.add_inputs("in").set_input_types(it.feed_forward(4))
    g.add_layer("a", ff.DenseLayer(n_out=5, activation="relu"), "in")
    g.add_layer("b", ff.DenseLayer(n_out=5, activation="tanh"), "in")
    g.add_vertex("m", cg.MergeVertex(), "a", "b")
    g.add_layer("out", ff.OutputLayer(n_out=3, activation="softmax",
                                      loss="mcxent"), "m")
    return g.set_outputs("out").build()


def test_graph_output_single_vertex_output_type_and_flat_params():
    jn = JCG(_graph("jax")).init()
    tn = ComputationGraph(ComputationGraphConfiguration.from_json(
        jn.conf.to_json()), device="cpu")
    params_from_jax(tn, jax.tree_util.tree_map(np.asarray, jn.params))
    x = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    np.testing.assert_allclose(tn.output_single(x).numpy(),
                               np.asarray(jn.output_single(x)), atol=1e-6)
    for name in ("a", "m", "out"):
        assert tn.conf.vertex_output_type(name).to_dict() == \
            jn.conf.vertex_output_type(name).to_dict()
    assert tn.conf.vertex_output_type("nope") is None
    order = tn.conf.topological_order
    want = np.concatenate([np.asarray(jn.params[k][n]).reshape(-1)
                           for k in order for n in sorted(jn.params[k])])
    np.testing.assert_array_equal(tn.params_flat(), want)
    assert tn.param_bytes() == jn.param_bytes()
    # two outputs: output_single refuses, as in JAX
    conf = tn.conf
    conf.network_outputs = ["out", "a"]
    two = ComputationGraph(conf, device="cpu").init()
    with pytest.raises(ValueError, match="multi-output"):
        two.output_single(x)


def test_flash_min_seq_override_is_read_from_the_environment():
    code = ("from deeplearning4j_tpu_torch.nn.layers import attention as a; "
            "print(a.DEFAULT_FLASH_MIN_SEQ)")
    env = dict(os.environ, DL4J_TPU_FLASH_MIN_SEQ="4096",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "4096"
    from deeplearning4j_tpu_torch.nn.layers import attention as tatt
    if "DL4J_TPU_FLASH_MIN_SEQ" not in os.environ:
        assert tatt.DEFAULT_FLASH_MIN_SEQ == 128
