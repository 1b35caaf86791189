"""The port's Keras export, the zoo's Keras-HDF5 branch and the VGG16
helpers against the JAX package: ``export_keras_sequential``/
``export_keras_model`` of a net loaded from a JAX ``write_model`` zip give
the JAX export's bytes; ``import_pretrained`` (and ``pretrained``'s HDF5
branch) transplants a JAX-written Keras file onto the zoo model with the
JAX params and outputs, and raises the JAX texts on a mismatch;
``VGG16Helper`` and ``ImageNetLabels`` preprocess and decode as the JAX
ones.  All f32 on the CPU.
"""
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import modelimport as jmi
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.computation_graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.conf import computation_graph as jcg
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.nn.layers import convolution as jconv
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.layers import pooling as jpool
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.utils.model_serializer import write_model
from deeplearning4j_tpu_torch import modelimport as tmi
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.model_serializer import (
    load_reference_model, params_from_jax)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_keras_files import (ATOL_OUT, assert_params_bit_equal,  # noqa: E402
                               dense, first, keras_file, randn, zeros)


def _jax_mln(seed=8):
    conf = (JNNC.builder().seed(seed).updater(JAdam(learning_rate=0.05))
            .list()
            .layer(jconv.ConvolutionLayer(n_out=3, kernel_size=(3, 3),
                                          convolution_mode="same",
                                          activation="relu"))
            .layer(jnorm.BatchNormalization())
            .layer(jconv.SubsamplingLayer(pooling_type="avg",
                                          kernel_size=(2, 2),
                                          stride=(2, 2)))
            .layer(jff.DenseLayer(n_out=6, activation="tanh"))
            .layer(jff.DropoutLayer(dropout=0.8))
            .layer(jff.ActivationLayer(activation="hardsigmoid"))
            .layer(jff.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(JIT.convolutional(6, 6, 2)).build())
    return JMLN(conf).init()


def _jax_rnn_mln():
    conf = (JNNC.builder().seed(4).list()
            .layer(jrec.SimpleRnn(n_out=4, activation="tanh"))
            .layer(jrec.LSTM(n_out=5, activation="tanh",
                             gate_activation="hardsigmoid"))
            .layer(jpool.GlobalPoolingLayer(pooling_type="max"))
            .layer(jff.OutputLayer(n_out=2, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(JIT.recurrent(3, 6)).build())
    return JMLN(conf).init()


def _jax_graph():
    g = jcg.GraphBuilder({"updater": JAdam(learning_rate=0.02)}, seed=5)
    g.add_inputs("inp").set_input_types(JIT.feed_forward(4))
    g.add_layer("a", jff.DenseLayer(n_out=6, activation="relu"), "inp")
    g.add_layer("b", jff.DenseLayer(n_out=6, activation="tanh"), "inp")
    g.add_layer("bn", jnorm.BatchNormalization(), "b")
    g.add_vertex("add", jcg.ElementWiseVertex(op="add"), "a", "bn")
    g.add_vertex("cat", jcg.MergeVertex(), "add", "a")
    g.add_vertex("mx", jcg.ElementWiseVertex(op="max"), "a", "bn")
    g.add_vertex("cat2", jcg.MergeVertex(), "cat", "mx")
    g.add_layer("out", jff.OutputLayer(n_out=3, activation="softmax",
                                       loss="mcxent"), "cat2")
    g.set_outputs("out")
    return JCG(g.build()).init()


# (the JAX net, its export entry point, an input batch's shape)
EXPORTS = {"mln_cnn": (_jax_mln, "seq", (3, 6, 6, 2)),
           "mln_rnn": (_jax_rnn_mln, "seq", (3, 6, 3)),
           "graph": (_jax_graph, "graph", (3, 4))}


@pytest.mark.parametrize("case", list(EXPORTS))
def test_export_of_a_jax_zip_gives_the_jax_export_bytes(case, tmp_path):
    make, kind, shape = EXPORTS[case]
    jnet = make()
    rng = np.random.default_rng(2)
    # moving statistics other than the initial 0/1
    jnet.state = {k: {n: np.asarray(v) + rng.uniform(0.1, 0.5, np.shape(v))
                      .astype(np.float32) for n, v in g.items()}
                  for k, g in jnet.state.items()}
    zpath = tmp_path / "net.zip"
    write_model(jnet, str(zpath))
    tnet = load_reference_model(str(zpath), device="cpu")
    jexp = jmi.export_keras_sequential if kind == "seq" \
        else jmi.export_keras_model
    texp = tmi.export_keras_sequential if kind == "seq" \
        else tmi.export_keras_model
    want = jexp(jnet)
    got = texp(tnet, str(tmp_path / "net.h5"))
    assert got == want
    assert (tmp_path / "net.h5").read_bytes() == want
    # and the port imports its own export back to the same function
    back = tmi.import_keras_model(got, device="cpu")
    x = rng.standard_normal(shape).astype(np.float32)
    np.testing.assert_allclose(first(back.output(x)).numpy(),
                               first(tnet.output(x)).numpy(),
                               atol=ATOL_OUT, rtol=0)


def test_export_refusals_are_the_jax_ones():
    jconf = (JNNC.builder().list()
             .layer(jff.DenseLayer(n_out=3, activation="cube"))
             .layer(jff.OutputLayer(n_out=2, activation="softmax"))
             .set_input_type(JIT.feed_forward(4)).build())
    jnet = JMLN(jconf).init()
    tnet = params_from_jax(MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu"),
        jax.tree_util.tree_map(np.asarray, jnet.params))
    with pytest.raises(ValueError) as jerr:
        jmi.export_keras_sequential(jnet)
    with pytest.raises(ValueError) as terr:
        tmi.export_keras_sequential(tnet)
    assert str(terr.value) == str(jerr.value)


# -------------------------------------------------------------------- zoo
def test_import_pretrained_transplants_a_jax_written_file(tmp_path):
    kw = dict(num_classes=4, input_shape=(8, 8, 3))
    src = jzoo.SimpleCNN(**kw).init()
    rng = np.random.default_rng(11)
    src.state = {k: {n: np.asarray(v) + rng.uniform(0.1, 0.5, np.shape(v))
                     .astype(np.float32) for n, v in g.items()}
                 for k, g in src.state.items()}
    path = tmp_path / "simplecnn.h5"
    jmi.export_keras_sequential(src, str(path))
    jnet = jzoo.SimpleCNN(**kw).import_pretrained(str(path))
    tnet = tzoo.SimpleCNN(**kw).import_pretrained(str(path), device="cpu")
    assert_params_bit_equal(jnet, tnet)
    assert type(tnet.conf.defaults["updater"]).__name__ == "Adam"
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=ATOL_OUT)
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(src.output(x)), atol=ATOL_OUT)
    # the pretrained() HDF5 branch takes the same path
    again = tzoo.SimpleCNN(**kw).pretrained(str(path), device="cpu")
    np.testing.assert_array_equal(again.output(x).numpy(),
                                  tnet.output(x).numpy())


def _mismatch_files(tmp_path):
    rng = np.random.default_rng(12)
    files = {}
    # fewer layers than the zoo model
    files["count"] = keras_file([dense("d", 4, "softmax", [8 * 8 * 3])], {
        "d": {"kernel": randn(rng, 192, 4), "bias": zeros(4)}})
    # the zoo's layer count, a Dense where the zoo has a convolution
    kw = dict(num_classes=4, input_shape=(8, 8, 3))
    src = jzoo.SimpleCNN(**kw).init()
    good = jmi.export_keras_sequential(src)
    cfg = json.loads(jmi.Hdf5File(good).attrs["model_config"])
    files["shape"] = jmi.export_keras_sequential(
        jzoo.SimpleCNN(num_classes=5, input_shape=(8, 8, 3)).init())
    out = {}
    for name, data in files.items():
        p = tmp_path / f"{name}.h5"
        p.write_bytes(data)
        out[name] = str(p)
    assert cfg["class_name"] == "Sequential"
    return out


def test_transplant_mismatch_raises_the_jax_texts(tmp_path):
    kw = dict(num_classes=4, input_shape=(8, 8, 3))
    for name, path in _mismatch_files(tmp_path).items():
        with pytest.raises(ValueError) as jerr:
            jzoo.SimpleCNN(**kw).import_pretrained(path)
        with pytest.raises(ValueError) as terr:
            tzoo.SimpleCNN(**kw).import_pretrained(path, device="cpu")
        assert str(terr.value) == str(jerr.value), name
        assert "transplant" in str(terr.value)


def test_vgg16_helpers_match_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(13)
    img8 = rng.integers(0, 256, (2, 5, 5, 3)).astype(np.uint8)
    unit = rng.random((5, 5, 3)).astype(np.float32)
    for images in (img8, unit):
        np.testing.assert_array_equal(
            tmi.VGG16Helper.preprocess(images),
            jmi.VGG16Helper.preprocess(images))
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(f"label {i}" for i in range(1000)) + "\n")
    probs = rng.random((3, 1000)).astype(np.float32)
    for path in (None, str(labels)):
        tl, jl = tmi.ImageNetLabels(path), jmi.ImageNetLabels(path)
        assert len(tl) == len(jl) == 1000
        want = jl.decode_predictions(probs, top=5)
        assert tl.decode_predictions(probs, top=5) == want
        assert tl.decode_predictions(torch.from_numpy(probs), top=5) == want
        assert tl.decode_predictions(probs[0], top=3) == \
            jl.decode_predictions(probs[0], top=3)
    monkeypatch.setenv("IMAGENET_LABELS", str(labels))
    assert tmi.ImageNetLabels().get_label(7) == "label 7"
    assert isinstance(tmi.TrainedModels.VGG16, tmi.VGG16Helper)
    assert tmi.VGG16Helper.input_shape == (224, 224, 3)
    # predict_and_decode over a small imported RGB net
    data = keras_file([
        {"class_name": "Conv2D", "config": {
            "name": "conv", "filters": 4, "kernel_size": [3, 3],
            "padding": "same", "activation": "relu",
            "batch_input_shape": [None, 8, 8, 3]}},
        {"class_name": "GlobalAveragePooling2D", "config": {"name": "gap"}},
        dense("out", 6, "softmax")], {
        "conv": {"kernel": randn(rng, 3, 3, 3, 4, scale=0.01),
                 "bias": zeros(4)},
        "out": {"kernel": randn(rng, 4, 6, scale=0.05), "bias": zeros(6)}})
    path = tmp_path / "convnet.h5"
    path.write_bytes(data)
    net = tmi.VGG16Helper().build_network(str(path), device="cpu")
    x = rng.integers(0, 256, (2, 8, 8, 3)).astype(np.float32)
    got = tmi.VGG16Helper().predict_and_decode(net, x, top=2)
    jnet = jmi.import_keras_model(data)
    want = jmi.VGG16Helper().predict_and_decode(jnet, x, top=2)
    assert [[lab for lab, _ in row] for row in got] == \
        [[lab for lab, _ in row] for row in want]
    for grow, wrow in zip(got, want):
        np.testing.assert_allclose([p for _, p in grow],
                                   [p for _, p in wrow], atol=ATOL_OUT)


def test_modelimport_modules_are_in_the_port():
    import deeplearning4j_tpu_torch.modelimport as m
    assert sorted(m.__all__) == sorted(jmi.__all__)
    for name in m.__all__:
        assert getattr(m, name).__module__.startswith(
            "deeplearning4j_tpu_torch.modelimport")
