"""The port's ``modelimport/`` against the JAX package's, on files the JAX
package's own writer wrote (no fixture is downloaded; h5py is on neither
machine): the HDF5 reader returns the JAX reader's datasets and
attributes, the writer writes the JAX writer's bytes, and every Keras
layer mapper imports to params bit-equal to the JAX importer's with
outputs within ``ATOL_OUT`` and one ``fit`` step within ``RTOL_LOSS``/
``ATOL_STEP``, with the JAX importer's errors.  All f32 on the CPU.
(Export, the zoo's transplant and the VGG16 helpers:
``tests/test_torch_keras_export_zoo.py``.)
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import modelimport as jmi
from deeplearning4j_tpu.modelimport import keras as jkeras
from deeplearning4j_tpu_torch import modelimport as tmi
from deeplearning4j_tpu_torch.modelimport import keras as tkeras
from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import feedforward as tff
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_keras_files import (ATOL_OUT, assert_params_bit_equal,  # noqa: E402
                               dense, first, host_params, keras_file, randn,
                               zeros)

# One Sgd(0.01) step from bit-equal params: the losses are the same sums
# (1e-6 relative); each param moves by lr x a gradient that agrees to a
# few f32 ulps of its largest term, well inside 1e-5 of the leaf's scale.
RTOL_LOSS, ATOL_STEP = 1e-6, 1e-5


# ------------------------------------------------------------------ HDF5
def _tree(rng):
    return {
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "f64": rng.standard_normal((2, 2, 2)),
        "i8": np.arange(-3, 3, dtype=np.int8),
        "u8": np.arange(6, dtype=np.uint8).reshape(2, 3),
        "i16": np.arange(4, dtype=np.int16),
        "i32": np.arange(12, dtype=np.int32).reshape(3, 4),
        "u32": np.arange(5, dtype=np.uint32),
        "i64": np.arange(5, dtype=np.int64),
        "scalar": np.float32(2.5),
        "grp": {"nested": np.ones((2,), np.float32),
                "deeper": {"leaf": np.zeros((1, 1), np.float64)}},
        "chunked": (rng.standard_normal((10, 7)).astype(np.float32), {},
                    (4, 3), None),
        "gzipped": (rng.standard_normal((10, 7)).astype(np.float32),
                    {"unit": "m"}, (5, 7), 6),
        "gz3d": (rng.standard_normal((5, 4, 3)), {}, (2, 3, 2), 1),
        "with_attrs": (np.arange(3, dtype=np.float32),
                       {"names": ["a", "bb"], "n": np.int64(7)}),
    }


ATTRS = {"/": {"title": "hello", "names": ["a", "bb", "ccc"],
               "version": np.int32(3), "scale": 2.5, "fixed": b"FIXEDSTR",
               "vec": np.arange(4, dtype=np.float64),
               "mat": np.arange(6, dtype=np.int32).reshape(2, 3)},
         "/grp": {"kind": "group", "empty_list": []},
         "/grp/deeper": {"depth": np.int16(2)}}


def _walk(g, prefix=""):
    out = {}
    for k in sorted(g.keys()):
        node = g[k]
        if hasattr(node, "read"):
            out[prefix + k] = node
        else:
            out.update(_walk(node, f"{prefix}{k}/"))
    return out


def _same_attr(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


def test_reader_returns_what_the_jax_reader_returns():
    data = jmi.Hdf5Writer().write(_tree(np.random.default_rng(0)), ATTRS)
    jf, tf = jmi.Hdf5File(data), tmi.Hdf5File(data)
    assert sorted(tf.keys()) == sorted(jf.keys())
    jd, td = _walk(jf), _walk(tf)
    assert sorted(td) == sorted(jd) and len(td) == 15
    for name in jd:
        a, b = jd[name].read(), td[name].read()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a)
        assert sorted(td[name].attrs) == sorted(jd[name].attrs)
        for k in jd[name].attrs:
            _same_attr(jd[name].attrs[k], td[name].attrs[k])
        assert td[name].shape == jd[name].shape
        np.testing.assert_array_equal(td[name][...], a[...])
    for path in ("/", "grp", "grp/deeper"):
        jg = jf if path == "/" else jf[path]
        tg = tf if path == "/" else tf[path]
        assert sorted(tg.attrs) == sorted(jg.attrs)
        for k in jg.attrs:
            _same_attr(jg.attrs[k], tg.attrs[k])
    assert "grp/nested" in tf and "nope" not in tf
    assert [k for k, _ in tf["grp"].items()] == \
        [k for k, _ in jf["grp"].items()]


def test_reader_reads_a_file_path_and_bytearray(tmp_path):
    data = jmi.Hdf5Writer().write({"a": np.arange(4, dtype=np.float32)})
    p = tmp_path / "a.h5"
    p.write_bytes(data)
    for src in (str(p), bytearray(data)):
        np.testing.assert_array_equal(tmi.Hdf5File(src)["a"].read(),
                                      np.arange(4, dtype=np.float32))


@pytest.mark.parametrize("bad", [b"not an hdf5 file at all............",
                                 b"\x89HDF\r\n\x1a\n" + bytes(8),
                                 b"\x89HDF\r\n\x1a\n\x07" + bytes(40)],
                         ids=["magic", "offsets", "version"])
def test_bad_files_raise_the_jax_classes_and_texts(bad):
    with pytest.raises(jmi.Hdf5FormatError) as jerr:
        jmi.Hdf5File(bad)
    with pytest.raises(tmi.Hdf5FormatError) as terr:
        tmi.Hdf5File(bad)
    assert str(terr.value) == str(jerr.value)
    assert issubclass(tmi.Hdf5FormatError, ValueError)


def test_missing_key_raises_key_error_as_jax():
    data = jmi.Hdf5Writer().write({"a": np.zeros(1, np.float32),
                                   "g": {"b": np.zeros(1, np.float32)}})
    for f in (jmi.Hdf5File(data), tmi.Hdf5File(data)):
        with pytest.raises(KeyError):
            f["nope"]
        with pytest.raises(KeyError):
            f["g/nope"]
        with pytest.raises(KeyError):
            f["a/b"]


WRITER_CASES = {
    "numeric": lambda rng: ({"x": rng.standard_normal((5, 3))}, None),
    "full": lambda rng: (_tree(rng), ATTRS),
    "empty_root": lambda rng: ({}, {"/": {"model_config": "{}"}}),
    "many_strings": lambda rng: (
        {"g": {f"d{i}": (np.float32(i), {"w": [f"s{i}", "t"]})
               for i in range(12)}},
        {"/": {"layer_names": [f"layer_{i}" for i in range(40)]}}),
}


@pytest.mark.parametrize("case", list(WRITER_CASES))
def test_writer_writes_the_jax_writers_bytes(case, tmp_path):
    tree, attrs = WRITER_CASES[case](np.random.default_rng(4))
    want = jmi.Hdf5Writer().write(tree, attrs)
    got = tmi.Hdf5Writer().write(tree, attrs)
    assert got == want
    tmi.write_hdf5(str(tmp_path / "t.h5"), tree, attrs)
    assert (tmp_path / "t.h5").read_bytes() == want
    # and a writer used twice writes the same file twice
    w = tmi.Hdf5Writer()
    assert w.write(tree, attrs) == w.write(tree, attrs) == want


# ------------------------------------------------------------ Keras files
def _case_mlp(rng):
    return keras_file(
        [dense("dense_1", 8, "relu", [4]), dense("dense_2", 3, "softmax")],
        {"dense_1": {"kernel": randn(rng, 4, 8), "bias": randn(rng, 8)},
         "dense_2": {"kernel": randn(rng, 8, 3), "bias": randn(rng, 3)}}), (5, 4)


def _case_activations_dropout(rng):
    layers = [dense("d1", 6, "linear", [4]),
              {"class_name": "Activation", "config": {
                  "name": "a1", "activation": "selu"}},
              {"class_name": "Dropout", "config": {"name": "dr", "rate": 0.25}},
              dense("d2", 5, "softplus"), dense("d3", 5, "softsign"),
              dense("d4", 5, "hard_sigmoid"), dense("d5", 5, "swish"),
              dense("d6", 5, "elu"), dense("d7", 5, "gelu"),
              dense("out", 2, "sigmoid", use_bias=False)]
    w = {"d1": {"kernel": randn(rng, 4, 6), "bias": randn(rng, 6)},
         "d2": {"kernel": randn(rng, 6, 5), "bias": randn(rng, 5)},
         "out": {"kernel": randn(rng, 5, 2)}}
    for n in ("d3", "d4", "d5", "d6", "d7"):
        w[n] = {"kernel": randn(rng, 5, 5, scale=1.5), "bias": randn(rng, 5)}
    return keras_file(layers, w), (5, 4)


def _case_convnet(rng):
    layers = [
        {"class_name": "Conv2D", "config": {
            "name": "conv", "filters": 4, "kernel_size": [3, 3],
            "strides": [1, 1], "padding": "valid", "activation": "relu",
            "use_bias": True, "batch_input_shape": [None, 8, 8, 1]}},
        {"class_name": "MaxPooling2D", "config": {
            "name": "pool", "pool_size": [2, 2], "strides": [2, 2]}},
        {"class_name": "Flatten", "config": {"name": "flatten"}},
        dense("out", 2, "softmax")]
    return keras_file(layers, {
        "conv": {"kernel": randn(rng, 3, 3, 1, 4), "bias": randn(rng, 4)},
        "pool": {}, "flatten": {},
        "out": {"kernel": randn(rng, 36, 2), "bias": zeros(2)}}), (2, 8, 8, 1)


def _case_keras1_conv_same_avgpool_bn(rng):
    layers = [
        {"class_name": "Convolution2D", "config": {
            "name": "c1", "nb_filter": 3, "nb_row": 3, "nb_col": 2,
            "subsample": [2, 1], "border_mode": "same",
            "activation": "tanh", "bias": True,
            "batch_input_shape": [None, 9, 7, 2]}},
        {"class_name": "BatchNormalization", "config": {
            "name": "bn", "epsilon": 1e-3, "momentum": 0.9}},
        {"class_name": "AveragePooling2D", "config": {
            "name": "ap", "pool_size": [2, 2], "strides": None}},
        {"class_name": "GlobalAveragePooling2D", "config": {"name": "gap"}},
        dense("out", 3, "softmax")]
    return keras_file(layers, {
        "c1": {"W": randn(rng, 3, 2, 2, 3), "b": randn(rng, 3)},
        "bn": {"gamma": rng.uniform(0.5, 1.5, 3).astype(np.float32),
               "beta": randn(rng, 3), "moving_mean": randn(rng, 3),
               "moving_variance": rng.uniform(0.5, 2, 3).astype(np.float32)},
        "out": {"kernel": randn(rng, 3, 3), "bias": zeros(3)}}), (4, 9, 7, 2)


def _case_batchnorm(rng):
    layers = [dense("d", 6, "linear", [6]),
              {"class_name": "BatchNormalization", "config": {
                  "name": "bn", "epsilon": 1e-3, "momentum": 0.99}},
              dense("out", 2, "softmax")]
    return keras_file(layers, {
        "d": {"kernel": randn(rng, 6, 6), "bias": zeros(6)},
        "bn": {"gamma": rng.uniform(0.5, 1.5, 6).astype(np.float32),
               "beta": randn(rng, 6), "moving_mean": randn(rng, 6),
               "moving_variance": rng.uniform(0.5, 2, 6).astype(np.float32)},
        "out": {"kernel": randn(rng, 6, 2), "bias": zeros(2)}}), (3, 6)


def _lstm_cfg(name, h, rec, input_shape=None, ret=True, keras1=False):
    cfg = {"name": name, "activation": "tanh", "return_sequences": ret}
    if keras1:
        cfg.update(output_dim=h, inner_activation=rec)
    else:
        cfg.update(units=h, recurrent_activation=rec)
    if input_shape:
        cfg["batch_input_shape"] = [None] + list(input_shape)
    return {"class_name": "LSTM", "config": cfg}


def _case_lstm(rec):
    def make(rng):
        n_in, h, t = 3, 5, 7
        layers = [_lstm_cfg("lstm", h, rec, [t, n_in]),
                  dense("out", 2, "softmax")]
        return keras_file(layers, {
            "lstm": {"kernel": randn(rng, n_in, 4 * h),
                     "recurrent_kernel": randn(rng, h, 4 * h),
                     "bias": randn(rng, 4 * h, scale=0.2)},
            "out": {"kernel": randn(rng, h, 2), "bias": zeros(2)}}), (2, t, n_in)
    return make


def _case_keras1_lstm_last_step(rng):
    n_in, h = 2, 3
    w = {}
    for gate in ("i", "f", "c", "o"):
        w[f"W_{gate}"] = randn(rng, n_in, h)
        w[f"U_{gate}"] = randn(rng, h, h)
        w[f"b_{gate}"] = randn(rng, h, scale=0.2)
    layers = [_lstm_cfg("lstm", h, "hard_sigmoid", [4, n_in], ret=False,
                        keras1=True),
              dense("out", 2, "softmax")]
    return keras_file(layers, {"lstm": w, "out": {
        "kernel": randn(rng, h, 2), "bias": zeros(2)}}), (3, 4, n_in)


def _case_simple_rnn(rng):
    layers = [{"class_name": "SimpleRNN", "config": {
        "name": "rnn", "units": 4, "activation": "tanh",
        "batch_input_shape": [None, 5, 3]}},
        {"class_name": "SimpleRNN", "config": {
            "name": "rnn2", "units": 3, "activation": "relu",
            "return_sequences": False}},
        dense("out", 2, "softmax")]
    return keras_file(layers, {
        "rnn": {"kernel": randn(rng, 3, 4), "recurrent_kernel": randn(rng, 4, 4),
                "bias": randn(rng, 4)},
        "rnn2": {"kernel": randn(rng, 4, 3), "recurrent_kernel": randn(rng, 3, 3)},
        "out": {"kernel": randn(rng, 3, 2), "bias": zeros(2)}}), (2, 5, 3)


def _case_zeropad_upsample_globalmax(rng):
    layers = [
        {"class_name": "ZeroPadding2D", "config": {
            "name": "pad", "padding": [[1, 1], [2, 2]],
            "batch_input_shape": [None, 6, 6, 1]}},
        {"class_name": "ZeroPadding2D", "config": {"name": "pad2",
                                                   "padding": [1, 0]}},
        {"class_name": "ZeroPadding2D", "config": {"name": "pad3",
                                                   "padding": 1}},
        {"class_name": "Conv2D", "config": {
            "name": "conv", "filters": 2, "kernel_size": 3,
            "strides": 1, "padding": "valid",
            "activation": "relu", "use_bias": False}},
        {"class_name": "UpSampling2D", "config": {
            "name": "up", "size": [2, 2]}},
        {"class_name": "GlobalMaxPooling2D", "config": {"name": "gmp"}},
        dense("out", 2, "softmax")]
    return keras_file(layers, {
        "conv": {"kernel": randn(rng, 3, 3, 1, 2)},
        "out": {"kernel": randn(rng, 2, 2), "bias": zeros(2)}}), (2, 6, 6, 1)


def _case_conv1d_pool1d(rng):
    layers = [
        {"class_name": "Conv1D", "config": {
            "name": "c1", "filters": 6, "kernel_size": [3],
            "strides": [1], "padding": "same", "activation": "relu",
            "use_bias": True, "batch_input_shape": [None, 10, 4]}},
        {"class_name": "MaxPooling1D", "config": {
            "name": "p1", "pool_size": [2], "strides": [2]}},
        {"class_name": "Convolution1D", "config": {
            "name": "c2", "nb_filter": 5, "filter_length": 2,
            "subsample_length": 1, "border_mode": "valid",
            "activation": "tanh"}},
        {"class_name": "AveragePooling1D", "config": {
            "name": "p2", "pool_length": 2}},
        {"class_name": "GlobalAveragePooling1D", "config": {"name": "gap"}},
        dense("out", 3, "softmax")]
    return keras_file(layers, {
        "c1": {"kernel": randn(rng, 3, 4, 6), "bias": randn(rng, 6)},
        "c2": {"kernel": randn(rng, 2, 6, 5), "bias": randn(rng, 5)},
        "out": {"kernel": randn(rng, 5, 3), "bias": zeros(3)}}), (2, 10, 4)


def _case_embedding(rng):
    layers = [{"class_name": "Embedding", "config": {
        "name": "emb", "input_dim": 7, "output_dim": 4,
        "batch_input_shape": [None, 1]}},
        dense("out", 3, "softmax")]
    return keras_file(layers, {
        "emb": {"embeddings": randn(rng, 7, 4)},
        "out": {"kernel": randn(rng, 4, 3), "bias": zeros(3)}}), "ids"


def _case_reshape_into_recurrent(rng):
    layers = [dense("d1", 6, "tanh", [4]),
              {"class_name": "Reshape",
               "config": {"name": "r1", "target_shape": [3, 2]}},
              _lstm_cfg("lstm_1", 5, "sigmoid", ret=False),
              dense("d2", 2, "softmax")]
    return keras_file(layers, {
        "d1": {"kernel": randn(rng, 4, 6), "bias": zeros(6)},
        "lstm_1": {"kernel": randn(rng, 2, 20), "recurrent_kernel":
                   randn(rng, 5, 20), "bias": zeros(20)},
        "d2": {"kernel": randn(rng, 5, 2), "bias": zeros(2)}}), (3, 4)


def _case_permute_time_distributed(rng):
    layers = [{"class_name": "Permute", "config": {
        "name": "p1", "dims": [2, 1], "batch_input_shape": [None, 4, 6]}},
        {"class_name": "TimeDistributed", "config": {
            "name": "td_1", "layer": {"class_name": "Dense", "config": {
                "name": "td_dense", "units": 2, "activation": "linear",
                "use_bias": True}}}}]
    return keras_file(layers, {"p1": {}, "td_1": {
        "kernel": randn(rng, 4, 2), "bias": randn(rng, 2)}}), (5, 4, 6)


def _case_repeat_vector(rng):
    layers = [dense("d1", 3, "linear", [5]),
              {"class_name": "RepeatVector", "config": {"name": "rv",
                                                        "n": 4}},
              {"class_name": "TimeDistributed", "config": {
                  "name": "td_out", "layer": {
                      "class_name": "Dense", "config": {
                          "name": "inner", "units": 2,
                          "activation": "softmax", "use_bias": False}}}}]
    return keras_file(layers, {
        "d1": {"kernel": randn(rng, 5, 3), "bias": zeros(3)},
        "td_out": {"kernel": randn(rng, 3, 2)}}), (2, 5)


def _case_advanced_activations(rng):
    layers = [dense("d1", 6, "linear", [3]),
              {"class_name": "LeakyReLU", "config": {"name": "l1",
                                                     "alpha": 0.3}},
              dense("d2", 6, "linear"),
              {"class_name": "ELU", "config": {"name": "e1", "alpha": 0.7}},
              {"class_name": "ThresholdedReLU",
               "config": {"name": "t1", "theta": 0.5}},
              dense("d3", 2, "linear")]
    return keras_file(layers, {
        "d1": {"kernel": randn(rng, 3, 6, scale=1.0), "bias": zeros(6)},
        "d2": {"kernel": randn(rng, 6, 6, scale=1.0), "bias": randn(rng, 6)},
        "d3": {"kernel": randn(rng, 6, 2), "bias": zeros(2)}}), (5, 3)


def _functional(rng, merge_cls, mode=None):
    """inp -> (branch_a relu, branch_b tanh) -> merge -> out softmax."""
    layers = [
        {"class_name": "InputLayer", "name": "inp",
         "config": {"name": "inp", "batch_input_shape": [None, 4]},
         "inbound_nodes": []},
        {"class_name": "Dense", "name": "branch_a",
         "config": {"name": "branch_a", "units": 8,
                    "activation": "relu", "use_bias": True},
         "inbound_nodes": [[["inp", 0, 0, {}]]]},
        {"class_name": "Dense", "name": "branch_b",
         "config": {"name": "branch_b", "units": 8,
                    "activation": "tanh", "use_bias": True},
         "inbound_nodes": [[["inp", 0, 0, {}]]]},
        {"class_name": merge_cls, "name": "merge",
         "config": {"name": "merge", **({"mode": mode} if mode else {})},
         "inbound_nodes": [[["branch_a", 0, 0, {}],
                            ["branch_b", 0, 0, {}]]]},
        {"class_name": "Flatten", "name": "flat",
         "config": {"name": "flat"},
         "inbound_nodes": [[["merge", 0, 0, {}]]]},
        {"class_name": "Dense", "name": "out",
         "config": {"name": "out", "units": 3,
                    "activation": "softmax", "use_bias": True},
         "inbound_nodes": [[["flat", 0, 0, {}]]]},
    ]
    n_merge = 16 if merge_cls == "Concatenate" or mode == "concat" else 8
    config = {"class_name": "Model", "config": {
        "name": "m", "layers": layers, "input_layers": [["inp", 0, 0]],
        "output_layers": [["out", 0, 0]]}}
    tree = {"model_weights": {
        "branch_a": {"kernel:0": randn(rng, 4, 8), "bias:0": randn(rng, 8)},
        "branch_b": {"kernel:0": randn(rng, 4, 8), "bias:0": randn(rng, 8)},
        "out": {"kernel:0": randn(rng, n_merge, 3), "bias:0": zeros(3)}}}
    attrs = {"/": {"model_config": json.dumps(config)},
             "/model_weights": {"layer_names":
                                ["branch_a", "branch_b", "out"]}}
    for lname in ("branch_a", "branch_b", "out"):
        attrs[f"/model_weights/{lname}"] = {
            "weight_names": [f"{lname}/kernel:0", f"{lname}/bias:0"]}
    return jmi.Hdf5Writer().write(tree, attrs), (5, 4)


def _case_functional(merge_cls, mode=None):
    return lambda rng: _functional(rng, merge_cls, mode)


def _case_functional_rnn_conv(rng):
    """A two-input functional graph: an LSTM branch and a conv branch."""
    layers = [
        {"class_name": "InputLayer", "name": "seq", "inbound_nodes": [],
         "config": {"name": "seq", "batch_input_shape": [None, 5, 3]}},
        {"class_name": "InputLayer", "name": "img", "inbound_nodes": [],
         "config": {"name": "img", "batch_input_shape": [None, 6, 6, 2]}},
        {**_lstm_cfg("lstm", 4, "hard_sigmoid", ret=False),
         "name": "lstm", "inbound_nodes": [[["seq", 0, 0, {}]]]},
        {"class_name": "Conv2D", "name": "conv", "inbound_nodes": [
            [["img", 0, 0, {}]]], "config": {
            "name": "conv", "filters": 3, "kernel_size": [3, 3],
            "padding": "same", "activation": "relu"}},
        {"class_name": "BatchNormalization", "name": "bn", "inbound_nodes": [
            [["conv", 0, 0, {}]]], "config": {"name": "bn"}},
        {"class_name": "GlobalAveragePooling2D", "name": "gap",
         "inbound_nodes": [[["bn", 0, 0, {}]]], "config": {"name": "gap"}},
        {"class_name": "Dense", "name": "proj", "inbound_nodes": [
            [["gap", 0, 0, {}]]], "config": {
            "name": "proj", "units": 4, "activation": "linear"}},
        {"class_name": "Multiply", "name": "mul", "config": {"name": "mul"},
         "inbound_nodes": [[["lstm", 0, 0, {}], ["proj", 0, 0, {}]]]},
        {"class_name": "Dense", "name": "out", "inbound_nodes": [
            [["mul", 0, 0, {}]]], "config": {
            "name": "out", "units": 2, "activation": "softmax"}}]
    config = {"class_name": "Functional", "config": {
        "name": "m", "layers": layers,
        "input_layers": [["seq", 0, 0], ["img", 0, 0]],
        "output_layers": [["out", 0, 0]]}}
    w = {"lstm": {"kernel:0": randn(rng, 3, 16), "recurrent_kernel:0":
                  randn(rng, 4, 16), "bias:0": randn(rng, 16, scale=0.2)},
         "conv": {"kernel:0": randn(rng, 3, 3, 2, 3), "bias:0": randn(rng, 3)},
         "bn": {"gamma:0": rng.uniform(0.5, 1.5, 3).astype(np.float32),
                "beta:0": randn(rng, 3), "moving_mean:0": randn(rng, 3),
                "moving_variance:0":
                    rng.uniform(0.5, 2, 3).astype(np.float32)},
         "proj": {"kernel:0": randn(rng, 3, 4), "bias:0": randn(rng, 4)},
         "out": {"kernel:0": randn(rng, 4, 2), "bias:0": zeros(2)}}
    attrs = {"/": {"model_config": json.dumps(config)},
             "/model_weights": {"layer_names": list(w)}}
    for lname, g in w.items():
        attrs[f"/model_weights/{lname}"] = {
            "weight_names": [f"{lname}/{k}" for k in g]}
    return jmi.Hdf5Writer().write({"model_weights": w}, attrs), \
        [(2, 5, 3), (2, 6, 6, 2)]


IMPORT_CASES = {
    "mlp": _case_mlp,
    "activations_dropout": _case_activations_dropout,
    "convnet": _case_convnet,
    "keras1_conv_same_avgpool_bn": _case_keras1_conv_same_avgpool_bn,
    "batchnorm": _case_batchnorm,
    "lstm_sigmoid": _case_lstm("sigmoid"),
    "lstm_hard_sigmoid": _case_lstm("hard_sigmoid"),
    "keras1_lstm_last_step": _case_keras1_lstm_last_step,
    "simple_rnn": _case_simple_rnn,
    "zeropad_upsample_globalmax": _case_zeropad_upsample_globalmax,
    "conv1d_pool1d": _case_conv1d_pool1d,
    "embedding": _case_embedding,
    "reshape_into_recurrent": _case_reshape_into_recurrent,
    "permute_time_distributed": _case_permute_time_distributed,
    "repeat_vector": _case_repeat_vector,
    "advanced_activations": _case_advanced_activations,
    "functional_add": _case_functional("Add"),
    "functional_concatenate": _case_functional("Concatenate"),
    "functional_subtract": _case_functional("Subtract"),
    "functional_average": _case_functional("Average"),
    "functional_maximum": _case_functional("Maximum"),
    "functional_keras1_merge_sum": _case_functional("Merge", "sum"),
    "functional_keras1_merge_concat": _case_functional("Merge", "concat"),
    "functional_rnn_conv": _case_functional_rnn_conv,
}
# dropout draws in training: these compare outputs, not a fit step
NO_FIT = {"activations_dropout"}


def _inputs(rng, spec):
    if spec == "ids":
        return [rng.integers(0, 7, (4, 1)).astype(np.int32)]
    specs = spec if isinstance(spec, list) else [spec]
    return [rng.standard_normal(s).astype(np.float32) for s in specs]


def _labels(rng, y):
    """One-hot labels of the output's shape (softmax heads) or targets
    (others)."""
    y = np.asarray(y)
    idx = rng.integers(0, y.shape[-1], y.shape[:-1])
    return np.eye(y.shape[-1], dtype=np.float32)[idx]


@pytest.mark.parametrize("case", list(IMPORT_CASES))
def test_every_mapper_imports_as_the_jax_importer(case):
    rng = np.random.default_rng(sorted(IMPORT_CASES).index(case))
    data, spec = IMPORT_CASES[case](rng)
    jnet = jmi.import_keras_model(data)
    tnet = tmi.import_keras_model(data, device="cpu")
    assert type(tnet).__name__ == type(jnet).__name__
    assert tnet.conf.to_json() == jnet.conf.to_json()
    assert_params_bit_equal(jnet, tnet)
    xs = _inputs(rng, spec)
    jy = np.asarray(first(jnet.output(*xs)))
    ty = first(tnet.output(*xs)).numpy()
    assert ty.shape == jy.shape and np.isfinite(ty).all()
    np.testing.assert_allclose(ty, jy, atol=ATOL_OUT, rtol=0)
    if case in NO_FIT:
        return
    y = _labels(rng, jy)
    if isinstance(tnet, MultiLayerNetwork):
        jnet.fit(xs[0], y)
        tnet.fit(xs[0], y)
    else:
        jnet.fit(xs, [y])
        tnet.fit(xs, [y])
    np.testing.assert_allclose(tnet.get_score(), float(jnet.score()),
                               rtol=RTOL_LOSS)
    for k, g in host_params(jnet).items():
        for n, a in g.items():
            b = tnet.params[k][n].detach().numpy()
            scale = max(float(np.abs(a).max()), 1e-3)
            np.testing.assert_allclose(b, a, atol=ATOL_STEP * scale, rtol=0,
                                       err_msg=f"{k}/{n}")


def test_sequential_entry_point_and_delegation():
    rng = np.random.default_rng(7)
    data, _ = _case_mlp(rng)
    for fn in (tmi.import_keras_model, tmi.import_keras_sequential_model,
               tmi.KerasModelImport.import_keras_model_and_weights,
               tmi.KerasModelImport.import_keras_sequential_model_and_weights):
        assert isinstance(fn(data, device="cpu"), MultiLayerNetwork)
    fdata, _ = _functional(rng, "Add")
    assert isinstance(tmi.KerasModelImport.import_keras_model_and_weights(
        fdata, device="cpu"), ComputationGraph)
    assert tkeras._layer_weight_groups(tmi.Hdf5File(data)).keys() == \
        jkeras._layer_weight_groups(jmi.Hdf5File(data)).keys()


def test_lstm_gates_land_in_the_port_order():
    """Keras stores i,f,c,o; the port (and lstm_fwd) reads i,f,o,g: a
    wrong reorder passes every shape check, so each gate block is held
    against the Keras block it must be."""
    rng = np.random.default_rng(9)
    data, _ = _case_keras1_lstm_last_step(rng)
    w = tmi.Hdf5File(data)["model_weights/lstm"]
    net = tmi.import_keras_sequential_model(data, device="cpu")
    h = 3
    p = {n: net.params["layer_0"][n].detach().numpy() for n in "WUb"}
    for port_slot, gate in enumerate("ifoc"):
        sl = slice(port_slot * h, (port_slot + 1) * h)
        np.testing.assert_array_equal(p["W"][:, sl], w[f"W_{gate}:0"].read())
        np.testing.assert_array_equal(p["U"][:, sl], w[f"U_{gate}:0"].read())
        np.testing.assert_array_equal(p["b"][sl], w[f"b_{gate}:0"].read())


def _error_cases(rng):
    cases = {
        "lambda": keras_file([{"class_name": "Lambda", "config": {
            "name": "lam", "batch_input_shape": [None, 3]}}], {}),
        "activation": keras_file([dense("d", 2, "exotic", [3])], {}),
        "causal": keras_file([{"class_name": "Conv1D", "config": {
            "name": "c", "filters": 2, "kernel_size": 2, "padding": "causal",
            "batch_input_shape": [None, 5, 3]}}], {}),
        "conv_padding": keras_file([{"class_name": "Conv2D", "config": {
            "name": "c", "filters": 2, "kernel_size": 2, "padding": "full",
            "batch_input_shape": [None, 5, 5, 3]}}], {}),
        "td_conv": keras_file([{"class_name": "TimeDistributed", "config": {
            "name": "td", "layer": {"class_name": "Conv2D", "config": {}},
            "batch_input_shape": [None, 5, 3]}}], {}),
        "no_input_shape": keras_file([dense("d", 2, "relu")], {}),
        "missing_weights": keras_file([dense("d", 2, "relu", [3])],
                                       {"d": {}}),
        "shape": keras_file([dense("d", 2, "relu", [3])], {
            "d": {"kernel": zeros(4, 2), "bias": zeros(2)}}),
        "input_rank": keras_file([dense("d", 2, "relu", [3, 4, 5, 6])],
                                  {}),
        "no_config": jmi.Hdf5Writer().write({"model_weights": {}}),
        "model_class": jmi.Hdf5Writer().write({}, {"/": {"model_config":
            json.dumps({"class_name": "Weird", "config": {}})}}),
        "keras3_nodes": jmi.Hdf5Writer().write({}, {"/": {"model_config":
            json.dumps({"class_name": "Model", "config": {
                "output_layers": [["d", 0, 0]], "layers": [
                    {"class_name": "Dense", "name": "d", "config": {},
                     "inbound_nodes": [{"args": []}]}]}})}}),
    }
    return cases


def test_import_errors_are_the_jax_ones():
    for name, data in _error_cases(np.random.default_rng(1)).items():
        with pytest.raises(Exception) as jerr:
            jmi.import_keras_model(data)
        with pytest.raises(Exception) as terr:
            tmi.import_keras_model(data, device="cpu")
        assert type(terr.value).__name__ == type(jerr.value).__name__, name
        assert str(terr.value) == str(jerr.value), name
    model = jmi.Hdf5Writer().write({}, {"/": {"model_config": json.dumps(
        {"class_name": "Model", "config": {}})}})
    with pytest.raises(tmi.KerasImportError, match="not a Sequential"):
        tmi.import_keras_sequential_model(model, device="cpu")


def test_custom_layer_registry():
    def mapper(conf, is_last, rnn_input):
        return tkeras.KerasLayerMapping(tff.ActivationLayer(
            name=conf.get("name"), activation=lambda x: x * 0.5),
            lambda w: {})

    tkeras.register_keras_layer("MyHalf", mapper)
    try:
        rng = np.random.default_rng(5)
        W = randn(rng, 3, 3)
        data = keras_file(
            [dense("d1", 3, "linear", [3]),
             {"class_name": "MyHalf", "config": {"name": "h1"}},
             dense("d2", 2, "linear")],
            {"d1": {"kernel": W, "bias": zeros(3)},
             "d2": {"kernel": np.eye(3, 2, dtype=np.float32),
                    "bias": zeros(2)}})
        net = tmi.import_keras_sequential_model(data, device="cpu")
        x = randn(rng, 4, 3)
        np.testing.assert_allclose(
            net.output(x).numpy(),
            (0.5 * (x @ W)) @ np.eye(3, 2, dtype=np.float32), atol=1e-6)
    finally:
        tkeras._CUSTOM_LAYERS.pop("MyHalf", None)


def test_import_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    data, _ = _case_mlp(np.random.default_rng(0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (tmi.import_keras_model, tmi.import_keras_sequential_model):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(data)
