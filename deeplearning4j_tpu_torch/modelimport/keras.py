"""Keras HDF5 model import (port of ``modelimport/keras.py``; reference
``deeplearning4j-modelimport``: ``KerasModelImport.java:50-157`` entry
points, ``KerasSequentialModel.java``, ``KerasLayer.java:42`` registry of
layer mappers).

Reads a Keras 1.x/2.x ``model.save()`` HDF5 file with the pure-Python
parser (``hdf5.py``), maps ``model_config`` onto the port's
configuration DSL, builds a ``MultiLayerNetwork`` (Sequential) or a
``ComputationGraph`` (functional ``Model``) on ``device`` and installs
the weights, transposing or reordering where conventions differ: Keras
stores the LSTM gates i,f,c,o and the port i,f,o,g, the order
``lstm_fwd`` reads.  TF channel-last conventions are assumed (the DL4J
importer's default for TF-backend files).  The network trains with
``Sgd(learning_rate=0.01)``, as the JAX package's import does.

Supported layers: Dense, Activation, Dropout, Flatten, Conv1D/2D,
MaxPooling1D/2D, AveragePooling1D/2D, Global*Pooling1D/2D, ZeroPadding2D,
UpSampling2D, BatchNormalization, LSTM (Keras-2 fused and Keras-1
per-gate weights), SimpleRNN, Embedding, Reshape, Permute, RepeatVector,
TimeDistributed, the advanced activations LeakyReLU / ELU /
ThresholdedReLU, and the merges Add, Subtract, Multiply, Average,
Maximum, Concatenate and Keras-1 ``Merge``.  More classes plug in with
:func:`register_keras_layer`.  Unsupported layers raise
``KerasImportError`` naming the layer class.

Entry points take ``device="cuda"`` and raise without a GPU; pass
``device="cpu"`` to import onto the CPU.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..nn.conf.input_type import InputType
from ..nn.conf.multi_layer import NeuralNetConfiguration
from ..nn.conf.updaters import Sgd
from ..nn.layers.convolution import ConvolutionLayer, SubsamplingLayer
from ..nn.layers.feedforward import (ActivationLayer, DenseLayer,
                                     DropoutLayer, EmbeddingLayer,
                                     OutputLayer)
from ..nn.layers.normalization import BatchNormalization
from ..nn.layers.pooling import GlobalPoolingLayer
from ..nn.layers.recurrent import LSTM, RnnOutputLayer, SimpleRnn
from ..nn.multilayer import MultiLayerNetwork
from ..utils.device import resolve_device
from .hdf5 import Hdf5File, Hdf5FormatError  # noqa: F401

__all__ = ["KerasModelImport", "KerasImportError",
           "import_keras_sequential_model", "import_keras_model",
           "register_keras_layer", "KerasLayerMapping"]


class KerasImportError(ValueError):
    pass


# Custom layer mappers (reference KerasLayer.registerCustomLayer):
# class name -> fn(conf, is_last, rnn_input) -> KerasLayerMapping
_CUSTOM_LAYERS: Dict[str, Any] = {}


def register_keras_layer(class_name: str, mapper) -> None:
    """Register an import mapper for a custom Keras layer class.

    ``mapper(conf: dict, is_last: bool, rnn_input: bool) ->
    KerasLayerMapping``: a layer conf plus a weight-copy function
    (``KerasLayerMapping(conf, copy_fn)``; ``copy_fn(keras_weights) ->
    params dict``).
    """
    _CUSTOM_LAYERS[class_name] = mapper


_ACT_MAP = {
    "relu": "relu", "tanh": "tanh", "sigmoid": "sigmoid",
    "softmax": "softmax", "linear": "identity", "elu": "elu",
    "selu": "selu", "softplus": "softplus", "softsign": "softsign",
    "hard_sigmoid": "hardsigmoid", "swish": "swish", "gelu": "gelu",
}


def _act(name: Optional[str]) -> str:
    if name is None:
        return "identity"
    if name not in _ACT_MAP:
        raise KerasImportError(f"unsupported Keras activation '{name}'")
    return _ACT_MAP[name]


def _cfg(layer: Dict[str, Any]) -> Dict[str, Any]:
    return layer.get("config", {})


def _input_type_from(conf: Dict[str, Any]) -> Optional[InputType]:
    shape = conf.get("batch_input_shape") or conf.get("batch_shape")
    if shape is None:
        return None
    dims = [d for d in shape[1:]]
    if len(dims) == 1:
        return InputType.feed_forward(dims[0])
    if len(dims) == 2:  # [timesteps, features]
        return InputType.recurrent(dims[1], dims[0])
    if len(dims) == 3:  # [h, w, c] channels_last
        return InputType.convolutional(dims[0], dims[1], dims[2])
    raise KerasImportError(f"cannot map input shape {shape}")


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _first(v) -> int:
    return int(v[0] if isinstance(v, (list, tuple)) else v)


class KerasLayerMapping:
    """One imported layer: the port's conf plus a weight-copy function.
    Custom mappers registered with :func:`register_keras_layer` return
    it."""

    def __init__(self, conf=None, copy=None):
        self.conf = conf
        self.copy = copy  # fn(keras_weights: dict[str, np.ndarray]) -> params


_LayerMap = KerasLayerMapping


def _no_weights(w):
    return {}


def _keras_lstm_reorder(m, h: int):
    """Keras gate blocks i,f,c,o -> the port's i,f,o,g (g = c)."""
    blocks = [m[..., i * h:(i + 1) * h] for i in range(4)]
    return np.concatenate([blocks[0], blocks[1], blocks[3], blocks[2]],
                          axis=-1)


def _last_step(lc, conf, name):
    """Keras ``return_sequences=False`` keeps only the final step: the
    reference maps it with the LastTimeStep wrapper."""
    if conf.get("return_sequences", True):
        return lc
    from ..nn.layers.recurrent import LastTimeStep
    return LastTimeStep(name=name, underlying=lc)


def _map_dense(name, conf, is_last, rnn_input):
    act = _act(conf.get("activation"))
    n_out = int(conf["units"] if "units" in conf else conf["output_dim"])
    use_bias = conf.get("bias", conf.get("use_bias", True))
    if is_last:
        loss = "mcxent" if act == "softmax" else "mse"
        # a Keras Dense over [b, t, f] is time-distributed: keep the time
        # axis (RnnOutputLayer) instead of auto-flattening
        cls = RnnOutputLayer if rnn_input else OutputLayer
        lc = cls(name=name, n_out=n_out, activation=act, loss=loss,
                 has_bias=use_bias)
    else:
        lc = DenseLayer(name=name, n_out=n_out, activation=act,
                        has_bias=use_bias)

    def copy(w):
        out = {"W": w.get("kernel", w.get("W"))}
        if use_bias:
            out["b"] = w.get("bias", w.get("b"))
        return out

    return _LayerMap(lc, copy)


def _map_conv2d(name, conf):
    n_out = int(conf.get("filters", conf.get("nb_filter", 0)))
    if "kernel_size" in conf:
        kernel = _pair(conf["kernel_size"])
    else:  # Keras 1: nb_row / nb_col
        kernel = (int(conf["nb_row"]), int(conf["nb_col"]))
    stride = _pair(conf.get("strides", conf.get("subsample", (1, 1))))
    padding = conf.get("padding", conf.get("border_mode", "valid"))
    if padding not in ("valid", "same"):
        raise KerasImportError(f"unsupported Conv2D padding '{padding}'")
    lc = ConvolutionLayer(
        name=name, n_out=n_out, kernel_size=kernel, stride=stride,
        convolution_mode="same" if padding == "same" else "truncate",
        activation=_act(conf.get("activation")),
        has_bias=conf.get("use_bias", conf.get("bias", True)))

    def copy(w):
        kernel_w = w.get("kernel", w.get("W"))
        if kernel_w is not None and kernel_w.ndim != 4:
            raise KerasImportError("Conv2D kernel must be 4-D (HWIO)")
        out = {"W": kernel_w}  # TF HWIO == the port's [kh, kw, in, out]
        if lc.has_bias:
            out["b"] = w.get("bias", w.get("b"))
        return out

    return _LayerMap(lc, copy)


def _map_conv1d(name, conf):
    from ..nn.layers.convolution import Convolution1DLayer
    n_out = int(conf.get("filters", conf.get("nb_filter", 0)))
    k = _first(conf.get("kernel_size", conf.get("filter_length", 3)))
    s = _first(conf.get("strides", conf.get("subsample_length", 1)))
    padding = conf.get("padding", conf.get("border_mode", "valid"))
    if padding not in ("valid", "same"):
        # 'causal' pads left only: mapping it to 'same' would leak
        # future timesteps
        raise KerasImportError(f"unsupported Conv1D padding '{padding}'")
    lc = Convolution1DLayer(
        name=name, n_out=n_out, kernel_size=k, stride=s,
        convolution_mode="same" if padding == "same" else "truncate",
        activation=_act(conf.get("activation")),
        has_bias=conf.get("use_bias", conf.get("bias", True)))

    def copy(w):
        out = {"W": w.get("kernel", w.get("W"))}  # [k, in, out]
        if lc.has_bias:
            out["b"] = w.get("bias", w.get("b"))
        return out

    return _LayerMap(lc, copy)


def _map_zero_padding(name, conf):
    from ..nn.layers.convolution import ZeroPaddingLayer
    pad = conf.get("padding", 1)
    if isinstance(pad, int):
        padding = (pad, pad, pad, pad)
    elif len(pad) == 2 and all(isinstance(p, int) for p in pad):
        padding = (pad[0], pad[0], pad[1], pad[1])
    else:  # [[top, bottom], [left, right]]
        padding = (pad[0][0], pad[0][1], pad[1][0], pad[1][1])
    return _LayerMap(ZeroPaddingLayer(name=name, padding=padding),
                     _no_weights)


def _map_batch_norm(name, conf):
    lc = BatchNormalization(name=name,
                            eps=float(conf.get("epsilon", 1e-3)),
                            decay=float(conf.get("momentum", 0.99)))

    def copy(w):
        out = {}
        if "gamma" in w:
            out["gamma"] = w["gamma"]
        if "beta" in w:
            out["beta"] = w["beta"]
        # the moving statistics go to the layer's state
        out["__state__"] = {
            "mean": w.get("moving_mean", w.get("running_mean")),
            "var": w.get("moving_variance", w.get("running_std")),
        }
        return out

    return _LayerMap(lc, copy)


def _map_lstm(name, conf):
    n_out = int(conf.get("units", conf.get("output_dim", 0)))
    act = _act(conf.get("activation", "tanh"))
    rec_act = conf.get("recurrent_activation",
                       conf.get("inner_activation", "hard_sigmoid"))
    lc = _last_step(LSTM(name=name, n_out=n_out, activation=act,
                         gate_activation=_act(rec_act)), conf, name)

    def copy(w):
        if "kernel" in w:  # Keras 2: fused [in, 4h], gate order i,f,c,o
            k, rk, b = w["kernel"], w["recurrent_kernel"], w.get("bias")
        else:  # Keras 1: per-gate matrices
            k = np.concatenate([w["W_i"], w["W_f"], w["W_c"], w["W_o"]], 1)
            rk = np.concatenate([w["U_i"], w["U_f"], w["U_c"], w["U_o"]], 1)
            b = np.concatenate([w["b_i"], w["b_f"], w["b_c"], w["b_o"]])
        h = n_out
        out = {"W": _keras_lstm_reorder(k, h),
               "U": _keras_lstm_reorder(rk, h)}
        out["b"] = (_keras_lstm_reorder(b.reshape(1, -1), h).reshape(-1)
                    if b is not None else np.zeros(4 * h, np.float32))
        return out

    return _LayerMap(lc, copy)


def _map_simple_rnn(name, conf):
    n_out = int(conf.get("units", conf.get("output_dim", 0)))
    lc = _last_step(SimpleRnn(name=name, n_out=n_out,
                              activation=_act(conf.get("activation",
                                                       "tanh"))),
                    conf, name)

    def copy(w):
        out = {"W": w.get("kernel", w.get("W")),
               "U": w.get("recurrent_kernel", w.get("U"))}
        b = w.get("bias", w.get("b"))
        out["b"] = b if b is not None else np.zeros(n_out, np.float32)
        return out

    return _LayerMap(lc, copy)


def _map_layer(cls: str, conf: Dict[str, Any], is_last: bool,
               rnn_input: bool = False) -> _LayerMap:
    name = conf.get("name")
    if cls in _CUSTOM_LAYERS:
        return _CUSTOM_LAYERS[cls](conf, is_last, rnn_input)
    if cls == "TimeDistributed":
        # the port's dense/activation layers already act on the trailing
        # feature axis of [b, t, f], so for those the wrapper is the inner
        # mapping with rnn semantics; spatial or recurrent inner layers
        # would need real per-step lifting: refuse them rather than import
        # a wrong network
        inner = conf.get("layer") or {}
        inner_cls = inner.get("class_name", "")
        if inner_cls not in ("Dense", "Activation", "Dropout"):
            raise KerasImportError(
                f"unsupported TimeDistributed inner layer '{inner_cls}' "
                "(only Dense/Activation/Dropout map directly)")
        inner_conf = dict(_cfg(inner))
        inner_conf.setdefault("name", name)
        return _map_layer(inner_cls, inner_conf,
                          is_last=is_last, rnn_input=True)
    if cls == "LeakyReLU":
        alpha = float(conf.get("alpha", conf.get("negative_slope", 0.3)))
        return _LayerMap(ActivationLayer(
            name=name, activation=f"leakyrelu:{alpha}"), _no_weights)
    if cls == "ELU":
        alpha = float(conf.get("alpha", 1.0))
        return _LayerMap(ActivationLayer(
            name=name, activation=f"elu:{alpha}"), _no_weights)
    if cls == "ThresholdedReLU":
        theta = float(conf.get("theta", 1.0))
        return _LayerMap(ActivationLayer(
            name=name, activation=f"thresholdedrelu:{theta}"), _no_weights)
    if cls == "Reshape":
        from ..nn.layers.misc import ReshapeLayer
        return _LayerMap(ReshapeLayer(
            name=name, target_shape=tuple(conf["target_shape"])),
            _no_weights)
    if cls == "Permute":
        from ..nn.layers.misc import PermuteLayer
        return _LayerMap(PermuteLayer(name=name, dims=tuple(conf["dims"])),
                         _no_weights)
    if cls == "RepeatVector":
        from ..nn.layers.misc import RepeatVector
        return _LayerMap(RepeatVector(name=name, n=int(conf["n"])),
                         _no_weights)
    if cls == "Dense":
        return _map_dense(name, conf, is_last, rnn_input)
    if cls == "Activation":
        return _LayerMap(ActivationLayer(name=name,
                                         activation=_act(conf["activation"])),
                         _no_weights)
    if cls == "Dropout":
        # Keras rate = drop probability; the port's dropout keeps the
        # reference's retain probability
        rate = float(conf.get("rate", conf.get("p", 0.5)))
        return _LayerMap(DropoutLayer(name=name, dropout=1.0 - rate),
                         _no_weights)
    if cls == "Flatten":
        return _LayerMap(None, None)  # the automatic preprocessor reshapes
    if cls in ("Conv2D", "Convolution2D"):
        return _map_conv2d(name, conf)
    if cls in ("MaxPooling2D", "AveragePooling2D"):
        kernel = _pair(conf.get("pool_size", (2, 2)))
        stride = _pair(conf.get("strides") or conf.get("pool_size", (2, 2)))
        return _LayerMap(SubsamplingLayer(
            name=name, kernel_size=kernel, stride=stride,
            pooling_type="max" if cls.startswith("Max") else "avg"),
            _no_weights)
    if cls in ("GlobalAveragePooling2D", "GlobalAveragePooling1D",
               "GlobalMaxPooling2D", "GlobalMaxPooling1D"):
        return _LayerMap(GlobalPoolingLayer(
            name=name, pooling_type="max" if "Max" in cls else "avg"),
            _no_weights)
    if cls in ("MaxPooling1D", "AveragePooling1D"):
        from ..nn.layers.convolution import Subsampling1DLayer
        k = _first(conf.get("pool_size", conf.get("pool_length", 2)))
        s = conf.get("strides", conf.get("stride")) or k
        return _LayerMap(Subsampling1DLayer(
            name=name, kernel_size=k, stride=_first(s),
            pooling_type="max" if cls.startswith("Max") else "avg"),
            _no_weights)
    if cls in ("Conv1D", "Convolution1D"):
        return _map_conv1d(name, conf)
    if cls == "ZeroPadding2D":
        return _map_zero_padding(name, conf)
    if cls == "UpSampling2D":
        from ..nn.layers.convolution import Upsampling2D
        return _LayerMap(Upsampling2D(
            name=name, size=_pair(conf.get("size", (2, 2)))), _no_weights)
    if cls == "BatchNormalization":
        return _map_batch_norm(name, conf)
    if cls == "LSTM":
        return _map_lstm(name, conf)
    if cls == "SimpleRNN":
        return _map_simple_rnn(name, conf)
    if cls == "Embedding":
        lc = EmbeddingLayer(name=name, n_in=int(conf.get("input_dim")),
                            n_out=int(conf.get("output_dim")),
                            activation="identity")
        return _LayerMap(lc, lambda w: {
            "W": w.get("embeddings", w.get("W"))})
    raise KerasImportError(f"unsupported Keras layer class '{cls}' "
                           "(reference KerasLayer registry)")


def _layer_weight_groups(f: Hdf5File) -> Dict[str, Dict[str, np.ndarray]]:
    """{layer_name: {short_weight_name: array}} from /model_weights (or the
    root for weights-only files)."""
    root = f["model_weights"] if "model_weights" in f.keys() else f
    out: Dict[str, Dict[str, np.ndarray]] = {}
    names = root.attrs.get("layer_names")
    layer_names = ([n.decode() if isinstance(n, bytes) else n
                    for n in list(names)]
                   if names is not None else root.keys())
    for lname in layer_names:
        try:
            g = root[lname]
        except KeyError:      # a weightless layer with no group written
            out[lname] = {}
            continue
        weights: Dict[str, np.ndarray] = {}
        wnames = g.attrs.get("weight_names")
        wlist = list(wnames) if wnames is not None else g.keys()
        for wn in wlist:
            if isinstance(wn, bytes):
                wn = wn.decode()
            try:  # Keras nests an inner scope group (layer/layer/kernel:0)
                ds = g[wn]
            except KeyError:  # weights-only layouts store datasets flat
                ds = g[wn.split("/")[-1]]
            short = wn.split("/")[-1].split(":")[0]
            # Keras 1 style "dense_1_W" -> "W"
            if short.startswith(lname + "_"):
                short = short[len(lname) + 1:]
            weights[short] = ds.read()
        out[lname] = weights
    return out


def _model_config(f: Hdf5File, missing: str) -> Dict[str, Any]:
    raw = f.attrs.get("model_config")
    if raw is None:
        raise KerasImportError(missing)
    return json.loads(raw if isinstance(raw, str) else str(raw))


def _copy_weights_into(groups, items) -> Tuple[Dict, Dict]:
    """The shared weight-copy loop.  ``items``: ``(keras_name, copy_fn,
    key, param spec, state spec)`` per mapped layer (specs: ``{name:
    (shape, dtype)}``).  Returns ``({key: {name: array}}, {key: {name:
    array}})``, the params and state the file gives, checked against the
    specs."""
    params_out: Dict[str, Dict[str, np.ndarray]] = {}
    state_out: Dict[str, Dict[str, np.ndarray]] = {}
    for lname, copy_fn, key, target, st in items:
        if copy_fn is None:
            continue
        params = copy_fn(groups.get(lname, {}))
        state_extra = params.pop("__state__", None)
        got = params_out.setdefault(key, {})
        for pname, val in params.items():
            if val is None:
                raise KerasImportError(
                    f"layer {lname}: weight '{pname}' not found in the "
                    "HDF5 file (layer group missing or dataset names "
                    "unrecognized)")
            val = np.asarray(val, np.float32)
            if pname not in target:
                raise KerasImportError(
                    f"layer {lname}: param '{pname}' missing on our side")
            if tuple(target[pname][0]) != tuple(val.shape):
                raise KerasImportError(
                    f"layer {lname}: shape mismatch for '{pname}': "
                    f"keras {val.shape} vs ours {tuple(target[pname][0])}")
            got[pname] = val
        if state_extra and st is not None:
            for sname in ("mean", "var"):
                if state_extra.get(sname) is not None:
                    state_out.setdefault(key, {})[sname] = np.asarray(
                        state_extra[sname], np.float32)
    return params_out, state_out


def _install(net, params: Dict, state: Dict):
    """``net`` (freshly initialised) with the file's params and state in
    place of its own; leaves the file does not give keep their initial
    values."""
    def host(tree, key, name):
        return tree[key][name].detach().cpu().numpy()

    own = net._param_tree()
    net.load_params({key: {name: params.get(key, {}).get(name)
                           if name in params.get(key, {})
                           else host(own, key, name) for name in group}
                     for key, group in own.items()})
    net.load_state({key: {name: state[key][name]
                          if name in state.get(key, {})
                          else host(net.state, key, name)
                          for name in group}
                    for key, group in net.state.items()})
    return net


def import_keras_sequential_model(path_or_bytes, device="cuda"
                                  ) -> MultiLayerNetwork:
    """Load a Keras Sequential ``model.save()`` file into a
    MultiLayerNetwork on ``device`` (reference
    ``KerasModelImport.importKerasSequentialModelAndWeights``)."""
    device = resolve_device(device)
    f = Hdf5File(path_or_bytes)
    config = _model_config(f, "no model_config attribute — is this a "
                              "weights-only file? (use layer_weight_groups)")
    if config.get("class_name") != "Sequential":
        raise KerasImportError(
            f"not a Sequential model ({config.get('class_name')}); "
            "functional-graph import is not yet supported")
    layer_list = config["config"]
    if isinstance(layer_list, dict):  # Keras 2.2+: {"name":..,"layers":[..]}
        layer_list = layer_list["layers"]

    itype = None
    maps: List[_LayerMap] = []
    mapped_names: List[str] = []
    # the last REAL layer (Flatten/InputLayer don't count)
    real_idx = [i for i, l in enumerate(layer_list)
                if l["class_name"] not in ("Flatten", "InputLayer")]
    rnn_ctx = False   # does the running activation carry a time axis?
    for i, l in enumerate(layer_list):
        cls = l["class_name"]
        conf = _cfg(l)
        if itype is None:
            it = _input_type_from(conf)
            if it is not None:
                itype = it
                rnn_ctx = it.kind == "rnn"
        if cls == "InputLayer":
            continue
        lm = _map_layer(cls, conf, is_last=(real_idx and i == real_idx[-1]),
                        rnn_input=rnn_ctx)
        rnn_ctx = _carries_time(cls, conf, rnn_ctx, sequential=True)
        if lm.conf is None:  # Flatten
            continue
        maps.append(lm)
        mapped_names.append(conf.get("name") or f"layer_{i}")
    if itype is None:
        raise KerasImportError("no batch_input_shape on the first layer")

    builder = (NeuralNetConfiguration.builder()
               .seed(12345)
               .updater(Sgd(learning_rate=0.01))
               .list())
    for lm in maps:
        builder.layer(lm.conf)
    conf = builder.set_input_type(itype).build()
    net = MultiLayerNetwork(conf, device=device).init()
    pspec, sspec = net.param_spec(), net.state_spec()
    params, state = _copy_weights_into(_layer_weight_groups(f), [
        (lname, lm.copy, f"layer_{i}", pspec.get(f"layer_{i}", {}),
         sspec.get(f"layer_{i}", {}))
        for i, (lm, lname) in enumerate(zip(maps, mapped_names))])
    return _install(net, params, state)


# the layers after which the running activation keeps (or gains) its
# time axis, beside those that decide it themselves
_KEEPS_TIME = ("Dropout", "Activation", "MaxPooling1D", "AveragePooling1D",
               "BatchNormalization", "LeakyReLU", "ELU", "ThresholdedReLU",
               "Permute")


def _carries_time(cls: str, conf: Dict[str, Any], rnn_in: bool,
                  sequential: bool) -> bool:
    """Whether the output of a ``cls`` layer fed ``rnn_in`` carries a
    time axis.  The Sequential path lets a time-distributed Dense keep
    it (and only that); the functional path lets any Dense."""
    if cls in ("LSTM", "SimpleRNN", "Conv1D", "Convolution1D"):
        return bool(conf.get("return_sequences", True)) or \
            cls in ("Conv1D", "Convolution1D")
    if cls == "Reshape":
        return len(conf.get("target_shape", ())) == 2
    if cls in ("RepeatVector", "TimeDistributed"):
        return True
    if cls in _KEEPS_TIME or (not sequential and cls == "Dense"):
        return rnn_in
    if sequential:
        return rnn_in and cls == "Dense"
    return False


# Keras merge-layer class -> the port's graph vertex op
_MERGE_ELEMENTWISE = {"Add": "add", "Subtract": "subtract",
                      "Multiply": "product", "Average": "average",
                      "Maximum": "max"}
# Keras 1 Merge(mode=...) -> op
_MERGE_MODE = {"sum": "add", "mul": "product", "ave": "average",
               "max": "max", "concat": None}


def _inbound_names(layer: Dict[str, Any]) -> List[str]:
    """First inbound node's source layer names (Keras 1 and 2 formats)."""
    nodes = layer.get("inbound_nodes") or []
    if not nodes:
        return []
    node = nodes[0]
    if isinstance(node, dict):  # Keras 3-style {"args": ...} unsupported
        raise KerasImportError("unsupported inbound_nodes format (Keras 3)")
    return [entry[0] for entry in node]


def import_keras_model(path_or_bytes, device="cuda"):
    """Load a Keras functional ``Model`` save file into a ComputationGraph
    on ``device`` (reference ``KerasModelImport.importKerasModelAndWeights``
    -> ``KerasModel.java`` building a CG).  Sequential files go to
    :func:`import_keras_sequential_model`."""
    from ..nn.computation_graph import ComputationGraph
    from ..nn.conf.computation_graph import (ElementWiseVertex, GraphBuilder,
                                             MergeVertex)

    device = resolve_device(device)
    f = Hdf5File(path_or_bytes)
    config = _model_config(f, "no model_config attribute in the file")
    cls_name = config.get("class_name")
    if cls_name == "Sequential":
        return import_keras_sequential_model(path_or_bytes, device=device)
    if cls_name not in ("Model", "Functional"):
        raise KerasImportError(f"unsupported model class '{cls_name}'")
    cfg = config["config"]
    out_names = [o[0] for o in cfg["output_layers"]]

    g = GraphBuilder(defaults={"updater": Sgd(learning_rate=0.01)})
    alias: Dict[str, str] = {}      # skipped layers forward to their input
    copy_items: List[Tuple[str, Any]] = []
    input_types: List[InputType] = []
    rnn_of: Dict[str, bool] = {}    # layer name -> carries a time axis

    def resolve(names: List[str]) -> List[str]:
        return [alias.get(n, n) for n in names]

    for l in cfg["layers"]:
        cls = l["class_name"]
        conf = _cfg(l)
        name = l.get("name") or conf.get("name")
        raw_inbound = _inbound_names(l)
        inbound = resolve(raw_inbound)
        rnn_in = any(rnn_of.get(n, False) for n in raw_inbound)
        if cls == "InputLayer" or not inbound:
            it = _input_type_from(conf)
            if it is None:
                raise KerasImportError(
                    f"input layer '{name}' has no batch_input_shape")
            g.add_inputs(name)
            input_types.append(it)
            rnn_of[name] = it.kind == "rnn"
            continue
        if cls in _MERGE_ELEMENTWISE:
            g.add_vertex(name, ElementWiseVertex(op=_MERGE_ELEMENTWISE[cls]),
                         *inbound)
            rnn_of[name] = rnn_in
            continue
        if cls in ("Concatenate", "Merge"):
            mode = conf.get("mode", "concat")
            if cls == "Concatenate" or _MERGE_MODE.get(mode) is None:
                g.add_vertex(name, MergeVertex(), *inbound)
            else:
                g.add_vertex(name, ElementWiseVertex(op=_MERGE_MODE[mode]),
                             *inbound)
            rnn_of[name] = rnn_in
            continue
        rnn_of[name] = _carries_time(cls, conf, rnn_in, sequential=False)
        lm = _map_layer(cls, conf, is_last=name in out_names,
                        rnn_input=rnn_in)
        if lm.conf is None:  # Flatten: the automatic preprocessor reshapes
            alias[name] = inbound[0]
            continue
        g.add_layer(name, lm.conf, *inbound)
        copy_items.append((name, lm.copy))

    conf_built = (g.set_outputs(*resolve(out_names))
                  .set_input_types(*input_types).build())
    net = ComputationGraph(conf_built, device=device).init()
    pspec, sspec = net.param_spec(), net.state_spec()
    params, state = _copy_weights_into(_layer_weight_groups(f), [
        (lname, copy_fn, lname, pspec.get(lname, {}), sspec.get(lname, {}))
        for lname, copy_fn in copy_items])
    return _install(net, params, state)


class KerasModelImport:
    """Entry points (reference ``KerasModelImport.java:50-157``)."""

    @staticmethod
    def import_keras_sequential_model_and_weights(path, device="cuda"
                                                  ) -> MultiLayerNetwork:
        return import_keras_sequential_model(path, device=device)

    @staticmethod
    def import_keras_model_and_weights(path, device="cuda"):
        """Functional (or Sequential) model -> ComputationGraph (or
        MultiLayerNetwork)."""
        return import_keras_model(path, device=device)
