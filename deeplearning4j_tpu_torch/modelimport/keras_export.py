"""Export networks to Keras-2-layout HDF5 (port of
``modelimport/keras_export.py``).

The reverse of ``keras.py``: ``export_keras_sequential`` writes a
``MultiLayerNetwork`` as a Keras ``Sequential`` ``model.save()`` file and
``export_keras_model`` a ``ComputationGraph`` as a functional ``Model``,
with the port's own ``Hdf5Writer``.  For the same configuration, params
and state the bytes equal the JAX package's export.  What Keras has no
field for is not written: a layer's dropout, a BatchNormalization's
activation, a pooling layer's padding mode.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np

from .hdf5_writer import Hdf5Writer

__all__ = ["export_keras_sequential", "export_keras_model"]

_ACT_INV = {
    "relu": "relu", "tanh": "tanh", "sigmoid": "sigmoid",
    "softmax": "softmax", "identity": "linear", "elu": "elu",
    "selu": "selu", "softplus": "softplus", "softsign": "softsign",
    "hardsigmoid": "hard_sigmoid", "swish": "swish", "gelu": "gelu",
}


def _act_name(layer) -> str:
    a = layer.resolved("activation", "identity")
    if a not in _ACT_INV:
        raise ValueError(f"activation '{a}' has no Keras name")
    return _ACT_INV[a]


def _np(p) -> np.ndarray:
    return np.asarray(p, np.float32)


def _pair_list(v) -> list:
    if isinstance(v, (tuple, list)):
        return [int(x) for x in v]
    return [int(v), int(v)]


def _lstm_to_keras(m, h: int):
    """The port's gate blocks i,f,o,g (g = c) -> Keras's i,f,c,o."""
    blocks = [m[..., g * h:(g + 1) * h] for g in range(4)]
    return np.concatenate([blocks[0], blocks[1], blocks[3], blocks[2]],
                          axis=-1)


def _export_layer(i: int, lc, params: Dict[str, Any],
                  state: Dict[str, Any], input_shape: Optional[list],
                  input_kind: Optional[str] = None):
    """Returns ``(keras_layer_config, {weight_name: array})``."""
    cls = type(lc).__name__
    name = lc.name or f"layer_{i}"
    conf: Dict[str, Any] = {"name": name}
    if input_shape is not None:
        conf["batch_input_shape"] = input_shape
    if cls in ("DenseLayer", "OutputLayer", "CenterLossOutputLayer",
               "RnnOutputLayer"):   # a Keras Dense maps over [b, t, f] too
        conf.update(units=int(lc.n_out), activation=_act_name(lc),
                    use_bias=bool(getattr(lc, "has_bias", True)))
        w = {"kernel:0": _np(params["W"])}
        if "b" in params:
            w["bias:0"] = _np(params["b"])
        return {"class_name": "Dense", "config": conf}, w
    if cls == "ConvolutionLayer":
        pad = _pair_list(getattr(lc, "padding", (0, 0)))
        dil = _pair_list(getattr(lc, "dilation", (1, 1)))
        if lc.convolution_mode != "same" and any(pad):
            raise ValueError(
                f"layer {name}: explicit padding {pad} has no Keras "
                "Sequential equivalent (use convolution_mode='same' or "
                "zero padding layers)")
        if any(d != 1 for d in dil):
            raise ValueError(
                f"layer {name}: dilation {dil} is not exported")
        conf.update(filters=int(lc.n_out),
                    kernel_size=_pair_list(lc.kernel_size),
                    strides=_pair_list(lc.stride),
                    padding="same" if lc.convolution_mode == "same"
                    else "valid",
                    activation=_act_name(lc),
                    use_bias=bool(lc.has_bias))
        w = {"kernel:0": _np(params["W"])}   # HWIO both sides
        if "b" in params:
            w["bias:0"] = _np(params["b"])
        return {"class_name": "Conv2D", "config": conf}, w
    if cls == "SubsamplingLayer":
        kname = ("MaxPooling2D" if lc.pooling_type == "max"
                 else "AveragePooling2D")
        conf.update(pool_size=_pair_list(lc.kernel_size),
                    strides=_pair_list(lc.stride))
        return {"class_name": kname, "config": conf}, {}
    if cls == "BatchNormalization":
        conf.update(epsilon=float(lc.eps), momentum=float(lc.decay))
        if state.get("mean") is None or state.get("var") is None:
            raise ValueError(
                f"layer {name}: BatchNormalization has no moving statistics "
                "in net.state — initialize/train the network before export")
        w = {}
        if "gamma" in params:
            w["gamma:0"] = _np(params["gamma"])
            w["beta:0"] = _np(params["beta"])
        w["moving_mean:0"] = _np(state["mean"])
        w["moving_variance:0"] = _np(state["var"])
        return {"class_name": "BatchNormalization", "config": conf}, w
    if cls == "LSTM":
        h = int(lc.n_out)
        gate = getattr(lc, "gate_activation", "sigmoid")
        if gate not in _ACT_INV:
            raise ValueError(
                f"layer {name}: gate activation '{gate}' has no Keras name")
        conf.update(units=h, activation=_act_name(lc),
                    recurrent_activation=_ACT_INV[gate],
                    return_sequences=True)
        return {"class_name": "LSTM", "config": conf}, {
            "kernel:0": _lstm_to_keras(_np(params["W"]), h),
            "recurrent_kernel:0": _lstm_to_keras(_np(params["U"]), h),
            "bias:0": _lstm_to_keras(_np(params["b"]).reshape(1, -1),
                                     h).reshape(-1)}
    if cls == "SimpleRnn":
        conf.update(units=int(lc.n_out), activation=_act_name(lc),
                    return_sequences=True)
        return {"class_name": "SimpleRNN", "config": conf}, {
            "kernel:0": _np(params["W"]),
            "recurrent_kernel:0": _np(params["U"]),
            "bias:0": _np(params["b"])}
    if cls == "EmbeddingLayer":
        conf.update(input_dim=int(lc.n_in), output_dim=int(lc.n_out))
        return {"class_name": "Embedding", "config": conf}, {
            "embeddings:0": _np(params["W"])}
    if cls == "ActivationLayer":
        conf.update(activation=_act_name(lc))
        return {"class_name": "Activation", "config": conf}, {}
    if cls == "DropoutLayer":
        conf.update(rate=1.0 - float(lc.dropout))
        return {"class_name": "Dropout", "config": conf}, {}
    if cls == "GlobalPoolingLayer":
        dim = "1D" if input_kind == "rnn" else "2D"
        kname = (f"GlobalMaxPooling{dim}" if lc.pooling_type == "max"
                 else f"GlobalAveragePooling{dim}")
        return {"class_name": kname, "config": conf}, {}
    raise ValueError(
        f"layer {name} ({cls}) has no Keras export mapping")


def _input_shape(itype) -> Optional[list]:
    if itype is None:
        return None
    if itype.kind == "ff":
        return [None, int(itype.size)]
    if itype.kind == "rnn":
        t = itype.timesteps
        return [None, None if not t or t < 0 else int(t), int(itype.size)]
    if itype.kind in ("cnn", "cnnflat"):
        return [None, int(itype.height), int(itype.width),
                int(itype.channels)]
    return None


def _host(tree) -> Dict[str, Dict[str, np.ndarray]]:
    """``{key: {name: tensor}}`` as host numpy arrays."""
    return {k: {n: t.detach().cpu().numpy() for n, t in g.items()}
            for k, g in tree.items()}


def _save(tree, attrs, layer_names, config, path: Optional[str]) -> bytes:
    attrs["/"] = {"model_config": json.dumps(config),
                  "keras_version": "2.1.6", "backend": "tensorflow"}
    attrs["/model_weights"] = {"layer_names": layer_names,
                               "backend": "tensorflow"}
    data = Hdf5Writer().write(tree, attrs)
    if path:
        with open(path, "wb") as fh:
            fh.write(data)
    return data


def _add_weights(tree, attrs, lname: str, weights: Dict[str, Any]) -> None:
    tree["model_weights"][lname] = dict(weights)
    attrs[f"/model_weights/{lname}"] = {
        "weight_names": [f"{lname}/{wn}" for wn in weights]}


def export_keras_sequential(net, path: Optional[str] = None) -> bytes:
    """Write ``net`` (a MultiLayerNetwork) as a Keras-2 Sequential
    ``model.save()``-layout HDF5; returns the bytes (and writes ``path``
    when given)."""
    layer_entries: List[dict] = []
    tree: Dict[str, Any] = {"model_weights": {}}
    attrs: Dict[str, Dict[str, Any]] = {}
    layer_names: List[str] = []
    params, state = _host(net._param_tree()), _host(net.state)
    layer_itypes = getattr(net.conf, "layer_input_types", None) or []
    for i, lc in enumerate(net.conf.layers):
        ishape = _input_shape(net.conf.input_type) if i == 0 else None
        ikind = (layer_itypes[i].kind if i < len(layer_itypes)
                 and layer_itypes[i] is not None else None)
        kconf, weights = _export_layer(
            i, lc, params.get(f"layer_{i}", {}), state.get(f"layer_{i}", {}),
            ishape, input_kind=ikind)
        lname = kconf["config"]["name"]
        layer_entries.append(kconf)
        layer_names.append(lname)
        _add_weights(tree, attrs, lname, weights)
    config = {"class_name": "Sequential",
              "config": {"name": "sequential", "layers": layer_entries}}
    return _save(tree, attrs, layer_names, config, path)


_EW_TO_KERAS = {"add": "Add", "subtract": "Subtract", "product": "Multiply",
                "average": "Average", "max": "Maximum"}


def export_keras_model(net, path: Optional[str] = None) -> bytes:
    """Write a ComputationGraph as a Keras functional ``Model`` HDF5
    (the inverse of ``import_keras_model``): layer vertices with the
    Sequential layer mappings, elementwise vertices as the Keras merge
    layers, MergeVertex as Concatenate; other vertex types raise."""
    from ..nn.conf.computation_graph import (ElementWiseVertex, LayerVertex,
                                             MergeVertex)
    conf = net.conf
    layer_entries: List[dict] = []
    tree: Dict[str, Any] = {"model_weights": {}}
    attrs: Dict[str, Dict[str, Any]] = {}
    layer_names: List[str] = []
    params, state = _host(net._param_tree()), _host(net.state)

    for idx, name in enumerate(conf.network_inputs):
        it = conf.input_types[idx] if idx < len(conf.input_types) else None
        shape = _input_shape(it)
        if shape is None:
            raise ValueError(f"network input '{name}' needs an InputType "
                             "for Keras export")
        layer_entries.append({
            "class_name": "InputLayer", "name": name,
            "config": {"name": name, "batch_input_shape": shape},
            "inbound_nodes": []})

    for name in conf.topological_order:
        v = conf.vertices[name]
        inbound = [[[src, 0, 0, {}] for src in conf.vertex_inputs[name]]]
        if isinstance(v, ElementWiseVertex):
            if v.op not in _EW_TO_KERAS:
                raise ValueError(f"vertex {name}: elementwise op '{v.op}' "
                                 "has no Keras merge layer")
            layer_entries.append({
                "class_name": _EW_TO_KERAS[v.op], "name": name,
                "config": {"name": name}, "inbound_nodes": inbound})
            continue
        if isinstance(v, MergeVertex):
            layer_entries.append({
                "class_name": "Concatenate", "name": name,
                "config": {"name": name}, "inbound_nodes": inbound})
            continue
        if not isinstance(v, LayerVertex):
            raise ValueError(
                f"vertex {name} ({type(v).__name__}) has no Keras export "
                "mapping")
        itypes = conf.vertex_input_types.get(name) or [None]
        ikind = itypes[0].kind if itypes and itypes[0] is not None else None
        kconf, weights = _export_layer(
            0, v.layer, params.get(name, {}), state.get(name, {}), None,
            input_kind=ikind)
        kconf["config"]["name"] = name
        kconf["name"] = name
        kconf["inbound_nodes"] = inbound
        layer_entries.append(kconf)
        layer_names.append(name)
        _add_weights(tree, attrs, name, weights)

    config = {"class_name": "Model", "config": {
        "name": "model", "layers": layer_entries,
        "input_layers": [[n, 0, 0] for n in conf.network_inputs],
        "output_layers": [[n, 0, 0] for n in conf.network_outputs]}}
    return _save(tree, attrs, layer_names, config, path)
