"""Batch-norm folding for inference (port of ``nn/fold.py``).

At inference a BatchNormalization layer is a per-channel affine transform
(running mean and variance), which folds exactly into the weights of the
convolution or dense layer before it.  ``fold_batch_norms(net)`` returns a
folded COPY for serving (the original keeps training): a params-only
network with no BN state to ship, and the same outputs to f32 rounding.
The foldable pattern: a Conv/Dense layer with identity activation feeding
a BatchNormalization directly (a graph's only consumer of that layer);
the BN slot becomes an ActivationLayer carrying the BN's activation.
Anything else (BN after pooling or a merge, a nonlinear conv) stays
unfused and runs BN in inference mode.  The fold is computed in float64
on the host and rounded to the params' dtype, as the JAX package's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .layers.convolution import Convolution1DLayer, ConvolutionLayer
from .layers.feedforward import ActivationLayer, DenseLayer
from .layers.normalization import BatchNormalization

__all__ = ["fold_batch_norms"]


def _bn_affine(bn: BatchNormalization, params, state
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel (scale, shift) of the BN inference transform."""
    mean = np.asarray(state["mean"], np.float64)
    var = np.asarray(state["var"], np.float64)
    scale = 1.0 / np.sqrt(var + bn.eps)
    shift = -mean * scale
    if not bn.lock_gamma_beta:
        gamma = np.asarray(params["gamma"], np.float64)
        beta = np.asarray(params["beta"], np.float64)
        scale = scale * gamma
        shift = shift * gamma + beta
    return scale, shift


def _fold_into(prev_params, scale, shift) -> Dict[str, np.ndarray]:
    """W' = W * scale (output-channel minor axis), b' = b*scale + shift,
    in float64 (the caller's spec rounds them to the params' dtype)."""
    W = np.asarray(prev_params["W"], np.float64)
    b = np.asarray(prev_params["b"], np.float64) if "b" in prev_params \
        else np.zeros(W.shape[-1])
    return {"W": W * scale, "b": b * scale + shift}


def _is_foldable_prev(layer) -> bool:
    return (isinstance(layer, (ConvolutionLayer, Convolution1DLayer,
                               DenseLayer))
            and getattr(layer, "activation", "identity") in
            ("identity", "linear", None))


def _replacement_activation(bn: BatchNormalization) -> ActivationLayer:
    act = getattr(bn, "activation", None) or "identity"
    repl = ActivationLayer(activation=act)
    # the BN's updaters, so that the folded net's updater labels match a
    # net built fresh from the folded configuration
    for attr in ("updater", "bias_updater"):
        if getattr(bn, attr, None) is not None:
            setattr(repl, attr, getattr(bn, attr))
    return repl


def fold_batch_norms(net):
    """An inference copy of ``net`` with every foldable Conv/Dense -> BN
    pair fused: a MultiLayerNetwork (adjacent layers) or a
    ComputationGraph (single-consumer layer vertices)."""
    from .computation_graph import ComputationGraph
    from .multilayer import MultiLayerNetwork
    if not isinstance(net, (MultiLayerNetwork, ComputationGraph)):
        raise TypeError(f"cannot fold {type(net).__name__}")
    out = net.clone()
    params = {k: {n: p.detach().cpu().numpy() for n, p in g.items()}
              for k, g in out.params.items()}
    state = {k: {n: t.cpu().numpy() for n, t in g.items()}
             for k, g in out.state.items()}
    if isinstance(net, MultiLayerNetwork):
        pairs = _fold_mln(out.conf)
        out._gen_programs = {}
    else:
        pairs = _fold_graph(out.conf)
    for prev_key, bn_key, bn in pairs:
        if not params.get(prev_key):
            continue
        scale, shift = _bn_affine(bn, params.get(bn_key, {}),
                                  state.get(bn_key, {}))
        params[prev_key] = _fold_into(params[prev_key], scale, shift)
        params[bn_key], state[bn_key] = {}, {}
    # the param tree changed shape (BN params gone, biases added): install
    # it against the folded configuration and rebuild the updater state
    out.load_params(params)
    out.load_state(state)
    out._init_updater()
    return out


def _give_bias(prev) -> None:
    """The (cloned) configuration's layer before a folded BN gets a bias:
    folding always makes one."""
    if hasattr(prev, "has_bias"):
        prev.has_bias = True


def _fold_mln(conf):
    """Fold the configuration's adjacent pairs; returns ``(prev key, BN
    key, BN conf)`` of each."""
    pairs = []
    for i in range(1, len(conf.layers)):
        bn, prev = conf.layers[i], conf.layers[i - 1]
        if not isinstance(bn, BatchNormalization) or \
                not _is_foldable_prev(prev):
            continue
        _give_bias(prev)
        pairs.append((f"layer_{i - 1}", f"layer_{i}", bn))
        conf.layers[i] = _replacement_activation(bn)
    return pairs


def _fold_graph(conf):
    """Fold the configuration's single-consumer pairs; returns ``(prev
    vertex, BN vertex, BN conf)`` of each."""
    from .conf.computation_graph import LayerVertex
    consumers: dict = {}
    for name, ins in conf.vertex_inputs.items():
        for src in ins:
            consumers.setdefault(src, []).append(name)
    pairs = []
    for name in list(conf.topological_order):
        v = conf.vertices[name]
        if not (isinstance(v, LayerVertex) and
                isinstance(v.layer, BatchNormalization)):
            continue
        srcs = conf.vertex_inputs[name]
        if len(srcs) != 1:
            continue
        src = srcs[0]
        pv = conf.vertices.get(src)
        if not (isinstance(pv, LayerVertex) and _is_foldable_prev(pv.layer)):
            continue
        if consumers.get(src) != [name]:   # the conv's output is used twice
            continue
        _give_bias(pv.layer)
        pairs.append((src, name, v.layer))
        conf.vertices[name] = LayerVertex(
            layer=_replacement_activation(v.layer))
    return pairs
