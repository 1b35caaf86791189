"""Read a model container written by the JAX package (read-only port of
``utils/model_serializer.py``).

The container is a zip: ``configuration.json`` (``@class``-tagged config
JSON), ``metadata.json``, ``params.npz`` and ``state.npz``, whose keys
are ``group/name`` paths (``layer_i`` for a MultiLayerNetwork, the
vertex name for a ComputationGraph; the state holds BatchNorm running
statistics).  It is read with ``zipfile``, ``json`` and ``numpy`` alone.
``params_from_jax``, ``state_from_jax`` and ``updater_state_from_jax``
carry a live JAX network's weights, state and optax state across.
Writing and restoring updater state from a container come later.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Dict, Mapping

import numpy as np

from ..nn._common import Network
from ..nn.layers.base import flatten_group
from ..nn.computation_graph import ComputationGraph
from ..nn.conf.computation_graph import ComputationGraphConfiguration
from ..nn.conf.multi_layer import MultiLayerConfiguration
from ..nn.multilayer import MultiLayerNetwork
from .device import resolve_device

# net_class in metadata.json -> (configuration class, network class)
_NET_CLASSES = {
    "MultiLayerNetwork": (MultiLayerConfiguration, MultiLayerNetwork),
    "ComputationGraph": (ComputationGraphConfiguration, ComputationGraph),
}


class CorruptModelError(RuntimeError):
    """A container is truncated, corrupt or missing a member."""


def _npz_bytes_to_tree(data: bytes) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    with np.load(io.BytesIO(data)) as z:
        for k in z.files:
            parts = k.split("/")
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[k]
    return out


def _read(zf: zipfile.ZipFile, name: str, path) -> bytes:
    try:
        return zf.read(name)
    except KeyError:
        raise CorruptModelError(f"{path}: member {name} missing") from None


def params_from_jax(net: Network, params: Mapping[str, Mapping[str, Any]]
                    ) -> Network:
    """Install the JAX package's param tree (``{group: {name: array}}``
    of numpy arrays, as ``net.params`` there) into ``net``; returns it."""
    return net.load_params(params)


def state_from_jax(net: Network, state: Mapping[str, Mapping[str, Any]]
                   ) -> Network:
    """Install the JAX package's state tree (``net.state`` there: BatchNorm
    running mean and var) into ``net``; returns it."""
    return net.load_state(state)


def _optax_node(state, fields):
    """The first namedtuple in an optax state (nested tuples) that has all
    of ``fields``, or None."""
    if set(fields) <= set(getattr(state, "_fields", ())):
        return state
    if isinstance(state, (tuple, list)):
        for s in state:
            found = _optax_node(s, fields)
            if found is not None:
                return found
    return None


def updater_state_from_jax(net: Network, opt_state) -> Network:
    """Install the JAX package's optax state (``net.opt_state`` there,
    leaves as numpy or JAX arrays) into ``net``, so both sides continue
    from the same mid-training state.  Every updater's slots are read by
    their optax field names (``ScaleByAdamState`` mu/nu for Adam, Nadam,
    AdamW and AdaMax; ``ScaleByAmsgradState`` mu/nu/nu_max;
    ``ScaleByAdaDeltaState`` e_g/e_x; ``ScaleByRssState``
    sum_of_squares; ``ScaleByRmsState`` nu; ``ScaleByLionState`` mu;
    ``TraceState`` trace), and each label's step count from the first
    state in its chain that has one (the moments' or the schedule's
    ``ScaleByScheduleState``); stateless updaters (``Sgd`` at a fixed
    rate, ``NoOp``) keep 0.  One transform may serve the whole network,
    or ``multi_transform`` may partition it by updater label, as
    ``nn/_common.build_tx`` does; slots are keyed by layer (``layer_i``)
    or vertex name, as the params, and a nested group
    (``Bidirectional``'s ``fwd``/``bwd``) is read through the port's flat
    names (``fwd/W``)."""
    import torch
    tx = net._tx
    inner = getattr(opt_state, "inner_states", None)
    if inner is None and len(tx.transforms) > 1:
        raise ValueError("updater_state_from_jax: the network has several "
                         "updater groups but the state is not partitioned")
    state = net.opt_state
    for label, u in tx.transforms.items():
        if u is None:
            continue
        src_state = opt_state if inner is None else inner[label]
        counted = _optax_node(src_state, ("count",))
        if counted is not None:
            state["count"][label] = int(np.asarray(counted.count))
        if not u.SLOTS:
            continue
        node = _optax_node(src_state, u.SLOTS)
        if node is None:
            raise ValueError(f"updater_state_from_jax: no optax state with "
                             f"fields {u.SLOTS} for group '{label}'")
        for layer, names in tx.labels.items():
            for name, lab in names.items():
                if lab != label:
                    continue
                slots = state["slots"][layer][name]
                for slot in u.SLOTS:
                    src = np.asarray(flatten_group(
                        dict(getattr(node, slot)[layer]))[name])
                    if src.shape != tuple(slots[slot].shape):
                        raise ValueError(
                            f"{layer}/{name}/{slot}: shape {src.shape} != "
                            f"{tuple(slots[slot].shape)}")
                    slots[slot] = torch.tensor(
                        src, dtype=slots[slot].dtype,
                        device=slots[slot].device)
    return net


def load_reference_model(path, device="cuda") -> Network:
    """A ``MultiLayerNetwork`` or ``ComputationGraph`` on ``device`` from a
    ``write_model`` zip, with its params and state."""
    device = resolve_device(device)
    try:
        with zipfile.ZipFile(path, "r") as zf:
            meta = json.loads(_read(zf, "metadata.json", path))
            conf_json = _read(zf, "configuration.json", path).decode()
            params = _npz_bytes_to_tree(_read(zf, "params.npz", path))
            state = _npz_bytes_to_tree(_read(zf, "state.npz", path))
    except (zipfile.BadZipFile, EOFError, ValueError, OSError) as e:
        raise CorruptModelError(f"{path}: {type(e).__name__}: {e}") from e
    classes = _NET_CLASSES.get(meta.get("net_class"))
    if classes is None:
        raise NotImplementedError(
            f"{path}: net_class {meta.get('net_class')!r} is not ported "
            f"yet; ported: {sorted(_NET_CLASSES)}")
    conf_cls, net_cls = classes
    net = params_from_jax(net_cls(conf_cls.from_json(conf_json),
                                  device=device), params)
    return state_from_jax(net, state)
