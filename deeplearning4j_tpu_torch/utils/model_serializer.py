"""Read a model container written by the JAX package (read-only port of
``utils/model_serializer.py``).

The container is a zip: ``configuration.json`` (``@class``-tagged config
JSON), ``metadata.json`` and ``params.npz``, whose keys are
``layer_i/name`` paths.  It is read with ``zipfile``, ``json`` and
``numpy`` alone.  ``params_from_jax`` and ``updater_state_from_jax``
carry a live JAX network's weights and optax state across.  Writing and
restoring updater state from a container come later.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Dict, Mapping

import numpy as np

from ..nn.conf.multi_layer import MultiLayerConfiguration
from ..nn.multilayer import MultiLayerNetwork
from .device import resolve_device


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


def params_from_jax(net: MultiLayerNetwork,
                    params: Mapping[str, Mapping[str, Any]]
                    ) -> MultiLayerNetwork:
    """Install the JAX package's param tree (``{layer_i: {name: array}}``
    of numpy arrays, as ``net.params`` there) into ``net``; returns it."""
    return net.load_params(params)


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


def updater_state_from_jax(net: MultiLayerNetwork, opt_state
                           ) -> MultiLayerNetwork:
    """Install the JAX package's optax state (``net.opt_state`` there,
    leaves as numpy or JAX arrays) into ``net``, so both sides continue
    from the same mid-training state.  Ported: ``Adam``
    (``ScaleByAdamState(count, mu, nu)``), ``Nesterovs``
    (``TraceState(trace)``) and ``Sgd`` (no state), whether one transform
    serves the whole network or ``multi_transform`` partitions it by
    updater label, as ``nn/_common.build_tx`` does."""
    import torch
    tx = net._tx
    inner = getattr(opt_state, "inner_states", None)
    if inner is None and len(tx.transforms) > 1:
        raise ValueError("updater_state_from_jax: the network has several "
                         "updater groups but the state is not partitioned")
    state = net.opt_state
    for label, u in tx.transforms.items():
        if u is None or not u.SLOTS:
            continue
        node = _optax_node(opt_state if inner is None else inner[label],
                           u.SLOTS)
        if node is None:
            raise ValueError(f"updater_state_from_jax: no optax state with "
                             f"fields {u.SLOTS} for group '{label}'")
        for layer, names in tx.labels.items():
            for name, lab in names.items():
                if lab != label:
                    continue
                slots = state["slots"][layer][name]
                for slot in u.SLOTS:
                    src = np.asarray(getattr(node, slot)[layer][name])
                    if src.shape != tuple(slots[slot].shape):
                        raise ValueError(
                            f"{layer}/{name}/{slot}: shape {src.shape} != "
                            f"{tuple(slots[slot].shape)}")
                    slots[slot] = torch.tensor(
                        src, dtype=slots[slot].dtype,
                        device=slots[slot].device)
        if "count" in node._fields:    # (a namedtuple's .count is a method)
            state["count"][label] = int(np.asarray(node.count))
    return net


def load_reference_model(path, device="cuda") -> MultiLayerNetwork:
    """A ``MultiLayerNetwork`` on ``device`` from a ``write_model`` zip."""
    device = resolve_device(device)
    try:
        with zipfile.ZipFile(path, "r") as zf:
            meta = json.loads(_read(zf, "metadata.json", path))
            conf_json = _read(zf, "configuration.json", path).decode()
            params = _npz_bytes_to_tree(_read(zf, "params.npz", path))
    except (zipfile.BadZipFile, EOFError, ValueError, OSError) as e:
        raise CorruptModelError(f"{path}: {type(e).__name__}: {e}") from e
    if meta.get("net_class") != "MultiLayerNetwork":
        raise NotImplementedError(
            f"{path}: net_class {meta.get('net_class')!r} is not ported "
            "yet; only MultiLayerNetwork")
    conf = MultiLayerConfiguration.from_json(conf_json)
    return params_from_jax(MultiLayerNetwork(conf, device=device), params)
