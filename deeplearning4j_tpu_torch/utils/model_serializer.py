"""Read a model container written by the JAX package (read-only port of
``utils/model_serializer.py``).

The container is a zip: ``configuration.json`` (``@class``-tagged config
JSON), ``metadata.json`` and ``params.npz``, whose keys are
``layer_i/name`` paths.  It is read with ``zipfile``, ``json`` and
``numpy`` alone.  Writing, state and updater restore come later.
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
