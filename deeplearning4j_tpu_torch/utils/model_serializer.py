"""Model save/restore — the JAX package's zip container, written and read
(port of ``utils/model_serializer.py``).

The container is a zip:

  configuration.json   ``@class``-tagged config JSON
  metadata.json        {"version", "net_class", "iteration", "epoch",
                        "has_updater"}
  params.npz           param tree, keys ``group/param`` (``layer_i`` for a
                       MultiLayerNetwork, the vertex name for a graph; a
                       nested group such as Bidirectional's is
                       ``group/fwd/W``)
  state.npz            layer state (BatchNorm running statistics) and a
                       precision policy's loss-scale state
  updater.npz          the optax state's leaves, ``leaf_<i>`` in
                       ``jax.tree_util`` flatten order

Both packages write and read the same bytes: a container the port wrote
restores in the JAX package with its updater state, and the other way
round.  The port keeps its updater state as ``{"count": {label: n},
"slots": {layer: {name: {slot: tensor}}}}``; ``updater_layout`` is the
map between that and optax's leaf order, one entry per leaf:

- a transform's state is a chain: the moment state (``count`` first for
  Adam, AdaMax, Nadam, AmsGrad, AdamW and Lion, then the slots in optax's
  field order, each a param-shaped tree), then the schedule's
  ``ScaleByScheduleState`` count where the learning rate is a schedule
  other than a fixed one; ``EmptyState`` parts, ``Sgd`` at a fixed rate
  and ``NoOp`` contribute no leaf;
- a param-shaped tree flattens in sorted key order at every level (so
  ``layer_10`` comes before ``layer_2``, and ``bwd`` before ``fwd``);
- where ``build_tx`` partitions the net (a layer's own updater or bias
  updater, or a frozen layer), ``multi_transform``'s inner states come
  in sorted label order over ``default``, ``frozen`` and the
  ``<layer>/w`` / ``<layer>/b`` groups, each slot tree holding only its
  label's params.

Reading goes through ``updater_state_from_jax``: the leaves are put back
into optax-shaped nodes (named tuples with optax's field names) and read
by field name, as a live JAX state is.

A label whose optax state holds no count (``Sgd``, ``Nesterovs``,
``AdaDelta``, ``AdaGrad`` and ``RmsProp`` at a fixed rate, ``NoOp``)
restores with count 0: no update of those reads it.

Durability: ``write_model`` commits through the atomic temp-then-rename
helper (``faulttolerance/atomic.py``).  With the tracer on, each member's
encoding (``container.encode``) and its deflate-and-write
(``container.deflate``) are spans.  A truncated or corrupt container
raises :class:`CorruptModelError` naming the path and the member that
failed.  Restore also accepts a checkpoint directory of the
``faulttolerance.CheckpointManager`` store (its ``model.zip``).  Restored
networks live on ``device`` (``"cuda"`` unless the caller passes
another).
"""
from __future__ import annotations

import collections
import io
import json
import os
import zipfile
import zlib
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from ..faulttolerance.atomic import atomic_file
from ..nn._common import Network
from ..nn.computation_graph import ComputationGraph
from ..nn.conf import updaters as _updaters
from ..nn.conf.computation_graph import ComputationGraphConfiguration
from ..nn.conf.multi_layer import MultiLayerConfiguration
from ..nn.conf.schedules import FixedSchedule, resolve as resolve_schedule
from ..nn.layers.base import flatten_group
from ..nn.multilayer import MultiLayerNetwork
from ..observability.tracer import get_tracer
from .device import resolve_device

__all__ = ["CorruptModelError", "write_model", "restore_model",
           "restore_multi_layer_network", "restore_computation_graph",
           "load_into", "load_reference_model", "params_from_jax",
           "state_from_jax", "updater_state_from_jax", "updater_layout"]

_VERSION = 1

# net_class in metadata.json -> (configuration class, network class)
_NET_CLASSES = {
    "MultiLayerNetwork": (MultiLayerConfiguration, MultiLayerNetwork),
    "ComputationGraph": (ComputationGraphConfiguration, ComputationGraph),
}

# updaters whose optax moment state carries its own step count
_MOMENT_COUNT = (_updaters.Adam, _updaters.AdaMax, _updaters.Nadam,
                 _updaters.AmsGrad, _updaters.Lion)


class CorruptModelError(RuntimeError):
    """A model container is truncated/corrupt.  Carries the ``path`` and,
    when known, the ``member`` inside the container that failed."""

    def __init__(self, path, member: Optional[str], detail: str):
        self.path = str(path)
        self.member = member
        where = f"{self.path}" + (f" [{member}]" if member else "")
        super().__init__(
            f"corrupt or truncated model container: {where}: {detail}")


# ------------------------------------------------------------ host copies
def _host(t) -> np.ndarray:
    """An owned host copy of a tensor (or array)."""
    if hasattr(t, "detach"):
        return t.detach().to("cpu", copy=True).numpy()
    return np.array(t)


def _host_tree(tree) -> Dict[str, Any]:
    return {k: _host_tree(v) if isinstance(v, Mapping) else _host(v)
            for k, v in tree.items()}


class HostModel:
    """Owned host copies of everything the container holds, taken
    synchronously (so a background writer never races live training);
    ``write_model`` accepts it in place of a network."""

    def __init__(self, net):
        self.net_class = getattr(net, "net_class", type(net).__name__)
        self.conf = net.conf
        self.params = {k: {n: _host(p) for n, p in g.items()}
                       for k, g in net.params.items()}
        self.state = _host_tree(net.state)
        self.tx = net._tx
        self.opt_state = None if net.opt_state is None else {
            "count": dict(net.opt_state["count"]),
            "slots": {k: {n: {s: _host(t) for s, t in sl.items()}
                          for n, sl in g.items()}
                      for k, g in net.opt_state["slots"].items()}}
        self.iteration = int(net.iteration)
        self.epoch = int(net.epoch)


# ------------------------------------------------------------ npz members
def _flatten(tree, prefix="", out=None) -> Dict[str, np.ndarray]:
    """``{"a": {"b": x}}`` -> ``{"a/b": x}`` (a port group's flat
    ``fwd/W`` names give the same keys as the JAX package's nesting)."""
    if out is None:
        out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            _flatten(v, path, out)
        else:
            out[path] = np.asarray(v)
    return out


def _tree_to_npz_bytes(tree) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **_flatten(tree))
    return buf.getvalue()


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


def _leaves_to_npz_bytes(leaves) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{f"leaf_{i}": np.asarray(l)
                     for i, l in enumerate(leaves)})
    return buf.getvalue()


def _npz_bytes_to_leaves(data: bytes) -> List[np.ndarray]:
    with np.load(io.BytesIO(data)) as z:
        return [z[f"leaf_{i}"] for i in range(len(z.files))]


# -------------------------------------------------- optax leaf order map
def _scheduled(u) -> bool:
    return u.learning_rate is not None and \
        not isinstance(resolve_schedule(u.learning_rate), FixedSchedule)


def _chain_nodes(u) -> List[Tuple[str, ...]]:
    """The leaf-bearing optax states of one transform's chain, in order,
    each as its field names: the moment state (``count`` first where it
    keeps one, then the slots) and the schedule's ``("count",)``."""
    if u is None or isinstance(u, _updaters.NoOp):
        return []
    moment = (("count",) if isinstance(u, _MOMENT_COUNT) else ()) + \
        tuple(u.SLOTS)
    nodes = [moment] if moment else []
    if _scheduled(u):
        nodes.append(("count",))
    return nodes


def _partitioned(tx) -> bool:
    """True where the JAX ``build_tx`` returns a ``multi_transform``."""
    return len(tx.transforms) > 1


def _labels_in_order(tx) -> List[str]:
    if not _partitioned(tx):
        return ["default"]
    return sorted(set(tx.transforms) | {"default", "frozen"})


def _params_of(tx, label: str, params) -> List[Tuple[str, str]]:
    """``(layer, name)`` of the params a label updates, in flatten order
    (sorted keys at every nesting level)."""
    out = []
    for layer in sorted(params):
        for name in sorted(params[layer], key=lambda n: n.split("/")):
            if tx.labels[layer][name] == label:
                out.append((layer, name))
    return out


def updater_layout(tx, params) -> List[Tuple]:
    """One descriptor per leaf of the JAX package's optax state, in
    ``jax.tree_util`` flatten order: ``("count", label)`` or ``("slot",
    label, layer, name, slot)``.  ``params`` gives the param names
    (``{layer: {name: ...}}``)."""
    layout: List[Tuple] = []
    for label in _labels_in_order(tx):
        owned = _params_of(tx, label, params)
        for fields in _chain_nodes(tx.transforms.get(label)):
            for f in fields:
                if f == "count":
                    layout.append(("count", label))
                else:
                    layout += [("slot", label, layer, name, f)
                               for layer, name in owned]
    return layout


def _updater_leaves(model) -> List[np.ndarray]:
    opt = model.opt_state
    leaves = []
    for d in updater_layout(model.tx, model.params):
        if d[0] == "count":
            leaves.append(np.asarray(opt["count"][d[1]], np.int32))
        else:
            _, _, layer, name, slot = d
            leaves.append(np.asarray(opt["slots"][layer][name][slot]))
    return leaves


def _optax_shaped(tx, params, leaves) -> Any:
    """Saved leaves put back into optax-shaped nodes (named tuples with
    optax's field names, slot trees keyed ``{layer: {name: leaf}}``), as
    ``updater_state_from_jax`` reads a live JAX state."""
    want = len(updater_layout(tx, params))
    if want != len(leaves):
        raise ValueError(
            f"updater state mismatch: saved {len(leaves)} leaves, model "
            f"needs {want}")
    it = iter(leaves)
    chains = {}
    for label in _labels_in_order(tx):
        owned = _params_of(tx, label, params)
        nodes = []
        for fields in _chain_nodes(tx.transforms.get(label)):
            values = []
            for f in fields:
                if f == "count":
                    values.append(next(it))
                    continue
                tree: Dict[str, Dict[str, Any]] = {}
                for layer, name in owned:
                    tree.setdefault(layer, {})[name] = next(it)
                values.append(tree)
            nodes.append(collections.namedtuple("State", fields)(*values))
        chains[label] = tuple(nodes)
    if not _partitioned(tx):
        return chains["default"]
    return collections.namedtuple("MultiTransformState",
                                  ["inner_states"])(chains)


# --------------------------------------------------------------- writing
def write_model(net, path, save_updater: bool = True) -> None:
    """Save a MultiLayerNetwork or ComputationGraph (reference
    ``ModelSerializer.writeModel``), or a :class:`HostModel` of one.  The
    zip is staged on a temp path and atomically renamed into place."""
    model = net if isinstance(net, HostModel) else HostModel(net)
    meta = {
        "version": _VERSION,
        "net_class": model.net_class,
        "iteration": model.iteration,
        "epoch": model.epoch,
        "has_updater": bool(save_updater and model.opt_state is not None),
    }
    members = [("configuration.json", model.conf.to_json),
               ("metadata.json", lambda: json.dumps(meta)),
               ("params.npz", lambda: _tree_to_npz_bytes(model.params)),
               ("state.npz", lambda: _tree_to_npz_bytes(model.state))]
    if meta["has_updater"]:
        members.append(("updater.npz", lambda: _leaves_to_npz_bytes(
            _updater_leaves(model))))
    tracer = get_tracer()
    with atomic_file(str(path)) as tmp:
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as zf:
            for name, encode in members:
                with tracer.span("container.encode", member=name):
                    data = encode()
                with tracer.span("container.deflate", member=name):
                    zf.writestr(name, data)


# --------------------------------------------------------------- reading
def _read_member(zf: zipfile.ZipFile, name: str, path) -> bytes:
    try:
        return zf.read(name)
    except KeyError:
        raise CorruptModelError(path, name, "member missing from container")
    except (zipfile.BadZipFile, zlib.error, EOFError, OSError) as e:
        raise CorruptModelError(path, name, f"{type(e).__name__}: {e}")


def _load_npz(data: bytes, member: str, path, loader):
    try:
        return loader(data)
    except (ValueError, KeyError, OSError, zipfile.BadZipFile,
            zlib.error, EOFError) as e:
        raise CorruptModelError(path, member, f"{type(e).__name__}: {e}")


def _read_container(path, load_updater: bool):
    """``(meta, conf JSON, params, state, updater leaves)`` from a model
    zip, every truncation or corruption raised as CorruptModelError."""
    try:
        zf = zipfile.ZipFile(path, "r")
    except (zipfile.BadZipFile, EOFError) as e:
        raise CorruptModelError(path, None, f"{type(e).__name__}: {e}")
    with zf:
        try:
            meta = json.loads(_read_member(zf, "metadata.json", path))
        except ValueError as e:
            raise CorruptModelError(path, "metadata.json", str(e))
        conf_json = _read_member(zf, "configuration.json", path).decode()
        params = _load_npz(_read_member(zf, "params.npz", path),
                           "params.npz", path, _npz_bytes_to_tree)
        state = _load_npz(_read_member(zf, "state.npz", path),
                          "state.npz", path, _npz_bytes_to_tree)
        updater_leaves = None
        if load_updater and meta.get("has_updater") and \
                "updater.npz" in zf.namelist():
            updater_leaves = _load_npz(
                _read_member(zf, "updater.npz", path), "updater.npz", path,
                _npz_bytes_to_leaves)
    return meta, conf_json, params, state, updater_leaves


def _model_payload_path(path) -> str:
    """A checkpoint directory's ``model.zip``, or the path itself."""
    p = str(path)
    if os.path.isdir(p):
        inner = os.path.join(p, "model.zip")
        if os.path.isfile(inner):
            return inner
        raise CorruptModelError(p, "model.zip",
                                "directory has no model.zip payload")
    return p


def _classes(meta, path):
    classes = _NET_CLASSES.get(meta.get("net_class"))
    if classes is None:
        raise NotImplementedError(
            f"{path}: net_class {meta.get('net_class')!r} is not ported "
            f"yet; ported: {sorted(_NET_CLASSES)}")
    return classes


def _install(net: Network, meta, params, state, updater_leaves) -> None:
    params_from_jax(net, params)
    state_from_jax(net, state)
    if updater_leaves is not None:
        updater_state_from_jax(net, _optax_shaped(
            net._tx, net._param_tree(), updater_leaves))
    net.iteration = int(meta.get("iteration", 0))
    net.epoch = int(meta.get("epoch", 0))


def _restore(path, expect_class: Optional[str], load_updater: bool,
             device) -> Network:
    path = _model_payload_path(path)
    meta, conf_json, params, state, updater_leaves = _read_container(
        path, load_updater)
    if expect_class and meta.get("net_class") != expect_class:
        raise ValueError(
            f"saved model is a {meta.get('net_class')}, not a "
            f"{expect_class}")
    conf_cls, net_cls = _classes(meta, path)
    try:
        conf = conf_cls.from_json(conf_json)
    except Exception as e:
        raise CorruptModelError(path, "configuration.json",
                                f"{type(e).__name__}: {e}") from e
    net = net_cls(conf, device=resolve_device(device))
    _install(net, meta, params, state, updater_leaves)
    return net


def restore_multi_layer_network(path, load_updater: bool = True,
                                device="cuda") -> MultiLayerNetwork:
    """Reference ``ModelSerializer.restoreMultiLayerNetwork``."""
    return _restore(path, "MultiLayerNetwork", load_updater, device)


def restore_computation_graph(path, load_updater: bool = True,
                              device="cuda") -> ComputationGraph:
    """Reference ``ModelSerializer.restoreComputationGraph``."""
    return _restore(path, "ComputationGraph", load_updater, device)


def restore_model(path, load_updater: bool = True,
                  device="cuda") -> Network:
    """Load either network type, with its updater state, iteration and
    epoch (reference ``ModelGuesser``'s role)."""
    return _restore(path, None, load_updater, device)


def load_into(net: Network, path, load_updater: bool = True) -> None:
    """Restore a saved container INTO ``net`` (same topology; params,
    state, optionally updater state, iteration and epoch), on the
    network's own device: the checkpoint-resume path keeps the caller's
    network object."""
    path = _model_payload_path(path)
    meta, _conf, params, state, updater_leaves = _read_container(
        path, load_updater)
    if meta.get("net_class") != type(net).__name__:
        raise ValueError(
            f"saved model is a {meta.get('net_class')}, not a "
            f"{type(net).__name__}")
    _install(net, meta, params, state, updater_leaves)


def load_reference_model(path, device="cuda") -> Network:
    """A ``MultiLayerNetwork`` or ``ComputationGraph`` on ``device`` from a
    ``write_model`` zip, with its params and state (fresh updater state,
    iteration 0)."""
    device = resolve_device(device)
    meta, conf_json, params, state, _ = _read_container(path, False)
    conf_cls, net_cls = _classes(meta, path)
    net = params_from_jax(net_cls(conf_cls.from_json(conf_json),
                                  device=device), params)
    return state_from_jax(net, state)


# ------------------------------------------------- live JAX trees across
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
