"""Transfer learning: copy a trained network, edit it, keep its weights
(port of ``nn/transfer_learning.py``; reference
``nn/transferlearning/TransferLearning.java:32``, ``FineTuneConfiguration``,
``TransferLearningHelper``).

The builders deep-copy the source configuration, apply every edit
(fine-tune overrides, ``n_out_replace``, freezing, removed and added
layers or vertices) and build a fresh network on the source's device;
the retained layers' params and state are then copied over the fresh
init and the updater state is made for the new tree.  Freezing wraps a
layer in ``FrozenLayer``: it runs in inference mode with its params
detached, and its updater group is ``frozen`` (no update, no state).
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import torch

from ._common import hyperparam_conf
from .layers.base import INHERITED_DEFAULTS
from .layers.misc import FrozenLayer
from .multilayer import MultiLayerNetwork, _stack_forward


def _copy_group(group) -> Dict[str, torch.Tensor]:
    return {n: t.detach().clone() for n, t in group.items()}


def _graft(net, params: Dict[str, Dict[str, torch.Tensor]],
           state: Dict[str, Dict[str, torch.Tensor]],
           fresh_updater: bool = True) -> None:
    """Replace groups of ``net``'s params and state; with
    ``fresh_updater``, make fresh updater state for the new tree."""
    with torch.no_grad():
        for k, g in params.items():
            for n, t in g.items():
                net.params[k][n] = torch.nn.Parameter(
                    t, requires_grad=t.is_floating_point())
    net.state.update(state)
    if fresh_updater:
        net._init_updater()


def _apply_fine_tune(conf, layers, overrides: Dict[str, Any]) -> None:
    """FineTuneConfiguration semantics: overrides REPLACE existing values on
    the conf defaults and on every (non-frozen) layer."""
    for k, v in overrides.items():
        if k == "seed":
            conf.seed = int(v)
            continue
        if k not in INHERITED_DEFAULTS:
            raise ValueError(f"unknown fine-tune override '{k}'")
        conf.defaults[k] = v
        for lc in layers:
            if isinstance(lc, FrozenLayer):
                continue
            hc = hyperparam_conf(lc)
            if hc is not None and hasattr(hc, k):
                setattr(hc, k, v)


class TransferLearning:
    """Namespace matching the reference entry point."""

    class Builder:
        """MultiLayerNetwork transfer-learning builder."""

        def __init__(self, net: MultiLayerNetwork):
            self._net = net
            self._conf = copy.deepcopy(net.conf)
            # (new_layer_conf, old_index or None, needs_reinit)
            self._plan: List[List[Any]] = [
                [lc, i, False] for i, lc in enumerate(self._conf.layers)]
            self._fine_tune: Dict[str, Any] = {}
            self._frozen_until = -1

        def fine_tune_configuration(self, **overrides
                                    ) -> "TransferLearning.Builder":
            self._fine_tune.update(overrides)
            return self

        def set_feature_extractor(self, layer_index: int
                                  ) -> "TransferLearning.Builder":
            """Freeze layers 0..layer_index inclusive."""
            self._frozen_until = int(layer_index)
            return self

        def remove_output_layer(self) -> "TransferLearning.Builder":
            return self.remove_layers_from_output(1)

        def remove_layers_from_output(self, n: int
                                      ) -> "TransferLearning.Builder":
            if n > len(self._plan):
                raise ValueError(
                    f"cannot remove {n} of {len(self._plan)} layers")
            del self._plan[len(self._plan) - n:]
            return self

        def add_layer(self, layer_conf) -> "TransferLearning.Builder":
            self._plan.append([layer_conf, None, True])
            return self

        def n_out_replace(self, layer_index: int, n_out: int,
                          weight_init: Optional[str] = None
                          ) -> "TransferLearning.Builder":
            """Replace a layer's n_out; it and the next layer are
            re-initialized (reference nOutReplace)."""
            lc = copy.deepcopy(self._plan[layer_index][0])
            lc.n_out = int(n_out)
            if weight_init is not None:
                hc = hyperparam_conf(lc)
                if hc is not None:
                    hc.weight_init = weight_init
            self._plan[layer_index] = [lc, None, True]
            if layer_index + 1 < len(self._plan):
                nlc = copy.deepcopy(self._plan[layer_index + 1][0])
                if hasattr(nlc, "n_in"):
                    nlc.n_in = 0  # re-inferred from the new upstream width
                self._plan[layer_index + 1] = [nlc, None, True]
            return self

        def build(self) -> MultiLayerNetwork:
            new_layers = []
            for i, (lc, old_idx, _) in enumerate(self._plan):
                if old_idx is not None and i <= self._frozen_until:
                    lc = FrozenLayer(underlying=lc, name=lc.name)
                new_layers.append(lc)
            conf = self._conf
            conf.layers = new_layers
            _apply_fine_tune(conf, new_layers, self._fine_tune)
            # drop auto-inserted preprocessors from the first structural
            # change onward: resolve() re-infers them for the new layout
            first_changed = len(self._plan)
            for i, (_, old_idx, reinit) in enumerate(self._plan):
                if old_idx is None or reinit:
                    first_changed = i
                    break
            conf.input_preprocessors = {
                k: v for k, v in conf.input_preprocessors.items()
                if int(k) < first_changed}
            conf.layer_input_types = []
            src = self._net
            net = MultiLayerNetwork(conf, device=src.device).init()
            params, state = {}, {}
            for i, (_, old_idx, reinit) in enumerate(self._plan):
                if old_idx is None or reinit:
                    continue
                params[f"layer_{i}"] = _copy_group(
                    src.params[f"layer_{old_idx}"])
                state[f"layer_{i}"] = _copy_group(
                    src.state.get(f"layer_{old_idx}", {}))
            _graft(net, params, state)
            return net

    class GraphBuilder:
        """ComputationGraph transfer-learning builder."""

        def __init__(self, net):
            self._net = net
            self._conf = copy.deepcopy(net.conf)
            self._fine_tune: Dict[str, Any] = {}
            self._frozen: set = set()
            self._reinit: set = set()
            self._removed: set = set()

        def fine_tune_configuration(self, **overrides
                                    ) -> "TransferLearning.GraphBuilder":
            self._fine_tune.update(overrides)
            return self

        def set_feature_extractor(self, *vertex_names: str
                                  ) -> "TransferLearning.GraphBuilder":
            """Freeze the named vertices and everything upstream of
            them."""
            conf = self._conf
            frontier = list(vertex_names)
            while frontier:
                v = frontier.pop()
                if v in self._frozen or v not in conf.vertices:
                    continue
                self._frozen.add(v)
                frontier.extend(conf.vertex_inputs.get(v, []))
            return self

        def remove_vertex_and_connections(self, name: str
                                          ) -> "TransferLearning.GraphBuilder":
            """Remove a vertex and every vertex downstream of it."""
            conf = self._conf
            if name not in conf.vertices:
                raise ValueError(f"no vertex '{name}'")
            dead = {name}
            changed = True
            while changed:
                changed = False
                for v, ins in conf.vertex_inputs.items():
                    if v not in dead and any(s in dead for s in ins):
                        dead.add(v)
                        changed = True
            for v in dead:
                conf.vertices.pop(v, None)
                conf.vertex_inputs.pop(v, None)
                self._removed.add(v)
            conf.network_outputs = [o for o in conf.network_outputs
                                    if o not in dead]
            return self

        def add_layer(self, name: str, layer, *inputs: str
                      ) -> "TransferLearning.GraphBuilder":
            from .conf.computation_graph import LayerVertex
            if layer.name is None:
                layer.name = name
            return self.add_vertex(name, LayerVertex(layer=layer), *inputs)

        def add_vertex(self, name: str, vertex, *inputs: str
                       ) -> "TransferLearning.GraphBuilder":
            conf = self._conf
            if name in conf.vertices:
                raise ValueError(f"duplicate vertex '{name}'")
            conf.vertices[name] = vertex
            conf.vertex_inputs[name] = list(inputs)
            self._reinit.add(name)
            return self

        def set_outputs(self, *names: str) -> "TransferLearning.GraphBuilder":
            self._conf.network_outputs = list(names)
            return self

        def build(self):
            from .computation_graph import ComputationGraph
            from .conf.computation_graph import LayerVertex
            conf = self._conf
            for name in self._frozen:
                v = conf.vertices.get(name)
                if isinstance(v, LayerVertex) and \
                        not isinstance(v.layer, FrozenLayer):
                    v.layer = FrozenLayer(underlying=v.layer,
                                          name=v.layer.name)
            layers = [v.layer for v in conf.vertices.values()
                      if isinstance(v, LayerVertex)]
            _apply_fine_tune(conf, layers, self._fine_tune)
            conf.topological_order = []
            conf.vertex_input_types = {}
            src = self._net
            net = ComputationGraph(conf, device=src.device).init()
            params, state = {}, {}
            for name in conf.vertices:
                if name in self._reinit or name in self._removed:
                    continue
                if name in src.params:
                    params[name] = _copy_group(src.params[name])
                    state[name] = _copy_group(src.state.get(name, {}))
            _graft(net, params, state)
            return net


class TransferLearningHelper:
    """Featurization helper (reference ``TransferLearningHelper.java``):
    run inputs through the frozen front of a network once, then train
    only the tail on the cached features."""

    def __init__(self, net: MultiLayerNetwork,
                 frozen_until: Optional[int] = None):
        if frozen_until is None:
            frozen_until = -1
            for i, lc in enumerate(net.conf.layers):
                if isinstance(lc, FrozenLayer):
                    frozen_until = i
        self.net = net
        self.frozen_until = frozen_until

    def featurize(self, x) -> torch.Tensor:
        """Activations at the frozen boundary (ordinary tensors, so
        ``fit_featurized`` can train on them)."""
        net = self.net
        with torch.no_grad():
            return _stack_forward(net.conf, net.params, net.state,
                                  net._on_device(x), train=False,
                                  to_layer=self.frozen_until + 1)[0]

    def fit_featurized(self, features, labels, epochs: int = 1
                       ) -> MultiLayerNetwork:
        """Train the unfrozen tail on featurized data (the frozen front
        is skipped), then copy its params and state back."""
        from .conf.multi_layer import MultiLayerConfiguration
        net, k = self.net, self.frozen_until + 1
        tail_confs = [copy.deepcopy(
            lc.underlying if isinstance(lc, FrozenLayer) else lc)
            for lc in net.conf.layers[k:]]
        tail_conf = MultiLayerConfiguration(
            layers=tail_confs, defaults=dict(net.conf.defaults),
            seed=net.conf.seed)
        tail = MultiLayerNetwork(tail_conf, device=net.device).init()
        _graft(tail, {f"layer_{j}": _copy_group(net.params[f"layer_{k + j}"])
                      for j in range(len(tail_confs))},
               {f"layer_{j}": _copy_group(net.state.get(f"layer_{k + j}",
                                                        {}))
                for j in range(len(tail_confs))})
        tail.fit(features, labels, epochs=epochs)
        _graft(net, {f"layer_{k + j}": _copy_group(tail.params[f"layer_{j}"])
                     for j in range(len(tail_confs))},
               {f"layer_{k + j}": tail.state[f"layer_{j}"]
                for j in range(len(tail_confs))}, fresh_updater=False)
        return net
