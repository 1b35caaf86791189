"""ComputationGraph configuration: vertices and the fluent GraphBuilder
(port of the parts of ``nn/conf/computation_graph.py`` that ResNet50
uses).

The graph is data: a dict of named vertex configs, each vertex's input
names, and the network inputs and outputs.  ``resolve`` fills network
defaults into each layer, orders the vertices topologically (Kahn's
algorithm with a sorted ready list, so the order is the JAX package's)
and infers every vertex's input types.

Ported vertices: ``LayerVertex`` (without a preprocessor) and
``ElementWiseVertex``.  Any other vertex class, or a layer vertex whose
preprocessor is set, raises when the JSON is read.  A vertex runs as
``forward(params, state, inputs, train) -> (y, new_state)``, the layer
protocol of ``nn/layers/base``; fan-in gradients are summed by autograd.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from ...utils import serde
from ...utils.serde import register_serde
from ..layers import (attention, convolution, feedforward,  # noqa: F401
                      normalization, pooling, recurrent)  # (@class registry)
from ..layers.base import LayerConf
from . import updaters  # noqa: F401  (@class registry)
from .input_type import InputType


@dataclass
class GraphVertexConf:
    """Base vertex."""

    def n_inputs(self) -> Tuple[int, int]:
        """(min, max) accepted input count; max=-1 means unbounded."""
        return (1, 1)

    def output_type(self, itypes: List[InputType]) -> InputType:
        return itypes[0]

    def init(self, generator, itypes, device) -> Dict[str, torch.Tensor]:
        return {}

    def init_state(self, itypes, device) -> Dict[str, torch.Tensor]:
        return {}

    def forward(self, params, state, inputs: List[torch.Tensor], *,
                train: bool = False):
        raise NotImplementedError


@register_serde
@dataclass
class LayerVertex(GraphVertexConf):
    """Wraps a LayerConf."""
    layer: LayerConf = None
    preprocessor: Optional[Any] = None

    def __post_init__(self):
        if self.preprocessor is not None:
            raise NotImplementedError(
                f"layer vertex '{getattr(self.layer, 'name', None)}': input "
                f"preprocessors are not ported yet: {self.preprocessor!r}")

    def output_type(self, itypes):
        return self.layer.output_type(itypes[0])

    def init(self, generator, itypes, device):
        return self.layer.init(generator, itypes[0], device)

    def init_state(self, itypes, device):
        return self.layer.init_state(itypes[0], device)

    def forward(self, params, state, inputs, *, train=False):
        return self.layer.forward(params, state, inputs[0], train=train)

    def compute_loss(self, params, x, labels, *, train=False, mask=None):
        return self.layer.compute_loss(params, x, labels, train=train,
                                       mask=mask)

    def regularization_score(self, params):
        return self.layer.regularization_score(params)


@register_serde
@dataclass
class ElementWiseVertex(GraphVertexConf):
    """Pointwise combine: add, subtract, product, average or max."""
    op: str = "add"

    def n_inputs(self):
        return (2, 2) if self.op == "subtract" else (2, -1)

    def forward(self, params, state, inputs, *, train=False):
        op = self.op.lower()
        out = inputs[0]
        if op == "add":
            for x in inputs[1:]:
                out = out + x
        elif op == "subtract":
            out = inputs[0] - inputs[1]
        elif op == "product":
            for x in inputs[1:]:
                out = out * x
        elif op == "average":
            out = sum(inputs) / len(inputs)
        elif op == "max":
            for x in inputs[1:]:
                out = torch.maximum(out, x)
        else:
            raise ValueError(f"unknown elementwise op '{self.op}'")
        return out, state


@register_serde
@dataclass
class ComputationGraphConfiguration:
    """The graph as data (reference ``ComputationGraphConfiguration``)."""
    vertices: Dict[str, GraphVertexConf] = field(default_factory=dict)
    vertex_inputs: Dict[str, List[str]] = field(default_factory=dict)
    network_inputs: List[str] = field(default_factory=list)
    network_outputs: List[str] = field(default_factory=list)
    input_types: List[Optional[InputType]] = field(default_factory=list)
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    defaults: Dict[str, Any] = field(default_factory=dict)
    seed: int = 12345
    # resolved:
    topological_order: List[str] = field(default_factory=list)
    vertex_input_types: Dict[str, List[Any]] = field(default_factory=dict)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        conf = serde.from_json(s)
        if not isinstance(conf, ComputationGraphConfiguration):
            raise ValueError(f"expected a ComputationGraphConfiguration, got "
                             f"{type(conf).__name__}")
        return conf

    def topo_sort(self) -> List[str]:
        """Kahn's algorithm; the ready list is sorted once and then
        appended to, as in the reference."""
        indeg: Dict[str, int] = {}
        children: Dict[str, List[str]] = {}
        for name, ins in self.vertex_inputs.items():
            indeg[name] = 0
            for src in ins:
                if src in self.vertices:
                    indeg[name] += 1
                    children.setdefault(src, []).append(name)
                elif src not in self.network_inputs:
                    raise ValueError(
                        f"vertex '{name}' input '{src}' is neither a vertex "
                        "nor a network input")
        ready = sorted(n for n, d in indeg.items() if d == 0)
        order = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for c in children.get(n, []):
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        if len(order) != len(self.vertices):
            cyc = set(self.vertices) - set(order)
            raise ValueError(f"graph has a cycle involving {sorted(cyc)}")
        return order

    def resolve(self) -> None:
        """Apply defaults, order the vertices, infer every input type."""
        for name in self.network_outputs:
            if name not in self.vertices:
                raise ValueError(f"network output '{name}' is not a vertex")
        if len(self.input_types) != len(self.network_inputs) or \
                any(t is None for t in self.input_types):
            raise NotImplementedError(
                "graphs without a declared input type for every network "
                "input are not ported yet")
        for v in self.vertices.values():
            lc = getattr(v, "layer", None)
            if hasattr(lc, "apply_global_defaults"):
                lc.apply_global_defaults(self.defaults)
        self.topological_order = self.topo_sort()
        it_by_name = dict(zip(self.network_inputs, self.input_types))
        self.vertex_input_types = {}
        for name in self.topological_order:
            v = self.vertices[name]
            ins = self.vertex_inputs[name]
            lo, hi = v.n_inputs()
            if len(ins) < lo or (hi != -1 and len(ins) > hi):
                raise ValueError(
                    f"vertex '{name}' takes {lo}..{'∞' if hi == -1 else hi} "
                    f"inputs, got {len(ins)}")
            itypes = [it_by_name[src] for src in ins]
            if isinstance(v, LayerVertex):
                v.layer.set_n_in(itypes[0], override=False)
            self.vertex_input_types[name] = itypes
            it_by_name[name] = v.output_type(itypes)


class GraphBuilder:
    """Fluent builder (reference ComputationGraphConfiguration.GraphBuilder)."""

    def __init__(self, defaults: Dict[str, Any] = None, seed: int = 12345):
        self._defaults = dict(defaults or {})
        self._seed = seed
        self._vertices: Dict[str, GraphVertexConf] = {}
        self._vertex_inputs: Dict[str, List[str]] = {}
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._input_types: List[Optional[InputType]] = []

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def set_input_types(self, *itypes: InputType) -> "GraphBuilder":
        self._input_types = list(itypes)
        return self

    def add_layer(self, name: str, layer: LayerConf, *inputs: str
                  ) -> "GraphBuilder":
        if layer.name is None:
            layer.name = name
        return self.add_vertex(name, LayerVertex(layer=layer), *inputs)

    def add_vertex(self, name: str, vertex: GraphVertexConf, *inputs: str
                   ) -> "GraphBuilder":
        if name in self._vertices:
            raise ValueError(f"duplicate vertex name '{name}'")
        if not inputs:
            raise ValueError(f"vertex '{name}' needs at least one input")
        self._vertices[name] = vertex
        self._vertex_inputs[name] = list(inputs)
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def build(self) -> ComputationGraphConfiguration:
        conf = ComputationGraphConfiguration(
            vertices=self._vertices,
            vertex_inputs=self._vertex_inputs,
            network_inputs=self._inputs,
            network_outputs=self._outputs,
            input_types=self._input_types,
            defaults=dict(self._defaults),
            seed=self._seed)
        conf.resolve()
        return conf
