"""ComputationGraph configuration: vertices and the fluent GraphBuilder
(port of ``nn/conf/computation_graph.py``).

The graph is data: a dict of named vertex configs, each vertex's input
names, and the network inputs and outputs.  ``resolve`` fills network
defaults into each layer, orders the vertices topologically (Kahn's
algorithm with a sorted ready list, so the order is the JAX package's),
gives a layer vertex the reshape preprocessor its layer family needs
(as the JAX package's builder does) and infers every vertex's input
types.

Vertices: ``LayerVertex`` (with an optional preprocessor),
``ElementWiseVertex``, ``MergeVertex`` (concatenation on the last axis:
features, or NHWC channels), ``SubsetVertex``, ``StackVertex``,
``UnstackVertex``, ``ScaleVertex``, ``ShiftVertex``,
``L2NormalizeVertex``, ``L2Vertex``, ``ReshapeVertex``,
``PreprocessorVertex``, ``PoolHelperVertex``, ``LastTimeStepVertex`` and
``DuplicateToTimeSeriesVertex``.  A vertex runs as ``forward(params,
state, inputs, train, key, masks) -> (y, new_state)``, the layer protocol
of ``nn/layers/base`` over a list of inputs and their features masks,
and ``feed_forward_mask(masks, inputs)`` gives the mask its consumers
see; fan-in gradients are summed by autograd.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from ...utils import serde
from ...utils.serde import register_serde
from ..layers import (attention, convolution, feedforward,  # noqa: F401
                      misc, moe, normalization,  # (@class registry)
                      pooling, recurrent)
from ..layers.base import LayerConf
from . import (constraints, distribution, dropout,  # noqa: F401
               schedules, updaters)  # (@class registry)
from .input_type import InputType
from .preprocessors import InputPreProcessor, auto_preprocessor


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
                train: bool = False, key=None, masks=None):
        return self.apply(params, inputs, train=train, key=key,
                          masks=masks), state

    def apply(self, params, inputs, *, train=False, key=None, masks=None):
        raise NotImplementedError

    def feed_forward_mask(self, masks, inputs=None):
        """The mask this vertex's consumers see: the first given one."""
        for m in masks:
            if m is not None:
                return m
        return None


@register_serde
@dataclass
class LayerVertex(GraphVertexConf):
    """Wraps a LayerConf, with the preprocessor its input needs."""
    layer: LayerConf = None
    preprocessor: Optional[InputPreProcessor] = None

    def _itype(self, itypes):
        it = itypes[0]
        if self.preprocessor is not None:
            it = self.preprocessor.output_type(it)
        return it

    def output_type(self, itypes):
        return self.layer.output_type(self._itype(itypes))

    def init(self, generator, itypes, device):
        return self.layer.init(generator, self._itype(itypes), device)

    def init_state(self, itypes, device):
        return self.layer.init_state(self._itype(itypes), device)

    def _pre(self, x, mask):
        if self.preprocessor is not None:
            x = self.preprocessor.pre_process(x, mask)
            if mask is not None:
                mask = self.preprocessor.feed_forward_mask(mask, None)
        return x, mask

    def forward(self, params, state, inputs, *, train=False, key=None,
                masks=None):
        x, mask = self._pre(inputs[0], masks[0] if masks else None)
        return self.layer.forward(params, state, x, train=train, key=key,
                                  mask=mask)

    def compute_loss(self, params, x, labels, *, train=False, key=None,
                     mask=None):
        x, mask = self._pre(x, mask)
        return self.layer.compute_loss(params, x, labels, train=train,
                                       key=key, mask=mask)

    def feed_forward_mask(self, masks, inputs=None):
        mask = masks[0] if masks else None
        if mask is not None and self.preprocessor is not None:
            mask = self.preprocessor.feed_forward_mask(mask, None)
        if mask is not None:
            mask = self.layer.feed_forward_mask(mask, None)
        return mask

    def regularization_score(self, params):
        return self.layer.regularization_score(params)


@register_serde
@dataclass
class ElementWiseVertex(GraphVertexConf):
    """Pointwise combine: add, subtract, product, average or max."""
    op: str = "add"

    def n_inputs(self):
        return (2, 2) if self.op == "subtract" else (2, -1)

    def apply(self, params, inputs, *, train=False, key=None, masks=None):
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
        return out


@register_serde
@dataclass
class MergeVertex(GraphVertexConf):
    """Concatenate along the last axis: features for FF/RNN, channels
    for NHWC images (the reference's NCHW dim 1)."""

    def n_inputs(self):
        return (1, -1)

    def output_type(self, itypes):
        first = itypes[0]
        if first.kind == "ff":
            return InputType.feed_forward(sum(t.size for t in itypes))
        if first.kind == "rnn":
            return InputType.recurrent(sum(t.size for t in itypes),
                                       first.timesteps)
        if first.kind == "cnn":
            return InputType.convolutional(first.height, first.width,
                                           sum(t.channels for t in itypes))
        raise ValueError(f"MergeVertex: unsupported input kind {first.kind}")

    def apply(self, params, inputs, *, train=False, key=None, masks=None):
        return torch.cat(inputs, dim=-1)


@register_serde
@dataclass
class SubsetVertex(GraphVertexConf):
    """Feature range ``[from_idx, to_idx]`` (inclusive) of the last
    axis."""
    from_idx: int = 0
    to_idx: int = 0

    def output_type(self, itypes):
        n = self.to_idx - self.from_idx + 1
        t = itypes[0]
        if t.kind == "ff":
            return InputType.feed_forward(n)
        if t.kind == "rnn":
            return InputType.recurrent(n, t.timesteps)
        if t.kind == "cnn":
            return InputType.convolutional(t.height, t.width, n)
        raise ValueError(t.kind)

    def apply(self, params, inputs, *, train=False, key=None, masks=None):
        return inputs[0][..., self.from_idx:self.to_idx + 1]


@register_serde
@dataclass
class StackVertex(GraphVertexConf):
    """Concatenate along the batch axis (one layer shared by several
    inputs)."""

    def n_inputs(self):
        return (1, -1)

    def apply(self, params, inputs, *, train=False, key=None, masks=None):
        return torch.cat(inputs, dim=0)

    def feed_forward_mask(self, masks, inputs=None):
        if all(m is None for m in masks):
            return None
        # unmasked inputs contribute all-ones rows (reference semantics)
        proto = next(m for m in masks if m is not None)
        out = []
        for i, m in enumerate(masks):
            if m is None:
                if inputs is None:
                    raise ValueError(
                        "StackVertex: mixed masked/unmasked inputs need "
                        "runtime shapes to synthesize all-ones masks")
                out.append(torch.ones((inputs[i].shape[0],)
                                      + tuple(proto.shape[1:]),
                                      dtype=proto.dtype,
                                      device=proto.device))
            else:
                out.append(m)
        return torch.cat(out, dim=0)


@register_serde
@dataclass
class UnstackVertex(GraphVertexConf):
    """Batch slab ``from_idx`` of ``stack_size`` equal slabs."""
    from_idx: int = 0
    stack_size: int = 1

    def _slab(self, x):
        step = x.shape[0] // self.stack_size
        return x[self.from_idx * step:(self.from_idx + 1) * step]

    def apply(self, params, inputs, *, train=False, key=None, masks=None):
        return self._slab(inputs[0])

    def feed_forward_mask(self, masks, inputs=None):
        m = masks[0] if masks else None
        return None if m is None else self._slab(m)


@register_serde
@dataclass
class ScaleVertex(GraphVertexConf):
    """Multiply by a fixed scalar."""
    scale_factor: float = 1.0

    def apply(self, params, inputs, *, train=False, key=None, masks=None):
        return inputs[0] * self.scale_factor


@register_serde
@dataclass
class ShiftVertex(GraphVertexConf):
    """Add a fixed scalar."""
    shift_factor: float = 0.0

    def apply(self, params, inputs, *, train=False, key=None, masks=None):
        return inputs[0] + self.shift_factor


@register_serde
@dataclass
class L2NormalizeVertex(GraphVertexConf):
    """``x / (||x||_2 + eps)`` per example."""
    eps: float = 1e-8

    def apply(self, params, inputs, *, train=False, key=None, masks=None):
        x = inputs[0]
        dims = tuple(range(1, x.ndim))
        norm = torch.sqrt(torch.sum(x * x, dim=dims, keepdim=True))
        return x / (norm + self.eps)


@register_serde
@dataclass
class L2Vertex(GraphVertexConf):
    """L2 distance between two activations per example: ``[b, 1]``; eps
    inside the root keeps the gradient finite at 0."""
    eps: float = 1e-8

    def n_inputs(self):
        return (2, 2)

    def output_type(self, itypes):
        return InputType.feed_forward(1)

    def apply(self, params, inputs, *, train=False, key=None, masks=None):
        a = inputs[0].reshape(inputs[0].shape[0], -1)
        b = inputs[1].reshape(inputs[1].shape[0], -1)
        d = a - b
        return torch.sqrt(torch.sum(d * d, dim=1, keepdim=True) + self.eps)


def _itype_of(shape) -> InputType:
    s = [int(d) for d in shape]
    if len(s) == 1:
        return InputType.feed_forward(s[0])
    if len(s) == 2:
        return InputType.recurrent(s[1], s[0])
    if len(s) == 3:
        return InputType.convolutional(s[0], s[1], s[2])
    raise ValueError(f"bad per-example shape {s}")


@register_serde
@dataclass
class ReshapeVertex(GraphVertexConf):
    """Reshape per example (``shape`` excludes the batch dim)."""
    shape: List[int] = field(default_factory=list)

    def output_type(self, itypes):
        return _itype_of(self.shape)

    def apply(self, params, inputs, *, train=False, key=None, masks=None):
        x = inputs[0]
        return x.reshape((x.shape[0],) + tuple(int(d) for d in self.shape))


@register_serde
@dataclass
class PreprocessorVertex(GraphVertexConf):
    """An input preprocessor as a vertex."""
    preprocessor: InputPreProcessor = None

    def output_type(self, itypes):
        return self.preprocessor.output_type(itypes[0])

    def apply(self, params, inputs, *, train=False, key=None, masks=None):
        return self.preprocessor.pre_process(inputs[0],
                                             masks[0] if masks else None)


@register_serde
@dataclass
class PoolHelperVertex(GraphVertexConf):
    """Drop the first row and column of an NHWC activation (the
    imported-GoogLeNet shim)."""

    def output_type(self, itypes):
        t = itypes[0]
        return InputType.convolutional(t.height - 1, t.width - 1, t.channels)

    def apply(self, params, inputs, *, train=False, key=None, masks=None):
        return inputs[0][:, 1:, 1:, :]


@register_serde
@dataclass
class LastTimeStepVertex(GraphVertexConf):
    """RNN ``[b, t, f]`` -> ``[b, f]`` at each row's last unmasked step;
    ``mask_input`` names the network input whose mask gives the
    lengths."""
    mask_input: Optional[str] = None

    def output_type(self, itypes):
        return InputType.feed_forward(itypes[0].size)

    def apply(self, params, inputs, *, train=False, key=None, masks=None):
        x = inputs[0]
        mask = masks[0] if masks else None
        if mask is None:
            return x[:, -1, :]
        # the index of the last nonzero mask entry of each row
        idx = x.shape[1] - 1 - torch.argmax((mask.flip(1) != 0).to(
            torch.int32), dim=1)
        return x[torch.arange(x.shape[0], device=x.device), idx]

    def feed_forward_mask(self, masks, inputs=None):
        return None  # the time axis is consumed


@register_serde
@dataclass
class DuplicateToTimeSeriesVertex(GraphVertexConf):
    """FF ``[b, f]`` -> RNN ``[b, t, f]`` by repetition; t from the
    optional second input (the series whose length to copy), else
    ``timesteps``, resolved from ``ts_input``'s input type."""
    ts_input: str = ""
    timesteps: int = -1

    def n_inputs(self):
        return (1, 2)

    def output_type(self, itypes):
        return InputType.recurrent(itypes[0].size, self.timesteps)

    def apply(self, params, inputs, *, train=False, key=None, masks=None):
        x = inputs[0]
        t = inputs[1].shape[1] if len(inputs) > 1 else self.timesteps
        if t is None or t < 0:
            raise ValueError(
                "DuplicateToTimeSeriesVertex needs static timesteps or the "
                "ts_input wired as a second graph input")
        return x[:, None, :].expand(-1, t, -1).contiguous()


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

    def to_json(self) -> str:
        return serde.to_json(self)

    def to_yaml(self) -> str:
        return serde.to_yaml(self)

    @staticmethod
    def from_yaml(s: str) -> "ComputationGraphConfiguration":
        return serde.from_yaml(s)

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
        """Apply defaults, check names, order the vertices, infer every
        input type."""
        from .multi_layer import validate_layer_names as _validate_layer_names
        for name in self.network_outputs:
            if name not in self.vertices:
                raise ValueError(f"network output '{name}' is not a vertex")
        for v in self.vertices.values():
            lc = getattr(v, "layer", None)
            if hasattr(lc, "apply_global_defaults"):
                lc.apply_global_defaults(self.defaults)
            _validate_layer_names(lc)
        self.topological_order = self.topo_sort()
        # a network input without a declared type (and every vertex it
        # reaches) stays None: those layers keep their explicit n_in, as
        # in the JAX package
        it_by_name = {n: (self.input_types[i]
                          if i < len(self.input_types) else None)
                      for i, n in enumerate(self.network_inputs)}
        self.vertex_input_types = {}
        for name in self.topological_order:
            v = self.vertices[name]
            ins = self.vertex_inputs[name]
            lo, hi = v.n_inputs()
            if len(ins) < lo or (hi != -1 and len(ins) > hi):
                raise ValueError(
                    f"vertex '{name}' takes {lo}..{'∞' if hi == -1 else hi} "
                    f"inputs, got {len(ins)}")
            itypes = [it_by_name.get(src) for src in ins]
            self.vertex_input_types[name] = itypes
            if any(t is None for t in itypes):
                it_by_name[name] = None
                continue
            if isinstance(v, LayerVertex):
                if v.preprocessor is None:
                    v.preprocessor = auto_preprocessor(itypes[0], v.layer)
                v.layer.set_n_in(v._itype(itypes), override=False)
            if isinstance(v, DuplicateToTimeSeriesVertex):
                ref = it_by_name.get(v.ts_input)
                if ref is not None:
                    v.timesteps = ref.timesteps
            it_by_name[name] = v.output_type(itypes)

    def vertex_output_type(self, name: str) -> Optional[InputType]:
        """The resolved output type of vertex ``name`` (None where an
        input's type is unknown)."""
        itypes = self.vertex_input_types.get(name)
        if itypes is None or any(t is None for t in itypes):
            return None
        return self.vertices[name].output_type(itypes)


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
        self._backprop_type = "standard"
        self._tbptt_fwd = 20
        self._tbptt_back = 20

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

    def backprop_type(self, t: str, fwd: int = 20, back: int = 20
                      ) -> "GraphBuilder":
        self._backprop_type = t
        self._tbptt_fwd = fwd
        self._tbptt_back = back
        return self

    def build(self) -> ComputationGraphConfiguration:
        conf = ComputationGraphConfiguration(
            vertices=self._vertices,
            vertex_inputs=self._vertex_inputs,
            network_inputs=self._inputs,
            network_outputs=self._outputs,
            input_types=self._input_types,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            defaults=dict(self._defaults),
            seed=self._seed)
        conf.resolve()
        return conf
