"""Sequential network configuration (port of ``nn/conf/multi_layer.py``):
``MultiLayerConfiguration``, the builder DSL
(``NeuralNetConfiguration.builder()`` -> ``ListBuilder`` /
``GraphBuilder``) and ``validate_layer_names``.

A configuration is built here or read from the JAX package's JSON, and
``to_json``/``to_yaml`` write the JSON the JAX package writes for the
same configuration.  ``resolve`` applies the network defaults to each
layer, checks activation and loss names, inserts the reshape
preprocessor where layer families change (``preprocessor(i)``, as the
JAX package's builder does) and infers input sizes layer by layer from
the declared input type; without one, the layers keep the sizes they
were given.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ...utils import serde
from ...utils.serde import register_serde
from ..layers import (attention, convolution, feedforward,  # noqa: F401
                      misc, moe, normalization,  # (@class registry)
                      pooling, recurrent)
from .. import precision  # noqa: F401  (@class registry)
from ..layers.base import LayerConf
from . import (constraints, distribution, dropout,  # noqa: F401
               schedules, updaters)  # (@class registry)
from .input_type import InputType
from .preprocessors import InputPreProcessor, auto_preprocessor


@register_serde
@dataclass
class MultiLayerConfiguration:
    layers: List[LayerConf] = field(default_factory=list)
    input_type: Optional[InputType] = None
    # int-keyed in meaning; str keys, as the JSON has them
    input_preprocessors: Dict[str, InputPreProcessor] = field(
        default_factory=dict)
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    defaults: Dict[str, Any] = field(default_factory=dict)
    seed: int = 12345
    layer_input_types: List[InputType] = field(default_factory=list)

    def to_json(self) -> str:
        return serde.to_json(self)

    def to_yaml(self) -> str:
        return serde.to_yaml(self)

    @staticmethod
    def from_yaml(s: str) -> "MultiLayerConfiguration":
        return serde.from_yaml(s)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        conf = serde.from_json(s)
        if not isinstance(conf, MultiLayerConfiguration):
            raise ValueError(f"expected a MultiLayerConfiguration, got "
                             f"{type(conf).__name__}")
        return conf

    def preprocessor(self, i: int) -> Optional[InputPreProcessor]:
        return self.input_preprocessors.get(str(i))

    def resolve(self) -> None:
        """Apply defaults, check names, insert preprocessors, infer n_in,
        record each layer's input type (None without a declared input
        type)."""
        for lc in self.layers:
            if hasattr(lc, "apply_global_defaults"):
                lc.apply_global_defaults(self.defaults)
            validate_layer_names(lc)
        self.layer_input_types = []
        itype = self.input_type
        for i, lc in enumerate(self.layers):
            if itype is None:
                # no declared input type: the user set n_in; chain the
                # output types on once a layer fixes its own
                self.layer_input_types.append(None)
                try:
                    itype = lc.output_type(itype)
                except Exception:
                    itype = None
                continue
            if str(i) not in self.input_preprocessors:
                pp = auto_preprocessor(itype, lc)
                if pp is not None:
                    self.input_preprocessors[str(i)] = pp
            pp = self.preprocessor(i)
            if pp is not None:
                itype = pp.output_type(itype)
            lc.set_n_in(itype, override=False)
            self.layer_input_types.append(itype)
            itype = lc.output_type(itype)


def validate_layer_names(lc, _seen: Optional[set] = None) -> None:
    """Fail at configuration time on unknown activation or loss names
    (reference ``LayerValidation``), through wrapper layers
    (``Bidirectional.fwd``, ``FrozenLayer``/``LastTimeStep.underlying``,
    a graph ``LayerVertex.layer``) to any depth."""
    if lc is None:
        return
    if _seen is None:
        _seen = set()
    if id(lc) in _seen:
        return
    _seen.add(id(lc))
    from .. import activations, losses
    act = getattr(lc, "activation", None)
    if isinstance(act, str):
        activations.get(act)
    loss = getattr(lc, "loss", None)
    if isinstance(loss, str):
        losses.get(loss)
    for attr in ("fwd", "underlying", "layer"):
        inner = getattr(lc, attr, None)
        if inner is not lc and isinstance(inner, LayerConf):
            validate_layer_names(inner, _seen)


class ListBuilder:
    """Fluent layer-stack builder (reference
    ``NeuralNetConfiguration.ListBuilder``)."""

    def __init__(self, defaults: Dict[str, Any], seed: int):
        self._defaults = defaults
        self._seed = seed
        self._layers: List[LayerConf] = []
        self._input_type: Optional[InputType] = None
        self._preprocessors: Dict[str, InputPreProcessor] = {}
        self._backprop_type = "standard"
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def layer(self, conf: LayerConf, index: Optional[int] = None
              ) -> "ListBuilder":
        """Append, or set the layer at ``index`` (no padding)."""
        if conf.name is None:
            conf.name = \
                f"layer{index if index is not None else len(self._layers)}"
        if index is None or index == len(self._layers):
            self._layers.append(conf)
        elif 0 <= index < len(self._layers):
            self._layers[index] = conf
        else:
            raise ValueError(f"layer index {index} out of range (have "
                             f"{len(self._layers)} layers)")
        return self

    def set_input_type(self, itype: InputType) -> "ListBuilder":
        self._input_type = itype
        return self

    def input_pre_processor(self, index: int, pp: InputPreProcessor
                            ) -> "ListBuilder":
        self._preprocessors[str(index)] = pp
        return self

    def backprop_type(self, t: str, fwd: int = 20, back: int = 20
                      ) -> "ListBuilder":
        self._backprop_type = t
        self._tbptt_fwd = fwd
        self._tbptt_back = back
        return self

    def build(self) -> MultiLayerConfiguration:
        conf = MultiLayerConfiguration(
            layers=self._layers, input_type=self._input_type,
            input_preprocessors=self._preprocessors,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            defaults=dict(self._defaults), seed=self._seed)
        conf.resolve()
        return conf


class NeuralNetConfiguration:
    """Entry point: ``NeuralNetConfiguration.builder()``, the network
    defaults, then ``list()`` or ``graph_builder()``.  Each method sets
    the same key of ``defaults`` as the JAX package's builder, so the
    two write the same JSON."""

    class Builder:
        def __init__(self):
            self._defaults: Dict[str, Any] = {}
            self._seed = 12345

        def seed(self, s: int):
            self._seed = int(s)
            return self

        def activation(self, a):
            self._defaults["activation"] = a
            return self

        def weight_init(self, w, dist=None):
            self._defaults["weight_init"] = w
            if dist is not None:
                self._defaults["weight_dist"] = dist
            return self

        def bias_init(self, b: float):
            self._defaults["bias_init"] = float(b)
            return self

        def updater(self, u):
            self._defaults["updater"] = u
            return self

        def bias_updater(self, u):
            self._defaults["bias_updater"] = u
            return self

        def l1(self, v: float):
            self._defaults["l1"] = float(v)
            return self

        def l2(self, v: float):
            self._defaults["l2"] = float(v)
            return self

        def l1_bias(self, v: float):
            self._defaults["l1_bias"] = float(v)
            return self

        def l2_bias(self, v: float):
            self._defaults["l2_bias"] = float(v)
            return self

        def dropout(self, d):
            self._defaults["dropout"] = d
            return self

        def weight_noise(self, wn):
            self._defaults["weight_noise"] = wn
            return self

        def constraints(self, cs):
            self._defaults["constraints"] = cs
            return self

        def gradient_normalization(self, gn, threshold: float = 1.0):
            self._defaults["gradient_normalization"] = gn
            self._defaults["gradient_normalization_threshold"] = \
                float(threshold)
            return self

        def dtype(self, dt: str):
            self._defaults["dtype"] = dt
            return self

        def cache_mode(self, mode: str):
            """Activation memory policy: 'none' (default) or 'remat'
            (``torch.utils.checkpoint`` per layer: the backward recomputes
            each layer's activations, trading operations for memory)."""
            if mode not in ("none", "remat"):
                raise ValueError(f"cache_mode must be 'none' or 'remat', "
                                 f"got '{mode}'")
            self._defaults["cache_mode"] = mode
            return self

        def compute_dtype(self, dt: str):
            """Mixed precision: master params and updater state stay
            float32, forward and backward run in ``dt``; shorthand for
            :meth:`precision` (which also takes loss scaling and per-layer
            overrides)."""
            self._defaults["compute_dtype"] = str(dt)
            return self

        def precision(self, policy):
            """A mixed-precision policy (``nn/precision``): a
            ``PrecisionPolicy``, or a shorthand string: 'bfloat16' (bf16
            compute, f32 masters, no scaling), 'float16' (f16 compute with
            dynamic loss scaling), 'float32' (full precision)."""
            from ..precision import PrecisionPolicy, named_policy
            if isinstance(policy, str):
                policy = named_policy(policy)
            if not isinstance(policy, PrecisionPolicy):
                raise ValueError(
                    "precision() takes a PrecisionPolicy or a dtype "
                    f"shorthand string, got {type(policy).__name__}")
            self._defaults["precision"] = policy
            # the legacy knob, for consumers that need only the compute
            # dtype (the memory report, the zoo)
            if policy.compute_dtype:
                self._defaults["compute_dtype"] = policy.compute_dtype
            return self

        def scan_layers(self, mode):
            """Scan-over-layers control, kept in ``defaults`` for the JAX
            package; the port runs its layers eagerly and ignores it."""
            if not isinstance(mode, (bool, int)):
                raise ValueError("scan_layers(True|False|min_run_length)")
            if not isinstance(mode, bool):
                if mode == 0:
                    mode = False
                elif mode < 2:
                    raise ValueError(
                        "scan_layers min run length must be >= 2 (a "
                        "1-layer 'run' cannot scan); use False/0 to "
                        "disable")
            self._defaults["scan_layers"] = mode
            return self

        def optimization_algo(self, algo: str, max_iterations: int = 100):
            """'sgd' (default) or a legacy full-batch solver ('lbfgs',
            'conjugate_gradient', 'line_gradient_descent';
            ``train/solvers.py``)."""
            self._defaults["optimization_algo"] = str(algo).lower()
            self._defaults["max_iterations"] = int(max_iterations)
            return self

        def list(self) -> ListBuilder:
            return ListBuilder(self._defaults, self._seed)

        def graph_builder(self):
            from .computation_graph import GraphBuilder
            return GraphBuilder(self._defaults, self._seed)

    @staticmethod
    def builder() -> "NeuralNetConfiguration.Builder":
        return NeuralNetConfiguration.Builder()
