"""Sequential network configuration (port of ``nn/conf/multi_layer.py``).

Reads a ``MultiLayerConfiguration`` JSON written by the JAX package and
resolves it: network defaults into each layer, input sizes inferred
layer by layer from the declared input type.  The builder DSL and input
preprocessors come later; a configuration that names a preprocessor
raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ...utils import serde
from ...utils.serde import register_serde
from ..layers import (attention, convolution, feedforward,  # noqa: F401
                      normalization, pooling, recurrent)  # (@class registry)
from ..layers.base import LayerConf
from . import updaters  # noqa: F401  (@class registry)
from .input_type import InputType


@register_serde
@dataclass
class MultiLayerConfiguration:
    layers: List[LayerConf] = field(default_factory=list)
    input_type: Optional[InputType] = None
    input_preprocessors: Dict[str, Any] = field(default_factory=dict)
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    defaults: Dict[str, Any] = field(default_factory=dict)
    seed: int = 12345
    layer_input_types: List[InputType] = field(default_factory=list)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        conf = serde.from_json(s)
        if not isinstance(conf, MultiLayerConfiguration):
            raise ValueError(f"expected a MultiLayerConfiguration, got "
                             f"{type(conf).__name__}")
        return conf

    def resolve(self) -> None:
        """Apply defaults, infer n_in, record each layer's input type."""
        if self.input_preprocessors:
            raise NotImplementedError(
                "input preprocessors are not ported yet: "
                f"{sorted(self.input_preprocessors)}")
        if self.input_type is None:
            raise NotImplementedError(
                "configurations without a declared input type are not "
                "ported yet")
        for lc in self.layers:
            if hasattr(lc, "apply_global_defaults"):
                lc.apply_global_defaults(self.defaults)
        self.layer_input_types = []
        itype = self.input_type
        for lc in self.layers:
            lc.set_n_in(itype, override=False)
            self.layer_input_types.append(itype)
            itype = lc.output_type(itype)
