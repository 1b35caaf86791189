"""Sequential network configuration (port of ``nn/conf/multi_layer.py``).

Reads a ``MultiLayerConfiguration`` JSON written by the JAX package and
resolves it: network defaults into each layer, the reshape preprocessor
inserted where layer families change (``preprocessor(i)``, as the JAX
package's builder does), input sizes inferred layer by layer from the
declared input type.  The builder DSL comes later.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ...utils import serde
from ...utils.serde import register_serde
from ..layers import (attention, convolution, feedforward,  # noqa: F401
                      misc, normalization, pooling,  # (@class registry)
                      recurrent)
from ..layers.base import LayerConf
from . import dropout, updaters  # noqa: F401  (@class registry)
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
        """Apply defaults, insert preprocessors, infer n_in, record each
        layer's input type."""
        if self.input_type is None:
            raise NotImplementedError(
                "configurations without a declared input type are not "
                "ported yet")
        for lc in self.layers:
            if hasattr(lc, "apply_global_defaults"):
                lc.apply_global_defaults(self.defaults)
        self.layer_input_types = []
        itype = self.input_type
        for i, lc in enumerate(self.layers):
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
