"""Time-distributed output head (port of ``RnnOutputLayer`` from
``nn/layers/recurrent.py``).  The recurrent layers come in a later
slice."""
from __future__ import annotations

from dataclasses import dataclass

from ...utils.serde import register_serde
from ..conf.input_type import InputType
from .feedforward import OutputLayer


@register_serde
@dataclass
class RnnOutputLayer(OutputLayer):
    """Dense + loss over ``[b, t, f]`` -> ``[b, t, n_out]``: the output
    head applied at every step."""

    def set_n_in(self, itype: InputType, override: bool = False) -> None:
        if self.n_in == 0 or override:
            if itype.kind != "rnn":
                raise ValueError(f"layer '{self.name}': RnnOutputLayer "
                                 f"expects RNN input, got {itype}")
            self.n_in = itype.size

    def output_type(self, itype: InputType) -> InputType:
        return InputType.recurrent(self.n_out, itype.timesteps)
