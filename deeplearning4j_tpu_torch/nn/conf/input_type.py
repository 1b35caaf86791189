"""Static shape inference (port of ``nn/conf/input_type.py``).

Only the recurrent kind is ported: ``[batch, time, size]``.  The other
kinds' fields stay so that a configuration written by the JAX package
reads back unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from ...utils.serde import register_serde


@register_serde
@dataclass(frozen=True)
class InputType:
    kind: str  # only "rnn" runs in the port so far
    size: int = 0            # feature size
    timesteps: int = -1      # -1 = variable
    height: int = 0
    width: int = 0
    depth: int = 0
    channels: int = 0

    @staticmethod
    def recurrent(size: int, timesteps: int = -1) -> "InputType":
        return InputType("rnn", size=int(size), timesteps=int(timesteps))

    def shape(self, batch: int = -1) -> Tuple[int, ...]:
        """Array shape with batch dim (-1 placeholder allowed)."""
        if self.kind == "rnn":
            return (batch, self.timesteps, self.size)
        raise ValueError(f"input kind '{self.kind}' is not ported yet")
