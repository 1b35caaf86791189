"""Static shape inference (port of ``nn/conf/input_type.py``).

Ported kinds: feed-forward ``[batch, size]``, recurrent ``[batch, time,
size]``, convolutional ``[batch, height, width, channels]`` (NHWC, as in
the JAX package) and flattened images ``[batch, height·width·channels]``
(``cnnflat``).  The 3-D kind's fields stay so that a configuration
written by the JAX package reads back unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from ...utils.serde import register_serde


@register_serde
@dataclass(frozen=True)
class InputType:
    kind: str  # "ff" | "rnn" | "cnn" | "cnnflat" run in the port so far
    size: int = 0            # ff/rnn feature size
    timesteps: int = -1      # -1 = variable
    height: int = 0
    width: int = 0
    depth: int = 0
    channels: int = 0

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType("ff", size=int(size))

    @staticmethod
    def recurrent(size: int, timesteps: int = -1) -> "InputType":
        return InputType("rnn", size=int(size), timesteps=int(timesteps))

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType("cnn", height=int(height), width=int(width),
                         channels=int(channels))

    @staticmethod
    def convolutional_flat(height: int, width: int, channels: int
                           ) -> "InputType":
        return InputType("cnnflat", height=int(height), width=int(width),
                         channels=int(channels))

    def flat_size(self) -> int:
        """Elements per example."""
        if self.kind == "ff":
            return self.size
        if self.kind == "rnn":
            if self.timesteps < 0:
                raise ValueError("variable-length RNN input has no static "
                                 "flat size")
            return self.size * self.timesteps
        if self.kind in ("cnn", "cnnflat"):
            return self.height * self.width * self.channels
        raise ValueError(f"input kind '{self.kind}' is not ported yet")

    def shape(self, batch: int = -1) -> Tuple[int, ...]:
        """Array shape with batch dim (-1 placeholder allowed)."""
        if self.kind == "ff":
            return (batch, self.size)
        if self.kind == "rnn":
            return (batch, self.timesteps, self.size)
        if self.kind == "cnn":
            return (batch, self.height, self.width, self.channels)
        if self.kind == "cnnflat":
            return (batch, self.height * self.width * self.channels)
        raise ValueError(f"input kind '{self.kind}' is not ported yet")
