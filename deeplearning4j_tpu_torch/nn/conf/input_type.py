"""Static shape inference (port of ``nn/conf/input_type.py``).

Kinds: feed-forward ``[batch, size]``, recurrent ``[batch, time, size]``,
convolutional ``[batch, height, width, channels]`` (NHWC, as in the JAX
package), flattened images ``[batch, height·width·channels]``
(``cnnflat``) and volumetric ``[batch, depth, height, width, channels]``
(``cnn3d``, NDHWC).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Tuple

from ...utils.serde import register_serde


@register_serde
@dataclass(frozen=True)
class InputType:
    kind: str  # "ff" | "rnn" | "cnn" | "cnnflat" | "cnn3d"
    size: int = 0            # ff/rnn feature size
    timesteps: int = -1      # -1 = variable
    height: int = 0
    width: int = 0
    depth: int = 0           # cnn3d
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

    @staticmethod
    def convolutional_3d(depth: int, height: int, width: int,
                         channels: int) -> "InputType":
        return InputType("cnn3d", depth=int(depth), height=int(height),
                         width=int(width), channels=int(channels))

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
        if self.kind == "cnn3d":
            return self.depth * self.height * self.width * self.channels
        raise ValueError(self.kind)

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
        if self.kind == "cnn3d":
            return (batch, self.depth, self.height, self.width,
                    self.channels)
        raise ValueError(self.kind)

    def to_dict(self):
        return asdict(self)

    @staticmethod
    def from_dict(d) -> "InputType":
        return InputType(**d)

    @staticmethod
    def infer(x, is_recurrent: bool = False) -> "InputType":
        """Best-effort inference from an array or tensor (reference
        ``InputType.inferInputType``)."""
        if x.ndim == 2:
            if is_recurrent:
                raise ValueError("2d array cannot be recurrent input")
            return InputType.feed_forward(x.shape[1])
        if x.ndim == 3:
            return InputType.recurrent(x.shape[2], x.shape[1])
        if x.ndim == 4:
            return InputType.convolutional(x.shape[1], x.shape[2],
                                           x.shape[3])
        if x.ndim == 5:
            return InputType.convolutional_3d(x.shape[1], x.shape[2],
                                              x.shape[3], x.shape[4])
        raise ValueError(f"cannot infer input type from shape {x.shape}")
