"""Input preprocessors: reshapes between layer families (port of
``nn/conf/preprocessors.py``).

Images are NHWC and time series ``[batch, time, features]``, as in the
JAX package, so a flattened image is read in (h, w, c) order: a dense
layer after a CNN reads the same rows of ``W`` on both sides.  Each is a
reshape that autograd differentiates; ``feed_forward_mask`` maps a
features mask where the time axis moves.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...utils.serde import register_serde
from .input_type import InputType


@dataclass
class InputPreProcessor:
    def pre_process(self, x, mask=None):
        raise NotImplementedError

    def output_type(self, itype: InputType) -> InputType:
        raise NotImplementedError

    def feed_forward_mask(self, mask, itype):
        return mask


@register_serde
@dataclass
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 0

    def pre_process(self, x, mask=None):
        return x.reshape(x.shape[0], -1)

    def output_type(self, itype):
        return InputType.feed_forward(itype.height * itype.width
                                      * itype.channels)


@register_serde
@dataclass
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 0

    def pre_process(self, x, mask=None):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, itype):
        return InputType.convolutional(self.height, self.width,
                                       self.channels)


@register_serde
@dataclass
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """Time-distributed activations ``[b·t, f]`` back to ``[b, t, f]``
    (``timesteps`` known), else ``[b, f]`` as one step ``[b, 1, f]``."""
    timesteps: int = -1

    def pre_process(self, x, mask=None):
        if self.timesteps > 0:
            return x.reshape(-1, self.timesteps, x.shape[-1])
        return x[:, None, :]

    def output_type(self, itype):
        return InputType.recurrent(itype.size, self.timesteps)


@register_serde
@dataclass
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """``[b, t, f]`` -> ``[b·t, f]`` (time-distributed dense)."""

    def pre_process(self, x, mask=None):
        return x.reshape(-1, x.shape[-1])

    def output_type(self, itype):
        return InputType.feed_forward(itype.size)

    def feed_forward_mask(self, mask, itype):
        return None if mask is None else mask.reshape(-1)


@register_serde
@dataclass
class CnnToRnnPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 0
    timesteps: int = -1

    def pre_process(self, x, mask=None):
        flat = x.reshape(x.shape[0], -1)
        if self.timesteps > 0:
            return flat.reshape(-1, self.timesteps, flat.shape[-1])
        return flat[:, None, :]

    def output_type(self, itype):
        return InputType.recurrent(itype.height * itype.width
                                   * itype.channels, self.timesteps)


@register_serde
@dataclass
class RnnToCnnPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 0

    def pre_process(self, x, mask=None):
        return x.reshape(-1, self.height, self.width, self.channels)

    def output_type(self, itype):
        return InputType.convolutional(self.height, self.width,
                                       self.channels)


@register_serde
@dataclass
class CnnFlatToCnnPreProcessor(InputPreProcessor):
    """Flattened image rows -> NHWC."""
    height: int = 0
    width: int = 0
    channels: int = 0

    def pre_process(self, x, mask=None):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, itype):
        return InputType.convolutional(self.height, self.width,
                                       self.channels)


def auto_preprocessor(prev: InputType, layer):
    """The reshape the JAX package inserts where layer families change
    (``nn/conf/multi_layer._auto_preprocessor``), or None."""
    want = getattr(layer, "INPUT_KIND", "any")
    if want == "any" or prev.kind == want:
        return None
    if want == "ff":
        if prev.kind == "cnn":
            return CnnToFeedForwardPreProcessor(prev.height, prev.width,
                                                prev.channels)
        if prev.kind == "cnnflat":
            return None  # already flat
        if prev.kind == "rnn":
            return RnnToFeedForwardPreProcessor()
    elif want == "cnn":
        if prev.kind == "cnnflat":
            return CnnFlatToCnnPreProcessor(prev.height, prev.width,
                                            prev.channels)
        if prev.kind == "ff":
            raise ValueError(
                f"cannot infer CNN dims from FF input for layer "
                f"'{layer.name}'; add an explicit "
                "FeedForwardToCnnPreProcessor")
    elif want == "rnn":
        if prev.kind == "ff":
            return FeedForwardToRnnPreProcessor()
        if prev.kind == "cnn":
            return CnnToRnnPreProcessor(prev.height, prev.width,
                                        prev.channels)
    raise ValueError(
        f"no automatic preprocessor from {prev.kind} input to '{want}' "
        f"layer '{layer.name}'")
