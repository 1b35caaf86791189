"""Global pooling (port of ``nn/layers/pooling.py``): CNN activations
``[b, h, w, c]`` -> ``[b, c]``, or RNN activations ``[b, t, f]`` ->
``[b, f]``, with the masked time reductions of variable-length series
(reference ``MaskedReductionUtil``): max over the valid steps, sum and
pnorm of the masked values, avg over the valid count."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ...utils.serde import register_serde
from ..conf.input_type import InputType
from .base import LayerConf


@register_serde
@dataclass
class GlobalPoolingLayer(LayerConf):
    pooling_type: str = "max"    # max | avg | sum | pnorm
    pnorm: int = 2
    collapse_dimensions: bool = True

    def output_type(self, itype: InputType) -> InputType:
        if itype.kind == "cnn":
            return InputType.feed_forward(itype.channels)
        if itype.kind == "rnn":
            return InputType.feed_forward(itype.size)
        raise ValueError(f"global pooling over {itype.kind} input")

    def forward(self, params, state, x, *, train=False, key=None,
                mask=None):
        if mask is not None and x.ndim == 3:
            return self._masked(x, mask), state
        return self.apply(params, x, train=train), state

    def _masked(self, x, mask):
        m = mask.to(x.dtype)[:, :, None]
        pt = self.pooling_type.lower()
        if pt == "max":
            return torch.amax(torch.where(m > 0, x, torch.full(
                (), float("-inf"), dtype=x.dtype, device=x.device)), dim=1)
        if pt == "sum":
            return torch.sum(x * m, dim=1)
        if pt == "avg":
            return torch.sum(x * m, dim=1) / torch.clamp(
                torch.sum(m, dim=1), min=1e-8)
        if pt == "pnorm":
            p = float(self.pnorm)
            return torch.sum(torch.abs(x * m) ** p, dim=1) ** (1.0 / p)
        raise ValueError(f"unknown pooling type '{self.pooling_type}'")

    def feed_forward_mask(self, mask, itype):
        return None      # the time axis is gone after global pooling

    def apply(self, params, x, *, train=False, key=None):
        if x.ndim == 4:
            dims = (1, 2)
        elif x.ndim == 3:
            dims = (1,)
        else:
            raise ValueError(f"global pooling needs 3/4-d input, got "
                             f"{x.ndim}d")
        pt = self.pooling_type.lower()
        if pt == "max":
            return torch.amax(x, dim=dims)
        if pt == "avg":
            return torch.mean(x, dim=dims)
        if pt == "sum":
            return torch.sum(x, dim=dims)
        if pt == "pnorm":
            p = float(self.pnorm)
            return torch.sum(torch.abs(x) ** p, dim=dims) ** (1.0 / p)
        raise ValueError(f"unknown pooling type '{self.pooling_type}'")
