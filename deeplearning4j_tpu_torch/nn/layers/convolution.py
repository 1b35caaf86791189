"""2-D convolution and spatial pooling (port of the parts of
``nn/layers/convolution.py`` that ResNet50 uses).

Layout is the JAX package's: activations are NHWC ``[b, h, w, c]`` and a
conv kernel ``W`` is HWIO ``[kh, kw, c_in, c_out]``, so a checkpoint
crosses without transposes.  ``x.permute(0, 3, 1, 2)`` of a contiguous
NHWC tensor is an NCHW view in PyTorch's channels-last memory format,
which is what ``F.conv2d`` and the pools take; their channels-last output
permutes back to a contiguous NHWC tensor.  Activations therefore stay
channels-last in memory from layer to layer, and the BatchNorm kernel
reads them as ``[M, C]`` without a copy.

Padding follows XLA.  ``same`` gives ``ceil(in / stride)`` outputs and
pads ``total // 2`` before and the rest after: asymmetric under stride
(the 7x7/2 stem at 224 pads (2, 3), the 3x3/2 max pool at 112 pads
(0, 1)), which PyTorch's symmetric ``padding=`` cannot express.  Such a
pad is an explicit ``F.pad`` (zeros for a conv or a sum, ``-inf`` for a
max pool) before an op with ``padding=0``; a symmetric pad goes to the op.
``truncate`` is VALID with the configured symmetric padding, flooring
leftover pixels; ``strict`` raises at configuration time when the input
does not tile.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ...utils.serde import register_serde
from ..conf.input_type import InputType
from .base import BaseLayerConf, LayerConf


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def conv_output_size(size: int, k: int, s: int, p: int, d: int, mode: str,
                     what: str = "input") -> int:
    """Reference ``ConvolutionUtils.getOutputSize``."""
    eff_k = k + (k - 1) * (d - 1)
    if mode == "same":
        return -(-size // s)  # ceil
    out = (size + 2 * p - eff_k) // s + 1
    if mode == "strict" and (size + 2 * p - eff_k) % s != 0:
        raise ValueError(
            f"ConvolutionMode.strict: {what} size {size} (+2*{p} pad) does not "
            f"tile with kernel {k} (dilation {d}) stride {s}; use mode='truncate' "
            "or 'same', or fix the sizes (reference ConvolutionUtils message)")
    if out < 1:
        raise ValueError(
            f"{what} size {size} too small for kernel {k} stride {s} pad {p}")
    return out


def same_pads(size: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (before, after)."""
    eff_k = k + (k - 1) * (d - 1)
    out = -(-size // s)
    total = max((out - 1) * s + eff_k - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, mode: str, kernel, stride, padding, dilation=(1, 1)
          ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((top, bottom), (left, right)) for an NHWC input."""
    if mode == "same":
        return tuple(same_pads(x.shape[1 + i], kernel[i], stride[i],
                               dilation[i]) for i in range(2))
    return tuple((p, p) for p in padding)


def _pad_nhwc(x: torch.Tensor, pads, value: float) -> torch.Tensor:
    (t, b), (l, r) = pads
    if not (t or b or l or r):
        return x
    return F.pad(x, (0, 0, l, r, t, b), value=value)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> NCHW view (channels-last memory when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


@register_serde
@dataclass
class ConvolutionLayer(BaseLayerConf):
    """2D convolution.  Params: W [kh, kw, c_in, c_out] (HWIO), b [c_out].
    Input/output: NHWC."""
    n_in: int = 0                 # input channels (inferred)
    n_out: int = 0                # output channels
    kernel_size: Sequence[int] = (5, 5)
    stride: Sequence[int] = (1, 1)
    padding: Sequence[int] = (0, 0)
    dilation: Sequence[int] = (1, 1)
    convolution_mode: str = "truncate"
    has_bias: bool = True

    def set_n_in(self, itype: InputType, override: bool = False) -> None:
        if self.n_in == 0 or override:
            if itype.kind != "cnn":
                raise ValueError(f"layer '{self.name}': conv layer expects "
                                 f"CNN input, got {itype}")
            self.n_in = itype.channels

    def output_type(self, itype: InputType) -> InputType:
        (kh, kw), (sh, sw) = _pair(self.kernel_size), _pair(self.stride)
        (ph, pw), (dh, dw) = _pair(self.padding), _pair(self.dilation)
        oh = conv_output_size(itype.height, kh, sh, ph, dh,
                              self.convolution_mode,
                              f"layer '{self.name}' height")
        ow = conv_output_size(itype.width, kw, sw, pw, dw,
                              self.convolution_mode,
                              f"layer '{self.name}' width")
        return InputType.convolutional(oh, ow, self.n_out)

    def init(self, generator, itype, device):
        if self.n_in <= 0 or self.n_out <= 0:
            raise ValueError(
                f"layer '{self.name}': n_in={self.n_in}, n_out={self.n_out} "
                "— declare the network input type or set n_in explicitly")
        kh, kw = _pair(self.kernel_size)
        params = {"W": self.make_weight(
            generator, (kh, kw, self.n_in, self.n_out), device)}
        if self.has_bias:
            params["b"] = self.make_bias((self.n_out,), device)
        return params

    def apply(self, params, x, *, train=False):
        params = self.maybe_noise_weights(params, train)
        x = self.maybe_dropout_input(x, train)
        w = params["W"]
        kernel, stride = _pair(self.kernel_size), _pair(self.stride)
        dilation = _pair(self.dilation)
        pads = _pads(x, self.convolution_mode, kernel, stride,
                     _pair(self.padding), dilation)
        sym = tuple(p[0] for p in pads) if all(p[0] == p[1] for p in pads) \
            else None
        if sym is None:
            x = _pad_nhwc(x, pads, 0.0)
            sym = (0, 0)
        z = F.conv2d(_nchw(x.to(w.dtype)), w.permute(3, 2, 0, 1),
                     params.get("b") if self.has_bias else None,
                     stride=stride, padding=sym, dilation=dilation)
        return self.act_fn(_nhwc(z))


@register_serde
@dataclass
class SubsamplingLayer(LayerConf):
    """Spatial pooling over kernel windows, NHWC: max, avg (the window
    sum over kh·kw, padding included, as ``lax.reduce_window`` + divide)
    or sum.  ``pnorm`` is not ported."""
    pooling_type: str = "max"     # max | avg | sum
    kernel_size: Sequence[int] = (2, 2)
    stride: Sequence[int] = (2, 2)
    padding: Sequence[int] = (0, 0)
    convolution_mode: str = "truncate"
    pnorm: int = 2
    eps: float = 1e-8

    def output_type(self, itype: InputType) -> InputType:
        (kh, kw), (sh, sw) = _pair(self.kernel_size), _pair(self.stride)
        ph, pw = _pair(self.padding)
        oh = conv_output_size(itype.height, kh, sh, ph, 1,
                              self.convolution_mode,
                              f"layer '{self.name}' height")
        ow = conv_output_size(itype.width, kw, sw, pw, 1,
                              self.convolution_mode,
                              f"layer '{self.name}' width")
        return InputType.convolutional(oh, ow, itype.channels)

    def apply(self, params, x, *, train=False):
        kernel, stride = _pair(self.kernel_size), _pair(self.stride)
        pads = _pads(x, self.convolution_mode, kernel, stride,
                     _pair(self.padding))
        pt = self.pooling_type.lower()
        if pt == "max":
            y = F.max_pool2d(_nchw(_pad_nhwc(x, pads, float("-inf"))),
                             kernel, stride)
        elif pt in ("avg", "sum"):
            # the window sum, exact (divisor 1), then the reference's divide
            y = F.avg_pool2d(_nchw(_pad_nhwc(x, pads, 0.0)), kernel, stride,
                             divisor_override=1)
            if pt == "avg":
                y = y / (kernel[0] * kernel[1])
        elif pt == "pnorm":
            raise NotImplementedError(
                f"layer '{self.name}': pooling_type 'pnorm' is not ported yet")
        else:
            raise ValueError(f"unknown pooling type '{self.pooling_type}'")
        return _nhwc(y)
