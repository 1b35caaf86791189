"""Convolution-family layers (port of ``nn/layers/convolution.py``):
2-D and 1-D convolution, 2-D and 1-D pooling (max, avg, sum, pnorm),
zero padding and nearest-neighbour upsampling.

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
does not tile.  The 1-D layers work on ``[b, t, f]`` the same way, as a
``[b, f, t]`` view (a 1-D kernel ``W`` is ``[k, c_in, c_out]``).
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


def _window_sum_2d(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """Exact window sums of an NCHW tensor (divisor 1), no padding."""
    return F.avg_pool2d(x, kernel, stride, divisor_override=1)


def _pool_nhwc(x: torch.Tensor, pt: str, kernel, stride, pads, pnorm: int,
               eps: float, name) -> torch.Tensor:
    """``lax.reduce_window`` pooling of an NHWC tensor over ``kernel``
    windows with explicit ``pads``; avg divides the window sum by kh·kw,
    padding included, and pnorm is ``(Σ|x|^p + eps)^(1/p)``."""
    if pt == "max":
        return _nhwc(F.max_pool2d(_nchw(_pad_nhwc(x, pads, float("-inf"))),
                                  kernel, stride))
    if pt in ("avg", "sum"):
        y = _window_sum_2d(_nchw(_pad_nhwc(x, pads, 0.0)), kernel, stride)
        if pt == "avg":
            y = y / (kernel[0] * kernel[1])
        return _nhwc(y)
    if pt == "pnorm":
        p = float(pnorm)
        y = _window_sum_2d(_nchw(_pad_nhwc(torch.abs(x) ** p, pads, 0.0)),
                           kernel, stride)
        return _nhwc((y + eps) ** (1.0 / p))
    raise ValueError(f"layer '{name}': unknown pooling type '{pt}'")


@register_serde
@dataclass
class ConvolutionLayer(BaseLayerConf):
    """2D convolution.  Params: W [kh, kw, c_in, c_out] (HWIO), b [c_out].
    Input/output: NHWC."""
    INPUT_KIND = "cnn"

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

    def apply(self, params, x, *, train=False, key=None):
        params = self.maybe_noise_weights(params, train, key)
        x = self.maybe_dropout_input(x, train, key)
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
class Convolution1DLayer(BaseLayerConf):
    """1D (temporal) convolution over ``[b, t, f]``.  Params: W
    [k, c_in, c_out], b [c_out]."""
    INPUT_KIND = "rnn"

    n_in: int = 0
    n_out: int = 0
    kernel_size: int = 5
    stride: int = 1
    padding: int = 0
    dilation: int = 1
    convolution_mode: str = "truncate"
    has_bias: bool = True

    def set_n_in(self, itype: InputType, override: bool = False) -> None:
        if self.n_in == 0 or override:
            self.n_in = itype.size

    def output_type(self, itype: InputType) -> InputType:
        t = itype.timesteps
        if t is not None and t > 0:
            t = conv_output_size(t, self.kernel_size, self.stride,
                                 self.padding, self.dilation,
                                 self.convolution_mode,
                                 f"layer '{self.name}' time")
        return InputType.recurrent(self.n_out, t if t else -1)

    def init(self, generator, itype, device):
        if self.n_in <= 0 or self.n_out <= 0:
            raise ValueError(f"layer '{self.name}': n_in/n_out unset")
        params = {"W": self.make_weight(
            generator, (self.kernel_size, self.n_in, self.n_out), device)}
        if self.has_bias:
            params["b"] = self.make_bias((self.n_out,), device)
        return params

    def apply(self, params, x, *, train=False, key=None):
        params = self.maybe_noise_weights(params, train, key)
        x = self.maybe_dropout_input(x, train, key)
        w = params["W"]
        k, s, d = self.kernel_size, self.stride, self.dilation
        if self.convolution_mode == "same":
            lo, hi = same_pads(x.shape[1], k, s, d)
        else:
            lo = hi = self.padding
        xt = x.to(w.dtype).transpose(1, 2)               # [b, f, t]
        if lo != hi:
            xt = F.pad(xt, (lo, hi))
            lo = 0
        z = F.conv1d(xt, w.permute(2, 1, 0),
                     params.get("b") if self.has_bias else None,
                     stride=s, padding=lo, dilation=d)
        return self.act_fn(z.transpose(1, 2))

    def feed_forward_mask(self, mask, itype):
        if mask is None or (self.stride == 1 and
                            self.convolution_mode == "same"):
            return mask
        return None  # time length changed; mask no longer aligned


@register_serde
@dataclass
class SubsamplingLayer(LayerConf):
    """Spatial pooling over kernel windows, NHWC: max, avg (the window
    sum over kh·kw, padding included, as ``lax.reduce_window`` + divide),
    sum or pnorm."""
    INPUT_KIND = "cnn"

    pooling_type: str = "max"     # max | avg | sum | pnorm
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

    def apply(self, params, x, *, train=False, key=None):
        kernel, stride = _pair(self.kernel_size), _pair(self.stride)
        pads = _pads(x, self.convolution_mode, kernel, stride,
                     _pair(self.padding))
        return _pool_nhwc(x, self.pooling_type.lower(), kernel, stride, pads,
                          self.pnorm, self.eps, self.name)


@register_serde
@dataclass
class Subsampling1DLayer(LayerConf):
    """Temporal pooling over ``[b, t, f]``: max, avg, sum or pnorm, as
    the 2-D layer over a ``[b, t, 1, f]`` view."""
    INPUT_KIND = "rnn"

    pooling_type: str = "max"
    kernel_size: int = 2
    stride: int = 2
    padding: int = 0
    convolution_mode: str = "truncate"
    pnorm: int = 2
    eps: float = 1e-8

    def output_type(self, itype: InputType) -> InputType:
        t = itype.timesteps
        if t is not None and t > 0:
            t = conv_output_size(t, self.kernel_size, self.stride,
                                 self.padding, 1, self.convolution_mode,
                                 f"layer '{self.name}' time")
        return InputType.recurrent(itype.size, t if t else -1)

    def apply(self, params, x, *, train=False, key=None):
        k, s = self.kernel_size, self.stride
        if self.convolution_mode == "same":
            pads = (same_pads(x.shape[1], k, s), (0, 0))
        else:
            pads = ((self.padding, self.padding), (0, 0))
        y = _pool_nhwc(x[:, :, None, :], self.pooling_type.lower(), (k, 1),
                       (s, 1), pads, self.pnorm, self.eps, self.name)
        return y[:, :, 0, :]

    def feed_forward_mask(self, mask, itype):
        if mask is None or (self.stride == 1 and
                            self.convolution_mode == "same"):
            return mask  # time axis unchanged: the mask still aligns
        return None


@register_serde
@dataclass
class ZeroPaddingLayer(LayerConf):
    """Spatial zero padding; ``padding`` is (top, bottom, left, right) or
    (h, w)."""
    INPUT_KIND = "cnn"

    padding: Sequence[int] = (1, 1, 1, 1)

    def _pads(self):
        p = tuple(int(v) for v in self.padding)
        if len(p) == 2:
            return (p[0], p[0], p[1], p[1])
        if len(p) == 4:
            return p
        raise ValueError("padding must be (h, w) or (top, bottom, left, "
                         "right)")

    def output_type(self, itype: InputType) -> InputType:
        t, b, l, r = self._pads()
        return InputType.convolutional(itype.height + t + b,
                                       itype.width + l + r, itype.channels)

    def apply(self, params, x, *, train=False, key=None):
        t, b, l, r = self._pads()
        return F.pad(x, (0, 0, l, r, t, b))


@register_serde
@dataclass
class Upsampling2D(LayerConf):
    """Nearest-neighbour upsampling of NHWC images."""
    INPUT_KIND = "cnn"

    size: Sequence[int] = (2, 2)

    def output_type(self, itype: InputType) -> InputType:
        sh, sw = _pair(self.size)
        return InputType.convolutional(itype.height * sh, itype.width * sw,
                                       itype.channels)

    def apply(self, params, x, *, train=False, key=None):
        sh, sw = _pair(self.size)
        return x.repeat_interleave(sh, dim=1).repeat_interleave(sw, dim=2)


@register_serde
@dataclass
class Upsampling1D(LayerConf):
    """Temporal upsampling of ``[b, t, f]``."""
    INPUT_KIND = "rnn"

    size: int = 2

    def output_type(self, itype: InputType) -> InputType:
        t = itype.timesteps
        return InputType.recurrent(itype.size,
                                   t * self.size if t and t > 0 else -1)

    def apply(self, params, x, *, train=False, key=None):
        return x.repeat_interleave(self.size, dim=1)
