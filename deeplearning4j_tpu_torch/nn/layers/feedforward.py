"""Dense/output head and token embedding (port of the parts of
``nn/layers/feedforward.py`` that TransformerLM uses).

``DenseLayer`` computes ``x @ W + b`` with ``W`` stored ``[n_in, n_out]``
as in the JAX package (not ``nn.Linear``'s transposed weight).
``OutputLayer`` adds the loss head.  ``EmbeddingSequenceLayer`` takes
integer ids ``[b, t]`` or a one-hot ``[b, t, n_in]`` batch, which it
decodes by argmax.  The id range is checked once, on the host batch, at
the network's boundary (``validate_host_ids``), not inside the forward,
where reading a device tensor's min and max would stall the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ...parallel.inference import InvalidInputError
from ...utils.serde import register_serde
from .. import losses as _losses
from ..conf.input_type import InputType
from .base import BaseLayerConf


@register_serde
@dataclass
class DenseLayer(BaseLayerConf):
    n_in: int = 0
    n_out: int = 0
    has_bias: bool = True

    def output_type(self, itype: InputType) -> InputType:
        raise ValueError("feed-forward input types are not ported yet")

    def init(self, generator, itype, device):
        if self.n_in <= 0 or self.n_out <= 0:
            raise ValueError(
                f"layer '{self.name}': n_in={self.n_in}, n_out={self.n_out}")
        params = {"W": self.make_weight(generator, (self.n_in, self.n_out),
                                        device)}
        if self.has_bias:
            params["b"] = self.make_bias((self.n_out,), device)
        return params

    def pre_output(self, params, x, *, train=False):
        params = self.maybe_noise_weights(params, train)
        x = self.maybe_dropout_input(x, train)
        z = x @ params["W"]
        if self.has_bias:
            z = z + params["b"]
        return z

    def apply(self, params, x, *, train=False):
        return self.act_fn(self.pre_output(params, x, train=train))


@register_serde
@dataclass
class OutputLayer(DenseLayer):
    """Dense + loss head.  ``loss_weights`` scales the per-unit loss
    column-wise before reduction (the reference's per-output weights)."""
    loss: str = "mcxent"
    loss_weights: Optional[Sequence[float]] = None

    def compute_loss(self, params, x, labels, *, train=False, mask=None):
        z = self.pre_output(params, x, train=train)
        act = self.resolved("activation", "identity")
        if self.loss_weights is not None:
            w = torch.as_tensor(self.loss_weights, dtype=z.dtype,
                                device=z.device)
            if w.shape[-1] != self.n_out:
                raise ValueError(
                    f"layer '{self.name}': {w.shape[-1]} loss weights for "
                    f"{self.n_out} outputs")
            return _losses.get(self.loss)(labels, z, act, mask,
                                          unit_weights=w)
        return _losses.get(self.loss)(labels, z, act, mask)


def _is_integer(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_complex \
        and dtype != torch.bool


@register_serde
@dataclass
class EmbeddingSequenceLayer(BaseLayerConf):
    """Token ids ``[b, t]`` (or one-hot ``[b, t, n_in]``) ->
    ``[b, t, n_out]`` by lookup.  ``one_hot_matmul=True`` keeps soft
    distributions over the vocabulary as ``x @ W``."""
    n_in: int = 0     # vocabulary size
    n_out: int = 0    # embedding dim
    one_hot_matmul: bool = False
    sparse_grad: bool = False
    sparse_grad_capacity: Optional[int] = None

    def set_n_in(self, itype: InputType, override: bool = False) -> None:
        if self.n_in == 0 or override:
            self.n_in = itype.size

    def output_type(self, itype: InputType) -> InputType:
        return InputType.recurrent(self.n_out, itype.timesteps)

    def init(self, generator, itype, device):
        return {"W": self.make_weight(generator, (self.n_in, self.n_out),
                                      device)}

    def decode_ids(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """``[b, t]`` int64 ids, or None when the batch takes the one-hot
        matmul."""
        if x.ndim == 3:
            if self.n_in > 0 and x.shape[-1] != self.n_in:
                raise InvalidInputError(
                    f"layer '{self.name}': 3-D input has trailing dim "
                    f"{x.shape[-1]} but the vocabulary is {self.n_in} — "
                    f"expected one-hot [batch, time, {self.n_in}] (or "
                    "integer ids [batch, time])")
            if self.one_hot_matmul or self.n_in <= 0:
                return None
            return torch.argmax(x, dim=-1)
        if x.ndim != 2:
            raise InvalidInputError(
                f"layer '{self.name}': expected ids [batch, time] or "
                f"one-hot [batch, time, {self.n_in}], got shape "
                f"{tuple(x.shape)}")
        if not _is_integer(x.dtype):
            raise InvalidInputError(
                f"layer '{self.name}': embedding ids must be an integer "
                f"dtype, got {x.dtype} — a float id batch would silently "
                f"truncate; pass int ids, or a one-hot batch with trailing "
                f"dim {self.n_in}")
        return x.long()

    def apply(self, params, x, *, train=False):
        W = params["W"]
        idx = self.decode_ids(x)
        z = x.to(W.dtype) @ W if idx is None else W[idx]
        return self.act_fn(z)


def validate_host_ids(lc, x) -> None:
    """Id-range check of a host (numpy) id batch for an embedding-first
    network, at the fit/output/score boundary.  Tensors skip it, CPU ones
    included: reading a CUDA tensor's min and max stalls the device, and
    a tensor's producer validated it on the host.  Lists and tuples
    (multi-input batches) skip, as in the reference, and so do float and
    one-hot batches: the dtype check in ``decode_ids`` covers them."""
    if x is None or isinstance(x, (torch.Tensor, list, tuple)):
        return
    arr = np.asarray(x)
    if arr.ndim == 0 or arr.size == 0 or \
            not np.issubdtype(arr.dtype, np.integer):
        return
    lo, hi = int(arr.min()), int(arr.max())
    if lo < 0 or hi >= lc.n_in:
        raise InvalidInputError(
            f"layer '{lc.name}': embedding ids out of range [{lo}, {hi}] "
            f"for vocabulary of {lc.n_in}")
