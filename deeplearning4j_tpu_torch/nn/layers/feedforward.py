"""Feed-forward layers (port of ``nn/layers/feedforward.py``): Dense,
Output, CenterLossOutput, Loss, Activation, Dropout, Embedding and
EmbeddingSequence.

``DenseLayer`` computes ``x @ W + b`` with ``W`` stored ``[n_in, n_out]``
as in the JAX package (not ``nn.Linear``'s transposed weight).
``OutputLayer`` adds the loss head.  ``EmbeddingLayer`` takes ids
``[b]``/``[b, 1]`` or a one-hot ``[b, n_in]`` batch,
``EmbeddingSequenceLayer`` integer ids ``[b, t]`` or a one-hot
``[b, t, n_in]`` batch, which both decode by argmax.  The id range is
checked once, on the host batch, at the network's boundary
(``validate_host_ids``), not inside the forward, where reading a device
tensor's min and max would stall the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ...parallel.inference import InvalidInputError
from ...utils import global_batch
from ...utils.device import constant
from ...utils.serde import register_serde
from .. import losses as _losses
from ..conf.input_type import InputType
from .base import BaseLayerConf


@register_serde
@dataclass
class DenseLayer(BaseLayerConf):
    INPUT_KIND = "ff"

    n_in: int = 0
    n_out: int = 0
    has_bias: bool = True

    def set_n_in(self, itype: InputType, override: bool = False) -> None:
        if self.n_in == 0 or override:
            if itype.kind not in ("ff", "cnnflat"):
                raise ValueError(f"layer '{self.name}': dense layer expects "
                                 f"FF input, got {itype}")
            self.n_in = itype.flat_size() if itype.kind == "cnnflat" \
                else itype.size

    def output_type(self, itype: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init(self, generator, itype, device):
        if self.n_in <= 0 or self.n_out <= 0:
            raise ValueError(
                f"layer '{self.name}': n_in={self.n_in}, n_out={self.n_out}")
        params = {"W": self.make_weight(generator, (self.n_in, self.n_out),
                                        device)}
        if self.has_bias:
            params["b"] = self.make_bias((self.n_out,), device)
        return params

    def pre_output(self, params, x, *, train=False, key=None):
        params = self.maybe_noise_weights(params, train, key)
        x = self.maybe_dropout_input(x, train, key)
        z = x @ params["W"]
        if self.has_bias:
            z = z + params["b"]
        return z

    def apply(self, params, x, *, train=False, key=None):
        return self.act_fn(self.pre_output(params, x, train=train, key=key))


@register_serde
@dataclass
class OutputLayer(DenseLayer):
    """Dense + loss head.  ``loss_weights`` scales the per-unit loss
    column-wise before reduction (the reference's per-output weights)."""
    loss: str = "mcxent"
    loss_weights: Optional[Sequence[float]] = None

    def compute_loss(self, params, x, labels, *, train=False, key=None,
                     mask=None):
        z = self.pre_output(params, x, train=train, key=key)
        act = self.resolved("activation", "identity")
        if self.loss_weights is not None:
            w = constant(self.loss_weights, z.dtype, z.device)
            if w.shape[-1] != self.n_out:
                raise ValueError(
                    f"layer '{self.name}': {w.shape[-1]} loss weights for "
                    f"{self.n_out} outputs")
            return _losses.get(self.loss)(labels, z, act, mask,
                                          unit_weights=w)
        return _losses.get(self.loss)(labels, z, act, mask)


@register_serde
@dataclass
class CenterLossOutputLayer(OutputLayer):
    """Softmax + center loss (reference ``CenterLossOutputLayer``): the
    intra-class term λ/2·||f − c_y||².  ``centers`` ``[n_out, n_in]`` is
    a param that the updater steps like any other; its pull towards the
    features is value-neutral (``+ l_cent − l_cent.detach()``), so it adds
    gradient to the centers and nothing to the score, and l1/l2 skip it."""
    alpha: float = 0.05
    lambda_: float = 2e-4

    def init(self, generator, itype, device):
        params = super().init(generator, itype, device)
        params["centers"] = torch.zeros((self.n_out, self.n_in),
                                        dtype=self._dtype(), device=device)
        return params

    def regularization_score(self, params):
        # centers are statistics, not weights
        return super().regularization_score(
            {k: v for k, v in params.items() if k != "centers"})

    def compute_loss(self, params, x, labels, *, train=False, key=None,
                     mask=None):
        base = super().compute_loss(params, x, labels, train=train, key=key,
                                    mask=mask)
        centers = params["centers"]
        c_sel = labels.to(centers.dtype) @ centers     # one-hot row select
        per_f = torch.sum((x - c_sel.detach()) ** 2, dim=-1)
        per_c = torch.sum((x.detach() - c_sel) ** 2, dim=-1)
        if mask is not None:
            w = mask.reshape(mask.shape[0], -1)[:, 0].to(per_f.dtype)
            mean_f = global_batch.masked_mean(torch.sum(w * per_f),
                                              torch.sum(w))
            mean_c = global_batch.masked_mean(torch.sum(w * per_c),
                                              torch.sum(w))
        else:
            mean_f = global_batch.mean_rows(per_f)
            mean_c = global_batch.mean_rows(per_c)
        l_feat = 0.5 * self.lambda_ * mean_f
        l_cent = 0.5 * self.alpha * mean_c
        return base + l_feat + l_cent - l_cent.detach()


@register_serde
@dataclass
class LossLayer(BaseLayerConf):
    """Loss-only head, no params (reference ``LossLayer``)."""
    loss: str = "mse"

    def has_params(self):
        return False

    def apply(self, params, x, *, train=False, key=None):
        return self.act_fn(x)

    def compute_loss(self, params, x, labels, *, train=False, key=None,
                     mask=None):
        return _losses.get(self.loss)(
            labels, x, self.resolved("activation", "identity"), mask)


@register_serde
@dataclass
class ActivationLayer(BaseLayerConf):
    """The activation alone, no params."""

    def has_params(self):
        return False

    def apply(self, params, x, *, train=False, key=None):
        return self.act_fn(x)


@register_serde
@dataclass
class DropoutLayer(BaseLayerConf):
    """Standalone dropout (reference ``DropoutLayer``): the activation,
    then the layer's dropout."""

    def apply(self, params, x, *, train=False, key=None):
        return self.maybe_dropout_input(self.act_fn(x), train, key)


def _is_integer(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_complex \
        and dtype != torch.bool


@register_serde
@dataclass
class EmbeddingLayer(BaseLayerConf):
    """Index -> vector lookup (reference ``EmbeddingLayer``): ids
    ``[b]``/``[b, 1]`` or one-hot ``[b, n_in]`` -> ``[b, n_out]``, plus
    the bias."""
    n_in: int = 0
    n_out: int = 0
    has_bias: bool = True
    sparse_grad: bool = False
    sparse_grad_capacity: Optional[int] = None

    def set_n_in(self, itype: InputType, override: bool = False) -> None:
        if self.n_in == 0 or override:
            self.n_in = itype.size

    def output_type(self, itype: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init(self, generator, itype, device):
        params = {"W": self.make_weight(generator, (self.n_in, self.n_out),
                                        device)}
        if self.has_bias:
            params["b"] = self.make_bias((self.n_out,), device)
        return params

    def decode_ids(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """``[b]`` int64 ids, or None for a one-hot batch (float
        ``[b, n_in]``, or the integer one-hot form with n_in > 1)."""
        if x.ndim == 2 and x.shape[-1] == self.n_in and self.n_in > 1 and \
                not _is_integer(x.dtype):
            return None
        if x.ndim == 2 and x.shape[-1] == 1:
            x = x[:, 0]
        if x.ndim != 1:
            if x.ndim == 2 and x.shape[-1] == self.n_in and self.n_in > 1:
                return None
            raise InvalidInputError(
                f"layer '{self.name}': expected ids [batch]/[batch, 1] or "
                f"one-hot [batch, {self.n_in}], got shape {tuple(x.shape)}")
        if not _is_integer(x.dtype):
            raise InvalidInputError(
                f"layer '{self.name}': embedding ids must be an integer "
                f"dtype, got {x.dtype} — a float id batch would silently "
                f"truncate; pass int ids, or a one-hot batch with trailing "
                f"dim {self.n_in}")
        return x.long()

    def apply(self, params, x, *, train=False, key=None):
        idx = self.decode_ids(x)
        if idx is None:
            idx = torch.argmax(x, dim=-1)
        if self.sparse_grad:
            from .. import sparse as _sparse
            z = _sparse.embedding_lookup(params["W"], idx)
        else:
            z = params["W"][idx]
        if self.has_bias:
            z = z + params["b"]
        return self.act_fn(z)


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

    INPUT_KIND = "rnn"

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

    def apply(self, params, x, *, train=False, key=None):
        W = params["W"]
        idx = self.decode_ids(x)
        if idx is None:
            z = x.to(W.dtype) @ W
        elif self.sparse_grad:
            from .. import sparse as _sparse
            z = _sparse.embedding_lookup(W, idx)
        else:
            z = W[idx]
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
