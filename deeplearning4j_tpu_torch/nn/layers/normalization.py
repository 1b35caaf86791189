"""Batch normalization and local response normalization (port of
``nn/layers/normalization.py``).

Training normalises with the batch's own statistics: one pass in f32,
the biased ``E[x²] − E[x]²`` clamped at 0 (``_bn_stats``), not
``torch.var`` (two passes) nor ``F.batch_norm`` (a library BN that keeps
an unbiased running variance).  The backward is the JAX package's
hand-derived two-pass formula (``_bn_bwd_math``), shared with the fused
kernel path of ``ops/pallas_bn``.  Both return ``(y, mean, var)`` and
drop the cotangents of mean and var, which feed only the running-stat
EMA.  Inside a data-parallel step of more than one rank (``gb``, the
``utils/global_batch.GlobalBatch`` of the step) both take the global
batch's statistics (SyncBN, as GSPMD computes them): the sums and sums
of squares, and the backward's two reductions, are all-reduced and
divided by the global row count, so the fused kernel applies global
statistics too.

The running mean and variance are the layer's state, ``{"mean", "var"}``:
``forward`` returns the new state (EMA with ``decay``, biased variance)
and never writes the old one.  Evaluation normalises with the running
statistics.

``helper="pallas"`` selects the fused apply(+ReLU) kernel of
``ops/pallas_bn`` wherever its ``supports`` rule accepts the shape, as
in the JAX package: the Hopper kernel on CUDA tensors, its plain version
on CPU tensors.  Elsewhere the layer takes ``_bn_train_norm`` and the
activation after it, which rounds differently (x̂·γ + β against
x·scale + shift).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ...ops import pallas_bn
from ...utils import global_batch
from ...utils.serde import register_serde
from ..conf.input_type import InputType
from .base import BaseLayerConf, LayerConf


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    """f32 accumulation for low-precision inputs; f64 stays f64."""
    return torch.promote_types(dt, torch.float32)


def _bn_stats(x: torch.Tensor, eps: float, gb=None):
    """One-pass statistics over every axis but the last: (mean, var, inv)
    in the accumulation dtype, var = max(E[x²] − E[x]², 0); over the
    global batch when ``gb`` is given."""
    dims = tuple(range(x.ndim - 1))
    xf = x.to(_acc_dtype(x.dtype))
    if gb is None:
        mean = torch.mean(xf, dim=dims)
        sq = torch.mean(xf * xf, dim=dims)
    else:
        c = x.shape[-1]
        sums = gb.all_reduce(torch.cat([torch.sum(xf, dim=dims),
                                        torch.sum(xf * xf, dim=dims)]))
        n = float((x.numel() // c) * gb.world)
        mean, sq = sums[:c] / n, sums[c:] / n
    var = torch.clamp(sq - mean * mean, min=0.0)
    return mean, var, torch.rsqrt(var + eps)


def _bn_fwd_math(x, gamma, beta, eps, gb=None):
    mean, var, inv = _bn_stats(x, eps, gb)
    xhat = (x - mean.to(x.dtype)) * inv.to(x.dtype)
    return xhat * gamma + beta, mean, var, inv


def _bn_bwd_math(x, gamma, mean, inv, dy, gb=None):
    """The two-pass backward: (dx, dgamma, dbeta).  With ``gb`` the two
    reductions that dx reads are the global batch's, and dgamma/dbeta
    are this rank's share (the wrappers' gradient exchange sums them)."""
    dims = tuple(range(x.ndim - 1))
    c = x.shape[-1]
    n = x.numel() // c
    acc = _acc_dtype(x.dtype)
    xhat = (x - mean.to(x.dtype)) * inv.to(x.dtype)
    dyf = dy.to(acc)
    # pass 1: both reductions over (dy, xhat)
    dbeta = torch.sum(dyf, dim=dims)
    dgamma = torch.sum(dyf * xhat.to(acc), dim=dims)
    sb, sg = dbeta, dgamma
    if gb is not None:
        both = gb.all_reduce(torch.cat([dbeta, dgamma]))
        sb, sg, n = both[:c], both[c:], n * gb.world
    # pass 2: dx = inv·gamma·(dy − dbeta/n − xhat·dgamma/n)
    coef = (inv * gamma.to(acc)).to(x.dtype)
    dx = coef * (dy - (sb / n).to(x.dtype)
                 - xhat * (sg / n).to(x.dtype))
    return dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype)


class _BnTrainNorm(torch.autograd.Function):
    """Training-mode batch norm with the hand-derived backward; returns
    (y, mean, var), mean and var not differentiable."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float, gb):
        y, mean, var, inv = _bn_fwd_math(x, gamma, beta, eps, gb)
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.gb = gb
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, mean, inv = ctx.saved_tensors
        dx, dgamma, dbeta = _bn_bwd_math(x, gamma, mean, inv, dy, ctx.gb)
        return dx, dgamma, dbeta, None, None


def bn_train_norm(x, gamma, beta, eps: float, gb=None):
    """(y, mean, var) of training-mode batch norm over the last axis;
    over the global batch of a data-parallel step when ``gb`` is
    given."""
    return _BnTrainNorm.apply(x, gamma, beta, eps, gb)


@register_serde
@dataclass
class BatchNormalization(BaseLayerConf):
    """Batch norm over the channel/feature axis (NHWC: reduce N, H, W).

    params: gamma, beta (unless lock_gamma_beta).  state: mean, var."""
    n_out: int = 0               # feature/channel count (inferred)
    decay: float = 0.9
    eps: float = 1e-5
    is_minibatch: bool = True
    lock_gamma_beta: bool = False
    gamma_init: float = 1.0
    beta_init: float = 0.0
    helper: Optional[str] = None

    def set_n_in(self, itype: InputType, override: bool = False) -> None:
        if self.n_out == 0 or override:
            self.n_out = itype.channels if itype.kind == "cnn" else itype.size

    def output_type(self, itype: InputType) -> InputType:
        return itype

    def _features(self) -> int:
        if self.n_out <= 0:
            raise ValueError(f"layer '{self.name}': feature count unknown — "
                             "declare input type")
        return self.n_out

    def init(self, generator, itype, device):
        f = self._features()
        if self.lock_gamma_beta:
            return {}
        dt = self._dtype()
        return {"gamma": torch.full((f,), float(self.gamma_init), dtype=dt,
                                    device=device),
                "beta": torch.full((f,), float(self.beta_init), dtype=dt,
                                   device=device)}

    def init_state(self, itype, device):
        f, dt = self._features(), self._dtype()
        return {"mean": torch.zeros((f,), dtype=dt, device=device),
                "var": torch.ones((f,), dtype=dt, device=device)}

    def forward(self, params, state, x, *, train=False, key=None,
                mask=None):
        act = self.resolved("activation", "identity")
        if self.lock_gamma_beta:
            gamma = torch.ones(x.shape[-1], dtype=x.dtype, device=x.device)
            beta = torch.zeros(x.shape[-1], dtype=x.dtype, device=x.device)
        else:
            gamma, beta = params["gamma"], params["beta"]
        if not (train and self.is_minibatch):
            mean, var = state["mean"], state["var"]
            xhat = (x - mean.to(x.dtype)) * torch.rsqrt(var.to(x.dtype)
                                                        + self.eps)
            if not self.lock_gamma_beta:
                xhat = xhat * gamma + beta
            return self.act_fn(xhat), state
        gamma, beta = gamma.to(x.dtype), beta.to(x.dtype)
        # None outside a data-parallel step of more than one rank; inside
        # one, the support rule sees the global batch's shape, as the JAX
        # package's (one program over the global batch) does
        gb = global_batch.current()
        shape = tuple(x.shape) if gb is None else \
            (gb.global_rows,) + tuple(x.shape[1:])
        if self.helper == "pallas" and pallas_bn.supports(
                activation=act, shape=shape, itemsize=x.element_size()):
            # the activation is fused into the apply
            y, mean, var = pallas_bn.bn_act_train(x, gamma, beta, self.eps,
                                                  act, gb=gb)
        else:
            y, mean, var = bn_train_norm(x, gamma, beta, self.eps, gb=gb)
            y = self.act_fn(y)
        d = self.decay
        with torch.no_grad():
            new_state = {k: d * state[k] + (1 - d) * v.to(state[k].dtype)
                         for k, v in (("mean", mean), ("var", var))}
        return y, new_state


@register_serde
@dataclass
class LocalResponseNormalization(LayerConf):
    """Across-channel LRN (reference ``LocalResponseNormalization``):
    ``y = x / (k + alpha · Σ_window x²)^beta`` over a window of n channels
    on the last (NHWC channel) axis, padded (n//2, n−1−n//2)."""
    INPUT_KIND = "cnn"

    k: float = 2.0
    alpha: float = 1e-4
    beta: float = 0.75
    n: int = 5

    def apply(self, params, x, *, train=False, key=None):
        half = self.n // 2
        sq = F.pad(x * x, (half, self.n - 1 - half))
        # window sums over the channel axis: exact, divisor 1
        summed = sq.unfold(-1, self.n, 1).sum(-1)
        return x / torch.pow(self.k + self.alpha * summed, self.beta)
