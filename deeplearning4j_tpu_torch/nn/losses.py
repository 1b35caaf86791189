"""Loss functions (port of ``nn/losses.py``: all 21 names).

Each loss is ``fn(labels, preout, activation, mask, unit_weights) ->
scalar``: the mean over examples of the per-example score, summed over
output units, from the *pre-activation* output, so that softmax
cross-entropy runs as a fused log-softmax.  Reductions run in at least
float32 (``_f32_loss_inputs``: low-precision pre-outputs, and labels
with them, are widened first).  The names and aliases are the JAX
package's: ``mse``/``squared_loss``, ``l2``, ``mae``/``l1``,
``mape``/``mean_absolute_percentage_error``,
``msle``/``mean_squared_logarithmic_error``, ``xent``,
``mcxent``/``negativeloglikelihood``, ``sparse_mcxent``, ``hinge``,
``squared_hinge``, ``kld``/``kl_divergence``, ``poisson``,
``cosine_proximity``, ``wasserstein`` and ``fmeasure``.  As there,
``l2`` ignores ``unit_weights`` and ``fmeasure`` ignores the mask and
the unit weights.  Inside a data-parallel step the means are over the
global batch (``utils/global_batch``).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch

from ..utils import global_batch
from . import activations

_EPS = 1e-7

_REGISTRY: Dict[str, Callable] = {}

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _f32_loss_inputs(fn: Callable) -> Callable:
    """Loss reductions always run in float32: low-precision pre-outputs
    (and low-precision labels with them) are widened first.  f32 inputs
    pass through untouched."""

    @functools.wraps(fn)
    def wrapped(labels, preout, *args, **kwargs):
        if preout.dtype in _LOW_PRECISION:
            preout = preout.float()
            if labels.dtype in _LOW_PRECISION:
                labels = labels.float()
        return fn(labels, preout, *args, **kwargs)

    return wrapped


def register(name: str):
    def deco(fn):
        _REGISTRY[name.lower()] = _f32_loss_inputs(fn)
        return fn
    return deco


def get(name) -> Callable:
    if callable(name):
        return name
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(f"Unknown loss '{name}'. Available: "
                         f"{names()}") from None


def names():
    return sorted(_REGISTRY)


def _apply_mask_and_mean(per_unit: torch.Tensor,
                         mask: Optional[torch.Tensor],
                         unit_weights: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Sum per-unit scores over feature axes, average over (masked)
    examples.  ``mask`` broadcasts against ``per_unit`` from the left
    (``[batch]``, ``[batch, t]`` or a full per-unit mask); the mean is over
    the rows with any mask weight on."""
    if unit_weights is not None:
        per_unit = per_unit * unit_weights
    if mask is not None:
        mask = mask.to(per_unit.dtype)
        while mask.ndim < per_unit.ndim:
            mask = mask[..., None]
        per_unit = per_unit * mask
        per_example = per_unit.reshape(per_unit.shape[0], -1).sum(dim=1)
        m = mask.reshape(mask.shape[0], -1).amax(dim=1)
        return global_batch.masked_mean(per_example.sum(), m.sum())
    per_example = per_unit.reshape(per_unit.shape[0], -1).sum(dim=1)
    return global_batch.mean_rows(per_example)


def _act(activation, preout):
    return activations.get(activation)(preout)


@register("mse")
@register("squared_loss")
def mse(labels, preout, activation="identity", mask=None,
        unit_weights=None):
    out = _act(activation, preout)
    return _apply_mask_and_mean((out - labels) ** 2, mask, unit_weights)


@register("l2")
def l2(labels, preout, activation="identity", mask=None, unit_weights=None):
    return mse(labels, preout, activation, mask)


@register("mae")
@register("l1")
def mae(labels, preout, activation="identity", mask=None,
        unit_weights=None):
    out = _act(activation, preout)
    return _apply_mask_and_mean(torch.abs(out - labels), mask, unit_weights)


@register("mape")
@register("mean_absolute_percentage_error")
def mape(labels, preout, activation="identity", mask=None,
         unit_weights=None):
    out = _act(activation, preout)
    return _apply_mask_and_mean(
        100.0 * torch.abs((out - labels) / (labels + _EPS)), mask,
        unit_weights)


@register("msle")
@register("mean_squared_logarithmic_error")
def msle(labels, preout, activation="identity", mask=None,
         unit_weights=None):
    out = _act(activation, preout)
    lo = -1 + _EPS
    per = (torch.log1p(torch.clamp(out, min=lo)) -
           torch.log1p(torch.clamp(labels, min=lo))) ** 2
    return _apply_mask_and_mean(per, mask, unit_weights)


@register("xent")
def xent(labels, preout, activation="sigmoid", mask=None,
         unit_weights=None):
    """Binary cross-entropy; the stable ``log(1 + exp(-|x|))`` form when
    the activation is sigmoid."""
    if isinstance(activation, str) and activation.lower() == "sigmoid":
        per = torch.clamp(preout, min=0) - preout * labels + \
            torch.log1p(torch.exp(-torch.abs(preout)))
    else:
        out = torch.clamp(_act(activation, preout), _EPS, 1 - _EPS)
        per = -(labels * torch.log(out) + (1 - labels) * torch.log(1 - out))
    return _apply_mask_and_mean(per, mask, unit_weights)


@register("mcxent")
@register("negativeloglikelihood")
def mcxent(labels, preout, activation="softmax", mask=None,
           unit_weights=None):
    """Multi-class cross-entropy; fused log-softmax when the activation
    is softmax."""
    if isinstance(activation, str) and activation.lower() == "softmax":
        per = -(labels * torch.log_softmax(preout, dim=-1))
    else:
        out = torch.clamp(activations.get(activation)(preout), _EPS, 1.0)
        per = -(labels * torch.log(out))
    return _apply_mask_and_mean(per, mask, unit_weights)


@register("sparse_mcxent")
def sparse_mcxent(labels, preout, activation="softmax", mask=None,
                  unit_weights=None):
    """``labels`` are integer class indices ``[batch, ...]``."""
    logp = torch.log_softmax(preout, dim=-1)
    per = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return _apply_mask_and_mean(per[..., None], mask, unit_weights)


def _signed(labels):
    """Labels as ±1 (the reference converts 0/1)."""
    return torch.where(labels > 0, 1.0, -1.0).to(labels.dtype)


@register("hinge")
def hinge(labels, preout, activation="identity", mask=None,
          unit_weights=None):
    out = _act(activation, preout)
    return _apply_mask_and_mean(
        torch.clamp(1.0 - _signed(labels) * out, min=0.0), mask,
        unit_weights)


@register("squared_hinge")
def squared_hinge(labels, preout, activation="identity", mask=None,
                  unit_weights=None):
    out = _act(activation, preout)
    return _apply_mask_and_mean(
        torch.clamp(1.0 - _signed(labels) * out, min=0.0) ** 2, mask,
        unit_weights)


@register("kl_divergence")
@register("kld")
def kld(labels, preout, activation="softmax", mask=None, unit_weights=None):
    out = torch.clamp(_act(activation, preout), _EPS, 1.0)
    lab = torch.clamp(labels, _EPS, 1.0)
    return _apply_mask_and_mean(lab * (torch.log(lab) - torch.log(out)),
                                mask, unit_weights)


@register("poisson")
def poisson(labels, preout, activation="identity", mask=None,
            unit_weights=None):
    out = _act(activation, preout)
    return _apply_mask_and_mean(
        out - labels * torch.log(torch.clamp(out, min=_EPS)), mask,
        unit_weights)


@register("cosine_proximity")
def cosine_proximity(labels, preout, activation="identity", mask=None,
                     unit_weights=None):
    out = _act(activation, preout)
    num = torch.sum(labels * out, dim=-1)
    den = torch.linalg.vector_norm(labels, dim=-1) * \
        torch.linalg.vector_norm(out, dim=-1) + _EPS
    return _apply_mask_and_mean((-num / den)[..., None], mask, unit_weights)


@register("wasserstein")
def wasserstein(labels, preout, activation="identity", mask=None,
                unit_weights=None):
    out = _act(activation, preout)
    return _apply_mask_and_mean(labels * out, mask, unit_weights)


@register("fmeasure")
def fmeasure(labels, preout, activation="sigmoid", mask=None,
             unit_weights=None):
    """Differentiable soft F1 loss (reference LossFMeasure, beta = 1)."""
    out = _act(activation, preout)
    tp = torch.sum(labels * out)
    fp = torch.sum((1 - labels) * out)
    fn = torch.sum(labels * (1 - out))
    gb = global_batch.current()
    if gb is not None:
        # the counts of the global batch; each rank's share of 1 - F1
        tp, fp, fn = (global_batch.all_reduce_grad(c) for c in (tp, fp, fn))
    f1 = (2 * tp) / torch.clamp(2 * tp + fp + fn, min=_EPS)
    return (1.0 - f1) if gb is None else (1.0 - f1) / gb.world
