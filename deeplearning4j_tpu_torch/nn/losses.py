"""Loss functions (port of the part of ``nn/losses.py`` that the ported
output heads use).

Each loss is ``fn(labels, preout, activation, mask, unit_weights) ->
scalar``: the mean over examples of the per-example score, summed over
output units, from the *pre-activation* output, so that softmax
cross-entropy runs as a fused log-softmax.  Reductions run in at least
float32.  Ported: ``mcxent`` (alias ``negativeloglikelihood``) and
``sparse_mcxent``; every other name the reference knows raises "not
ported yet".
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch

from . import activations

_EPS = 1e-7

_REGISTRY: Dict[str, Callable] = {}

# The reference's other losses: known names that this port does not run.
_UNPORTED = ("mse", "squared_loss", "l2", "mae", "l1", "mape",
             "mean_absolute_percentage_error", "msle",
             "mean_squared_logarithmic_error", "xent", "hinge",
             "squared_hinge", "kl_divergence", "kld", "poisson",
             "cosine_proximity", "wasserstein", "fmeasure")

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
    key = name.lower()
    if key in _REGISTRY:
        return _REGISTRY[key]
    if key in _UNPORTED:
        raise NotImplementedError(
            f"loss '{name}' is not ported yet; ported: {names()}")
    raise ValueError(f"Unknown loss '{name}'. Available: "
                     f"{sorted(set(names()) | set(_UNPORTED))}")


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
        denom = torch.clamp(m.sum(), min=1.0)
        return per_example.sum() / denom
    per_example = per_unit.reshape(per_unit.shape[0], -1).sum(dim=1)
    return per_example.mean()


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
