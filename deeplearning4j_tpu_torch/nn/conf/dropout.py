"""Dropout and weight-noise configurations (port of
``nn/conf/dropout.py``): ``Dropout``, ``GaussianDropout``,
``GaussianNoise``, ``AlphaDropout`` and ``resolve`` on activations;
``DropConnect`` and ``WeightNoise`` on parameters.

Each ``apply(key, x)`` draws from the JAX package's threefry stream
(``utils/_random``) on the key's device, so for one key the port keeps
or drops the same units as the JAX package does with x64 off: the
Bernoulli masks of ``Dropout`` and ``AlphaDropout`` are bit-equal, and
``Dropout`` divides by p (``x / p``, not ``x * (1/p)``) so its kept
values are too.  ``GaussianDropout`` and ``GaussianNoise`` go through
``erfinv`` and agree within float32 rounding.  Training only: the layers
call ``apply`` when ``train`` and a key are given.  Weight noise
(``apply(key, param)``) runs in the layers' ``maybe_noise_weights``
(``nn/layers/base``), which hands param i of the sorted names the key
``fold_in(layer key, i)``; ``DropConnect``'s mask is bit-equal to the
JAX package's, ``WeightNoise`` agrees within its distribution's
rounding.  Inside a data-parallel step the activation draws are the
global batch's rows (``utils/global_batch.rows``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ...utils import _random, global_batch
from ...utils.serde import register_serde
from .distribution import Distribution, NormalDistribution


@dataclass
class IDropout:
    def apply(self, key: torch.Tensor, x: torch.Tensor, iteration: int = 0
              ) -> torch.Tensor:  # pragma: no cover - abstract
        raise NotImplementedError


@register_serde
@dataclass
class Dropout(IDropout):
    """Inverted dropout with retain probability p (reference
    Dropout.java)."""
    p: float = 0.5  # probability of *retaining* a unit, as in DL4J

    def apply(self, key, x, iteration=0):
        keep = global_batch.rows(
            lambda s: _random.bernoulli(key, self.p, s), x.shape)
        return torch.where(keep, x / self.p, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))


@register_serde
@dataclass
class GaussianDropout(IDropout):
    rate: float = 0.5

    def apply(self, key, x, iteration=0):
        std = (self.rate / (1.0 - self.rate)) ** 0.5
        noise = global_batch.rows(lambda s: _random.normal(key, s), x.shape)
        return x * (1.0 + std * noise.to(x.dtype))


@register_serde
@dataclass
class GaussianNoise(IDropout):
    stddev: float = 0.1

    def apply(self, key, x, iteration=0):
        noise = global_batch.rows(lambda s: _random.normal(key, s), x.shape)
        return x + self.stddev * noise.to(x.dtype)


@register_serde
@dataclass
class AlphaDropout(IDropout):
    """SELU-compatible dropout (reference AlphaDropout.java)."""
    p: float = 0.95
    alpha: float = -1.7580993408473766  # -alpha*lambda of SELU

    def apply(self, key, x, iteration=0):
        p = self.p
        a = (p + self.alpha ** 2 * p * (1 - p)) ** -0.5
        b = -a * (1 - p) * self.alpha
        keep = global_batch.rows(lambda s: _random.bernoulli(key, p, s),
                                 x.shape)
        return a * torch.where(keep, x, torch.full((), self.alpha,
                                                   dtype=x.dtype,
                                                   device=x.device)) + b


def resolve(d) -> Optional[IDropout]:
    """Accept None, a float retain probability (DL4J style) or an
    ``IDropout``; a float outside (0, 1) is off."""
    if d is None:
        return None
    if isinstance(d, IDropout):
        return d
    p = float(d)
    if p <= 0.0 or p >= 1.0:
        return None
    return Dropout(p)


# ---- weight noise (applied to params, not activations) ----------------------

@dataclass
class IWeightNoise:
    def apply(self, key: torch.Tensor, param: torch.Tensor,
              iteration: int = 0) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError


@register_serde
@dataclass
class DropConnect(IWeightNoise):
    """Randomly zero weights during training (reference DropConnect.java);
    kept weights are divided by the retain probability ``p``."""
    p: float = 0.5  # retain probability

    def apply(self, key, param, iteration=0):
        keep = _random.bernoulli(key, self.p, param.shape)
        return torch.where(keep, param / self.p,
                           torch.zeros((), dtype=param.dtype,
                                       device=param.device))


@register_serde
@dataclass
class WeightNoise(IWeightNoise):
    """Additive or multiplicative noise from a distribution (N(0, 0.01)
    when unset)."""
    distribution: Optional[Distribution] = None
    additive: bool = True

    def apply(self, key, param, iteration=0):
        dist = self.distribution or NormalDistribution(0.0, 0.01)
        noise = dist.sample(key, param.shape).to(param.dtype)
        return param + noise if self.additive else param * noise
