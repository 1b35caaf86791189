"""Sampling distributions for ``WeightInit.DISTRIBUTION`` and
``WeightNoise`` (port of ``nn/conf/distribution.py``): ``Normal``,
``Uniform``, ``Binomial``, ``LogNormal``, ``TruncatedNormal``,
``Orthogonal`` and ``Constant``, serde-registered, with
``to_dict``/``from_dict``.

``sample(key, shape)`` draws from the JAX package's threefry stream
(``utils/_random``) on the key's device, in float32, as the JAX package
does with x64 off: the uniform, Bernoulli (``Binomial``) and constant
draws are bit-equal to it; the normal-based ones agree within float32
rounding (their last step is ``erfinv``/``exp``).  ``TruncatedNormal``
follows ``jax.random.truncated_normal(key, -2, 2)``: a uniform between
``erf(±2/√2)``, then ``√2·erfinv``, then a clip into the open interval.
``Orthogonal`` takes the QR of a normal draw and fixes the signs by
``sign(diag(r))``; the factor is then unique, so it matches JAX within
rounding.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Type

import torch

from ...utils import _random
from ...utils.serde import register_serde

_DIST_REGISTRY: Dict[str, Type["Distribution"]] = {}
_F32 = torch.float32


def register_distribution(cls):
    _DIST_REGISTRY[cls.__name__] = cls
    return register_serde(cls)


@dataclass
class Distribution:
    def sample(self, key: torch.Tensor, shape) -> torch.Tensor:
        raise NotImplementedError  # pragma: no cover - abstract

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["@dist"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d):
        d = dict(d)
        cls = _DIST_REGISTRY[d.pop("@dist")]
        return cls(**d)


@register_distribution
@dataclass
class NormalDistribution(Distribution):
    mean: float = 0.0
    std: float = 1.0

    def sample(self, key, shape):
        return self.mean + self.std * _random.normal(key, tuple(shape))


@register_distribution
@dataclass
class UniformDistribution(Distribution):
    lower: float = -1.0
    upper: float = 1.0

    def sample(self, key, shape):
        return _random.uniform(key, tuple(shape), self.lower, self.upper)


@register_distribution
@dataclass
class BinomialDistribution(Distribution):
    trials: int = 1
    prob: float = 0.5

    def sample(self, key, shape):
        draws = _random.bernoulli(key, self.prob,
                                  (self.trials,) + tuple(shape))
        return draws.to(_F32).sum(dim=0)


@register_distribution
@dataclass
class LogNormalDistribution(Distribution):
    mean: float = 0.0
    std: float = 1.0

    def sample(self, key, shape):
        return torch.exp(self.mean + self.std *
                         _random.normal(key, tuple(shape)))


def truncated_normal(key: torch.Tensor, lower: float, upper: float, shape
                     ) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape)`` in
    float32."""
    f32 = dict(dtype=_F32, device=key.device)
    sqrt2 = torch.tensor(math.sqrt(2.0), **f32)
    lo, hi = torch.tensor(lower, **f32), torch.tensor(upper, **f32)
    a = float(torch.erf(lo / sqrt2))
    b = float(torch.erf(hi / sqrt2))
    u = _random.uniform(key, tuple(shape), a, b)
    out = sqrt2 * torch.erfinv(u)
    inf = torch.tensor(math.inf, **f32)
    return torch.clamp(out, torch.nextafter(lo, inf),
                       torch.nextafter(hi, -inf))


@register_distribution
@dataclass
class TruncatedNormalDistribution(Distribution):
    mean: float = 0.0
    std: float = 1.0

    def sample(self, key, shape):
        return self.mean + self.std * truncated_normal(key, -2.0, 2.0, shape)


@register_distribution
@dataclass
class OrthogonalDistribution(Distribution):
    gain: float = 1.0

    def sample(self, key, shape):
        shape = tuple(shape)
        if len(shape) < 2:
            raise ValueError("orthogonal requires >=2d shape")
        rows, cols = shape[0], math.prod(shape[1:])
        a = _random.normal(key, (max(rows, cols), min(rows, cols)))
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return self.gain * q[:rows, :cols].reshape(shape)


@register_distribution
@dataclass
class ConstantDistribution(Distribution):
    value: float = 0.0

    def sample(self, key, shape):
        return torch.full(tuple(shape), float(self.value), dtype=_F32,
                          device=key.device)
