"""Reconstruction distributions for the variational autoencoder (port of
``nn/conf/variational.py``).

Reference ``nn/conf/layers/variational/``: Bernoulli, Gaussian,
Exponential, Composite and ``LossFunctionWrapper``.  Each maps a slice of
the decoder pre-output to p(x|z): ``dist_params_size`` says how many
pre-output units a data dimension needs, ``neg_log_prob`` scores data
under the distribution, ``mean`` and ``sample`` generate.  ``sample``
draws from the JAX package's threefry stream (``utils/_random``) on the
key's device.  The clips are ``jnp.clip``'s ``minimum(maximum(x, lo),
hi)`` (``activations._clip``), so a value on a bound takes half the
gradient, as in JAX.  ``neg_log_prob(..., per_example=True)`` gives one
value per row in one batched computation (the JAX package takes it by
``vmap`` over rows; the loss wrapper's takes it by ``torch.vmap``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, List

import torch

from ...utils import _random
from ...utils.serde import register_serde
from .. import activations as _act
from .. import losses as _losses

_EPS = 1e-7


def _reduce(ll: torch.Tensor, average: bool, per_example: bool
            ) -> torch.Tensor:
    """Negative log-likelihood of per-unit ``ll``: per row, or its mean
    (``average``) or sum over the rows."""
    per_ex = -torch.sum(ll, dim=-1)
    if per_example:
        return per_ex
    return torch.mean(per_ex) if average else torch.sum(per_ex)


@dataclass
class ReconstructionDistribution:
    def dist_params_size(self, data_size: int) -> int:
        return data_size

    def neg_log_prob(self, x, preout, average: bool = True,
                     per_example: bool = False) -> torch.Tensor:
        raise NotImplementedError

    def mean(self, preout) -> torch.Tensor:
        raise NotImplementedError

    def sample(self, key, preout) -> torch.Tensor:
        raise NotImplementedError

    def has_loss_function(self) -> bool:
        return False


@register_serde
@dataclass
class BernoulliReconstructionDistribution(ReconstructionDistribution):
    """p(x|z) = Bernoulli(sigmoid(preout))."""
    activation: str = "sigmoid"

    def neg_log_prob(self, x, preout, average=True, per_example=False):
        p = _act._clip(_act.get(self.activation)(preout), _EPS, 1 - _EPS)
        ll = x * torch.log(p) + (1 - x) * torch.log(1 - p)
        return _reduce(ll, average, per_example)

    def mean(self, preout):
        return _act.get(self.activation)(preout)

    def sample(self, key, preout):
        return _random.bernoulli(key, self.mean(preout)).to(preout.dtype)


@register_serde
@dataclass
class GaussianReconstructionDistribution(ReconstructionDistribution):
    """p(x|z) = N(mu, sigma^2); the pre-output packs [mu, log sigma^2]
    (2 params per dimension)."""
    activation: str = "identity"

    def dist_params_size(self, data_size: int) -> int:
        return 2 * data_size

    def _split(self, preout):
        n = preout.shape[-1] // 2
        return _act.get(self.activation)(preout[..., :n]), preout[..., n:]

    def neg_log_prob(self, x, preout, average=True, per_example=False):
        mu, log_var = self._split(preout)
        log_var = _act._clip(log_var, -20.0, 20.0)
        ll = -0.5 * (math.log(2 * math.pi) + log_var
                     + (x - mu) ** 2 / torch.exp(log_var))
        return _reduce(ll, average, per_example)

    def mean(self, preout):
        return self._split(preout)[0]

    def sample(self, key, preout):
        mu, log_var = self._split(preout)
        std = torch.exp(0.5 * _act._clip(log_var, -20.0, 20.0))
        return mu + std * _random.normal(key, tuple(mu.shape), mu.dtype)


@register_serde
@dataclass
class ExponentialReconstructionDistribution(ReconstructionDistribution):
    """p(x|z) = Exp(lambda = exp(gamma)), gamma = act(preout)."""
    activation: str = "identity"

    def neg_log_prob(self, x, preout, average=True, per_example=False):
        gamma = _act._clip(_act.get(self.activation)(preout), -20.0, 20.0)
        ll = gamma - torch.exp(gamma) * x
        return _reduce(ll, average, per_example)

    def mean(self, preout):
        return torch.exp(-_act._clip(_act.get(self.activation)(preout),
                                     -20.0, 20.0))

    def sample(self, key, preout):
        u = _random.uniform(key, tuple(preout.shape), _EPS, 1.0,
                            dtype=preout.dtype)
        return -torch.log(u) * self.mean(preout)


@register_serde
@dataclass
class CompositeReconstructionDistribution(ReconstructionDistribution):
    """Different distributions over slices of the data vector.
    ``components`` is a list of ``[data_size, distribution]``."""
    components: List[Any] = field(default_factory=list)

    def add(self, data_size: int, dist
            ) -> "CompositeReconstructionDistribution":
        self.components.append([int(data_size), dist])
        return self

    def dist_params_size(self, data_size: int) -> int:
        total_data = sum(c[0] for c in self.components)
        if data_size != total_data:
            raise ValueError(
                f"composite covers {total_data} dims, data has {data_size}")
        return sum(c[1].dist_params_size(c[0]) for c in self.components)

    def _slices(self):
        xi = pi = 0
        for size, dist in self.components:
            psize = dist.dist_params_size(size)
            yield (xi, xi + size), (pi, pi + psize), dist
            xi += size
            pi += psize

    def neg_log_prob(self, x, preout, average=True, per_example=False):
        total = None
        for (x0, x1), (p0, p1), dist in self._slices():
            v = dist.neg_log_prob(x[..., x0:x1], preout[..., p0:p1],
                                  average, per_example)
            total = v if total is None else total + v
        return total

    def mean(self, preout):
        return torch.cat([d.mean(preout[..., p0:p1])
                          for _, (p0, p1), d in self._slices()], dim=-1)

    def sample(self, key, preout):
        return torch.cat([d.sample(_random.fold_in(key, i),
                                   preout[..., p0:p1])
                          for i, (_, (p0, p1), d)
                          in enumerate(self._slices())], dim=-1)


@register_serde
@dataclass
class LossFunctionWrapper(ReconstructionDistribution):
    """A plain loss as a pseudo-distribution (turns the VAE into a
    standard deep autoencoder)."""
    loss: str = "mse"
    activation: str = "identity"

    def has_loss_function(self) -> bool:
        return True

    def neg_log_prob(self, x, preout, average=True, per_example=False):
        fn = _losses.get(self.loss)
        if per_example:
            # each row's loss alone, as the JAX package's vmap over rows
            return torch.vmap(lambda xi, pi: fn(
                xi[None], pi[None], self.activation, None))(x, preout)
        val = fn(x, preout, self.activation, None)
        return val if average else val * x.shape[0]

    def mean(self, preout):
        return _act.get(self.activation)(preout)

    def sample(self, key, preout):
        return self.mean(preout)

