"""Updater configurations and their update arithmetic (port of
``nn/conf/updaters.py``).

The JAX package resolves each updater to an optax transform.  Here each
one writes optax 0.2.6's arithmetic out by hand, in optax's order of
operations (``torch.optim`` orders several of them differently), and
returns the update ``u`` that the caller adds to the parameter:

- ``Sgd``: ``u = −lr·g``;
- ``Nesterovs`` (``trace``, nesterov): ``t = g + m·t``;
  ``u = −lr·(g + m·t)``;
- ``Adam`` (``scale_by_adam``): ``mu = (1−b1)·g + b1·mu``,
  ``nu = (1−b2)·g² + b2·nu``, both bias-corrected with ``count+1``,
  ``u = −lr·mu_hat/(sqrt(nu_hat) + eps)``;
- ``Nadam``: ``scale_by_adam(nesterov=True)``: the numerator is
  ``b1·mu/(1−b1^(count+2)) + (1−b1)·g/(1−b1^(count+1))``;
- ``AmsGrad``: the running max of the *bias-corrected* ``nu_hat`` (torch
  takes it of the raw ``nu``);
- ``AdaMax``: ``nu = max(|g| + eps, b2·nu)``, ``u = −lr·mu_hat/nu``;
- ``AdaDelta``: ``u = sqrt(e_x + eps)/sqrt(e_g + eps)·g`` with ``e_g``
  updated first and ``e_x`` after, from ``u``; lr defaults to 1;
- ``AdaGrad`` (``scale_by_rss``): the accumulator starts at 0.1;
  ``u = −lr·where(t > 0, rsqrt(t + eps), 0)·g``;
- ``RmsProp`` (``scale_by_rms``): nu starts at 0, eps inside the root:
  ``u = −lr·rsqrt(nu + eps)·g``;
- ``NoOp`` (``set_to_zero``): ``u = 0``;
- ``AdamW``: Adam's update plus ``weight_decay·p`` on every parameter
  (no mask: biases and BatchNorm gamma/beta too), then ``−lr``;
- ``Lion``: ``u = sign((1−b1)·g + b1·mu)`` from the old moment, then
  ``mu = (1−b2)·g + b2·mu``; plus ``weight_decay·p``, then ``−lr``.

The learning rate is a float or a ``Schedule``; ``_lr(count)`` is its
value at the label's step count (0-based, as optax's), a host float.
Per-parameter state (``slots``) lives in a dict of tensors; the step
count is kept by the caller.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Dict, Tuple, Union

import torch

from ...utils.serde import register_serde
from .schedules import Schedule, resolve


@dataclass
class UpdaterConf:
    """Base: the learning rate is a float or a Schedule."""
    learning_rate: Union[float, Schedule, None] = None

    SLOTS: ClassVar[Tuple[str, ...]] = ()
    # a slot's initial value where it is not 0
    SLOT_INIT: ClassVar[Dict[str, float]] = {}
    DEFAULT_LR: ClassVar[float] = 1e-3

    def _lr(self, count: int) -> float:
        """The learning rate of step ``count`` (0-based, per label)."""
        if self.learning_rate is None:
            return self.DEFAULT_LR
        return resolve(self.learning_rate).value(count)

    def init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {name: torch.full_like(p, self.SLOT_INIT.get(name, 0.0))
                for name in self.SLOTS}

    def update(self, g: torch.Tensor, slots: Dict[str, torch.Tensor],
               count: int, p: torch.Tensor) -> torch.Tensor:
        """The update for gradient ``g`` of parameter ``p``; ``slots`` are
        replaced in place in the dict; ``count`` is the number of steps
        taken before."""
        raise NotImplementedError  # pragma: no cover - abstract


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count``, computed in float64 on the host and rounded
    to the moment's dtype by the division, as optax computes it under
    ``jax_enable_x64``.  Without x64 optax rounds ``decay`` to float32
    first, and ``1 - 0.999f`` is then ~1.3e-5 relative off ``1 - 0.999``."""
    return 1.0 - decay ** count


def _moment(g, m, decay):
    """optax ``update_moment`` (order 1): ``(1−decay)·g + decay·m``."""
    return (1 - decay) * g + decay * m


def _moment2(g, m, decay):
    """optax ``update_moment_per_elem_norm`` (order 2)."""
    return (1 - decay) * (g * g) + decay * m


@register_serde
@dataclass
class Sgd(UpdaterConf):
    DEFAULT_LR: ClassVar[float] = 1e-1

    def update(self, g, slots, count, p):
        return -self._lr(count) * g


@register_serde
@dataclass
class Nesterovs(UpdaterConf):
    momentum: float = 0.9

    SLOTS: ClassVar[Tuple[str, ...]] = ("trace",)
    DEFAULT_LR: ClassVar[float] = 1e-1

    def update(self, g, slots, count, p):
        m = self.momentum
        trace = g + m * slots["trace"]
        slots["trace"] = trace
        return -self._lr(count) * (g + m * trace)


@register_serde
@dataclass
class Adam(UpdaterConf):
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    SLOTS: ClassVar[Tuple[str, ...]] = ("mu", "nu")

    def _scaled(self, g, slots, count):
        """``scale_by_adam``'s update (before the learning rate)."""
        b1, b2 = self.beta1, self.beta2
        mu = _moment(g, slots["mu"], b1)
        nu = _moment2(g, slots["nu"], b2)
        slots["mu"], slots["nu"] = mu, nu
        mu_hat = mu / _bias_correction(b1, count + 1)
        nu_hat = nu / _bias_correction(b2, count + 1)
        return mu_hat / (torch.sqrt(nu_hat) + self.epsilon)

    def update(self, g, slots, count, p):
        return -self._lr(count) * self._scaled(g, slots, count)


@register_serde
@dataclass
class AdaMax(UpdaterConf):
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    SLOTS: ClassVar[Tuple[str, ...]] = ("mu", "nu")

    def update(self, g, slots, count, p):
        mu = _moment(g, slots["mu"], self.beta1)
        nu = torch.maximum(torch.abs(g) + self.epsilon,
                           self.beta2 * slots["nu"])
        slots["mu"], slots["nu"] = mu, nu
        mu_hat = mu / _bias_correction(self.beta1, count + 1)
        return -self._lr(count) * (mu_hat / nu)


@register_serde
@dataclass
class Nadam(UpdaterConf):
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    SLOTS: ClassVar[Tuple[str, ...]] = ("mu", "nu")

    def update(self, g, slots, count, p):
        b1, b2 = self.beta1, self.beta2
        mu = _moment(g, slots["mu"], b1)
        nu = _moment2(g, slots["nu"], b2)
        slots["mu"], slots["nu"] = mu, nu
        mu_hat = b1 * (mu / _bias_correction(b1, count + 2)) + \
            (1 - b1) * (g / _bias_correction(b1, count + 1))
        nu_hat = nu / _bias_correction(b2, count + 1)
        return -self._lr(count) * (mu_hat / (torch.sqrt(nu_hat) +
                                             self.epsilon))


@register_serde
@dataclass
class AmsGrad(UpdaterConf):
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    SLOTS: ClassVar[Tuple[str, ...]] = ("mu", "nu", "nu_max")

    def update(self, g, slots, count, p):
        b1, b2 = self.beta1, self.beta2
        mu = _moment(g, slots["mu"], b1)
        nu = _moment2(g, slots["nu"], b2)
        mu_hat = mu / _bias_correction(b1, count + 1)
        nu_hat = nu / _bias_correction(b2, count + 1)
        nu_max = torch.maximum(slots["nu_max"], nu_hat)
        slots["mu"], slots["nu"], slots["nu_max"] = mu, nu, nu_max
        return -self._lr(count) * (mu_hat / (torch.sqrt(nu_max) +
                                             self.epsilon))


@register_serde
@dataclass
class AdaDelta(UpdaterConf):
    rho: float = 0.95
    epsilon: float = 1e-6

    SLOTS: ClassVar[Tuple[str, ...]] = ("e_g", "e_x")
    DEFAULT_LR: ClassVar[float] = 1.0   # the reference's AdaDelta has none

    def update(self, g, slots, count, p):
        e_g = _moment2(g, slots["e_g"], self.rho)
        u = (torch.sqrt(slots["e_x"] + self.epsilon) /
             torch.sqrt(e_g + self.epsilon)) * g
        slots["e_g"] = e_g
        slots["e_x"] = _moment2(u, slots["e_x"], self.rho)
        return -self._lr(count) * u


@register_serde
@dataclass
class AdaGrad(UpdaterConf):
    epsilon: float = 1e-6

    SLOTS: ClassVar[Tuple[str, ...]] = ("sum_of_squares",)
    SLOT_INIT: ClassVar[Dict[str, float]] = {"sum_of_squares": 0.1}
    DEFAULT_LR: ClassVar[float] = 1e-1

    def update(self, g, slots, count, p):
        t = g * g + slots["sum_of_squares"]
        slots["sum_of_squares"] = t
        inv = torch.where(t > 0, torch.rsqrt(t + self.epsilon),
                          torch.zeros((), dtype=t.dtype, device=t.device))
        return -self._lr(count) * (inv * g)


@register_serde
@dataclass
class RmsProp(UpdaterConf):
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    SLOTS: ClassVar[Tuple[str, ...]] = ("nu",)
    DEFAULT_LR: ClassVar[float] = 1e-1

    def update(self, g, slots, count, p):
        nu = _moment2(g, slots["nu"], self.rms_decay)
        slots["nu"] = nu
        return -self._lr(count) * (torch.rsqrt(nu + self.epsilon) * g)


@register_serde
@dataclass
class NoOp(UpdaterConf):
    """Updater.NONE: gradients are not applied."""

    def update(self, g, slots, count, p):
        return torch.zeros_like(g)


@register_serde
@dataclass
class AdamW(Adam):
    """Adam with decoupled weight decay on every parameter."""
    weight_decay: float = 0.01

    def update(self, g, slots, count, p):
        u = self._scaled(g, slots, count) + self.weight_decay * p
        return -self._lr(count) * u


@register_serde
@dataclass
class Lion(UpdaterConf):
    beta1: float = 0.9
    beta2: float = 0.99
    weight_decay: float = 0.0

    SLOTS: ClassVar[Tuple[str, ...]] = ("mu",)
    DEFAULT_LR: ClassVar[float] = 1e-4

    def update(self, g, slots, count, p):
        u = torch.sign(_moment(g, slots["mu"], self.beta1))
        slots["mu"] = _moment(g, slots["mu"], self.beta2)
        return -self._lr(count) * (u + self.weight_decay * p)


_BY_NAME = {
    "sgd": Sgd, "adam": Adam, "adamax": AdaMax, "adadelta": AdaDelta,
    "nesterovs": Nesterovs, "nadam": Nadam, "adagrad": AdaGrad,
    "rmsprop": RmsProp, "none": NoOp, "amsgrad": AmsGrad,
    "adamw": AdamW, "lion": Lion,
}


def by_name(name: str, learning_rate=None, **kwargs) -> UpdaterConf:
    """Resolve a DL4J Updater enum name to a config instance."""
    cls = _BY_NAME.get(name.lower())
    if cls is None:
        raise ValueError(f"unknown updater '{name}'; available: "
                         f"{sorted(_BY_NAME)}")
    return cls(learning_rate=learning_rate, **kwargs)
