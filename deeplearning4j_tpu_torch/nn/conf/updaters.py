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
The values that depend on the count (``-lr`` and the bias corrections,
``scalars(count)``) are computed on the host in f64 and reach the
update as a small device tensor, so the update launches the same
kernels at every step (a captured CUDA graph replays them).
Per-parameter state (``slots``) lives in a dict of tensors that the
update writes in place (``mul_``, ``add_``, ``maximum(out=)``), in
optax's order of operations; the step count is kept by the caller.
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

    def scalars(self, count: int) -> Tuple[float, ...]:
        """The host values step ``count`` reads (``count`` = steps taken
        before), f64: ``-lr`` first, then the updater's bias
        corrections."""
        return (-float(self._lr(count)),)

    def init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {name: torch.full_like(p, self.SLOT_INIT.get(name, 0.0))
                for name in self.SLOTS}

    def update(self, g: torch.Tensor, slots: Dict[str, torch.Tensor],
               s: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """The update for gradient ``g`` of parameter ``p``; the tensors
        of ``slots`` are updated in place.  ``s`` holds ``scalars(count)``
        as a 1-D tensor in ``p``'s dtype on its device."""
        raise NotImplementedError  # pragma: no cover - abstract


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count``, computed in float64 on the host and rounded
    to the moment's dtype by the division, as optax computes it under
    ``jax_enable_x64``.  Without x64 optax rounds ``decay`` to float32
    first, and ``1 - 0.999f`` is then ~1.3e-5 relative off ``1 - 0.999``."""
    return 1.0 - decay ** count


def _moment_(m, g, decay):
    """optax ``update_moment`` (order 1), ``(1−decay)·g + decay·m``, into
    ``m``: the same two products and sum, in place."""
    return m.mul_(decay).add_((1 - decay) * g)


def _moment2_(m, g, decay):
    """optax ``update_moment_per_elem_norm`` (order 2) into ``m``."""
    return m.mul_(decay).add_((1 - decay) * (g * g))


@register_serde
@dataclass
class Sgd(UpdaterConf):
    DEFAULT_LR: ClassVar[float] = 1e-1

    def update(self, g, slots, s, p):
        return g * s[0]


@register_serde
@dataclass
class Nesterovs(UpdaterConf):
    momentum: float = 0.9

    SLOTS: ClassVar[Tuple[str, ...]] = ("trace",)
    DEFAULT_LR: ClassVar[float] = 1e-1

    def update(self, g, slots, s, p):
        m = self.momentum
        trace = slots["trace"].mul_(m).add_(g)
        return (g + m * trace) * s[0]


@register_serde
@dataclass
class Adam(UpdaterConf):
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    SLOTS: ClassVar[Tuple[str, ...]] = ("mu", "nu")

    def scalars(self, count):
        return (-float(self._lr(count)),
                _bias_correction(self.beta1, count + 1),
                _bias_correction(self.beta2, count + 1))

    def _scaled(self, g, slots, s):
        """``scale_by_adam``'s update (before the learning rate)."""
        mu = _moment_(slots["mu"], g, self.beta1)
        nu = _moment2_(slots["nu"], g, self.beta2)
        return (mu / s[1]) / (torch.sqrt(nu / s[2]) + self.epsilon)

    def update(self, g, slots, s, p):
        return self._scaled(g, slots, s) * s[0]


@register_serde
@dataclass
class AdaMax(UpdaterConf):
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    SLOTS: ClassVar[Tuple[str, ...]] = ("mu", "nu")

    def scalars(self, count):
        return (-float(self._lr(count)),
                _bias_correction(self.beta1, count + 1))

    def update(self, g, slots, s, p):
        mu = _moment_(slots["mu"], g, self.beta1)
        nu = slots["nu"].mul_(self.beta2)
        torch.maximum(torch.abs(g) + self.epsilon, nu, out=nu)
        return ((mu / s[1]) / nu) * s[0]


@register_serde
@dataclass
class Nadam(UpdaterConf):
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    SLOTS: ClassVar[Tuple[str, ...]] = ("mu", "nu")

    def scalars(self, count):
        return (-float(self._lr(count)),
                _bias_correction(self.beta1, count + 1),
                _bias_correction(self.beta2, count + 1),
                _bias_correction(self.beta1, count + 2))

    def update(self, g, slots, s, p):
        b1 = self.beta1
        mu = _moment_(slots["mu"], g, b1)
        nu = _moment2_(slots["nu"], g, self.beta2)
        mu_hat = b1 * (mu / s[3]) + (1 - b1) * (g / s[1])
        nu_hat = nu / s[2]
        return (mu_hat / (torch.sqrt(nu_hat) + self.epsilon)) * s[0]


@register_serde
@dataclass
class AmsGrad(UpdaterConf):
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    SLOTS: ClassVar[Tuple[str, ...]] = ("mu", "nu", "nu_max")

    def scalars(self, count):
        return (-float(self._lr(count)),
                _bias_correction(self.beta1, count + 1),
                _bias_correction(self.beta2, count + 1))

    def update(self, g, slots, s, p):
        mu = _moment_(slots["mu"], g, self.beta1)
        nu = _moment2_(slots["nu"], g, self.beta2)
        nu_max = slots["nu_max"]
        torch.maximum(nu_max, nu / s[2], out=nu_max)
        return ((mu / s[1]) / (torch.sqrt(nu_max) + self.epsilon)) * s[0]


@register_serde
@dataclass
class AdaDelta(UpdaterConf):
    rho: float = 0.95
    epsilon: float = 1e-6

    SLOTS: ClassVar[Tuple[str, ...]] = ("e_g", "e_x")
    DEFAULT_LR: ClassVar[float] = 1.0   # the reference's AdaDelta has none

    def update(self, g, slots, s, p):
        e_g = _moment2_(slots["e_g"], g, self.rho)
        e_x = slots["e_x"]
        u = (torch.sqrt(e_x + self.epsilon) /
             torch.sqrt(e_g + self.epsilon)) * g
        _moment2_(e_x, u, self.rho)
        return u * s[0]


@register_serde
@dataclass
class AdaGrad(UpdaterConf):
    epsilon: float = 1e-6

    SLOTS: ClassVar[Tuple[str, ...]] = ("sum_of_squares",)
    SLOT_INIT: ClassVar[Dict[str, float]] = {"sum_of_squares": 0.1}
    DEFAULT_LR: ClassVar[float] = 1e-1

    def update(self, g, slots, s, p):
        t = slots["sum_of_squares"].add_(g * g)
        inv = torch.where(t > 0, torch.rsqrt(t + self.epsilon),
                          torch.zeros((), dtype=t.dtype, device=t.device))
        return (inv * g) * s[0]


@register_serde
@dataclass
class RmsProp(UpdaterConf):
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    SLOTS: ClassVar[Tuple[str, ...]] = ("nu",)
    DEFAULT_LR: ClassVar[float] = 1e-1

    def update(self, g, slots, s, p):
        nu = _moment2_(slots["nu"], g, self.rms_decay)
        return (torch.rsqrt(nu + self.epsilon) * g) * s[0]


@register_serde
@dataclass
class NoOp(UpdaterConf):
    """Updater.NONE: gradients are not applied."""

    def scalars(self, count):
        return ()

    def update(self, g, slots, s, p):
        return torch.zeros_like(g)


@register_serde
@dataclass
class AdamW(Adam):
    """Adam with decoupled weight decay on every parameter."""
    weight_decay: float = 0.01

    def update(self, g, slots, s, p):
        return (self._scaled(g, slots, s) + self.weight_decay * p) * s[0]


@register_serde
@dataclass
class Lion(UpdaterConf):
    beta1: float = 0.9
    beta2: float = 0.99
    weight_decay: float = 0.0

    SLOTS: ClassVar[Tuple[str, ...]] = ("mu",)
    DEFAULT_LR: ClassVar[float] = 1e-4

    def update(self, g, slots, s, p):
        mu = slots["mu"]
        # the sign reads the old moment; the moment moves after it
        u = torch.sign((1 - self.beta1) * g + self.beta1 * mu)
        _moment_(mu, g, self.beta2)
        return (u + self.weight_decay * p) * s[0]


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
