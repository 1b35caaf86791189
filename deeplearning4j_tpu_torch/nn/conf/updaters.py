"""Updater configurations and their update arithmetic (port of
``nn/conf/updaters.py``).

The JAX package resolves each updater to an optax transform.  Here each
ported updater writes optax's arithmetic out by hand, in optax's order of
operations (``torch.optim`` orders them differently):

- ``Sgd``: ``u = -lr·g``;
- ``Nesterovs`` (optax ``trace``, nesterov): ``t = g + m·t``;
  ``u = -lr·(g + m·t)``;
- ``Adam`` (optax ``scale_by_adam``): ``mu = (1−b1)·g + b1·mu``,
  ``nu = (1−b2)·g² + b2·nu``, both bias-corrected with ``count+1``,
  ``u = −lr·mu_hat/(sqrt(nu_hat) + eps)``.

Each returns the update ``u`` that the caller adds to the parameter.
Per-parameter state (``slots``) lives in a dict of tensors; the step
count is kept by the caller.  The reference's other updaters are not
registered: a configuration naming one raises "not ported" when read.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Dict, Tuple, Union

import torch

from ...utils.serde import register_serde
from .schedules import FixedSchedule, Schedule, resolve


@dataclass
class UpdaterConf:
    """Base: the learning rate is a float or a Schedule."""
    learning_rate: Union[float, Schedule, None] = None

    SLOTS: ClassVar[Tuple[str, ...]] = ()
    DEFAULT_LR: ClassVar[float] = 1e-3

    def _lr(self) -> float:
        if self.learning_rate is None:
            return self.DEFAULT_LR
        sched = resolve(self.learning_rate)
        if isinstance(sched, FixedSchedule):
            return sched.value_
        raise NotImplementedError(
            f"{type(self).__name__}: learning-rate schedule "
            f"{type(sched).__name__} is not ported yet; ported: "
            "['FixedSchedule']")

    def init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {name: torch.zeros_like(p) for name in self.SLOTS}

    def update(self, g: torch.Tensor, slots: Dict[str, torch.Tensor],
               count: int) -> torch.Tensor:
        """The update for gradient ``g``; ``slots`` are replaced in place
        in the dict; ``count`` is the number of steps taken before."""
        raise NotImplementedError(
            f"updater {type(self).__name__} is not ported yet")


@register_serde
@dataclass
class Sgd(UpdaterConf):
    DEFAULT_LR: ClassVar[float] = 1e-1

    def update(self, g, slots, count):
        return -self._lr() * g


@register_serde
@dataclass
class Nesterovs(UpdaterConf):
    momentum: float = 0.9

    SLOTS: ClassVar[Tuple[str, ...]] = ("trace",)
    DEFAULT_LR: ClassVar[float] = 1e-1

    def update(self, g, slots, count):
        m = self.momentum
        trace = g + m * slots["trace"]
        slots["trace"] = trace
        return -self._lr() * (g + m * trace)


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count``, computed in float64 on the host and rounded
    to the moment's dtype by the division, as optax computes it under
    ``jax_enable_x64``.  Without x64 optax rounds ``decay`` to float32
    first, and ``1 - 0.999f`` is then ~1.3e-5 relative off ``1 - 0.999``."""
    return 1.0 - decay ** count


@register_serde
@dataclass
class Adam(UpdaterConf):
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    SLOTS: ClassVar[Tuple[str, ...]] = ("mu", "nu")

    def update(self, g, slots, count):
        b1, b2 = self.beta1, self.beta2
        mu = (1 - b1) * g + b1 * slots["mu"]
        nu = (1 - b2) * (g * g) + b2 * slots["nu"]
        slots["mu"], slots["nu"] = mu, nu
        mu_hat = mu / _bias_correction(b1, count + 1)
        nu_hat = nu / _bias_correction(b2, count + 1)
        return -self._lr() * (mu_hat / (torch.sqrt(nu_hat) + self.epsilon))
