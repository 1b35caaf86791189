"""Learning-rate schedules (port of ``nn/conf/schedules.py``): ``Fixed``,
``Step``, ``Exponential``, ``Inverse``, ``Poly``, ``Sigmoid``, ``Map``,
``Cycle`` and ``Warmup``, each serde-registered under the JAX package's
class name, and ``resolve``.

``value(iteration)`` is one Python float, computed on the host in
float64: the updater reads it once per step and label, with optax's
count (0-based, kept per updater label; step t uses ``value(t)``,
because optax's ``scale_by_learning_rate(schedule)`` reads its count
before it increments it).  The JAX package computes the same formula on
the device, in float64 under ``jax_enable_x64`` and in float32 without
it; both then round the value to the gradient's dtype.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict

from ...utils.serde import register_serde


@dataclass
class Schedule:
    def value(self, iteration, epoch=0) -> float:  # pragma: no cover
        raise NotImplementedError


@register_serde
@dataclass
class FixedSchedule(Schedule):
    value_: float = 0.001

    def value(self, iteration, epoch=0):
        return float(self.value_)


@register_serde
@dataclass
class StepSchedule(Schedule):
    """lr · decay_rate^floor(iter / step)."""
    initial_value: float = 0.001
    decay_rate: float = 0.1
    step: float = 1000.0

    def value(self, iteration, epoch=0):
        return self.initial_value * self.decay_rate ** math.floor(
            iteration / self.step)


@register_serde
@dataclass
class ExponentialSchedule(Schedule):
    initial_value: float = 0.001
    gamma: float = 0.99

    def value(self, iteration, epoch=0):
        return self.initial_value * self.gamma ** iteration


@register_serde
@dataclass
class InverseSchedule(Schedule):
    initial_value: float = 0.001
    gamma: float = 0.001
    power: float = 2.0

    def value(self, iteration, epoch=0):
        return self.initial_value / (1 + self.gamma * iteration) ** self.power


@register_serde
@dataclass
class PolySchedule(Schedule):
    initial_value: float = 0.001
    power: float = 2.0
    max_iter: int = 10000

    def value(self, iteration, epoch=0):
        frac = min(max(iteration / self.max_iter, 0.0), 1.0)
        return self.initial_value * (1 - frac) ** self.power


@register_serde
@dataclass
class SigmoidSchedule(Schedule):
    initial_value: float = 0.001
    gamma: float = 0.01
    step_size: int = 1000

    def value(self, iteration, epoch=0):
        return self.initial_value / (
            1 + math.exp(self.gamma * (iteration - self.step_size)))


@register_serde
@dataclass
class MapSchedule(Schedule):
    """Piecewise constant by iteration: ``{0: lr0, 1000: lr1, ...}``
    (keys may be str, as JSON has them)."""
    values: Dict[int, float] = field(default_factory=dict)

    def value(self, iteration, epoch=0):
        keys = sorted(int(k) for k in self.values)
        by_int = {int(k): v for k, v in self.values.items()}
        out = by_int[keys[0]] if keys else 0.0
        for k in keys:
            if iteration >= k:
                out = by_int[k]
        return float(out)


@register_serde
@dataclass
class CycleSchedule(Schedule):
    """Triangular cycle from ``initial_value`` up to ``max_value`` and
    back over ``cycle_length`` iterations."""
    initial_value: float = 1e-4
    max_value: float = 1e-2
    cycle_length: int = 1000
    annealing_cycles: int = 0
    annealing_decay: float = 0.1

    def value(self, iteration, epoch=0):
        pos = (iteration % self.cycle_length) / max(self.cycle_length - 1, 1)
        tri = pos * 2 if pos < 0.5 else (1 - pos) * 2
        return self.initial_value + (self.max_value - self.initial_value) * tri


@register_serde
@dataclass
class WarmupSchedule(Schedule):
    """Linear warmup to ``target`` over ``warmup_iters`` iterations."""
    warmup_iters: int = 100
    target: float = 1e-3

    def value(self, iteration, epoch=0):
        return self.target * min(max(iteration / max(self.warmup_iters, 1),
                                     0.0), 1.0)


def resolve(lr) -> Schedule:
    """Accept a float or a Schedule; return a Schedule."""
    if isinstance(lr, Schedule):
        return lr
    return FixedSchedule(float(lr))
