"""Learning-rate schedules (port of the part of ``nn/conf/schedules.py``
that the updaters read): ``FixedSchedule`` and ``resolve``.  A
configuration naming any other schedule raises when it is read."""
from __future__ import annotations

from dataclasses import dataclass

from ...utils.serde import register_serde


@dataclass
class Schedule:
    def value(self, iteration, epoch=0):  # pragma: no cover - abstract
        raise NotImplementedError


@register_serde
@dataclass
class FixedSchedule(Schedule):
    value_: float = 0.001

    def value(self, iteration, epoch=0):
        return self.value_


def resolve(lr) -> Schedule:
    """Accept a float or a Schedule; return a Schedule."""
    if isinstance(lr, Schedule):
        return lr
    return FixedSchedule(float(lr))
