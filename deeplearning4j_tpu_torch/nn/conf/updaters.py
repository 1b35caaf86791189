"""Updater configurations, read-only (port of ``nn/conf/updaters.py``).

A configuration written by the JAX package names its updater; the port
reads it so the configuration loads.  The update arithmetic comes with
training.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ...utils.serde import register_serde


@dataclass
class UpdaterConf:
    learning_rate: Optional[float] = None


@register_serde
@dataclass
class Sgd(UpdaterConf):
    pass


@register_serde
@dataclass
class Adam(UpdaterConf):
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
