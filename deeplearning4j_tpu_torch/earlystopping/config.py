"""EarlyStoppingConfiguration (reference
``earlystopping/EarlyStoppingConfiguration.java`` Builder).  Copy of the JAX
package's module for the PyTorch port."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

from .savers import InMemoryModelSaver


@dataclass
class EarlyStoppingConfiguration:
    score_calculator: Any = None
    model_saver: Any = field(default_factory=InMemoryModelSaver)
    epoch_terminations: List[Any] = field(default_factory=list)
    iteration_terminations: List[Any] = field(default_factory=list)
    save_last_model: bool = False
    evaluate_every_n_epochs: int = 1

    class Builder:
        def __init__(self):
            self._conf = EarlyStoppingConfiguration()

        def score_calculator(self, sc):
            self._conf.score_calculator = sc
            return self

        def model_saver(self, saver):
            self._conf.model_saver = saver
            return self

        def epoch_termination_conditions(self, *conds):
            self._conf.epoch_terminations = list(conds)
            return self

        def iteration_termination_conditions(self, *conds):
            self._conf.iteration_terminations = list(conds)
            return self

        def save_last_model(self, b: bool = True):
            self._conf.save_last_model = bool(b)
            return self

        def evaluate_every_n_epochs(self, n: int):
            self._conf.evaluate_every_n_epochs = int(n)
            return self

        def build(self):
            return self._conf

    @staticmethod
    def builder() -> "EarlyStoppingConfiguration.Builder":
        return EarlyStoppingConfiguration.Builder()
