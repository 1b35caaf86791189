"""Termination conditions (reference ``earlystopping/termination/`` — both
epoch-level and iteration-level families).  Copy of the JAX
package's module for the PyTorch port."""
from __future__ import annotations

import math
import time


class EpochTerminationCondition:
    def initialize(self) -> None:
        pass

    def terminate(self, epoch: int, score: float, minimize: bool) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def initialize(self) -> None:
        pass

    def terminate(self, last_score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = int(max_epochs)

    def terminate(self, epoch, score, minimize):
        return epoch + 1 >= self.max_epochs


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs with no (sufficient) improvement."""

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.patience = int(max_epochs_without_improvement)
        self.min_improvement = float(min_improvement)
        self.best = None
        self.since = 0

    def initialize(self):
        self.best, self.since = None, 0

    def terminate(self, epoch, score, minimize):
        if self.best is None:
            self.best = score
            return False
        improvement = (self.best - score) if minimize else (score - self.best)
        if improvement > self.min_improvement:
            self.best = score
            self.since = 0
            return False
        self.since += 1
        return self.since >= self.patience


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once the score is at least as good as a target."""

    def __init__(self, best_expected_score: float):
        self.target = float(best_expected_score)

    def terminate(self, epoch, score, minimize):
        return score <= self.target if minimize else score >= self.target


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = float(max_seconds)
        self._start = None

    def initialize(self):
        self._start = time.perf_counter()

    def terminate(self, last_score):
        return (time.perf_counter() - self._start) >= self.max_seconds


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Stop if the score exceeds a bound (divergence guard)."""

    def __init__(self, max_score: float):
        self.max_score = float(max_score)

    def terminate(self, last_score):
        return last_score > self.max_score


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    def terminate(self, last_score):
        return math.isnan(last_score) or math.isinf(last_score)
