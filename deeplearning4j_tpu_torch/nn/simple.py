"""Lightweight classification result DTOs (port of ``nn/simple.py``, a
copy).

Reference ``nn/simple/binary/BinaryClassificationResult.java`` and
``nn/simple/multiclass/RankClassificationResult.java`` — small
serialization-friendly holders returned by simple classifier facades.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["BinaryClassificationResult", "RankClassificationResult"]


@dataclass
class BinaryClassificationResult:
    """One binary decision: probability + thresholded label (reference
    BinaryClassificationResult)."""
    probability: float
    threshold: float = 0.5

    @property
    def value(self) -> bool:
        return self.probability >= self.threshold

    def to_dict(self) -> dict:
        return {"probability": self.probability,
                "threshold": self.threshold, "value": self.value}


class RankClassificationResult:
    """Class ranking for a batch of probability rows (reference
    RankClassificationResult: ranked labels + max-index helpers)."""

    def __init__(self, probabilities, labels: Optional[Sequence[str]] = None):
        self.probabilities = np.asarray(probabilities, np.float64)
        if self.probabilities.ndim == 1:
            self.probabilities = self.probabilities[None]
        n = self.probabilities.shape[1]
        self.labels = list(labels) if labels is not None else \
            [str(i) for i in range(n)]
        if len(self.labels) != n:
            raise ValueError(f"{len(self.labels)} labels for {n} classes")

    def max_index(self, row: int = 0) -> int:
        return int(np.argmax(self.probabilities[row]))

    def max_label(self, row: int = 0) -> str:
        return self.labels[self.max_index(row)]

    def rank(self, row: int = 0) -> List[str]:
        """Labels sorted most→least probable for one example."""
        order = np.argsort(-self.probabilities[row], kind="stable")
        return [self.labels[i] for i in order]

    def probability(self, row: int, label: str) -> float:
        return float(self.probabilities[row][self.labels.index(label)])

    def to_dict(self) -> dict:
        return {"labels": self.labels,
                "probabilities": self.probabilities.tolist()}
