"""EarlyStoppingResult (reference ``earlystopping/EarlyStoppingResult.java``).  Copy of the JAX
package's module for the PyTorch port."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class EarlyStoppingResult:
    termination_reason: str          # "EpochTerminationCondition" | "IterationTerminationCondition" | "Error"
    termination_details: str
    score_vs_epoch: Dict[int, float] = field(default_factory=dict)
    best_model_epoch: int = -1
    best_model_score: float = float("nan")
    total_epochs: int = 0
    best_model: Any = None

    def get_best_model(self):
        return self.best_model
