"""Early stopping (reference ``deeplearning4j-nn/.../earlystopping/``;
port of the JAX package's ``earlystopping``)."""
from .config import EarlyStoppingConfiguration
from .result import EarlyStoppingResult
from .savers import InMemoryModelSaver, LocalFileModelSaver
from .scorecalc import AccuracyScoreCalculator, DataSetLossCalculator
from .terminations import (BestScoreEpochTerminationCondition,
                           InvalidScoreIterationTerminationCondition,
                           MaxEpochsTerminationCondition,
                           MaxScoreIterationTerminationCondition,
                           MaxTimeIterationTerminationCondition,
                           ScoreImprovementEpochTerminationCondition)
from .trainer import (EarlyStoppingGraphTrainer, EarlyStoppingMasterTrainer,
                      EarlyStoppingParallelTrainer, EarlyStoppingTrainer)

__all__ = [
    "AccuracyScoreCalculator", "BestScoreEpochTerminationCondition",
    "DataSetLossCalculator", "EarlyStoppingConfiguration",
    "EarlyStoppingResult", "EarlyStoppingTrainer", "EarlyStoppingGraphTrainer",
    "EarlyStoppingMasterTrainer", "EarlyStoppingParallelTrainer",
    "InMemoryModelSaver", "InvalidScoreIterationTerminationCondition",
    "LocalFileModelSaver",
    "MaxEpochsTerminationCondition", "MaxScoreIterationTerminationCondition",
    "MaxTimeIterationTerminationCondition",
    "ScoreImprovementEpochTerminationCondition",
]
