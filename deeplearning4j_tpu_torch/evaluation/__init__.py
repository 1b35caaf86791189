"""Evaluation (own copies of the JAX package's ``evaluation``
classification, regression and ROC modules, with tensors accepted at the
boundary)."""
from .classification import ConfusionMatrix, Evaluation
from .regression import RegressionEvaluation
from .roc import ROC, PrecisionRecallCurve, ROCBinary, ROCMultiClass, RocCurve

__all__ = ["ConfusionMatrix", "Evaluation", "PrecisionRecallCurve", "ROC",
           "ROCBinary", "ROCMultiClass", "RegressionEvaluation", "RocCurve"]
