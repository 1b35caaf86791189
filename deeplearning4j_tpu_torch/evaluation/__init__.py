"""Evaluation (own copies of the JAX package's ``evaluation`` modules:
classification, binary multi-label, regression, the ROC family,
calibration and the HTML export, with tensors accepted at the
boundary)."""
from .binary import EvaluationBinary
from .calibration import (EvaluationCalibration, Histogram,
                          ReliabilityDiagram)
from .classification import ConfusionMatrix, Evaluation
from .regression import RegressionEvaluation
from .roc import ROC, PrecisionRecallCurve, ROCBinary, ROCMultiClass, RocCurve
from .tools import (calibration_to_html, export_calibration_to_html,
                    export_roc_charts_to_html, rocs_to_html)

__all__ = ["Evaluation", "ConfusionMatrix", "EvaluationBinary",
           "EvaluationCalibration", "Histogram", "ReliabilityDiagram",
           "RegressionEvaluation", "ROC", "ROCBinary", "ROCMultiClass",
           "RocCurve", "PrecisionRecallCurve", "rocs_to_html",
           "calibration_to_html", "export_roc_charts_to_html",
           "export_calibration_to_html"]
