"""Probability-calibration evaluation (reference
``eval/EvaluationCalibration.java`` + curves ``eval/curves/ReliabilityDiagram``,
``Histogram``): reliability diagrams, residual histograms, and predicted-
probability histograms per class, plus expected calibration error (ECE).

Copy of the JAX package's module of the same path for the PyTorch
port: ``eval`` takes numpy arrays or tensors on any device (``_np``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .classification import _np

__all__ = ["EvaluationCalibration", "ReliabilityDiagram", "Histogram"]


@dataclass
class Histogram:
    title: str
    lower: float
    upper: float
    bin_counts: np.ndarray

    @property
    def n_bins(self) -> int:
        return len(self.bin_counts)


@dataclass
class ReliabilityDiagram:
    title: str
    mean_predicted_value: np.ndarray  # per bin
    fraction_positives: np.ndarray    # per bin (NaN where bin empty)
    bin_counts: np.ndarray


class EvaluationCalibration:
    """Accumulates (label, predicted prob) pairs binned by confidence."""

    def __init__(self, reliability_bins: int = 10, histogram_bins: int = 50):
        self.reliability_bins = reliability_bins
        self.histogram_bins = histogram_bins
        self._n_classes: Optional[int] = None
        # per class: sum of probs, count of positives, count, per bin
        self._prob_sum = None
        self._pos_count = None
        self._count = None
        self._residual_counts = None
        self._prob_counts = None

    def _ensure(self, n_classes: int):
        if self._n_classes is None:
            self._n_classes = n_classes
            rb, hb = self.reliability_bins, self.histogram_bins
            self._prob_sum = np.zeros((n_classes, rb))
            self._pos_count = np.zeros((n_classes, rb), np.int64)
            self._count = np.zeros((n_classes, rb), np.int64)
            self._residual_counts = np.zeros((n_classes, hb), np.int64)
            self._prob_counts = np.zeros((n_classes, hb), np.int64)

    def eval(self, labels, predictions):
        labels = _np(labels, np.float64)
        predictions = _np(predictions, np.float64)
        if labels.ndim == 3:
            labels = labels.reshape(-1, labels.shape[-1])
            predictions = predictions.reshape(-1, predictions.shape[-1])
        self._ensure(labels.shape[-1])
        rb, hb = self.reliability_bins, self.histogram_bins
        bins = np.clip((predictions * rb).astype(int), 0, rb - 1)
        resid = np.abs(labels - predictions)
        rbins = np.clip((resid * hb).astype(int), 0, hb - 1)
        pbins = np.clip((predictions * hb).astype(int), 0, hb - 1)
        for c in range(self._n_classes):
            np.add.at(self._prob_sum[c], bins[:, c], predictions[:, c])
            np.add.at(self._pos_count[c], bins[:, c],
                      (labels[:, c] >= 0.5).astype(np.int64))
            np.add.at(self._count[c], bins[:, c], 1)
            np.add.at(self._residual_counts[c], rbins[:, c], 1)
            np.add.at(self._prob_counts[c], pbins[:, c], 1)
        return self

    # ---- outputs -----------------------------------------------------------
    def reliability_diagram(self, class_idx: int) -> ReliabilityDiagram:
        cnt = self._count[class_idx]
        with np.errstate(invalid="ignore", divide="ignore"):
            mean_pred = np.where(cnt > 0, self._prob_sum[class_idx]
                                 / np.maximum(cnt, 1), np.nan)
            frac_pos = np.where(cnt > 0, self._pos_count[class_idx]
                                / np.maximum(cnt, 1), np.nan)
        return ReliabilityDiagram(f"class {class_idx}", mean_pred, frac_pos,
                                  cnt.copy())

    def residual_histogram(self, class_idx: int) -> Histogram:
        return Histogram(f"|label - p| class {class_idx}", 0.0, 1.0,
                         self._residual_counts[class_idx].copy())

    def probability_histogram(self, class_idx: int) -> Histogram:
        return Histogram(f"P(class {class_idx})", 0.0, 1.0,
                         self._prob_counts[class_idx].copy())

    def expected_calibration_error(self, class_idx: Optional[int] = None
                                   ) -> float:
        """ECE: count-weighted mean |confidence - accuracy| over bins."""
        classes = ([class_idx] if class_idx is not None
                   else range(self._n_classes))
        total_err = total_cnt = 0.0
        for c in classes:
            d = self.reliability_diagram(c)
            ok = d.bin_counts > 0
            total_err += np.sum(np.abs(d.mean_predicted_value[ok]
                                       - d.fraction_positives[ok])
                                * d.bin_counts[ok])
            total_cnt += d.bin_counts[ok].sum()
        return float(total_err / max(total_cnt, 1.0))
