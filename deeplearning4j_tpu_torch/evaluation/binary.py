"""Per-output binary classification evaluation (reference
``eval/EvaluationBinary.java``: independent binary stats per output column,
with optional per-label decision thresholds and mask support).

Copy of the JAX package's module of the same path for the PyTorch
port: ``eval`` takes numpy arrays or tensors on any device (``_np``)."""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .classification import _np

__all__ = ["EvaluationBinary"]


class EvaluationBinary:
    """Counts TP/FP/TN/FN independently for each of the n output columns
    (multi-label setting — each column is its own binary problem)."""

    def __init__(self, n_labels: Optional[int] = None,
                 decision_threshold: float = 0.5,
                 thresholds: Optional[Sequence[float]] = None,
                 label_names: Optional[List[str]] = None):
        self.n_labels = n_labels
        self.decision_threshold = decision_threshold
        self.thresholds = None if thresholds is None else np.asarray(thresholds)
        self.label_names = label_names
        self.tp = self.fp = self.tn = self.fn = None

    def _ensure(self, n: int):
        if self.tp is None:
            self.n_labels = n
            self.tp = np.zeros(n, np.int64)
            self.fp = np.zeros(n, np.int64)
            self.tn = np.zeros(n, np.int64)
            self.fn = np.zeros(n, np.int64)

    def eval(self, labels, predictions, mask: Optional[np.ndarray] = None):
        labels = _np(labels)
        predictions = _np(predictions)
        n_out = labels.shape[-1]
        if mask is not None:
            mask = _np(mask)
        if labels.ndim == 3:  # time series: flatten [b,t,n] -> [b*t,n]
            labels = labels.reshape(-1, n_out)
            predictions = predictions.reshape(-1, n_out)
            if mask is not None:
                # per-step [b,t] -> [b*t]; per-output [b,t,n] -> [b*t,n]
                mask = (mask.reshape(-1, n_out) if mask.ndim == 3
                        else mask.reshape(-1))
        self._ensure(n_out)
        t = (self.thresholds if self.thresholds is not None
             else self.decision_threshold)
        pred = (predictions >= t).astype(np.int64)
        lab = (labels >= 0.5).astype(np.int64)
        if mask is None:
            w = np.ones((len(lab), 1), np.int64)
        elif mask.ndim == 1:   # per-example weight, broadcast over outputs
            w = (mask > 0).astype(np.int64)[:, None]
        else:                  # per-output weight [N, n]
            w = (mask > 0).astype(np.int64)
        # weighted per-label counts: never index-flatten, so per-output masks
        # keep the label axis intact
        self.tp += (((pred == 1) & (lab == 1)) * w).sum(0)
        self.fp += (((pred == 1) & (lab == 0)) * w).sum(0)
        self.tn += (((pred == 0) & (lab == 0)) * w).sum(0)
        self.fn += (((pred == 0) & (lab == 1)) * w).sum(0)
        return self

    def merge(self, other: "EvaluationBinary") -> "EvaluationBinary":
        if other.tp is None:
            return self
        self._ensure(len(other.tp))
        self.tp += other.tp
        self.fp += other.fp
        self.tn += other.tn
        self.fn += other.fn
        return self

    # ---- per-label metrics -------------------------------------------------
    def _div(self, a, b):
        return np.divide(a, b, out=np.zeros_like(a, dtype=float),
                         where=b > 0)

    def accuracy(self, label: Optional[int] = None):
        acc = self._div(self.tp + self.tn, self.tp + self.tn + self.fp + self.fn)
        return float(acc[label]) if label is not None else acc

    def precision(self, label: Optional[int] = None):
        p = self._div(self.tp, self.tp + self.fp)
        return float(p[label]) if label is not None else p

    def recall(self, label: Optional[int] = None):
        r = self._div(self.tp, self.tp + self.fn)
        return float(r[label]) if label is not None else r

    def f1(self, label: Optional[int] = None):
        p, r = self.precision(), self.recall()
        f = self._div(2 * p * r, p + r)
        return float(f[label]) if label is not None else f

    def average_accuracy(self) -> float:
        return float(np.mean(self.accuracy()))

    def average_f1(self) -> float:
        return float(np.mean(self.f1()))

    def false_alarm_rate(self, label: Optional[int] = None):
        fa = self._div(self.fp, self.fp + self.tn)
        return float(fa[label]) if label is not None else fa

    def stats(self) -> str:
        names = (self.label_names
                 or [f"label_{i}" for i in range(self.n_labels or 0)])
        lines = [f"{'label':<16}{'acc':>8}{'prec':>8}{'rec':>8}{'f1':>8}"
                 f"{'tp':>8}{'fp':>8}{'tn':>8}{'fn':>8}"]
        for i, nm in enumerate(names):
            lines.append(
                f"{nm:<16}{self.accuracy(i):>8.4f}{self.precision(i):>8.4f}"
                f"{self.recall(i):>8.4f}{self.f1(i):>8.4f}"
                f"{self.tp[i]:>8}{self.fp[i]:>8}{self.tn[i]:>8}{self.fn[i]:>8}")
        lines.append(f"average accuracy: {self.average_accuracy():.4f}  "
                     f"average f1: {self.average_f1():.4f}")
        return "\n".join(lines)
