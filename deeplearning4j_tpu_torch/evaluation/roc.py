"""ROC / AUC evaluation.

Analogue of ``eval/ROC.java:34-74`` (exact mode default :74, thresholded via
``thresholdSteps`` :57), ``eval/ROCBinary.java``, ``eval/ROCMultiClass.java``
and the curve classes in ``eval/curves/`` (RocCurve, PrecisionRecallCurve).

Exact mode stores all (probability, label) pairs and computes exact AUROC /
AUPRC; thresholded mode accumulates fixed-threshold counts (memory-bounded,
for huge datasets) — both reference semantics.

Copy of the JAX package's module of the same path for the PyTorch
port: ``eval`` takes numpy arrays or tensors on any device (``_np``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def _np(a, dtype=None) -> np.ndarray:
    """A host array from a numpy array or a tensor on any device."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)

_trapz = getattr(np, "trapezoid", None) or np.trapz


class RocCurve:
    def __init__(self, thresholds, fpr, tpr):
        self.thresholds = np.asarray(thresholds)
        self.fpr = np.asarray(fpr)
        self.tpr = np.asarray(tpr)

    def calculate_auc(self) -> float:
        order = np.argsort(self.fpr, kind="stable")
        return float(_trapz(self.tpr[order], self.fpr[order]))


class PrecisionRecallCurve:
    def __init__(self, thresholds, precision, recall):
        self.thresholds = np.asarray(thresholds)
        self.precision = np.asarray(precision)
        self.recall = np.asarray(recall)

    def calculate_auprc(self) -> float:
        order = np.argsort(self.recall, kind="stable")
        return float(_trapz(self.precision[order], self.recall[order]))


class ROC:
    """Binary ROC. threshold_steps=0 → exact (reference default)."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self.is_exact = threshold_steps == 0
        self._probs: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []
        if not self.is_exact:
            n = threshold_steps + 1
            self.thresholds = np.linspace(0.0, 1.0, n)
            self.tp = np.zeros(n)
            self.fp = np.zeros(n)
            self.fn = np.zeros(n)
            self.tn = np.zeros(n)

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None):
        labels = _np(labels, dtype=np.float64)
        predictions = _np(predictions, dtype=np.float64)
        if labels.ndim == 3:
            labels = labels.reshape(-1, labels.shape[-1])
            predictions = predictions.reshape(-1, predictions.shape[-1])
        if labels.ndim == 2 and labels.shape[-1] == 2:
            # [P(class0), P(class1)] convention: positive = column 1
            labels = labels[:, 1]
            predictions = predictions[:, 1]
        elif labels.ndim == 2 and labels.shape[-1] > 2:
            raise ValueError(
                f"ROC is binary-only (got {labels.shape[-1]} output columns); "
                "use ROCMultiClass (reference eval/ROC.java throws likewise)")
        labels = labels.reshape(-1)
        predictions = predictions.reshape(-1)
        if mask is not None:
            keep = _np(mask).reshape(-1) > 0
            labels, predictions = labels[keep], predictions[keep]
        if self.is_exact:
            self._probs.append(predictions)
            self._labels.append(labels)
        else:
            pos = labels > 0.5
            for i, t in enumerate(self.thresholds):
                pred_pos = predictions >= t
                self.tp[i] += np.sum(pred_pos & pos)
                self.fp[i] += np.sum(pred_pos & ~pos)
                self.fn[i] += np.sum(~pred_pos & pos)
                self.tn[i] += np.sum(~pred_pos & ~pos)

    def merge(self, other: "ROC"):
        if self.is_exact:
            self._probs.extend(other._probs)
            self._labels.extend(other._labels)
        else:
            self.tp += other.tp
            self.fp += other.fp
            self.fn += other.fn
            self.tn += other.tn

    def _exact_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        return np.concatenate(self._probs), np.concatenate(self._labels)

    def get_roc_curve(self) -> RocCurve:
        if self.is_exact:
            p, y = self._exact_arrays()
            order = np.argsort(-p, kind="stable")
            y = y[order] > 0.5
            tps = np.cumsum(y)
            fps = np.cumsum(~y)
            P, N = max(tps[-1], 1), max(fps[-1], 1)
            thr = p[order]
            tpr = np.concatenate([[0.0], tps / P])
            fpr = np.concatenate([[0.0], fps / N])
            return RocCurve(np.concatenate([[1.0], thr]), fpr, tpr)
        tpr = self.tp / np.maximum(self.tp + self.fn, 1)
        fpr = self.fp / np.maximum(self.fp + self.tn, 1)
        return RocCurve(self.thresholds, fpr, tpr)

    def get_precision_recall_curve(self) -> PrecisionRecallCurve:
        if self.is_exact:
            p, y = self._exact_arrays()
            order = np.argsort(-p, kind="stable")
            y = y[order] > 0.5
            tps = np.cumsum(y)
            fps = np.cumsum(~y)
            P = max(tps[-1], 1)
            prec = tps / np.maximum(tps + fps, 1)
            rec = tps / P
            return PrecisionRecallCurve(p[order], prec, rec)
        prec = self.tp / np.maximum(self.tp + self.fp, 1)
        rec = self.tp / np.maximum(self.tp + self.fn, 1)
        return PrecisionRecallCurve(self.thresholds, prec, rec)

    def calculate_auc(self) -> float:
        return self.get_roc_curve().calculate_auc()

    def calculate_auprc(self) -> float:
        return self.get_precision_recall_curve().calculate_auprc()

    def stats(self) -> str:
        return (f"AUC (Area under ROC curve): {self.calculate_auc():.6f}\n"
                f"AUPRC (Area under PR curve): {self.calculate_auprc():.6f}")


class ROCBinary:
    """Per-output-column binary ROC (reference eval/ROCBinary.java) for
    multi-label sigmoid outputs."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self._rocs: List[ROC] = []

    def eval(self, labels, predictions, mask=None):
        labels = _np(labels)
        predictions = _np(predictions)
        if labels.ndim == 1:
            labels = labels[:, None]
            predictions = predictions[:, None]
        n = labels.shape[-1]
        if not self._rocs:
            self._rocs = [ROC(self.threshold_steps) for _ in range(n)]
        for c in range(n):
            self._rocs[c].eval(labels[..., c], predictions[..., c], mask)

    def calculate_auc(self, col: int) -> float:
        return self._rocs[col].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._rocs]))

    def num_labels(self) -> int:
        return len(self._rocs)


class ROCMultiClass:
    """One-vs-all ROC per class (reference eval/ROCMultiClass.java)."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self._rocs: List[ROC] = []

    def eval(self, labels, predictions, mask=None):
        labels = _np(labels)
        predictions = _np(predictions)
        if labels.ndim == 3:
            labels = labels.reshape(-1, labels.shape[-1])
            predictions = predictions.reshape(-1, predictions.shape[-1])
        n = labels.shape[-1]
        if not self._rocs:
            self._rocs = [ROC(self.threshold_steps) for _ in range(n)]
        for c in range(n):
            self._rocs[c].eval(labels[:, c], predictions[:, c], mask)

    def calculate_auc(self, cls: int) -> float:
        return self._rocs[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._rocs]))
