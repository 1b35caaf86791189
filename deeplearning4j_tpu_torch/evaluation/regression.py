"""Regression evaluation (reference ``eval/RegressionEvaluation.java``).

Streaming accumulation of MSE, MAE, RMSE, RSE, PC (Pearson correlation), R².
Per-column statistics, merged across batches exactly as the reference does.

Copy of the JAX package's module of the same path for the PyTorch
port: ``eval`` takes numpy arrays or tensors on any device (``_np``).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def _np(a, dtype=None) -> np.ndarray:
    """A host array from a numpy array or a tensor on any device."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


class RegressionEvaluation:
    def __init__(self, n_columns: Optional[int] = None,
                 column_names: Optional[List[str]] = None):
        self.n_columns = n_columns
        self.column_names = column_names
        self._initialized = False

    def _init_stats(self, n):
        self.n_columns = n
        z = lambda: np.zeros(n, dtype=np.float64)
        self.sum_abs_err = z()
        self.sum_sq_err = z()
        self.sum_label = z()
        self.sum_sq_label = z()
        self.sum_pred = z()
        self.sum_sq_pred = z()
        self.sum_label_pred = z()
        self.count = z()
        self._initialized = True

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None):
        labels = _np(labels, dtype=np.float64)
        predictions = _np(predictions, dtype=np.float64)
        if labels.ndim == 3:
            labels = labels.reshape(-1, labels.shape[-1])
            predictions = predictions.reshape(-1, predictions.shape[-1])
        if mask is not None:
            keep = _np(mask).reshape(-1) > 0
            labels, predictions = labels[keep], predictions[keep]
        if labels.ndim == 1:
            labels = labels[:, None]
            predictions = predictions[:, None]
        if not self._initialized:
            self._init_stats(labels.shape[1])
        err = predictions - labels
        self.sum_abs_err += np.abs(err).sum(0)
        self.sum_sq_err += (err ** 2).sum(0)
        self.sum_label += labels.sum(0)
        self.sum_sq_label += (labels ** 2).sum(0)
        self.sum_pred += predictions.sum(0)
        self.sum_sq_pred += (predictions ** 2).sum(0)
        self.sum_label_pred += (labels * predictions).sum(0)
        self.count += labels.shape[0]

    def merge(self, other: "RegressionEvaluation"):
        if not other._initialized:
            return
        if not self._initialized:
            self._init_stats(other.n_columns)
        for f in ("sum_abs_err", "sum_sq_err", "sum_label", "sum_sq_label",
                  "sum_pred", "sum_sq_pred", "sum_label_pred", "count"):
            setattr(self, f, getattr(self, f) + getattr(other, f))

    # ---- metrics ------------------------------------------------------------
    def mean_squared_error(self, col: int) -> float:
        return float(self.sum_sq_err[col] / self.count[col])

    def mean_absolute_error(self, col: int) -> float:
        return float(self.sum_abs_err[col] / self.count[col])

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self.sum_sq_err[col] / self.count[col]))

    def relative_squared_error(self, col: int) -> float:
        n = self.count[col]
        mean_label = self.sum_label[col] / n
        ss_tot = self.sum_sq_label[col] - n * mean_label ** 2
        return float(self.sum_sq_err[col] / ss_tot) if ss_tot else float("nan")

    def pearson_correlation(self, col: int) -> float:
        n = self.count[col]
        cov = self.sum_label_pred[col] - self.sum_label[col] * self.sum_pred[col] / n
        vl = self.sum_sq_label[col] - self.sum_label[col] ** 2 / n
        vp = self.sum_sq_pred[col] - self.sum_pred[col] ** 2 / n
        den = np.sqrt(vl * vp)
        return float(cov / den) if den else float("nan")

    def r_squared(self, col: int) -> float:
        rse = self.relative_squared_error(col)
        return 1.0 - rse

    def average_mean_squared_error(self) -> float:
        return float(np.mean([self.mean_squared_error(c) for c in range(self.n_columns)]))

    def average_mean_absolute_error(self) -> float:
        return float(np.mean([self.mean_absolute_error(c) for c in range(self.n_columns)]))

    def average_root_mean_squared_error(self) -> float:
        return float(np.mean([self.root_mean_squared_error(c) for c in range(self.n_columns)]))

    def average_pearson_correlation(self) -> float:
        return float(np.mean([self.pearson_correlation(c) for c in range(self.n_columns)]))

    def average_r_squared(self) -> float:
        return float(np.mean([self.r_squared(c) for c in range(self.n_columns)]))

    def stats(self) -> str:
        lines = ["Column    MSE            MAE            RMSE           RSE            PC             R^2"]
        for c in range(self.n_columns):
            name = (self.column_names[c] if self.column_names and c < len(self.column_names)
                    else f"col_{c}")
            lines.append(
                f"{name:<10}{self.mean_squared_error(c):<15.6e}"
                f"{self.mean_absolute_error(c):<15.6e}"
                f"{self.root_mean_squared_error(c):<15.6e}"
                f"{self.relative_squared_error(c):<15.6e}"
                f"{self.pearson_correlation(c):<15.6e}"
                f"{self.r_squared(c):<.6e}")
        return "\n".join(lines)

    def __str__(self):
        return self.stats()
