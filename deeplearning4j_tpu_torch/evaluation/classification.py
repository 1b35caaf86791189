"""Classification evaluation.

Analogue of ``eval/Evaluation.java:72`` + ``eval/ConfusionMatrix.java`` and
``eval/EvaluationBinary.java``: accuracy, precision, recall, F-beta, Matthews
correlation, confusion matrix, top-N accuracy, per-class reports.  Accumulation
is streaming (eval batch by batch), matching the reference's merge semantics.

Copy of the JAX package's module of the same path for the PyTorch
port: ``eval`` takes numpy arrays or tensors on any device (``_np``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def _np(a, dtype=None) -> np.ndarray:
    """A host array from a numpy array or a tensor on any device."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


class ConfusionMatrix:
    """Integer confusion-count matrix (reference eval/ConfusionMatrix.java)."""

    def __init__(self, n_classes: int):
        self.n = n_classes
        self.matrix = np.zeros((n_classes, n_classes), dtype=np.int64)

    def add(self, actual: int, predicted: int, count: int = 1):
        self.matrix[actual, predicted] += count

    def add_batch(self, actual: np.ndarray, predicted: np.ndarray):
        np.add.at(self.matrix, (actual, predicted), 1)

    def actual_total(self, cls: int) -> int:
        return int(self.matrix[cls].sum())

    def predicted_total(self, cls: int) -> int:
        return int(self.matrix[:, cls].sum())

    def count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def total(self) -> int:
        return int(self.matrix.sum())


class Prediction:
    """One recorded (actual, predicted, metadata) triple (reference
    ``eval/meta/Prediction.java``)."""

    __slots__ = ("actual", "predicted", "metadata")

    def __init__(self, actual: int, predicted: int, metadata=None):
        self.actual = actual
        self.predicted = predicted
        self.metadata = metadata

    def __repr__(self):
        return (f"Prediction(actual={self.actual}, "
                f"predicted={self.predicted}, metadata={self.metadata!r})")


class Evaluation:
    """Multi-class classification metrics (reference eval/Evaluation.java)."""

    def __init__(self, n_classes: Optional[int] = None,
                 labels: Optional[List[str]] = None, top_n: int = 1):
        self.n_classes = n_classes
        self.label_names = labels
        self.top_n = top_n
        self.confusion: Optional[ConfusionMatrix] = None
        self.top_n_correct = 0
        self.top_n_total = 0
        self._predictions: List[Prediction] = []

    # ------------------------------------------------------------------ eval
    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None, record_metadata=None):
        """labels/predictions: [batch, n_classes] probabilities or one-hot;
        time series [batch, time, n_classes] are flattened (reference
        evalTimeSeries).  record_metadata: optional per-example objects
        (reference ``eval/meta/``) enabling get_prediction_errors()."""
        labels = _np(labels)
        predictions = _np(predictions)
        if labels.ndim == 3:
            if mask is not None:
                keep = _np(mask).reshape(-1) > 0
            labels = labels.reshape(-1, labels.shape[-1])
            predictions = predictions.reshape(-1, predictions.shape[-1])
            if mask is not None:
                labels, predictions = labels[keep], predictions[keep]
        elif mask is not None:
            keep = _np(mask).reshape(-1) > 0
            labels, predictions = labels[keep], predictions[keep]

        if labels.ndim == 1 or labels.shape[-1] == 1:
            # binary 0/1 labels in a single column
            labels = labels.reshape(-1)
            n = 2
            actual = (labels > 0.5).astype(np.int64)
            p = predictions.reshape(-1)
            predicted = (p > 0.5).astype(np.int64)
        else:
            n = labels.shape[-1]
            actual = labels.argmax(-1)
            predicted = predictions.argmax(-1)

        if self.confusion is None:
            self.n_classes = self.n_classes or n
            self.confusion = ConfusionMatrix(self.n_classes)
        self.confusion.add_batch(actual, predicted)

        if record_metadata is not None:
            if len(record_metadata) != len(actual):
                raise ValueError(
                    f"{len(record_metadata)} metadata entries for "
                    f"{len(actual)} (post-mask) examples")
            for a, p, md in zip(actual, predicted, record_metadata):
                self._predictions.append(
                    Prediction(int(a), int(p), md))

        if self.top_n > 1 and predictions.ndim == 2:
            topn = np.argsort(-predictions, axis=-1)[:, :self.top_n]
            self.top_n_correct += int((topn == actual[:, None]).any(axis=1).sum())
            self.top_n_total += len(actual)

    def merge(self, other: "Evaluation"):
        if other.confusion is None:
            return
        if self.confusion is None:
            self.n_classes = other.n_classes
            self.confusion = ConfusionMatrix(self.n_classes)
        self.confusion.matrix += other.confusion.matrix
        self.top_n_correct += other.top_n_correct
        self.top_n_total += other.top_n_total
        self._predictions.extend(other._predictions)

    # ------------------------------------------------------------- serde
    def to_json(self) -> str:
        """Reference ``eval/serde``: evaluations are serializable so
        workers can ship partial results for merge()."""
        import json
        return json.dumps({
            "type": "Evaluation",
            "n_classes": self.n_classes,
            "labels": self.label_names,
            "top_n": self.top_n,
            "top_n_correct": self.top_n_correct,
            "top_n_total": self.top_n_total,
            "confusion": (self.confusion.matrix.tolist()
                          if self.confusion is not None else None),
            "predictions": [
                {"a": p.actual, "p": p.predicted,
                 "m": p.metadata if isinstance(
                     p.metadata, (str, int, float, type(None)))
                 else str(p.metadata)}
                for p in self._predictions],
        })

    @staticmethod
    def from_json(s: str) -> "Evaluation":
        import json
        d = json.loads(s)
        ev = Evaluation(n_classes=d["n_classes"], labels=d["labels"],
                        top_n=d.get("top_n", 1))
        if d.get("confusion") is not None:
            ev.confusion = ConfusionMatrix(d["n_classes"])
            ev.confusion.matrix = np.asarray(d["confusion"], np.int64)
        ev.top_n_correct = d.get("top_n_correct", 0)
        ev.top_n_total = d.get("top_n_total", 0)
        ev._predictions = [Prediction(r["a"], r["p"], r.get("m"))
                           for r in d.get("predictions", [])]
        return ev

    # ----------------------------------------------------- prediction meta
    def get_prediction_errors(self) -> List["Prediction"]:
        """Misclassified examples with their metadata (reference
        ``getPredictionErrors``)."""
        return [p for p in self._predictions if p.actual != p.predicted]

    def get_predictions_by_actual_class(self, cls: int) -> List["Prediction"]:
        return [p for p in self._predictions if p.actual == cls]

    def get_predictions_by_predicted_class(self, cls: int
                                           ) -> List["Prediction"]:
        return [p for p in self._predictions if p.predicted == cls]

    # --------------------------------------------------------------- metrics
    def _tp(self, c):
        return self.confusion.count(c, c)

    def _fp(self, c):
        return self.confusion.predicted_total(c) - self._tp(c)

    def _fn(self, c):
        return self.confusion.actual_total(c) - self._tp(c)

    def accuracy(self) -> float:
        m = self.confusion.matrix
        tot = m.sum()
        return float(np.trace(m) / tot) if tot else 0.0

    def top_n_accuracy(self) -> float:
        return self.top_n_correct / self.top_n_total if self.top_n_total else 0.0

    def precision(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            d = self._tp(cls) + self._fp(cls)
            return self._tp(cls) / d if d else 0.0
        vals = [self.precision(c) for c in range(self.n_classes)
                if self.confusion.actual_total(c) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            d = self._tp(cls) + self._fn(cls)
            return self._tp(cls) / d if d else 0.0
        vals = [self.recall(c) for c in range(self.n_classes)
                if self.confusion.actual_total(c) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        return self.f_beta(1.0, cls)

    def f_beta(self, beta: float, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        d = beta * beta * p + r
        return float((1 + beta * beta) * p * r / d) if d else 0.0

    def matthews_correlation(self, cls: int) -> float:
        tp, fp, fn = self._tp(cls), self._fp(cls), self._fn(cls)
        tn = self.confusion.total() - tp - fp - fn
        num = tp * tn - fp * fn
        den = np.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
        return float(num / den) if den else 0.0

    def false_positive_rate(self, cls: int) -> float:
        fp = self._fp(cls)
        tn = self.confusion.total() - self._tp(cls) - fp - self._fn(cls)
        return fp / (fp + tn) if (fp + tn) else 0.0

    def false_negative_rate(self, cls: int) -> float:
        fn = self._fn(cls)
        return fn / (fn + self._tp(cls)) if (fn + self._tp(cls)) else 0.0

    # ---------------------------------------------------------------- report
    def stats(self) -> str:
        if self.confusion is None:
            return "<no data>"
        lines = ["", "========================Evaluation Metrics========================"]
        lines.append(f" # of classes:    {self.n_classes}")
        lines.append(f" Accuracy:        {self.accuracy():.4f}")
        if self.top_n > 1:
            lines.append(f" Top {self.top_n} Accuracy:  {self.top_n_accuracy():.4f}")
        lines.append(f" Precision:       {self.precision():.4f}")
        lines.append(f" Recall:          {self.recall():.4f}")
        lines.append(f" F1 Score:        {self.f1():.4f}")
        lines.append("")
        lines.append("=========================Confusion Matrix=========================")
        lines.append(str(self.confusion.matrix))
        lines.append("==================================================================")
        return "\n".join(lines)

    def __str__(self):
        return self.stats()
