"""HTML export of evaluation artifacts (reference
``deeplearning4j-core/.../evaluation/EvaluationTools.java`` — ROC/calibration
chart export).  Self-contained inline-SVG pages, no external assets.

Copy of the JAX package's module of the same path for the PyTorch
port."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["export_roc_charts_to_html", "export_calibration_to_html",
           "rocs_to_html", "calibration_to_html"]

_W, _H, _PAD = 420, 320, 45


def _polyline(xs, ys, color: str, width: int = 2) -> str:
    pts = " ".join(
        f"{_PAD + x * (_W - 2 * _PAD):.1f},"
        f"{_H - _PAD - y * (_H - 2 * _PAD):.1f}"
        for x, y in zip(xs, ys) if np.isfinite(x) and np.isfinite(y))
    return (f'<polyline fill="none" stroke="{color}" '
            f'stroke-width="{width}" points="{pts}"/>')


def _axes(title: str, xlabel: str, ylabel: str) -> str:
    return (
        f'<rect x="{_PAD}" y="{_PAD}" width="{_W-2*_PAD}" height="{_H-2*_PAD}"'
        f' fill="none" stroke="#999"/>'
        f'<text x="{_W/2}" y="18" text-anchor="middle" font-size="13">{title}</text>'
        f'<text x="{_W/2}" y="{_H-8}" text-anchor="middle" font-size="11">{xlabel}</text>'
        f'<text x="12" y="{_H/2}" text-anchor="middle" font-size="11" '
        f'transform="rotate(-90 12 {_H/2})">{ylabel}</text>'
        + "".join(
            f'<text x="{_PAD + f * (_W - 2*_PAD)}" y="{_H-_PAD+14}" '
            f'text-anchor="middle" font-size="9">{f:.1f}</text>'
            f'<text x="{_PAD-6}" y="{_H-_PAD - f*(_H-2*_PAD)+3}" '
            f'text-anchor="end" font-size="9">{f:.1f}</text>'
            for f in (0.0, 0.5, 1.0)))


def _svg(body: str) -> str:
    return (f'<svg width="{_W}" height="{_H}" '
            f'xmlns="http://www.w3.org/2000/svg">{body}</svg>')


def rocs_to_html(rocs, names: Optional[Sequence[str]] = None) -> str:
    """ROC curves (one chart per ROC with AUC in the title)."""
    charts = []
    if not isinstance(rocs, (list, tuple)):
        rocs = [rocs]
    for i, roc in enumerate(rocs):
        curve = roc.get_roc_curve()
        name = names[i] if names else f"output {i}"
        body = _axes(f"ROC {name} (AUC={curve.calculate_auc():.4f})",
                     "false positive rate", "true positive rate")
        body += _polyline([0, 1], [0, 1], "#bbb", 1)
        body += _polyline(curve.fpr, curve.tpr, "#1565c0")
        charts.append(_svg(body))
        pr = roc.get_precision_recall_curve()
        body = _axes(f"P-R {name} (AUPRC={pr.calculate_auprc():.4f})",
                     "recall", "precision")
        body += _polyline(pr.recall, pr.precision, "#c62828")
        charts.append(_svg(body))
    return ("<!doctype html><html><head><meta charset='utf-8'>"
            "<title>ROC report</title></head><body>"
            + "".join(charts) + "</body></html>")


def calibration_to_html(cal, class_indices: Optional[Sequence[int]] = None
                        ) -> str:
    """Reliability diagrams + probability histograms."""
    classes = list(class_indices
                   if class_indices is not None else range(cal._n_classes))
    charts = []
    for c in classes:
        d = cal.reliability_diagram(c)
        body = _axes(f"Reliability class {c} "
                     f"(ECE={cal.expected_calibration_error(c):.4f})",
                     "mean predicted", "fraction positive")
        body += _polyline([0, 1], [0, 1], "#bbb", 1)
        ok = np.isfinite(d.fraction_positives)
        body += _polyline(d.mean_predicted_value[ok], d.fraction_positives[ok],
                          "#2e7d32")
        charts.append(_svg(body))
        h = cal.probability_histogram(c)
        mx = max(int(h.bin_counts.max()), 1)
        bw = (_W - 2 * _PAD) / h.n_bins
        bars = "".join(
            f'<rect x="{_PAD + j * bw:.1f}" '
            f'y="{_H - _PAD - (v / mx) * (_H - 2 * _PAD):.1f}" '
            f'width="{bw:.1f}" height="{(v / mx) * (_H - 2 * _PAD):.1f}" '
            f'fill="#1565c0"/>' for j, v in enumerate(h.bin_counts))
        charts.append(_svg(_axes(h.title, "p", "count") + bars))
    return ("<!doctype html><html><head><meta charset='utf-8'>"
            "<title>Calibration report</title></head><body>"
            + "".join(charts) + "</body></html>")


def export_roc_charts_to_html(rocs, path: str,
                              names: Optional[Sequence[str]] = None) -> None:
    with open(path, "w") as fh:
        fh.write(rocs_to_html(rocs, names))


def export_calibration_to_html(cal, path: str,
                               class_indices: Optional[Sequence[int]] = None
                               ) -> None:
    with open(path, "w") as fh:
        fh.write(calibration_to_html(cal, class_indices))
