"""Dataset normalizers (port of ``data/normalization.py``, a copy: numpy
only; a file that either package saves, the other loads).

Analogue of the nd4j DataNormalization stack the reference trains with
(``NormalizerStandardize``, ``NormalizerMinMaxScaler``,
``ImagePreProcessingScaler`` — external nd4j classes, referenced all over
the examples and Spark masters): fit statistics over an iterator, then
transform (and optionally revert) batches; serializable so serving sees
the exact training-time preprocessing.
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np

from .dataset import DataSet

__all__ = ["NormalizerStandardize", "NormalizerMinMaxScaler",
           "ImagePreProcessingScaler", "load_normalizer"]


class _BaseNormalizer:
    KIND = "base"
    _EPS = 1e-8

    def __init__(self):
        self.fit_labels = False

    def fit_label(self, fit_labels: bool = True) -> "_BaseNormalizer":
        """Also normalize labels (regression targets) — reference
        ``fitLabel``."""
        self.fit_labels = fit_labels
        return self

    # -- iterator plumbing ---------------------------------------------------
    def _batches(self, data):
        if isinstance(data, DataSet):
            yield data
            return
        if hasattr(data, "reset"):
            data.reset()
        for b in data:
            yield b if isinstance(b, DataSet) else DataSet(b[0], b[1])

    def fit(self, data) -> "_BaseNormalizer":
        """Streaming fit: per-batch running accumulators, O(features)
        memory — the dataset is never materialized (nd4j normalizers use
        the same running-stats approach)."""
        self._begin_fit()
        for ds in self._batches(data):
            # host ETL, not a device fetch: batches come from the host
            # iterator and the running accumulators are numpy
            self._update_fit(np.asarray(ds.features, np.float64),  # graftlint: disable=JX003
                             np.asarray(ds.labels, np.float64)  # graftlint: disable=JX003
                             if self.fit_labels else None)
        self._finish_fit()
        return self

    def _begin_fit(self):
        raise NotImplementedError

    def _update_fit(self, feats, labels):
        raise NotImplementedError

    def _finish_fit(self):
        raise NotImplementedError

    def transform(self, ds: DataSet) -> DataSet:
        f = self._tx(np.asarray(ds.features, np.float32), False)
        l = ds.labels
        if self.fit_labels:
            l = self._tx(np.asarray(ds.labels, np.float32), True)
        return DataSet(f, l, ds.features_mask, ds.labels_mask)

    def revert(self, ds: DataSet) -> DataSet:
        f = self._untx(np.asarray(ds.features, np.float32), False)
        l = ds.labels
        if self.fit_labels:
            l = self._untx(np.asarray(ds.labels, np.float32), True)
        return DataSet(f, l, ds.features_mask, ds.labels_mask)

    def pre_process(self, ds: DataSet) -> DataSet:  # reference naming
        return self.transform(ds)

    def wrap(self, iterator):
        """Iterator adapter applying this normalizer per batch (the
        reference attaches normalizers via setPreProcessor)."""
        norm = self

        class _It:
            def batch(self):
                return iterator.batch()

            def reset(self):
                if hasattr(iterator, "reset"):
                    iterator.reset()

            def __iter__(self):
                if hasattr(iterator, "reset"):
                    iterator.reset()
                for ds in iterator:
                    yield norm.transform(
                        ds if isinstance(ds, DataSet)
                        else DataSet(ds[0], ds[1]))

        return _It()

    # -- persistence ---------------------------------------------------------
    def save(self, path) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump({"kind": self.KIND, "fit_labels": self.fit_labels,
                       "stats": self._stats_dict()}, fh)

    def _stats_dict(self):
        raise NotImplementedError

    def _load_stats(self, d):
        raise NotImplementedError


class NormalizerStandardize(_BaseNormalizer):
    """Zero-mean unit-variance per feature column (reference
    NormalizerStandardize)."""
    KIND = "standardize"

    def __init__(self):
        super().__init__()
        self.mean = self.std = None
        self.label_mean = self.label_std = None

    def _begin_fit(self):
        self._acc = {}

    @staticmethod
    def _acc_update(acc, key, a):
        flat = a.reshape(-1, a.shape[-1])
        n, sm, sq = acc.get(key, (0, 0.0, 0.0))
        acc[key] = (n + flat.shape[0], sm + flat.sum(0),
                    sq + (flat * flat).sum(0))

    @staticmethod
    def _acc_final(acc, key):
        n, sm, sq = acc[key]
        mean = sm / max(n, 1)
        var = np.maximum(sq / max(n, 1) - mean * mean, 0.0)
        return mean, np.sqrt(var)

    def _update_fit(self, feats, labels):
        self._acc_update(self._acc, "f", feats)
        if labels is not None:
            self._acc_update(self._acc, "l", labels)

    def _finish_fit(self):
        self.mean, self.std = self._acc_final(self._acc, "f")
        if "l" in self._acc:
            self.label_mean, self.label_std = self._acc_final(self._acc, "l")
        del self._acc

    def _tx(self, a, is_label):
        m, s = ((self.label_mean, self.label_std) if is_label
                else (self.mean, self.std))
        return ((a - m) / np.maximum(s, self._EPS)).astype(np.float32)

    def _untx(self, a, is_label):
        m, s = ((self.label_mean, self.label_std) if is_label
                else (self.mean, self.std))
        return (a * np.maximum(s, self._EPS) + m).astype(np.float32)

    def _stats_dict(self):
        out = {"mean": self.mean.tolist(), "std": self.std.tolist()}
        if self.label_mean is not None:
            out["label_mean"] = self.label_mean.tolist()
            out["label_std"] = self.label_std.tolist()
        return out

    def _load_stats(self, d):
        self.mean = np.asarray(d["mean"])
        self.std = np.asarray(d["std"])
        if "label_mean" in d:
            self.label_mean = np.asarray(d["label_mean"])
            self.label_std = np.asarray(d["label_std"])


class NormalizerMinMaxScaler(_BaseNormalizer):
    """Scale per feature column into [lo, hi] (reference
    NormalizerMinMaxScaler)."""
    KIND = "minmax"

    def __init__(self, lo: float = 0.0, hi: float = 1.0):
        super().__init__()
        self.lo, self.hi = float(lo), float(hi)
        self.min = self.max = None
        self.label_min = self.label_max = None

    def _begin_fit(self):
        self.min = self.max = None
        self.label_min = self.label_max = None

    def _update_fit(self, feats, labels):
        flat = feats.reshape(-1, feats.shape[-1])
        lo, hi = flat.min(0), flat.max(0)
        self.min = lo if self.min is None else np.minimum(self.min, lo)
        self.max = hi if self.max is None else np.maximum(self.max, hi)
        if labels is not None:
            lf = labels.reshape(-1, labels.shape[-1])
            llo, lhi = lf.min(0), lf.max(0)
            self.label_min = llo if self.label_min is None else                 np.minimum(self.label_min, llo)
            self.label_max = lhi if self.label_max is None else                 np.maximum(self.label_max, lhi)

    def _finish_fit(self):
        pass

    def _scale(self, a, lo_v, hi_v):
        rng = np.maximum(hi_v - lo_v, self._EPS)
        return ((a - lo_v) / rng * (self.hi - self.lo) + self.lo).astype(
            np.float32)

    def _tx(self, a, is_label):
        lo_v, hi_v = ((self.label_min, self.label_max) if is_label
                      else (self.min, self.max))
        return self._scale(a, lo_v, hi_v)

    def _untx(self, a, is_label):
        lo_v, hi_v = ((self.label_min, self.label_max) if is_label
                      else (self.min, self.max))
        rng = np.maximum(hi_v - lo_v, self._EPS)
        return (((a - self.lo) / max(self.hi - self.lo, self._EPS)) * rng
                + lo_v).astype(np.float32)

    def _stats_dict(self):
        out = {"lo": self.lo, "hi": self.hi, "min": self.min.tolist(),
               "max": self.max.tolist()}
        if self.label_min is not None:
            out["label_min"] = self.label_min.tolist()
            out["label_max"] = self.label_max.tolist()
        return out

    def _load_stats(self, d):
        self.lo, self.hi = d["lo"], d["hi"]
        self.min = np.asarray(d["min"])
        self.max = np.asarray(d["max"])
        if "label_min" in d:
            self.label_min = np.asarray(d["label_min"])
            self.label_max = np.asarray(d["label_max"])


class ImagePreProcessingScaler(_BaseNormalizer):
    """Fixed-range pixel scaling, no fitting needed: [0, max_pixel] →
    [lo, hi] (reference ImagePreProcessingScaler)."""
    KIND = "image"

    def __init__(self, lo: float = 0.0, hi: float = 1.0,
                 max_pixel: float = 255.0):
        super().__init__()
        self.lo, self.hi = float(lo), float(hi)
        self.max_pixel = float(max_pixel)

    def fit(self, data):  # stateless
        return self

    def _tx(self, a, is_label):
        if is_label:
            return a
        return (a / self.max_pixel * (self.hi - self.lo) + self.lo).astype(
            np.float32)

    def _untx(self, a, is_label):
        if is_label:
            return a
        return ((a - self.lo) / max(self.hi - self.lo, self._EPS)
                * self.max_pixel).astype(np.float32)

    def _stats_dict(self):
        return {"lo": self.lo, "hi": self.hi, "max_pixel": self.max_pixel}

    def _load_stats(self, d):
        self.lo, self.hi = d["lo"], d["hi"]
        self.max_pixel = d["max_pixel"]


_KINDS = {c.KIND: c for c in (NormalizerStandardize, NormalizerMinMaxScaler,
                              ImagePreProcessingScaler)}


def load_normalizer(path):
    """Restore any saved normalizer (reference NormalizerSerializer)."""
    with open(path, encoding="utf-8") as fh:
        d = json.load(fh)
    norm = _KINDS[d["kind"]]()
    norm.fit_labels = d.get("fit_labels", False)
    norm._load_stats(d["stats"])
    return norm
