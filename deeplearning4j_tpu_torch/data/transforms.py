"""Image transforms for training pipelines (port of
``data/transforms.py``, a copy: numpy only, the same draws from the same
seed).

The DataVec ``ImageTransform`` role (the reference's CIFAR/image iterators
wrap DataVec's flip/crop/normalize pipeline — external module, SURVEY
§2.2).  Transforms are numpy, run on the prefetch thread (compose with
``AsyncDataSetIterator``), deterministic under a seeded rng, and applied
per batch via ``TransformingDataSetIterator``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .dataset import DataSet, DataSetIterator

__all__ = ["ImageTransform", "RandomFlipTransform", "RandomCropTransform",
           "CutoutTransform", "ComposeTransform",
           "TransformingDataSetIterator"]


class ImageTransform:
    """transform(features [b,h,w,c], rng) -> features."""

    def transform(self, feats: np.ndarray, rng) -> np.ndarray:
        raise NotImplementedError

    def __call__(self, feats, rng):
        return self.transform(feats, rng)


class RandomFlipTransform(ImageTransform):
    """Horizontal (and optionally vertical) flips with probability p."""

    def __init__(self, p: float = 0.5, vertical: bool = False):
        self.p = p
        self.vertical = vertical

    def transform(self, feats, rng):
        out = feats.copy()
        flip = rng.random(len(out)) < self.p
        out[flip] = out[flip, :, ::-1]
        if self.vertical:
            flip = rng.random(len(out)) < self.p
            out[flip] = out[flip, ::-1]
        return out


class RandomCropTransform(ImageTransform):
    """Pad by ``padding`` then crop back to the original size at a random
    offset (the standard CIFAR augmentation)."""

    def __init__(self, padding: int = 4):
        self.padding = padding

    def transform(self, feats, rng):
        p = self.padding
        b, h, w = feats.shape[:3]
        pad_width = [(0, 0), (p, p), (p, p)] + \
            [(0, 0)] * (feats.ndim - 3)
        padded = np.pad(feats, pad_width, mode="reflect")
        out = np.empty_like(feats)
        ys = rng.integers(0, 2 * p + 1, b)
        xs = rng.integers(0, 2 * p + 1, b)
        for i in range(b):
            out[i] = padded[i, ys[i]:ys[i] + h, xs[i]:xs[i] + w]
        return out


class CutoutTransform(ImageTransform):
    """Zero a random square patch per image (regularization)."""

    def __init__(self, size: int = 8, p: float = 0.5):
        self.size = size
        self.p = p

    def transform(self, feats, rng):
        out = feats.copy()
        b, h, w = feats.shape[:3]
        s = self.size
        for i in range(b):
            if rng.random() >= self.p:
                continue
            y = int(rng.integers(0, max(h - s, 1)))
            x = int(rng.integers(0, max(w - s, 1)))
            out[i, y:y + s, x:x + s] = 0
        return out


class ComposeTransform(ImageTransform):
    def __init__(self, transforms: Sequence[ImageTransform]):
        self.transforms = list(transforms)

    def transform(self, feats, rng):
        for t in self.transforms:
            feats = t.transform(feats, rng)
        return feats


class TransformingDataSetIterator(DataSetIterator):
    """Apply an ImageTransform to every batch's features (fresh random
    draws each epoch, seeded for reproducibility)."""

    def __init__(self, underlying: DataSetIterator,
                 transform: ImageTransform, seed: int = 0):
        self.underlying = underlying
        self.transform = transform
        self.seed = seed
        self._epoch = 0

    def batch(self):
        return self.underlying.batch()

    def reset(self):
        self._epoch += 1
        if hasattr(self.underlying, "reset"):
            self.underlying.reset()

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self._epoch))
        for ds in self.underlying:
            feats = self.transform.transform(
                np.asarray(ds.features), rng)
            yield DataSet(feats, ds.labels, ds.features_mask,
                          ds.labels_mask)
