"""Ecosystem dataset interop (port of ``data/interop.py``).

Reference ``dl4j-spark``'s ``MLLibUtil`` (RDD<LabeledPoint> ↔ DataSet
adapters) — the Python-ecosystem counterpart adapts PyTorch datasets/
dataloaders and (features, labels) pair iterables into our
DataSetIterator protocol, and exposes our iterators back as torch
datasets.  The batches stay the JAX package's: host numpy, NCHW images
turned NHWC, integer labels one-hot.  torch is imported inside the calls
that need it, so the ``data`` package stays numpy-only at import (the
ETL workers of ``data/pipeline`` import it and never load torch).
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from .dataset import DataSet, DataSetIterator

__all__ = ["TorchDataSetIterator", "from_torch", "as_torch_dataset"]


def _to_numpy(t):
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


class TorchDataSetIterator(DataSetIterator):
    """Wrap a torch ``DataLoader`` (or any iterable of (x, y) pairs) as a
    DataSetIterator.  One-hot encodes integer class labels when
    ``n_classes`` is given (torch datasets yield class indices; our output
    layers take one-hot)."""

    def __init__(self, loader, n_classes: Optional[int] = None):
        self.loader = loader
        self.n_classes = n_classes

    def batch(self) -> int:
        return getattr(self.loader, "batch_size", -1) or -1

    def reset(self) -> None:
        pass  # DataLoader re-iterates from the top

    def _labels(self, y: np.ndarray) -> np.ndarray:
        if self.n_classes is not None and y.ndim <= 1:
            return np.eye(self.n_classes, dtype=np.float32)[
                y.astype(np.int64).reshape(-1)]
        return y.astype(np.float32)

    def __iter__(self) -> Iterator[DataSet]:
        for batch in self.loader:
            if isinstance(batch, (tuple, list)) and len(batch) >= 2:
                x, y = batch[0], batch[1]
            else:
                raise ValueError(
                    "expected (features, labels) batches from the loader")
            x = _to_numpy(x).astype(np.float32)
            if x.ndim == 4 and x.shape[1] in (1, 3) and \
                    x.shape[1] < x.shape[-1]:
                x = np.transpose(x, (0, 2, 3, 1))  # NCHW (torch) -> NHWC
            yield DataSet(x, self._labels(_to_numpy(y)))


def from_torch(dataset_or_loader, batch_size: int = 32,
               n_classes: Optional[int] = None, shuffle: bool = False
               ) -> TorchDataSetIterator:
    """torch Dataset or DataLoader -> DataSetIterator (builds a DataLoader
    when given a bare Dataset)."""
    if hasattr(dataset_or_loader, "__getitem__") and not hasattr(
            dataset_or_loader, "batch_size"):
        import torch.utils.data as tud
        loader = tud.DataLoader(dataset_or_loader, batch_size=batch_size,
                                shuffle=shuffle)
    else:
        loader = dataset_or_loader
    return TorchDataSetIterator(loader, n_classes=n_classes)


def as_torch_dataset(iterator: DataSetIterator):
    """Our DataSetIterator -> torch IterableDataset (features/labels as
    torch tensors), so torch tooling can consume our pipelines."""
    import torch
    import torch.utils.data as tud

    class _Wrapped(tud.IterableDataset):
        def __iter__(self):
            if hasattr(iterator, "reset"):
                iterator.reset()
            for ds in iterator:
                yield (torch.from_numpy(np.asarray(ds.features)),
                       torch.from_numpy(np.asarray(ds.labels)))

    return _Wrapped()
