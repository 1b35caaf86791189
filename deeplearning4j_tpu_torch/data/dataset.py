"""DataSet and array iterators (port of the part of ``data/dataset.py``
that ``fit`` consumes): ``DataSet``, the ``DataSetIterator`` protocol,
``INDArrayDataSetIterator`` and ``ExistingDataSetIterator``.

Iterators yield host-side numpy batches; the network moves each batch to
its device once per step.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np


class DataSet:
    """features/labels (+ masks) container (nd4j DataSet role)."""

    def __init__(self, features, labels, features_mask=None,
                 labels_mask=None):
        self.features = features
        self.labels = labels
        self.features_mask = features_mask
        self.labels_mask = labels_mask

    def num_examples(self) -> int:
        return self.features.shape[0]

    def _rows(self, sl) -> "DataSet":
        return DataSet(
            self.features[sl], self.labels[sl],
            None if self.features_mask is None else self.features_mask[sl],
            None if self.labels_mask is None else self.labels_mask[sl])

    def split_test_and_train(self, n_train: int):
        return self._rows(slice(None, n_train)), \
            self._rows(slice(n_train, None))

    def shuffle(self, seed: Optional[int] = None) -> None:
        idx = np.random.default_rng(seed).permutation(self.num_examples())
        shuffled = self._rows(idx)
        self.features, self.labels = shuffled.features, shuffled.labels
        self.features_mask = shuffled.features_mask
        self.labels_mask = shuffled.labels_mask

    def __iter__(self):
        yield self.features
        yield self.labels
        yield self.features_mask
        yield self.labels_mask


class DataSetIterator:
    """Iterator protocol (reference DataSetIterator): an iterable of
    DataSet with ``reset()``."""

    def reset(self) -> None:
        pass

    def batch(self) -> int:
        raise NotImplementedError

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError


class INDArrayDataSetIterator(DataSetIterator):
    """Batches over in-memory arrays (reference INDArrayDataSetIterator).
    The last batch is ragged unless ``drop_last``; ``shuffle`` permutes
    with ``seed + epoch``, the epoch counting ``reset()`` calls."""

    def __init__(self, features, labels, batch_size: int,
                 features_mask=None, labels_mask=None, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False):
        self.data = DataSet(np.asarray(features), np.asarray(labels),
                            features_mask, labels_mask)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def batch(self):
        return self.batch_size

    def reset(self):
        self._epoch += 1

    def __iter__(self):
        n = self.data.num_examples()
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        stop = n - (n % self.batch_size) if self.drop_last else n
        for i in range(0, stop, self.batch_size):
            yield self.data._rows(idx[i:i + self.batch_size])


class ExistingDataSetIterator(DataSetIterator):
    """Wrap a list of DataSets (reference ExistingDataSetIterator)."""

    def __init__(self, datasets: List[DataSet]):
        self.datasets = list(datasets)

    def batch(self):
        return self.datasets[0].num_examples() if self.datasets else 0

    def __iter__(self):
        return iter(self.datasets)
