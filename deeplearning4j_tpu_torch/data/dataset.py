"""DataSet and the iterator stack (port of ``data/dataset.py``): the
``DataSet`` and ``MultiDataSet`` containers, the ``DataSetIterator``
protocol, array-backed, synthetic and file-backed iterators, wrappers
(early termination, multiple epochs, sampling, moving windows,
background prefetch, pre-processors, re-batching, reconstruction
targets, joint iteration) and ``save_dataset``/``load_dataset``, which
write the JAX package's bytes (``streaming/codec``).

Iterators yield host-side numpy batches; the network moves each batch to
its device once per step.  Numpy only: the module is a copy of the JAX
package's, which imports no JAX.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional

import numpy as np


def _optional_array(a):
    return None if a is None else np.asarray(a)


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
                            _optional_array(features_mask),
                            _optional_array(labels_mask))
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


class BenchmarkDataSetIterator(DataSetIterator):
    """Fixed synthetic batch repeated N times (reference
    ``datasets/iterator/impl/BenchmarkDataSetIterator.java``) — zero ETL cost,
    used to measure pure compute throughput."""

    def __init__(self, feature_shape, n_classes: int, n_batches: int,
                 seed: int = 42, label_shape=None):
        rng = np.random.default_rng(seed)
        self.features = rng.standard_normal(feature_shape).astype(np.float32)
        batch = feature_shape[0]
        if label_shape is not None:
            self.labels = rng.standard_normal(label_shape).astype(np.float32)
        else:
            cls = rng.integers(0, n_classes, batch)
            self.labels = np.zeros((batch, n_classes), np.float32)
            self.labels[np.arange(batch), cls] = 1.0
        self.n_batches = n_batches

    def batch(self):
        return self.features.shape[0]

    def __iter__(self):
        for _ in range(self.n_batches):
            yield DataSet(self.features, self.labels)


class EarlyTerminationDataSetIterator(DataSetIterator):
    """Cap the number of batches (reference EarlyTerminationDataSetIterator)."""

    def __init__(self, underlying: DataSetIterator, max_batches: int):
        self.underlying = underlying
        self.max_batches = max_batches

    def batch(self):
        return self.underlying.batch()

    def reset(self):
        self.underlying.reset()

    def __iter__(self):
        for i, ds in enumerate(self.underlying):
            if i >= self.max_batches:
                break
            yield ds


class MultipleEpochsIterator(DataSetIterator):
    """Repeat an iterator N epochs (reference MultipleEpochsIterator)."""

    def __init__(self, epochs: int, underlying: DataSetIterator):
        self.epochs = epochs
        self.underlying = underlying

    def batch(self):
        return self.underlying.batch()

    def reset(self):
        self.underlying.reset()

    def __iter__(self):
        for e in range(self.epochs):
            if e > 0:
                self.underlying.reset()
            yield from self.underlying


class SamplingDataSetIterator(DataSetIterator):
    """Sample random batches with replacement (reference
    SamplingDataSetIterator)."""

    def __init__(self, dataset: DataSet, batch_size: int, total_batches: int,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.total_batches = total_batches
        self.seed = seed
        self._epoch = 0

    def batch(self):
        return self.batch_size

    def reset(self):
        self._epoch += 1

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self._epoch)
        n = self.dataset.num_examples()
        for _ in range(self.total_batches):
            sl = rng.integers(0, n, self.batch_size)
            yield DataSet(self.dataset.features[sl], self.dataset.labels[sl])


class MovingWindowDataSetIterator(DataSetIterator):
    """Slide a (rows, cols) window over each image example, emitting one
    sub-image example per window position with the source label (reference
    ``MovingWindowBaseDataSetIterator`` + ``util/MovingWindowMatrix.java``).
    Features [n, h, w] or [n, h, w, c]; stride defaults to the window size
    (non-overlapping, the reference's behavior)."""

    def __init__(self, dataset: DataSet, batch_size: int, window_rows: int,
                 window_cols: int, stride_rows: Optional[int] = None,
                 stride_cols: Optional[int] = None):
        feats = np.asarray(dataset.features)
        if feats.ndim not in (3, 4):
            raise ValueError(
                f"MovingWindow needs image features [n,h,w(,c)], got "
                f"shape {feats.shape}")
        labels = np.asarray(dataset.labels)
        sr = stride_rows or window_rows
        sc = stride_cols or window_cols
        h, w = feats.shape[1], feats.shape[2]
        if window_rows > h or window_cols > w:
            raise ValueError(f"window ({window_rows},{window_cols}) exceeds "
                             f"image ({h},{w})")
        wins, labs = [], []
        for r0 in range(0, h - window_rows + 1, sr):
            for c0 in range(0, w - window_cols + 1, sc):
                wins.append(feats[:, r0:r0 + window_rows,
                                  c0:c0 + window_cols])
                labs.append(labels)
        self._inner = INDArrayDataSetIterator(
            np.concatenate(wins), np.concatenate(labs), batch_size,
            shuffle=False)

    def batch(self):
        return self._inner.batch()

    def reset(self):
        self._inner.reset()

    def __iter__(self):
        return iter(self._inner)


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch (reference
    ``datasets/iterator/AsyncDataSetIterator.java:30`` + MagicQueue).  The
    producer thread fills a bounded queue so host-side ETL overlaps device
    compute — the counterpart of the reference's device-affinity prefetch
    threads.

    Not re-entrant: one live iteration at a time.  Two concurrent
    iterations would race two producer threads over the ONE underlying
    iterator (interleaving/dropping batches nondeterministically), so a
    second ``__iter__`` while the first is still running raises instead."""

    _SENTINEL = object()

    def __init__(self, underlying: DataSetIterator, queue_size: int = 4):
        # AsyncShieldDataSetIterator is defined below in this module; it
        # exists by the time any caller constructs an async wrapper
        if isinstance(underlying, AsyncShieldDataSetIterator):
            raise ValueError(
                "iterator is wrapped in AsyncShieldDataSetIterator — it must "
                "not be prefetched from a background thread")
        self.underlying = underlying
        self.queue_size = queue_size
        self._state_lock = threading.Lock()
        self._active = False

    def batch(self):
        return self.underlying.batch()

    def reset(self):
        self.underlying.reset()

    def __iter__(self):
        with self._state_lock:
            if self._active:
                raise RuntimeError(
                    "AsyncDataSetIterator is already being iterated — a "
                    "concurrent second iteration would race two producer "
                    "threads over one underlying iterator; finish (or "
                    "close) the first iteration, or give each consumer its "
                    "own wrapper")
            self._active = True
        try:
            yield from self._iterate()
        finally:
            with self._state_lock:
                self._active = False

    def _iterate(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.queue_size)
        stop = threading.Event()
        err: List[BaseException] = []

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for ds in self.underlying:
                    if not _put(ds):
                        return  # consumer went away
            except BaseException as e:  # noqa: BLE001 - relayed to consumer
                err.append(e)
            finally:
                _put(self._SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._SENTINEL:
                    break
                yield item
        finally:
            # consumer stopped early (break/exception/GC): release the producer
            stop.set()
            t.join()
        if err:
            raise err[0]


# --------------------------------------------------------------------------
# file-backed DataSets (reference: spark export-then-fitPaths flow,
# datasets/iterator/parallel/ file-split iterators + callbacks/)
# --------------------------------------------------------------------------

def _dataset_to_bytes(ds: DataSet) -> bytes:
    from ..streaming.codec import serialize_dataset
    return serialize_dataset(np.asarray(ds.features), np.asarray(ds.labels),
                             None if ds.features_mask is None
                             else np.asarray(ds.features_mask),
                             None if ds.labels_mask is None
                             else np.asarray(ds.labels_mask))


def _dataset_from_bytes(data: bytes) -> DataSet:
    from ..streaming.codec import deserialize_dataset
    f, l, fm, lm = deserialize_dataset(data)
    return DataSet(f, l, fm, lm)


def save_dataset(ds: DataSet, path) -> None:
    """One DataSet -> one binary file (reference DataSet.save)."""
    with open(path, "wb") as fh:
        fh.write(_dataset_to_bytes(ds))


def load_dataset(path) -> DataSet:
    with open(path, "rb") as fh:
        return _dataset_from_bytes(fh.read())


def export_dataset_batches(iterator, directory, prefix: str = "dataset"
                           ) -> List[str]:
    """Write every batch of an iterator to ``directory`` (the Spark
    export-to-disk step before ``fitPaths``,
    ``spark/data/DataSetExportFunction`` role).  Returns the paths."""
    import os
    os.makedirs(directory, exist_ok=True)
    paths = []
    if hasattr(iterator, "reset"):
        iterator.reset()
    for i, b in enumerate(iterator):
        ds = b if isinstance(b, DataSet) else DataSet(*b) if isinstance(
            b, (tuple, list)) else b
        p = os.path.join(directory, f"{prefix}_{i:06d}.bin")
        save_dataset(ds, p)
        paths.append(p)
    return paths


class DataSetCallback:
    """Hook applied to each loaded DataSet before it reaches the trainer
    (reference ``datasets/iterator/callbacks/DataSetCallback.java`` — e.g.
    device placement or augmentation on the prefetch thread)."""

    def call(self, ds: DataSet) -> DataSet:
        return ds


class FileSplitDataSetIterator(DataSetIterator):
    """Iterate serialized DataSet files; ``worker``/``num_workers`` select
    an interleaved shard of the file list (reference
    ``datasets/iterator/parallel/FileSplitParallelDataSetIterator.java``
    + ``InterleavedDataSetCallback`` role via ``callback``)."""

    def __init__(self, paths_or_dir, callback: Optional[DataSetCallback] = None,
                 worker: int = 0, num_workers: int = 1):
        import os
        if isinstance(paths_or_dir, (str, bytes)) or hasattr(
                paths_or_dir, "is_dir"):
            d = str(paths_or_dir)
            if os.path.isdir(d):
                paths = sorted(os.path.join(d, f) for f in os.listdir(d)
                               if f.endswith(".bin"))
            else:
                paths = [d]
        else:
            paths = [str(p) for p in paths_or_dir]
        if not 0 <= worker < num_workers:
            raise ValueError(f"worker {worker} outside 0..{num_workers - 1}")
        self.paths = paths[worker::num_workers]
        self.callback = callback

    def batch(self):
        return -1

    def reset(self):
        pass

    def __iter__(self) -> Iterator[DataSet]:
        for p in self.paths:
            ds = load_dataset(p)
            if self.callback is not None:
                ds = self.callback.call(ds)
            yield ds


class MultiDataSet:
    """Multi-input/multi-output container (nd4j MultiDataSet role):
    features/labels are LISTS of arrays — the ComputationGraph batch
    shape."""

    def __init__(self, features, labels, features_masks=None,
                 labels_masks=None):
        as_list = lambda v: list(v) if isinstance(v, (list, tuple)) else [v]
        self.features = as_list(features)
        self.labels = as_list(labels)
        self.features_mask = (None if features_masks is None
                              else as_list(features_masks))
        self.labels_mask = (None if labels_masks is None
                            else as_list(labels_masks))

    def num_examples(self) -> int:
        return self.features[0].shape[0]

    def __iter__(self):
        yield self.features
        yield self.labels
        yield self.features_mask
        yield self.labels_mask


# The prefetch loop is payload-agnostic (it queues whatever the underlying
# iterator yields), so the MultiDataSet variant (reference
# ``AsyncMultiDataSetIterator``) is the same class.
AsyncMultiDataSetIterator = AsyncDataSetIterator


class DataSetPreProcessor:
    """``pre_process(DataSet) -> None`` contract (nd4j DataSetPreProcessor;
    mutates the batch in place before the model sees it)."""

    def pre_process(self, ds: DataSet) -> None:
        raise NotImplementedError


class DummyPreProcessor(DataSetPreProcessor):
    """No-op (reference ``DummyPreProcessor.java``)."""

    def pre_process(self, ds: DataSet) -> None:
        pass


class CombinedPreProcessor(DataSetPreProcessor):
    """Apply several preprocessors in order (reference
    ``CombinedPreProcessor.java`` builder; also serves the
    CombinedMultiDataSetPreProcessor role — members just need
    ``pre_process``)."""

    def __init__(self, *pre_processors: DataSetPreProcessor):
        self.pre_processors = list(pre_processors)

    def add_pre_processor(self, pp: DataSetPreProcessor) -> "CombinedPreProcessor":
        self.pre_processors.append(pp)
        return self

    def pre_process(self, ds: DataSet) -> None:
        for pp in self.pre_processors:
            pp.pre_process(ds)


class PreProcessedDataSetIterator(DataSetIterator):
    """Wrap an iterator, applying a DataSetPreProcessor to every batch (the
    reference attaches this via ``DataSetIterator.setPreProcessor``)."""

    def __init__(self, iterator: DataSetIterator,
                 pre_processor: DataSetPreProcessor):
        self.iterator = iterator
        self.pre_processor = pre_processor

    def reset(self):
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()

    def batch(self):
        return self.iterator.batch()

    def __iter__(self):
        for ds in self.iterator:
            self.pre_processor.pre_process(ds)
            yield ds


class AsyncShieldDataSetIterator(DataSetIterator):
    """Marker wrapper that prevents async prefetching of the underlying
    iterator (reference ``AsyncShieldDataSetIterator.java``: used when
    batches must be produced on the training thread, e.g. the source is not
    thread-safe).  ``AsyncDataSetIterator`` refuses to wrap it."""

    def __init__(self, iterator: DataSetIterator):
        self.iterator = iterator

    def reset(self):
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()

    def batch(self):
        return self.iterator.batch()

    def __iter__(self):
        return iter(self.iterator)


#: reference has a separate AsyncShieldMultiDataSetIterator; MultiDataSet
#: batches flow through the same wrapper here
AsyncShieldMultiDataSetIterator = AsyncShieldDataSetIterator


class _PairsDataSetIterator(DataSetIterator):
    """Batched iteration over an iterable of (features, labels) pairs."""

    _dtype = np.float32

    def __init__(self, pairs, batch_size: int):
        self._pairs = list(pairs)
        self.batch_size = batch_size

    def batch(self):
        return self.batch_size

    def __iter__(self):
        for i in range(0, len(self._pairs), self.batch_size):
            chunk = self._pairs[i:i + self.batch_size]
            f = np.stack([np.asarray(p[0], dtype=self._dtype) for p in chunk])
            l = np.stack([np.asarray(p[1], dtype=self._dtype) for p in chunk])
            yield DataSet(f, l)


class FloatsDataSetIterator(_PairsDataSetIterator):
    """(float32) reference ``FloatsDataSetIterator.java``."""
    _dtype = np.float32


class DoublesDataSetIterator(_PairsDataSetIterator):
    """(float64) reference ``DoublesDataSetIterator.java``."""
    _dtype = np.float64


class IteratorDataSetIterator(DataSetIterator):
    """Re-batch an iterator of DataSets to a target minibatch size
    (reference ``IteratorDataSetIterator.java``: splits/joins incoming
    examples so every yielded batch has ``batch_size`` rows; also serves the
    IteratorMultiDataSetIterator role for single-input sets)."""

    def __init__(self, iterator, batch_size: int):
        self._source = iterator
        self.batch_size = batch_size

    def batch(self):
        return self.batch_size

    def reset(self):
        if hasattr(self._source, "reset"):
            self._source.reset()

    def __iter__(self):
        # four parallel buffers: features, labels, and the optional masks
        # (masks must survive re-batching — dropping them would silently
        # un-mask padded RNN timesteps).  Mask presence must be consistent
        # across the stream: flipping mid-stream would emit some re-batched
        # sets with masks and some without, so mixing raises instead.
        bufs = [[], [], [], []]
        have = 0
        has_mask = [None, None]   # None = undecided yet

        def _emit(lo, hi):
            cat = [np.concatenate(b)[lo:hi] if b else None for b in bufs]
            return DataSet(cat[0], cat[1],
                           cat[2] if has_mask[0] else None,
                           cat[3] if has_mask[1] else None)

        def _trim(b, keep):
            return [np.concatenate(b)[keep:]] if b else []

        for ds in self._source:
            parts = [np.asarray(ds.features), np.asarray(ds.labels),
                     ds.features_mask, ds.labels_mask]
            for j in range(2):
                present = parts[2 + j] is not None
                if has_mask[j] is None:
                    has_mask[j] = present
                elif has_mask[j] != present:
                    which = "features" if j == 0 else "labels"
                    raise ValueError(
                        f"IteratorDataSetIterator: inconsistent {which}_mask "
                        "presence across incoming batches (some batches "
                        "carry a mask, others do not)")
                if present:
                    bufs[2 + j].append(np.asarray(parts[2 + j]))
            bufs[0].append(parts[0])
            bufs[1].append(parts[1])
            have += parts[0].shape[0]
            while have >= self.batch_size:
                yield _emit(0, self.batch_size)
                bufs = [_trim(b, self.batch_size) for b in bufs]
                have = bufs[0][0].shape[0] if bufs[0] else 0
        if have:
            yield _emit(0, None)


class MultiDataSetWrapperIterator(DataSetIterator):
    """Adapt a single-input/single-output MultiDataSet iterator to the
    DataSet protocol (reference ``MultiDataSetWrapperIterator.java``)."""

    def __init__(self, iterator):
        self.iterator = iterator

    def reset(self):
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()

    def batch(self):
        return self.iterator.batch()

    @staticmethod
    def _single(value, kind: str, required: bool = False):
        if isinstance(value, (list, tuple)):
            if len(value) != 1:
                if not value and not required:
                    return None
                raise ValueError(
                    f"MultiDataSetWrapperIterator needs exactly one {kind} "
                    f"array, got {len(value)}")
            return value[0]
        return value

    def __iter__(self):
        for mds in self.iterator:
            yield DataSet(
                self._single(mds.features, "input", required=True),
                self._single(mds.labels, "output", required=True),
                self._single(getattr(mds, "features_mask", None),
                             "input mask"),
                self._single(getattr(mds, "labels_mask", None),
                             "label mask"))


class ReconstructionDataSetIterator(DataSetIterator):
    """labels := features (autoencoder targets; reference
    ``ReconstructionDataSetIterator.java``)."""

    def __init__(self, iterator: DataSetIterator):
        self.iterator = iterator

    def reset(self):
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()

    def batch(self):
        return self.iterator.batch()

    def __iter__(self):
        for ds in self.iterator:
            yield DataSet(ds.features, ds.features,
                          ds.features_mask, ds.features_mask)


class JointParallelDataSetIterator(DataSetIterator):
    """Interleave several source iterators round-robin (reference
    ``parallel/JointParallelDataSetIterator.java`` with ``InequalityHandling``
    for sources of different length: ``stop`` ends the epoch when any source
    is exhausted, ``pass`` skips exhausted sources, ``reset`` restarts an
    exhausted source — the reference's STOP_EVERYONE / PASS_NULL /
    RESET per-source policy enums)."""

    def __init__(self, *iterators, inequality: str = "pass"):
        if inequality not in ("stop", "pass", "reset"):
            raise ValueError(f"unknown inequality handling '{inequality}'; "
                             "expected stop|pass|reset")
        self.iterators = list(iterators)
        self.inequality = inequality

    def reset(self):
        for it in self.iterators:
            if hasattr(it, "reset"):
                it.reset()

    def batch(self):
        return self.iterators[0].batch()

    def __iter__(self):
        actives = [iter(it) for it in self.iterators]
        exhausted = [False] * len(actives)   # stop yielding from this source
        drained = [False] * len(actives)     # has run dry at least once
        while True:
            progressed = False
            for i, src in enumerate(actives):
                if exhausted[i]:
                    continue
                try:
                    yield next(src)
                    progressed = True
                except StopIteration:
                    drained[i] = True
                    if self.inequality == "stop":
                        return
                    if self.inequality == "reset":
                        # epoch ends once EVERY source has run dry once
                        # (reference RESET policy) — until then, restart
                        if all(drained):
                            return
                        if hasattr(self.iterators[i], "reset"):
                            self.iterators[i].reset()
                        actives[i] = iter(self.iterators[i])
                        try:
                            yield next(actives[i])
                            progressed = True
                            continue
                        except StopIteration:
                            pass
                    exhausted[i] = True
            if all(exhausted) or not progressed:
                return


class FileSplitParallelDataSetIterator(JointParallelDataSetIterator):
    """Joint-parallel iteration over saved dataset files matching a pattern
    (reference ``parallel/FileSplitParallelDataSetIterator.java``: one
    FileSplitDataSetIterator per shard, interleaved)."""

    def __init__(self, directory, n_shards: int = 2,
                 inequality: str = "pass"):
        # FileSplitDataSetIterator already owns the interleaved sharding
        # (worker/num_workers); this class just joins the shards
        shards = [FileSplitDataSetIterator(directory, worker=i,
                                           num_workers=n_shards)
                  for i in range(n_shards)]
        shards = [s for s in shards if s.paths]
        if not shards:
            raise FileNotFoundError(f"no .bin dataset files in {directory}")
        super().__init__(*shards, inequality=inequality)
