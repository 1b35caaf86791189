"""Record readers + adapters (port of ``data/records.py``: numpy only,
the same batches from the same records; the DataVec bridge role of the
reference's ``datasets/datavec/RecordReaderDataSetIterator.java`` and
``SequenceRecordReaderDataSetIterator.java``).

Record readers yield lists of float records; the iterators assemble them
into DataSets (classification one-hot, regression passthrough, or sequence
tensors with masking for ragged lengths).  ``CSVRecordReader`` parses a
plain numeric file in one call of the native ``parse_csv``
(``utils/native``) and falls back to the ``csv`` module's reader, which
the JAX package uses for every file, where that strict grammar refuses
the text (quoted fields, ragged rows).
"""
from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .dataset import DataSet, DataSetIterator

__all__ = ["CSVRecordReader", "CSVSequenceRecordReader",
           "CollectionRecordReader", "RecordReaderDataSetIterator",
           "SequenceRecordReaderDataSetIterator"]


class RecordReader:
    """Iterable of per-example records (list of floats)."""

    def __iter__(self) -> Iterator[List[float]]:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class CSVRecordReader(RecordReader):
    """One record per CSV line (reference DataVec ``CSVRecordReader``)."""

    def __init__(self, path: str, skip_lines: int = 0, delimiter: str = ","):
        self.path = path
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def _parsed(self) -> Optional[np.ndarray]:
        """The records as one [rows, cols] f32 matrix through
        ``parse_csv``, or None where its grammar refuses the file."""
        from ..utils.native import parse_csv
        with open(self.path, "rb") as fh:
            text = fh.read()
        if b'"' in text or len(self.delimiter) != 1:
            return None
        for _ in range(self.skip_lines):
            cut = text.find(b"\n")
            text = b"" if cut < 0 else text[cut + 1:]
        try:
            rows = parse_csv(text, self.delimiter)
        except ValueError:
            return None
        return rows if rows.ndim == 2 else None

    def __iter__(self):
        rows = self._parsed()
        if rows is not None:
            for r in rows:
                yield r.tolist()
            return
        with open(self.path, newline="") as fh:
            reader = csv.reader(fh, delimiter=self.delimiter)
            for i, row in enumerate(reader):
                if i < self.skip_lines or not row:
                    continue
                yield [float(v) for v in row]


class CollectionRecordReader(RecordReader):
    """In-memory records (reference ``CollectionRecordReader``) — test tier."""

    def __init__(self, records: Sequence[Sequence[float]]):
        self.records = [list(map(float, r)) for r in records]

    def __iter__(self):
        return iter([list(r) for r in self.records])


class CSVSequenceRecordReader(RecordReader):
    """One sequence per FILE in a directory (reference DataVec
    ``CSVSequenceRecordReader``); yields [T, n_cols] float arrays."""

    def __init__(self, directory: str, skip_lines: int = 0,
                 delimiter: str = ",", glob: str = "*.csv"):
        self.directory = directory
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self.glob = glob

    def __iter__(self):
        for f in sorted(Path(self.directory).glob(self.glob)):
            rows = []
            with open(f, newline="") as fh:
                for i, row in enumerate(csv.reader(fh, delimiter=self.delimiter)):
                    if i < self.skip_lines or not row:
                        continue
                    rows.append([float(v) for v in row])
            yield np.asarray(rows, dtype=np.float32)


class RecordReaderDataSetIterator(DataSetIterator):
    """records -> DataSets (reference
    ``RecordReaderDataSetIterator.java``): ``label_index`` column becomes the
    one-hot label (classification, ``n_classes`` set) or the regression
    target range (``regression=True``, ``label_index_to`` inclusive)."""

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: int = -1, n_classes: Optional[int] = None,
                 regression: bool = False,
                 label_index_to: Optional[int] = None):
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.n_classes = n_classes
        self.regression = regression
        self.label_index_to = label_index_to
        if not regression and n_classes is None:
            raise ValueError("classification needs n_classes "
                             "(or pass regression=True)")

    def batch(self) -> int:
        return self.batch_size

    def reset(self):
        self.reader.reset()

    def _split(self, rec: List[float]):
        li = self.label_index if self.label_index >= 0 else len(rec) + self.label_index
        if self.regression:
            hi = (self.label_index_to if self.label_index_to is not None
                  else li)
            hi = hi if hi >= 0 else len(rec) + hi
            label = rec[li:hi + 1]
            feats = rec[:li] + rec[hi + 1:]
        else:
            label = [rec[li]]
            feats = rec[:li] + rec[li + 1:]
        return feats, label

    def __iter__(self):
        feats, labels = [], []
        for rec in self.reader:
            f, l = self._split(rec)
            feats.append(f)
            labels.append(l)
            if len(feats) == self.batch_size:
                yield self._make(feats, labels)
                feats, labels = [], []
        if feats:
            yield self._make(feats, labels)

    def _make(self, feats, labels):
        x = np.asarray(feats, dtype=np.float32)
        if self.regression:
            y = np.asarray(labels, dtype=np.float32)
        else:
            idx = np.asarray(labels, dtype=np.int64).reshape(-1)
            y = np.eye(self.n_classes, dtype=np.float32)[idx]
        return DataSet(x, y)


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Per-file sequences -> padded+masked RNN DataSets (reference
    ``SequenceRecordReaderDataSetIterator`` ALIGN_END=False semantics:
    sequences padded at the END, mask marks valid steps)."""

    def __init__(self, features_reader: CSVSequenceRecordReader,
                 labels_reader: Optional[CSVSequenceRecordReader],
                 batch_size: int, n_classes: Optional[int] = None,
                 regression: bool = False, label_index: int = -1):
        self.features_reader = features_reader
        self.labels_reader = labels_reader
        self.batch_size = batch_size
        self.n_classes = n_classes
        self.regression = regression
        self.label_index = label_index
        if not regression and n_classes is None:
            raise ValueError("classification needs n_classes "
                             "(or pass regression=True)")

    def batch(self) -> int:
        return self.batch_size

    def _pairs(self):
        if self.labels_reader is not None:
            yield from zip(iter(self.features_reader),
                           iter(self.labels_reader))
        else:  # label column inside the same sequence file
            for seq in self.features_reader:
                li = (self.label_index if self.label_index >= 0
                      else seq.shape[1] + self.label_index)
                lab = seq[:, li:li + 1]
                feat = np.delete(seq, li, axis=1)
                yield feat, lab

    def __iter__(self):
        buf = []
        for pair in self._pairs():
            buf.append(pair)
            if len(buf) == self.batch_size:
                yield self._make(buf)
                buf = []
        if buf:
            yield self._make(buf)

    def _make(self, pairs):
        t_max = max(f.shape[0] for f, _ in pairs)
        n = len(pairs)
        nf = pairs[0][0].shape[1]
        x = np.zeros((n, t_max, nf), np.float32)
        mask = np.zeros((n, t_max), np.float32)
        if self.regression:
            nl = pairs[0][1].shape[1]
            y = np.zeros((n, t_max, nl), np.float32)
        else:
            y = np.zeros((n, t_max, self.n_classes), np.float32)
        for i, (f, l) in enumerate(pairs):
            t = f.shape[0]
            x[i, :t] = f
            mask[i, :t] = 1.0
            if self.regression:
                y[i, :t] = l
            else:
                idx = np.asarray(l, dtype=np.int64).reshape(-1)
                y[i, :t] = np.eye(self.n_classes, dtype=np.float32)[idx]
        return DataSet(x, y, features_mask=mask, labels_mask=mask)


class RecordReaderMultiDataSetIterator:
    """Multiple record readers -> MultiDataSet batches (reference
    ``RecordReaderMultiDataSetIterator.java`` builder: named readers with
    per-reader input/output column selections).

    Usage::

        it = (RecordReaderMultiDataSetIterator.builder(batch_size=32)
              .add_reader("csv", reader)
              .add_input("csv", 0, 3)            # columns 0..3 inclusive
              .add_output_one_hot("csv", 4, 3)   # column 4, 3 classes
              .build())
    """

    class Builder:
        def __init__(self, batch_size: int):
            self.batch_size = batch_size
            self.readers: Dict[str, RecordReader] = {}
            self.inputs: List[tuple] = []    # (reader, lo, hi)
            self.outputs: List[tuple] = []   # (reader, lo, hi, n_classes)

        def add_reader(self, name: str, reader: RecordReader):
            self.readers[name] = reader
            return self

        def add_input(self, reader: str, col_from: int, col_to: int):
            self.inputs.append((reader, col_from, col_to, None))
            return self

        def add_output(self, reader: str, col_from: int, col_to: int):
            self.outputs.append((reader, col_from, col_to, None))
            return self

        def add_output_one_hot(self, reader: str, col: int, n_classes: int):
            self.outputs.append((reader, col, col, n_classes))
            return self

        def build(self) -> "RecordReaderMultiDataSetIterator":
            if not self.inputs or not self.outputs:
                raise ValueError("need at least one input and one output")
            missing = {r for r, *_ in self.inputs + self.outputs} \
                - set(self.readers)
            if missing:
                raise ValueError(f"selections reference unknown readers "
                                 f"{sorted(missing)}")
            return RecordReaderMultiDataSetIterator(self)

    @staticmethod
    def builder(batch_size: int) -> "RecordReaderMultiDataSetIterator.Builder":
        return RecordReaderMultiDataSetIterator.Builder(batch_size)

    def __init__(self, b: "RecordReaderMultiDataSetIterator.Builder"):
        self._b = b

    def batch(self) -> int:
        return self._b.batch_size

    def reset(self) -> None:
        for r in self._b.readers.values():
            r.reset()

    @staticmethod
    def _slice(rows: np.ndarray, lo: int, hi: int,
               n_classes: Optional[int]) -> np.ndarray:
        cols = rows[:, lo:hi + 1].astype(np.float32)
        if n_classes is not None:
            return np.eye(n_classes, dtype=np.float32)[
                cols[:, 0].astype(np.int64)]
        return cols

    def __iter__(self):
        from .dataset import MultiDataSet
        b = self._b
        self.reset()
        streams = {name: iter(r) for name, r in b.readers.items()}
        while True:
            rows: Dict[str, List] = {}
            done = False
            for _ in range(b.batch_size):
                record = {}
                for name, st in streams.items():
                    nxt = next(st, None)
                    if nxt is None:
                        done = True
                        break
                    record[name] = nxt
                if done:
                    break
                for name, vals in record.items():
                    rows.setdefault(name, []).append(vals)
            if not rows:
                return
            mats = {name: np.asarray(v, np.float32)
                    for name, v in rows.items()}
            feats = [self._slice(mats[r], lo, hi, nc)
                     for r, lo, hi, nc in b.inputs]
            labels = [self._slice(mats[r], lo, hi, nc)
                      for r, lo, hi, nc in b.outputs]
            yield MultiDataSet(feats, labels)
            if done:
                return
