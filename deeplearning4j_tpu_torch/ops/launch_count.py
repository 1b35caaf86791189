"""The kernel wrappers' launch counts, and what a CUDA-graph capture does
to them.

Each wrapper adds to a plain dict where it launches its kernel
(``count``).  A capture runs no kernel, though the wrapper's Python
runs: while a stream is being captured (``recording``), the counts of
launches made on it, from any thread (autograd runs the backward on a
thread of its own, on the forward's stream), go to the capture's record
instead, and each replay of the graph adds the record (``add``).  One
lock guards every counter: replicas of a training master launch and
replay from several threads.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Dict, List, Tuple

Record = List[Tuple[dict, Any, int]]

_lock = threading.Lock()
# the record of each stream being captured, by its CUDA handle
_records: Dict[int, Record] = {}


def count(counter: dict, key, n: int = 1) -> None:
    """``counter[key] += n``, or into the record of the capture of the
    current stream."""
    if _records:
        import torch
        rec = _records.get(torch.cuda.current_stream().cuda_stream)
        if rec is not None:
            rec.append((counter, key, n))
            return
    with _lock:
        counter[key] = counter.get(key, 0) + n


@contextmanager
def recording(stream):
    """The counts of launches on ``stream`` while inside, as the record
    this yields."""
    rec: Record = []
    _records[stream.cuda_stream] = rec
    try:
        yield rec
    finally:
        _records.pop(stream.cuda_stream, None)


def add(record: Record) -> None:
    """One replay's counts."""
    with _lock:
        for counter, key, n in record:
            counter[key] = counter.get(key, 0) + n
