"""Batch-bucket ladder for serving (port of ``serving_buckets`` from
``data/shapes.py``)."""
from __future__ import annotations

from typing import Optional, Sequence


def serving_buckets(max_batch: int,
                    ladder: Optional[Sequence[int]] = None) -> list:
    """Powers of two below ``max_batch``, then ``max_batch`` itself as the
    top bucket.  An explicit ``ladder`` is used as given (sorted,
    deduplicated)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if ladder:
        return sorted({int(b) for b in ladder})
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b <<= 1
    return out + [int(max_batch)]
