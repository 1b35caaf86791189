"""Bucket ladders for serving and generation (port of ``serving_buckets``,
``prefill_buckets`` and ``suffix_prefill_buckets`` from
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


def prefill_buckets(max_len: int,
                    ladder: Optional[Sequence[int]] = None,
                    min_bucket: int = 8) -> list:
    """The prompt-length ladder of generation: powers of two from
    ``min_bucket`` below ``max_len``, then ``max_len`` itself (pow2 or
    not) as the top bucket, because a weight migration re-prefills a
    sequence's whole history.  An explicit ``ladder`` is used as given
    (sorted, deduplicated, entries above ``max_len`` dropped, ``max_len``
    appended)."""
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    if ladder:
        out = sorted({int(b) for b in ladder if int(b) <= max_len})
        if not out:
            raise ValueError(f"explicit ladder {list(ladder)} has no "
                             f"bucket <= max_len {max_len}")
        if out[-1] != max_len:
            out.append(int(max_len))
        return out
    out = []
    b = max(1, int(min_bucket))
    while b < max_len:
        out.append(b)
        b <<= 1
    return out + [int(max_len)]


def suffix_prefill_buckets(max_len: int, block_size: int,
                           ladder: Optional[Sequence[int]] = None) -> list:
    """The paged engine's ladder over the *unshared suffix* of a prompt:
    a shared-prefix admission prefills only its suffix, so the floor is
    ``min(8, block_size)``; the top stays ``max_len`` (a cold prompt or a
    migration is a suffix with nothing shared)."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    return prefill_buckets(max_len, ladder,
                           min_bucket=min(8, int(block_size)))
