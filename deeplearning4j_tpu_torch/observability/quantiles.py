"""Sliding-window quantile estimation for live SLO tracking (port of
``observability/quantiles.py``).

Prometheus histograms answer "what was the p99 over the scrape interval"
*after* the scrape; an admission controller needs the answer *now*, from
the most recent requests only, without a registry round-trip.
``LatencyWindow`` is that primitive: a fixed-size ring of the last N
observations with exact (sorted-copy) quantile reads.  Exactness over a
bounded window beats a streaming sketch here — serving windows are small
(hundreds of requests), reads are rare (health probes, admission
decisions), and an approximate p99 that under-reads during a latency
spike is precisely the failure an SLO gate exists to catch.

Thread-safe: request threads observe, the health/admission path reads.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["LatencyWindow", "bucket_quantile"]


def bucket_quantile(cumulative: Sequence[Tuple[float, int]],
                    q: float) -> Optional[float]:
    """Nearest-rank quantile from cumulative histogram buckets
    ``[(upper_bound, cumulative_count), ...]`` (the
    ``Histogram.cumulative_buckets()`` shape, ending at ``(+Inf, n)``).

    Returns the upper bound of the bucket containing the rank — an upper
    estimate whose error is bounded by the bucket width, the same answer
    Prometheus' ``histogram_quantile`` gives at the bucket edge.  The
    ``+Inf`` bucket clamps to the largest finite bound (there is no
    meaningful upper edge beyond it).  None while the histogram is empty.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    if not cumulative:
        return None
    total = cumulative[-1][1]
    if total <= 0:
        return None
    rank = max(1, math.ceil(q * total))
    largest_finite = None
    for bound, count in cumulative:
        if bound != float("inf"):
            largest_finite = bound
        if count >= rank:
            return bound if bound != float("inf") else largest_finite
    return largest_finite


class LatencyWindow:
    """Fixed-size ring buffer of float observations with quantile reads.

    ``observe`` is O(1) under a lock; ``quantile`` copies and sorts the
    live window (O(n log n), n = window size) — cheap at the window sizes
    serving uses and only paid on health/admission reads.
    """

    def __init__(self, size: int = 512):
        if size <= 0:
            raise ValueError(f"window size must be positive, got {size}")
        self.size = int(size)
        self._ring: List[float] = [0.0] * self.size
        self._n = 0          # total observations ever
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self._ring[self._n % self.size] = float(value)
            self._n += 1

    def __len__(self) -> int:
        return min(self._n, self.size)

    @property
    def count(self) -> int:
        """Total observations ever (not just the live window)."""
        return self._n

    def _live(self) -> List[float]:
        with self._lock:
            n = min(self._n, self.size)
            return self._ring[:n]

    def quantile(self, q: float) -> Optional[float]:
        """Exact q-quantile (nearest-rank) of the live window; None while
        empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        live = sorted(self._live())
        if not live:
            return None
        idx = min(len(live) - 1, int(q * len(live)))
        return live[idx]

    def snapshot(self) -> Dict[str, Optional[float]]:
        """One consistent read for health payloads: count + p50/p99."""
        live = sorted(self._live())
        if not live:
            return {"count": self._n, "p50": None, "p99": None}
        return {
            "count": self._n,
            "p50": live[min(len(live) - 1, int(0.50 * len(live)))],
            "p99": live[min(len(live) - 1, int(0.99 * len(live)))],
        }
