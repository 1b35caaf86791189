"""Sliding-window quantiles for live SLO reads (port of ``LatencyWindow``
from ``observability/quantiles.py``): a fixed ring of the last N
observations with exact nearest-rank quantiles.  Thread-safe."""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

__all__ = ["LatencyWindow"]


class LatencyWindow:
    """Fixed-size ring buffer of float observations with quantile reads:
    ``observe`` is O(1) under a lock, ``quantile`` sorts a copy."""

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
            return self._ring[:min(self._n, self.size)]

    def quantile(self, q: float) -> Optional[float]:
        """Exact q-quantile (nearest-rank) of the live window; None while
        empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        live = sorted(self._live())
        if not live:
            return None
        return live[min(len(live) - 1, int(q * len(live)))]

    def snapshot(self) -> Dict[str, Optional[float]]:
        """One consistent read: count and p50/p99."""
        live = sorted(self._live())
        if not live:
            return {"count": self._n, "p50": None, "p99": None}
        return {"count": self._n,
                "p50": live[min(len(live) - 1, int(0.50 * len(live)))],
                "p99": live[min(len(live) - 1, int(0.99 * len(live)))]}
