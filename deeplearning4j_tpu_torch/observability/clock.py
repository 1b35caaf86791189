"""Clock helpers (port of ``observability/clock.py``): ``monotonic_s`` for
intervals, ``wall_s`` for timestamps only."""
from __future__ import annotations

import time

__all__ = ["monotonic_s", "wall_s"]


def monotonic_s() -> float:
    """Monotonic seconds for interval measurement (never steps backwards)."""
    return time.perf_counter()


def wall_s() -> float:
    """Wall-clock seconds since the epoch: timestamps, never intervals."""
    return time.time()
