"""Structured JSONL event log for offline analysis (port of
``observability/events.py``).

One JSON object per line: ``{"ts": <wall seconds>, "type": <str>, ...}``.
Writers are thread-safe (one lock around the write; lines stay atomic)
and the module-level sink is a no-op until :func:`configure_event_log`
points it somewhere — the same off-by-default posture as the registry
and tracer.  Consumers are anything that reads JSONL: pandas, jq, or
``tools/trace_categorize.py``-style scripts.

**Rotation**: long runs emit events forever, so an unbounded JSONL file
is a disk-filler.  With ``max_bytes`` set, a write that pushes the
active file past the limit rotates it: ``events.jsonl`` becomes
``events.jsonl.1`` (existing ``.1`` shifts to ``.2``, and so on up to
``max_files`` total segments — the oldest falls off the end).  Every
shift is one ``os.replace`` (atomic on POSIX), so a crash mid-rotation
leaves whole segments, never spliced ones.  :meth:`EventLog.read`
iterates records across all surviving segments oldest-first, so
consumers see one continuous stream regardless of how many times the
log rotated underneath them.

Every :func:`emit_event` also lands in the process flight recorder's
``events`` ring (when one is installed) — the JSONL file is the durable
archive, the ring is the crash-time window a dump preserves.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Iterator, List, Optional

from .clock import wall_s
from .recorder import get_flight_recorder

__all__ = ["EventLog", "configure_event_log", "get_event_log", "emit_event"]


class EventLog:
    """Append-only JSONL writer with optional size-based rotation.

    ``max_bytes``: rotate when the active file reaches this size (None =
    never, the historical behavior).  ``max_files``: total segments kept
    including the active one (minimum 1; 1 means rotation truncates)."""

    def __init__(self, path: str, append: bool = True,
                 max_bytes: Optional[int] = None, max_files: int = 5):
        self.path = str(path)
        self.max_bytes = None if not max_bytes else int(max_bytes)
        self.max_files = max(1, int(max_files))
        self._lock = threading.Lock()
        self._fh = open(self.path, "a" if append else "w", encoding="utf-8")

    def emit(self, type: str, **fields: Any) -> None:
        record: Dict[str, Any] = {"ts": wall_s(), "type": type}
        record.update(fields)
        line = json.dumps(record, default=str)
        with self._lock:
            if self._fh.closed:
                return
            self._fh.write(line + "\n")
            self._fh.flush()
            if self.max_bytes is not None and \
                    self._fh.tell() >= self.max_bytes:
                self._rotate_locked()

    def _rotate_locked(self) -> None:
        """Shift segments up one index and start a fresh active file.
        Caller holds ``self._lock``.  Each shift is an atomic
        ``os.replace``; the segment at ``max_files - 1`` is overwritten
        by its younger neighbor, which drops the oldest data."""
        self._fh.close()
        if self.max_files > 1:
            for i in range(self.max_files - 2, 0, -1):
                src = f"{self.path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{i + 1}")
            os.replace(self.path, f"{self.path}.1")
        self._fh = open(self.path, "w", encoding="utf-8")

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @staticmethod
    def segments(path: str) -> List[str]:
        """Existing segment paths oldest-first: ``path.N`` … ``path.1``,
        then the active ``path``."""
        path = str(path)
        directory = os.path.dirname(os.path.abspath(path)) or "."
        base = os.path.basename(path)
        indices = []
        try:
            names = os.listdir(directory)
        except OSError:
            names = []
        for name in names:
            if name.startswith(base + "."):
                suffix = name[len(base) + 1:]
                if suffix.isdigit():
                    indices.append(int(suffix))
        out = [f"{path}.{i}" for i in sorted(indices, reverse=True)]
        if os.path.exists(path):
            out.append(path)
        return out

    @staticmethod
    def read(path: str) -> Iterator[Dict[str, Any]]:
        """Iterate the records of a JSONL event file, spanning rotated
        segments in order (oldest first, active file last)."""
        for segment in EventLog.segments(path):
            with open(segment, "r", encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if line:
                        yield json.loads(line)


_default: Optional[EventLog] = None
_lock = threading.Lock()


def configure_event_log(path: Optional[str],
                        max_bytes: Optional[int] = None,
                        max_files: int = 5) -> Optional[EventLog]:
    """Point the process-global event sink at ``path`` (None closes and
    disables it).  Returns the active log."""
    global _default
    with _lock:
        if _default is not None:
            _default.close()
        _default = EventLog(path, max_bytes=max_bytes,
                            max_files=max_files) if path else None
    return _default


def get_event_log() -> Optional[EventLog]:
    return _default


def emit_event(type: str, **fields: Any) -> None:
    """Emit to the process-global log (a no-op when unconfigured) and
    mirror into the flight recorder's ``events`` ring (when installed) —
    the crash-window copy a dump preserves even with no JSONL sink."""
    log = _default
    if log is not None:
        log.emit(type, **fields)
    rec = get_flight_recorder()
    if rec is not None:
        rec.record("events", type, **fields)
