"""Stats persistence (port of ``ui/storage.py``, host code: the same
``DL4JTPU1`` log frames and SQLite rows, so a log written by either
package replays in the other; reference ``deeplearning4j-core/.../api/storage/
StatsStorage.java`` + impls in ``ui-model/.../ui/storage/``: InMemory and
file-backed; the reference's SBE wire format becomes length-prefixed JSON
binary framing here).

Storage emits change events to registered listeners — the hook the UI server
uses to live-refresh (reference ``StatsStorageListener``).
"""
from __future__ import annotations

import json
import os
import struct
import threading
from collections import defaultdict
from typing import Callable, Dict, List, Optional

from .stats import StatsReport

__all__ = ["StatsStorage", "InMemoryStatsStorage", "FileStatsStorage",
           "SqliteStatsStorage"]

_MAGIC = b"DL4JTPU1"


class StatsStorage:
    """Interface: put/list/get + change listeners (``StatsStorage.java``)."""

    def __init__(self):
        self._listeners: List[Callable[[StatsReport], None]] = []
        self._lock = threading.Lock()

    # -- router side ------------------------------------------------------
    def put_record(self, report: StatsReport) -> None:
        self._store(report)
        for fn in list(self._listeners):
            fn(report)

    # -- reader side ------------------------------------------------------
    def list_session_ids(self) -> List[str]:
        raise NotImplementedError

    def list_worker_ids(self, session_id: str) -> List[str]:
        raise NotImplementedError

    def get_records(self, session_id: str,
                    worker_id: Optional[str] = None) -> List[StatsReport]:
        raise NotImplementedError

    def get_latest_record(self, session_id: str) -> Optional[StatsReport]:
        recs = self.get_records(session_id)
        return recs[-1] if recs else None

    def register_listener(self, fn: Callable[[StatsReport], None]) -> None:
        self._listeners.append(fn)

    def _store(self, report: StatsReport) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class InMemoryStatsStorage(StatsStorage):
    """Reference ``InMemoryStatsStorage``: dict-of-lists, test/dev tier."""

    def __init__(self):
        super().__init__()
        self._records: Dict[str, List[StatsReport]] = defaultdict(list)

    def _store(self, report):
        with self._lock:
            self._records[report.session_id].append(report)

    def list_session_ids(self):
        with self._lock:
            return sorted(self._records)

    def list_worker_ids(self, session_id):
        with self._lock:
            return sorted({r.worker_id for r in self._records.get(session_id, [])})

    def get_records(self, session_id, worker_id=None):
        with self._lock:
            recs = list(self._records.get(session_id, []))
        if worker_id is not None:
            recs = [r for r in recs if r.worker_id == worker_id]
        return recs


class FileStatsStorage(StatsStorage):
    """Append-only binary log: 8-byte magic header, then
    ``[u32 length][json payload]`` frames (the SBE-file role of the
    reference's ``FileStatsStorage`` MapDB file).  Re-opening replays the log.
    """

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._memory = InMemoryStatsStorage()
        exists = os.path.exists(path) and os.path.getsize(path) > 0
        if exists:
            self._replay()
        self._fh = open(path, "ab")
        if not exists:
            self._fh.write(_MAGIC)
            self._fh.flush()

    def _replay(self) -> None:
        with open(self.path, "rb") as fh:
            magic = fh.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"{self.path}: not a stats log (bad magic)")
            while True:
                head = fh.read(4)
                if len(head) < 4:
                    break
                (n,) = struct.unpack("<I", head)
                payload = fh.read(n)
                if len(payload) < n:
                    break  # truncated trailing frame (crash mid-write): drop
                self._memory._store(StatsReport.from_dict(json.loads(payload)))

    def _store(self, report):
        payload = json.dumps(report.to_dict()).encode()
        with self._lock:
            self._fh.write(struct.pack("<I", len(payload)))
            self._fh.write(payload)
            self._fh.flush()
        self._memory._store(report)

    def list_session_ids(self):
        return self._memory.list_session_ids()

    def list_worker_ids(self, session_id):
        return self._memory.list_worker_ids(session_id)

    def get_records(self, session_id, worker_id=None):
        return self._memory.get_records(session_id, worker_id)

    def close(self):
        self._fh.close()


class SqliteStatsStorage(StatsStorage):
    """SQLite-backed storage (reference ``ui-model/.../ui/storage/sqlite/
    J7FileStatsStorage.java`` — the embedded-DB backend next to the MapDB
    file store).  One ``records`` table indexed by (session, worker,
    iteration); reports persist as JSON blobs.  Safe across threads: each
    call opens a short-lived connection (sqlite serializes writers)."""

    def __init__(self, path: str):
        super().__init__()
        self.path = str(path)
        self._exec(
            "CREATE TABLE IF NOT EXISTS records ("
            " session_id TEXT NOT NULL,"
            " worker_id TEXT NOT NULL DEFAULT '',"
            " iteration INTEGER NOT NULL DEFAULT 0,"
            " payload TEXT NOT NULL)")
        self._exec(
            "CREATE INDEX IF NOT EXISTS idx_records "
            "ON records (session_id, worker_id, iteration)")

    def _exec(self, sql: str, params: tuple = ()) -> list:
        """One short-lived connection per call: commit AND close (the
        sqlite3 context manager only commits)."""
        import sqlite3
        from contextlib import closing
        with closing(sqlite3.connect(self.path)) as conn:
            with conn:
                return conn.execute(sql, params).fetchall()

    def _store(self, report: StatsReport) -> None:
        d = report.to_dict()
        with self._lock:
            self._exec(
                "INSERT INTO records VALUES (?, ?, ?, ?)",
                (report.session_id, report.worker_id or "",
                 int(report.iteration or 0), json.dumps(d)))

    def list_session_ids(self) -> List[str]:
        rows = self._exec("SELECT DISTINCT session_id FROM records")
        return sorted(r[0] for r in rows)

    def list_worker_ids(self, session_id: str) -> List[str]:
        rows = self._exec(
            "SELECT DISTINCT worker_id FROM records WHERE session_id=?",
            (session_id,))
        return sorted(r[0] for r in rows)

    def get_records(self, session_id: str,
                    worker_id: Optional[str] = None) -> List[StatsReport]:
        # insertion order (rowid), matching the InMemory/File backends —
        # get_latest_record must agree across storage implementations
        if worker_id is not None:
            rows = self._exec(
                "SELECT payload FROM records WHERE session_id=? AND "
                "worker_id=? ORDER BY rowid", (session_id, worker_id))
        else:
            rows = self._exec(
                "SELECT payload FROM records WHERE session_id=? "
                "ORDER BY rowid", (session_id,))
        return [StatsReport.from_dict(json.loads(r[0])) for r in rows]
