"""Atomic, checksummed file commits — the one write path for durable state
(port of ``faulttolerance/atomic.py``, the same protocol and checksums).

Reference posture: DL4J's ``CheckpointListener``/``ModelSerializer`` write
zips in place, so a crash mid-write leaves a truncated file that a later
``restoreMultiLayerNetwork`` explodes on.  Here every durable artifact is
committed by the POSIX temp-then-rename protocol:

  1. write the payload to a sibling temp path (same filesystem, so the
     rename below cannot degrade into a copy);
  2. flush + ``fsync`` the file descriptor (data reaches the disk, not
     just the page cache);
  3. ``os.replace`` onto the final name — atomic on POSIX: readers see
     either the old complete file or the new complete file, never a
     partial one;
  4. best-effort ``fsync`` of the parent directory so the rename itself
     survives power loss.

Checkpoint *directories* extend the same idea: stage every file in a
``.tmp-`` sibling directory, write a manifest carrying per-file SHA-256
checksums last, and commit the whole directory with one rename.  A crash
at any point leaves either the previous committed state or a ``.tmp-``
orphan that discovery ignores and ``discard_orphans`` sweeps.

This module is dependency-light on purpose (stdlib only, no package
imports): ``utils/model_serializer`` routes through it, and the
``faulttolerance.checkpoint`` store builds on it.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import uuid
from typing import Any, Dict, Iterator, Optional

__all__ = ["atomic_file", "atomic_write_bytes", "atomic_write_json",
           "commit_dir", "staging_dir", "discard_orphans",
           "manifest_for", "sha256_file", "TMP_PREFIX"]

TMP_PREFIX = ".tmp-"


def _fsync_path(path: str) -> None:
    """fsync a file by path; directory fsync is best-effort (some
    filesystems refuse O_RDONLY dir descriptors)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _tmp_sibling(path: str) -> str:
    """A temp name in the SAME directory as ``path`` (rename stays atomic
    only within one filesystem); unique per attempt so a crashed writer's
    leftover can't collide with a retry."""
    d, base = os.path.split(os.path.abspath(path))
    return os.path.join(d, f"{TMP_PREFIX}{base}-{os.getpid()}-"
                           f"{uuid.uuid4().hex[:8]}")


@contextlib.contextmanager
def atomic_file(path: str) -> Iterator[str]:
    """Context manager yielding a temp path; on clean exit the temp file
    is fsynced and atomically renamed onto ``path``.  On error the temp
    file is removed and nothing at ``path`` changes::

        with atomic_file(dst) as tmp:
            with zipfile.ZipFile(tmp, "w") as zf:
                ...
    """
    tmp = _tmp_sibling(path)
    try:
        yield tmp
        _fsync_path(tmp)
        os.replace(tmp, path)
        _fsync_path(os.path.dirname(os.path.abspath(path)))
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Commit ``data`` to ``path`` via temp-then-rename + fsync."""
    tmp = _tmp_sibling(path)
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_path(os.path.dirname(os.path.abspath(path)))
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise


def atomic_write_json(path: str, obj: Any) -> None:
    atomic_write_bytes(path, json.dumps(obj, sort_keys=True,
                                        indent=1).encode())


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def staging_dir(final_dir: str) -> str:
    """Create and return a ``.tmp-`` sibling staging directory for
    ``final_dir`` (commit it with :func:`commit_dir`)."""
    tmp = _tmp_sibling(final_dir)
    os.makedirs(tmp)
    return tmp


def commit_dir(tmp_dir: str, final_dir: str) -> None:
    """Atomically publish a fully-staged directory: fsync every staged
    file, then rename the directory onto ``final_dir``.  An existing
    ``final_dir`` (same step re-saved) is replaced."""
    for root, _, files in os.walk(tmp_dir):
        for name in files:
            _fsync_path(os.path.join(root, name))
    _fsync_path(tmp_dir)
    try:
        os.replace(tmp_dir, final_dir)
    except OSError:
        # POSIX rename onto a non-empty directory fails: this step was
        # committed before (listener iter+epoch triggers can coincide) —
        # drop the old one and retry once
        if os.path.isdir(final_dir):
            shutil.rmtree(final_dir, ignore_errors=True)
            os.replace(tmp_dir, final_dir)
        else:
            raise
    _fsync_path(os.path.dirname(os.path.abspath(final_dir)))


def discard_orphans(directory: str,
                    log_warning=None, min_age_s: float = 0.0) -> int:
    """Remove ``.tmp-`` staging leftovers from crashed writers.  Returns
    the number removed; ``log_warning(path)`` observes each one.
    ``min_age_s`` spares staging dirs younger than that many seconds —
    a multi-writer barrier round stages under a SHARED ``.tmp-`` name,
    so a peer sweeping the store mid-round (an elastic rejoin) must not
    reclaim a round that is still being written."""
    import time
    removed = 0
    try:
        entries = os.listdir(directory)
    except OSError:
        return 0
    now = time.time()
    for name in entries:
        if not name.startswith(TMP_PREFIX):
            continue
        path = os.path.join(directory, name)
        if min_age_s > 0:
            try:
                if now - os.path.getmtime(path) < min_age_s:
                    continue
            except OSError:
                continue        # vanished mid-scan: someone else's sweep
        if log_warning is not None:
            log_warning(path)
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        else:
            with contextlib.suppress(OSError):
                os.remove(path)
        removed += 1
    return removed


def manifest_for(directory: str, files: Optional[Dict[str, str]] = None
                 ) -> Dict[str, Dict[str, Any]]:
    """Per-file checksum table for every regular file in ``directory``
    (or the given name->path map): ``{name: {"sha256", "bytes"}}``."""
    table: Dict[str, Dict[str, Any]] = {}
    items = (files.items() if files is not None else
             ((n, os.path.join(directory, n))
              for n in sorted(os.listdir(directory))))
    for name, path in items:
        if not os.path.isfile(path):
            continue
        table[name] = {"sha256": sha256_file(path),
                       "bytes": os.path.getsize(path)}
    return table
