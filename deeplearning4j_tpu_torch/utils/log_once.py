"""One-time logging (port of ``utils/log_once.py``; reference
``util/OneTimeLogger.java``): a given message at most once per process,
for warnings inside hot loops."""
from __future__ import annotations

import logging
import threading

__all__ = ["info_once", "warn_once", "reset_once"]

_seen = set()
_lock = threading.Lock()


def _once(level: int, logger: logging.Logger, msg: str, *args) -> bool:
    key = (logger.name, level, msg)
    with _lock:
        if key in _seen:
            return False
        _seen.add(key)
    logger.log(level, msg, *args)
    return True


def info_once(logger: logging.Logger, msg: str, *args) -> bool:
    return _once(logging.INFO, logger, msg, *args)


def warn_once(logger: logging.Logger, msg: str, *args) -> bool:
    return _once(logging.WARNING, logger, msg, *args)


def reset_once() -> None:
    with _lock:
        _seen.clear()
