"""Continuous-batching serving engine (port of the predict path of
``serving/engine.py``).

Requests enter one bounded queue.  A dispatcher thread drains whatever
arrived while the previous batch ran into the next batch, pads it to a
bucket of ``data/shapes.serving_buckets`` by repeating its last row, runs
the network's forward on the device and hands each caller its row.
Admission sheds a request before it queues once the queue is at
``queue_limit`` rows (``ShedError``, status 429).

``generation=`` (a ``GenerationConfig``, a dict of its fields, or True
for the defaults) starts the continuous-batching decode engine of
``generation/engine.py`` over this engine's model slot: ``warmup`` warms
it too, ``ready`` includes its readiness and ``generation_status`` reports
it.

The reference engine's HTTP tier, hot swap, checkpoint watch and SLO
tracking are not ported yet: the slot holds the one model the engine was
built with, at version 1.
"""
from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import Future
from typing import List, Optional, Tuple

import numpy as np

from ..data.shapes import serving_buckets
from ..generation.engine import StaticSlotSource
from ..ops import flash_attention as _flash
from ..parallel.inference import InvalidInputError
from ..utils.device import resolve_device

__all__ = ["ServingEngine", "AdmissionController", "ShedError"]

log = logging.getLogger("deeplearning4j_tpu_torch.serving")


class ShedError(RuntimeError):
    """Request refused by admission control.  ``status`` is the HTTP code
    (429 queue full) and ``retry_after_s`` the client backoff hint."""

    def __init__(self, detail: str, status: int = 429,
                 retry_after_s: float = 1.0):
        super().__init__(detail)
        self.status = int(status)
        self.retry_after_s = float(retry_after_s)


class AdmissionController:
    """Queue-depth load shedding: ``admit(n, depth)`` refuses ``n`` rows
    that would take the queue past ``queue_limit``."""

    retry_after_s = 1.0   # client backoff hint sent with a shed

    def __init__(self, queue_limit: int = 256):
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        self.queue_limit = int(queue_limit)
        self._lock = threading.Lock()
        self.shed = 0

    def count_shed(self) -> None:
        with self._lock:
            self.shed += 1

    def admit(self, n: int, depth: int) -> None:
        if depth + n > self.queue_limit:
            self.count_shed()
            raise ShedError(
                f"queue at limit ({depth}/{self.queue_limit} + {n} rows)",
                status=429, retry_after_s=self.retry_after_s)


class _Request:
    __slots__ = ("row", "future")

    def __init__(self, row):
        self.row = row
        self.future: Future = Future()


def _pad_rows_np(rows: np.ndarray, bucket: int) -> np.ndarray:
    """Pad a host batch up to ``bucket`` rows by repeating the last row."""
    if len(rows) >= bucket:
        return rows
    return np.concatenate(
        [rows, np.repeat(rows[-1:], bucket - len(rows), axis=0)])


class ServingEngine:
    """Continuous-batching scheduler over one network.

    ``predict(x)`` admits, enqueues and blocks on the result; the
    dispatcher thread forms bucket-padded batches as fast as the device
    finishes them.  ``model`` is a ``MultiLayerNetwork`` on ``device``.
    """

    def __init__(self, model, *, device="cuda", max_batch_size: int = 32,
                 queue_limit: int = 256, generation=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, the engine on "
                             f"{self.device}")
        self.model = model
        self.generation = None
        self._slot = StaticSlotSource(model)
        self.feature_shape: Tuple[int, ...] = tuple(
            model.conf.input_type.shape(-1)[1:])
        self.buckets = serving_buckets(max_batch_size)
        self.admission = AdmissionController(queue_limit=queue_limit)
        # admission sheds above queue_limit; the queue's own cap (limit +
        # one bucket) bounds a burst racing between admit and put
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue(
            maxsize=self.admission.queue_limit + self.buckets[-1])
        self._stats_lock = threading.Lock()
        self._batches_dispatched = 0
        self._rows_served = 0
        self._shutdown = threading.Event()
        self._submit_lock = threading.Lock()
        self._dispatcher = threading.Thread(
            target=self._serve_loop, daemon=True,
            name="dl4j-torch-serve-dispatch")
        self._dispatcher.start()
        if generation is not None:
            # built last: its decode thread reads the slot from the start
            from ..generation.engine import (GenerationConfig,
                                             GenerationEngine)
            if isinstance(generation, GenerationConfig):
                cfg = generation
            elif isinstance(generation, dict):
                cfg = GenerationConfig(**generation)
            else:
                cfg = GenerationConfig()
            self.generation = GenerationEngine(lambda: self.slot, cfg)

    @property
    def slot(self):
        """The served model slot (``.model``, ``.version``) the
        generation engine follows; None once shut down."""
        return None if self._shutdown.is_set() else self._slot()

    # ------------------------------------------------------------ counters
    @property
    def batches_dispatched(self) -> int:
        with self._stats_lock:
            return self._batches_dispatched

    def stats(self) -> dict:
        with self._stats_lock:
            batches, rows = self._batches_dispatched, self._rows_served
        return {
            "device": str(self.device),
            "buckets": list(self.buckets),
            "batches_dispatched": batches,
            "rows_served": rows,
            "shed": self.admission.shed,
            "queue_depth": self._queue.qsize(),
            "queue_limit": self.admission.queue_limit,
            "flash_attention_launches": _flash.launches["fwd"],
            "generation": self.generation_status(),
        }

    def ready(self) -> bool:
        """Not shut down, the queue below its shed limit and, with
        generation on, the decode engine ready."""
        ok = (not self._shutdown.is_set()
              and self._queue.qsize() < self.admission.queue_limit)
        if self.generation is not None:
            ok = ok and self.generation.ready()
        return ok

    def generation_status(self) -> Optional[dict]:
        """The generation engine's ``status()``; None without generation."""
        return None if self.generation is None else self.generation.status()

    # ------------------------------------------------------------- serving
    def _forward(self, batch: np.ndarray) -> np.ndarray:
        out = self.model.output(batch)
        return out.float().cpu().numpy()

    def warmup(self) -> int:
        """Run one forward per bucket (allocator and kernel build happen
        here, not on a client request), and with generation on its
        prefill ladder and decode step; returns the calls made."""
        probe = np.zeros((1, *self.feature_shape), np.float32)
        for b in self.buckets:
            self._forward(_pad_rows_np(probe, b))
        warmed = len(self.buckets)
        if self.generation is not None:
            warmed += self.generation.warmup()
        return warmed

    def predict(self, x, timeout: Optional[float] = 60.0) -> np.ndarray:
        """Serve ``x`` (one example or a batch); blocks for the result.
        Raises ``ShedError`` when admission refuses and
        ``InvalidInputError`` on a shape mismatch."""
        rows, single = self._validate(x)
        self.admission.admit(len(rows), self._queue.qsize())
        reqs = self._submit_all(rows)
        out = np.stack([r.future.result(timeout=timeout) for r in reqs])
        return out[0] if single else out

    def _validate(self, x) -> Tuple[np.ndarray, bool]:
        x = np.asarray(x, dtype=np.float32)
        single = x.ndim == len(self.feature_shape)
        batch = x[None] if single else x
        if tuple(batch.shape[1:]) != self.feature_shape:
            raise InvalidInputError(
                f"expected feature shape {self.feature_shape}, got "
                f"{tuple(batch.shape[1:])}")
        return batch, single

    def _submit_all(self, rows) -> List[_Request]:
        """Enqueue every row or none: a queue.Full mid-way cancels the
        rows already enqueued before the ShedError propagates."""
        reqs: List[_Request] = []
        try:
            for row in rows:
                reqs.append(self._submit(row))
        except ShedError:
            for r in reqs:
                r.future.cancel()
            raise
        return reqs

    def _submit(self, row: np.ndarray) -> _Request:
        req = _Request(row)
        with self._submit_lock:
            if self._shutdown.is_set():
                raise RuntimeError("ServingEngine shut down")
            try:
                self._queue.put_nowait(req)
            except queue.Full:
                self.admission.count_shed()
                raise ShedError("queue at hard limit", status=429,
                                retry_after_s=self.admission.retry_after_s)
        return req

    # ---------------------------------------------------------- dispatcher
    def _serve_loop(self) -> None:
        top = self.buckets[-1]
        while not self._shutdown.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            if first is None:
                continue
            # continuous batching: whatever arrived while the last batch
            # ran is the next batch
            pending = [first]
            while len(pending) < top:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is not None:
                    pending.append(nxt)
            self._run_batch(pending)

    def _run_batch(self, pending: List[_Request]) -> None:
        pending = [r for r in pending if not r.future.cancelled()]
        if not pending:
            return
        try:
            rows = np.stack([r.row for r in pending])
            n = len(rows)
            bucket = next(b for b in self.buckets if n <= b)
            out = self._forward(_pad_rows_np(rows, bucket))[:n]
            with self._stats_lock:
                self._batches_dispatched += 1
                self._rows_served += n
            for req, row in zip(pending, out):
                if not req.future.done():
                    req.future.set_result(row)
        except Exception as e:   # a failed batch must not kill the loop
            log.exception("serving batch of %d rows failed", len(pending))
            for req in pending:
                if not req.future.done():
                    req.future.set_exception(e)

    # ----------------------------------------------------------- lifecycle
    def shutdown(self) -> None:
        with self._submit_lock:
            self._shutdown.set()
        if self.generation is not None:
            self.generation.shutdown()
        try:
            self._queue.put_nowait(None)     # wake the dispatcher
        except queue.Full:
            pass
        self._dispatcher.join(timeout=5)
        while True:                          # unblock stranded callers
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item.future.done():
                item.future.set_exception(
                    RuntimeError("ServingEngine shut down"))
