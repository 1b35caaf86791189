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

Observability, as the JAX engine's: ``serving_shed_total{reason,
tenant}``, ``serving_request_seconds{priority}``, ``serving_batch_fill``,
``serving_batches_total``, ``serving_queue_depth``,
``serving_model_reloads_total`` and ``serving_model_version`` in the
metrics registry; request latencies and sheds fed to the health monitor;
one ``serve`` record of queue-wait / batch-formation / execute slices per
batch in the step profiler's ``profile`` channel; the ``serving`` flight
channel (each dispatch, and a failed batch with a rate-limited dump).

The reference engine's HTTP tier, hot swap, checkpoint watch and SLO
tracking are not ported yet (ROADMAP queue 1, item 5): the slot holds the
one model the engine was built with, at version 1.
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
from ..observability import clock
from ..observability.health import get_health_monitor
from ..observability.profiler import record_slices
from ..observability.recorder import get_flight_recorder
from ..observability.registry import default_registry
from ..ops import flash_attention as _flash
from ..parallel.inference import InvalidInputError
from ..utils.device import resolve_device

__all__ = ["ServingEngine", "AdmissionController", "ShedError"]

log = logging.getLogger("deeplearning4j_tpu_torch.serving")

# request latency buckets (seconds)
_LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                    0.25, 0.5, 1.0, 2.5, 10.0)
# batch fill = real rows / bucket rows per dispatch (1.0 = perfectly full)
_FILL_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


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
    that would take the queue past ``queue_limit``; ``observe(seconds)``
    records a served request's latency."""

    retry_after_s = 1.0   # client backoff hint sent with a shed

    def __init__(self, queue_limit: int = 256, registry=None):
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        self.queue_limit = int(queue_limit)
        self._registry = registry
        self._lock = threading.Lock()
        self.shed = 0

    def _reg(self):
        return self._registry if self._registry is not None \
            else default_registry()

    def count_shed(self, reason: str = "queue_full",
                   tenant: str = "-") -> None:
        with self._lock:
            self.shed += 1
        reg = self._reg()
        if reg.enabled:
            reg.counter("serving_shed_total",
                        "Requests shed by admission control",
                        ("reason", "tenant")).labels(reason, tenant).inc()
        mon = get_health_monitor()
        if mon is not None:
            mon.observe_request(shed=True)

    def observe(self, seconds: float, priority: str = "interactive") -> None:
        reg = self._reg()
        if reg.enabled:
            reg.histogram("serving_request_seconds",
                          "Engine request latency, enqueue to result",
                          ("priority",),
                          buckets=_LATENCY_BUCKETS).labels(
                              priority).observe(seconds)
        mon = get_health_monitor()
        if mon is not None:
            mon.observe_request(seconds=seconds)

    def admit(self, n: int, depth: int) -> None:
        if depth + n > self.queue_limit:
            self.count_shed()
            raise ShedError(
                f"queue at limit ({depth}/{self.queue_limit} + {n} rows)",
                status=429, retry_after_s=self.retry_after_s)


class _Request:
    __slots__ = ("row", "future", "t_enqueue")

    def __init__(self, row):
        self.row = row
        self.future: Future = Future()
        self.t_enqueue = clock.monotonic_s()


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
                 queue_limit: int = 256, generation=None, registry=None):
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
        self._registry = registry
        self.admission = AdmissionController(queue_limit=queue_limit,
                                             registry=registry)
        # admission sheds above queue_limit; the queue's own cap (limit +
        # one bucket) bounds a burst racing between admit and put
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue(
            maxsize=self.admission.queue_limit + self.buckets[-1])
        self._stats_lock = threading.Lock()
        self._batches_dispatched = 0
        self._rows_served = 0
        self._shutdown = threading.Event()
        self._submit_lock = threading.Lock()
        reg = self._reg()
        if reg.enabled:
            # the slot is installed once, at version 1
            reg.counter("serving_model_reloads_total",
                        "Successful model slot swaps").inc()
            reg.gauge("serving_model_version",
                      "Version of the currently served slot").set(1)
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
            self.generation = GenerationEngine(lambda: self.slot, cfg,
                                               registry=registry)

    @property
    def slot(self):
        """The served model slot (``.model``, ``.version``) the
        generation engine follows; None once shut down."""
        return None if self._shutdown.is_set() else self._slot()

    # ------------------------------------------------------------ counters
    def _reg(self):
        return self._registry if self._registry is not None \
            else default_registry()

    def _note_batch(self, real: int, bucket: int) -> None:
        with self._stats_lock:
            self._batches_dispatched += 1
            self._rows_served += real
        rec = get_flight_recorder()
        if rec is not None:
            rec.record("serving", "dispatch", rows=real, bucket=bucket,
                       traced=False, version=1, depth=self._queue.qsize())
        reg = self._reg()
        if not reg.enabled:
            return
        reg.histogram("serving_batch_fill",
                      "Real rows / bucket rows per dispatched batch",
                      buckets=_FILL_BUCKETS).observe(real / bucket)
        reg.counter("serving_batches_total",
                    "Batches dispatched by the continuous-batching "
                    "scheduler").inc()
        reg.gauge("serving_queue_depth",
                  "Requests waiting in the engine queue"
                  ).set(self._queue.qsize())

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
        now = clock.monotonic_s()
        for r in reqs:
            self.admission.observe(now - r.t_enqueue)
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
                self.admission.count_shed("queue_full")
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
            t_form = clock.monotonic_s()
            rows = np.stack([r.row for r in pending])
            n = len(rows)
            bucket = next(b for b in self.buckets if n <= b)
            batch = _pad_rows_np(rows, bucket)
            t_exec = clock.monotonic_s()
            out = self._forward(batch)[:n]
            t_done = clock.monotonic_s()
            self._note_batch(n, bucket)
            # profile slices: queue wait (oldest coalesced row), batch
            # formation (stack+pad), execute — one record per batch
            record_slices(
                "serve",
                queue_wait_s=round(
                    t_form - min(r.t_enqueue for r in pending), 7),
                batch_form_s=round(t_exec - t_form, 7),
                execute_s=round(t_done - t_exec, 7),
                batch=n, bucket=bucket, compile=False)
            for req, row in zip(pending, out):
                if not req.future.done():
                    req.future.set_result(row)
        except Exception as e:   # a failed batch must not kill the loop
            rec = get_flight_recorder()
            if rec is not None:
                # serve-side fault forensics, dumped (rate-limited; needs
                # a configured dump directory) before callers see it
                rec.record("serving", "batch_error",
                           error=f"{type(e).__name__}: {e}",
                           rows=len(pending), version=1)
                rec.maybe_dump("serve_exception")
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
