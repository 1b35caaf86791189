"""Continuous-batching serving engine: scheduler, admission control with
SLO tracking, zero-downtime weight hot swap, and its HTTP tier (port of
``serving/engine.py``).

**Continuous batching** (:class:`ServingEngine`): requests enter one
bounded queue; a dispatcher thread drains whatever arrived while the
previous batch ran into the next batch, pads it to a bucket of
``data/shapes.serving_buckets`` by repeating its last row, runs the
served slot's forward on the device and hands each caller its row.  The
dispatcher is the only thread that touches the device on the predict
path: callers and HTTP handlers hand in and get back host arrays.

**Admission control** (:class:`AdmissionController`): a queue-depth
limit sheds load before it queues (429 + ``Retry-After``), a model-less
engine sheds with 503, and per-model p50/p99 SLO targets are tracked over
a sliding window (``observability.quantiles.LatencyWindow``).  The
ok→breach edge counts ``serving_slo_breaches_total``, emits the
``slo_breach`` event, records in the ``serving`` flight channel, makes one
rate-limited ``slo_breach`` dump and tells the health monitor.

**Hot swap** (:meth:`ServingEngine.hot_swap`, :meth:`promote_latest`,
:meth:`watch`): the engine serves from an immutable model *slot* (model,
version, identity, checkpoint step).  The dispatcher reads ONE slot per
batch and runs that slot's model, so a batch never mixes two weight
versions: in-flight batches finish on the slot they took, later batches
run the new one.  Promotion restores the newest manifest-complete
checkpoint of a ``CheckpointManager`` directory (without updater state)
onto the engine's own device; corrupt checkpoints are skipped by the
manager's verification, and a sharded checkpoint (a ``ShardedTrainer``'s
blocks) is gathered into the slot (``CheckpointManager.restore_any``).

``generation=`` (a ``GenerationConfig``, a dict of its fields, or True
for the defaults) starts the continuous-batching decode engine of
``generation/engine.py`` over this engine's slot: it follows every swap,
``warmup`` warms it too, and ``ready`` includes its readiness.

HTTP front-end: :class:`ServingServer` (``/predict``, ``/generate``,
``/reload``, ``/watch``, ``/health``, ``/metrics``) over the bounded
``BackgroundHttpServer`` of ``utils/http.py``.

Observability, as the JAX engine's: ``serving_shed_total{reason,
tenant}``, ``serving_request_seconds{priority}``, ``serving_batch_fill``,
``serving_batches_total``, ``serving_queue_depth``,
``serving_model_reloads_total``, ``serving_model_version`` and
``serving_slo_breaches_total``; one ``serve`` record of queue-wait /
batch-formation / execute slices per batch in the step profiler's
``profile`` channel; the ``serving`` flight channel (each dispatch, a
failed batch with a rate-limited dump, SLO edges).  The port runs
eagerly and compiles nothing, so it has no steady-state recompiles to
count.
"""
from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..data.shapes import serving_buckets
from ..faulttolerance.checkpoint import CheckpointManager
from ..observability import clock
from ..observability.events import emit_event
from ..observability.health import get_health_monitor
from ..observability.profiler import record_slices
from ..observability.quantiles import LatencyWindow
from ..observability.recorder import get_flight_recorder
from ..observability.registry import default_registry
from ..ops import flash_attention as _flash
from ..parallel.inference import InvalidInputError, feature_shape, to_host
from ..utils.device import resolve_device
from ..utils.http import (BackgroundHttpServer, JsonClient, JsonHandler,
                          PredictCircuitMixin)
from ..utils.profiling import device_platform

__all__ = ["ServingEngine", "ServingServer", "ServingClient",
           "GenerationClient", "AdmissionController", "SLOConfig",
           "ShedError"]

log = logging.getLogger("deeplearning4j_tpu_torch.serving")

# engine-side request latency (enqueue -> result), seconds
_LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                    0.25, 0.5, 1.0, 2.5, 10.0)
# batch fill = real rows / bucket rows per dispatch (1.0 = perfectly full)
_FILL_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


class ShedError(RuntimeError):
    """Request refused by admission control.  ``status`` is the HTTP code
    the serving layer maps it to (429 queue full / 503 unready) and
    ``retry_after_s`` the client backoff hint."""

    def __init__(self, detail: str, status: int = 429,
                 retry_after_s: float = 1.0):
        super().__init__(detail)
        self.status = int(status)
        self.retry_after_s = float(retry_after_s)


@dataclass(frozen=True)
class SLOConfig:
    """Per-model latency SLO: targets in milliseconds over a sliding
    window of recent requests.  ``None`` targets never breach;
    ``min_samples`` withholds a verdict until the window holds that many
    requests."""

    p50_target_ms: Optional[float] = None
    p99_target_ms: Optional[float] = None
    window: int = 512
    min_samples: int = 32


class AdmissionController:
    """Queue-depth load shedding and sliding-window SLO tracking.

    ``admit(n, depth)`` is the gate every request passes before it
    enqueues: past ``queue_limit`` it is shed (429 + ``Retry-After``).
    ``observe(seconds)`` feeds the SLO window; ``status(depth)`` is the
    readiness payload ``/health`` embeds.  The health monitor is the
    process one (``get_health_monitor()``)."""

    def __init__(self, queue_limit: int = 256,
                 slo: Optional[SLOConfig] = None,
                 retry_after_s: float = 1.0, registry=None):
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        self.queue_limit = int(queue_limit)
        self.slo = slo or SLOConfig()
        self.retry_after_s = float(retry_after_s)
        self._registry = registry
        self._window = LatencyWindow(self.slo.window)
        self._lock = threading.Lock()
        self.shed = 0
        # SLO breach edge state: slo_ok() is polled by health probes from
        # many threads, and the transition is the incident, so one lock
        # keeps one breach from being counted (and dumped) twice
        self._slo_lock = threading.Lock()
        self._slo_was_ok = True
        self.slo_breaches = 0

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

    def admit(self, n: int, depth: int) -> None:
        """Admit ``n`` rows given the queue ``depth`` or raise
        :class:`ShedError`."""
        if depth + n > self.queue_limit:
            self.count_shed("queue_full")
            raise ShedError(
                f"queue at limit ({depth}/{self.queue_limit} + {n} rows)",
                status=429, retry_after_s=self.retry_after_s)

    def shed_unready(self, detail: str) -> ShedError:
        """Build (and count) the 503 shed of a model-less engine."""
        self.count_shed("unready")
        return ShedError(detail, status=503,
                         retry_after_s=self.retry_after_s)

    def observe(self, seconds: float, priority: str = "interactive") -> None:
        self._window.observe(seconds)
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

    def slo_ok(self) -> bool:
        """True until the window holds ``min_samples`` requests whose p50
        or p99 breaches its target.  The ok→breach edge is the incident
        (see the module docstring)."""
        slo = self.slo
        if slo.p50_target_ms is None and slo.p99_target_ms is None:
            return True
        snap = self._window.snapshot()
        if len(self._window) < slo.min_samples or snap["p50"] is None:
            ok = True
        else:
            ok = not (
                (slo.p50_target_ms is not None
                 and snap["p50"] * 1e3 > slo.p50_target_ms)
                or (slo.p99_target_ms is not None
                    and snap["p99"] * 1e3 > slo.p99_target_ms))
        with self._slo_lock:
            edge = ok != self._slo_was_ok
            self._slo_was_ok = ok
            if edge and not ok:
                self.slo_breaches += 1
        if edge:
            self._note_slo_edge(ok, snap)
        return ok

    def _note_slo_edge(self, ok: bool, snap: dict) -> None:
        p50 = None if snap["p50"] is None else round(snap["p50"] * 1e3, 3)
        p99 = None if snap["p99"] is None else round(snap["p99"] * 1e3, 3)
        reg = self._reg()
        if reg.enabled and not ok:
            reg.counter("serving_slo_breaches_total",
                        "SLO-window breach edges (ok -> breached)").inc()
        kind = "slo_recovered" if ok else "slo_breach"
        targets = dict(p50_target_ms=self.slo.p50_target_ms,
                       p99_target_ms=self.slo.p99_target_ms)
        emit_event(kind, p50_ms=p50, p99_ms=p99, **targets)
        rec = get_flight_recorder()
        if rec is not None:
            rec.record("serving", kind, p50_ms=p50, p99_ms=p99, **targets)
            if not ok:
                rec.maybe_dump("slo_breach")
        if not ok:
            mon = get_health_monitor()
            if mon is not None:
                mon.note_slo_breach(
                    f"serving SLO breached: p50 {p50} ms / p99 {p99} ms "
                    f"over targets {self.slo.p50_target_ms}/"
                    f"{self.slo.p99_target_ms} ms", value=p99)

    def status(self, depth: int) -> dict:
        snap = self._window.snapshot()
        return {
            "queue_depth": depth,
            "queue_limit": self.queue_limit,
            "saturated": depth >= self.queue_limit,
            "slo_ok": self.slo_ok(),
            "p50_ms": None if snap["p50"] is None
            else round(snap["p50"] * 1e3, 3),
            "p99_ms": None if snap["p99"] is None
            else round(snap["p99"] * 1e3, 3),
            "slo_p50_target_ms": self.slo.p50_target_ms,
            "slo_p99_target_ms": self.slo.p99_target_ms,
            "requests_observed": snap["count"],
        }


class _ModelSlot:
    """Immutable serving snapshot: model, version, identity and the
    checkpoint step it came from.  The dispatcher reads ONE slot per
    batch; the generation engine reads ``.model`` and ``.version``."""

    __slots__ = ("version", "model", "model_id", "feature_shape", "step")

    def __init__(self, version: int, model, origin: str,
                 step: Optional[int] = None):
        if not callable(getattr(model, "output", None)):
            raise TypeError(f"{type(model).__name__} is not servable: it "
                            "needs an output(batch) method")
        self.version = version
        self.model = model
        self.step = step
        self.feature_shape = feature_shape(model)
        name = type(model).__name__
        try:
            n = model.num_params()    # shape metadata only: no device sync
            self.model_id = f"{name}[params={n},v={version},from={origin}]"
        except Exception:
            self.model_id = f"{name}[v={version},from={origin}]"


class _Request:
    __slots__ = ("row", "future", "t_enqueue")

    def __init__(self, row):
        self.row = row
        self.future: Future = Future()
        self.t_enqueue = clock.monotonic_s()


def for_serving(model):
    """A network restored without updater state, as a slot holds it: the
    fresh updater state the restore made is dropped.  A slot never
    trains, so optimizer moments would only hold device memory; a later
    ``fit`` on the model makes them anew."""
    model.opt_state = None
    return model


def _pad_rows_np(rows: np.ndarray, bucket: int) -> np.ndarray:
    """Pad a host batch up to ``bucket`` rows by repeating the last row."""
    if len(rows) >= bucket:
        return rows
    return np.concatenate(
        [rows, np.repeat(rows[-1:], bucket - len(rows), axis=0)])


class ServingEngine:
    """Continuous-batching scheduler over one served model slot.

    ``predict(x)`` admits, enqueues and blocks on the result; the
    dispatcher forms bucket-padded batches as fast as the device finishes
    them.  ``model`` (optional: without it, and without a
    ``checkpoint_dir`` to promote from, the engine answers 503 until a
    slot is installed) is a network on ``device``.
    """

    def __init__(self, model=None, *, device="cuda",
                 max_batch_size: int = 32, queue_limit: int = 256,
                 nano_wait: float = 0.0,
                 batch_buckets: Optional[Sequence[int]] = None,
                 slo: Optional[SLOConfig] = None,
                 admission: Optional[AdmissionController] = None,
                 checkpoint_dir: Optional[str] = None, registry=None,
                 generation=None):
        self.device = resolve_device(device)
        self.buckets = serving_buckets(max_batch_size, batch_buckets)
        self.max_batch_size = int(max_batch_size)
        self.nano_wait = float(nano_wait)
        self.checkpoint_dir = checkpoint_dir
        self._registry = registry
        self.admission = admission if admission is not None else \
            AdmissionController(queue_limit=queue_limit, slo=slo,
                                registry=registry)
        self.generation = None
        # admission sheds above queue_limit; the queue's own cap (limit +
        # one bucket) bounds a burst racing between admit and put
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue(
            maxsize=self.admission.queue_limit + self.buckets[-1])
        self._slot: Optional[_ModelSlot] = None
        self._slot_lock = threading.Lock()
        self._version = 0
        self._stats_lock = threading.Lock()
        self._batches_dispatched = 0
        self._rows_served = 0
        self._shutdown = threading.Event()
        self._submit_lock = threading.Lock()
        self._watch_stop: Optional[threading.Event] = None
        self._watch_thread: Optional[threading.Thread] = None
        if model is not None:
            self.hot_swap(model, origin="init")
        elif checkpoint_dir:
            if self.promote_latest() is None:
                raise FileNotFoundError(
                    f"no complete checkpoint to serve in {checkpoint_dir}")
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

    # ------------------------------------------------------------ counters
    def _reg(self):
        return self._registry if self._registry is not None \
            else default_registry()

    def _note_batch(self, real: int, bucket: int, version: int) -> None:
        with self._stats_lock:
            self._batches_dispatched += 1
            self._rows_served += real
        rec = get_flight_recorder()
        if rec is not None:
            rec.record("serving", "dispatch", rows=real, bucket=bucket,
                       traced=False, version=version,
                       depth=self._queue.qsize())
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

    # ---------------------------------------------------------- model slot
    @property
    def queue_depth(self) -> int:
        """Live request-queue depth: the fleet router's load signal."""
        return self._queue.qsize()

    @property
    def slot(self) -> Optional[_ModelSlot]:
        """The served slot; None before one is installed and after
        shutdown."""
        if self._shutdown.is_set():
            return None
        with self._slot_lock:
            return self._slot

    @property
    def model_version(self) -> int:
        return self._version

    def hot_swap(self, model, origin: str = "swap",
                 step: Optional[int] = None) -> int:
        """Install ``model`` as the serving slot; returns the new version.
        Batches already formed finish on the slot they took; every batch
        formed after this call runs the new model."""
        model_device = getattr(model, "device", None)
        if model_device is not None and model_device != self.device:
            raise ValueError(f"model is on {model_device}, the engine on "
                             f"{self.device}")
        with self._slot_lock:
            self._version += 1
            slot = self._slot = _ModelSlot(self._version, model, origin,
                                           step=step)
        reg = self._reg()
        if reg.enabled:
            reg.counter("serving_model_reloads_total",
                        "Successful model slot swaps").inc()
            reg.gauge("serving_model_version",
                      "Version of the currently served slot"
                      ).set(slot.version)
        log.info("serving slot v%d installed (%s)", slot.version,
                 slot.model_id)
        return slot.version

    def promote_latest(self, directory: Optional[str] = None
                       ) -> Optional[int]:
        """Promote the newest COMPLETE checkpoint of ``directory``
        (default: the engine's ``checkpoint_dir``) into the slot,
        restored without updater state onto the engine's device.  Corrupt
        and partial checkpoints are skipped by the manager's verification;
        a sharded one is gathered into the slot.  Returns the promoted
        step, or None when nothing newer than the served step exists."""
        directory = directory or self.checkpoint_dir
        if not directory:
            raise ValueError("promote_latest needs a checkpoint directory "
                             "(constructor checkpoint_dir or argument)")
        with self._slot_lock:
            cur = self._slot
        after = -1 if cur is None or cur.step is None else int(cur.step)
        mgr = CheckpointManager(directory, registry=self._registry)
        newest = mgr.latest_complete(after_step=after)
        if newest is None:
            return None
        step, path = newest
        # restore_any: a sharded directory (a ShardedTrainer's, either
        # package's) is gathered into the slot like a dense one
        model = for_serving(mgr.restore_any(path=path, load_updater=False,
                                            device=self.device)[0])
        self.hot_swap(model, origin=path, step=step)
        if self.checkpoint_dir is None:
            self.checkpoint_dir = directory
        return step

    def watch(self, directory: Optional[str] = None,
              interval_s: float = 2.0) -> None:
        """Start (or retarget) the checkpoint watcher: poll ``directory``
        every ``interval_s`` and promote whenever a newer complete
        checkpoint commits (train→serve promotion)."""
        directory = directory or self.checkpoint_dir
        if not directory:
            raise ValueError("watch needs a checkpoint directory")
        self.checkpoint_dir = directory
        self.stop_watch()
        stop = threading.Event()

        def loop():
            while not stop.wait(interval_s):
                try:
                    self.promote_latest(directory)
                except Exception:
                    log.exception("checkpoint watch promotion failed "
                                  "(still serving v%d)", self._version)

        self._watch_stop = stop
        self._watch_thread = threading.Thread(
            target=loop, daemon=True, name="dl4j-torch-serve-watch")
        self._watch_thread.start()

    def stop_watch(self) -> None:
        if self._watch_stop is not None:
            self._watch_stop.set()
            self._watch_thread.join(timeout=30)
            self._watch_stop = self._watch_thread = None

    @property
    def watching(self) -> bool:
        return self._watch_thread is not None and \
            self._watch_thread.is_alive()

    # ------------------------------------------------------------- serving
    def _forward(self, batch: np.ndarray, slot: _ModelSlot) -> np.ndarray:
        return to_host(slot.model.output(batch))

    def warmup(self) -> int:
        """Run one forward per bucket (allocator and kernel build happen
        here, not on a client request), and with generation on its
        prefill ladder and decode step; returns the calls made.  A slot
        whose model declares no input type warms no bucket."""
        slot = self.slot
        if slot is None:
            raise self.admission.shed_unready("no model installed")
        warmed = 0
        if slot.feature_shape is not None:
            probe = np.zeros((1, *slot.feature_shape), np.float32)
            for b in self.buckets:
                self._forward(_pad_rows_np(probe, b), slot)
                warmed += 1
        if self.generation is not None:
            warmed += self.generation.warmup()
        return warmed

    def predict(self, x, timeout: Optional[float] = 60.0) -> np.ndarray:
        """Serve ``x`` (one example or a batch); blocks for the result.
        Raises :class:`ShedError` when admission refuses and
        ``InvalidInputError`` on a shape mismatch."""
        out, _ = self.predict_versioned(x, timeout=timeout)
        return out

    def predict_versioned(self, x, timeout: Optional[float] = 60.0):
        """Like :meth:`predict` but returns ``(output, versions)`` where
        ``versions[i]`` is the slot version that computed row ``i``."""
        if self._shutdown.is_set():
            raise RuntimeError("ServingEngine shut down")
        rows, single = self._validate(x)
        if self.slot is None:
            raise self.admission.shed_unready("no model installed")
        self.admission.admit(len(rows), self._queue.qsize())
        reqs = self._submit_all(rows)
        pairs = [r.future.result(timeout=timeout) for r in reqs]
        now = clock.monotonic_s()
        for r in reqs:
            self.admission.observe(now - r.t_enqueue)
        out = np.stack([p for p, _ in pairs])
        versions = [v for _, v in pairs]
        return (out[0], versions[:1]) if single else (out, versions)

    def _validate(self, x) -> Tuple[np.ndarray, bool]:
        x = np.asarray(x, dtype=np.float32)
        slot = self.slot
        expected = slot.feature_shape if slot is not None else None
        ndim = len(expected) if expected is not None else 1
        single = x.ndim == ndim
        batch = x[None] if single else x
        if expected is not None and tuple(batch.shape[1:]) != expected:
            raise InvalidInputError(
                f"expected feature shape {expected}, got "
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
            # ran is the next batch; nano_wait (off by default) holds a
            # lone request for stragglers
            pending = [first]
            if self.nano_wait and self._queue.qsize() == 0:
                self._shutdown.wait(self.nano_wait)
            while len(pending) < top:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is not None:
                    pending.append(nxt)
            # group by feature shape: a malformed row (a model without a
            # declared input type skips validation) must not fail the
            # requests coalesced with it
            groups: dict = {}
            for req in pending:
                groups.setdefault(tuple(np.shape(req.row)), []).append(req)
            for group in groups.values():
                self._run_batch(group)

    def _run_batch(self, pending: List[_Request]) -> None:
        # rows cancelled by a failed multi-row submit never reach device
        pending = [r for r in pending if not r.future.cancelled()]
        if not pending:
            return
        slot = self.slot       # ONE snapshot: no mixed-weights batch
        try:
            if slot is None:
                raise RuntimeError("no model installed")
            t_form = clock.monotonic_s()
            rows = np.stack([r.row for r in pending])
            n = len(rows)
            bucket = next(b for b in self.buckets if n <= b)
            batch = _pad_rows_np(rows, bucket)
            t_exec = clock.monotonic_s()
            out = self._forward(batch, slot)[:n]
            t_done = clock.monotonic_s()
            self._note_batch(n, bucket, slot.version)
            # profile slices: queue wait (oldest coalesced row), batch
            # formation (stack+pad), execute (H2D, forward, D2H)
            record_slices(
                "serve",
                queue_wait_s=round(
                    t_form - min(r.t_enqueue for r in pending), 7),
                batch_form_s=round(t_exec - t_form, 7),
                execute_s=round(t_done - t_exec, 7),
                batch=n, bucket=bucket, compile=False)
            for req, row in zip(pending, out):
                if not req.future.done():
                    req.future.set_result((row, slot.version))
        except Exception as e:   # a failed batch must not kill the loop
            rec = get_flight_recorder()
            if rec is not None:
                # serve-side fault forensics, dumped (rate-limited; needs
                # a configured dump directory) before callers see it
                rec.record("serving", "batch_error",
                           error=f"{type(e).__name__}: {e}",
                           rows=len(pending),
                           version=None if slot is None else slot.version)
                rec.maybe_dump("serve_exception")
            log.exception("serving batch of %d rows failed", len(pending))
            for req in pending:
                if not req.future.done():
                    req.future.set_exception(e)

    # ----------------------------------------------------------- lifecycle
    def ready(self) -> Tuple[bool, dict]:
        """``(ready, admission_status)``: ready means a slot is installed,
        the queue is below its shed limit, the SLO window is not in
        breach and, with generation on, the decode engine is ready."""
        depth = self._queue.qsize()
        status = self.admission.status(depth)
        ready = (self.slot is not None and not status["saturated"]
                 and status["slo_ok"])
        if self.generation is not None:
            ready = ready and self.generation.ready()
        return ready, status

    def generation_status(self) -> Optional[dict]:
        """The generation engine's ``status()``; None without generation."""
        return None if self.generation is None else self.generation.status()

    def stats(self) -> dict:
        slot = self.slot
        ready, admission = self.ready()
        with self._stats_lock:
            batches, rows = self._batches_dispatched, self._rows_served
        return {
            "ready": ready,
            "device": str(self.device),
            "model": None if slot is None else slot.model_id,
            "model_version": self._version,
            "serving_step": None if slot is None else slot.step,
            "buckets": list(self.buckets),
            "batches_dispatched": batches,
            "rows_served": rows,
            "shed": self.admission.shed,
            "queue_depth": admission["queue_depth"],
            "queue_limit": self.admission.queue_limit,
            "watching": self.watching,
            "checkpoint_dir": self.checkpoint_dir,
            "admission": admission,
            "flash_attention_launches": _flash.launches["fwd"],
            "generation": self.generation_status(),
        }

    def shutdown(self) -> None:
        self.stop_watch()
        with self._submit_lock:
            self._shutdown.set()
        if self.generation is not None:
            self.generation.shutdown()
        try:
            self._queue.put_nowait(None)     # wake the dispatcher
        except queue.Full:
            pass
        self._dispatcher.join(timeout=30)
        while True:                          # unblock stranded callers
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item.future.done():
                item.future.set_exception(
                    RuntimeError("ServingEngine shut down"))


# --------------------------------------------------------------------- HTTP
def _shed_response(handler, e: ShedError):
    return handler._json(
        {"error": str(e)}, e.status,
        headers={"Retry-After": max(1, round(e.retry_after_s))})


# /generate body fields and their types
_GENERATE_FIELDS = (("max_new_tokens", int), ("temperature", float),
                    ("top_k", int), ("top_p", float), ("seed", int),
                    ("eos_id", int))


class _EngineHandler(JsonHandler):
    server_ref = None    # type: ServingServer

    def do_GET(self):
        if self._serve_metrics():
            return
        if self._serve_flightrecorder():
            return
        if self.path.rstrip("/") == "/health":
            return self._json(self.server_ref.health())
        return self._json({"error": "not found"}, 404)

    def do_POST(self):
        route = self.path.rstrip("/")
        srv = self.server_ref
        if route == "/predict":
            return self._predict(srv)
        if route == "/generate":
            return self._generate(srv)
        if route == "/reload":
            return self._reload(srv)
        if route == "/watch":
            return self._watch(srv)
        return self._json({"error": "not found"}, 404)

    def _generate(self, srv):
        gen = srv.engine.generation
        if gen is None:
            return self._json({"error": "generation not enabled on this "
                               "server"}, 404)
        try:
            body = self._read_json()
            tokens = body["tokens"]
            kw = {name: cast(body[name]) for name, cast in _GENERATE_FIELDS
                  if body.get(name) is not None}
            stream = bool(body.get("stream", False))
        except Exception as e:
            return self._json({"error": str(e)}, 400)
        try:
            if not stream:
                res = gen.generate(tokens, **kw)
                srv.note_predict_result(True)
                return self._json({"tokens": res.tokens,
                                   "model_versions": res.versions,
                                   "finish": res.finish,
                                   "request_id": res.request_id})
            req = gen.submit(tokens, **kw)
        except ShedError as e:
            return _shed_response(self, e)
        except InvalidInputError as e:
            return self._json({"error": str(e)}, 400)
        except Exception as e:
            srv.note_predict_result(False)
            return self._json({"error": str(e)}, 500)

        # streaming: one NDJSON chunk per token.  A client that
        # disconnects cancels the request (its slot vacates at the next
        # step boundary); the stream always ends in a done/error event
        def events():
            while True:
                try:
                    ev = req.events.get(timeout=5.0)
                except queue.Empty:
                    if not (req.future.done() or req.cancelled.is_set()):
                        continue
                    try:
                        # the terminal event may have landed between the
                        # timeout and the done() check
                        ev = req.events.get_nowait()
                    except queue.Empty:
                        yield {"error": "generation ended without a "
                                        "terminal event"}
                        return
                yield ev
                if ev.get("done") or "error" in ev:
                    return
        try:
            if not self._stream_json_lines(events()):
                req.cancelled.set()
        except Exception:
            req.cancelled.set()
            raise

    def _predict(self, srv):
        try:
            x = np.asarray(self._read_json()["data"], dtype=np.float32)
        except Exception as e:
            return self._json({"error": str(e)}, 400)
        try:
            out, versions = srv.engine.predict_versioned(x)
        except ShedError as e:
            return _shed_response(self, e)
        except InvalidInputError as e:
            return self._json({"error": str(e)}, 400)
        except Exception as e:    # model-side failure: server error
            srv.note_predict_result(False)
            return self._json({"error": str(e)}, 500)
        srv.note_predict_result(True)
        reg = self._registry()
        if reg.enabled:
            reg.counter("inference_examples_total",
                        "Examples served through /predict") \
               .inc(len(versions))
        body = {"output": out.tolist(),
                "model_version": versions[0] if len(set(versions)) == 1
                else sorted(set(versions))}
        return self._json(body)

    def _reload(self, srv):
        try:
            body = self._read_json() if \
                int(self.headers.get("Content-Length", 0)) else {}
            if "path" in body:
                from ..utils.model_serializer import restore_model
                model = for_serving(restore_model(
                    body["path"], load_updater=False,
                    device=srv.engine.device))
                version = srv.engine.hot_swap(model, origin=body["path"])
                return self._json({"ok": True, "version": version})
            step = srv.engine.promote_latest(body.get("dir"))
            if step is None:
                return self._json({"ok": True, "promoted": False,
                                   "version": srv.engine.model_version})
            return self._json({"ok": True, "promoted": True, "step": step,
                               "version": srv.engine.model_version})
        except Exception as e:
            return self._json({"error": str(e)}, 400)

    def _watch(self, srv):
        try:
            body = self._read_json() if \
                int(self.headers.get("Content-Length", 0)) else {}
            if body.get("stop"):
                srv.engine.stop_watch()
                return self._json({"ok": True, "watching": False})
            srv.engine.watch(body.get("dir"),
                             interval_s=float(body.get("interval_s", 2.0)))
            return self._json({"ok": True, "watching": True})
        except Exception as e:
            return self._json({"error": str(e)}, 400)


class ServingServer(PredictCircuitMixin):
    """HTTP front-end over a :class:`ServingEngine`.

    Endpoints::

      POST /predict  {"data": [...]}            -> {"output", "model_version"}
                     429/503 + Retry-After when admission sheds
      POST /generate {"tokens", "stream"?, ...} -> tokens, or NDJSON events
      POST /reload   {"path": zip} | {"dir"?: ckpt store} -> promote/swap
      POST /watch    {"dir"?, "interval_s"?} | {"stop": true}
      GET  /health   liveness + readiness (queue/SLO/model identity)
      GET  /metrics  Prometheus text (?format=json snapshot)
    """

    FAILURE_THRESHOLD = 3     # consecutive 5xx predicts flip readiness

    def __init__(self, model=None, port: int = 0, *,
                 engine: Optional[ServingEngine] = None, device="cuda",
                 max_batch_size: int = 32, queue_limit: int = 256,
                 slo: Optional[SLOConfig] = None,
                 checkpoint_dir: Optional[str] = None,
                 watch_interval_s: Optional[float] = None,
                 max_concurrent: int = 64, registry=None, warmup: bool = True,
                 generation=None):
        self.registry = registry if registry is not None \
            else default_registry()
        self.engine = engine if engine is not None else ServingEngine(
            model, device=device, max_batch_size=max_batch_size,
            queue_limit=queue_limit, slo=slo, checkpoint_dir=checkpoint_dir,
            registry=registry, generation=generation)
        if warmup and self.engine.slot is not None:
            self.engine.warmup()
        if watch_interval_s is not None:
            self.engine.watch(interval_s=watch_interval_s)
        self.platform = device_platform(self.engine.device)
        self._init_predict_circuit()
        self._server = BackgroundHttpServer(
            _EngineHandler, port, max_concurrent=max_concurrent,
            server_ref=self, metrics_registry=self.registry)

    def health(self) -> dict:
        engine_ready, admission = self.engine.ready()
        ready = engine_ready and \
            self.consecutive_failures < self.FAILURE_THRESHOLD
        since = (None if self.last_predict_mono is None
                 else round(clock.monotonic_s() - self.last_predict_mono, 3))
        slot = self.engine.slot
        # ok / degraded / unready: degraded = still serving, but the
        # health monitor confirmed an anomaly (NaN run, SLO breach, ...)
        status = "ok" if ready else "unready"
        health_status = None
        mon = get_health_monitor()
        if mon is not None:
            health_status = mon.status()
            if ready and health_status["state"] == "degraded":
                status = "degraded"
        return {"status": status,
                "live": True,
                "ready": ready,
                "health": health_status,
                "consecutive_failures": self.consecutive_failures,
                "platform": self.platform,
                "model": None if slot is None else slot.model_id,
                "model_version": self.engine.model_version,
                "serving_step": None if slot is None else slot.step,
                "watching": self.engine.watching,
                "admission": admission,
                "generation": self.engine.generation_status(),
                "seconds_since_last_predict": since}

    @property
    def port(self) -> int:
        return self._server.port

    def start(self) -> "ServingServer":
        self._server.start()
        return self

    def stop(self) -> None:
        self._server.stop()
        self.engine.shutdown()


class GenerationClient(JsonClient):
    """Client for ``POST /generate``: :meth:`generate` blocks for the
    finished sequence; :meth:`stream` yields one event per token (and
    cancels the server-side request when the caller abandons it)."""

    @staticmethod
    def _body(tokens, **kw):
        body = {"tokens": [int(t) for t in np.asarray(tokens).reshape(-1)]}
        body.update({k: v for k, v in kw.items() if v is not None})
        return body

    def generate(self, tokens, **kw) -> dict:
        return self.post("/generate", self._body(tokens, **kw))

    def stream(self, tokens, **kw):
        yield from self.stream_lines(
            "/generate", self._body(tokens, stream=True, **kw))


class ServingClient(JsonClient):
    def predict(self, data) -> np.ndarray:
        return np.asarray(self.post(
            "/predict", {"data": np.asarray(data).tolist()})["output"])

    def predict_versioned(self, data):
        body = self.post("/predict", {"data": np.asarray(data).tolist()})
        return np.asarray(body["output"]), body["model_version"]

    def reload(self, path: Optional[str] = None,
               directory: Optional[str] = None) -> dict:
        body = {}
        if path:
            body["path"] = path
        if directory:
            body["dir"] = directory
        return self.post("/reload", body)
