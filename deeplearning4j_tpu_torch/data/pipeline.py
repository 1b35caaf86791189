"""Device-overlapped input pipeline (port of ``data/pipeline.py``): k-deep
device prefetch + multiprocess shared-memory ETL.

Two composable stages sit between a host ``DataSetIterator`` and the train
step, so neither host ETL nor the host→device copy serializes with device
compute (the overlapped-ETL input pipeline of *TensorFlow: A system for
large-scale machine learning*):

``MultiprocessETLIterator``
    Worker *processes* run the numpy transform stage (``data/transforms.py``
    et al.) outside the trainer's GIL, handing finished batches back through
    a ring of preallocated shared-memory slabs.  Batch order is
    deterministic and worker exceptions reach the consumer with the
    worker's traceback.  Workers are spawned and never touch the card:
    this module imports no torch, and a worker hides every CUDA device
    from itself (``CUDA_VISIBLE_DEVICES=""``) before it builds its source.

``DevicePrefetchIterator``
    A background thread copies up to ``depth`` batches ahead of the
    consumer onto the device, in stream order:

    - the thread copies each field into a **pinned** staging buffer and
      issues the host→device copy ``non_blocking`` on a **copy stream** of
      its own, then records an event on that stream;
    - the consumer (the generator body, on the thread that trains) makes
      its current stream wait on that event before it yields the batch,
      and ``record_stream``\\ s each yielded tensor on it, so the caching
      allocator does not hand the memory back while the step still reads
      it;
    - a pinned buffer is written again only after its copy's event has
      completed.

    The copy of batch *n+k* thus overlaps the step of batch *n*.  The
    networks' ``fit`` (``nn/_common.Network._on_device``) takes a tensor
    already on its device as it is, with no second copy.

    With a ``mesh`` (``parallel/mesh.Mesh``), the prefetcher trims each
    batch to a multiple of the data axis and places the trimmed GLOBAL
    batch on the mesh's device.  ``ParallelWrapper`` takes global batches
    on every rank and slices its own rows (views of the placed tensor);
    placing only this rank's rows would slice them twice.  So training
    from the prefetcher equals training from host batches, and each rank
    copies the whole global batch.

Observability (the port's registry; instruments resolved once per
iteration, never forcing a device sync):

- ``training_etl_seconds{stage}`` histogram — per-stage waits:
  ``fetch`` (trainer blocked on the iterator — recorded by ``fit``),
  ``source``/``h2d`` (prefetch producer pulling + staging and issuing the
  copy), ``wait`` (consumer blocked on the device queue), ``transform``
  (worker ETL time, measured in-worker, observed parent-side), ``ring``
  (parent blocked on the shared-memory ring).
- ``training_pipeline_depth{stage=device|ring}`` gauges — how full each
  stage's buffer is.
- ``training_pipeline_starved_total{stage=device|ring}`` counters — times a
  consumer found the buffer empty (the producer is the bottleneck).
"""
from __future__ import annotations

import multiprocessing
import os
import queue
import threading
import time
import traceback
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .dataset import AsyncShieldDataSetIterator, DataSet, DataSetIterator
from ..observability.clock import monotonic_s
from ..observability.registry import default_registry

__all__ = ["DevicePrefetchIterator", "MultiprocessETLIterator",
           "build_input_pipeline", "ETL_BUCKETS"]

# training_etl_seconds bucket bounds — shared with nn/_common.py's
# registration of the same family (the registry rejects re-registration
# with different buckets, so there must be exactly one source of truth).
ETL_BUCKETS: Tuple[float, ...] = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                                  0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

_FIELDS = ("features", "labels", "features_mask", "labels_mask")

# slabs whose close() found live consumer views at teardown: kept referenced
# so SharedMemory.__del__ never re-raises mid-GC; already unlinked, so the
# OS frees the memory with the last unmap
_UNCLOSED_SLABS: List = []


def _etl_instruments(registry=None):
    """(etl_histogram, depth_gauge, starved_counter) or (None,)*3 when the
    registry is disabled."""
    reg = registry if registry is not None else default_registry()
    if not reg.enabled:
        return None, None, None
    etl = reg.histogram(
        "training_etl_seconds",
        "Time blocked on the data pipeline per batch, by stage",
        ("stage",), buckets=ETL_BUCKETS)
    depth = reg.gauge("training_pipeline_depth",
                      "Batches buffered ahead of the consumer, by stage",
                      ("stage",))
    starved = reg.counter("training_pipeline_starved_total",
                          "Times a pipeline consumer found its buffer empty",
                          ("stage",))
    return etl, depth, starved


# ===================================================================== device
class _Stager:
    """Host → device placement for one producer thread.  On a card: a
    copy stream and ``slots`` pinned staging slots used in turn, each a
    byte buffer per field and the event of its last copy.  On the CPU: an
    owned copy of each field."""

    def __init__(self, torch, device, slots: int):
        self.torch = torch
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(device=device)
            self.slots = [{"event": None, "bufs": {}} for _ in range(slots)]
        self.turn = 0

    def _tdtype(self, dt: np.dtype):
        return self.torch.from_numpy(np.empty(0, dt)).dtype

    def _pinned(self, slot, key, a: np.ndarray):
        """A pinned tensor of ``a``'s shape and dtype in this slot's
        buffer for field ``key`` (grown when too small)."""
        torch = self.torch
        buf = slot["bufs"].get(key)
        if buf is None or buf.numel() < a.nbytes:
            buf = torch.empty(max(a.nbytes, 1), dtype=torch.uint8,
                              pin_memory=True)
            slot["bufs"][key] = buf
        return buf[:a.nbytes].view(self._tdtype(a.dtype)).view(a.shape)

    def place(self, fields):
        """``(tensors, event, owned)``: the fields on the device, the copy
        stream's event after their copies (None on the CPU), and which of
        them this stager allocated."""
        torch = self.torch
        owned = []

        def one(key, a):
            if isinstance(a, torch.Tensor) and a.device == self.device:
                return a
            host = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
                else np.asarray(a)
            if not self.cuda:
                return torch.tensor(host)
            pinned = self._pinned(slot, key, host)
            np.copyto(pinned.numpy(), host)
            d = torch.empty(host.shape, dtype=pinned.dtype,
                            device=self.device)
            d.copy_(pinned, non_blocking=True)
            owned.append(d)
            return d

        def all_fields():
            return [None if a is None else
                    [one((i, j), e) for j, e in enumerate(a)]
                    if isinstance(a, (list, tuple)) else one(i, a)
                    for i, a in enumerate(fields)]

        if not self.cuda:
            return all_fields(), None, owned
        slot = self.slots[self.turn % len(self.slots)]
        self.turn += 1
        if slot["event"] is not None:
            # the pinned bytes are the source of a copy still in flight
            slot["event"].synchronize()
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = all_fields()
            event = torch.cuda.Event()
            event.record(self.stream)
        slot["event"] = event
        return out, event, owned


def _prefetch_device(device, mesh):
    """The device batches go to: ``device``, else the mesh's, else the
    card (raising where there is none)."""
    import torch
    from ..utils.device import resolve_device
    if device is None:
        device = getattr(mesh, "device", None) or "cuda"
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DevicePrefetchIterator(DataSetIterator):
    """Wrap any ``DataSetIterator`` and copy up to ``depth`` batches ahead
    onto ``device`` (default ``"cuda"``; ``"cpu"`` asks for the CPU) on a
    background thread, in stream order (see the module docstring).

    With a ``mesh`` (``parallel/mesh.Mesh``; its device unless ``device``
    is given), partial batches are trimmed to a multiple of the
    ``data_axis`` size — the same policy as ``ParallelWrapper._trim`` —
    and the trimmed global batch is placed whole: the wrapper slices this
    rank's rows itself.  ``seq_axis_name``/``seq_axis`` are kept for the
    JAX package's signature; the time axis is placed whole too.

    The yielded ``DataSet`` holds torch tensors on the device.  Not
    re-entrant: one live iteration at a time (a second concurrent
    ``__iter__`` raises rather than racing two producers over the
    underlying iterator).
    """

    _SENTINEL = object()

    def __init__(self, underlying: DataSetIterator, depth: int = 2, *,
                 mesh=None, data_axis: str = "data",
                 seq_axis_name: Optional[str] = None,
                 seq_axis: Optional[int] = None, registry=None,
                 device=None):
        if isinstance(underlying, AsyncShieldDataSetIterator):
            raise ValueError(
                "iterator is wrapped in AsyncShieldDataSetIterator — it must "
                "not be prefetched from a background thread")
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.device = _prefetch_device(device, mesh)
        self.underlying = underlying
        self.depth = depth
        self.mesh = mesh
        self.data_axis = data_axis
        self.seq_axis_name = seq_axis_name
        self.seq_axis = seq_axis
        self._registry = registry
        self._state_lock = threading.Lock()
        self._active = False

    def batch(self):
        return self.underlying.batch()

    def reset(self):
        self.underlying.reset()

    # ------------------------------------------------------------ placement
    def _data_axis_size(self) -> int:
        if self.mesh is None:
            return 1
        return int(self.mesh.shape.get(self.data_axis, 1))

    def _host_fields(self, ds) -> Optional[list]:
        """A batch's four fields, trimmed to the data axis (None: a batch
        smaller than the data axis)."""
        fields = [getattr(ds, f, None) for f in _FIELDS] \
            if not isinstance(ds, (tuple, list)) else \
            list(ds) + [None] * (4 - len(ds))
        d = self._data_axis_size()
        if d > 1:
            first = fields[0][0] if isinstance(fields[0], (list, tuple)) \
                else fields[0]
            n = int(first.shape[0])
            keep = (n // d) * d
            if keep == 0:
                return None
            if keep != n:
                fields = [None if a is None else
                          [e[:keep] for e in a]
                          if isinstance(a, (list, tuple)) else a[:keep]
                          for a in fields]
        return fields

    # ------------------------------------------------------------ iteration
    def __iter__(self):
        with self._state_lock:
            if self._active:
                raise RuntimeError(
                    "DevicePrefetchIterator is already being iterated — a "
                    "second concurrent iteration would race two producer "
                    "threads over one underlying iterator")
            self._active = True
        try:
            yield from self._run()
        finally:
            with self._state_lock:
                self._active = False

    def _run(self):
        import torch
        etl_h, depth_g, starved_c = _etl_instruments(self._registry)
        if etl_h is not None:
            src_h, h2d_h, wait_h = (etl_h.labels("source"),
                                    etl_h.labels("h2d"),
                                    etl_h.labels("wait"))
            depth_dev = depth_g.labels("device")
            starved_dev = starved_c.labels("device")
        else:
            src_h = h2d_h = wait_h = depth_dev = starved_dev = None
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        err: List[BaseException] = []
        # depth queued + one in the producer's hands + one being consumed
        stager = _Stager(torch, self.device, self.depth + 2)

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                it = iter(self.underlying)
                while True:
                    t0 = monotonic_s()
                    try:
                        ds = next(it)
                    except StopIteration:
                        break
                    t1 = monotonic_s()
                    fields = self._host_fields(ds)
                    placed = None if fields is None else stager.place(fields)
                    t2 = monotonic_s()
                    if src_h is not None:
                        src_h.observe(t1 - t0)
                        h2d_h.observe(t2 - t1)
                    if placed is None:
                        continue
                    if not _put(placed):
                        return                 # consumer went away
                    if depth_dev is not None:
                        depth_dev.set(q.qsize())
            except BaseException as e:  # noqa: BLE001 - relayed to consumer
                err.append(e)
            finally:
                _put(self._SENTINEL)

        t = threading.Thread(target=producer, daemon=True,
                             name="device-prefetch")
        t.start()
        first_get = True
        try:
            while True:
                # the very first get is empty by construction (producer
                # warm-up), not a starvation signal
                if starved_dev is not None and q.empty() and not first_get:
                    starved_dev.inc()
                first_get = False
                t0 = monotonic_s()
                item = q.get()
                if wait_h is not None:
                    wait_h.observe(monotonic_s() - t0)
                    depth_dev.set(q.qsize())
                if item is self._SENTINEL:
                    break
                tensors, event, owned = item
                if event is not None:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(event)
                    for d in owned:
                        d.record_stream(cur)
                item = owned = None
                yield DataSet(*tensors)
        finally:
            stop.set()
            t.join()
        if err:
            raise err[0]


# ================================================================ multiproc
def _mute_shm_tracking() -> None:
    """Stop THIS process's resource tracker from adopting shared-memory
    attachments.  In CPython < 3.13 ``SharedMemory(name=...)`` registers on
    *attach* too, so a worker would co-own (and at exit unregister/unlink)
    slabs the parent created and still owns.  Workers are dedicated
    processes, so the patch is process-wide and never reverted."""
    from multiprocessing import resource_tracker
    orig = resource_tracker.register

    def register(name, rtype):
        if rtype != "shared_memory":
            orig(name, rtype)

    resource_tracker.register = register


def _attach_shm(name: str):
    from multiprocessing import shared_memory
    return shared_memory.SharedMemory(name=name)


def _etl_worker(worker_id: int, num_workers: int, source_factory,
                transform, seed: int, epoch: int, slot_names: Sequence[str],
                slot_bytes: int, slots_per_worker: int, sem, result_q,
                stop_evt) -> None:
    """Worker-process body: iterate a private copy of the source, process
    the interleaved shard ``seq % num_workers == worker_id``, write results
    into this worker's ring slots.  The ETL itself is pure numpy.  Every
    CUDA device is hidden from the process first thing, so user code
    inside ``source_factory``/``transform`` that imports torch can never
    make a context on the training card (CUDA reads the variable when it
    initializes, which nothing in this process has done yet)."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    _mute_shm_tracking()
    shms = [_attach_shm(slot_names[worker_id * slots_per_worker + i])
            for i in range(slots_per_worker)]
    local = 0
    try:
        source = source_factory()
        for _ in range(epoch):
            # replay resets so per-epoch source state (shuffle streams)
            # matches a single-process consumer on the same epoch
            if hasattr(source, "reset"):
                source.reset()
        for seq, ds in enumerate(source):
            if stop_evt.is_set():
                return
            if seq % num_workers != worker_id:
                continue
            t0 = time.perf_counter()
            fields = [None if a is None else np.asarray(a)
                      for a in (ds.features, ds.labels,
                                getattr(ds, "features_mask", None),
                                getattr(ds, "labels_mask", None))]
            if transform is not None:
                rng = np.random.default_rng((seed, epoch, seq))
                fields[0] = np.ascontiguousarray(transform(fields[0], rng))
            etl_s = time.perf_counter() - t0
            payload = [(f, None if a is None else np.ascontiguousarray(a))
                       for f, a in zip(_FIELDS, fields)]
            nbytes = sum(a.nbytes for _, a in payload if a is not None)
            if nbytes <= slot_bytes:
                # wait for one of OUR slots to be released by the parent;
                # stop-aware so shutdown never deadlocks on a full ring
                while not stop_evt.is_set():
                    if sem.acquire(timeout=0.1):
                        break
                else:
                    return
                shm = shms[local % slots_per_worker]
                meta, off = [], 0
                for fname, a in payload:
                    if a is None:
                        continue
                    dst = np.ndarray(a.shape, a.dtype, buffer=shm.buf,
                                     offset=off)
                    np.copyto(dst, a)
                    del dst
                    meta.append((fname, a.shape, a.dtype.str, off))
                    off += a.nbytes
                result_q.put(("slab", seq, worker_id,
                              local % slots_per_worker, etl_s, meta))
                local += 1
            else:
                # batch outgrew the preallocated slab (variable-shape
                # transform): fall back to a pickled handoff for this batch
                result_q.put(("inline", seq, worker_id, None, etl_s,
                              {f: a for f, a in payload if a is not None}))
    except BaseException:  # noqa: BLE001 - relayed to the parent
        result_q.put(("error", worker_id, traceback.format_exc()))
    finally:
        result_q.put(("done", worker_id))
        for shm in shms:
            try:
                shm.close()
            except BufferError:
                pass


class MultiprocessETLIterator(DataSetIterator):
    """Run host ETL (the numpy transform stage) in worker *processes*,
    handing finished batches back through a preallocated shared-memory ring.

    Each worker builds its own source from ``source_factory`` (a
    PICKLABLE zero-argument callable returning a ``DataSetIterator``: a
    module-level function or a ``functools.partial`` of a class, not a
    lambda), iterates it, and fully processes only the interleaved shard
    ``seq % num_workers == worker_id``.  ``transform(features, rng) ->
    features`` runs under ``np.random.default_rng((seed, epoch, seq))``,
    so results do not depend on worker count or scheduling.  Workers are
    spawned, so a script that iterates this stage needs an
    ``if __name__ == "__main__":`` guard around its entry point.

    Ring protocol: every worker owns ``slots_per_worker`` shared-memory
    slabs used cyclically; a semaphore per worker counts free slots.  The
    parent reorders arrivals by sequence number and yields ``DataSet``
    batches.  With the default ``copy_out=True`` the parent copies each
    batch out of the slab (one memcpy) and frees the slot at once — the
    batches are owned arrays, safe to hand to a device prefetch stage.
    ``copy_out=False`` yields ZERO-COPY views into the slab, valid only
    until the next ``next()``.  A batch that outgrows its slab falls back
    to a pickled handoff.

    Worker exceptions reach the consumer as ``RuntimeError`` carrying the
    worker traceback; shutdown (normal end, consumer break, or error)
    stops workers, joins them, and unlinks every slab.
    """

    def __init__(self, source_factory: Callable[[], DataSetIterator],
                 transform=None, *, num_workers: int = 2,
                 slots_per_worker: int = 2, slot_bytes: Optional[int] = None,
                 seed: int = 0, copy_out: bool = True, registry=None,
                 join_timeout_s: float = 10.0):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        if slots_per_worker < 1:
            raise ValueError(
                f"slots_per_worker must be >= 1, got {slots_per_worker}")
        self.source_factory = source_factory
        self.transform = transform
        self.num_workers = num_workers
        self.slots_per_worker = slots_per_worker
        self.slot_bytes = slot_bytes
        self.seed = seed
        self.copy_out = copy_out
        self.join_timeout_s = join_timeout_s
        self._registry = registry
        self._epoch = 0
        self._batch: Optional[int] = None
        self._state_lock = threading.Lock()
        self._active = False
        self.workers: List = []

    def batch(self):
        if self._batch is None:
            self._batch = int(self.source_factory().batch())
        return self._batch

    def reset(self):
        self._epoch += 1

    # ------------------------------------------------------------ internals
    def _probe_slot_bytes(self) -> int:
        """Size slabs from the first (transformed) batch of a parent-side
        probe source; bigger later batches fall back to the inline path.
        Cached on ``slot_bytes``."""
        if self.slot_bytes is not None:
            return int(self.slot_bytes)
        probe = next(iter(self.source_factory()), None)
        if probe is None:
            self.slot_bytes = 1
            return 1
        fields = [None if a is None else np.asarray(a)
                  for a in (probe.features, probe.labels,
                            getattr(probe, "features_mask", None),
                            getattr(probe, "labels_mask", None))]
        if self.transform is not None:
            rng = np.random.default_rng((self.seed, 0, 0))
            fields[0] = np.asarray(self.transform(fields[0], rng))
        self.slot_bytes = max(1, sum(a.nbytes for a in fields
                                     if a is not None))
        return self.slot_bytes

    def __iter__(self):
        with self._state_lock:
            if self._active:
                raise RuntimeError(
                    "MultiprocessETLIterator is already being iterated — a "
                    "second concurrent iteration would tear down the ring "
                    "under the first one")
            self._active = True
        try:
            yield from self._run()
        finally:
            with self._state_lock:
                self._active = False

    def _run(self):
        from multiprocessing import shared_memory
        etl_h, depth_g, starved_c = _etl_instruments(self._registry)
        if etl_h is not None:
            ring_h = etl_h.labels("ring")
            transform_h = etl_h.labels("transform")
            depth_ring = depth_g.labels("ring")
            starved_ring = starved_c.labels("ring")
        else:
            ring_h = transform_h = depth_ring = starved_ring = None
        ctx = multiprocessing.get_context("spawn")
        slot_bytes = self._probe_slot_bytes()
        n_slots = self.num_workers * self.slots_per_worker
        shms = [shared_memory.SharedMemory(create=True, size=slot_bytes)
                for _ in range(n_slots)]
        slot_names = [s.name for s in shms]
        sems = [ctx.Semaphore(self.slots_per_worker)
                for _ in range(self.num_workers)]
        result_q = ctx.Queue()
        stop_evt = ctx.Event()
        workers = [
            ctx.Process(
                target=_etl_worker,
                args=(w, self.num_workers, self.source_factory,
                      self.transform, self.seed, self._epoch, slot_names,
                      slot_bytes, self.slots_per_worker, sems[w],
                      result_q, stop_evt),
                daemon=True, name=f"etl-worker-{w}")
            for w in range(self.num_workers)]
        # the live workers, for a caller that inspects them (their pids)
        self.workers = workers
        for p in workers:
            p.start()
        pending_release: Optional[int] = None   # worker whose slot we hold

        def _release_prev():
            nonlocal pending_release
            if pending_release is not None:
                sems[pending_release].release()
                pending_release = None

        try:
            buffer = {}
            next_seq = 0
            done = 0
            failure: Optional[str] = None
            while True:
                starved_counted = False
                while next_seq not in buffer:
                    if done >= self.num_workers:
                        break
                    # at most one starvation event per awaited batch
                    if (starved_ring is not None and not starved_counted
                            and result_q.empty()):
                        starved_ring.inc()
                        starved_counted = True
                    t0 = monotonic_s()
                    try:
                        msg = result_q.get(timeout=0.5)
                    except queue.Empty:
                        if not any(p.is_alive() for p in workers):
                            done = self.num_workers
                            failure = failure or (
                                "ETL worker(s) died without reporting. If "
                                "this happened at startup, make sure the "
                                "program's entry point is guarded with "
                                "`if __name__ == '__main__':` — "
                                "multiprocessing spawn re-imports the main "
                                "module (see the worker stderr above)")
                        continue
                    if ring_h is not None:
                        ring_h.observe(monotonic_s() - t0)
                    kind = msg[0]
                    if kind == "done":
                        done += 1
                    elif kind == "error":
                        failure = f"ETL worker {msg[1]} failed:\n{msg[2]}"
                        stop_evt.set()
                    else:
                        buffer[msg[1]] = msg
                        if depth_ring is not None:
                            depth_ring.set(len(buffer))
                if next_seq not in buffer:
                    break
                kind, seq, wid, slot, etl_s, payload = buffer.pop(next_seq)
                if transform_h is not None:
                    transform_h.observe(etl_s)
                    depth_ring.set(len(buffer))
                if kind == "slab":
                    shm = shms[wid * self.slots_per_worker + slot]
                    arrays = {}
                    for fname, shape, dtype, off in payload:
                        count = int(np.prod(shape)) if shape else 1
                        view = np.frombuffer(
                            shm.buf, dtype=np.dtype(dtype), count=count,
                            offset=off).reshape(shape)
                        # copy_out: one memcpy buys an OWNED batch — the
                        # slot recycles immediately and nothing downstream
                        # can observe the worker's next write to this slab
                        arrays[fname] = np.array(view) if self.copy_out \
                            else view
                    view = None
                    if self.copy_out:
                        sems[wid].release()
                        yield DataSet(*[arrays.get(f) for f in _FIELDS])
                    else:
                        _release_prev()
                        ds = DataSet(*[arrays.get(f) for f in _FIELDS])
                        arrays = None  # frame must not pin slab views past
                        yield ds       # the consumer's lifetime for them
                        ds = None
                        pending_release = wid
                else:                               # inline fallback
                    _release_prev()
                    yield DataSet(*[payload.get(f) for f in _FIELDS])
                next_seq += 1
            if failure is not None:
                raise RuntimeError(failure)
        finally:
            stop_evt.set()
            _release_prev()
            for p in workers:
                p.join(timeout=self.join_timeout_s)
            for p in workers:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=1.0)
            result_q.cancel_join_thread()
            result_q.close()
            for s in shms:
                try:
                    s.close()
                except BufferError:
                    # the consumer still holds a zero-copy view into this
                    # slab: keep the object referenced so __del__ never
                    # re-raises; the mapping is freed at process exit
                    _UNCLOSED_SLABS.append(s)
                try:
                    s.unlink()
                except FileNotFoundError:
                    pass


# ================================================================= pipeline
def build_input_pipeline(source_factory: Callable[[], DataSetIterator],
                         transform=None, *, num_workers: int = 2,
                         depth: int = 2, mesh=None, seed: int = 0,
                         registry=None, device=None
                         ) -> DevicePrefetchIterator:
    """The full overlapped pipeline in one call: multiprocess ETL feeding a
    k-deep device prefetch onto ``device`` (default ``"cuda"``, or the
    mesh's).  ``num_workers=0`` skips the multiprocess stage (the source
    runs on the prefetch thread — the right choice when the transform is
    cheap or the source is not picklable)."""
    device = _prefetch_device(device, mesh)
    if num_workers > 0:
        inner: DataSetIterator = MultiprocessETLIterator(
            source_factory, transform, num_workers=num_workers, seed=seed,
            registry=registry)
    else:
        inner = source_factory()
        if transform is not None:
            from .transforms import TransformingDataSetIterator
            inner = TransformingDataSetIterator(inner, transform, seed=seed)
    return DevicePrefetchIterator(inner, depth, mesh=mesh, registry=registry,
                                  device=device)
