"""Flight recorder: crash-time forensics for training and serving (port
of ``observability/recorder.py``: the same artifact format and checksum,
so each package's ``load_dump`` reads the other's dumps).

``/metrics`` answers "what is the state *now*"; when a run dies — an
unhandled fit exception, a SIGTERM preemption, a watchdog eviction, a
serving SLO breach — *now* is already gone.  The
:class:`FlightRecorder` keeps the recent past in bounded, thread-safe
ring buffers (per-subsystem **channels** of structured events, the most
recent tracer **spans**, and periodic **metric snapshots**) and, when
something goes wrong, ``dump()`` commits the whole window to disk as an
atomic, checksummed JSON artifact through the same temp-then-rename
path checkpoints use (``faulttolerance/atomic.py``) — the artifact that
explains the 3am incident is on disk before the process is.

Cost model: recording is a dict build plus a deque append under a
per-ring lock (no device values, no clocks beyond one wall read), so
the recorder is ON by default like the metrics registry; a disabled
recorder reduces ``record()`` to one bool check.  Dumping is the cold
path and may import/IO freely.

Channel conventions (callers may invent more):

- ``train``   — per-step loss/grad-norm/throughput records, fit faults
- ``serving`` — batch dispatches, shed/SLO events, predict failures
- ``cluster`` — membership: heartbeats, evictions, chaos faults
- ``broker``  — messaging-layer incidents
- ``health``  — :class:`~.health.HealthMonitor` detections
- ``events``  — mirror of :func:`~.events.emit_event`

Artifact layout (see README "Observability")::

    {"sha256": <hex over canonical payload>,
     "payload": {"format": "dl4j-tpu-flightrec-v1", "reason": ...,
                 "ts": ..., "pid": ..., "seq": ...,
                 "channels": {name: [records...]},
                 "spans": [...], "metric_snapshots": [...],
                 "dropped": {name: n}}}

``load_dump`` re-canonicalizes the payload and verifies the checksum,
so a truncated or bit-flipped artifact is detected, never trusted.
"""
from __future__ import annotations

import collections
import hashlib
import json
import os
import re
import threading
from typing import Any, Dict, List, Optional, Sequence

from .clock import monotonic_s, wall_s
from .registry import MetricsRegistry, default_registry

__all__ = ["FlightRecorder", "get_flight_recorder", "set_flight_recorder",
           "load_dump", "FORMAT", "DUMP_PREFIX"]

FORMAT = "dl4j-tpu-flightrec-v1"
DUMP_PREFIX = "flightrec-"
_REASON_RE = re.compile(r"[^a-zA-Z0-9_.-]+")


class _Ring:
    """Bounded deque of JSON-able records; appends are O(1) under one
    lock, eviction counts are kept so a dump can say what it lost."""

    __slots__ = ("_d", "_lock", "dropped")

    def __init__(self, capacity: int):
        self._d: collections.deque = collections.deque(
            maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        self.dropped = 0

    def append(self, record: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._d) == self._d.maxlen:
                self.dropped += 1
            self._d.append(record)

    def items(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._d)

    def __len__(self) -> int:
        return len(self._d)


class FlightRecorder:
    """Bounded in-memory forensics window with atomic checksummed dumps.

    ``capacity``: records kept per channel; ``span_capacity`` /
    ``snapshot_capacity`` bound the span and metric-snapshot rings.
    ``directory``: where auto-triggered dumps land (fallback:
    ``DL4J_TPU_FLIGHTREC_DIR``); triggers with their own better location
    (the preemption checkpoint store, a job dir) pass it explicitly.
    ``min_dump_interval_s`` rate-limits :meth:`maybe_dump` per reason so
    a repeating fault (an SLO breach probed every second) cannot spam
    the disk — the first dump of a burst is the forensically useful one.
    ``min_snapshot_interval_s`` floors the cadence of periodic metric
    snapshots: a full registry snapshot costs ~1ms, so a fast step loop
    calling :meth:`snapshot_metrics` every N steps would both tax the
    step and compress the 16-slot ring into a couple of seconds of
    history — the time floor keeps the amortized cost ~0 and stretches
    the ring into minutes of trajectory (``dump()`` still captures the
    final state unconditionally).
    """

    def __init__(self, capacity: int = 256, span_capacity: int = 256,
                 snapshot_capacity: int = 16,
                 directory: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 enabled: bool = True,
                 min_dump_interval_s: float = 30.0,
                 min_snapshot_interval_s: float = 10.0):
        self.capacity = int(capacity)
        self.directory = directory
        self.min_dump_interval_s = float(min_dump_interval_s)
        self.min_snapshot_interval_s = float(min_snapshot_interval_s)
        # the throttle clock starts at construction: the first periodic
        # snapshot also waits out the interval (a trajectory needs time
        # to exist; dump() force-captures the final state regardless)
        self._last_snap_mono: float = monotonic_s()
        self._registry = registry
        self._enabled = bool(enabled)
        self._channels: Dict[str, _Ring] = {}
        self._chan_lock = threading.Lock()
        self._spans = _Ring(span_capacity)
        self._snapshots = _Ring(snapshot_capacity)
        self._dump_lock = threading.Lock()
        self._last_dump_mono: Dict[str, float] = {}
        self._seq = 0
        self.dumps: List[str] = []     # paths written by this recorder

    # -- state ---------------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> "FlightRecorder":
        self._enabled = True
        return self

    def disable(self) -> "FlightRecorder":
        self._enabled = False
        return self

    def _reg(self) -> MetricsRegistry:
        return self._registry if self._registry is not None \
            else default_registry()

    def channel(self, name: str) -> _Ring:
        ring = self._channels.get(name)
        if ring is None:
            with self._chan_lock:
                ring = self._channels.setdefault(name, _Ring(self.capacity))
        return ring

    # -- recording (hot path) ------------------------------------------------
    def record(self, channel: str, type: str, **fields: Any) -> None:
        """Append one structured record to ``channel``'s ring.  The
        kwargs dict is fresh per call, so it IS the record — stamping it
        in place keeps the hot path at one dict build, one dict lookup,
        and one locked append.  A caller-supplied ``ts`` is kept (batched
        feeders record when the event *happened*, not when it drained)."""
        if not self._enabled:
            return
        if "ts" not in fields:
            fields["ts"] = wall_s()
        fields["type"] = type
        ring = self._channels.get(channel)
        if ring is None:
            ring = self.channel(channel)
        ring.append(fields)

    def record_span(self, span) -> None:
        """Append a finished tracer span (``Span`` or its dict form)."""
        if not self._enabled:
            return
        self._spans.append(span.to_dict() if hasattr(span, "to_dict")
                           else dict(span))

    def snapshot_metrics(self, registry: Optional[MetricsRegistry] = None,
                         force: bool = False) -> None:
        """Capture one full registry snapshot into the snapshot ring —
        call periodically (the training loop does, every N steps) so a
        dump carries the metric *trajectory*, not just the final value.
        Periodic calls are floored at ``min_snapshot_interval_s`` apart
        (an explicit registry or ``force=True`` bypasses the floor — a
        caller naming the registry wants *that* snapshot now)."""
        if not self._enabled:
            return
        now = monotonic_s()
        if not force and registry is None and \
                now - self._last_snap_mono < self.min_snapshot_interval_s:
            return
        self._last_snap_mono = now
        reg = registry if registry is not None else self._reg()
        self._snapshots.append({"ts": wall_s(), "metrics": reg.snapshot()})

    # -- inspection ----------------------------------------------------------
    def view(self) -> Dict[str, Any]:
        """JSON-able live view (the ``/debug/flightrecorder`` payload)."""
        return {
            "enabled": self._enabled,
            "capacity": self.capacity,
            "directory": self._resolve_directory(None),
            "channels": {n: r.items() for n, r in
                         sorted(self._channels.items())},
            "spans": self._spans.items(),
            "metric_snapshots": self._snapshots.items(),
            "dropped": {n: r.dropped for n, r in
                        sorted(self._channels.items()) if r.dropped},
            "dumps": list(self.dumps),
        }

    # -- dumping (cold path) -------------------------------------------------
    def _resolve_directory(self, directory: Optional[str]) -> Optional[str]:
        return (directory or self.directory
                or os.environ.get("DL4J_TPU_FLIGHTREC_DIR") or None)

    def dump(self, reason: str, directory: Optional[str] = None,
             channels: Optional[Sequence[str]] = None,
             snapshot: bool = True) -> Optional[str]:
        """Commit the current window to an atomic, checksummed artifact;
        returns the path (None when the recorder is disabled).  With no
        resolvable directory the artifact lands in the cwd — an explicit
        ``dump()`` call means the caller wants a file; the automatic
        triggers go through :meth:`maybe_dump`, which never guesses."""
        if not self._enabled:
            return None
        if snapshot:
            try:
                self.snapshot_metrics(force=True)
            except Exception:
                pass   # a broken snapshot must not block crash forensics
        directory = self._resolve_directory(directory) or os.getcwd()
        with self._dump_lock:
            self._seq += 1
            seq = self._seq
        names = (sorted(self._channels) if channels is None
                 else [c for c in channels if c in self._channels])
        payload = {
            "format": FORMAT,
            "reason": str(reason),
            "ts": wall_s(),
            "pid": os.getpid(),
            "seq": seq,
            "channels": {n: self._channels[n].items() for n in names},
            "spans": self._spans.items(),
            "metric_snapshots": self._snapshots.items(),
            "dropped": {n: self._channels[n].dropped for n in names
                        if self._channels[n].dropped},
        }
        blob = _seal(payload)
        slug = _REASON_RE.sub("-", str(reason))[:48] or "dump"
        path = os.path.join(
            directory, f"{DUMP_PREFIX}{slug}-{os.getpid()}-{seq:04d}.json")
        # lazy import: atomic.py is stdlib-only, but routing through the
        # faulttolerance package at module import time would cycle
        from ..faulttolerance.atomic import atomic_write_bytes
        os.makedirs(directory, exist_ok=True)
        atomic_write_bytes(path, blob)
        self.dumps.append(path)
        self._last_dump_mono[str(reason)] = monotonic_s()
        reg = self._reg()
        if reg.enabled:
            reg.counter("flightrecorder_dumps_total",
                        "Flight-recorder artifacts committed to disk",
                        ("reason",)).labels(slug).inc()
        return path

    def maybe_dump(self, reason: str, directory: Optional[str] = None,
                   channels: Optional[Sequence[str]] = None
                   ) -> Optional[str]:
        """The automatic-trigger entry point: dump unless (a) no
        directory is configured anywhere — an auto trigger must never
        litter the cwd — or (b) the same reason dumped less than
        ``min_dump_interval_s`` ago.  Never raises: a failed forensics
        write must not turn an incident into a second incident."""
        if not self._enabled:
            return None
        if self._resolve_directory(directory) is None:
            return None
        last = self._last_dump_mono.get(str(reason))
        if last is not None and \
                monotonic_s() - last < self.min_dump_interval_s:
            return None
        try:
            return self.dump(reason, directory=directory, channels=channels)
        except Exception:
            return None


def _seal(payload: Dict[str, Any]) -> bytes:
    """Wrap ``payload`` with a sha256 over its canonical JSON form."""
    canonical = json.dumps(payload, sort_keys=True, default=str,
                           separators=(",", ":")).encode("utf-8")
    sha = hashlib.sha256(canonical).hexdigest()
    return json.dumps({"sha256": sha, "payload": payload},
                      default=str).encode("utf-8")


def load_dump(path: str, verify: bool = True) -> Dict[str, Any]:
    """Read a flight-recorder artifact and return its payload.  With
    ``verify`` (default) the embedded checksum is recomputed over the
    canonical payload; a mismatch — truncation, bit rot, a hand-edited
    artifact — raises ``ValueError`` rather than returning bad forensics."""
    with open(path, "r", encoding="utf-8") as f:
        artifact = json.load(f)
    payload = artifact.get("payload")
    if payload is None or "sha256" not in artifact:
        raise ValueError(f"{path}: not a flight-recorder artifact")
    if verify:
        canonical = json.dumps(payload, sort_keys=True, default=str,
                               separators=(",", ":")).encode("utf-8")
        want, got = artifact["sha256"], hashlib.sha256(canonical).hexdigest()
        if want != got:
            raise ValueError(
                f"{path}: checksum mismatch (artifact corrupt): "
                f"recorded {want[:12]}…, recomputed {got[:12]}…")
    return payload


# process-global recorder: ON by default (bounded deque appends are in
# the metrics-registry cost class); DL4J_TPU_FLIGHTREC=0 disables, and
# DL4J_TPU_FLIGHTREC_DIR gives auto-triggered dumps a home without code
# changes (the knob production pods flip)
_default: Optional[FlightRecorder] = FlightRecorder(
    enabled=os.environ.get("DL4J_TPU_FLIGHTREC", "1") != "0")
_default_lock = threading.Lock()


def get_flight_recorder() -> Optional[FlightRecorder]:
    """The process-global recorder every built-in trigger point uses
    unless handed an explicit instance; None disables them all."""
    return _default


def set_flight_recorder(recorder: Optional[FlightRecorder]
                        ) -> Optional[FlightRecorder]:
    """Swap the process-global recorder; returns the previous one (tests
    restore it in a finally block)."""
    global _default
    with _default_lock:
        prev, _default = _default, recorder
    return prev
