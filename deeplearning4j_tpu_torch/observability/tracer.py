"""Span-based tracer (port of ``observability/tracer.py``): nested spans
with monotonic timing, cross-thread / cross-process context propagation,
and optional bridging into ``torch.profiler.record_function`` so spans
land on a ``torch.profiler`` timeline beside the CUDA kernels they
launched.

The model is deliberately small (a working subset of OpenTelemetry's):

- a **Span** is a named interval with attributes, a ``trace_id`` shared
  by everything descending from one root, and a ``parent_id``;
- the **active span stack** is thread-local, so ``span()`` nests
  naturally inside one thread;
- a **SpanContext** is the serializable (trace_id, span_id) pair a
  parent hands to another thread (``parallel/master.py`` worker pools)
  or another process (``parallel/master_mp.py`` puts it in the job
  spec); ``attach(ctx)`` re-roots the local stack under the remote
  parent.

Tracing is OFF by default (unlike the metrics registry, which stays on
— spans allocate objects and read clocks, counters are plain float
adds).  A disabled tracer short-circuits ``span()`` to a shared no-op
context manager: no object allocation, no clock reads, no device syncs
ever.
"""
from __future__ import annotations

import contextlib
import os
import threading
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .clock import monotonic_s, wall_s
from .registry import MetricsRegistry, default_registry

__all__ = ["Span", "SpanContext", "Tracer", "get_tracer",
           "set_default_tracer"]

# span-duration histogram bounds: phase timings range from sub-ms host
# work to multi-second aggregation rounds
_SPAN_BUCKETS = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
                 10.0, 60.0)


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass(frozen=True)
class SpanContext:
    """Serializable propagation handle: everything a child span in
    another thread/process needs to join the trace."""
    trace_id: str
    span_id: str

    def to_dict(self) -> Dict[str, str]:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @classmethod
    def from_dict(cls, d: Dict[str, str]) -> "SpanContext":
        return cls(trace_id=str(d["trace_id"]), span_id=str(d["span_id"]))


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    attributes: Dict[str, Any] = field(default_factory=dict)
    start_wall_s: float = 0.0
    _start_mono: float = 0.0
    duration_s: Optional[float] = None

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    @property
    def context(self) -> SpanContext:
        return SpanContext(trace_id=self.trace_id, span_id=self.span_id)

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "start_wall_s": self.start_wall_s,
                "duration_s": self.duration_s,
                "attributes": dict(self.attributes)}


class _RemoteParent:
    """Stack entry representing a span living in another thread/process —
    context-only, never timed or recorded locally."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, ctx: SpanContext):
        self.trace_id = ctx.trace_id
        self.span_id = ctx.span_id


@contextlib.contextmanager
def _noop_cm():
    yield None


class Tracer:
    """Create with ``enabled=True`` (or call :func:`get_tracer` after
    ``set_default_tracer``) to record spans.

    ``registry``: span durations land in a ``span_seconds{name=...}``
    histogram there (defaults to the process-global registry).
    ``bridge_profiler``: wrap every span in a
    ``torch.profiler.record_function`` so host-side phases line up with
    CUDA kernels in a ``torch.profiler`` trace (imports torch lazily —
    the tracer stays dependency-free when the bridge is off).
    ``max_finished``: ring buffer of completed spans kept for
    inspection/tests; 0 keeps none.
    """

    def __init__(self, enabled: bool = False,
                 registry: Optional[MetricsRegistry] = None,
                 bridge_profiler: bool = False,
                 max_finished: int = 1024,
                 event_log=None):
        self._enabled = enabled
        self._registry = registry
        self._bridge_profiler = bridge_profiler
        self._max_finished = max_finished
        self._event_log = event_log
        self._tls = threading.local()
        self._finished: List[Span] = []
        self._finished_lock = threading.Lock()

    # -- state ---------------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> "Tracer":
        self._enabled = True
        return self

    def disable(self) -> "Tracer":
        self._enabled = False
        return self

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current_span(self) -> Optional[Span]:
        st = self._stack()
        for entry in reversed(st):
            if isinstance(entry, Span):
                return entry
        return None

    def current_context(self) -> Optional[SpanContext]:
        """Propagation handle for the innermost active span (remote or
        local); None outside any span or when disabled."""
        st = self._stack()
        if not st:
            return None
        top = st[-1]
        return SpanContext(trace_id=top.trace_id, span_id=top.span_id)

    @property
    def finished_spans(self) -> List[Span]:
        with self._finished_lock:
            return list(self._finished)

    def clear_finished(self) -> None:
        with self._finished_lock:
            self._finished.clear()

    # -- span lifecycle ------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **attributes):
        """Open a nested span; yields the Span (or None when disabled)."""
        if not self._enabled:
            with _noop_cm() as nothing:
                yield nothing
            return
        st = self._stack()
        parent = st[-1] if st else None
        sp = Span(name=name,
                  trace_id=parent.trace_id if parent else _new_id(),
                  span_id=_new_id(),
                  parent_id=parent.span_id if parent else None,
                  attributes=dict(attributes),
                  start_wall_s=wall_s(),
                  _start_mono=monotonic_s())
        st.append(sp)
        annotation = None
        if self._bridge_profiler:
            try:
                import torch
                annotation = torch.profiler.record_function(name)
                annotation.__enter__()
            except Exception:
                annotation = None
        try:
            yield sp
        finally:
            if annotation is not None:
                try:
                    annotation.__exit__(None, None, None)
                except Exception:
                    pass
            sp.duration_s = monotonic_s() - sp._start_mono
            if st and st[-1] is sp:
                st.pop()
            else:  # tolerate out-of-order exits from generator teardown
                try:
                    st.remove(sp)
                except ValueError:
                    pass
            self._record(sp)

    @contextlib.contextmanager
    def attach(self, ctx: Optional[SpanContext]):
        """Continue a trace started elsewhere: spans opened inside this
        context parent onto ``ctx`` (worker threads get the master's
        context; worker processes get it from the serialized job spec).
        A None ctx (or a disabled tracer) is a no-op, so call sites can
        propagate unconditionally."""
        if not self._enabled or ctx is None:
            with _noop_cm():
                yield self
            return
        st = self._stack()
        entry = _RemoteParent(ctx)
        st.append(entry)
        try:
            yield self
        finally:
            try:
                st.remove(entry)
            except ValueError:
                pass

    # -- sinks ---------------------------------------------------------------
    def _record(self, sp: Span) -> None:
        if self._max_finished:
            with self._finished_lock:
                self._finished.append(sp)
                if len(self._finished) > self._max_finished:
                    del self._finished[:len(self._finished)
                                       - self._max_finished]
        reg = self._registry if self._registry is not None \
            else default_registry()
        if reg.enabled:
            reg.histogram("span_seconds",
                          "Tracer span durations by span name",
                          ("name",), buckets=_SPAN_BUCKETS) \
               .labels(sp.name).observe(sp.duration_s)
        if self._event_log is not None:
            self._event_log.emit("span", **sp.to_dict())
        # finished spans also land in the flight recorder's span ring so
        # a crash dump carries the recent execution timeline
        from .recorder import get_flight_recorder
        rec = get_flight_recorder()
        if rec is not None:
            rec.record_span(sp)


# env opt-in: DL4J_TPU_TRACE=1 enables the default tracer at import time
# (the knob production hosts flip without code changes); =profiler also
# bridges spans into torch.profiler captures.
_env = os.environ.get("DL4J_TPU_TRACE", "")
_default_tracer = Tracer(enabled=bool(_env),
                         bridge_profiler=_env.lower() == "profiler")
_default_tracer_lock = threading.Lock()


def get_tracer() -> Tracer:
    """The process-global tracer every built-in instrumentation point
    uses unless handed an explicit instance.  Disabled by default."""
    return _default_tracer


def set_default_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-global tracer; returns the previous one."""
    global _default_tracer
    with _default_tracer_lock:
        prev, _default_tracer = _default_tracer, tracer
    return prev
