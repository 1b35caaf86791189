"""deeplearning4j_tpu_torch.observability — metrics, tracing and crash
forensics (port of ``observability/``; pure host code except the step
profiler's sampled CUDA events and allocator reads).

- :mod:`registry` — dependency-free Counter/Gauge/Histogram with label
  sets; thread-safe; process-global default + injectable instances;
- :mod:`exposition` — Prometheus text format (byte-equal to the JAX
  package's for the same operations);
- :mod:`tracer` — nested spans on monotonic clocks with cross-thread /
  cross-process context propagation and optional bridging into
  ``torch.profiler.record_function``;
- :mod:`events` — structured JSONL event log for offline analysis;
- :mod:`listener` — ``MetricsListener`` publishing score/throughput/
  grad-norm/device-memory from the ``TrainingListener`` hook points;
- :mod:`clock` — the monotonic/wall helpers everything above reads;
- :mod:`quantiles` — sliding-window exact quantiles (``LatencyWindow``)
  and ``bucket_quantile`` over histogram buckets;
- :mod:`recorder` — the flight recorder: bounded ring buffers of recent
  spans/events/metric snapshots per subsystem channel, dumped as atomic
  checksummed JSON artifacts on crashes and preemptions;
- :mod:`health` — streaming anomaly detection (NaN loss/grads, EWMA
  spike, throughput regression, MFU regression, padding drift, serving
  p99/shed-rate, generation TTFT/ITL);
- :mod:`profiler` — the step profiler: per-step phase attribution
  (etl/h2d/dispatch/device/listener/forensics/checkpoint) with a
  SAMPLED device fence, dispatch-depth gauge, card-derived MFU and
  live-bytes watermarks, and Chrome-trace export.

Cost model: METRICS are on by default and
``default_registry().disable()`` short-circuits every instrument write to
one bool check; TRACING is off by default (enable via
``DL4J_TPU_TRACE=1|profiler`` or an injected ``Tracer``).  Only the step
profiler's sampled fence waits for the device.
"""
from __future__ import annotations

from .clock import monotonic_s, wall_s
from .events import EventLog, configure_event_log, emit_event, get_event_log
from .exposition import CONTENT_TYPE, escape_label_value, render_text
from .health import (Detection, HealthConfig, HealthMonitor,
                     HealthTermination, get_health_monitor,
                     set_health_monitor)
from .profiler import (StepProfiler, chrome_trace, dump_chrome_trace,
                       load_chrome_trace, phase_summary, record_slices,
                       step_profiler_for, stepprof_enabled)
from .quantiles import LatencyWindow, bucket_quantile
from .recorder import (FlightRecorder, get_flight_recorder, load_dump,
                       set_flight_recorder)
from .registry import (DEFAULT_BUCKETS, Counter, Gauge, Histogram,
                       MetricsRegistry, default_registry,
                       set_default_registry)
from .tracer import Span, SpanContext, Tracer, get_tracer, set_default_tracer

__all__ = [
    "CONTENT_TYPE", "Counter", "DEFAULT_BUCKETS", "Detection", "EventLog",
    "FlightRecorder", "Gauge", "HealthConfig", "HealthMonitor",
    "HealthTermination", "Histogram", "LatencyWindow", "MetricsListener",
    "MetricsRegistry", "Span",
    "SpanContext", "StepProfiler", "Tracer", "bucket_quantile",
    "chrome_trace", "configure_event_log",
    "default_registry", "dump_chrome_trace",
    "emit_event", "escape_label_value", "get_event_log",
    "get_flight_recorder", "get_health_monitor", "get_tracer",
    "load_chrome_trace", "load_dump",
    "monotonic_s", "phase_summary", "record_slices", "render_text",
    "set_default_registry",
    "set_default_tracer", "set_flight_recorder", "set_health_monitor",
    "step_profiler_for", "stepprof_enabled", "wall_s",
]


def __getattr__(name):
    # MetricsListener imports train.listeners, which itself uses the
    # clock helpers here — resolve lazily to keep the import DAG acyclic
    if name == "MetricsListener":
        from .listener import MetricsListener
        return MetricsListener
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
