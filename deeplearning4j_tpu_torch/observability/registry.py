"""Dependency-free metrics registry (port of ``observability/registry.py``,
the same data model, so the two packages render the same text for the
same operations): Counter / Gauge / Histogram with
label sets, thread-safe, with a process-global default registry plus
injectable instances.

Design constraints (the serving/training tiers both ride this):

- **stdlib only** — importable in minimal serving images;
- **off-by-default cheap** — a disabled registry turns every instrument
  write into a single attribute check and an early return, and no code
  path here ever touches a device value (callers hand us host floats);
- **bounded locking** — child creation takes the instrument lock once,
  after which the hot path is one per-child lock around plain float math
  (Python's ``+=`` on a float attribute is not atomic across threads).

The exposition formats (Prometheus text, JSON snapshot) live in
``exposition.py``; this module only owns the data model.
"""
from __future__ import annotations

import re
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry", "set_default_registry", "DEFAULT_BUCKETS"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Prometheus client-library default latency buckets (seconds).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class _Child:
    """One (metric, label-values) time series."""

    __slots__ = ("_metric", "_lock")

    def __init__(self, metric: "_Instrument"):
        self._metric = metric
        self._lock = threading.Lock()

    @property
    def _on(self) -> bool:
        return self._metric._registry._enabled


class _CounterChild(_Child):
    __slots__ = ("_value",)

    def __init__(self, metric):
        super().__init__(metric)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if not self._on:
            return
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class _GaugeChild(_Child):
    __slots__ = ("_value",)

    def __init__(self, metric):
        super().__init__(metric)
        self._value = 0.0

    def set(self, value: float) -> None:
        if not self._on:
            return
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not self._on:
            return
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value


class _HistogramChild(_Child):
    __slots__ = ("_bucket_counts", "_sum", "_count")

    def __init__(self, metric):
        super().__init__(metric)
        self._bucket_counts = [0] * len(metric.buckets)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        if not self._on:
            return
        value = float(value)
        with self._lock:
            # non-cumulative per-bucket counts; exposition cumulates
            for i, bound in enumerate(self._metric.buckets):
                if value <= bound:
                    self._bucket_counts[i] += 1
                    break
            self._sum += value
            self._count += 1

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def count(self) -> int:
        return self._count

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """[(upper_bound, cumulative_count), ...] ending at (+inf, count)."""
        out, acc = [], 0
        with self._lock:
            counts = list(self._bucket_counts)
            total = self._count
        for bound, c in zip(self._metric.buckets, counts):
            acc += c
            out.append((bound, acc))
        out.append((float("inf"), total))
        return out


class _Instrument:
    """Base for Counter/Gauge/Histogram: a named family of label children."""

    kind = "untyped"
    _child_cls = _Child

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labelnames: Sequence[str]):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r}")
        self._registry = registry
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], _Child] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            # eagerly materialize the unlabeled series so zero-valued
            # metrics still appear in expositions
            self._children[()] = self._child_cls(self)

    def labels(self, *values, **kw):
        if kw:
            if values:
                raise ValueError("pass label values positionally OR by name")
            try:
                values = tuple(kw[ln] for ln in self.labelnames)
            except KeyError as e:
                raise ValueError(f"missing label {e} for {self.name}") from e
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, got {values}")
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.setdefault(values,
                                                  self._child_cls(self))
        return child

    def _unlabeled(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; call .labels()")
        return self._children[()]

    def samples(self) -> List[Tuple[Tuple[str, ...], _Child]]:
        """Deterministic (sorted by label values) child listing."""
        with self._lock:
            items = list(self._children.items())
        return sorted(items, key=lambda kv: kv[0])


class Counter(_Instrument):
    kind = "counter"
    _child_cls = _CounterChild

    def inc(self, amount: float = 1.0) -> None:
        self._unlabeled().inc(amount)

    @property
    def value(self) -> float:
        return self._unlabeled().value


class Gauge(_Instrument):
    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, value: float) -> None:
        self._unlabeled().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._unlabeled().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._unlabeled().dec(amount)

    @property
    def value(self) -> float:
        return self._unlabeled().value


class Histogram(_Instrument):
    kind = "histogram"
    _child_cls = _HistogramChild

    def __init__(self, registry, name, help, labelnames,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        buckets = tuple(sorted(float(b) for b in buckets))
        if not buckets:
            raise ValueError("histogram needs at least one bucket bound")
        if any(b != b or b == float("inf") for b in buckets):
            raise ValueError("bucket bounds must be finite (+Inf is implicit)")
        self.buckets = buckets
        super().__init__(registry, name, help, labelnames)

    def observe(self, value: float) -> None:
        self._unlabeled().observe(value)


class MetricsRegistry:
    """Thread-safe instrument store.  ``counter``/``gauge``/``histogram``
    are get-or-create: repeated calls with the same name return the same
    instrument (and raise on kind/label mismatch, which would otherwise
    corrupt the exposition)."""

    def __init__(self, enabled: bool = True):
        self._metrics: Dict[str, _Instrument] = {}
        self._lock = threading.Lock()
        self._enabled = enabled

    # -- lifecycle -----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> "MetricsRegistry":
        self._enabled = True
        return self

    def disable(self) -> "MetricsRegistry":
        """No-op fast path: instrument writes become a bool check."""
        self._enabled = False
        return self

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    # -- instrument factories ------------------------------------------------
    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(self, name, help, labelnames, **kw)
                self._metrics[name] = m
                return m
        if not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}")
        if m.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} registered with labels {m.labelnames}, "
                f"requested {tuple(labelnames)}")
        if "buckets" in kw:
            want = tuple(sorted(float(b) for b in kw["buckets"]))
            if want != m.buckets:
                raise ValueError(
                    f"histogram {name!r} registered with buckets "
                    f"{m.buckets}, requested {want}")
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    # -- introspection -------------------------------------------------------
    def collect(self) -> List[_Instrument]:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view of every time series (the /metrics?format=json
        payload and the offline-analysis sidecar of the Prometheus text).
        Histogram samples carry derived ``p50``/``p99`` summaries
        (nearest-rank over the bucket counts — an upper estimate bounded
        by bucket width) so dashboards consuming the JSON exposition
        don't re-implement quantile math; the Prometheus text format is
        unchanged."""
        from .quantiles import bucket_quantile
        out: Dict[str, Any] = {}
        for m in self.collect():
            samples = []
            for values, child in m.samples():
                labels = dict(zip(m.labelnames, values))
                if m.kind == "histogram":
                    cum = child.cumulative_buckets()
                    samples.append({
                        "labels": labels,
                        "buckets": [[b if b != float("inf") else "+Inf", c]
                                    for b, c in cum],
                        "sum": child.sum, "count": child.count,
                        "p50": bucket_quantile(cum, 0.50),
                        "p99": bucket_quantile(cum, 0.99)})
                else:
                    samples.append({"labels": labels, "value": child.value})
            out[m.name] = {"type": m.kind, "help": m.help,
                          "samples": samples}
        return out


_default = MetricsRegistry(enabled=True)
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-global registry every built-in instrumentation point
    writes to unless handed an explicit instance."""
    return _default


def set_default_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-global registry; returns the previous one (tests
    restore it in a finally block)."""
    global _default
    with _default_lock:
        prev, _default = _default, registry
    return prev
