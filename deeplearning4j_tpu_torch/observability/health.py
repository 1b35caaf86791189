"""Streaming training/serving health monitor (port of
``observability/health.py``): anomaly detection over the signals the
registry already collects, reacting *before* a run is wasted.

The registry records what happened; nothing watches it.  A NaN gradient
at step 40k silently poisons every later step, a loss spike marks the
moment divergence started, a throughput collapse burns budget at full
allocation — all visible in ``/metrics`` *if a human is looking*.
:class:`HealthMonitor` is the machine that looks:

==================  ======================================  ==============
detector            signal                                  detection kind
==================  ======================================  ==============
non-finite          loss / grad-norm is NaN or +-Inf        ``nan_loss`` /
                                                            ``nan_grad``
EWMA z-score spike  loss / grad-norm vs running mean+var    ``loss_spike`` /
                                                            ``grad_spike``
throughput          steady examples/sec EWMA collapses      ``throughput_``
regression          below a fraction of the peak EWMA       ``regression``
padding drift       padding-ratio EWMA drifts off its       ``padding_``
                    warmed baseline                         ``drift``
serving p99         sliding-window p99 over a target        ``serving_p99``
                    (:class:`~.quantiles.LatencyWindow`)
shed rate           shed fraction of recent admissions      ``shed_rate``
==================  ======================================  ==============

Every detection emits a structured event (:func:`~.events.emit_event` +
the flight-recorder ``health`` channel), lands in
``health_detections_total{kind}``, and flips :meth:`state` to
``degraded`` — which both HTTP servers surface as a third ``/health``
state between ``ok`` and ``unready`` (degraded = still serving, but a
human should look).  Detections can also **act**: a bound checkpoint
hook (``fit`` binds its :class:`FitCheckpointer`) takes an immediate
crash-consistent save — the artifact from *before* the divergence — and
with ``stop_training=True`` (opt-in) the fit loop halts cleanly through
the same contract the terminations path uses.

False-positive posture: every statistical detector warms up on real
data before it may fire (``warmup_steps`` / ``min_samples``), spikes are
measured in EWMA standard deviations with a variance floor (a perfectly
flat loss cannot divide by zero into a false alarm), and same-kind
detections within ``dedupe_s`` merge into one (a NaN run is ONE
incident, not ten thousand).
"""
from __future__ import annotations

import collections
import math
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .clock import monotonic_s, wall_s
from .events import emit_event
from .quantiles import LatencyWindow
from .registry import MetricsRegistry, default_registry

__all__ = ["HealthConfig", "HealthMonitor", "Detection",
           "HealthTermination", "get_health_monitor", "set_health_monitor"]

# detection kinds whose cause does not decay with time: a NaN in the
# params poisons everything after it, so degraded sticks until clear()
_STICKY_KINDS = frozenset(("nan_loss", "nan_grad"))


@dataclass(frozen=True)
class HealthConfig:
    """Detector thresholds + reaction policy; defaults are deliberately
    conservative (few false positives on noisy-but-healthy runs)."""

    # EWMA spike detectors (loss / grad-norm)
    ewma_alpha: float = 0.05
    z_threshold: float = 8.0
    warmup_steps: int = 20
    # the fit loops fetch the grad norm off-device only every Nth step:
    # it is the monitor's one per-step device read (~15us on CPU), and a
    # NaN gradient poisons the params so the NEXT step's loss — checked
    # every step for free — goes NaN anyway; subsampling trades at most
    # grad_check_every steps of detection latency for <2% step overhead
    grad_check_every: int = 4
    # throughput regression: steady EWMA below ratio * peak EWMA
    throughput_floor_ratio: float = 0.5
    throughput_warmup: int = 20
    # MFU regression: sampled-fence MFU EWMA (StepProfiler) below ratio *
    # peak EWMA; fences arrive 1-in-sample_every steps, so the warmup is
    # counted in SAMPLES, not steps
    mfu_floor_ratio: float = 0.5
    mfu_warmup: int = 8
    # padding drift: |ewma - baseline| above this absolute ratio delta
    padding_drift: float = 0.25
    # serving detectors
    serving_window: int = 256
    serving_min_samples: int = 32
    p99_target_ms: Optional[float] = None
    shed_rate_threshold: float = 0.5
    # generation detectors: time-to-first-token and inter-token latency
    # p99 over their own sliding windows (the decode engine feeds them)
    ttft_p99_target_ms: Optional[float] = None
    itl_p99_target_ms: Optional[float] = None
    # reaction policy
    degraded_cooldown_s: float = 300.0   # non-sticky detections age out
    dedupe_s: float = 30.0               # same-kind merge window
    checkpoint_on_detection: bool = True
    stop_training: bool = False          # opt-in: halt fit on detection


@dataclass
class Detection:
    """One confirmed anomaly (possibly merging a same-kind burst)."""

    kind: str
    reason: str
    value: Optional[float] = None
    threshold: Optional[float] = None
    step: Optional[int] = None
    ts: float = field(default_factory=wall_s)
    count: int = 1
    _mono: float = field(default_factory=monotonic_s, repr=False)

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "reason": self.reason,
                "value": self.value, "threshold": self.threshold,
                "step": self.step, "ts": self.ts, "count": self.count}


class _Ewma:
    """Exponentially-weighted mean + variance (West's update)."""

    __slots__ = ("alpha", "n", "mean", "var")

    def __init__(self, alpha: float):
        self.alpha = float(alpha)
        self.n = 0
        self.mean = 0.0
        self.var = 0.0

    def update(self, x: float) -> None:
        x = float(x)
        if self.n == 0:
            self.mean, self.var = x, 0.0
        else:
            d = x - self.mean
            self.mean += self.alpha * d
            self.var = (1.0 - self.alpha) * (self.var
                                             + self.alpha * d * d)
        self.n += 1

    def z(self, x: float) -> float:
        # variance floor: a near-constant signal must not turn numeric
        # dust into an infinite z-score
        std = max(math.sqrt(self.var), 1e-3 * (abs(self.mean) + 1e-6))
        return (float(x) - self.mean) / std

    def spikes_above(self, x: float, z_threshold: float) -> bool:
        """``z(x) > z_threshold`` without the sqrt: the fit loop asks
        this every step, so the healthy path is two multiplies and two
        compares (``d > 0 and d² > z²·max(var, floor²)`` is exactly the
        threshold test on the floored std)."""
        d = x - self.mean
        if d <= 0.0:
            return False
        floor = 1e-3 * (abs(self.mean) + 1e-6)
        v = self.var if self.var > floor * floor else floor * floor
        return d * d > z_threshold * z_threshold * v


class HealthMonitor:
    """Attach globally (``set_health_monitor(HealthMonitor())``) and the
    fit loops, serving admission, and HTTP ``/health`` pick it up; or
    inject an instance where isolation matters (tests).  All entry
    points are thread-safe — the train loop, serving request threads,
    and health probes feed/read one monitor concurrently."""

    def __init__(self, config: Optional[HealthConfig] = None,
                 registry: Optional[MetricsRegistry] = None,
                 recorder=None):
        self.config = config or HealthConfig()
        self._registry = registry
        self._recorder = recorder
        self._lock = threading.Lock()
        self._loss = _Ewma(self.config.ewma_alpha)
        self._gnorm = _Ewma(self.config.ewma_alpha)
        self._eps = _Ewma(self.config.ewma_alpha)      # examples/sec
        self._eps_peak = 0.0
        self._mfu = _Ewma(self.config.ewma_alpha)      # sampled-fence MFU
        self._mfu_peak = 0.0
        self._pad = _Ewma(self.config.ewma_alpha)
        self._pad_baseline: Optional[float] = None
        self._steps = 0
        self._latency = LatencyWindow(self.config.serving_window)
        self._ttft = LatencyWindow(self.config.serving_window)
        self._itl = LatencyWindow(self.config.serving_window)
        self._shed_ring: collections.deque = collections.deque(
            maxlen=self.config.serving_window)
        self._detections: collections.deque = collections.deque(maxlen=64)
        self._by_kind: Dict[str, Detection] = {}
        self._stop = False
        self._save_fn = None
        self._saved_kinds: set = set()
        self.checkpoint_saves = 0

    # -- plumbing ------------------------------------------------------------
    def _reg(self) -> MetricsRegistry:
        return self._registry if self._registry is not None \
            else default_registry()

    def _rec(self):
        if self._recorder is not None:
            return self._recorder
        from .recorder import get_flight_recorder
        return get_flight_recorder()

    def bind_checkpoint(self, save_fn) -> None:
        """Bind ``save_fn(detection) -> path`` — called once per (deduped)
        detection when ``checkpoint_on_detection`` is set.  ``fit`` binds
        its checkpointer so a detection leaves a crash-consistent save
        from before the damage spreads."""
        self._save_fn = save_fn

    # -- detection core ------------------------------------------------------
    def _detect(self, kind: str, reason: str, value: Optional[float] = None,
                threshold: Optional[float] = None,
                step: Optional[int] = None) -> Optional[Detection]:
        """Register one anomaly; returns the Detection, or None when it
        merged into a same-kind detection inside the dedupe window."""
        now = monotonic_s()
        with self._lock:
            prev = self._by_kind.get(kind)
            if prev is not None and now - prev._mono < self.config.dedupe_s:
                prev.count += 1
                prev._mono = now
                return None
            det = Detection(kind=kind, reason=reason, value=value,
                            threshold=threshold, step=step)
            self._by_kind[kind] = det
            self._detections.append(det)
        reg = self._reg()
        if reg.enabled:
            reg.counter("health_detections_total",
                        "Anomalies confirmed by the health monitor",
                        ("kind",)).labels(kind).inc()
            reg.gauge("health_degraded",
                      "1 while the health monitor reports degraded").set(1)
        emit_event("health_detection", **det.to_dict())
        rec = self._rec()
        if rec is not None:
            rec.record("health", "detection", **det.to_dict())
        if self.config.stop_training:
            self._stop = True
        if self._save_fn is not None and self.config.checkpoint_on_detection \
                and kind not in self._saved_kinds:
            # one emergency save per kind: a sticky detection re-firing
            # every dedupe_s must not keep saving (possibly poisoned)
            # params until the manager's keep_last window holds nothing
            # from before the incident
            self._saved_kinds.add(kind)
            try:
                self._save_fn(det)
                self.checkpoint_saves += 1
            except Exception:
                pass   # a failed emergency save must not kill the step
        return det

    # -- training-side observers --------------------------------------------
    def observe_step(self, loss: Optional[float] = None,
                     grad_norm: Optional[float] = None,
                     examples_per_sec: Optional[float] = None,
                     padding_ratio: Optional[float] = None,
                     step: Optional[int] = None) -> List[Detection]:
        """Feed one training step's host-side signals; returns any NEW
        detections (deduped same-kind repeats return empty).  This runs
        inside the train step loop, so the healthy path is kept to EWMA
        updates and square-compare spike checks — no sqrt, no closures,
        no allocation beyond the (usually empty) result list."""
        cfg = self.config
        out: List[Detection] = []
        self._steps += 1
        if loss is not None:
            loss = float(loss)
            ew = self._loss
            if not math.isfinite(loss):
                d = self._detect("nan_loss", "non-finite training loss",
                                 value=loss, step=step)
                if d is not None:
                    out.append(d)
            else:
                if ew.n >= cfg.warmup_steps and \
                        ew.spikes_above(loss, cfg.z_threshold):
                    d = self._detect(
                        "loss_spike",
                        f"loss {loss:.6g} is {ew.z(loss):.1f} EWMA std devs "
                        f"above mean {ew.mean:.6g}",
                        value=loss, threshold=cfg.z_threshold, step=step)
                    if d is not None:
                        out.append(d)
                ew.update(loss)
        if grad_norm is not None:
            g = float(grad_norm)
            ew = self._gnorm
            if not math.isfinite(g):
                d = self._detect("nan_grad",
                                 "non-finite gradient global norm",
                                 value=g, step=step)
                if d is not None:
                    out.append(d)
            else:
                if ew.n >= cfg.warmup_steps and \
                        ew.spikes_above(g, cfg.z_threshold):
                    d = self._detect(
                        "grad_spike",
                        f"grad norm {g:.6g} is {ew.z(g):.1f} EWMA std devs "
                        f"above mean {ew.mean:.6g}",
                        value=g, threshold=cfg.z_threshold, step=step)
                    if d is not None:
                        out.append(d)
                ew.update(g)
        if examples_per_sec is not None and examples_per_sec > 0:
            ew = self._eps
            ew.update(examples_per_sec)
            if ew.n >= cfg.throughput_warmup:
                if ew.mean > self._eps_peak:
                    self._eps_peak = ew.mean
                floor = cfg.throughput_floor_ratio * self._eps_peak
                if self._eps_peak > 0 and ew.mean < floor:
                    d = self._detect(
                        "throughput_regression",
                        f"steady throughput {ew.mean:.1f} ex/s fell "
                        f"below {cfg.throughput_floor_ratio:.0%} of peak "
                        f"{self._eps_peak:.1f}",
                        value=ew.mean, threshold=floor, step=step)
                    if d is not None:
                        out.append(d)
        if padding_ratio is not None:
            ew = self._pad
            ew.update(padding_ratio)
            if ew.n == cfg.warmup_steps:
                self._pad_baseline = ew.mean
            elif self._pad_baseline is not None and \
                    abs(ew.mean - self._pad_baseline) > cfg.padding_drift:
                d = self._detect(
                    "padding_drift",
                    f"padding ratio EWMA {ew.mean:.3f} drifted from "
                    f"its warmed baseline {self._pad_baseline:.3f}",
                    value=ew.mean, threshold=cfg.padding_drift, step=step)
                if d is not None:
                    out.append(d)
        return out

    def observe_mfu(self, mfu: Optional[float],
                    program: Optional[str] = None,
                    step: Optional[int] = None) -> List[Detection]:
        """Feed one sampled-fence MFU reading (the StepProfiler's
        roofline sample).  Same shape as the throughput detector: the
        EWMA tracks its own peak, and a collapse below
        ``mfu_floor_ratio`` x peak fires ``mfu_regression`` — the "same
        step rate, emptier device" signal a pure examples/sec detector
        cannot see (e.g. a padding blowup keeps steps/s flat while
        useful FLOPs crater)."""
        cfg = self.config
        out: List[Detection] = []
        if mfu is None:
            return out
        mfu = float(mfu)
        if not math.isfinite(mfu) or mfu <= 0:
            return out
        ew = self._mfu
        ew.update(mfu)
        if ew.n >= cfg.mfu_warmup:
            if ew.mean > self._mfu_peak:
                self._mfu_peak = ew.mean
            floor = cfg.mfu_floor_ratio * self._mfu_peak
            if self._mfu_peak > 0 and ew.mean < floor:
                prog = f" [{program}]" if program else ""
                d = self._detect(
                    "mfu_regression",
                    f"sampled MFU EWMA{prog} {ew.mean:.4f} fell below "
                    f"{cfg.mfu_floor_ratio:.0%} of peak "
                    f"{self._mfu_peak:.4f}",
                    value=ew.mean, threshold=floor, step=step)
                if d is not None:
                    out.append(d)
        return out

    # -- serving-side observers ---------------------------------------------
    def observe_request(self, seconds: Optional[float] = None,
                        shed: bool = False) -> List[Detection]:
        """Feed one serving request outcome (latency and/or a shed)."""
        cfg = self.config
        out: List[Detection] = []
        self._shed_ring.append(1 if shed else 0)
        if seconds is not None:
            self._latency.observe(seconds)
        if len(self._shed_ring) >= cfg.serving_min_samples:
            rate = sum(self._shed_ring) / len(self._shed_ring)
            if rate >= cfg.shed_rate_threshold:
                d = self._detect(
                    "shed_rate",
                    f"{rate:.0%} of the last {len(self._shed_ring)} "
                    "admissions were shed",
                    value=rate, threshold=cfg.shed_rate_threshold)
                if d is not None:
                    out.append(d)
        if cfg.p99_target_ms is not None and \
                len(self._latency) >= cfg.serving_min_samples:
            p99 = self._latency.quantile(0.99)
            if p99 is not None and p99 * 1e3 > cfg.p99_target_ms:
                d = self._detect(
                    "serving_p99",
                    f"p99 {p99 * 1e3:.1f} ms over target "
                    f"{cfg.p99_target_ms:.1f} ms",
                    value=p99 * 1e3, threshold=cfg.p99_target_ms)
                if d is not None:
                    out.append(d)
        return out

    def observe_generation(self, ttft_s: Optional[float] = None,
                           itl_s: Optional[float] = None
                           ) -> List[Detection]:
        """Feed one generation latency sample: time-to-first-token
        (request admitted → first token emitted, covers queue wait +
        prefill) and/or inter-token latency (one decode-step boundary to
        the next for a sequence).  Each has its own sliding-window p99
        detector so a decode tier drowning in prefills pages on TTFT
        while steady decode stays green — and vice versa."""
        cfg = self.config
        out: List[Detection] = []
        for window, sample, target, kind, label in (
                (self._ttft, ttft_s, cfg.ttft_p99_target_ms,
                 "generation_ttft_p99", "time-to-first-token"),
                (self._itl, itl_s, cfg.itl_p99_target_ms,
                 "generation_itl_p99", "inter-token latency")):
            if sample is None:
                continue
            window.observe(sample)
            if target is None or len(window) < cfg.serving_min_samples:
                continue
            p99 = window.quantile(0.99)
            if p99 is not None and p99 * 1e3 > target:
                d = self._detect(
                    kind,
                    f"generation {label} p99 {p99 * 1e3:.1f} ms over "
                    f"target {target:.1f} ms",
                    value=p99 * 1e3, threshold=target)
                if d is not None:
                    out.append(d)
        return out

    def note_slo_breach(self, detail: str, **fields: Any
                        ) -> Optional[Detection]:
        """Admission control reports an SLO-window breach edge."""
        return self._detect("slo_breach", detail, **fields)

    # -- state ---------------------------------------------------------------
    def should_stop(self) -> bool:
        """True once a detection occurred under ``stop_training=True`` —
        the fit loops (and :class:`HealthTermination`) poll this."""
        return self._stop

    def state(self) -> str:
        """``"ok"`` or ``"degraded"``: degraded while any sticky (NaN)
        detection exists or any detection is younger than the cooldown."""
        now = monotonic_s()
        degraded = False
        with self._lock:
            for det in self._detections:
                if det.kind in _STICKY_KINDS or \
                        now - det._mono < self.config.degraded_cooldown_s:
                    degraded = True
                    break
        reg = self._reg()
        if reg.enabled:
            # keep the gauge consistent with what /health reports: a
            # non-sticky detection aging past the cooldown must drop the
            # metric too, not page forever until an operator clear()
            reg.gauge("health_degraded",
                      "1 while the health monitor reports degraded"
                      ).set(1 if degraded else 0)
        return "degraded" if degraded else "ok"

    def reasons(self) -> List[str]:
        now = monotonic_s()
        with self._lock:
            return [f"{d.kind}: {d.reason}" for d in self._detections
                    if d.kind in _STICKY_KINDS
                    or now - d._mono < self.config.degraded_cooldown_s]

    def status(self) -> Dict[str, Any]:
        """The ``/health`` embed: state + active reasons + history."""
        with self._lock:
            dets = [d.to_dict() for d in self._detections]
        return {"state": self.state(), "reasons": self.reasons(),
                "detections": dets, "stopped": self._stop,
                "checkpoint_saves": self.checkpoint_saves,
                "steps_observed": self._steps}

    def clear(self) -> None:
        """Operator acknowledgement: drop all detections (including
        sticky ones) and re-arm; the statistical state is kept."""
        with self._lock:
            self._detections.clear()
            self._by_kind.clear()
            self._saved_kinds.clear()
            self._stop = False
        reg = self._reg()
        if reg.enabled:
            reg.gauge("health_degraded",
                      "1 while the health monitor reports degraded").set(0)


class HealthTermination:
    """Iteration-level termination condition bridging the monitor into
    the existing early-stopping terminations path (duck-typed to
    ``earlystopping.terminations.IterationTerminationCondition`` — same
    ``initialize()``/``terminate(last_score)`` contract)::

        conf = EarlyStoppingConfiguration(
            iteration_terminations=[HealthTermination(monitor)], ...)
    """

    def __init__(self, monitor: "HealthMonitor"):
        self.monitor = monitor

    def initialize(self) -> None:
        pass

    def terminate(self, last_score: float) -> bool:
        self.monitor.observe_step(loss=last_score)
        return self.monitor.should_stop()


# process-global monitor: OFF (None) by default — health monitoring is
# an opt-in subsystem like tracing; installing one wires every fit loop,
# the serving admission path, and both /health endpoints at once.
_default: Optional[HealthMonitor] = None
_default_lock = threading.Lock()


def get_health_monitor() -> Optional[HealthMonitor]:
    return _default


def set_health_monitor(monitor: Optional[HealthMonitor]
                       ) -> Optional[HealthMonitor]:
    """Install the process-global monitor; returns the previous one
    (tests restore it in a finally block)."""
    global _default
    with _default_lock:
        prev, _default = _default, monitor
    return prev
