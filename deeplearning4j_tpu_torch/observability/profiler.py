"""StepProfiler (port of ``observability/profiler.py``): per-step time
attribution with MFU, dispatch-depth, and memory-watermark telemetry.

The profiler attributes every training step's wall time into named
phases::

    etl_wait | h2d | dispatch | device | listener | forensics | checkpoint

and exports the result through every observability surface: a bounded
FlightRecorder ``profile`` channel (Chrome-trace dumpable), registry
gauges (``training_mfu{program}``, ``training_dispatch_depth``,
``device_live_bytes``), and the HealthMonitor's MFU-regression detector.
Records, summaries and Chrome traces have the JAX package's format, so
either package loads the other's artifacts.

Honesty model — the one thing this module must not lie about:

- The *device* slice can only be measured by waiting for the step's
  work on the card, which is exactly the per-step host sync the fit
  loops avoid (a CUDA step returns as soon as its kernels are queued).
  So the fence is SAMPLED: on every ``sample_every``-th step the
  profiler records one CUDA event on the current stream before the
  step's first launch and one after its last, and synchronizes on the
  second (counted in ``stepprof_fences_total``); all other steps record
  nothing and add no host sync.  On unsampled steps the device slice is
  ``None``, never an estimate.  The slice is the step's span on the
  device timeline (``elapsed_time`` between the two events): every
  kernel of the step runs inside it, so it is at least their sum, and it
  includes the gaps where the card waited for the host's next launch.
  The host launches while the card runs, so on a sampled step the
  dispatch and device slices overlap and the phases may sum past the
  wall.  A network on the CPU has no events: there the slice is the
  fence's own cost, from the step's return to the fence.
- The **dispatch-depth gauge** counts steps dispatched since the
  profiler's last fence.
- **MFU** derives from the committed graftaudit card ``flops`` field
  (``tools/graftaudit/cards/``, or ``DL4J_TPU_CARDS_DIR``), read as data:
  no analytic formula is duplicated here.  The peak-FLOP/s denominator
  comes from ``DL4J_TPU_PEAK_FLOPS`` or the card table below (dense bf16
  tensor-core peaks from the data sheet); with neither, achieved FLOP/s
  is still exported and the MFU gauge is withheld rather than faked.
- **Memory watermarks** read the CUDA caching allocator's live bytes
  (``torch.cuda.memory_allocated``) at fences and compare the observed
  peak against the AX008 ``peak_live_bytes`` budget from
  ``tools/graftaudit/budgets.json`` where the program has one.

Enablement: ``DL4J_TPU_STEPPROF`` (default on; the per-step cost is a
handful of ``perf_counter`` reads plus one buffered list append).
``DL4J_TPU_STEPPROF_SAMPLE`` sets the fence cadence (default 16);
``DL4J_TPU_STEPPROF_PROGRAM`` overrides the program label the fit
loops pass, mapping a run onto its card/budget entry.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Any, Dict, List, Optional

from .clock import monotonic_s, wall_s
from .recorder import get_flight_recorder
from .registry import MetricsRegistry, default_registry

__all__ = ["StepProfiler", "step_profiler_for", "stepprof_enabled",
           "record_slices", "resolve_card_flops", "resolve_budget_bytes",
           "peak_device_flops", "live_device_bytes", "phase_summary",
           "chrome_trace", "dump_chrome_trace", "load_chrome_trace",
           "CHANNEL", "PHASES", "TRACE_FORMAT", "TRACE_PREFIX"]

CHANNEL = "profile"
PHASES = ("etl_wait", "h2d", "dispatch", "device", "listener",
          "forensics", "checkpoint")
TRACE_FORMAT = "dl4j-tpu-stepprof-trace-v1"
TRACE_PREFIX = "stepprof-"

#: serve/decode slice keys in their temporal order (Chrome-trace layout)
SLICE_KEYS = ("queue_wait_s", "batch_form_s", "execute_s")

# repo root when running from a checkout: profiler.py lives at
# <root>/deeplearning4j_tpu_torch/observability/profiler.py
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# dense bf16 tensor-core peak FLOP/s per card (NVIDIA's data sheets, SXM
# parts at their full power limit) — the roofline denominator when
# DL4J_TPU_PEAK_FLOPS is not set; prefix-matched against
# torch.cuda.get_device_name(), most specific first
_PEAK_FLOPS_BY_KIND = (
    ("NVIDIA H100", 989e12),
)


def stepprof_enabled() -> bool:
    """Default on; ``DL4J_TPU_STEPPROF=0`` disables every hook."""
    return os.environ.get("DL4J_TPU_STEPPROF", "1") != "0"


def _default_sample_every() -> int:
    try:
        return max(1, int(os.environ.get("DL4J_TPU_STEPPROF_SAMPLE", "16")))
    except ValueError:
        return 16


# ---------------------------------------------------------------- cards
def _card_path(program: str) -> str:
    directory = os.environ.get("DL4J_TPU_CARDS_DIR") or os.path.join(
        _REPO_ROOT, "tools", "graftaudit", "cards")
    # mirrors tools/graftaudit/cards.card_filename (not imported: the
    # audit toolchain must stay optional at runtime)
    fname = re.sub(r"[^A-Za-z0-9_.-]+", "_", program) + ".json"
    return os.path.join(directory, fname)


def resolve_card_flops(program: str) -> Optional[float]:
    """FLOPs of one execution of ``program`` from its committed
    graftaudit card — the single source of truth for program cost; None
    when no card exists (installed package, un-audited program)."""
    try:
        with open(_card_path(program), "r", encoding="utf-8") as fh:
            flops = json.load(fh).get("flops")
        flops = float(flops)
        return flops if flops > 0 else None
    except (OSError, ValueError, TypeError):
        return None


def resolve_budget_bytes(program: str) -> Optional[int]:
    """The AX008 ``peak_live_bytes`` ceiling for ``program`` from
    ``tools/graftaudit/budgets.json`` (or ``DL4J_TPU_BUDGETS``)."""
    path = os.environ.get("DL4J_TPU_BUDGETS") or os.path.join(
        _REPO_ROOT, "tools", "graftaudit", "budgets.json")
    try:
        with open(path, "r", encoding="utf-8") as fh:
            row = json.load(fh)["programs"][program]
        b = int(row["peak_live_bytes"])
        return b if b > 0 else None
    except (OSError, ValueError, KeyError, TypeError):
        return None


def peak_device_flops() -> Optional[float]:
    """Peak FLOP/s of the card a step runs on: ``DL4J_TPU_PEAK_FLOPS``
    wins; else the table entry for ``torch.cuda.get_device_name()``; else
    None — MFU is withheld, never faked.  One card, not the sum over
    cards: a port network and its step live on one device."""
    env = os.environ.get("DL4J_TPU_PEAK_FLOPS")
    if env:
        try:
            peak = float(env)
            return peak if peak > 0 else None
        except ValueError:
            return None
    import torch
    if not torch.cuda.is_available():
        return None
    kind = torch.cuda.get_device_name()
    for prefix, peak in _PEAK_FLOPS_BY_KIND:
        if kind.startswith(prefix):
            return peak
    return None


def live_device_bytes() -> Optional[int]:
    """Live bytes in the CUDA caching allocator (the observed-watermark
    sample taken at fences); None without a card."""
    import torch
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.memory_allocated())


def _record_event(device):
    """A timing CUDA event recorded on ``device``'s current stream."""
    import torch
    with torch.cuda.device(device):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
    return ev


class StepProfiler:
    """Per-step phase attribution for one fit/serve loop.

    Hot-path protocol (the fit loops drive it; every call is a couple of
    ``perf_counter`` reads and float math — no allocation, no locks, no
    device access on unsampled steps)::

        prof.begin(t_step, etl_s)      # loop's existing step-start read
        prof.mark("listener", dt)      # inner slices, from _fit_one
        prof.dispatched(loss)          # the step's launches returned;
                                       #   maybe fence (sampled): device
                                       #   slice, live bytes, MFU
        prof.lap("forensics")          # bookkeeping laps
        prof.lap("checkpoint")
        prof.end(iteration, compile_step)

    Step records buffer as raw tuples and drain into the FlightRecorder
    ``profile`` channel every ``FLUSH_EVERY`` steps (the
    ``_StepForensics`` amortization pattern); ``flush()`` in the loop's
    ``finally`` guarantees no step is lost to an exception."""

    FLUSH_EVERY = 16
    __slots__ = ("program", "sample_every", "ring", "fences",
                 "steps", "dispatch_depth", "max_depth",
                 "live_bytes_watermark", "card_flops", "budget_bytes",
                 "peak_flops", "last_mfu", "last_achieved_flops",
                 "_registry", "_monitor", "_wall0", "_buf", "_t0", "_last",
                 "_etl", "_h2d", "_listener", "_dispatch", "_device",
                 "_forensics", "_checkpoint", "_sampled",
                 "_live", "_ratio", "_mfu", "_ach", "_cuda", "_ev0")

    def __init__(self, program: str = "train_step", *,
                 sample_every: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None,
                 recorder=None, monitor=None, device=None):
        self.program = program
        # the CUDA device whose stream the sampled events time (None: a
        # CPU network — no events, the fence times its own cost)
        self._cuda = device if getattr(device, "type", None) == "cuda" \
            else None
        self._ev0 = None
        self.sample_every = max(1, int(sample_every)) \
            if sample_every is not None else _default_sample_every()
        rec = recorder if recorder is not None else get_flight_recorder()
        self.ring = rec.channel(CHANNEL) \
            if (rec is not None and rec.enabled) else None
        self._registry = registry
        self._monitor = monitor
        # cold, once per fit: committed card/budget lookups + roofline
        self.card_flops = resolve_card_flops(program)
        self.budget_bytes = resolve_budget_bytes(program)
        self.peak_flops = peak_device_flops() if self.card_flops else None
        self.fences = 0
        self.steps = 0
        self.dispatch_depth = 0
        self.max_depth = 0
        self.live_bytes_watermark = 0
        self.last_mfu: Optional[float] = None
        self.last_achieved_flops: Optional[float] = None
        # record timestamps derive from the monotonic reads the loop
        # already takes (the _StepForensics wall0 trick)
        self._wall0 = wall_s() - monotonic_s()
        self._buf: list = []
        self._t0 = self._last = 0.0
        self._etl = self._h2d = self._listener = 0.0
        self._dispatch = self._forensics = self._checkpoint = 0.0
        self._device: Optional[float] = None
        self._sampled = False
        self._live: Optional[int] = None
        self._ratio: Optional[float] = None
        self._mfu: Optional[float] = None
        self._ach: Optional[float] = None

    def _reg(self) -> MetricsRegistry:
        return self._registry if self._registry is not None \
            else default_registry()

    # ------------------------------------------------------ step protocol
    def begin(self, t0: float, etl_s: float = 0.0) -> None:
        """Open a step at the loop's own step-start monotonic read;
        ``etl_s`` is the already-measured time blocked on the pipeline
        *before* ``t0`` (the step record's window starts at etl start)."""
        self._t0 = self._last = t0
        self._etl = etl_s if etl_s > 0.0 else 0.0
        self._h2d = self._listener = 0.0
        self._dispatch = self._forensics = self._checkpoint = 0.0
        self._device = None
        self._sampled = False
        self._ev0 = None
        if self._cuda is not None and \
                (self.steps + 1) % self.sample_every == 0:
            # the step about to run is sampled: open its device span
            # before its first launch
            self._ev0 = _record_event(self._cuda)

    def mark(self, phase: str, seconds: float) -> None:
        """Credit an inner slice measured by the step body (h2d device
        placement, the listener loop) — subtracted from the enclosing
        dispatch window so nothing is double-counted."""
        if phase == "h2d":
            self._h2d += seconds
        elif phase == "listener":
            self._listener += seconds

    def dispatched(self, handle=None, window=None) -> None:
        """The step's launches returned.  Every ``sample_every``-th step
        additionally fences on ``handle`` (the step's loss) to measure the
        device slice honestly (the ONLY profiler-added sync; counted).

        ``window``: the fit loop's bounded ``nn/dispatch.DispatchWindow``
        (or None).  A sampled fence drains it first, so the steps still
        in flight retire through ``drained`` and the occupancy books
        balance."""
        now = monotonic_s()
        self._dispatch = now - self._last - self._h2d - self._listener
        self._last = now
        self.steps += 1
        depth = self.dispatch_depth + 1
        self.dispatch_depth = depth
        if depth > self.max_depth:
            self.max_depth = depth
        if handle is not None and self.steps % self.sample_every == 0:
            self._fence(handle, now, window)
        self._ev0 = None

    def drained(self, k: int = 1) -> None:
        """The dispatch window materialized ``k`` in-flight steps: keep
        the depth gauge tracking the window's real occupancy (in steady
        state ``max_depth`` is the configured depth)."""
        d = self.dispatch_depth - k
        self.dispatch_depth = d if d > 0 else 0

    def lap(self, phase: str) -> None:
        """Close a bookkeeping slice (forensics / checkpoint) at now."""
        now = monotonic_s()
        if phase == "forensics":
            self._forensics = now - self._last
        elif phase == "checkpoint":
            self._checkpoint = now - self._last
        self._last = now

    def end(self, iteration: int, compile_step: bool = False) -> None:
        """Seal the step record (wall = etl + everything since begin)."""
        wall = self._etl + (monotonic_s() - self._t0)
        self._buf.append((
            self._wall0 + self._t0 - self._etl, iteration, wall,
            self._etl, self._h2d, self._dispatch, self._device,
            self._listener, self._forensics, self._checkpoint,
            self._sampled, compile_step, self.dispatch_depth,
            self._live, self._ratio, self._mfu, self._ach))
        if len(self._buf) >= self.FLUSH_EVERY:
            self.flush()

    # ------------------------------------------------- fence (cold, 1/N)
    def _fence(self, handle, t_disp: float, window=None) -> None:
        if window is not None and len(window):
            window.drain()
        if self._ev0 is not None:
            ev1 = _record_event(self._cuda)
            ev1.synchronize()
            now = monotonic_s()
            device = self._ev0.elapsed_time(ev1) * 1e-3
        else:
            now = monotonic_s()
            device = now - t_disp
        self._device = device
        self._last = now
        self._sampled = True
        self.fences += 1
        if window is None:
            # no window feeding drained(): the fence is the only
            # materialization point, so it resets the occupancy itself.
            # With one, the drain above retired the earlier steps and
            # the fenced step retires at its own push.
            self.dispatch_depth = 0
        live = live_device_bytes()
        self._live = live
        if live is not None and live > self.live_bytes_watermark:
            self.live_bytes_watermark = live
        ratio = None
        if self.budget_bytes and self.live_bytes_watermark:
            ratio = self.live_bytes_watermark / self.budget_bytes
        self._ratio = ratio
        achieved = mfu = None
        if self.card_flops and device > 0:
            achieved = self.card_flops / device
            self.last_achieved_flops = achieved
            if self.peak_flops:
                mfu = achieved / self.peak_flops
                self.last_mfu = mfu
        self._ach, self._mfu = achieved, mfu
        if mfu is not None:
            mon = self._monitor
            if mon is None:
                from .health import get_health_monitor
                mon = get_health_monitor()
            if mon is not None:
                mon.observe_mfu(mfu, program=self.program, step=self.steps)
        reg = self._reg()
        if reg.enabled:
            p = self.program
            reg.counter("stepprof_fences_total",
                        "Sampled device fences taken by the "
                        "step profiler", ("program",)).labels(p).inc()
            reg.gauge("training_dispatch_depth",
                      "Async dispatches in flight between materialization "
                      "points (max over the last sample window)"
                      ).set(self.max_depth)
            self.max_depth = 0
            if achieved is not None:
                reg.gauge("training_achieved_flops",
                          "Achieved FLOP/s of the sampled device slice "
                          "(card flops / fenced device time)",
                          ("program",)).labels(p).set(achieved)
            if mfu is not None:
                reg.gauge("training_mfu",
                          "Model FLOP/s utilization: achieved over peak "
                          "device FLOP/s", ("program",)).labels(p).set(mfu)
            if live is not None:
                reg.gauge("device_live_bytes",
                          "Live device bytes sampled at the last profiler "
                          "fence").set(live)
            if ratio is not None:
                reg.gauge("device_live_bytes_budget_ratio",
                          "Observed live-bytes watermark over the AX008 "
                          "peak_live_bytes budget",
                          ("program",)).labels(p).set(ratio)

    # ------------------------------------------------------- flush (cold)
    def flush(self) -> None:
        """Drain buffered steps into the recorder's ``profile`` ring."""
        buf = self._buf
        if not buf:
            return
        self._buf = []
        ring = self.ring
        if ring is None:
            return
        prog = self.program
        for (ts, it, wall, etl, h2d, disp, dev, lst, fore, ckpt,
             sampled, comp, depth, live, ratio, mfu, ach) in buf:
            rec = {"ts": ts, "type": "step", "program": prog,
                   "iteration": it, "wall_s": round(wall, 7),
                   "sampled": sampled, "compile": comp, "depth": depth,
                   "phases": {
                       "etl_wait": round(etl, 7),
                       "h2d": round(h2d, 7),
                       "dispatch": round(disp, 7),
                       "device": None if dev is None else round(dev, 7),
                       "listener": round(lst, 7),
                       "forensics": round(fore, 7),
                       "checkpoint": round(ckpt, 7)}}
            if live is not None:
                rec["live_bytes"] = live
            if ratio is not None:
                rec["budget_ratio"] = round(ratio, 4)
            if mfu is not None:
                rec["mfu"] = mfu
            if ach is not None:
                rec["achieved_flops"] = ach
            ring.append(rec)


def step_profiler_for(program: str, **kwargs) -> Optional[StepProfiler]:
    """The fit loops' entry point: a fresh profiler, or None when
    ``DL4J_TPU_STEPPROF=0`` — and never an exception, because telemetry
    must not break training.  ``DL4J_TPU_STEPPROF_PROGRAM`` overrides
    the label (mapping a run onto its canonical card/budget entry)."""
    if not stepprof_enabled():
        return None
    program = os.environ.get("DL4J_TPU_STEPPROF_PROGRAM", program)
    try:
        return StepProfiler(program, **kwargs)
    except Exception:
        return None


def record_slices(kind: str, *, recorder=None, **fields: Any) -> None:
    """Serve/decode-side contribution to the ``profile`` channel: one
    record per batch/step with its ``*_s`` slices (``queue_wait_s``,
    ``batch_form_s``, ``execute_s``).  A cheap guarded single
    ``record()`` — the serving loops call this once per *batch*, not
    per request."""
    if not stepprof_enabled():
        return
    rec = recorder if recorder is not None else get_flight_recorder()
    if rec is None or not rec.enabled:
        return
    rec.record(CHANNEL, kind, **fields)


# ------------------------------------------------------------- summaries
def phase_summary(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate ``profile``-channel step records into the text-table /
    ``/debug/profile`` summary: mean seconds + share per phase over
    steady (non-compile) steps, and the sampled-step coverage (phase
    sum over measured wall — the honesty check)."""
    steps = [r for r in records if r.get("type") == "step"
             and not r.get("compile")]
    out: Dict[str, Any] = {"steps": len(steps)}
    if not steps:
        return out
    wall = sum(r.get("wall_s", 0.0) for r in steps)
    phases: Dict[str, float] = {}
    for r in steps:
        for name, v in (r.get("phases") or {}).items():
            if v:
                phases[name] = phases.get(name, 0.0) + v
    n = len(steps)
    out["mean_wall_s"] = wall / n
    out["mean_phase_s"] = {k: phases.get(k, 0.0) / n for k in PHASES}
    out["phase_share"] = {k: (phases.get(k, 0.0) / wall if wall else 0.0)
                          for k in PHASES}
    sampled = [r for r in steps if r.get("sampled")]
    out["sampled_steps"] = len(sampled)
    if sampled:
        cov = [sum(v for v in (r.get("phases") or {}).values() if v)
               / r["wall_s"] for r in sampled if r.get("wall_s")]
        if cov:
            out["sampled_coverage"] = sum(cov) / len(cov)
        mfus = [r["mfu"] for r in sampled if r.get("mfu") is not None]
        if mfus:
            out["mean_mfu"] = sum(mfus) / len(mfus)
        ratios = [r["budget_ratio"] for r in sampled
                  if r.get("budget_ratio") is not None]
        if ratios:
            out["max_budget_ratio"] = max(ratios)
    return out


# ----------------------------------------------------------- Chrome trace
_TRACK_HOST, _TRACK_DEVICE = 1, 2


def chrome_trace(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Build a Chrome-trace (catapult JSON, ``chrome://tracing`` /
    Perfetto loadable) document from ``profile``-channel records.  Train
    steps lay their host phases sequentially on a host track with the
    sampled device slice on its own track (it genuinely overlaps
    nothing — the fence serialized it); serve/decode records place
    their ``*_s`` slices on per-subsystem tracks."""
    events: List[Dict[str, Any]] = []
    pids: Dict[int, str] = {}
    for r in records:
        kind = r.get("type")
        ts = float(r.get("ts", 0.0)) * 1e6   # catapult wants microseconds
        if kind == "step":
            pid = 1
            pids[pid] = f"train [{r.get('program', 'train_step')}]"
            args = {"iteration": r.get("iteration"),
                    "depth": r.get("depth"),
                    "sampled": bool(r.get("sampled"))}
            for opt in ("mfu", "live_bytes", "budget_ratio"):
                if r.get(opt) is not None:
                    args[opt] = r[opt]
            cursor = ts
            ph = r.get("phases") or {}
            for name in ("etl_wait", "h2d", "dispatch"):
                d = ph.get(name) or 0.0
                if d > 0:
                    events.append({"name": name, "cat": "train", "ph": "X",
                                   "pid": pid, "tid": _TRACK_HOST,
                                   "ts": cursor, "dur": d * 1e6,
                                   "args": args})
                cursor += d * 1e6
            dev = ph.get("device")
            if dev:
                events.append({"name": "device", "cat": "train", "ph": "X",
                               "pid": pid, "tid": _TRACK_DEVICE,
                               "ts": cursor, "dur": dev * 1e6,
                               "args": args})
                cursor += dev * 1e6
            for name in ("listener", "forensics", "checkpoint"):
                d = ph.get(name) or 0.0
                if d > 0:
                    events.append({"name": name, "cat": "train", "ph": "X",
                                   "pid": pid, "tid": _TRACK_HOST,
                                   "ts": cursor, "dur": d * 1e6,
                                   "args": args})
                cursor += d * 1e6
        elif kind in ("serve", "decode", "prefill"):
            pid = 2 if kind == "serve" else 3
            pids[pid] = "serving" if kind == "serve" else "generation"
            cursor = ts
            for key in SLICE_KEYS:
                d = r.get(key) or 0.0
                if d > 0:
                    events.append({"name": f"{kind}:{key[:-2]}",
                                   "cat": kind, "ph": "X", "pid": pid,
                                   "tid": _TRACK_HOST, "ts": cursor,
                                   "dur": d * 1e6})
                cursor += d * 1e6
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": name}} for pid, name in sorted(pids.items())]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms",
            "otherData": {"format": TRACE_FORMAT, "records": len(records)}}


def _seal_trace(doc: Dict[str, Any]) -> bytes:
    """Stamp a sha256 over the canonical traceEvents into the document
    (extra top-level keys are legal catapult metadata, so the artifact
    stays chrome://tracing-loadable AND checksum-verifiable)."""
    canonical = json.dumps(doc["traceEvents"], sort_keys=True,
                           separators=(",", ":")).encode("utf-8")
    doc = dict(doc)
    doc["sha256"] = hashlib.sha256(canonical).hexdigest()
    return json.dumps(doc).encode("utf-8")


def dump_chrome_trace(directory: Optional[str] = None,
                      records: Optional[List[Dict[str, Any]]] = None,
                      recorder=None) -> str:
    """Commit the current ``profile`` window as an atomic checksummed
    Chrome-trace artifact; returns the path written."""
    rec = recorder if recorder is not None else get_flight_recorder()
    if records is None:
        records = rec.channel(CHANNEL).items() if rec is not None else []
    if directory is None and rec is not None:
        directory = rec._resolve_directory(None)
    directory = directory or os.getcwd()
    blob = _seal_trace(chrome_trace(records))
    path = os.path.join(
        directory, f"{TRACE_PREFIX}{os.getpid()}-{int(wall_s())}.json")
    from ..faulttolerance.atomic import atomic_write_bytes
    os.makedirs(directory, exist_ok=True)
    atomic_write_bytes(path, blob)
    return path


def load_chrome_trace(path: str, verify: bool = True) -> Dict[str, Any]:
    """Read a stepprof Chrome-trace artifact; with ``verify`` (default)
    the embedded checksum is recomputed over the canonical traceEvents —
    truncation or bit rot raises ``ValueError``, never loads quietly."""
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    if "traceEvents" not in doc or "sha256" not in doc:
        raise ValueError(f"{path}: not a stepprof trace artifact")
    if verify:
        canonical = json.dumps(doc["traceEvents"], sort_keys=True,
                               separators=(",", ":")).encode("utf-8")
        want, got = doc["sha256"], hashlib.sha256(canonical).hexdigest()
        if want != got:
            raise ValueError(
                f"{path}: checksum mismatch (artifact corrupt): recorded "
                f"{want[:12]}…, recomputed {got[:12]}…")
    return doc
