"""MetricsListener (port of ``observability/listener.py``) — publishes
training telemetry into the metrics registry from the existing
:class:`TrainingListener` hook points.

Per iteration (at ``frequency`` granularity): score, iteration/examples
throughput, gradient global norm, device memory.

Sync discipline: the listener NEVER forces a device sync on its own.
The port's ``fit`` keeps each step's loss a device scalar (epoch ends
included), so the hooks SKIP score/grad-norm rather than wait for the
device; ``force_device_sync=True`` opts in to one host sync per
``frequency`` iterations and one per epoch.

A disabled registry turns ``iteration_done`` into a single bool check:
no clocks, no fetches, no syncs.
"""
from __future__ import annotations

from typing import Optional

from .clock import monotonic_s
from .registry import MetricsRegistry, default_registry
from ..train.listeners import TrainingListener

__all__ = ["MetricsListener"]


class MetricsListener(TrainingListener):
    """Attach like any listener::

        net.add_listeners(MetricsListener())
        ...train...
        print(render_text(default_registry()))

    Metrics published (default registry unless one is injected):

    - ``model_iterations_total`` / ``model_examples_total`` counters
    - ``model_score`` gauge (most recent minibatch loss)
    - ``model_examples_per_sec`` / ``model_iterations_per_sec`` gauges
      (window = the last ``frequency`` iterations; the window containing
      the first, compile-dominated iteration is never reported)
    - ``model_grad_norm`` gauge (fused global norm from the train step)
    - ``model_epochs_total`` counter
    - ``device_memory_bytes{device,kind}`` gauges (the CUDA caching
      allocator's ``memory_stats``: in use, peak and the card's total;
      absent without a card)
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 frequency: int = 1, collect_grad_norms: bool = True,
                 collect_device_memory: bool = True,
                 force_device_sync: bool = False, event_log=None):
        self.registry = registry if registry is not None \
            else default_registry()
        self.frequency = max(1, frequency)
        self.collect_grad_norms = collect_grad_norms
        self.collect_device_memory = collect_device_memory
        self.force_device_sync = force_device_sync
        self.event_log = event_log
        self._last_mono: Optional[float] = None
        self._last_iter: Optional[int] = None
        self._seen_iterations = 0
        self._ins = None

    # lazily bound ONCE (so a never-firing listener registers nothing,
    # and firing ones pay no per-iteration registry lookups)
    def _instruments(self):
        if self._ins is not None:
            return self._ins
        reg = self.registry
        self._ins = {
            "iters": reg.counter("model_iterations_total",
                                 "Train iterations observed by listeners"),
            "examples": reg.counter("model_examples_total",
                                    "Training examples consumed"),
            "score": reg.gauge("model_score",
                               "Most recent minibatch training loss"),
            "eps": reg.gauge("model_examples_per_sec",
                             "Steady-state examples/sec (compile window "
                             "excluded)"),
            "ips": reg.gauge("model_iterations_per_sec",
                             "Steady-state iterations/sec (compile window "
                             "excluded)"),
            "gnorm": reg.gauge("model_grad_norm",
                               "Global gradient L2 norm from the fused "
                               "train step"),
            "epochs": reg.counter("model_epochs_total",
                                  "Completed training epochs"),
        }
        return self._ins

    def iteration_done(self, model, iteration: int, epoch: int) -> None:
        reg = self.registry
        if not reg.enabled:        # no-op fast path: no clocks, no syncs
            return
        ins = self._instruments()
        now = monotonic_s()
        self._seen_iterations += 1
        batch = int(getattr(model, "last_batch_size", 0) or 0)
        ins["iters"].inc()
        if batch:
            ins["examples"].inc(batch)
        if iteration % self.frequency != 0:
            return
        # score: a host float where the caller materialized it; the
        # port's fit keeps each step's loss a device scalar, read here
        # only under force_device_sync
        raw_score = getattr(model, "_score", None)
        score_is_host = isinstance(raw_score, float)
        score = None
        if score_is_host:
            score = raw_score
        elif self.force_device_sync:
            score = float(model.get_score())
        if score is not None:
            ins["score"].set(score)
        if self._last_mono is not None and self._last_iter is not None \
                and self._seen_iterations > self.frequency:
            # rate over the closed window; the very first window holds
            # the compile-dominated iteration and is skipped above
            dt = max(now - self._last_mono, 1e-9)
            iters = max(iteration - self._last_iter, 1)
            ins["ips"].set(iters / dt)
            if batch:
                ins["eps"].set(batch * iters / dt)
        self._last_mono = now
        self._last_iter = iteration
        if self.collect_grad_norms and (score_is_host
                                        or self.force_device_sync):
            gstats = getattr(model, "_last_grad_stats", None)
            if gstats is not None:
                ins["gnorm"].set(float(gstats["global_norm"]))
        if self.collect_device_memory:
            self._collect_memory(reg)
        if self.event_log is not None:
            self.event_log.emit("train_iteration", iteration=iteration,
                                epoch=epoch, score=score, batch_size=batch)

    def _collect_memory(self, reg: MetricsRegistry) -> None:
        import torch
        if not torch.cuda.is_available():
            return
        g = reg.gauge("device_memory_bytes", "Device memory by kind",
                      ("device", "kind"))
        for i in range(torch.cuda.device_count()):
            st = torch.cuda.memory_stats(i)
            for src, kind in (("allocated_bytes.all.current", "in_use"),
                              ("allocated_bytes.all.peak", "peak")):
                if src in st:
                    g.labels(str(i), kind).set(float(st[src]))
            g.labels(str(i), "limit").set(
                float(torch.cuda.get_device_properties(i).total_memory))

    def on_epoch_end(self, model) -> None:
        if not self.registry.enabled:
            return
        ins = self._instruments()
        ins["epochs"].inc()
        # a device scalar is skipped unless force_device_sync, the rule
        # of iteration_done
        raw = getattr(model, "_score", None)
        score = raw if isinstance(raw, float) else (
            float(model.get_score()) if self.force_device_sync else None)
        if score is not None:
            ins["score"].set(score)
            if self.collect_grad_norms:
                gstats = getattr(model, "_last_grad_stats", None)
                if gstats is not None:
                    ins["gnorm"].set(float(gstats["global_norm"]))
        if self.event_log is not None:
            self.event_log.emit("epoch_end", epoch=getattr(model, "epoch", -1),
                                score=score)
