"""Training listeners (callbacks; port of ``train/listeners.py``).

Analogue of ``optimize/api/IterationListener.java`` / ``TrainingListener.java``
and the impls in ``optimize/listeners/``: ScoreIterationListener,
PerformanceListener, EvaluativeListener, CollectScoresIterationListener,
TimeIterationListener, SleepyTrainingListener, ComposableIterationListener,
ParamAndGradientIterationListener, ConvolutionalIterationListener and
CheckpointListener.

The networks keep each step's loss on the device; a listener that reads
the score calls ``get_score()``, the one host sync it causes.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional

import numpy as np

from ..observability.clock import monotonic_s

log = logging.getLogger("deeplearning4j_tpu_torch.train")


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


class TrainingListener:
    """Base callback; all hooks optional (reference TrainingListener.java)."""

    def iteration_done(self, model, iteration: int, epoch: int) -> None:
        pass

    def on_epoch_start(self, model) -> None:
        pass

    def on_epoch_end(self, model) -> None:
        pass

    def on_forward_pass(self, model, activations) -> None:
        pass

    def on_gradient_calculation(self, model) -> None:
        pass

    def on_backward_pass(self, model) -> None:
        pass


class ScoreIterationListener(TrainingListener):
    """Log score every N iterations (reference ScoreIterationListener)."""

    def __init__(self, print_iterations: int = 10):
        self.print_iterations = max(1, print_iterations)

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.print_iterations == 0:
            log.info("Score at iteration %d is %s", iteration,
                     model.get_score())


class PerformanceListener(TrainingListener):
    """Throughput: samples/sec, batches/sec
    (reference ``optimize/listeners/PerformanceListener.java:19,48-96``).

    Steady-state semantics: reported rates NEVER include the first
    observed iteration — it pays the warm-up (kernel builds, allocator
    growth), so a window containing it under-reads throughput.  The
    baseline clock starts at the first hook call (after that iteration
    completed) and every window is measured from there on the monotonic
    clock (``observability.clock``).
    """

    def __init__(self, frequency: int = 1, report_score: bool = False,
                 batch_size_fn: Optional[Callable] = None):
        self.frequency = max(1, frequency)
        self.report_score = report_score
        self.batch_size_fn = batch_size_fn
        self._last_time = None
        self._last_iter = 0
        self.samples_per_sec = float("nan")
        self.batches_per_sec = float("nan")
        self.last_batch_size = 0

    def iteration_done(self, model, iteration, epoch):
        now = monotonic_s()
        if self.batch_size_fn is not None:
            self.last_batch_size = self.batch_size_fn(model)
        else:
            self.last_batch_size = getattr(model, "last_batch_size", 0)
        if self._last_time is None:
            # the first observation closes the warm-up iteration: start
            # the steady-state clock here, report nothing yet
            self._last_time = now
            self._last_iter = iteration
            return
        if iteration % self.frequency == 0:
            dt = max(now - self._last_time, 1e-9)
            iters = max(iteration - self._last_iter, 1)
            self.batches_per_sec = iters / dt
            if self.last_batch_size:
                self.samples_per_sec = self.last_batch_size * iters / dt
            msg = (f"iteration {iteration}; iterations/sec: "
                   f"{self.batches_per_sec:.3f}; samples/sec: {self.samples_per_sec:.3f}")
            if self.report_score:
                msg += f"; score: {model.get_score()}"
            log.info(msg)
            self._last_time = now
            self._last_iter = iteration


class CollectScoresIterationListener(TrainingListener):
    """Collect (iteration, score) pairs (reference CollectScoresIterationListener)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: List[tuple] = []

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, model.get_score()))


class TimeIterationListener(TrainingListener):
    """Estimate remaining time (reference TimeIterationListener)."""

    def __init__(self, iteration_count: int, frequency: int = 50):
        self.iteration_count = iteration_count
        self.frequency = max(1, frequency)
        self.start = monotonic_s()

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.frequency == 0 and iteration > 0:
            elapsed = monotonic_s() - self.start
            remaining = elapsed / iteration * (self.iteration_count - iteration)
            log.info("Remaining time: %d min %d sec", remaining // 60, remaining % 60)


class SleepyTrainingListener(TrainingListener):
    """Throttle training (reference SleepyTrainingListener) — debugging aid."""

    def __init__(self, timer_iteration_ms: float = 0.0, timer_epoch_ms: float = 0.0):
        self.timer_iteration_ms = timer_iteration_ms
        self.timer_epoch_ms = timer_epoch_ms

    def iteration_done(self, model, iteration, epoch):
        if self.timer_iteration_ms > 0:
            time.sleep(self.timer_iteration_ms / 1000.0)

    def on_epoch_end(self, model):
        if self.timer_epoch_ms > 0:
            time.sleep(self.timer_epoch_ms / 1000.0)


class EvaluativeListener(TrainingListener):
    """Periodically evaluate on a held-out iterator (reference EvaluativeListener)."""

    def __init__(self, iterator, frequency: int = 100, print_report: bool = True):
        self.iterator = iterator
        self.frequency = max(1, frequency)
        self.print_report = print_report
        self.last_evaluation = None

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.frequency == 0:
            self.last_evaluation = model.evaluate(self.iterator)
            if self.print_report:
                log.info("Evaluation at iteration %d:\n%s", iteration,
                         self.last_evaluation.stats())


class ComposableIterationListener(TrainingListener):
    def __init__(self, *listeners):
        self.listeners = list(listeners)

    def iteration_done(self, model, iteration, epoch):
        for l in self.listeners:
            l.iteration_done(model, iteration, epoch)


class ParamAndGradientIterationListener(TrainingListener):
    """Per-iteration parameter/update statistics to a log or file
    (reference ``optimize/listeners/ParamAndGradientIterationListener.java``).
    Gradient norms come from the train step's stats
    (``model._last_grad_stats``); parameter norms are computed host-side."""

    def __init__(self, iterations: int = 1, print_mean: bool = True,
                 print_norms: bool = True, output_file=None,
                 delimiter: str = "\t"):
        self.iterations = max(1, iterations)
        self.print_mean = print_mean
        self.print_norms = print_norms
        self.output_file = output_file
        self.delimiter = delimiter
        self.rows: List[dict] = []

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.iterations != 0:
            return
        row = {"iteration": iteration, "score": model.get_score()}
        gstats = getattr(model, "_last_grad_stats", None)
        if gstats is not None:
            row["grad_norm"] = float(gstats["global_norm"])
            for k, v in gstats.get("layer_norms", {}).items():
                row[f"grad_norm_{k}"] = float(v)
        if self.print_norms or self.print_mean:
            for lname, lp in getattr(model, "params", {}).items():
                for pname, arr in (lp or {}).items():
                    a = _host(arr)
                    if self.print_norms:
                        row[f"l2_{lname}.{pname}"] = float(
                            np.linalg.norm(a.reshape(-1)))
                    if self.print_mean:
                        row[f"mean_{lname}.{pname}"] = float(a.mean())
        self.rows.append(row)
        if self.output_file:
            import json as _json
            with open(self.output_file, "a", encoding="utf-8") as f:
                f.write(_json.dumps(row) + "\n")
        else:
            log.info("paramStats %s", row)


class ConvolutionalIterationListener(TrainingListener):
    """Render conv-layer activation grids to HTML every N iterations
    (reference ``RemoteConvolutionalIterationListener`` / ``WebReporter``:
    the reference posts rendered activations to the UI; here they land as
    standalone HTML files, or are POSTed to a UI server's /activations
    page when ``url`` is given)."""

    def __init__(self, probe_batch, frequency: int = 50, output_dir=None,
                 layer_index: int = 0, url: Optional[str] = None):
        import os as _os
        self.probe = probe_batch
        self.frequency = max(1, frequency)
        self.output_dir = output_dir
        self.layer_index = layer_index
        self.url = url
        self.rendered: List[str] = []
        if output_dir:
            _os.makedirs(output_dir, exist_ok=True)

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.frequency != 0:
            return
        from ..ui.components import activation_grid_svg
        acts = model.feed_forward(self.probe)
        a = _host(acts[self.layer_index])
        if a.ndim != 4:
            return  # not a conv activation
        svg = activation_grid_svg(a)
        page = (f"<h3>iteration {iteration}, layer {self.layer_index}, "
                f"shape {a.shape}</h3>{svg}")
        self.rendered.append(page)
        if self.output_dir:
            import os as _os
            path = _os.path.join(self.output_dir,
                                 f"activations_{iteration:06d}.html")
            with open(path, "w", encoding="utf-8") as f:
                f.write(f"<!DOCTYPE html><html><body>{page}</body></html>")
        if self.url:
            import json as _json
            import urllib.request
            req = urllib.request.Request(
                self.url, data=_json.dumps(
                    {"iteration": iteration, "svg": svg}).encode(),
                headers={"Content-Type": "application/json"})
            try:
                urllib.request.urlopen(req, timeout=5).read()
            except OSError:
                log.warning("activation POST to %s failed", self.url)


class CheckpointListener(TrainingListener):
    """Periodic model checkpoints (reference
    ``optimize/listeners/checkpoint/CheckpointListener.java``): save every
    N iterations and/or every N epochs, keep the last K.

    Every save is a crash-consistent checkpoint DIRECTORY of
    ``faulttolerance.CheckpointManager`` (atomic temp-then-rename commit,
    manifest with per-file checksums), and ``background=True`` rides the
    manager's writer with a snapshot that leaves the network's key stream
    alone.  The iteration trigger does not fire at iteration 0.  Saved
    entries restore with ``model_serializer.restore_*`` (which accepts
    checkpoint dirs) or ``CheckpointManager.restore``.
    """

    def __init__(self, directory, save_every_n_iterations: Optional[int] = None,
                 save_every_n_epochs: Optional[int] = None, keep_last: int = 3,
                 background: bool = False):
        from ..faulttolerance.checkpoint import CheckpointManager
        self.directory = directory
        self.save_every_n_iterations = save_every_n_iterations
        self.save_every_n_epochs = save_every_n_epochs
        self.keep_last = keep_last
        self.background = background
        self.manager = CheckpointManager(directory, keep_last=keep_last,
                                         background=background)
        self.saved: List[str] = []

    def _save(self, model):
        self.manager.save(model)
        self._refresh_saved()

    def _refresh_saved(self) -> None:
        self.saved = [p for _, p, _ in self.manager.checkpoints()]

    def wait(self) -> None:
        """Block until any in-flight background checkpoint completes."""
        self.manager.wait()
        self._refresh_saved()

    def iteration_done(self, model, iteration, epoch):
        if self.save_every_n_iterations and iteration > 0 and \
                iteration % self.save_every_n_iterations == 0:
            self._save(model)

    def on_epoch_end(self, model):
        if self.save_every_n_epochs and \
                (model.epoch + 1) % self.save_every_n_epochs == 0:
            self._save(model)
