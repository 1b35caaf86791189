"""Profiling hooks (port of ``utils/profiling.py``): a listener that
traces a window of training iterations with ``torch.profiler`` and
writes a Chrome trace, a region annotation, and the device's memory
figures.

The JAX package captures an XLA trace; the port captures the PyTorch
profiler's (CPU ops, and CUDA kernels where the profiled work runs on
the card), written as ``trace_<first>-<last>.json`` into ``log_dir``,
where Perfetto or ``chrome://tracing`` opens it.
"""
from __future__ import annotations

import contextlib
import logging
import os
from typing import Optional

import torch

from ..train.listeners import TrainingListener

log = logging.getLogger("deeplearning4j_tpu_torch.profiling")

__all__ = ["ProfilerListener", "trace_annotation", "device_memory_stats",
           "device_platform"]


def device_platform(device) -> str:
    """The platform name a server reports in ``/health`` for the device
    its model runs on: ``"gpu"`` for CUDA, ``"cpu"`` for the CPU (the
    names the JAX package's ``/health`` uses), ``"unknown"`` otherwise.
    It names the serving object's own device, never the process
    default."""
    kind = torch.device(device).type
    return {"cuda": "gpu", "cpu": "cpu"}.get(kind, "unknown")


class ProfilerListener(TrainingListener):
    """Trace iterations [start, start + num) into ``log_dir``.  The first
    iterations build kernels and warm the allocator, so
    ``start_iteration`` defaults past them.  ``trace_path`` names the
    written trace (None until one is written)."""

    def __init__(self, log_dir: str, start_iteration: int = 3,
                 num_iterations: int = 3):
        self.log_dir = log_dir
        self.start_iteration = start_iteration
        self.end_iteration = start_iteration + num_iterations
        self._active = False
        self._prof = None
        self._first = None
        self.captured = False
        self.trace_path: Optional[str] = None

    def iteration_done(self, model, iteration, epoch):
        if not self._active and not self.captured and \
                iteration >= self.start_iteration:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            self._active = True
            self._first = iteration
            log.info("trace started at iteration %d -> %s", iteration,
                     self.log_dir)
        elif self._active and iteration >= self.end_iteration:
            self.stop(iteration)

    def stop(self, iteration: Optional[int] = None):
        if not self._active:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        last = self._first if iteration is None else iteration
        self.trace_path = os.path.join(self.log_dir,
                                       f"trace_{self._first}-{last}.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        self._active = False
        self.captured = True
        log.info("trace written to %s", self.trace_path)

    def on_epoch_end(self, model):
        # never leave a trace running across epochs
        self.stop()


@contextlib.contextmanager
def trace_annotation(name: str):
    """Label a host-side region so it shows on the profiler's timeline
    (``record_function``), and as an NVTX range where CUDA is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def device_memory_stats(device=None) -> Optional[dict]:
    """Memory of one CUDA device: ``{bytes_in_use, peak_bytes_in_use,
    bytes_limit}`` (the JAX package's keys, from the caching allocator's
    ``memory_stats`` and the card's total memory); None for the CPU,
    where the JAX package also gives None."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = "cuda"
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    s = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                dev).total_memory)}
