"""Profiling helpers (port of ``device_platform`` from
``utils/profiling.py``; the rest of that module is ROADMAP item 9 b)."""
from __future__ import annotations

import torch

__all__ = ["device_platform"]


def device_platform(device) -> str:
    """The platform name a server reports in ``/health`` for the device
    its model runs on: ``"gpu"`` for CUDA, ``"cpu"`` for the CPU (the
    names the JAX package's ``/health`` uses), ``"unknown"`` otherwise.
    It names the serving object's own device, never the process
    default."""
    kind = torch.device(device).type
    return {"cuda": "gpu", "cpu": "cpu"}.get(kind, "unknown")
