"""Time-series helpers (port of ``utils/time_series.py``; reference
``util/TimeSeriesUtils.java``): mask-aware time reversal, the last valid
step of each sequence, sliding windows and per-step mask reshaping.

The tensor helpers compute on their input's device; an array input goes
to ``device`` (the card by default).
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = ["reverse_time_series", "get_last_time_step",
           "moving_window_matrix", "reshape_time_series_mask"]


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.asarray(a), device=resolve_device(device))


def _lengths(mask, device) -> torch.Tensor:
    """Valid steps of each row of a ``[b, t]`` mask, on ``device``."""
    return torch.sum(_tensor(mask, device) > 0, dim=1).to(device)


def reverse_time_series(x, mask=None, device="cuda") -> torch.Tensor:
    """Reverse [b, t, f] along time; with a mask, each sequence reverses
    within its own valid length, so padding stays at the end."""
    x = _tensor(x, device)
    if mask is None:
        return x.flip(1)
    t = x.shape[1]
    lengths = _lengths(mask, x.device)                          # [b]
    idx = torch.arange(t, device=x.device)[None, :]             # [1, t]
    src = lengths[:, None] - 1 - idx                            # [b, t]
    src = torch.where(src >= 0, src, idx)                       # padding stays
    return torch.take_along_dim(x, src[:, :, None], dim=1)


def get_last_time_step(x, mask=None, device="cuda") -> torch.Tensor:
    """[b, t, f] -> [b, f] at each sequence's last valid step (reference
    ``pullLastTimeSteps``)."""
    x = _tensor(x, device)
    if mask is None:
        return x[:, -1]
    idx = torch.clamp(_lengths(mask, x.device) - 1, min=0)
    return torch.take_along_dim(
        x, idx[:, None, None].expand(-1, 1, x.shape[-1]), dim=1)[:, 0]


def moving_window_matrix(x, window: int, stride: int = 1) -> np.ndarray:
    """[t, f] -> [n_windows, window, f] sliding windows (reference
    ``MovingWindowMatrix``), on the host."""
    x = np.asarray(x)
    t = x.shape[0]
    if window > t:
        raise ValueError(f"window {window} exceeds length {t}")
    return np.stack([x[s:s + window]
                     for s in range(0, t - window + 1, stride)])


def reshape_time_series_mask(mask, n_features: int, device="cuda"
                             ) -> torch.Tensor:
    """Per-step mask [b, t] -> per-example mask [b*t, n_features] for 2-D
    losses (reference ``reshapeTimeSeriesMaskToVector``)."""
    m = _tensor(mask, device).reshape(-1)
    return m[:, None].repeat(1, n_features)
