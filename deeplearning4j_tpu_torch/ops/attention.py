"""Scaled-dot-product attention, the always-correct reference path.

Port of ``deeplearning4j_tpu/ops/attention.py``: tensors are
``[batch, heads, time, head_dim]``, masked scores take the finite
``NEG_INF`` (so a fully-masked softmax stays NaN-free), and the softmax
runs in at least float32.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps masked softmax NaN-free


def causal_mask(t_q: int, t_k: int, q_offset=0, k_offset=0,
                device=None) -> torch.Tensor:
    """Boolean ``[t_q, t_k]`` mask, True = attend.  Offsets place the
    blocks inside the full sequence; each is an int or a 0-d tensor (a
    cached stream position on the device, read without a host sync)."""
    qi = torch.arange(t_q, device=device)[:, None] + q_offset
    ki = torch.arange(t_k, device=device)[None, :] + k_offset
    return qi >= ki


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def sdpa_reference(q, k, v, *, mask=None, causal: bool = False,
                   scale: Optional[float] = None,
                   q_offset=0, k_offset=0) -> torch.Tensor:
    """Reference attention.  q, k, v: ``[b, h, t, d]``; ``mask`` is a
    ``[b, t_k]`` key-padding mask (1 = valid) or a full
    ``[b, 1, t_q, t_k]`` mask."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    acc_dt = _acc_dtype(q.dtype)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).to(acc_dt) * scale
    t_q, t_k = scores.shape[-2], scores.shape[-1]
    if causal:
        keep = causal_mask(t_q, t_k, q_offset, k_offset, device=q.device)
        scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    if mask is not None:
        if mask.ndim == 2:
            mask = mask[:, None, None, :]
        scores = torch.where(mask.to(torch.bool), scores,
                             torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
