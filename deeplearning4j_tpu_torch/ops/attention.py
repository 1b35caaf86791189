"""Scaled-dot-product attention, the always-correct reference path.

Port of ``deeplearning4j_tpu/ops/attention.py``: tensors are
``[batch, heads, time, head_dim]``, masked scores take the finite
``NEG_INF`` (so a fully-masked softmax stays NaN-free), and the softmax
runs in at least float32.

The online-softmax block helpers (``attn_block``, ``combine_blocks``,
``finalize_blocks``, ``init_blocks``) are the shared math of ring
attention (``parallel/sequence``): attend q to one block of keys, merge
partials over disjoint key blocks, normalize at the end.  A block whose
keys a row may not see at all (a causal ring step ahead of the row)
contributes nothing: ``attn_block`` zeroes its probabilities where the
score is masked, and ``finalize_blocks`` keeps a row with no key at 0.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def _apply_masks(scores, mask, causal: bool, q_offset, k_offset):
    t_q, t_k = scores.shape[-2], scores.shape[-1]
    if causal:
        keep = causal_mask(t_q, t_k, q_offset, k_offset,
                           device=scores.device)
        scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    if mask is not None:
        # [b, t_k] key padding (1 = valid) or a full [b, 1, t_q, t_k]
        if mask.ndim == 2:
            mask = mask[:, None, None, :]
        scores = torch.where(mask.to(torch.bool), scores,
                             torch.full_like(scores, NEG_INF))
    return scores


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
    scores = _apply_masks(scores, mask, causal, q_offset, k_offset)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def attn_block(q, k, v, *, mask=None, causal: bool = False,
               scale: Optional[float] = None, q_offset=0, k_offset=0
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attend q to ONE block of (k, v); returns the partials ``(acc, m,
    l)``: ``acc = sum_j exp(s_j - m) v_j`` (unnormalized), ``m`` the row
    max, ``l = sum_j exp(s_j - m)``, all in at least f32.  Merge partials
    with ``combine_blocks``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    acc_dt = _acc_dtype(q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).to(acc_dt) * scale
    s = _apply_masks(s, mask, causal, q_offset, k_offset)
    m = torch.amax(s, dim=-1)                                 # [b,h,q]
    # a fully-masked row: exp(NEG_INF - NEG_INF) = 1 would pollute l
    p = torch.exp(s - m[..., None]) * (s > NEG_INF / 2)
    l = torch.sum(p, dim=-1)                                  # [b,h,q]
    acc = torch.einsum("bhqk,bhkd->bhqd", p, v.to(acc_dt))
    return acc, m, l


def combine_blocks(acc1, m1, l1, acc2, m2, l2):
    """Merge two online-softmax partials over disjoint key blocks."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    acc = acc1 * a1[..., None] + acc2 * a2[..., None]
    l = l1 * a1 + l2 * a2
    return acc, m, l


def finalize_blocks(acc, m, l, dtype) -> torch.Tensor:
    """Normalize accumulated partials into the attention output; a row
    that saw no key is zeros, not NaN."""
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l[..., None]).to(dtype)


def init_blocks(b: int, h: int, t_q: int, d: int, dtype=torch.float32,
                device=None):
    """The identity element of ``combine_blocks``."""
    acc_dt = _acc_dtype(dtype)
    return (torch.zeros((b, h, t_q, d), dtype=acc_dt, device=device),
            torch.full((b, h, t_q), NEG_INF, dtype=acc_dt, device=device),
            torch.zeros((b, h, t_q), dtype=acc_dt, device=device))
