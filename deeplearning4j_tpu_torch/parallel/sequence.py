"""Sequence parallelism: ring attention and Ulysses (port of
``parallel/sequence.py``).

The time axis of q/k/v is sharded over the mesh's ``seq`` axis, and
exact attention comes out of either

* **ring attention**: the k/v shards rotate around the ring
  (``collectives.ppermute``, one ``batch_isend_irecv`` per hop); each
  step attends the local q block to the visiting k/v block and merges
  the partials (``ops.attention.combine_blocks``).  n - 1 neighbour hops:
  the last rotation is not made;
* **Ulysses**: one ``all_to_all`` reswizzles ``[seq shard, all heads]``
  into ``[all seq, head shard]``, ordinary attention runs per head group
  (``attn_fn``, by default ``sdpa_reference``; the port's
  ``flash_attention`` runs the Hopper kernels there), and a second
  ``all_to_all`` restores the layout.  Needs ``n_heads % n == 0``.

Both run where ``shard_map`` runs the JAX functions: inside a grid whose
``seq`` axis the caller entered (``with mesh:``; ``axis_name`` is
resolved there), or given an :class:`~.mesh.Axis`.  Both are
differentiable: the collectives' backward is their transpose.
"""
from __future__ import annotations

from typing import Optional

from ..ops.attention import (attn_block, combine_blocks, finalize_blocks,
                             init_blocks, sdpa_reference)
from .collectives import all_to_all, ppermute
from .mesh import resolve_axis

__all__ = ["ring_self_attention", "ulysses_attention"]


def ring_self_attention(q, k, v, *, axis_name="seq", causal: bool = False,
                        scale: Optional[float] = None):
    """Exact attention with q/k/v sharded ``[b, h, t/n, d]`` over
    ``axis_name``.  Shard i holds global positions ``[i * t_blk, (i + 1)
    * t_blk)``; the k/v blocks rotate ring-wise and the online-softmax
    partials make the result equal to full attention (up to the order of
    the f32 sums)."""
    ax = resolve_axis(axis_name)
    n, idx = ax.size, int(ax.index)
    b, h, t_blk, d = q.shape
    acc, m, l = init_blocks(b, h, t_blk, d, q.dtype, q.device)
    q_off = idx * t_blk
    perm = [(j, (j + 1) % n) for j in range(n)]
    k_cur, v_cur = k, v
    for i in range(n):
        # the block visiting now came from shard (idx - i) mod n
        src = (idx - i) % n
        a2, m2, l2 = attn_block(q, k_cur, v_cur, causal=causal, scale=scale,
                                q_offset=q_off, k_offset=src * t_blk)
        acc, m, l = combine_blocks(acc, m, l, a2, m2, l2)
        if i < n - 1:
            k_cur = ppermute(k_cur, ax, perm)
            v_cur = ppermute(v_cur, ax, perm)
    return finalize_blocks(acc, m, l, q.dtype)


def ulysses_attention(q, k, v, *, axis_name="seq", causal: bool = False,
                      scale: Optional[float] = None, attn_fn=None):
    """All-to-all sequence parallelism (DeepSpeed-Ulysses).  In: ``[b, h,
    t/n, d]`` sharded over time; ``all_to_all`` to ``[b, h/n, t, d]``
    sharded over heads, full attention locally (``attn_fn``, default
    ``sdpa_reference``), ``all_to_all`` back.  Needs ``h % n == 0``."""
    if attn_fn is None:
        attn_fn = sdpa_reference
    ax = resolve_axis(axis_name)
    n = ax.size
    if q.shape[1] % n:
        raise ValueError(f"ulysses_attention needs n_heads ({q.shape[1]}) "
                         f"divisible by the '{ax.name}' axis size ({n})")
    # split heads across ranks, gather time
    qg = all_to_all(q, ax, split_axis=1, concat_axis=2)
    kg = all_to_all(k, ax, split_axis=1, concat_axis=2)
    vg = all_to_all(v, ax, split_axis=1, concat_axis=2)
    o = attn_fn(qg, kg, vg, causal=causal, scale=scale)
    # [b, h/n, t, d] -> back to [b, h, t/n, d]
    return all_to_all(o, ax, split_axis=2, concat_axis=1)
