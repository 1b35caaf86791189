"""The global batch of a data-parallel train step.

The JAX package's data-parallel step is one SPMD program over the
*global* batch: GSPMD shards it, but every reduction inside the step
(the loss's mean, BatchNormalization's batch statistics) and every draw
(dropout masks) is the global one.  The port's step runs once per rank
on that rank's slice of the batch, so while a wrapper's step runs, this
context makes those three global again:

* **loss denominators** (``mean_rows``, ``masked_mean``): a rank's loss
  is its local sum divided by the *global* count (the global row count,
  or the global count of rows a mask keeps on), and the wrappers
  all-reduce gradients by SUM, so the summed per-rank objectives are the
  global mean exactly as in JAX;
* **batch statistics** (``all_reduce_grad``): BatchNormalization sums
  its statistics over every rank's rows through a differentiable
  all-reduce (SyncBN semantics, as GSPMD gives them);
* **dropout** (``rows``): a rank draws the mask for the global batch
  shape from the one replicated key and keeps its own rows, so the
  masks are bit-equal to the JAX package's.

Regularization (l1/l2) is a function of the replicated parameters, not
of the batch: ``share`` keeps it on rank 0 only, so it enters the
summed objective once.

Outside a wrapper, and at world size 1, every helper is the plain
single-device computation, op for op.  The context is thread-local: the
training masters run replicas on threads, each its own single-device
step.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Optional, Sequence

import torch

__all__ = ["GlobalBatch", "current", "global_batch", "mean_rows",
           "masked_mean", "rows", "share", "all_reduce_grad", "snapshot",
           "reentered"]

_local = threading.local()


class GlobalBatch:
    """One rank's view of the global batch: ``world`` ranks of
    ``local_rows`` rows each; this rank holds rows ``[row_offset,
    row_offset + local_rows)`` of ``global_rows``.  ``axis`` is the data
    axis of the wrapper's mesh (``parallel.mesh.Axis``), over which a
    mixture-of-experts layer routes the global batch."""

    __slots__ = ("group", "world", "rank", "local_rows", "row_offset",
                 "global_rows", "axis")

    def __init__(self, group, world: int, rank: int, local_rows: int,
                 axis=None):
        self.group = group
        self.axis = axis
        self.world = int(world)
        self.rank = int(rank)
        self.local_rows = int(local_rows)
        self.row_offset = self.rank * self.local_rows
        self.global_rows = self.local_rows * self.world

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over the ranks of a tensor that carries no gradient."""
        import torch.distributed as dist
        out = t.detach().clone()
        dist.all_reduce(out, group=self.group)
        return out


def current() -> Optional[GlobalBatch]:
    """The active context with more than one rank, or None."""
    gb = getattr(_local, "ctx", None)
    return gb if gb is not None and gb.world > 1 else None


@contextmanager
def global_batch(group, world: int, rank: int, local_rows: int,
                 axis=None):
    """Run the enclosed step as rank ``rank`` of ``world`` equal slices."""
    prev = getattr(_local, "ctx", None)
    _local.ctx = GlobalBatch(group, world, rank, local_rows, axis)
    try:
        yield _local.ctx
    finally:
        _local.ctx = prev


def snapshot() -> Optional[GlobalBatch]:
    """The calling thread's context (None outside a step), to re-enter
    on another thread with ``reentered``."""
    return getattr(_local, "ctx", None)


@contextmanager
def reentered(ctx: Optional[GlobalBatch]):
    """Run the enclosed code in ``ctx`` (a ``snapshot``): a checkpointed
    layer's forward replays in the backward, on autograd's device thread
    on CUDA."""
    prev = getattr(_local, "ctx", None)
    _local.ctx = ctx
    try:
        yield ctx
    finally:
        _local.ctx = prev


class _AllReduceSum(torch.autograd.Function):
    """SUM over the ranks whose backward is the SUM of the ranks'
    cotangents: every rank's objective depends on the summed value."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_grad(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, differentiably; ``t`` itself outside
    a multi-rank context."""
    gb = current()
    return t if gb is None else _AllReduceSum.apply(t, gb.group)


def mean_rows(per_row: torch.Tensor) -> torch.Tensor:
    """The mean over the global batch's rows of a per-row score: this
    rank's sum over the global row count (``mean()`` alone)."""
    gb = current()
    if gb is None:
        return per_row.mean()
    return per_row.sum() / float(per_row.shape[0] * gb.world)


def masked_mean(total: torch.Tensor, kept: torch.Tensor) -> torch.Tensor:
    """``total / max(kept, 1)`` with ``kept`` (the count of rows a mask
    keeps on) summed over the ranks first."""
    gb = current()
    if gb is not None:
        kept = gb.all_reduce(kept)
    return total / torch.clamp(kept, min=1.0)


def rows(draw: Callable[[Sequence[int]], torch.Tensor],
         shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)`` of a batch-leading shape, as the rows this rank
    holds of the draw for the global batch."""
    gb = current()
    shape = tuple(int(s) for s in shape)
    if gb is None or not shape or shape[0] != gb.local_rows:
        return draw(shape)
    full = draw((gb.global_rows,) + shape[1:])
    return full[gb.row_offset:gb.row_offset + gb.local_rows]


def share(reg: torch.Tensor) -> torch.Tensor:
    """A replicated term of the objective (l1/l2), kept on rank 0 only so
    the summed objective counts it once."""
    gb = current()
    if gb is None or gb.rank == 0:
        return reg
    return reg * 0.0
