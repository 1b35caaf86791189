"""Differentiable collectives over one axis of a mesh: the port's
counterparts of the ``lax`` collectives the JAX package's model axes run
inside ``shard_map``.

Each takes an axis (a :class:`~.mesh.Axis`, or a name resolved in the
entered grid, ``mesh.resolve_axis``) and runs over that axis's process
group; on an axis that is not ``live`` (one rank, no process group) each
is the identity.  The backward of each is its transpose, as ``jax.grad``
derives it (``psum_`` and ``pmean_`` reduce losses and gradients after
the backward, outside autograd):

* ``ppermute`` (``lax.ppermute``): ``batch_isend_irecv`` of the pairs
  ``(source, destination)`` of ``perm``; a rank no pair sends to gets
  zeros.  Backward: the inverse permutation.
* ``all_to_all`` (``lax.all_to_all(..., tiled=True)``): the input is cut
  into ``size`` chunks along ``split_axis``, chunk j goes to place j, and
  the chunks received are joined along ``concat_axis`` in place order
  (``all_to_all_single``).  Backward: the same with the two axes
  swapped.
* ``copy_to`` / ``reduce_from``: Megatron's conjugate pair of tensor
  parallelism.  ``copy_to`` is the identity whose backward sums the
  cotangents over the axis (the input of a column-split product);
  ``reduce_from`` sums the partial products over the axis and hands the
  cotangent back unchanged (the output of a row-split product).
* ``broadcast_from_last`` (``pipeline._broadcast_from_last``): the last
  place's value on every rank; the backward counts the cotangent once,
  on the last place.
* ``all_gather`` (``lax.all_gather(..., tiled=True)``): the places'
  inputs joined along dim 0 in place order.  Backward: the cotangent
  summed over the places, each place keeping its own block
  (``reduce_scatter_tensor``).

Every rank of the axis must call the same collectives in the same order,
forward and backward (NCCL's rule, and gloo's).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .mesh import Axis, resolve_axis

__all__ = ["ppermute", "all_to_all", "all_gather", "psum_", "pmean_",
           "copy_to", "reduce_from", "broadcast_from_last"]


def _dist():
    import torch.distributed as dist
    return dist


def _p2p(x: torch.Tensor, ax: Axis, perm: Sequence[Tuple[int, int]]
         ) -> torch.Tensor:
    me = ax.index
    out = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    if not ax.live:
        for src, dst in perm:
            if src == me and dst == me:
                out = x.clone()
        return out
    dist = _dist()
    send = x.contiguous()
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out = send.clone()
            continue
        if src == me:
            ops.append(dist.P2POp(dist.isend, send, ax.global_rank(dst),
                                  group=ax.group))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, out, ax.global_rank(src),
                                  group=ax.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, perm):
        ctx.ax, ctx.perm = ax, perm
        return _p2p(x, ax, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((dst, src) for src, dst in ctx.perm)
        return _PPermute.apply(g, ctx.ax, inverse), None, None


def ppermute(x: torch.Tensor, axis, perm: Sequence[Tuple[int, int]]
             ) -> torch.Tensor:
    """``lax.ppermute(x, axis, perm)``: place ``src`` sends ``x`` to place
    ``dst`` for each pair of ``perm``."""
    return _PPermute.apply(x, resolve_axis(axis),
                           tuple((int(s), int(d)) for s, d in perm))


def _a2a(x: torch.Tensor, ax: Axis, split_axis: int, concat_axis: int
         ) -> torch.Tensor:
    n = ax.size
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"does not split over the {n} places of axis "
                         f"'{ax.name}'")
    if not ax.live:
        return x.clone()
    src = x.movedim(split_axis, 0).contiguous()
    out = torch.empty_like(src)
    _dist().all_to_all_single(out, src, group=ax.group)
    # place j's chunk (my share of its input) is out's j-th block
    chunks = out.reshape((n, src.shape[0] // n) + tuple(src.shape[1:]))
    chunks = chunks.movedim(1, split_axis + 1)        # [n, ...x's layout]
    return torch.cat(list(chunks.unbind(0)), dim=concat_axis).contiguous()


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, split_axis, concat_axis):
        ctx.ax, ctx.axes = ax, (split_axis, concat_axis)
        return _a2a(x, ax, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return _AllToAll.apply(g, ctx.ax, concat_axis, split_axis), \
            None, None, None


def all_to_all(x: torch.Tensor, axis, split_axis: int, concat_axis: int
               ) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``."""
    ax = resolve_axis(axis)
    return _AllToAll.apply(x, ax, split_axis % x.ndim, concat_axis % x.ndim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        if not ax.live:
            return x.clone()
        src = x.contiguous()
        out = torch.empty((ax.size * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        _dist().all_gather_into_tensor(out, src, group=ax.group)
        return out

    @staticmethod
    def backward(ctx, g):
        ax = ctx.ax
        if not ax.live:
            return g, None
        src = g.contiguous()
        out = torch.empty((src.shape[0] // ax.size,) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        _dist().reduce_scatter_tensor(out, src, group=ax.group)
        return out, None


def all_gather(x: torch.Tensor, axis) -> torch.Tensor:
    """``lax.all_gather(x, axis, tiled=True)``: every place's ``x`` joined
    along dim 0, place 0 first."""
    return _AllGather.apply(x, resolve_axis(axis))


def _all_reduce(t: torch.Tensor, ax: Axis) -> torch.Tensor:
    out = t.contiguous().clone()
    if ax.live:
        _dist().all_reduce(out, group=ax.group)
    return out


@torch.no_grad()
def psum_(t: torch.Tensor, axes) -> torch.Tensor:
    """``lax.psum`` over one axis or several, in place, outside autograd.
    Returns ``t``."""
    if isinstance(axes, (str, Axis)):
        axes = (axes,)
    for a in axes:
        ax = resolve_axis(a)
        if ax.live:
            _dist().all_reduce(t, group=ax.group)
    return t


@torch.no_grad()
def pmean_(t: torch.Tensor, axes) -> torch.Tensor:
    """``lax.pmean`` over one axis or several, in place, outside autograd
    (a loss after the backward)."""
    if isinstance(axes, (str, Axis)):
        axes = (axes,)
    psum_(t, axes)
    n = 1
    for a in axes:
        n *= resolve_axis(a).size
    if n > 1:
        t.div_(n)
    return t


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.ax), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, axis) -> torch.Tensor:
    """Megatron's ``f``: the identity; the backward sums the cotangents
    over the axis."""
    return _CopyTo.apply(x, resolve_axis(axis))


def reduce_from(x: torch.Tensor, axis) -> torch.Tensor:
    """Megatron's ``g``: the partial products summed over the axis; the
    backward is the identity."""
    return _ReduceFrom.apply(x, resolve_axis(axis))


class _BroadcastFromLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        last = ax.index == ax.size - 1
        return _all_reduce(x if last else torch.zeros_like(x), ax)

    @staticmethod
    def backward(ctx, g):
        ax = ctx.ax
        return (g if ax.index == ax.size - 1 else torch.zeros_like(g)), None


def broadcast_from_last(x: torch.Tensor, axis) -> torch.Tensor:
    """The value at the axis's last place, on every rank; its cotangent
    counted once, at the last place (owner-only)."""
    return _BroadcastFromLast.apply(x, resolve_axis(axis))
