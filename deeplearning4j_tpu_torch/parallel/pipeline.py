"""Pipeline parallelism: the GPipe schedule over a mesh ``pipe`` axis
(port of ``parallel/pipeline.py``).

Every rank of the pipe axis runs the same program on its own stage's
parameters; activations hop from stage to stage with a neighbour
exchange (``batch_isend_irecv``, one per tick).  Stage params are stacked
on a leading axis of size n_stages (``stack_stage_params``) and each rank
holds its own ``[1, ...]`` slice (the JAX package's ``P('pipe')``
shard); inputs are microbatches on a leading axis, ``[n_micro, mb,
...]``, replicated over the pipe axis.  Contract: stages are
structurally identical, and a stage maps a microbatch to an activation
of the microbatch's shape.

    ys = gpipe(stage_fn, local_stage_params, xs, axis_name="pipe")

runs inside a grid with a ``pipe`` axis (``with grid:``).

``jax.grad`` through the JAX package's unrolled schedule transposes its
ppermutes into the backward pipeline.  Autograd in PyTorch runs each
rank's own graph, and the stages' graphs differ (stage 0 reads the
microbatches, the last stage writes the outputs), so the order in which
one rank would reach its exchanges need not match its neighbour's.  The
schedule is therefore one autograd function (``_GPipe``) whose backward
runs the transposed schedule explicitly: ticks in reverse, each tick's
cotangent exchange first (the forward's neighbour pairs inverted), then
the stage's vector-Jacobian product for the microbatch it held, its
forward replayed from the saved stage input (GPipe's rematerialization).
Every rank posts the same exchanges in the same order; collectives
inside ``stage_fn`` (ring attention over ``seq``) run alike on the ranks
of one stage.  The backward re-enters the grid the forward ran in: on
CUDA autograd runs it on its own device thread, where the caller's axis
environment is not entered.  A rank skips its stage on the ticks where
it holds no microbatch (the bubble) and sends zeros: those values reach
no output in the JAX package's schedule either.  The last stage's
outputs reach every rank through ``_broadcast_from_last``, whose
backward counts the cotangent once, on the last stage (the loss is
computed on every rank).
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, List

import torch

from .collectives import _p2p
from .collectives import broadcast_from_last as _broadcast_from_last
from .mesh import current_grid, resolve_axis

__all__ = ["gpipe", "stack_stage_params"]


def _leaves(tree, out=None) -> List[torch.Tensor]:
    out = [] if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    else:
        out.append(tree)
    return out


def _rebuild(tree, leaves, pos=None):
    pos = [0] if pos is None else pos
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves, pos) for k in sorted(tree)}
    leaf = leaves[pos[0]]
    pos[0] += 1
    return leaf


class _GPipe(torch.autograd.Function):
    """The fill-drain schedule: forward over ``n_micro + n - 1`` ticks,
    backward over the same ticks in reverse.  Returns the last stage's
    outputs on the last stage, zeros elsewhere."""

    @staticmethod
    def forward(ctx, stage_fn, ax, tree, xs, *leaves):
        n, idx = ax.size, int(ax.index)
        n_micro = xs.shape[0]
        local = _rebuild(tree, [p[0] for p in leaves])
        zeros = torch.zeros_like(xs[0])
        fwd_perm = [(j, j + 1) for j in range(n - 1)]
        buf = zeros
        inputs, outs = {}, [zeros] * n_micro
        for t in range(n_micro + n - 1):
            mb = t - idx
            if 0 <= mb < n_micro:
                inp = xs[mb] if idx == 0 else buf
                inputs[mb] = inp
                y = stage_fn(local, inp)
                if idx == n - 1:
                    outs[mb] = y
            else:
                y = zeros
            buf = _p2p(y, ax, fwd_perm)
        ctx.stage_fn, ctx.ax, ctx.tree = stage_fn, ax, tree
        ctx.grid = current_grid()
        ctx.inputs, ctx.n_micro = inputs, n_micro
        ctx.save_for_backward(xs, *leaves)
        return torch.stack(outs)

    @staticmethod
    def backward(ctx, g_outs):
        xs, *leaves = ctx.saved_tensors
        ax, n_micro = ctx.ax, ctx.n_micro
        n, idx = ax.size, int(ax.index)
        bwd_perm = [(j + 1, j) for j in range(n - 1)]
        local = [p[0].detach().requires_grad_(True) for p in leaves]
        params = _rebuild(ctx.tree, local)
        grads = [torch.zeros_like(p) for p in local]
        g_xs = torch.zeros_like(xs)
        zeros = torch.zeros_like(xs[0])
        send = zeros
        for t in reversed(range(n_micro + n - 1)):
            # the transpose of tick t's exchange: the cotangent of what
            # the next stage read at tick t + 1 comes back
            g_y = _p2p(send, ax, bwd_perm)
            mb = t - idx
            send = zeros
            if not 0 <= mb < n_micro:
                continue
            ct = g_outs[mb] if idx == n - 1 else g_y
            inp = ctx.inputs[mb].detach().requires_grad_(True)
            with torch.enable_grad(), (ctx.grid or nullcontext()):
                y = ctx.stage_fn(params, inp)
                got = torch.autograd.grad(y, [inp] + local, ct,
                                          allow_unused=True)
            for i, g in enumerate(got[1:]):
                if g is not None:
                    grads[i] = grads[i] + g
            if got[0] is not None:
                if idx == 0:
                    g_xs[mb] = got[0]
                else:
                    send = got[0]
        return (None, None, None, g_xs) + tuple(g[None] for g in grads)


def gpipe(stage_fn: Callable, stage_params, xs: torch.Tensor, *,
          axis_name="pipe") -> torch.Tensor:
    """Run microbatches ``[n_micro, mb, ...]`` through the stage pipeline.

    ``stage_params`` is this rank's shard (a ``[1, ...]`` leading stage
    axis on every leaf); ``stage_fn(params, x)`` maps one microbatch
    through one stage.  Returns the last stage's ``[n_micro, mb, ...]``
    outputs, valid on every rank."""
    ax = resolve_axis(axis_name)
    n_micro = xs.shape[0]
    if n_micro < ax.size:
        raise ValueError(f"gpipe needs >= {ax.size} microbatches to fill "
                         f"the pipeline, got {n_micro}")
    outs = _GPipe.apply(stage_fn, ax, stage_params, xs,
                        *_leaves(stage_params))
    return _broadcast_from_last(outs, ax)


def stack_stage_params(param_list):
    """Stack per-stage trees (identical structure) on a new leading axis:
    the layout ``gpipe`` shards over ``pipe``."""
    first = param_list[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in param_list])
                for k in first}
    return torch.stack([torch.as_tensor(p) for p in param_list], dim=0)
