"""Expert parallelism: the mixture-of-experts FFN with all-to-all
dispatch (port of ``parallel/expert.py``).

The GShard/Switch dense-dispatch formulation: top-1 routing, a fixed
expert capacity, dispatch and combine as einsums over ``[T, E, C]``
one-hot tensors, and, with an expert axis, two tiled ``all_to_all``s so
each rank hosts a shard of the experts while the tokens stay sharded
over data (``collectives.all_to_all`` over the axis's process group).
The products are ``torch.einsum`` (the JAX package computes them
outside any Pallas kernel).

``expert_axis`` names an axis of the grid the caller entered (``with
grid:``), or is an :class:`~.mesh.Axis`.  ``make_moe_train_step`` is the
step of one rank of a ``("data", "expert")`` grid.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..utils import _random
from .collectives import all_to_all, pmean_, psum_

__all__ = ["init_moe_params", "moe_ffn", "make_moe_train_step"]


def init_moe_params(key, n_experts: int, embed: int, hidden: int,
                    dtype=torch.float32, device=None
                    ) -> Dict[str, torch.Tensor]:
    """Router + stacked expert FFN weights from a threefry ``key``
    (``utils/_random``): the JAX package's numbers for the same key,
    within f32 rounding.  Under expert parallelism each rank keeps its
    ``n_experts / ep`` rows of ``w1``/``w2``; the router is replicated."""
    key = torch.as_tensor(key)
    kr, k1, k2 = _random.split(key, 3)
    s1 = 1.0 / np.sqrt(embed)
    s2 = 1.0 / np.sqrt(hidden)

    def draw(k, shape, s):
        return (_random.normal(k, shape) * s).to(dtype=dtype, device=device)

    return {"router": draw(kr, (embed, n_experts), s1),
            "w1": draw(k1, (n_experts, embed, hidden), s1),
            "w2": draw(k2, (n_experts, hidden, embed), s2)}


def _dispatch_tensors(router_probs: torch.Tensor, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 dispatch/combine tensors ``[T, E, C]`` (Switch): token t goes
    to its argmax expert (the first of equal maxima) at its position in
    that expert's queue, and is dropped when the queue is past
    ``capacity``.  The one-hots are comparisons, as ``jax.nn.one_hot``
    gives them: a position of -1 (another expert) or >= capacity (a
    dropped token) is a zero row."""
    dt = router_probs.dtype
    dev = router_probs.device
    n_experts = router_probs.shape[-1]
    expert_idx = torch.argmax(router_probs, dim=-1)                # [T]
    onehot = (expert_idx[:, None] == torch.arange(
        n_experts, device=dev)).to(dt)                             # [T, E]
    pos = torch.cumsum(onehot, dim=0) - 1.0                        # [T, E]
    keep = (pos < capacity).to(dt) * onehot
    pos_oh = (pos.to(torch.int64)[..., None] == torch.arange(
        capacity, device=dev)).to(dt)                              # [T, E, C]
    dispatch = keep[..., None] * pos_oh
    gate = torch.sum(router_probs * onehot, dim=-1)                # [T]
    combine = dispatch * gate[:, None, None]
    return dispatch, combine


def moe_ffn(params: Dict[str, torch.Tensor], x: torch.Tensor, capacity: int,
            expert_axis=None, act=torch.relu
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN over local tokens ``x [T, D]``.

    Without ``expert_axis``: ``w1``/``w2`` hold ALL experts.  With it:
    they hold this rank's expert shard, and two tiled all-to-alls move
    each token group to its expert's owner and back:

        [E, C, D] --a2a(split E, concat C)--> [E/ep, ep*C, D]   (to owners)
        [E/ep, ep*C, D] --a2a(split C, concat E)--> [E, C, D]   (back)

    Returns ``(output [T, D], the Switch load-balancing aux loss)``."""
    probs = torch.softmax(x @ params["router"], dim=-1)            # [T, E]
    n_experts = probs.shape[-1]
    dispatch, combine = _dispatch_tensors(probs, capacity)
    expert_in = torch.einsum("tec,td->ecd", dispatch, x)           # [E, C, D]
    if expert_axis is not None:
        expert_in = all_to_all(expert_in, expert_axis, split_axis=0,
                               concat_axis=1)
    h = torch.einsum("ecd,edh->ech", expert_in, params["w1"])
    if "b1" in params:
        h = h + params["b1"]
    h = act(h)
    out = torch.einsum("ech,ehd->ecd", h, params["w2"])
    if "b2" in params:
        out = out + params["b2"]
    if expert_axis is not None:
        out = all_to_all(out, expert_axis, split_axis=1, concat_axis=0)
    y = torch.einsum("tec,ecd->td", combine, out)
    # Switch aux loss: the fraction routed times the mean router
    # probability, per expert
    top = torch.argmax(probs, dim=-1)
    frac = torch.mean((top[:, None] == torch.arange(
        n_experts, device=probs.device)).to(probs.dtype), dim=0)
    aux = n_experts * torch.sum(frac * torch.mean(probs, dim=0))
    return y, aux


def make_moe_train_step(capacity: int, lr: float = 0.1,
                        aux_weight: float = 0.01, *, data_axis="data",
                        expert_axis="expert"):
    """The MoE regression train step of one rank of a ``("data",
    "expert")`` grid (entered by the caller): tokens sharded over both
    axes, ``w1``/``w2`` over expert, the router replicated.
    ``step(params, x, y) -> (new_params, loss)``.  The loss is averaged
    over both axes.  Every rank's backward runs the all-to-alls'
    transposes, so an expert shard's gradient takes the cotangents of
    every token its experts served.  Each parameter's gradient is then
    summed over the axes it is replicated on (the router's over data and
    expert, ``w1``/``w2``'s over data), as the JAX package's step computes
    it on jax >= 0.6, where its ``pmean`` of each gradient then changes
    nothing."""

    def step(params, x, y):
        names = ("router", "w1", "w2")
        p = {k: params[k].detach().requires_grad_(True) for k in names}
        out, aux = moe_ffn(p, x, capacity, expert_axis=expert_axis)
        loss = torch.mean((out - y) ** 2) + aux_weight * aux
        grads = dict(zip(names, torch.autograd.grad(
            loss, [p[k] for k in names])))
        loss = pmean_(pmean_(loss.detach().clone(), data_axis), expert_axis)
        # jax.grad inside shard_map (jax >= 0.6, varying manual axes)
        # transposes a replicated input's implicit broadcast into a psum
        # over the ranks that used it; the JAX step's pmean then sees an
        # axis-invariant value and leaves it as it is
        grads["router"] = psum_(grads["router"], (data_axis, expert_axis))
        grads["w1"] = psum_(grads["w1"], data_axis)
        grads["w2"] = psum_(grads["w2"], data_axis)
        new_params = {k: (params[k] - lr * grads[k]).detach()
                      for k in names}
        return new_params, loss

    return step
