"""The 3D-parallel demo model (port of ``parallel/demo.py``): a pre-norm
transformer block with ring attention, GPipe-stacked stages, and a
train step reduced over the data and seq axes.

Shared by the dry run (``dryrun.py``), the pipeline tests and
``chip_ranks.py``.  Weights and inputs come from numpy's generator with
the JAX package's seeds, so both packages start from the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..nn.activations import gelu
from .collectives import pmean_, psum_
from .pipeline import gpipe, stack_stage_params
from .sequence import ring_self_attention

__all__ = ["ring_transformer_block", "make_stage_params",
           "make_pipelined_train_step", "build_demo_inputs"]


def ring_transformer_block(params, x, *, n_heads: int, seq_axis="seq"):
    """Pre-norm block: LN -> ring attention (causal) -> residual -> gelu
    MLP.  ``x`` is this rank's ``[b, t/n, e]`` shard of the sequence."""
    xn = (x - x.mean(-1, keepdim=True)) * torch.rsqrt(
        x.var(-1, unbiased=False, keepdim=True) + 1e-5)
    b, t, e = x.shape
    d = e // n_heads

    def heads(y):
        return y.reshape(b, t, n_heads, d).transpose(1, 2)

    q, k, v = (heads(xn @ params[w]) for w in ("Wq", "Wk", "Wv"))
    o = ring_self_attention(q, k, v, axis_name=seq_axis, causal=True)
    x = x + o.transpose(1, 2).reshape(b, t, e) @ params["Wo"]
    return x + gelu(x @ params["W1"]) @ params["W2"]


def make_stage_params(embed: int, seed: int, dtype=torch.float32,
                      device=None):
    r = np.random.default_rng(seed)

    def w(*s):
        return torch.as_tensor(r.standard_normal(s) * 0.1, dtype=dtype,
                               device=device)

    return {"Wq": w(embed, embed), "Wk": w(embed, embed),
            "Wv": w(embed, embed), "Wo": w(embed, embed),
            "W1": w(embed, 2 * embed), "W2": w(2 * embed, embed)}


def build_demo_inputs(*, n_stages: int, embed: int, n_heads: int,
                      seq_len: int, microbatch: int, n_micro: int,
                      seed: int = 0, dtype=torch.float32, device=None):
    """Stacked stage params + ``[n_micro, mb, t, e]`` inputs/targets, the
    whole (unsharded) arrays."""
    rng = np.random.default_rng(seed)
    stacked = stack_stage_params(
        [make_stage_params(embed, i, dtype, device)
         for i in range(n_stages)])
    shape = (n_micro, microbatch, seq_len, embed)
    xs = torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                         device=device)
    ys = torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                         device=device)
    return stacked, xs, ys


def make_pipelined_train_step(*, n_heads: int, lr: float = 0.1,
                              pipe_axis="pipe",
                              reduce_axes=("data", "seq")):
    """The step of one rank of a ``(data, pipe, seq)`` grid (entered by
    the caller): GPipe forward, MSE loss averaged over ``reduce_axes``,
    SGD.  The stage params are replicated over ``reduce_axes``: their
    gradient is the sum over those ranks, as the JAX package's step
    computes it on jax >= 0.6, where its ``pmean`` of the gradient then
    changes nothing.  ``train_step(stacked, xs, ys) -> (loss,
    new_stacked)`` on this rank's shards: ``stacked`` its ``[1, ...]``
    stage, ``xs``/``ys`` ``[n_micro, mb/dp, t/sp, e]``."""

    def block(params, x):
        return ring_transformer_block(params, x, n_heads=n_heads,
                                      seq_axis="seq")

    def train_step(stacked, xs, ys):
        names = sorted(stacked)
        leaves = {k: stacked[k].detach().requires_grad_(True)
                  for k in names}
        out = gpipe(block, leaves, xs, axis_name=pipe_axis)
        loss = torch.mean((out - ys) ** 2)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        loss = pmean_(loss.detach().clone(), reduce_axes)
        new = {}
        for k, g in zip(names, grads):
            # the psum jax.grad makes of a replicated input's gradient
            # inside shard_map (jax >= 0.6); the JAX step's pmean then
            # leaves it as it is
            g = psum_(g.contiguous(), reduce_axes)
            new[k] = (stacked[k] - lr * g).detach()
        return loss, new

    return train_step
