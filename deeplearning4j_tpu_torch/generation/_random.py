"""The threefry-2x32 random stream of the JAX package, on torch tensors.

A raw ``[2] uint32`` key (no typed key wrapper) and the counter layout of
``jax_threefry_partitionable=True``: element ``i`` of a draw of ``n``
values hashes the 64-bit counter ``i`` as the word pair ``(hi, lo) =
(0, i)`` and keeps the two output words XOR-ed.  ``bits(key, (4,))`` for
the key ``[7, 3]`` is ``[771269580, 2590461243, 3066716433,
3196467460]``, as ``jax.random.bits`` gives.  ``uniform`` and ``gumbel``
follow ``jax.random`` bit for bit up to the last step, ``-log(-log(u))``,
which rounds as the device's ``log`` does.

torch has no uint32 arithmetic on every device, so the words live in
int64 tensors, masked to 32 bits after every add and shift; everything
runs on the device of the key.
"""
from __future__ import annotations

import torch

__all__ = ["threefry2x32", "bits", "uniform", "gumbel"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_FLOAT32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011, as
    ``jax._src.prng.threefry2x32``).  All four arguments are int64 tensors
    of uint32 values, broadcast together; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``[S, n]`` random uint32 words (held in int64), one row per
    ``[S, 2]`` key row: row s equals ``jax.random.bits(keys[s], (n,))``."""
    keys = keys.to(torch.int64) & _M32
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    o0, o1 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(lo),
                          lo)
    return o0 ^ o1


def uniform(keys: torch.Tensor, n: int,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``[S, n]`` float32 in ``[minval, maxval)``, as ``jax.random.uniform``:
    the top 23 bits as the mantissa of a float in [1, 2), minus 1, scaled
    and floored at ``minval``."""
    b = bits(keys, n)
    mant = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    f32 = dict(dtype=torch.float32, device=keys.device)
    lo = torch.tensor(minval, **f32)
    hi = torch.tensor(maxval, **f32)
    floats = mant - torch.tensor(1.0, **f32)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``[S, n]`` float32 standard Gumbel noise, as ``jax.random.gumbel``
    in its default ("low") mode: ``-log(-log(u))`` with u uniform in
    ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(keys, n, _FLOAT32_TINY, 1.0)))
