"""The threefry-2x32 random stream of the JAX package, on torch tensors.

A raw ``[2] uint32`` key (no typed key wrapper) and the counter layout of
``jax_threefry_partitionable=True`` (the default of jax 0.9.0):

* ``prng_key(seed)`` is ``[seed >> 32, seed & 0xFFFFFFFF]``
  (``jax.random.PRNGKey``);
* ``split(key, n)``: key i is the word pair threefry(key, (0, i));
* ``fold_in(key, d)`` is threefry(key, (0, d));
* a draw of ``shape`` hashes the row-major flat index ``i`` of each
  element as the counter ``(hi, lo) = (0, i)`` and keeps the two output
  words XOR-ed (``random_bits``; ``bits`` draws one row per key of a
  ``[S, 2]`` batch).  ``bits(key, (4,))`` for the key ``[7, 3]`` is
  ``[771269580, 2590461243, 3066716433, 3196467460]``, as
  ``jax.random.bits`` gives;
* ``uniform`` puts the top 23 bits into the mantissa of a float in
  [1, 2) and subtracts 1; ``bernoulli(key, p, shape)`` is ``uniform <
  p``, bit for bit.  A float64 draw takes the 64-bit word ``(o0 << 32) |
  o1`` (no XOR) and its top 52 bits, as JAX's under ``jax_enable_x64``;
  ``bernoulli`` with a tensor ``p`` draws uniforms in p's dtype, as
  ``jax.random.bernoulli`` with an array ``p``;
* ``randint(key, shape, lo, hi)`` is ``jax.random.randint`` with x64
  off (int32, 32-bit words): the key splits in two, each half draws a
  word per element (``hi_bits``, ``lo_bits``), and with ``span = hi -
  lo`` and ``m = (2**16 mod span)**2 mod span`` the value is ``lo +
  ((hi_bits mod span) * m + lo_bits mod span) mod span``, every product
  and sum wrapping mod 2**32 as ``lax.mul``/``lax.add`` on uint32 (so for
  a span above 2**16, ``m`` is 0).  Under ``jax_enable_x64`` JAX draws
  int64 from 64-bit words: another stream;
* ``normal`` is ``sqrt(2) * erfinv(uniform(nextafter(-1, +inf), 1))``
  and ``gumbel`` is ``-log(-log(uniform(tiny, 1)))``; their last step
  rounds as the device's ``erfinv`` and ``log`` do, so they agree with
  JAX within float32 rounding, not bit for bit.

The uniforms are float32: the JAX package draws them so with x64 off,
its production setting.  Under ``jax_enable_x64`` JAX's ``bernoulli``
with a Python-float ``p`` draws float64 uniforms and gives other masks.

torch has no uint32 arithmetic on every device, so the words live in
int64 tensors, masked to 32 bits after every add and shift; every draw
runs on the device of the key.
"""
from __future__ import annotations

import math

import torch

__all__ = ["threefry2x32", "prng_key", "split", "fold_in", "bits",
           "random_bits", "uniform", "bernoulli", "normal", "gumbel",
           "permutation", "randint"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_FLOAT32_TINY = torch.finfo(torch.float32).tiny
# the float32 after -1 towards 0: the low end of ``normal``'s uniform
_NORMAL_LO = -1.0 + 2.0 ** -24


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


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the ``[2]`` words ``(seed >> 32,
    seed & 0xFFFFFFFF)`` as int64, on ``device``."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _M32, seed & _M32],
                        dtype=torch.int64, device=device)


def _hash(key: torch.Tensor, lo: torch.Tensor):
    """threefry(key, (0, lo)) for int64 counters ``lo``."""
    key = key.to(torch.int64) & _M32
    return threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``[num, 2]`` keys."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    return torch.stack(_hash(key, lo), dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: a ``[2]`` key."""
    lo = torch.full((1,), int(data) & _M32, dtype=torch.int64,
                    device=key.device)
    return torch.cat(_hash(key, lo))


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 words held in int64)."""
    lo = torch.arange(_numel(shape), dtype=torch.int64, device=key.device)
    o0, o1 = _hash(key, lo)
    return (o0 ^ o1).reshape(tuple(shape))


def bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``[S, n]`` random uint32 words (held in int64), one row per
    ``[S, 2]`` key row: row s equals ``jax.random.bits(keys[s], (n,))``."""
    keys = keys.to(torch.int64) & _M32
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    o0, o1 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(lo),
                          lo)
    return o0 ^ o1


def _scaled(mant: torch.Tensor, minval: float, maxval: float
            ) -> torch.Tensor:
    """A float in [1, 2) minus 1, scaled and floored at ``minval``, each
    step rounded to the float's dtype as ``jax.random.uniform``."""
    f = dict(dtype=mant.dtype, device=mant.device)
    lo = torch.full((), minval, **f)
    hi = torch.full((), maxval, **f)
    floats = mant - torch.full((), 1.0, **f)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def _floats(b: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """uint32 words -> float32 in ``[minval, maxval)``: the top 23 bits as
    the mantissa of a float in [1, 2)."""
    mant = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return _scaled(mant, minval, maxval)


def _floats64(key: torch.Tensor, shape, minval: float, maxval: float
              ) -> torch.Tensor:
    """float64 uniforms of one ``[2]`` key: the top 52 bits of the word
    ``(o0 << 32) | o1`` as the mantissa of a float in [1, 2)."""
    lo = torch.arange(_numel(shape), dtype=torch.int64, device=key.device)
    o0, o1 = _hash(key, lo)
    mant = ((o0 << 20) | (o1 >> 12)) | 0x3FF0000000000000
    return _scaled(mant.view(torch.float64), minval, maxval).reshape(
        tuple(shape))


def uniform(keys: torch.Tensor, n, minval: float = 0.0,
            maxval: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """``[S, n]`` float32 uniforms, one row per ``[S, 2]`` key row, as
    ``jax.random.uniform(keys[s], (n,), minval=, maxval=)``; or, for one
    ``[2]`` key and a shape ``n``, ``jax.random.uniform(key, n, dtype)``
    (float32 or float64)."""
    if dtype == torch.float64:
        if keys.ndim != 1:
            raise ValueError("float64 uniforms take one [2] key")
        return _floats64(keys, n, minval, maxval)
    if dtype != torch.float32:
        raise ValueError(f"uniform draws float32 or float64, not {dtype}")
    if keys.ndim == 1:
        return _floats(random_bits(keys, n), minval, maxval)
    return _floats(bits(keys, n), minval, maxval)


def bernoulli(key: torch.Tensor, p, shape=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: a bool tensor.  A float
    ``p`` compares float32 uniforms with ``float32(p)`` (x64 off); a
    tensor ``p`` draws uniforms of its shape (or ``shape``) in its dtype
    and compares ``uniform < p``."""
    if isinstance(p, torch.Tensor):
        u = uniform(key, tuple(p.shape) if shape is None else shape,
                    dtype=p.dtype)
        return u < p
    u = uniform(key, shape)
    return u < torch.full((), p, dtype=torch.float32, device=u.device)


def normal(key: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)``: ``sqrt(2) * erfinv(u)``,
    u uniform in ``[nextafter(-1, +inf), 1)`` of the dtype (float32 or
    float64).  ``erfinv`` is torch's, not XLA's ``erf_inv``: equal within
    the dtype's rounding."""
    lo = _NORMAL_LO if dtype != torch.float64 else -1.0 + 2.0 ** -53
    u = uniform(key, shape, lo, 1.0, dtype=dtype)
    return torch.full((), 2.0 ** 0.5, dtype=dtype,
                      device=u.device) * torch.erfinv(u)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``[S, n]`` float32 standard Gumbel noise, as ``jax.random.gumbel``
    in its default ("low") mode: ``-log(-log(u))`` with u uniform in
    ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(keys, n, _FLOAT32_TINY, 1.0)))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: an int64 permutation of
    ``arange(n)`` on the key's device."""
    n = int(n)
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(_M32))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


def randint(keys: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` with x64 off,
    bit for bit, as int64.  ``keys`` is one ``[2]`` key, or ``[S, 2]``
    keys for ``[S, *shape]`` draws in one batched call (row s equals the
    draw of ``keys[s]``)."""
    one = keys.ndim == 1
    keys = (keys[None] if one else keys).to(torch.int64) & _M32
    n = _numel(shape)
    # split(key, 2) of every row at once: halves (k1, k2) = threefry(key,
    # (0, 0)) and threefry(key, (0, 1))
    lo = torch.arange(2, dtype=torch.int64, device=keys.device)[None, :]
    o0, o1 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(lo), lo)
    hi_bits = bits(torch.stack((o0[:, 0], o1[:, 0]), dim=-1), n)
    lo_bits = bits(torch.stack((o0[:, 1], o1[:, 1]), dim=-1), n)
    span = int(maxval) - int(minval)
    span = 1 if span <= 0 else span
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span
    off = ((((hi_bits % span) * mult) & _M32) + lo_bits % span) & _M32
    out = (off % span + int(minval)).reshape((keys.shape[0],) + tuple(shape))
    return out[0] if one else out
