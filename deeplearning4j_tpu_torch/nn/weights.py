"""Weight initialization (port of ``nn/weights.py``): every scheme of
the JAX package's ``init_weights``, drawn from a ``torch.Generator``.

The schemes and their fans are the JAX package's (a dense ``[n_in,
n_out]`` kernel has fan_in n_in, fan_out n_out; a conv kernel ``[kh, kw,
c_in, c_out]`` has kh·kw·c_in and kh·kw·c_out); the numbers are torch's,
so a parity run loads the JAX package's params.  The ``distribution``
scheme samples its ``Distribution`` from the threefry stream
(``utils/_random``) with a key seeded from the generator.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..utils import _random
from .conf.distribution import Distribution

SCHEMES = ("zero", "ones", "identity", "distribution", "sigmoid_uniform",
           "normal", "xavier_fan_in", "lecun_normal", "lecun_uniform",
           "uniform", "xavier", "xavier_uniform", "xavier_legacy", "relu",
           "relu_uniform", "var_scaling_normal_fan_in",
           "var_scaling_normal_fan_out", "var_scaling_normal_fan_avg",
           "var_scaling_uniform_fan_in", "var_scaling_uniform_fan_out",
           "var_scaling_uniform_fan_avg")


def fans(shape: Sequence[int]) -> Tuple[float, float]:
    shape = tuple(shape)
    if len(shape) == 0:
        return 1.0, 1.0
    if len(shape) == 1:
        return float(shape[0]), float(shape[0])
    receptive = 1.0
    for d in shape[:-2]:
        receptive *= d
    return receptive * shape[-2], receptive * shape[-1]


def _normal(gen, shape, scale):
    return torch.randn(shape, generator=gen, dtype=torch.float32) * scale


def _uniform(gen, shape, r):
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return (2 * u - 1) * r


def init_weights(generator: torch.Generator, shape: Sequence[int],
                 scheme: str, distribution: Optional[Distribution] = None
                 ) -> torch.Tensor:
    """A float32 CPU weight of ``shape`` under the named scheme."""
    scheme = scheme.lower()
    shape = tuple(int(d) for d in shape)
    fan_in, fan_out = fans(shape)
    if scheme == "zero":
        return torch.zeros(shape)
    if scheme == "ones":
        return torch.ones(shape)
    if scheme == "identity":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError(
                f"identity init requires square 2d shape, got {shape}")
        return torch.eye(shape[0])
    if scheme == "distribution":
        if distribution is None:
            raise ValueError(
                "WeightInit 'distribution' requires a Distribution")
        seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
        return distribution.sample(_random.prng_key(seed), shape).to(
            torch.float32)
    if scheme == "sigmoid_uniform":
        return _uniform(generator, shape, 4.0 * (6.0 / (fan_in + fan_out))
                        ** 0.5)
    if scheme in ("normal", "xavier_fan_in", "lecun_normal"):
        return _normal(generator, shape, 1.0 / fan_in ** 0.5)
    if scheme == "lecun_uniform":
        return _uniform(generator, shape, (3.0 / fan_in) ** 0.5)
    if scheme == "uniform":
        return _uniform(generator, shape, (1.0 / fan_in) ** 0.5)
    if scheme == "xavier":
        return _normal(generator, shape, (2.0 / (fan_in + fan_out)) ** 0.5)
    if scheme == "xavier_uniform":
        return _uniform(generator, shape, (6.0 / (fan_in + fan_out)) ** 0.5)
    if scheme == "xavier_legacy":
        return _normal(generator, shape, 1.0 / (shape[0] + shape[-1]) ** 0.5)
    if scheme == "relu":
        return _normal(generator, shape, (2.0 / fan_in) ** 0.5)
    if scheme == "relu_uniform":
        return _uniform(generator, shape, (6.0 / fan_in) ** 0.5)
    if scheme.startswith("var_scaling"):
        # var_scaling_{normal|uniform}_{fan_in|fan_out|fan_avg}
        parts = scheme.split("_")
        mode = "_".join(parts[3:]) or "fan_in"
        dist = parts[2] if len(parts) > 2 else "normal"
        n = {"fan": fan_in, "fan_in": fan_in, "fan_out": fan_out,
             "fan_avg": (fan_in + fan_out) / 2.0}.get(mode, fan_in)
        if dist == "uniform":
            return _uniform(generator, shape, (3.0 / n) ** 0.5)
        return _normal(generator, shape, 1.0 / n ** 0.5)
    raise ValueError(f"Unknown weight init scheme '{scheme}'")
