"""Activation functions by name (port of ``nn/activations.py``).

Every name of the JAX registry, and the parameterized forms
``"name:param"`` (``leakyrelu:0.3``, ``lrelu:0.3``, ``elu:0.7``,
``thresholdedrelu:0.5``), which keep a layer's configuration a plain
string.  ``register`` and ``register_parameterized`` add more.

Each function is the JAX function's own composition, so that autograd
splits ties as JAX's differentiation does: ``torch.minimum`` and
``torch.maximum`` give each side half the gradient where the two are
equal, as ``jnp.minimum``/``jnp.maximum`` do, so the clip at the edge of
``hardtanh``, ``hardsigmoid`` and ``relu6`` has gradient 0.5 there (where
``torch.clamp`` gives 1 and ``F.hardtanh`` 0), and ``leakyrelu`` is a
``where(x >= 0, ...)`` with gradient 1 at 0, as ``jax.nn.leaky_relu``.
``gelu`` is the tanh approximation, because ``jax.nn.gelu`` defaults to
it.  ``relu``'s gradient at 0 is 0, as ``jax.nn.relu``'s.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

Fn = Callable[[torch.Tensor], torch.Tensor]

_REGISTRY: Dict[str, Fn] = {}
_PARAMETERIZED: Dict[str, Callable[[float], Fn]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name.lower()] = fn
        return fn
    return deco


def register_parameterized(name: str):
    def deco(factory):
        _PARAMETERIZED[name.lower()] = factory
        return factory
    return deco


def get(name) -> Fn:
    """Resolve an activation by name (case-insensitive); callables pass
    through.  ``"name:param"`` resolves a parameterized activation, e.g.
    ``"leakyrelu:0.3"``."""
    if callable(name):
        return name
    s = name.lower()
    if ":" in s:
        base, _, arg = s.partition(":")
        if base in _PARAMETERIZED:
            try:
                param = float(arg)
            except ValueError:
                raise ValueError(
                    f"Bad parameter '{arg}' for activation '{base}': expected "
                    f"a number (e.g. '{base}:0.3'). "
                    f"Parameterized activations: {sorted(_PARAMETERIZED)}") from None
            return _PARAMETERIZED[base](param)
        raise ValueError(
            f"Unknown parameterized activation '{base}'. "
            f"Available: {sorted(_PARAMETERIZED)}")
    try:
        return _REGISTRY[s]
    except KeyError:
        raise ValueError(
            f"Unknown activation '{name}'. Available: {sorted(_REGISTRY)}") from None


def names():
    return sorted(_REGISTRY)


def _clip(x, lo: float, hi: float):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, ties split."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _leaky(x, slope: float):
    """``jax.nn.leaky_relu``: gradient 1 at 0."""
    return torch.where(x >= 0, x, slope * x)


def _elu(x, alpha: float = 1.0):
    """``jax.nn.elu``: ``where(x > 0, x, alpha * expm1(x))``, with the
    negative branch evaluated at ``min(x, 0)``."""
    return torch.where(x > 0, x, alpha * torch.expm1(torch.where(
        x > 0, torch.zeros_like(x), x)))


@register("identity")
@register("linear")
def identity(x):
    return x


@register("relu")
def relu(x):
    return torch.relu(x)


@register("relu6")
def relu6(x):
    return torch.minimum(torch.relu(x), x.new_tensor(6.0))


@register("leakyrelu")
def leakyrelu(x):
    return _leaky(x, 0.01)


@register("elu")
def elu(x):
    return _elu(x)


_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


@register("selu")
def selu(x):
    return _SELU_SCALE * _elu(x, _SELU_ALPHA)


@register("gelu")
def gelu(x):
    return F.gelu(x, approximate="tanh")


@register("tanh")
def tanh(x):
    return torch.tanh(x)


@register("rationaltanh")
def rationaltanh(x):
    return _clip(1.7159 * torch.tanh(2.0 * x / 3.0), -1.0, 1.0)


@register("hardtanh")
def hardtanh(x):
    return _clip(x, -1.0, 1.0)


@register("sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@register("hardsigmoid")
def hardsigmoid(x):
    return _clip(0.2 * x + 0.5, 0.0, 1.0)


@register("softmax")
def softmax(x):
    return torch.softmax(x, dim=-1)


@register("logsoftmax")
def logsoftmax(x):
    return torch.log_softmax(x, dim=-1)


@register("softplus")
def softplus(x):
    # jax.nn.softplus is logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros_like(x))


@register("softsign")
def softsign(x):
    return x / (torch.abs(x) + 1)


@register("cube")
def cube(x):
    return x ** 3


@register("swish")
@register("silu")
def swish(x):
    return x * torch.sigmoid(x)


@register("mish")
def mish(x):
    return x * torch.tanh(softplus(x))


@register("rrelu")
def rrelu(x):
    # the deterministic midpoint of the randomized slope's range
    return torch.where(x >= 0, x, x * (1.0 / 8.0 + 1.0 / 3.0) / 2.0)


@register("thresholdedrelu")
def thresholdedrelu(x):
    return torch.where(x > 1.0, x, torch.zeros_like(x))


@register_parameterized("leakyrelu")
@register_parameterized("lrelu")
def _leakyrelu_p(alpha: float):
    return lambda x: _leaky(x, alpha)


@register_parameterized("elu")
def _elu_p(alpha: float):
    return lambda x: _elu(x, alpha)


@register_parameterized("thresholdedrelu")
def _thresholdedrelu_p(theta: float):
    return lambda x: torch.where(x > theta, x, torch.zeros_like(x))

