"""Activation functions by name (port of ``nn/activations.py``).

Only the activations the TransformerLM, ResNet50 and char-LSTM paths use
are ported: ``identity``/``linear``, ``softmax``, ``gelu``, ``relu``, and
the LSTM's ``sigmoid`` gates and ``tanh`` cell activation.
``gelu`` is the tanh approximation, because ``jax.nn.gelu`` defaults to
it.  ``relu``'s gradient at 0 is 0, as ``jax.nn.relu``'s.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


_REGISTRY: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "identity": identity,
    "linear": identity,
    "softmax": softmax,
    "gelu": gelu,
    "relu": relu,
    "sigmoid": sigmoid,
    "tanh": tanh,
}


def get(name) -> Callable[[torch.Tensor], torch.Tensor]:
    """Resolve an activation by name (case-insensitive); callables pass
    through."""
    if callable(name):
        return name
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(f"activation '{name}' is not ported yet; ported: "
                         f"{sorted(_REGISTRY)}") from None
