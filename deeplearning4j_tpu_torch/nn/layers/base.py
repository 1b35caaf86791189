"""Layer base classes (port of ``nn/layers/base.py``).

A layer is a config dataclass, read from the JAX package's JSON, with two
functions on tensors:

    init(generator, itype, device) -> {name: tensor}   fresh parameters
    apply(params, x)               -> y                inference forward

Parameters keep the JAX package's names and shapes (a dense ``W`` is
``[n_in, n_out]`` and applies as ``x @ W``), so a checkpoint crosses over
without transposes.  ``None`` fields inherit the network-level default,
as in the reference's builder.  Training-only fields (updaters,
regularisation, dropout, weight noise, constraints) are read and kept
but have no effect on inference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from .. import activations as _act
from ..conf.input_type import InputType

Params = Dict[str, torch.Tensor]

# Global-default-able fields and their fallback values.
INHERITED_DEFAULTS = {
    "activation": "identity",
    "weight_init": "xavier",
    "weight_dist": None,
    "bias_init": 0.0,
    "l1": 0.0,
    "l2": 0.0,
    "l1_bias": 0.0,
    "l2_bias": 0.0,
    "updater": None,
    "bias_updater": None,
    "dropout": None,
    "weight_noise": None,
    "constraints": None,
    "dtype": "float32",
    "gradient_normalization": None,
    "gradient_normalization_threshold": 1.0,
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _fans(shape) -> tuple:
    if len(shape) == 1:
        return float(shape[0]), float(shape[0])
    return float(shape[0]), float(shape[-1])


@dataclass
class LayerConf:
    """Root of the layer-config hierarchy."""
    name: Optional[str] = None

    def output_type(self, itype: InputType) -> InputType:
        return itype

    def set_n_in(self, itype: InputType, override: bool = False) -> None:
        """Infer input size from the previous layer's output type."""

    def init(self, generator: torch.Generator, itype: InputType,
             device) -> Params:
        return {}

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclass
class BaseLayerConf(LayerConf):
    """Layers with weights."""
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    weight_dist: Optional[Any] = None
    bias_init: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    l1_bias: Optional[float] = None
    l2_bias: Optional[float] = None
    updater: Optional[Any] = None
    bias_updater: Optional[Any] = None
    dropout: Optional[Any] = None
    weight_noise: Optional[Any] = None
    constraints: Optional[List[Any]] = None
    dtype: Optional[str] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: Optional[float] = None

    def apply_global_defaults(self, defaults: Dict[str, Any]) -> None:
        """Fill None fields from network-level defaults."""
        my_fields = {f.name for f in dataclasses.fields(self)}
        for k, fallback in INHERITED_DEFAULTS.items():
            if k in my_fields and getattr(self, k, None) is None:
                setattr(self, k, defaults.get(k, fallback))

    def resolved(self, name, fallback=None):
        v = getattr(self, name, None)
        if v is None:
            v = INHERITED_DEFAULTS.get(name, fallback)
        if v is None:
            v = fallback
        return v

    @property
    def act_fn(self):
        return _act.get(self.resolved("activation", "identity"))

    def _dtype(self) -> torch.dtype:
        name = self.resolved("dtype", "float32")
        try:
            return _DTYPES[name]
        except KeyError:
            raise ValueError(f"layer '{self.name}': dtype '{name}' is not "
                             f"ported yet; ported: {sorted(_DTYPES)}") from None

    def make_weight(self, generator: torch.Generator, shape, device
                    ) -> torch.Tensor:
        """Fresh weight.  Only ``xavier`` (normal, std
        sqrt(2/(fan_in+fan_out))) is ported; torch's generator does not
        reproduce JAX's numbers, so parity runs load transferred params."""
        scheme = self.resolved("weight_init", "xavier").lower()
        if scheme != "xavier" or self.weight_dist is not None:
            raise ValueError(f"layer '{self.name}': weight_init '{scheme}' "
                             "is not ported yet; ported: ['xavier']")
        if torch.device(device).type == "meta":   # shapes only
            return torch.empty(shape, dtype=self._dtype(), device=device)
        fan_in, fan_out = _fans(shape)
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        w = w * (2.0 / (fan_in + fan_out)) ** 0.5
        return w.to(device=device, dtype=self._dtype())

    def make_bias(self, shape, device) -> torch.Tensor:
        return torch.full(shape, float(self.resolved("bias_init", 0.0)),
                          dtype=self._dtype(), device=device)
