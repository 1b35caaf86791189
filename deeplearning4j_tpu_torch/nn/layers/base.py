"""Layer base classes (port of ``nn/layers/base.py``).

A layer is a config dataclass, read from the JAX package's JSON, with two
functions on tensors:

    init(generator, itype, device) -> {name: tensor}   fresh parameters
    apply(params, x, train=False)  -> y                forward

Parameters keep the JAX package's names and shapes (a dense ``W`` is
``[n_in, n_out]`` and applies as ``x @ W``), so a checkpoint crosses over
without transposes.  ``None`` fields inherit the network-level default,
as in the reference's builder.  l1/l2 regularisation is ported
(``regularization_score``).  Dropout and weight noise draw their masks
from JAX's threefry stream, which is not ported: they have no effect on
inference, and a training forward with either set raises.
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

    def apply(self, params: Params, x: torch.Tensor, *,
              train: bool = False) -> torch.Tensor:
        raise NotImplementedError


def _dropout_on(d) -> bool:
    """The reference's ``conf.dropout.resolve``: None, or a float retain
    probability outside (0, 1), is off; anything else is on."""
    if d is None:
        return False
    if isinstance(d, (int, float)):
        return 0.0 < float(d) < 1.0
    return True


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

    _BIAS_PARAMS = ("b", "gamma", "beta", "mean", "var")  # bias-like (no l2 by default)

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

    def maybe_dropout_input(self, x: torch.Tensor, train: bool
                            ) -> torch.Tensor:
        """Dropout on the layer input (reference semantics).  Identity
        when unset or not training; raises when set in training."""
        if train and _dropout_on(self.dropout):
            raise NotImplementedError(
                f"layer '{self.name}': dropout={self.dropout!r} is not "
                "ported yet (its masks come from JAX's threefry stream); "
                "train with dropout unset")
        return x

    def maybe_noise_weights(self, params: Params, train: bool) -> Params:
        """Weight noise on non-bias params.  Identity when unset or not
        training; raises when set in training."""
        if train and self.weight_noise is not None:
            raise NotImplementedError(
                f"layer '{self.name}': weight_noise is not ported yet (its "
                "draws come from JAX's threefry stream); train with "
                "weight_noise unset")
        return params

    def regularization_score(self, params: Params) -> torch.Tensor:
        """l1·sum|w| + l2/2·sum w² over weights, with the ``*_bias``
        coefficients over bias-like params."""
        l1 = float(self.resolved("l1", 0.0) or 0.0)
        l2 = float(self.resolved("l2", 0.0) or 0.0)
        l1b = float(self.resolved("l1_bias", 0.0) or 0.0)
        l2b = float(self.resolved("l2_bias", 0.0) or 0.0)
        device = next(iter(params.values())).device if params else None
        score = torch.zeros((), dtype=torch.float32, device=device)
        for k, v in params.items():
            a1, a2 = (l1b, l2b) if k in self._BIAS_PARAMS else (l1, l2)
            if a1:
                score = score + a1 * torch.sum(torch.abs(v))
            if a2:
                score = score + 0.5 * a2 * torch.sum(v * v)
        return score
