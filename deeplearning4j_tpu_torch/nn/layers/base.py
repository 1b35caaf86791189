"""Layer base classes (port of ``nn/layers/base.py``).

A layer is a config dataclass, read from the JAX package's JSON, with
these functions on tensors:

    init(generator, itype, device) -> {name: tensor}    fresh parameters
    init_state(itype, device)      -> {name: tensor}    fresh state
    apply(params, x, train=False, key=None) -> y        stateless forward
    forward(params, state, x, train=False, key=None, mask=None)
                                   -> (y, new_state)
    feed_forward_mask(mask, itype) -> the mask the next layer sees

The networks call ``forward``: the JAX package's ``apply`` returns
``(y, new_state)`` for every layer, and the port keeps that one protocol
for both containers.  A stateless layer writes ``apply`` only and hands
its (empty) state back; a layer with state (``BatchNormalization``:
running mean and variance) overrides ``forward``.  New state is returned,
never written in place.  A ``[b, t]`` features mask reaches ``forward``;
layers that ignore it in the JAX package ignore it here, and the layers
that read it (recurrent, attention) override ``forward``.

Recurrent layers carry state across calls (``rnn_time_step`` streaming,
tBPTT chunks): ``HAS_CARRY`` marks them, ``init_carry(batch, dtype,
device)`` makes a zero carry and ``apply_with_carry(params, x, carry,
train, key, mask) -> (y, new_carry)`` runs from a given one.

``key`` is a ``[2]`` threefry key of ``utils/_random`` (the JAX
package's stream), given in training: the network folds the layer's
index into the step's key, as the JAX package does, and the layer draws
its dropout from it on the key's device.

Parameters keep the JAX package's names and shapes (a dense ``W`` is
``[n_in, n_out]`` and applies as ``x @ W``), so a checkpoint crosses over
without transposes.  A wrapper whose JAX param group nests sub-groups
(``Bidirectional``: ``{"fwd": {...}, "bwd": {...}}``) keeps one flat group
named ``fwd/W``, ...: ``flatten_group`` and ``nest_group`` map between the
two.  ``None`` fields inherit the network-level default,
as in the reference's builder.  l1/l2 regularisation is ported
(``regularization_score``), and so is dropout on a layer's input
(``maybe_dropout_input``, ``nn/conf/dropout``), and weight noise
(``maybe_noise_weights``: ``DropConnect``, ``WeightNoise``), which has
no effect on inference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from ...utils import _random
from .. import activations as _act
from ..conf import dropout as _dropout
from ..conf.input_type import InputType
from ..weights import fans as _fans, init_weights  # noqa: F401

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

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64}


def flatten_group(group: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A JAX param group with nested sub-groups as one flat group:
    ``{"fwd": {"W": a}}`` -> ``{"fwd/W": a}``; a flat group is unchanged
    ('.' is illegal in a parameter name, so the port joins with '/')."""
    out = {}
    for k, v in group.items():
        if isinstance(v, dict):
            out.update(flatten_group(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def nest_group(group: Dict[str, Any]) -> Dict[str, Any]:
    """``flatten_group`` undone: ``{"fwd/W": a}`` -> ``{"fwd": {"W": a}}``."""
    out: Dict[str, Any] = {}
    for k, v in group.items():
        *path, leaf = k.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def draws(lc) -> bool:
    """Whether a layer (or a wrapper's inner layer) draws from its key in
    training: dropout, ``attn_dropout`` or weight noise set.  A frozen
    layer runs in inference mode and draws nothing.  The networks derive
    a layer's key only where it draws: each derivation is a threefry
    hash, some hundred small launches on the card."""
    if lc is None or getattr(lc, "FROZEN", False):
        return False
    if _dropout.resolve(getattr(lc, "dropout", None)) is not None or \
            getattr(lc, "attn_dropout", None) or \
            getattr(lc, "weight_noise", None) is not None:
        return True
    return any(draws(getattr(lc, a, None))
               for a in ("underlying", "fwd", "layer")
               if getattr(lc, a, None) is not lc)


@dataclass
class LayerConf:
    """Root of the layer-config hierarchy."""
    name: Optional[str] = None

    HAS_CARRY = False

    def output_type(self, itype: InputType) -> InputType:
        return itype

    def set_n_in(self, itype: InputType, override: bool = False) -> None:
        """Infer input size from the previous layer's output type."""

    def init(self, generator: torch.Generator, itype: InputType,
             device) -> Params:
        return {}

    def init_state(self, itype: InputType, device) -> Params:
        return {}

    def apply(self, params: Params, x: torch.Tensor, *,
              train: bool = False, key: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, params: Params, state: Params, x: torch.Tensor, *,
                train: bool = False, key: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Params]:
        return self.apply(params, x, train=train, key=key), state

    def regularization_score(self, params: Params) -> torch.Tensor:
        device = next(iter(params.values())).device if params else None
        return torch.zeros((), dtype=torch.float32, device=device)

    def feed_forward_mask(self, mask: Optional[torch.Tensor],
                          itype: Optional[InputType]
                          ) -> Optional[torch.Tensor]:
        """Propagate a mask through this layer (reference Layer.java:282):
        unchanged unless the layer changes the time axis."""
        return mask

    def has_params(self) -> bool:
        return False

    def n_params(self, itype: InputType) -> int:
        """Elements of the params ``init`` makes for ``itype``, counted on
        the meta device (nothing is allocated)."""
        made = self.init(torch.Generator(), itype, torch.device("meta"))
        return sum(int(t.numel()) for t in made.values())


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

    def has_params(self) -> bool:
        return True

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
        """Fresh weight under the layer's ``weight_init`` scheme (and
        ``weight_dist`` for ``distribution``), every scheme of the JAX
        package's ``init_weights`` (``nn/weights``).  torch's generator
        does not reproduce JAX's numbers, so parity runs load transferred
        params."""
        scheme = self.resolved("weight_init", "xavier")
        if torch.device(device).type == "meta":   # shapes only
            return torch.empty(shape, dtype=self._dtype(), device=device)
        w = init_weights(generator, shape, scheme, self.weight_dist)
        return w.to(device=device, dtype=self._dtype())

    def make_bias(self, shape, device) -> torch.Tensor:
        return torch.full(shape, float(self.resolved("bias_init", 0.0)),
                          dtype=self._dtype(), device=device)

    def maybe_dropout_input(self, x: torch.Tensor, train: bool,
                            key: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
        """Dropout on the layer input (reference semantics), drawn from
        ``key``; identity when unset, not training or without a key."""
        d = _dropout.resolve(self.dropout)
        if train and d is not None and key is not None:
            return d.apply(key, x)
        return x

    def maybe_noise_weights(self, params: Params, train: bool,
                            key: Optional[torch.Tensor] = None) -> Params:
        """Weight noise (``DropConnect``/``WeightNoise``) on the non-bias
        params in training: param i of the sorted names draws from
        ``fold_in(key, i)`` (bias-like names keep their index and are
        skipped), as the JAX package.  The noised tensors are what the
        layer computes with, its kernels included; the stored params are
        untouched.  Identity when unset, not training or without a
        key."""
        wn = self.weight_noise
        if not (train and wn is not None and key is not None):
            return params
        out = dict(params)
        for i, (k, v) in enumerate(sorted(params.items())):
            if k not in self._BIAS_PARAMS:
                out[k] = wn.apply(_random.fold_in(key, i), v)
        return out

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
