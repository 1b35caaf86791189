"""Recurrent layers (port of ``nn/layers/recurrent.py``): ``SimpleRnn``,
``LSTM``, ``GravesLSTM`` (peepholes), the ``Bidirectional`` wrapper and
``GravesBidirectionalLSTM``, ``LastTimeStep`` and the time-distributed
``RnnOutputLayer``.

Each recurrent layer runs one Python loop over time with the input
projection ``x @ W + b`` hoisted out of it as one matrix product, as the
reference does outside its ``lax.scan``.  State (h, c) is an explicit
carry:

    init_carry(batch, dtype, device)   -> carry
    scan(params, x, carry, mask)       -> (y [b, t, h], final carry)

``apply`` starts from a zero carry (no state across batches);
``apply_with_carry`` runs from a given one (``rnn_time_step`` streaming,
tBPTT chunks).  A masked step (mask 0) zeroes the output and holds the
carry.  ``LSTM(helper="pallas")`` runs the recurrence through
``ops/pallas_lstm.lstm_forward_fast`` (the hand-written Hopper kernel on
CUDA) where ``pallas_lstm.supports`` accepts the cell, in f32 with f32
carries, as the reference does; otherwise the plain loop.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ...ops import pallas_lstm
from ...utils import _random
from ...utils.serde import register_serde
from .. import activations as _act
from ..conf.input_type import InputType
from .base import BaseLayerConf, LayerConf, flatten_group, nest_group
from .feedforward import OutputLayer


@dataclass
class BaseRecurrentLayer(BaseLayerConf):
    """The recurrent contract (reference ``RecurrentLayer``)."""
    INPUT_KIND = "rnn"

    n_in: int = 0
    n_out: int = 0

    def set_n_in(self, itype: InputType, override: bool = False) -> None:
        if self.n_in == 0 or override:
            if itype.kind != "rnn":
                raise ValueError(f"layer '{self.name}': recurrent layer "
                                 f"expects RNN input, got {itype}")
            self.n_in = itype.size

    def output_type(self, itype: InputType) -> InputType:
        return InputType.recurrent(self.n_out, itype.timesteps)

    def _check_sizes(self) -> None:
        if self.n_in <= 0 or self.n_out <= 0:
            raise ValueError(f"layer '{self.name}': n_in/n_out unset")

    def scan(self, params, x, carry, mask=None):
        """x: [b, t, f] -> (y [b, t, h], final carry)."""
        raise NotImplementedError

    def apply(self, params, x, *, train=False, key=None, mask=None):
        params = self.maybe_noise_weights(params, train, key)
        x = self.maybe_dropout_input(x, train, key)
        carry = self.init_carry(x.shape[0], x.dtype, x.device)
        return self.scan(params, x, carry, mask)[0]

    def forward(self, params, state, x, *, train=False, key=None,
                mask=None):
        return self.apply(params, x, train=train, key=key, mask=mask), state

    def apply_with_carry(self, params, x, carry, *, train=False, key=None,
                         mask=None):
        params = self.maybe_noise_weights(params, train, key)
        x = self.maybe_dropout_input(x, train, key)
        if carry is None:
            carry = self.init_carry(x.shape[0], x.dtype, x.device)
        return self.scan(params, x, carry, mask)


def _stack_time(ys, like: torch.Tensor, width: int) -> torch.Tensor:
    if not ys:
        return like.new_zeros((like.shape[0], 0, width))
    return torch.stack(ys, dim=1)


def _mm(h, U):
    """``h @ U`` in the promoted dtype of the two, as JAX's ``@`` promotes
    (torch's refuses mixed dtypes): an f32 carry handed to a layer whose
    params a precision policy cast to bf16/f16 (tBPTT) makes an f32
    step, and the carry stays f32."""
    if h.dtype != U.dtype:
        dt = torch.promote_types(h.dtype, U.dtype)
        return h.to(dt) @ U.to(dt)
    return h @ U


@register_serde
@dataclass
class SimpleRnn(BaseRecurrentLayer):
    """h_t = act(x_t W + h_{t-1} U + b) (reference ``SimpleRnn``)."""
    HAS_CARRY = True

    def init(self, generator, itype, device):
        self._check_sizes()
        return {"W": self.make_weight(generator, (self.n_in, self.n_out),
                                      device),
                "U": self.make_weight(generator, (self.n_out, self.n_out),
                                      device),
                "b": self.make_bias((self.n_out,), device)}

    def init_carry(self, batch, dtype, device):
        return {"h": torch.zeros((batch, self.n_out), dtype=dtype,
                                 device=device)}

    def scan(self, params, x, carry, mask=None):
        act = self.act_fn
        xz = x.to(params["W"].dtype) @ params["W"] + params["b"]
        m = None if mask is None else mask.to(xz.dtype)
        h = carry["h"]
        ys = []
        for s in range(xz.shape[1]):
            h_new = act(xz[:, s] + _mm(h, params["U"]))
            if m is None:
                h = h_new
                ys.append(h_new)
            else:
                ms = m[:, s, None]
                h = ms * h_new + (1 - ms) * h
                ys.append(h_new * ms)
        return _stack_time(ys, xz, self.n_out), {"h": h}


@register_serde
@dataclass
class LSTM(BaseRecurrentLayer):
    """LSTM without peepholes (reference ``nn/conf/layers/LSTM``), gates
    IFOG.  ``helper="pallas"`` takes the fused kernel where
    ``pallas_lstm.supports`` accepts the cell (sigmoid gates, tanh
    activation, no peepholes, no mask) and the card has a launch for the
    shape (``pallas_lstm.kernel_plan_exists``), and the plain loop
    elsewhere."""
    HAS_CARRY = True
    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"
    helper: Optional[str] = None

    _PEEPHOLES = False

    def init(self, generator, itype, device):
        self._check_sizes()
        h = self.n_out
        # bias at bias_init, the forget gate's slice at
        # forget_gate_bias_init (reference LSTMParamInitializer)
        b = self.make_bias((4 * h,), device)
        b[h:2 * h] = self.forget_gate_bias_init
        params = {"W": self.make_weight(generator, (self.n_in, 4 * h), device),
                  "U": self.make_weight(generator, (h, 4 * h), device),
                  "b": b}
        if self._PEEPHOLES:
            params["p"] = torch.zeros((3 * h,), dtype=self._dtype(),
                                      device=device)    # pi, pf, po
        return params

    def init_carry(self, batch, dtype, device):
        z = torch.zeros((batch, self.n_out), dtype=dtype, device=device)
        return {"h": z, "c": z.clone()}

    def scan(self, params, x, carry, mask=None):
        if self.helper == "pallas" and pallas_lstm.supports(
                peepholes=self._PEEPHOLES,
                gate_activation=self.gate_activation,
                activation=self.resolved("activation", "tanh"),
                masked=mask is not None) and pallas_lstm.kernel_plan_exists(
                    x.shape[0], self.n_out, x.shape[1], x.device):
            f32 = torch.float32
            ys, hT, cT = pallas_lstm.lstm_forward_fast(
                x.to(f32), params["W"].to(f32), params["U"].to(f32),
                params["b"].to(f32), carry["h"].to(f32), carry["c"].to(f32))
            return ys, {"h": hT, "c": cT}
        act = self.act_fn
        gate = _act.get(self.gate_activation)
        xz = x.to(params["W"].dtype) @ params["W"] + params["b"]
        m = None if mask is None else mask.to(xz.dtype)
        peep = params.get("p") if self._PEEPHOLES else None
        if peep is not None:
            pi, pf, po = peep.chunk(3)
        hh, cc = carry["h"], carry["c"]
        ys = []
        for s in range(xz.shape[1]):
            zi, zf, zo, zg = (xz[:, s] + _mm(hh, params["U"])).chunk(
                4, dim=-1)
            if peep is not None:
                zi = zi + pi * cc
                zf = zf + pf * cc
            c_new = gate(zf) * cc + gate(zi) * act(zg)
            if peep is not None:
                zo = zo + po * c_new
            h_new = gate(zo) * act(c_new)
            if m is None:
                hh, cc = h_new, c_new
                ys.append(h_new)
            else:
                ms = m[:, s, None]
                hh = ms * h_new + (1 - ms) * hh
                cc = ms * c_new + (1 - ms) * cc
                ys.append(h_new * ms)
        return _stack_time(ys, xz, self.n_out), {"h": hh, "c": cc}


@register_serde
@dataclass
class GravesLSTM(LSTM):
    """LSTM with peephole connections (reference ``GravesLSTM.java:46``)."""
    _PEEPHOLES = True


@register_serde
@dataclass
class Bidirectional(LayerConf):
    """Runs the wrapped recurrent layer forwards and a second copy
    backwards over time, combined by mode add/mul/average/concat
    (reference ``Bidirectional``).  Its params are the JAX package's
    ``{"fwd": {...}, "bwd": {...}}`` group, held flat as ``fwd/W``, ..."""
    fwd: Optional[BaseRecurrentLayer] = None
    mode: str = "concat"           # concat | add | mul | average

    def has_params(self):
        return True

    def __post_init__(self):
        if self.fwd is not None and self.name is None:
            self.name = f"bi_{self.fwd.name or type(self.fwd).__name__}"

    def apply_global_defaults(self, defaults):
        self.fwd.apply_global_defaults(defaults)

    def set_n_in(self, itype, override=False):
        self.fwd.set_n_in(itype, override)

    def output_type(self, itype: InputType) -> InputType:
        inner = self.fwd.output_type(itype)
        if self.mode == "concat":
            return InputType.recurrent(inner.size * 2, inner.timesteps)
        return inner

    def regularization_score(self, params):
        p = nest_group(params)
        return (self.fwd.regularization_score(p.get("fwd", {})) +
                self.fwd.regularization_score(p.get("bwd", {})))

    def init(self, generator, itype, device):
        return flatten_group({"fwd": self.fwd.init(generator, itype, device),
                              "bwd": self.fwd.init(generator, itype, device)})

    def _combine(self, yf, yb):
        if self.mode == "concat":
            return torch.cat([yf, yb], dim=-1)
        if self.mode == "add":
            return yf + yb
        if self.mode == "mul":
            return yf * yb
        if self.mode == "average":
            return 0.5 * (yf + yb)
        raise ValueError(f"unknown bidirectional mode '{self.mode}'")

    def apply(self, params, x, *, train=False, key=None, mask=None):
        p = nest_group(params)
        kf, kb = (None, None) if key is None else _random.split(key)
        yf = self.fwd.apply(p["fwd"], x, train=train, key=kf, mask=mask)
        mr = None if mask is None else mask.flip(1)
        yb = self.fwd.apply(p["bwd"], x.flip(1), train=train, key=kb,
                            mask=mr)
        return self._combine(yf, yb.flip(1))

    def forward(self, params, state, x, *, train=False, key=None,
                mask=None):
        return self.apply(params, x, train=train, key=key, mask=mask), state


@register_serde
@dataclass
class GravesBidirectionalLSTM(Bidirectional):
    """Bidirectional GravesLSTM combined by ADD (reference
    ``GravesBidirectionalLSTM.java:224``)."""
    n_in: int = 0
    n_out: int = 0
    mode: str = "add"

    def __post_init__(self):
        if self.fwd is None:
            self.fwd = GravesLSTM(n_in=self.n_in, n_out=self.n_out,
                                  name=f"{self.name or 'gbilstm'}_inner")
        super().__post_init__()

    def set_n_in(self, itype, override=False):
        super().set_n_in(itype, override)
        self.n_in = self.fwd.n_in


@register_serde
@dataclass
class RnnOutputLayer(OutputLayer):
    """Dense + loss over ``[b, t, f]`` -> ``[b, t, n_out]``: the output
    head applied at every step; a ``[b, t]`` label mask weighs the steps
    in the loss."""
    INPUT_KIND = "rnn"

    def set_n_in(self, itype: InputType, override: bool = False) -> None:
        if self.n_in == 0 or override:
            if itype.kind != "rnn":
                raise ValueError(f"layer '{self.name}': RnnOutputLayer "
                                 f"expects RNN input, got {itype}")
            self.n_in = itype.size

    def output_type(self, itype: InputType) -> InputType:
        return InputType.recurrent(self.n_out, itype.timesteps)


def _last_step(y: torch.Tensor, mask: Optional[torch.Tensor]
               ) -> torch.Tensor:
    """``y[:, -1]``, or with a mask each row's last step whose mask is
    nonzero (the last NONZERO index, not count-1, as
    ``LastTimeStepVertex``; a row with no such step takes the last)."""
    if mask is None:
        return y[:, -1]
    t = mask.shape[1]
    idx = t - 1 - torch.argmax((mask.flip(1) > 0).to(torch.int32), dim=1)
    return y[torch.arange(y.shape[0], device=y.device), idx]


@register_serde
@dataclass
class LastTimeStep(LayerConf):
    """Keeps only the last (mask-aware) step of the wrapped recurrent
    layer's output: ``[b, t, h]`` -> ``[b, h]`` (reference
    ``LastTimeStep``).  Streaming and tBPTT state is the wrapped layer's."""
    underlying: Optional[LayerConf] = None

    def has_params(self):
        return self.underlying.has_params()

    @property
    def HAS_CARRY(self):
        return getattr(self.underlying, "HAS_CARRY", False)

    def init_carry(self, batch, dtype, device):
        return self.underlying.init_carry(batch, dtype, device)

    def apply_with_carry(self, params, x, carry, *, train=False, key=None,
                         mask=None):
        y, new_carry = self.underlying.apply_with_carry(
            params, x, carry, train=train, key=key, mask=mask)
        return _last_step(y, mask), new_carry

    def apply_global_defaults(self, defaults):
        if hasattr(self.underlying, "apply_global_defaults"):
            self.underlying.apply_global_defaults(defaults)

    def set_n_in(self, itype, override=False):
        self.underlying.set_n_in(itype, override)

    def output_type(self, itype: InputType) -> InputType:
        return InputType.feed_forward(self.underlying.output_type(itype).size)

    def init(self, generator, itype, device):
        return self.underlying.init(generator, itype, device)

    def regularization_score(self, params):
        return self.underlying.regularization_score(params)

    def apply(self, params, x, *, train=False, key=None, mask=None):
        y = self.underlying.apply(params, x, train=train, key=key, mask=mask)
        return _last_step(y, mask)

    def forward(self, params, state, x, *, train=False, key=None,
                mask=None):
        y, state = self.underlying.forward(params, state, x, train=train,
                                           key=key, mask=mask)
        return _last_step(y, mask), state

    def feed_forward_mask(self, mask, itype):
        return None
