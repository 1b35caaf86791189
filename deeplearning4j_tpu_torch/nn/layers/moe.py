"""The mixture-of-experts layer of the config DSL (port of
``nn/layers/moe.py``): top-1 Switch routing over a stack of expert FFNs
with a fixed capacity, the layer-level face of ``parallel/expert.py``.

The load-balancing aux loss goes through the layer's state
(``aux_loss``, the weighted term) and into the objective by the
networks' loss (the ``AUX_LOSS`` flag), which keeps it right under remat
and in checkpoints.  Feed-forward ``[b, f]``, recurrent ``[b, t, f]`` and
convolutional ``[b, h, w, c]`` inputs (flattened) are taken as they are.
In a data-parallel wrapper's step of several ranks the layer routes the
global batch (``parallel/expert.routing_axis``): the capacity is the
global token count's, and the aux term is this rank's share of the
global one (its state holds that share).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ...utils.serde import register_serde
from ..conf.input_type import InputType
from .base import BaseLayerConf

__all__ = ["MixtureOfExpertsLayer", "moe_capacity"]


def moe_capacity(capacity_factor: float, tokens: int, n_experts: int) -> int:
    """Each expert's token budget, ``capacity_factor * tokens /
    n_experts`` truncated as Python's ``int`` truncates, and at least 1."""
    return max(int(capacity_factor * tokens / n_experts), 1)


@register_serde
@dataclass
class MixtureOfExpertsLayer(BaseLayerConf):
    """params: router ``[f, E]``, w1 ``[E, f, hidden]``, b1 ``[E, 1,
    hidden]``, w2 ``[E, hidden, n_out]``, b2 ``[E, 1, n_out]``."""
    INPUT_KIND = "any"   # FF [b,f] and RNN [b,t,f] both handled natively
    AUX_LOSS = True

    n_in: int = 0
    n_out: int = 0
    n_experts: int = 4
    hidden: int = 0                 # defaults to 4 * n_in
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01

    def set_n_in(self, itype: InputType, override: bool = False) -> None:
        if self.n_in == 0 or override:
            self.n_in = itype.size if itype.kind in ("ff", "rnn") else \
                itype.flat_size()

    def output_type(self, itype: InputType) -> InputType:
        if itype.kind == "rnn":
            return InputType.recurrent(self.n_out, itype.timesteps)
        return InputType.feed_forward(self.n_out)

    def init(self, generator, itype, device):
        if self.n_in <= 0 or self.n_out <= 0:
            raise ValueError(
                f"layer '{self.name}': n_in/n_out unset — declare the "
                "network input type")
        h = self.hidden or 4 * self.n_in
        e = self.n_experts
        return {
            "router": self.make_weight(generator, (self.n_in, e), device),
            "w1": self.make_weight(generator, (e, self.n_in, h), device),
            "b1": self.make_bias((e, 1, h), device),
            "w2": self.make_weight(generator, (e, h, self.n_out), device),
            "b2": self.make_bias((e, 1, self.n_out), device),
        }

    def init_state(self, itype, device):
        return {"aux_loss": torch.zeros((), dtype=self._dtype(),
                                        device=device)}

    def forward(self, params, state, x, *, train=False, key=None,
                mask=None):
        from ...parallel.expert import moe_ffn, routing_axis
        x = self.maybe_dropout_input(x, train, key)
        if x.ndim == 4:   # CNN [b,h,w,c] -> flat [b, h*w*c]
            x = x.reshape(x.shape[0], -1)
        shape = x.shape
        x2d = x.reshape(-1, shape[-1])
        ax = routing_axis()
        capacity = moe_capacity(self.capacity_factor,
                                x2d.shape[0] * (1 if ax is None else ax.size),
                                self.n_experts)
        y, aux = moe_ffn(params, x2d, capacity, act=self.act_fn,
                         data_axis=ax)
        new_state = {"aux_loss": (self.aux_loss_weight * aux).to(x.dtype)}
        return y.reshape(shape[:-1] + (self.n_out,)), new_state

    def apply(self, params, x, *, train=False, key=None):
        return self.forward(params, {}, x, train=train, key=key)[0]
