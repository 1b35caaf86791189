"""Layer wrappers and reshapes (port of ``nn/layers/misc.py``):
``FrozenLayer``, ``ReshapeLayer``, ``PermuteLayer`` and ``RepeatVector``.

``FrozenLayer`` runs the layer it wraps in inference mode whatever the
caller asks (no dropout; BatchNorm normalises with its running
statistics and keeps them), on detached params, adds no regularisation
score, and the updater labels its group ``frozen`` (``nn/_common``): its
params and their updater state never move in ``fit``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ...utils.serde import register_serde
from ..conf.input_type import InputType
from .base import LayerConf


def _detached(params):
    return {k: v.detach() for k, v in params.items()}


@register_serde
@dataclass
class FrozenLayer(LayerConf):
    """Freeze the wrapped layer's params (training no-op, inference
    normal)."""
    underlying: Optional[LayerConf] = None

    FROZEN = True

    def has_params(self):
        return self.underlying.has_params()

    @property
    def INPUT_KIND(self):  # the auto preprocessor sees the real kind
        return getattr(self.underlying, "INPUT_KIND", "any")

    @property
    def HAS_CARRY(self):
        return getattr(self.underlying, "HAS_CARRY", False)

    def init_carry(self, batch, dtype, device, max_len=None):
        if max_len is not None:
            return self.underlying.init_carry(batch, dtype, device,
                                              max_len=max_len)
        return self.underlying.init_carry(batch, dtype, device)

    def apply_with_carry(self, params, x, carry, *, train=False, key=None,
                         mask=None):
        return self.underlying.apply_with_carry(
            _detached(params), x, carry, train=train, key=key, mask=mask)

    def apply_global_defaults(self, defaults):
        if hasattr(self.underlying, "apply_global_defaults"):
            self.underlying.apply_global_defaults(defaults)

    def set_n_in(self, itype, override=False):
        self.underlying.set_n_in(itype, override)

    def output_type(self, itype: InputType) -> InputType:
        return self.underlying.output_type(itype)

    def init(self, generator, itype, device):
        return self.underlying.init(generator, itype, device)

    def init_state(self, itype, device):
        return self.underlying.init_state(itype, device)

    def apply(self, params, x, *, train=False, key=None, mask=None):
        return self.forward(params, {}, x, train=train, key=key,
                            mask=mask)[0]

    def forward(self, params, state, x, *, train=False, key=None,
                mask=None):
        # inference mode for the wrapped layer, as the reference's
        # FrozenLayer delegates with training disabled
        return self.underlying.forward(_detached(params), state, x,
                                       train=False, key=key, mask=mask)

    def compute_loss(self, params, x, labels, *, train=False, key=None,
                     mask=None):
        return self.underlying.compute_loss(_detached(params), x, labels,
                                            train=False, key=key, mask=mask)

    def feed_forward_mask(self, mask, itype):
        return self.underlying.feed_forward_mask(mask, itype)


def _itype_of(shape) -> InputType:
    """Per-example shape -> input type: rank 1 ff, 2 rnn [t, f], 3 cnn."""
    t = tuple(int(d) for d in shape)
    if len(t) == 1:
        return InputType.feed_forward(t[0])
    if len(t) == 2:
        return InputType.recurrent(t[1], t[0])
    if len(t) == 3:
        return InputType.convolutional(t[0], t[1], t[2])
    raise ValueError(f"unsupported per-example rank {len(t)}")


@register_serde
@dataclass
class ReshapeLayer(LayerConf):
    """Per-example reshape (Keras ``Reshape``); ``target_shape`` of rank
    1 is ff, 2 rnn ``[t, f]``, 3 cnn ``[h, w, c]``."""
    INPUT_KIND = "any"

    target_shape: tuple = ()

    def output_type(self, itype: InputType) -> InputType:
        return _itype_of(self.target_shape)

    def feed_forward_mask(self, mask, itype):
        return None   # the time axis is reinterpreted or gone

    def apply(self, params, x, *, train=False, key=None):
        return x.reshape((x.shape[0],) + tuple(int(d)
                                               for d in self.target_shape))


@register_serde
@dataclass
class PermuteLayer(LayerConf):
    """Per-example axis permutation (Keras ``Permute``: 1-indexed dims
    over the per-example axes, the batch axis fixed)."""
    INPUT_KIND = "any"

    dims: tuple = ()

    def output_type(self, itype: InputType) -> InputType:
        if itype.kind == "rnn":
            shape = [itype.timesteps, itype.size]
        elif itype.kind == "cnn":
            shape = [itype.height, itype.width, itype.channels]
        else:
            shape = [itype.size]
        return _itype_of([shape[d - 1] for d in self.dims])

    def feed_forward_mask(self, mask, itype):
        return None   # the time axis moves

    def apply(self, params, x, *, train=False, key=None):
        return x.permute((0,) + tuple(int(d) for d in self.dims))


@register_serde
@dataclass
class RepeatVector(LayerConf):
    """Repeat a ``[b, f]`` vector n times: ``[b, n, f]``."""
    INPUT_KIND = "ff"

    n: int = 1

    def output_type(self, itype: InputType) -> InputType:
        return InputType.recurrent(itype.size, self.n)

    def feed_forward_mask(self, mask, itype):
        return None   # every repeated step is a real step

    def apply(self, params, x, *, train=False, key=None):
        return x[:, None, :].expand(-1, self.n, -1).contiguous()
