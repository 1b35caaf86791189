"""Attention layers: LayerNorm, MultiHeadAttention, TransformerBlock and
the sinusoidal positional encoding (port of ``nn/layers/attention.py``).

Attention implementations (``attn_impl``):
  'reference' — ``ops.attention.sdpa_reference``, always correct.
  'flash'     — ``ops.flash_attention`` (the Hopper kernel on CUDA).
  'auto'      — reference below ``DEFAULT_FLASH_MIN_SEQ`` tokens or for a
                masked input, flash at or above it.
  'ring'/'ulysses' (sequence parallelism) are not ported yet.

The flash path is differentiable: its backward runs the two Hopper
backward kernels on CUDA tensors.  KV-cache decoding and the MoE
feed-forward come in later slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ...ops.attention import sdpa_reference
from ...ops.flash_attention import flash_attention
from ...utils.serde import register_serde
from ..activations import gelu
from ..conf.input_type import InputType
from .base import BaseLayerConf, LayerConf


def _layer_norm(x, gamma, beta, eps=1e-5):
    """Population variance, eps inside the root, as the reference."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * gamma + beta


@register_serde
@dataclass
class LayerNormLayer(BaseLayerConf):
    """Layer normalization over the feature axis (gamma/beta learned)."""
    n_out: int = 0
    eps: float = 1e-5

    def set_n_in(self, itype: InputType, override: bool = False) -> None:
        if self.n_out == 0 or override:
            self.n_out = itype.size

    def init(self, generator, itype, device):
        return {"gamma": torch.ones(self.n_out, dtype=self._dtype(),
                                    device=device),
                "beta": torch.zeros(self.n_out, dtype=self._dtype(),
                                    device=device)}

    def apply(self, params, x, *, train=False):
        return _layer_norm(x, params["gamma"], params["beta"], self.eps)


_ATTN_IMPLS = ("auto", "reference", "flash", "ring", "ulysses")

# 'auto' switches to flash at this sequence length, as the reference
# does by default.  The crossover has not been measured on a GPU.
DEFAULT_FLASH_MIN_SEQ = 128


def _run_attention(q, k, v, *, impl: str, causal: bool, mask=None,
                   flash_min_seq: Optional[int] = None):
    """Dispatch ``[b, h, t, d]`` q/k/v to the selected implementation."""
    if impl not in _ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl '{impl}'; expected one of "
                         f"{_ATTN_IMPLS}")
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl='{impl}' (sequence parallelism) is not ported yet")
    if impl == "flash":
        if mask is not None:
            raise ValueError("attn_impl='flash' does not take key-padding "
                             "masks; use 'reference'/'auto' or pre-mask inputs")
        return flash_attention(q, k, v, causal=causal)
    if impl == "auto" and mask is None:
        threshold = (DEFAULT_FLASH_MIN_SEQ if flash_min_seq is None
                     else flash_min_seq)
        if q.shape[2] >= threshold:
            return flash_attention(q, k, v, causal=causal)
    return sdpa_reference(q, k, v, mask=mask, causal=causal)


@register_serde
@dataclass
class MultiHeadAttention(BaseLayerConf):
    """Multi-head self-attention over ``[b, t, n_in]``.  All heads share
    one ``[n_in, h*d]`` projection per q/k/v; heads are split head-major
    (``[b, t, h*d] -> [b, h, t, d]``)."""
    n_in: int = 0
    n_out: int = 0
    n_heads: int = 4
    head_dim: int = 0           # default n_out // n_heads
    causal: bool = False
    attn_impl: str = "auto"
    flash_min_seq: Optional[int] = None
    seq_axis: str = "seq"
    has_bias: bool = True
    attn_dropout: Optional[float] = None
    max_cache_len: int = 512

    def set_n_in(self, itype: InputType, override: bool = False) -> None:
        if self.n_in == 0 or override:
            if itype.kind != "rnn":
                raise ValueError(f"layer '{self.name}': MultiHeadAttention "
                                 f"expects RNN input, got {itype}")
            self.n_in = itype.size
        if self.n_out == 0:
            self.n_out = self.n_in

    def output_type(self, itype: InputType) -> InputType:
        return InputType.recurrent(self.n_out, itype.timesteps)

    def _dims(self):
        d = self.head_dim or max(1, self.n_out // self.n_heads)
        return self.n_heads, d

    def init(self, generator, itype, device):
        h, d = self._dims()
        params = {
            "Wq": self.make_weight(generator, (self.n_in, h * d), device),
            "Wk": self.make_weight(generator, (self.n_in, h * d), device),
            "Wv": self.make_weight(generator, (self.n_in, h * d), device),
            "Wo": self.make_weight(generator, (h * d, self.n_out), device),
        }
        if self.has_bias:
            params.update(bq=self.make_bias((h * d,), device),
                          bk=self.make_bias((h * d,), device),
                          bv=self.make_bias((h * d,), device),
                          bo=self.make_bias((self.n_out,), device))
        return params

    def _heads(self, x, p, w, b):
        h, d = self._dims()
        y = x @ p[w]
        if self.has_bias:
            y = y + p[b]
        bsz, t = y.shape[0], y.shape[1]
        return y.reshape(bsz, t, h, d).transpose(1, 2)   # [b,h,t,d]

    def attend(self, p, x, *, train=False, mask=None):
        """QKV projection -> attention -> output projection."""
        q = self._heads(x, p, "Wq", "bq")
        k = self._heads(x, p, "Wk", "bk")
        v = self._heads(x, p, "Wv", "bv")
        o = _run_attention(q, k, v, impl=self.attn_impl, causal=self.causal,
                           mask=mask, flash_min_seq=self.flash_min_seq)
        b_, h, t, d = o.shape
        y = o.transpose(1, 2).reshape(b_, t, h * d) @ p["Wo"]
        if self.has_bias:
            y = y + p["bo"]
        if train and self.attn_dropout:
            raise NotImplementedError(
                f"layer '{self.name}': attn_dropout={self.attn_dropout!r} "
                "is not ported yet (its masks come from JAX's threefry "
                "stream); train with attn_dropout unset")
        return y

    def apply(self, params, x, *, train=False, mask=None):
        params = self.maybe_noise_weights(params, train)
        x = self.maybe_dropout_input(x, train)
        return self.act_fn(self.attend(params, x, train=train, mask=mask))


@register_serde
@dataclass
class TransformerBlock(BaseLayerConf):
    """Pre-norm block: LN -> MHA -> residual, LN -> MLP(GELU) -> residual.
    The attention half's params carry an ``mha_`` prefix."""
    n_in: int = 0
    n_heads: int = 4
    ffn_mult: int = 4
    causal: bool = True
    attn_impl: str = "auto"
    flash_min_seq: Optional[int] = None
    seq_axis: str = "seq"
    eps: float = 1e-5
    max_cache_len: int = 512
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01

    def __post_init__(self):
        if self.moe_experts:
            raise NotImplementedError(
                "TransformerBlock(moe_experts>0) is not ported yet")

    def set_n_in(self, itype: InputType, override: bool = False) -> None:
        if self.n_in == 0 or override:
            if itype.kind != "rnn":
                raise ValueError(f"layer '{self.name}': TransformerBlock "
                                 f"expects RNN input, got {itype}")
            self.n_in = itype.size

    def output_type(self, itype: InputType) -> InputType:
        return InputType.recurrent(self.n_in, itype.timesteps)

    def _mha(self) -> MultiHeadAttention:
        return MultiHeadAttention(
            n_in=self.n_in, n_out=self.n_in, n_heads=self.n_heads,
            causal=self.causal, attn_impl=self.attn_impl,
            flash_min_seq=self.flash_min_seq, seq_axis=self.seq_axis,
            activation="identity", weight_init=self.weight_init,
            weight_dist=self.weight_dist, bias_init=self.bias_init,
            dtype=self.dtype, max_cache_len=self.max_cache_len)

    def init(self, generator, itype, device):
        e = self.n_in
        f = self.ffn_mult * e
        params = {f"mha_{k}": v for k, v in
                  self._mha().init(generator, itype, device).items()}
        dt = self._dtype()
        params.update({
            "W1": self.make_weight(generator, (e, f), device),
            "b1": self.make_bias((f,), device),
            "W2": self.make_weight(generator, (f, e), device),
            "b2": self.make_bias((e,), device),
            "ln1_g": torch.ones(e, dtype=dt, device=device),
            "ln1_b": torch.zeros(e, dtype=dt, device=device),
            "ln2_g": torch.ones(e, dtype=dt, device=device),
            "ln2_b": torch.zeros(e, dtype=dt, device=device),
        })
        return params

    def apply(self, params, x, *, train=False, mask=None):
        p = self.maybe_noise_weights(params, train)
        x = self.maybe_dropout_input(x, train)
        mha_p = {k[4:]: v for k, v in p.items() if k.startswith("mha_")}
        xn = _layer_norm(x, p["ln1_g"], p["ln1_b"], self.eps)
        x = x + self._mha().attend(mha_p, xn, train=train, mask=mask)
        xn = _layer_norm(x, p["ln2_g"], p["ln2_b"], self.eps)
        return x + gelu(xn @ p["W1"] + p["b1"]) @ p["W2"] + p["b2"]


@register_serde
@dataclass
class PositionalEncodingLayer(LayerConf):
    """Adds the sinusoidal table ``pos / 10000**(2*(i//2)/e)`` (sin on
    even i, cos on odd i).  No params."""

    @staticmethod
    def _pe(t, e, dtype, device):
        pos = torch.arange(t, dtype=torch.float32, device=device)
        i = torch.arange(e, dtype=torch.float32, device=device)
        angle = pos[:, None] / torch.pow(10000.0, (2 * (i // 2)) / e)
        return torch.where(i % 2 == 0, torch.sin(angle),
                           torch.cos(angle)).to(dtype)

    def apply(self, params, x, *, train=False):
        _, t, e = x.shape
        return x + self._pe(t, e, x.dtype, x.device)
