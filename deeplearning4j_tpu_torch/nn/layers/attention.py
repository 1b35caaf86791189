"""Attention layers: LayerNorm, MultiHeadAttention, TransformerBlock and
the sinusoidal positional encoding (port of ``nn/layers/attention.py``).

Attention implementations (``attn_impl``):
  'reference' — ``ops.attention.sdpa_reference``, always correct.
  'flash'     — ``ops.flash_attention`` (the Hopper kernel on CUDA).
  'auto'      — reference below ``DEFAULT_FLASH_MIN_SEQ`` tokens (128,
                or ``DL4J_TPU_FLASH_MIN_SEQ`` from the environment) or
                for a masked input, flash at or above it.
  'ring'/'ulysses' — sequence parallelism (``parallel/sequence``): q/k/v
                are this rank's shard of the time axis, and ``seq_axis``
                names the axis of the mesh the caller entered (``with
                mesh:``; outside one the layer raises ``NameError``).
                Key-padding masks are refused, as in the reference.

The flash path is differentiable: its backward runs the two Hopper
backward kernels on CUDA tensors.  ``attn_dropout`` (a retain
probability) drops the attention output in training with a mask drawn
from ``fold_in(key, 7)``, as the JAX package does;
``TransformerBlock`` builds its attention without it, as there.

Incremental decoding carries a KV cache through ``init_carry`` /
``apply_with_carry`` (``rnn_time_step``, tBPTT, the generation engine).
A dense carry holds ``k``/``v`` ``[b, h, L, d]``, the validity ``m``
``[b, L]`` and the stream position ``pos``, a 0-d tensor (every row at
one position) or a ``[b]`` vector (one-token decode, each slot at its
own position).  A carry holding ``kp``/``vp`` block pools attends
through a block table (``_attend_paged``, the generation engine's paged
cache).  Positions stay on the device: no host read inside the layer
walk.  The cached paths always attend through ``sdpa_reference``, as the
reference does.

``TransformerBlock(moe_experts=E)`` replaces the dense MLP with a top-1
Switch expert stack (``parallel/expert.moe_ffn``, ``gelu``): params
``router``/``w1``/``b1``/``w2``/``b2``, and the weighted aux loss in its
state (``aux_loss``), which the networks add to the objective
(``AUX_LOSS``).  The carry paths (``rnn_time_step``, tBPTT) run the
routed MLP and leave the aux term out, as they leave out layer state.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch

from ...ops.attention import sdpa_reference
from ...ops.flash_attention import flash_attention
from ...utils import _random, global_batch
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

    def apply(self, params, x, *, train=False, key=None):
        return _layer_norm(x, params["gamma"], params["beta"], self.eps)


_ATTN_IMPLS = ("auto", "reference", "flash", "ring", "ulysses")

# 'auto' switches to flash at this sequence length, as the reference
# does by default, unless the environment's DL4J_TPU_FLASH_MIN_SEQ says
# otherwise (read once, at import, as the JAX package reads it).  The
# crossover has not been measured on a GPU.
DEFAULT_FLASH_MIN_SEQ = int(os.environ.get("DL4J_TPU_FLASH_MIN_SEQ", 128))


def _run_attention(q, k, v, *, impl: str, causal: bool, mask=None,
                   flash_min_seq: Optional[int] = None, seq_axis="seq"):
    """Dispatch ``[b, h, t, d]`` q/k/v to the selected implementation."""
    if impl not in _ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl '{impl}'; expected one of "
                         f"{_ATTN_IMPLS}")
    if impl in ("ring", "ulysses"):
        from ...parallel.sequence import (ring_self_attention,
                                          ulysses_attention)
        if mask is not None:
            raise ValueError("sequence-parallel attention does not take "
                             "key-padding masks (pad to shard boundary)")
        fn = ring_self_attention if impl == "ring" else ulysses_attention
        return fn(q, k, v, axis_name=seq_axis, causal=causal)
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


def _clamped_start(pos, hi: int):
    """Where ``lax.dynamic_update_slice`` starts a write at ``pos``: it
    clamps the start into ``[0, hi]`` (``hi`` = capacity - rows
    written).  ``pos`` is an int or a tensor, kept on its device."""
    if isinstance(pos, torch.Tensor):
        return pos.to(torch.int64).clamp(0, hi)
    return min(max(int(pos), 0), hi)


def _kv_quantize(x: torch.Tensor):
    """Per-(row, head) absmax int8 quantization of a ``[..., d]`` K/V
    write (JAX ``_kv_quantize``): ``(codes int8, scale f32 [...])`` with
    codes * scale ≈ x; rounding half to even, as ``jnp.round``.  Both
    divisions are true divisions on every device: torch's CUDA kernel
    divides by a Python scalar as a multiply by its reciprocal, which
    can land an ulp away from the CPU's (and the reference's) quotient,
    so 127 comes in as a tensor."""
    amax = x.abs().amax(dim=-1)
    scale = (torch.clamp(amax, min=1e-8)
             / torch.full_like(amax, 127.0)).to(torch.float32)
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


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

    INPUT_KIND = "rnn"
    HAS_CARRY = True

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

    def attend(self, p, x, *, train=False, key=None, mask=None):
        """QKV projection -> attention -> output projection."""
        q = self._heads(x, p, "Wq", "bq")
        k = self._heads(x, p, "Wk", "bk")
        v = self._heads(x, p, "Wv", "bv")
        o = _run_attention(q, k, v, impl=self.attn_impl, causal=self.causal,
                           mask=mask, flash_min_seq=self.flash_min_seq,
                           seq_axis=self.seq_axis)
        b_, h, t, d = o.shape
        y = o.transpose(1, 2).reshape(b_, t, h * d) @ p["Wo"]
        if self.has_bias:
            y = y + p["bo"]
        return self._maybe_attn_dropout(y, train, key)

    def _maybe_attn_dropout(self, y, train, key):
        """Inverted dropout of the attention output with retain
        probability ``attn_dropout``, drawn from ``fold_in(key, 7)``."""
        if train and self.attn_dropout and key is not None:
            keep = self.attn_dropout
            k7 = _random.fold_in(key, 7)
            mask_d = global_batch.rows(
                lambda s: _random.bernoulli(k7, keep, s), y.shape)
            y = torch.where(mask_d, y / keep,
                            torch.zeros((), dtype=y.dtype, device=y.device))
        return y

    def apply(self, params, x, *, train=False, key=None, mask=None):
        params = self.maybe_noise_weights(params, train, key)
        x = self.maybe_dropout_input(x, train, key)
        return self.act_fn(self.attend(params, x, train=train, key=key,
                                       mask=mask))

    def forward(self, params, state, x, *, train=False, key=None,
                mask=None):
        return self.apply(params, x, train=train, key=key, mask=mask), state

    # ---- KV-cache incremental decoding -----------------------------------
    def init_carry(self, batch, dtype, device, max_len=None):
        """Zero dense carry.  ``max_len`` overrides the cache capacity
        (``max_cache_len`` by default); ``attend_cached`` reads the
        capacity from the carry."""
        h, d = self._dims()
        L = self.max_cache_len if max_len is None else int(max_len)
        return {"k": torch.zeros((batch, h, L, d), dtype=dtype,
                                 device=device),
                "v": torch.zeros((batch, h, L, d), dtype=dtype,
                                 device=device),
                "m": torch.zeros((batch, L), dtype=torch.float32,
                                 device=device),
                "pos": torch.zeros((), dtype=torch.int32, device=device)}

    def attend_cached(self, p, x, carry, *, mask=None):
        """Project the t new steps, write them into the cache, attend q
        against the written prefix.  Masked steps are recorded invalid
        and their outputs zeroed.  Returns ``(y [b, t, n_out],
        new_carry)``; the dense carry is rebuilt, not written in place,
        so tBPTT can differentiate through it.  A vector ``pos`` takes
        t == 1 only: the written-prefix mask is then the causal mask.  A
        carry with ``kp`` goes to ``_attend_paged``."""
        if "kp" in carry:
            return self._attend_paged(p, x, carry, mask=mask)
        q = self._heads(x, p, "Wq", "bq")                 # [b,h,t,d]
        k_new = self._heads(x, p, "Wk", "bk")
        v_new = self._heads(x, p, "Wv", "bv")
        pos = carry["pos"]
        kc, vc = carry["k"], carry["v"]
        b_, h, t = q.shape[0], q.shape[1], q.shape[2]
        L = kc.shape[2]
        dev = x.device
        chunk_valid = (torch.ones((b_, t), dtype=torch.float32, device=dev)
                       if mask is None else mask.to(torch.float32))
        ar_l = torch.arange(L, device=dev)
        if isinstance(pos, torch.Tensor) and pos.ndim == 1:
            if t != 1:
                raise ValueError(
                    "per-row vector pos carries support single-token decode "
                    f"only (t=1), got a {t}-step chunk")
            at = _clamped_start(pos, L - 1)               # [b]
            rows = torch.arange(b_, device=dev)[:, None]
            heads = torch.arange(h, device=dev)[None, :]
            k = kc.index_put((rows, heads, at[:, None]),
                             k_new[:, :, 0].to(kc.dtype))
            v = vc.index_put((rows, heads, at[:, None]),
                             v_new[:, :, 0].to(vc.dtype))
            m = carry["m"].index_put((rows[:, 0], at), chunk_valid[:, 0])
            written = (ar_l[None, :] < (pos + t)[:, None]).to(torch.float32)
            o = sdpa_reference(q, k.to(q.dtype), v.to(q.dtype),
                               mask=m * written, causal=False)
        else:
            idx = _clamped_start(pos, L - t) + torch.arange(t, device=dev)
            k = kc.index_copy(2, idx, k_new.to(kc.dtype))
            v = vc.index_copy(2, idx, v_new.to(vc.dtype))
            m = carry["m"].index_copy(1, idx, chunk_valid)
            written = (ar_l < pos + t).to(torch.float32)
            o = sdpa_reference(q, k.to(q.dtype), v.to(q.dtype),
                               mask=m * written[None, :], causal=self.causal,
                               q_offset=pos)
        y = self._project_out(p, o, mask)
        return y, {"k": k, "v": v, "m": m, "pos": pos + t}

    def _project_out(self, p, o, mask):
        b_, _, t, _ = o.shape
        y = o.transpose(1, 2).reshape(b_, t, -1) @ p["Wo"]
        if self.has_bias:
            y = y + p["bo"]
        if mask is not None:   # zero outputs at padded query steps
            y = y * mask.to(y.dtype)[:, :, None]
        return y

    @staticmethod
    def _gather_pool(pool, scales, table, dtype):
        """``[S, h, NB * block, d]`` keys or values gathered through an
        ``[S, NB]`` block table (virtual position == token position).  An
        int8 pool is dequantized here against its ``[n_blocks, h, block]``
        scales: quantized storage, full-precision math."""
        table = table.to(torch.int64)
        g = pool[table]                                # [S, NB, h, blk, d]
        if scales is not None:
            g = g.to(torch.float32) * scales[table][..., None]
        s_, nb, h, blk, d = g.shape
        return g.permute(0, 2, 1, 3, 4).reshape(s_, h, nb * blk,
                                                d).to(dtype)

    def _attend_paged(self, p, x, carry, *, mask=None):
        """Attention through the paged block pool of the generation
        engine (``generation/cache.PagedKV``).  The carry holds the pools
        ``kp``/``vp`` ``[n_blocks, h, block, d]`` (int8 pools add
        ``ksc``/``vsc`` ``[n_blocks, h, block]`` scales), the block ``table``
        and ``pos``: an ``[S, NB]`` table with ``[S]`` positions for the
        one-token decode step, or an ``[NB]`` row with a scalar start for
        a prompt suffix (batch 1).

        The pools are written IN PLACE at ``table[pos // block], pos %
        block``; padded and inactive lanes write into physical block 0,
        the trash block, which is never allocated and never read through
        the written-prefix mask (duplicate writes there may land in any
        order).  Reads gather the whole virtual axis, so masked tail
        entries contribute exact zeros to the softmax."""
        q = self._heads(x, p, "Wq", "bq")                 # [b,h,t,d]
        k_new = self._heads(x, p, "Wk", "bk")
        v_new = self._heads(x, p, "Wv", "bv")
        kp, vp = carry["kp"], carry["vp"]
        table, pos = carry["table"], carry["pos"]
        blk = kp.shape[2]
        t = q.shape[2]
        dev = x.device
        chunk_valid = (torch.ones((x.shape[0], t), dtype=torch.float32,
                                  device=dev)
                       if mask is None else mask.to(torch.float32))
        if isinstance(pos, torch.Tensor) and pos.ndim == 1:
            # decode: one token per slot, per-slot positions, [S, NB]
            if t != 1:
                raise ValueError(
                    "per-slot vector pos supports single-token decode "
                    f"only (t=1), got a {t}-step chunk")
            nb = table.shape[1]
            bidx = (pos // blk).clamp(0, nb - 1).to(torch.int64)
            phys = torch.gather(table, 1, bidx[:, None])[:, 0]
            off = pos % blk
            kw, vw = k_new[:, :, 0, :], v_new[:, :, 0, :]   # [S, h, d]
            tab2 = table
            written = (torch.arange(nb * blk, device=dev)[None, :]
                       < (pos + t)[:, None]).to(torch.float32)
            causal, q_offset = False, 0
        else:
            # prompt suffix: batch 1, t steps from `pos`
            nb = table.shape[0]
            p_j = pos + torch.arange(t, device=dev)
            bidx = (p_j // blk).clamp(0, nb - 1)
            phys = torch.where(chunk_valid[0] > 0, table[bidx], 0)
            off = p_j % blk
            kw = k_new[0].transpose(0, 1)                  # [t, h, d]
            vw = v_new[0].transpose(0, 1)
            tab2 = table[None, :]
            v_ax = nb * blk
            ar_v = torch.arange(v_ax, device=dev)
            chunk_m = torch.zeros(v_ax, dtype=torch.float32,
                                  device=dev).index_copy(
                0, _clamped_start(pos, v_ax - t)
                + torch.arange(t, device=dev), chunk_valid[0])
            written = ((ar_v < pos).to(torch.float32)
                       + chunk_m).clamp(0.0, 1.0)[None, :]
            causal, q_offset = self.causal, pos
        phys = phys.to(torch.int64)
        off = off.to(torch.int64)
        ksc, vsc = carry.get("ksc"), carry.get("vsc")
        if kp.dtype == torch.int8:
            kq, ks = _kv_quantize(kw)
            vq, vs = _kv_quantize(vw)
            kp[phys, :, off, :] = kq
            vp[phys, :, off, :] = vq
            ksc[phys, :, off] = ks
            vsc[phys, :, off] = vs
        else:
            kp[phys, :, off, :] = kw.to(kp.dtype)
            vp[phys, :, off, :] = vw.to(vp.dtype)
        k = self._gather_pool(kp, ksc, tab2, q.dtype)
        v = self._gather_pool(vp, vsc, tab2, q.dtype)
        o = sdpa_reference(q, k, v, mask=written, causal=causal,
                           q_offset=q_offset)
        return self._project_out(p, o, mask), dict(carry, pos=pos + t)

    def apply_with_carry(self, params, x, carry, *, train=False, key=None,
                         mask=None):
        if carry is None:
            carry = self.init_carry(x.shape[0], x.dtype, x.device)
        params = self.maybe_noise_weights(params, train, key)
        x = self.maybe_dropout_input(x, train, key)
        y, new_carry = self.attend_cached(params, x, carry, mask=mask)
        y = self._maybe_attn_dropout(y, train, key)
        return self.act_fn(y), new_carry


@register_serde
@dataclass
class TransformerBlock(BaseLayerConf):
    """Pre-norm block: LN -> MHA -> residual, LN -> MLP(GELU) -> residual.
    The attention half's params carry an ``mha_`` prefix.  With
    ``moe_experts > 0`` the MLP is a top-1 routed expert stack (Switch)
    whose aux loss threads through the block's state."""
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

    INPUT_KIND = "rnn"
    HAS_CARRY = True
    _BIAS_PARAMS = ("mha_bq", "mha_bk", "mha_bv", "mha_bo", "b1", "b2",
                    "ln1_g", "ln1_b", "ln2_g", "ln2_b")

    @property
    def AUX_LOSS(self):
        return self.moe_experts > 0

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
        if self.moe_experts > 0:
            n = self.moe_experts
            params.update({
                "router": self.make_weight(generator, (e, n), device),
                "w1": self.make_weight(generator, (n, e, f), device),
                "b1": self.make_bias((n, 1, f), device),
                "w2": self.make_weight(generator, (n, f, e), device),
                "b2": self.make_bias((n, 1, e), device),
            })
        else:
            params.update({
                "W1": self.make_weight(generator, (e, f), device),
                "b1": self.make_bias((f,), device),
                "W2": self.make_weight(generator, (f, e), device),
                "b2": self.make_bias((e,), device),
            })
        params.update({
            "ln1_g": torch.ones(e, dtype=dt, device=device),
            "ln1_b": torch.zeros(e, dtype=dt, device=device),
            "ln2_g": torch.ones(e, dtype=dt, device=device),
            "ln2_b": torch.zeros(e, dtype=dt, device=device),
        })
        return params

    def init_state(self, itype, device):
        if self.moe_experts > 0:
            return {"aux_loss": torch.zeros((), dtype=self._dtype(),
                                            device=device)}
        return {}

    def _ffn(self, p, xn):
        """The dense or routed MLP; returns ``(out, state update)``."""
        if self.moe_experts == 0:
            return gelu(xn @ p["W1"] + p["b1"]) @ p["W2"] + p["b2"], {}
        from ...parallel.expert import moe_ffn, routing_axis
        from .moe import moe_capacity
        b, t, e = xn.shape
        ax = routing_axis()
        capacity = moe_capacity(self.moe_capacity_factor,
                                b * t * (1 if ax is None else ax.size),
                                self.moe_experts)
        moe_p = {k: p[k] for k in ("router", "w1", "b1", "w2", "b2")}
        y, aux = moe_ffn(moe_p, xn.reshape(b * t, e), capacity, act=gelu,
                         data_axis=ax)
        return y.reshape(b, t, e), {
            "aux_loss": (self.aux_loss_weight * aux).to(xn.dtype)}

    def forward(self, params, state, x, *, train=False, key=None,
                mask=None):
        p = self.maybe_noise_weights(params, train, key)
        x = self.maybe_dropout_input(x, train, key)
        mha_p = {k[4:]: v for k, v in p.items() if k.startswith("mha_")}
        xn = _layer_norm(x, p["ln1_g"], p["ln1_b"], self.eps)
        x = x + self._mha().attend(mha_p, xn, train=train, key=key,
                                   mask=mask)
        xn = _layer_norm(x, p["ln2_g"], p["ln2_b"], self.eps)
        ff, st = self._ffn(p, xn)
        return x + ff, (st if st else state)

    def apply(self, params, x, *, train=False, key=None, mask=None):
        return self.forward(params, {}, x, train=train, key=key,
                            mask=mask)[0]

    # ---- KV-cache incremental decoding -----------------------------------
    def init_carry(self, batch, dtype, device, max_len=None):
        return self._mha().init_carry(batch, dtype, device, max_len=max_len)

    def apply_with_carry(self, params, x, carry, *, train=False, key=None,
                         mask=None):
        if carry is None:
            carry = self.init_carry(x.shape[0], x.dtype, x.device)
        p = self.maybe_noise_weights(params, train, key)
        x = self.maybe_dropout_input(x, train, key)
        mha_p = {k[4:]: v for k, v in p.items() if k.startswith("mha_")}
        xn = _layer_norm(x, p["ln1_g"], p["ln1_b"], self.eps)
        attn, new_carry = self._mha().attend_cached(mha_p, xn, carry,
                                                    mask=mask)
        x = x + attn
        xn = _layer_norm(x, p["ln2_g"], p["ln2_b"], self.eps)
        return x + self._ffn(p, xn)[0], new_carry


@register_serde
@dataclass
class PositionalEncodingLayer(LayerConf):
    """Adds the sinusoidal table ``pos / 10000**(2*(i//2)/e)`` (sin on
    even i, cos on odd i).  No params.  The carry is the stream position,
    so incremental decoding keeps absolute positions."""
    HAS_CARRY = True

    @staticmethod
    def _pe(t, e, offset, dtype, device):
        """The table for ``t`` steps from ``offset``: an int or 0-d tensor
        (``[t, e]``) or a ``[b]`` vector of per-row positions (``[b, t,
        e]``, the slot-batched decode step)."""
        if not isinstance(offset, torch.Tensor):
            # a fill, not a host-to-device copy: a captured train step
            # may run this
            offset = torch.full((), int(offset), dtype=torch.int64,
                                device=device)
        offset = offset.to(device=device, dtype=torch.float32)
        pos = offset[..., None] + torch.arange(t, dtype=torch.float32,
                                               device=device)
        i = torch.arange(e, dtype=torch.float32, device=device)
        angle = pos[..., None] / torch.pow(10000.0, (2 * (i // 2)) / e)
        return torch.where(i % 2 == 0, torch.sin(angle),
                           torch.cos(angle)).to(dtype)

    def apply(self, params, x, *, train=False, key=None):
        _, t, e = x.shape
        return x + self._pe(t, e, 0, x.dtype, x.device)

    def init_carry(self, batch, dtype, device, max_len=None):
        return {"pos": torch.zeros((), dtype=torch.int32, device=device)}

    def apply_with_carry(self, params, x, carry, *, train=False, key=None,
                         mask=None):
        if carry is None:
            carry = self.init_carry(x.shape[0], x.dtype, x.device)
        _, t, e = x.shape
        y = x + self._pe(t, e, carry["pos"], x.dtype, x.device)
        return y, {"pos": carry["pos"] + t}
