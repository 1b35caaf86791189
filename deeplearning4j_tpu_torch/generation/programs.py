"""The two generation programs: paged prefill (one request, its unshared
prompt suffix padded onto the ``data/shapes.suffix_prefill_buckets``
ladder) and paged decode (one token for every slot of the batch), port
of ``generation/programs.py``.

The reference traces both into compiled programs that donate the cache.
The port runs them eagerly under ``torch.inference_mode()`` (entered by
the program itself, in whichever thread calls it) and writes the block
pools IN PLACE: ``caches`` is the engine's ``PagedKV.caches`` dict, and a
dense RNN carry is replaced in it.  The attention inside runs through
``sdpa_reference`` (``MultiHeadAttention._attend_paged``), as in the
reference; an ``LSTM(helper="pallas")`` layer takes its kernel where its
rule admits the shape (the unmasked decode step, not the masked prefill).

Both programs return the sampled token(s) and the log-probabilities the
sampler drew from, left on the device.  Block tables and positions are
device tensors the engine copies once per call; ``slot``, ``start``,
``length`` and the copy-on-write pair are host ints.
"""
from __future__ import annotations

import torch

from .sampling import sample_tokens

__all__ = ["build_generation_fn", "fresh_carries", "install_carry",
           "carried_layers", "paged_layout"]

# log-prob floor for softmax-headed models: keeps log() finite on exact
# zeros without perturbing the sampling order of reachable tokens
_LOG_FLOOR = 1e-30

_META = torch.device("meta")


def carried_layers(conf) -> dict:
    """``{layer_i: conf}`` for every layer with ``HAS_CARRY``."""
    return {f"layer_{i}": lc for i, lc in enumerate(conf.layers)
            if getattr(lc, "HAS_CARRY", False)}


def _fresh_carry(lc, batch: int, max_len: int, device):
    """Zero carry sized to ``max_len``.  A layer whose ``init_carry``
    takes no ``max_len`` (the recurrent layers: no sequence axis) keeps
    the three-argument call; such a layer may not return a carry with a
    sequence axis of another length, which would clamp writes past its
    capacity onto its last row: refuse it loudly."""
    try:
        return lc.init_carry(batch, torch.float32, device, max_len=max_len)
    except TypeError:
        carry = lc.init_carry(batch, torch.float32, device)
    if isinstance(carry, dict):
        for key, leaf in carry.items():
            if getattr(leaf, "ndim", 0) >= 3 and leaf.shape[2] != max_len:
                raise ValueError(
                    f"{type(lc).__name__}.init_carry ignored max_len="
                    f"{max_len}: its '{key}' cache has capacity "
                    f"{leaf.shape[2]} — the layer (or its wrapper) must "
                    "accept init_carry(batch, dtype, device, max_len=...) "
                    "to be generatable")
    return carry


def fresh_carries(conf, batch: int, max_len: int, device) -> dict:
    return {name: _fresh_carry(lc, batch, max_len, device)
            for name, lc in carried_layers(conf).items()}


def paged_layout(conf) -> dict:
    """Each carried layer's kind for the paged cache, from its carry's
    schema (probed on the meta device, nothing allocated): ``"attn"``
    (``k``/``v``/``pos``: K/V move into the block pool), ``"pos"`` (a
    position only: rebuilt from engine data every call) or ``"rnn"``
    (anything else: a dense per-slot row; prefix sharing is off for such
    a stack, as recurrent state cannot be rebuilt from a suffix)."""
    out = {}
    for name, lc in carried_layers(conf).items():
        probe = _fresh_carry(lc, 1, 8, _META)
        if isinstance(probe, dict) and {"k", "v", "pos"} <= set(probe):
            out[name] = "attn"
        elif isinstance(probe, dict) and set(probe) == {"pos"}:
            out[name] = "pos"
        else:
            out[name] = "rnn"
    return out


def install_carry(cache: dict, carry: dict, slot: int, length: int) -> None:
    """Write a freshly prefilled carry (batch 1) into row ``slot`` of the
    slot-batched ``cache``, in place: ``pos`` gets the TRUE prompt
    ``length`` (not the padded bucket), ``m`` is rewritten full width (a
    previous occupant's validity never leaks), sequence-axis leaves land
    at the row origin, any other leaf (RNN ``h``/``c``) is the row."""
    for key, leaf in carry.items():
        dst = cache[key]
        if key == "pos":
            dst[slot] = length
        elif key == "m":
            dst[slot] = 0.0
            dst[slot, :leaf.shape[1]] = leaf[0].to(dst.dtype)
        elif leaf.ndim >= 3:
            dst[slot, :, :leaf.shape[2]] = leaf[0].to(dst.dtype)
        else:
            dst[slot] = leaf[0].to(dst.dtype)


def _head_logp(conf, probs):
    """Log-probabilities from the stack output: a softmax head emits
    probabilities (logged, floored at 1e-30), anything else is taken as
    logits."""
    if getattr(conf.layers[-1], "activation", None) == "softmax":
        return torch.log(torch.clamp(probs, min=_LOG_FLOOR))
    return probs


def build_generation_fn(conf, kind: str):
    """The program ``kind`` (``"paged_prefill"``/``"paged_decode"``) over
    ``conf``.  It closes over the configuration only, never a network, so
    a hot swap to equal-topology weights runs the same function."""
    from ..nn.multilayer import _stack_forward

    layout = paged_layout(conf)
    carried = carried_layers(conf)

    if kind == "paged_prefill":
        def paged_prefill(params, state, tokens, mask, caches, table_row,
                          slot, start, length, cow_src, cow_dst, keys,
                          temp, top_k, top_p):
            """Suffix prefill through the block pool.  ``tokens`` [1, T]
            are the unshared suffix ids (T = the suffix bucket), ``mask``
            [1, T] marks the true ``length``, ``table_row`` [NB] is the
            slot's block table (shared prefix blocks + private suffix
            blocks), ``start`` the first suffix position; a copy-on-write
            pair ``cow_src -> cow_dst`` is copied in every attention
            layer's pool before the walk (0, 0: none).  ``keys``/``temp``
            /``top_k``/``top_p`` are the sampler's [1]-row data.  Samples
            the token after position ``start + length - 1`` and installs
            any dense RNN carry at ``slot``.  Returns ``(token [1],
            logp [V])``."""
            with torch.inference_mode():
                T = tokens.shape[1]
                carries = {}
                for name, kv_kind in layout.items():
                    if kv_kind == "attn":
                        pool = caches[name]
                        if cow_dst:
                            for buf in pool.values():
                                buf[cow_dst] = buf[cow_src]
                        carries[name] = dict(pool, table=table_row,
                                             pos=start)
                    elif kv_kind == "pos":
                        carries[name] = {"pos": start}
                    else:
                        carries[name] = _fresh_carry(carried[name], 1, T,
                                                     tokens.device)
                probs = _stack_forward(conf, params, state, tokens,
                                       train=False, mask=mask,
                                       carries=carries)[0]
                logp = _head_logp(conf, probs[0, length - 1])      # [V]
                tok = sample_tokens(logp[None], keys, temp, top_k, top_p)
                for name, kv_kind in layout.items():
                    if kv_kind == "rnn":
                        install_carry(caches[name], carries[name], slot,
                                      start + length)
                return tok, logp
        return paged_prefill

    if kind == "paged_decode":
        def paged_decode(params, state, tokens, caches, tables, pos, keys,
                         temp, top_k, top_p):
            """One token per slot through the block pool.  ``tables``
            [S, NB] and ``pos`` [S] are data: any slot and block mix runs
            the same code.  Inactive lanes (pos 0, all-trash table) write
            into block 0 and read nothing they keep.  Returns ``(tokens
            [S], logp [S, V])``."""
            with torch.inference_mode():
                carries = {}
                for name, kv_kind in layout.items():
                    if kv_kind == "attn":
                        carries[name] = dict(caches[name], table=tables,
                                             pos=pos)
                    elif kv_kind == "pos":
                        carries[name] = {"pos": pos}
                    else:
                        carries[name] = dict(caches[name])
                probs = _stack_forward(conf, params, state, tokens[:, None],
                                       train=False, carries=carries)[0]
                logp = _head_logp(conf, probs[:, -1, :])           # [S, V]
                toks = sample_tokens(logp, keys, temp, top_k, top_p)
                for name, kv_kind in layout.items():
                    if kv_kind == "rnn":
                        caches[name] = carries[name]
                return toks, logp
        return paged_decode

    raise KeyError(kind)
