"""Batched embedding-update steps: SkipGram, CBOW, GloVe (port of
``nlp/elements.py``).

Reference ``models/embeddings/learning/impl/elements/{SkipGram,CBOW,GloVe}.java``:
the reference batches ~4096 ``AggregateSkipGram`` native ops per
executioner call (``SkipGram.java:271-283``).  Here one call is one padded
index batch: gather rows, sigmoid dot products, add the updates into the
tables.  The JAX package's ``lax.scan`` over S steps is a Python loop over
the S steps, each step reading the tables the previous one wrote.  The
steps are plain PyTorch (the JAX package leaves them to XLA: no Pallas
kernel).

The step functions update the tables IN PLACE and return them, as the
JAX package's donate their buffers: a caller keeps no other view of a
table it passes.  Everything a block draws or masks that does not depend
on the tables (the negatives' threefry draws, row and sample masks) is
computed for the whole block before the step loop, in one batched call.

Shapes: B pairs, C max code length (HS), K negatives.  Padded slots carry
mask 0: zero gradient, an add of zeros.  The S-step functions take
``active``, the number of leading steps that hold rows (the host knows it
from the n_valids it packed): the steps after it would only add zeros, and
are skipped.
"""
from __future__ import annotations

import os
import threading

import torch

from ..utils import _random

# The table-update rule of the JAX package, under the same names: at or
# below this vocabulary size the scatter-add is a one-hot product (the
# JAX package measured it 3-4.4x faster on a TPU, whose scatter
# serializes duplicate indices); above it, or when the one-hot operand
# would exceed _DENSE_TABLE_MAX_ELEMS f32 elements, the scatter-add.
# DL4J_TPU_DENSE_TABLE_MAX_V=0 forces the scatter everywhere.
_DENSE_TABLE_MAX_V = int(os.environ.get("DL4J_TPU_DENSE_TABLE_MAX_V", "65536"))
_DENSE_TABLE_MAX_ELEMS = int(
    os.environ.get("DL4J_TPU_DENSE_TABLE_MAX_ELEMS", "250000000"))

# cuBLAS reads the TF32 switch at each call; the one-hot product must run
# in true f32 whatever the process set, so it clears the switch for its
# own call, under a lock (thread workers share the switch).
_F32_LOCK = threading.Lock()


def _f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the operands' own precision: on a card, with TF32 off
    for this call only."""
    if a.device.type != "cuda":
        return a @ b
    with _F32_LOCK:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return a @ b
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


def _add_rows(tab: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor
              ) -> torch.Tensor:
    """``tab[idx] += upd`` along dim 0 with duplicates summed in a fixed
    order, in place: on a card ``index_put_(accumulate=True)``, which sorts
    the indices and sums each row's duplicates in order (CUDA
    ``index_add_`` adds floats with atomics, in no fixed order); on the CPU
    ``index_add_``, which adds the rows one after another (the CPU's
    ``index_put_(accumulate=True)`` adds them from several threads)."""
    if tab.device.type == "cuda":
        return tab.index_put_((idx,), upd, accumulate=True)
    return tab.index_add_(0, idx, upd)


def _table_add(tab: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor
               ) -> torch.Tensor:
    """``tab[idx] += upd`` with duplicates summed, in place.

    ``idx``: integer rows, any shape; ``upd``: the matching update rows
    with a trailing D axis.  The dense branch adds the one-hot product
    ``onehot(idx)^T @ upd`` in true f32; the scatter branch is
    ``_add_rows``: deterministic, as the JAX package's sorted segment sum.
    The two sum duplicates in different float orders."""
    D = tab.shape[1]
    idx = idx.reshape(-1)
    upd = upd.reshape(idx.shape[0], D)
    V = tab.shape[0]
    if V > _DENSE_TABLE_MAX_V or idx.shape[0] * V > _DENSE_TABLE_MAX_ELEMS:
        return _add_rows(tab, idx, upd)
    oh = (idx[:, None] == torch.arange(V, device=idx.device)[None, :]
          ).to(tab.dtype)
    return tab.add_(_f32_mm(oh.t(), upd))


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    # word2vec clips activations to +-MAX_EXP=6 via its exp table
    return torch.sigmoid(torch.clamp(x, -6.0, 6.0))


def _dots(v: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``einsum("bd,bkd->bk")``."""
    return torch.bmm(rows, v[:, :, None])[..., 0]


def _mix(g: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``einsum("bk,bkd->bd")``."""
    return torch.bmm(g[:, None, :], rows)[:, 0]


def _outer(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return g[..., None] * v[:, None, :]


def skipgram_step(syn0, syn1, syn1neg, ctx, points, codes, code_mask,
                  neg, neg_label, neg_mask, alpha):
    """One batch of skip-gram pair updates (``AggregateSkipGram``,
    SkipGram.java:271-283).

    ctx:(B,) input-word rows of syn0 to update; points/codes/code_mask:
    (B,C) HS targets from the *center* word's Huffman path; neg:(B,K+1)
    rows of syn1neg (col 0 = center word, label 1; the rest sampled
    negatives, label 0)."""
    v = syn0[ctx]
    p = syn1[points]
    f = _sigmoid(_dots(v, p))
    g = (1.0 - codes - f) * alpha * code_mask
    neu1e = torch.zeros_like(v) + _mix(g, p)
    _table_add(syn1, points, _outer(g, v))
    n = syn1neg[neg]
    fn = _sigmoid(_dots(v, n))
    gn = (neg_label - fn) * alpha * neg_mask
    neu1e = neu1e + _mix(gn, n)
    _table_add(syn1neg, neg, _outer(gn, v))
    _table_add(syn0, ctx, neu1e)
    return syn0, syn1, syn1neg


def _block_negatives(table, centers, key, K: int, dtype):
    """The negatives of an S-step block in one batched draw: step s draws
    ``randint(split(key, S)[s], (B, K), 0, len(table))``.  Returns
    ``(neg [S, B, K+1], neg_label [B, K+1], sample_mask [S, B, K+1])``;
    the rows' validity is applied by the caller."""
    S, B = centers.shape
    keys = _random.split(key, S)
    samples = table.long()[_random.randint(keys, (B, K), 0, table.shape[0])]
    neg = torch.cat([centers[..., None], samples], dim=2)
    neg_label = torch.cat([
        torch.ones((B, 1), dtype=dtype, device=centers.device),
        torch.zeros((B, K), dtype=dtype, device=centers.device)], dim=1)
    keep = torch.cat([
        torch.ones((S, B, 1), dtype=dtype, device=centers.device),
        (samples != centers[..., None]).to(dtype)], dim=2)
    return neg, neg_label, keep


def _row_valid(n_valids, B: int, dtype):
    """``[S, B]``: 1 for rows below each step's n_valid."""
    return (torch.arange(B, device=n_valids.device)[None, :]
            < n_valids[:, None]).to(dtype)


def _active(S: int, active) -> int:
    return S if active is None else min(int(active), S)


def skipgram_steps_ns(syn0, syn1neg, table, ctxs, centers, n_valids, key,
                      alphas, K: int, active=None):
    """S sequential NS skip-gram step-batches in one call.

    ctxs/centers: (S, B) int; n_valids/alphas: (S,).  Negatives are drawn
    on the device from the unigram table; a sample equal to the target is
    masked (equal in expectation to the C original's redraw).  Padded rows
    (index >= n_valid) add zeros."""
    S, B = ctxs.shape
    dt = syn0.dtype
    ctxs, centers = ctxs.long(), centers.long()
    neg, neg_label, keep = _block_negatives(table, centers, key, K, dt)
    rv = _row_valid(n_valids, B, dt)
    neg_mask = keep * rv[..., None]
    alphas = alphas.to(dt)
    for s in range(_active(S, active)):
        v = syn0[ctxs[s]]
        nvecs = syn1neg[neg[s]]
        fn = _sigmoid(_dots(v, nvecs))
        gn = (neg_label - fn) * alphas[s] * neg_mask[s]
        neu1e = _mix(gn, nvecs)
        _table_add(syn1neg, neg[s], _outer(gn, v))
        _table_add(syn0, ctxs[s], neu1e * rv[s][:, None])
    return syn0, syn1neg


def cbow_step(syn0, syn1, syn1neg, ctx, ctx_mask, points, codes, code_mask,
              neg, neg_label, neg_mask, alpha):
    """One batch of CBOW window updates (``CBOW.java`` / ``AggregateCBOW``).

    ctx:(B,W) window-word rows (mask-padded); the averaged context vector
    trains against the center word's HS path / negative samples, and the
    full error vector is added to every context row (the word2vec
    convention: not divided by the window size).  ParagraphVectors-DM
    reuses this with the document label in one window slot."""
    v_ctx = syn0[ctx]
    denom = torch.clamp(ctx_mask.sum(-1, keepdim=True), min=1.0)
    v = (v_ctx * ctx_mask[..., None]).sum(1) / denom
    p = syn1[points]
    f = _sigmoid(_dots(v, p))
    g = (1.0 - codes - f) * alpha * code_mask
    neu1e = torch.zeros_like(v) + _mix(g, p)
    _table_add(syn1, points, _outer(g, v))
    n = syn1neg[neg]
    fn = _sigmoid(_dots(v, n))
    gn = (neg_label - fn) * alpha * neg_mask
    neu1e = neu1e + _mix(gn, n)
    _table_add(syn1neg, neg, _outer(gn, v))
    _table_add(syn0, ctx, neu1e[:, None, :] * ctx_mask[..., None])
    return syn0, syn1, syn1neg


def infer_step(vec, syn1, syn1neg, points, codes, code_mask,
               neg, neg_label, neg_mask, alpha):
    """ParagraphVectors ``inferVector``: update ONLY the inference vector
    against frozen output weights (``SkipGram.iterateSample``'s
    ``isInference`` branch, SkipGram.java:224).  Returns a new vector."""
    B = points.shape[0]
    v = vec.expand(B, vec.shape[-1])
    p = syn1[points]
    f = _sigmoid(_dots(v, p))
    g = (1.0 - codes - f) * alpha * code_mask
    neu1e = _mix(g, p)
    n = syn1neg[neg]
    fn = _sigmoid(_dots(v, n))
    gn = (neg_label - fn) * alpha * neg_mask
    neu1e = neu1e + _mix(gn, n)
    return vec + neu1e.sum(0)


def glove_step(w, w_ctx, b, b_ctx, hw, hwc, hb, hbc, rows, cols, xij,
               alpha, x_max, exponent):
    """One AdaGrad batch on the GloVe weighted least-squares objective
    (``learning/impl/elements/GloVe.java`` iterateSample), in place.

    hw/hwc/hb/hbc are per-table AdaGrad accumulators; rows/cols index the
    main / context tables, xij (f32) holds the cooccurrence counts.  The
    squared gradients are added to the accumulators FIRST and read back
    at the same rows, so a row repeated in the batch sees the summed
    history, as in the JAX package.  ``log(xij)`` and the weight
    ``(xij / x_max) ** exponent`` are f32, as the JAX package computes
    them whatever the tables' dtype; ``alpha``, ``x_max`` and
    ``exponent`` are f32 values.  Returns the tables and the batch's
    loss."""
    dt = w.dtype
    wi, wj = w[rows], w_ctx[cols]
    diff = ((wi * wj).sum(-1) + b[rows] + b_ctx[cols]
            - torch.log(xij).to(dt))
    weight = ((xij / x_max) ** exponent).to(dt)
    fdiff = torch.where(xij > x_max, diff, weight * diff)
    gi = fdiff[:, None] * wj
    gj = fdiff[:, None] * wi
    _add_rows(hw, rows, gi * gi)
    _add_rows(hwc, cols, gj * gj)
    _add_rows(hb, rows, fdiff * fdiff)
    _add_rows(hbc, cols, fdiff * fdiff)
    _add_rows(w, rows, -alpha * gi / torch.sqrt(hw[rows] + 1e-8))
    _add_rows(w_ctx, cols, -alpha * gj / torch.sqrt(hwc[cols] + 1e-8))
    _add_rows(b, rows, -alpha * fdiff / torch.sqrt(hb[rows] + 1e-8))
    _add_rows(b_ctx, cols, -alpha * fdiff / torch.sqrt(hbc[cols] + 1e-8))
    loss = 0.5 * torch.sum(fdiff * diff)
    return w, w_ctx, b, b_ctx, hw, hwc, hb, hbc, loss


def glove_epoch(w, w_ctx, b, b_ctx, hw, hwc, hb, hbc, rows_b, cols_b, xij_b,
                alpha, x_max, exponent):
    """``glove_step`` over pre-batched (nb, B) cooccurrence index arrays,
    in order.  Returns the tables and the per-batch losses [nb]."""
    carry = (w, w_ctx, b, b_ctx, hw, hwc, hb, hbc)
    losses = []
    for i in range(rows_b.shape[0]):
        out = glove_step(*carry, rows_b[i], cols_b[i], xij_b[i], alpha,
                         x_max, exponent)
        carry, loss = out[:8], out[8]
        losses.append(loss)
    return carry + (torch.stack(losses),)


def _hs_labels(pts, cds, msk, center, rv, dtype):
    points = pts[center]
    codes = cds[center].to(dtype)
    cmask = msk[center].to(dtype) * rv[:, None]
    return points, codes, cmask


def skipgram_steps_hs(syn0, syn1, pts, cds, msk, ctxs, centers, n_valids,
                      alphas, active=None):
    """S sequential HS skip-gram step-batches in one call.

    The Huffman tables live on the device (pts/cds/msk: [V, C] from
    ``build_hs_tables``) and each step gathers its labels by center index:
    no host-side label packing.  Padded rows (>= n_valid) carry zero masks
    and add zeros."""
    _, B = ctxs.shape
    dt = syn0.dtype
    ctxs, centers = ctxs.long(), centers.long()
    rv_all = _row_valid(n_valids, B, dt)
    alphas = alphas.to(dt)
    for s in range(_active(ctxs.shape[0], active)):
        rv = rv_all[s]
        points, codes, cmask = _hs_labels(pts, cds, msk, centers[s], rv, dt)
        v = syn0[ctxs[s]]
        p = syn1[points]
        f = _sigmoid(_dots(v, p))
        g = (1.0 - codes - f) * alphas[s] * cmask
        neu1e = _mix(g, p)
        _table_add(syn1, points, _outer(g, v))
        _table_add(syn0, ctxs[s], neu1e * rv[:, None])
    return syn0, syn1


def _window_mean(syn0, ctx, cm):
    v_ctx = syn0[ctx]
    denom = torch.clamp(cm.sum(-1, keepdim=True), min=1.0)
    return (v_ctx * cm[..., None]).sum(1) / denom


def cbow_steps_ns(syn0, syn1neg, table, ctxw, cmask, centers, n_valids, key,
                  alphas, K: int, active=None):
    """S sequential NS CBOW step-batches in one call (``AggregateCBOW``).

    ctxw/cmask: (S, B, W2) window-word rows + validity; centers: (S, B).
    The averaged window vector trains against the center and its
    negatives, and the full error vector is added to every valid context
    row (the word2vec convention)."""
    S, B, _ = ctxw.shape
    dt = syn0.dtype
    ctxw, centers = ctxw.long(), centers.long()
    neg, neg_label, keep = _block_negatives(table, centers, key, K, dt)
    rv = _row_valid(n_valids, B, dt)
    neg_mask = keep * rv[..., None]
    cms = cmask.to(dt) * rv[..., None]
    alphas = alphas.to(dt)
    for s in range(_active(S, active)):
        cm = cms[s]
        v = _window_mean(syn0, ctxw[s], cm)
        n = syn1neg[neg[s]]
        fn = _sigmoid(_dots(v, n))
        gn = (neg_label - fn) * alphas[s] * neg_mask[s]
        neu1e = _mix(gn, n)
        _table_add(syn1neg, neg[s], _outer(gn, v))
        _table_add(syn0, ctxw[s], neu1e[:, None, :] * cm[..., None])
    return syn0, syn1neg


def cbow_steps_hs(syn0, syn1, pts, cds, msk, ctxw, cmask, centers, n_valids,
                  alphas, active=None):
    """S sequential HS CBOW step-batches in one call; the Huffman tables
    on the device, labels gathered by center index."""
    S, B, _ = ctxw.shape
    dt = syn0.dtype
    ctxw, centers = ctxw.long(), centers.long()
    rv_all = _row_valid(n_valids, B, dt)
    cms = cmask.to(dt) * rv_all[..., None]
    alphas = alphas.to(dt)
    for s in range(_active(S, active)):
        cm = cms[s]
        v = _window_mean(syn0, ctxw[s], cm)
        points, codes, code_mask = _hs_labels(pts, cds, msk, centers[s],
                                              rv_all[s], dt)
        p = syn1[points]
        f = _sigmoid(_dots(v, p))
        g = (1.0 - codes - f) * alphas[s] * code_mask
        neu1e = _mix(g, p)
        _table_add(syn1, points, _outer(g, v))
        _table_add(syn0, ctxw[s], neu1e[:, None, :] * cm[..., None])
    return syn0, syn1
