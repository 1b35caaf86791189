"""SequenceVectors: the generic embedding-training engine (port of
``nlp/sequence_vectors.py``).

Reference ``models/sequencevectors/SequenceVectors.java:49``: a producer
thread feeding ``VectorCalculationsThread`` workers that batch ~4096 native
aggregate ops.  Here the host turns token sequences into padded index
batches (numpy) and the step functions of ``elements.py`` replace the
worker pool: the device's parallelism comes from the batch dimension, not
threads, and the updates are deterministic rather than hogwild.  The host
emission, its three numpy streams (``seed``, ``seed + 1``, ``seed + 2``),
the block sizes, chunking, padded tail and per-row learning-rate decay are
the JAX package's, so both packages train the same rows in the same order.
Only index arrays cross to the device per block, from pinned memory,
without blocking the host.

Learning algorithms are selected by name, mirroring the reference's pluggable
``ElementsLearningAlgorithm`` (skipgram/cbow) and ``SequenceLearningAlgorithm``
(dbow/dm) split.
"""
from __future__ import annotations

from collections import deque
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..utils import _random
from ..utils.device import resolve_device
from .elements import (cbow_step, cbow_steps_hs, cbow_steps_ns,
                       skipgram_step, skipgram_steps_hs, skipgram_steps_ns)
from .lookup_table import InMemoryLookupTable
from .vocab import VocabCache, VocabConstructor, subsample_keep_prob
from .word_vectors import WordVectors


def _active_steps(n_valids: np.ndarray) -> int:
    """Leading steps of a block that hold rows (the packers fill steps in
    order, so the empty ones trail)."""
    nz = np.flatnonzero(n_valids)
    return int(nz[-1]) + 1 if nz.size else 0


def _to_device(arr, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``: pinned and copied without blocking on a
    card (the caching host allocator keeps the pinned block until the
    copy is done)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


class _PairBatcher:
    """Accumulates (ctx, center) training pairs into fixed-shape batches.

    Pairs arrive as whole numpy arrays (``add_many`` — one call per sequence,
    not one per pair): the reference reaches throughput by batching the hot
    loop into native ``AggregateSkipGram`` ops, and the host-side equivalent
    is keeping pair generation vectorized end to end."""

    def __init__(self, batch_size: int, code_len: int, negative: int,
                 use_hs: bool):
        self.B, self.C, self.K = batch_size, code_len, negative
        self.use_hs = use_hs
        # deque of chunks + read offset into the head chunk: _take hands out
        # B-sized slices without re-concatenating the tail (a per-call full
        # copy would make the S drains per dispatch quadratic in scan steps)
        self._ctx: deque = deque()
        self._cen: deque = deque()
        self._seen: deque = deque()
        self._off = 0
        self.count = 0

    def add(self, ctx: int, center: int, seen: int = 0) -> bool:
        return self.add_many(np.array([ctx], dtype=np.int64),
                             np.array([center], dtype=np.int64), seen)

    def add_many(self, ctx, center, seen: int = 0) -> bool:
        """Buffer a whole sequence's pairs.  ``seen`` (words consumed when
        these pairs were emitted) rides along so the learning-rate decay is
        applied at the pair's corpus position, not at dispatch time — with
        multi-step dispatch the two can be far apart."""
        ctx = np.asarray(ctx, dtype=np.int64)
        if ctx.size:
            self._ctx.append(ctx)
            self._cen.append(np.asarray(center, dtype=np.int64))
            self._seen.append(np.full(ctx.size, seen, dtype=np.int64))
            self.count += ctx.size
        return self.count >= self.B

    def _take(self, force: bool):
        if self.count == 0 or (self.count < self.B and not force):
            return None
        ctx = np.zeros(self.B, dtype=np.int32)
        center = np.zeros(self.B, dtype=np.int32)
        seen_sum, taken = 0.0, 0
        while self._ctx and taken < self.B:
            head = self._ctx[0]
            take = min(self.B - taken, head.size - self._off)
            sl = slice(self._off, self._off + take)
            ctx[taken:taken + take] = head[sl]
            center[taken:taken + take] = self._cen[0][sl]
            seen_sum += float(self._seen[0][sl].sum())
            taken += take
            self._off += take
            if self._off >= head.size:
                self._ctx.popleft()
                self._cen.popleft()
                self._seen.popleft()
                self._off = 0
        self.count -= taken
        return ctx, center, taken, seen_sum / max(taken, 1)

    def drain(self, vocab_words, table, rng, force=False, hs_tables=None):
        taken = self._take(force)
        if taken is None:
            return None
        ctx, center, n, seen_mean = taken
        batch = _label_arrays(center, n, self.B, self.C, self.K,
                              vocab_words, table, rng, use_hs=self.use_hs,
                              hs_tables=hs_tables)
        return (ctx,) + batch + (seen_mean,)

    def drain_pairs(self, force=False):
        """(ctx, center, n, seen_mean) — for the device-sampling fast path."""
        return self._take(force)


def _window_matrix(rng, W: int, N: int, sent_id=None):
    """Per-position context-window matrix over N token positions with the
    C original's window shrink (half-width w = W - b, b ~ U[0, W);
    ``SkipGram.skipGram``, SkipGram.java:200-221).  Returns
    (positions [N, 2W] clipped in-range, valid [N, 2W]).  ``sent_id``:
    optional [N] array; windows never cross a sentence boundary."""
    w = W - rng.integers(0, W, size=N)                   # (N,) in [1, W]
    offs = np.concatenate([np.arange(-W, 0), np.arange(1, W + 1)])
    pos = np.arange(N)[:, None] + offs[None, :]
    posc = np.clip(pos, 0, N - 1)
    valid = (np.abs(offs)[None, :] <= w[:, None]) & (pos >= 0) & (pos < N)
    if sent_id is not None:
        valid &= sent_id[posc] == sent_id[:, None]
    return posc, valid


def _window_pairs(rng, W: int, N: int, sent_id=None):
    """Flattened (context_positions, center_positions) pairs from
    :func:`_window_matrix` — the skip-gram emission."""
    posc, valid = _window_matrix(rng, W, N, sent_id)
    cen_rows = np.broadcast_to(np.arange(N)[:, None], valid.shape)
    return posc[valid], cen_rows[valid]


def build_hs_tables(vocab_words, C):
    """Vocab-level padded Huffman tables [V, C'] (points/codes/mask): one
    fancy-index per batch replaces the per-row HS lookup loop.  Built once
    per fit by the caller (no global cache — vocab lists are rebuilt and
    Huffman codes mutated across fits, so identity-keyed caching is unsafe).
    Width is capped to the actual max code length and codes/mask are uint8:
    HS is the big-vocab objective, so these tables are sized with care
    (V=1M, C'=25: ~100MB points + ~50MB codes/mask)."""
    V = len(vocab_words)
    C = min(C, max((len(vw.codes) for vw in vocab_words), default=1))
    C = max(C, 1)
    pts = np.zeros((V, C), dtype=np.int32)
    cds = np.zeros((V, C), dtype=np.uint8)
    msk = np.zeros((V, C), dtype=np.uint8)
    for i, vw in enumerate(vocab_words):
        L = min(len(vw.codes), C)
        if L:
            pts[i, :L] = vw.points[:L]
            cds[i, :L] = vw.codes[:L]
            msk[i, :L] = 1
    return pts, cds, msk


def _label_arrays(center, n, B, C, K, vocab_words, table, rng, use_hs=True,
                  hs_tables=None):
    """HS codes/points + negative samples for each batch row's center word.

    Masks gate the two objectives independently, matching the reference's
    ``isUseHierarchicSoftmax`` / ``negative > 0`` branches
    (SkipGram.java:236-257): HS disabled → code_mask stays zero; negative
    sampling disabled → neg_mask stays zero (including the positive column).
    ``hs_tables``: precomputed ``build_hs_tables`` output; built on the fly
    when absent.
    """
    points = np.zeros((B, C), dtype=np.int32)
    codes = np.zeros((B, C), dtype=np.float32)
    code_mask = np.zeros((B, C), dtype=np.float32)
    if use_hs:
        pts_t, cds_t, msk_t = hs_tables if hs_tables is not None \
            else build_hs_tables(vocab_words, C)
        idx = center[:n]
        Ct = min(pts_t.shape[1], C)   # tables are capped to real code length
        points[:n, :Ct] = pts_t[idx, :Ct]
        codes[:n, :Ct] = cds_t[idx, :Ct]
        code_mask[:n, :Ct] = msk_t[idx, :Ct]
    neg = np.zeros((B, K + 1), dtype=np.int32)
    neg_label = np.zeros((B, K + 1), dtype=np.float32)
    neg_mask = np.zeros((B, K + 1), dtype=np.float32)
    neg[:, 0] = center
    neg_label[:, 0] = 1.0
    if K > 0 and table is not None and len(table):
        neg_mask[:n, 0] = 1.0
        samples = table[rng.integers(0, len(table), size=(B, K))]
        neg[:, 1:] = samples
        # resample-avoidance: the C code redraws when the sample hits the
        # target; masking is equivalent under expectation
        neg_mask[:n, 1:] = (samples[:n] != center[:n, None]).astype(np.float32)
    return center, points, codes, code_mask, neg, neg_label, neg_mask


class SequenceVectors(WordVectors):
    """Trainer for element embeddings over token sequences."""

    def __init__(self, layer_size: int = 100, window: int = 5,
                 learning_rate: float = 0.025, min_learning_rate: float = 1e-4,
                 negative: int = 5, use_hierarchic_softmax: bool = False,
                 sampling: float = 0.0, min_word_frequency: int = 1,
                 epochs: int = 1, batch_size: int = 512, seed: int = 123,
                 elements_algorithm: str = "skipgram",
                 max_code_length: int = 40, scan_steps: int = 16,
                 device="cuda"):
        self.layer_size = layer_size
        self.window = window
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.negative = negative
        self.use_hs = use_hierarchic_softmax or negative == 0
        self.sampling = sampling
        self.min_word_frequency = min_word_frequency
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.elements_algorithm = elements_algorithm
        self.max_code_length = max_code_length
        # step-batches per call of the S-step functions on the NS fast path
        self.scan_steps = max(1, scan_steps)
        self.device = resolve_device(device)
        self.vocab: Optional[VocabCache] = None
        self.lookup_table: Optional[InMemoryLookupTable] = None

    # -- corpus hooks (overridden by Word2Vec / ParagraphVectors) ------------
    def _sequences(self) -> Iterable[Sequence[str]]:
        raise NotImplementedError

    def _sequence_labels(self, seq_index: int) -> Sequence[str]:
        return ()

    # -- bulk-path label hooks (ParagraphVectors overrides) ------------------
    def _bulk_label_width(self) -> Optional[int]:
        """Max labels per sequence, known up front — required by the bulk
        path because the packed device blocks need a corpus-constant label
        width.  ``None`` = the subclass can't declare it; labeled fits fall
        back to the per-sentence loop."""
        return None

    def _label_indices(self, seq_index: int) -> np.ndarray:
        """Vocab indices of a sequence's labels (int64, possibly empty)."""
        return np.zeros(0, dtype=np.int64)

    def _raw_sentences(self):
        """Raw sentence strings when tokenization is exactly ``str.split``
        (enables the native corpus indexer); None otherwise."""
        return None

    def _try_native_index(self, index_map):
        """Per-sentence int32 index arrays via the C++ corpus indexer
        (``native_src.cpp dl4j_index_corpus`` — the DataVec/libnd4j
        data-loader role), or None to use the Python path.  Tokenization
        semantics are identical by construction (str.split only; Unicode
        whitespace bails out) — the bulk-emission equivalence oracle pins
        this.  ``index_map``: the caller's vocab map (O(V) to rebuild)."""
        raw = self._raw_sentences()
        if raw is None:
            return None
        from ..utils import native
        return native.index_corpus(raw, index_map)

    # -- vocab + weights -----------------------------------------------------
    def build_vocab(self, extra_labels: Sequence[str] = ()) -> None:
        ctor = VocabConstructor(self.min_word_frequency)
        self.vocab = ctor.build(self._sequences(), special_labels=extra_labels)
        self.lookup_table = InMemoryLookupTable(
            self.vocab, self.layer_size, seed=self.seed,
            use_hs=self.use_hs, negative=self.negative, device=self.device)
        self.lookup_table.reset_weights()

    # -- training ------------------------------------------------------------
    # bulk-path sizing, the JAX package's: ~2^17 pairs per block
    _BULK_PAIRS_PER_DISPATCH = 1 << 17
    _BULK_CHUNK_WORDS = 1 << 18          # corpus words per vectorized emission
    _BULK_CACHE_LIMIT = 50_000_000       # max words of indexed-corpus cache

    def _ns_eligible(self) -> bool:
        """Algorithm-agnostic NS fast-path condition: negative sampling
        enabled with a device-resident unigram table (and no HS objective).
        One rule for the in-batcher and bulk gates."""
        lt = self.lookup_table
        return (not self.use_hs and self.negative > 0
                and lt.table is not None and len(lt.table) > 0)

    def _ns_fast_eligible(self) -> bool:
        """The in-batcher device-sampling fast path: skip-gram only."""
        return self.elements_algorithm == "skipgram" and self._ns_eligible()

    def _hs_tables(self):
        """(code_len, (pts, cds, msk)) with the max_code_length clamp, for
        both the generic and bulk HS paths."""
        vocab_words = self.vocab.vocab_words()
        code_len = max((vw.code_length for vw in vocab_words), default=1)
        code_len = min(max(code_len, 1), self.max_code_length)
        return code_len, build_hs_tables(vocab_words, code_len)

    def _rows_per_step(self) -> int:
        """Batched rows update from stale weights (the reference's
        sequential hogwild never sees this): with a small vocabulary a big
        batch packs many duplicates of the same word whose correlated
        updates sum and can diverge.  Cap rows-per-step by vocab size and
        spend the budget on extra steps instead (steps read fresh
        weights)."""
        n_words = max(self.vocab.num_words(), 1)
        return int(min(self.batch_size, max(64, 4 * n_words)))

    def fit(self) -> None:
        if self.vocab is None:
            self.build_vocab()
        has_labels = (type(self)._sequence_labels
                      is not SequenceVectors._sequence_labels)
        lt = self.lookup_table
        if self.elements_algorithm in ("skipgram", "cbow"):
            # labeled corpora (ParagraphVectors DBOW/DM) ride the bulk path
            # too when the subclass can declare its label width up front —
            # DBOW is skip-gram with label→word pairs added, DM is CBOW with
            # label columns appended to the window
            lab_w = 0 if not has_labels else self._bulk_label_width()
            if lab_w is not None:
                bulk = (self._fit_bulk_sg
                        if self.elements_algorithm == "skipgram"
                        else self._fit_bulk_cbow)
                if self._ns_eligible():
                    return bulk("ns", label_width=lab_w)
                if self.use_hs and self.negative == 0:
                    return bulk("hs", label_width=lab_w)
        # three independent streams, partitioned exactly like the bulk path
        # (window draws: seed; subsampling: seed+1) so the two emissions are
        # stream-aligned and checkable against each other, plus seed+2 for
        # host-side negative sampling, which the bulk path does on device
        rng = np.random.default_rng(self.seed)
        rng_sub = np.random.default_rng(self.seed + 1)
        rng_neg = np.random.default_rng(self.seed + 2)
        vocab_words = self.vocab.vocab_words()
        keep = subsample_keep_prob(self.vocab, self.sampling)
        code_len, _hs = self._hs_tables() if self.use_hs else (
            min(max(max((vw.code_length for vw in vocab_words), default=1),
                    1), self.max_code_length), None)
        total = max(self.vocab.total_word_count * self.epochs, 1)
        seen = 0
        dev = self.device
        syn0, syn1, syn1neg = lt.syn0, lt.syn1, lt.syn1neg
        if syn1 is None:
            syn1 = torch.zeros_like(syn0)
        if syn1neg is None:
            syn1neg = torch.zeros_like(syn0)
        b_eff = self._rows_per_step()     # stale-duplicate cap (see helper)
        scan_eff = self.scan_steps
        if b_eff < self.batch_size:
            scan_eff = min(512, -(-self.scan_steps * self.batch_size // b_eff))
        batcher = _PairBatcher(b_eff, code_len, self.negative,
                               self.use_hs)
        is_skipgram = self.elements_algorithm == "skipgram"
        # device-sampling fast path: NS-only skip-gram ships just the int32
        # pair indices per step; negatives come from the device's table
        fast_ns = self._ns_fast_eligible()
        hs_tables = _hs
        key = _random.prng_key(self.seed, dev) if fast_ns else None
        if fast_ns:
            table_dev = _to_device(np.asarray(lt.table, dtype=np.int32), dev)

        def f32(x) -> float:
            return float(np.float32(x))

        def decay(seen_at: float) -> float:
            """LR at a given corpus position (word2vec linear decay)."""
            return max(self.min_learning_rate,
                       self.learning_rate * (1.0 - seen_at / total))

        def flush(force=False):
            nonlocal syn0, syn1, syn1neg, key
            while True:
                if fast_ns:
                    S, B = scan_eff, b_eff
                    if batcher.count == 0 or (
                            batcher.count < S * B and not force):
                        return
                    ctxs = np.zeros((S, B), dtype=np.int32)
                    cens = np.zeros((S, B), dtype=np.int32)
                    n_valids = np.zeros(S, dtype=np.int32)
                    alphas = np.zeros(S, dtype=np.float32)
                    for s in range(S):
                        b = batcher.drain_pairs(force=force)
                        if b is None:
                            break
                        ctxs[s], cens[s], n_valids[s], seen_mean = b
                        alphas[s] = decay(seen_mean)
                    if not n_valids.any():
                        return
                    key, sub = _random.split(key)
                    syn0, syn1neg = skipgram_steps_ns(
                        syn0, syn1neg, table_dev, _to_device(ctxs, dev),
                        _to_device(cens, dev), _to_device(n_valids, dev), sub,
                        _to_device(alphas, dev), self.negative,
                        active=_active_steps(n_valids))
                elif is_skipgram:
                    b = batcher.drain(vocab_words, lt.table, rng_neg,
                                      force=force, hs_tables=hs_tables)
                    if b is None:
                        return
                    ctx, _center, pts, cds, cm, neg, nl, nm, seen_mean = b
                    syn0, syn1, syn1neg = skipgram_step(
                        syn0, syn1, syn1neg,
                        *(_to_device(a, dev).long() for a in (ctx, pts)),
                        *(_to_device(a, dev) for a in (cds, cm)),
                        _to_device(neg, dev).long(),
                        *(_to_device(a, dev) for a in (nl, nm)),
                        f32(decay(seen_mean)))
                else:
                    b = self._drain_cbow(vocab_words, lt.table, rng_neg,
                                         force, hs_tables=hs_tables)
                    if b is None:
                        return
                    ctxw, cmask, _center, pts, cds, cm, neg, nl, nm = b
                    syn0, syn1, syn1neg = cbow_step(
                        syn0, syn1, syn1neg, _to_device(ctxw, dev).long(),
                        _to_device(cmask, dev),
                        _to_device(pts, dev).long(),
                        *(_to_device(a, dev) for a in (cds, cm)),
                        _to_device(neg, dev).long(),
                        *(_to_device(a, dev) for a in (nl, nm)),
                        f32(decay(seen)))
                if force and self._pending_empty(batcher):
                    return

        self._cbow_buf: List = []
        self._cbow_wmax = None   # recomputed per fit (labels may change)
        for _epoch in range(self.epochs):
            for seq_idx, seq in enumerate(self._sequences()):
                idxs = [self.vocab.index_of(t) for t in seq]
                idxs = np.array([i for i in idxs if i >= 0], dtype=np.int64)
                if idxs.size == 0:
                    continue
                seen += int(idxs.size)
                if self.sampling > 0:
                    idxs = idxs[rng_sub.random(idxs.size) < keep[idxs]]
                label_idxs = [self.vocab.index_of(l)
                              for l in self._sequence_labels(seq_idx)]
                label_idxs = [l for l in label_idxs if l >= 0]
                # unlabeled 1-token sequences can't emit pairs — skip before
                # any window draw so the stream stays aligned with the bulk
                # path (which skips them pre-windowing)
                if idxs.size < (1 if label_idxs else 2):
                    continue
                self._emit_sequence(idxs, label_idxs, batcher, rng, seen)
                flush()
        flush(force=True)
        lt.syn0, lt.syn1, lt.syn1neg = syn0, syn1, syn1neg

    def _fit_bulk_sg(self, mode: str, label_width: int = 0) -> None:
        """Corpus-level vectorized skip-gram (the words/sec fast path);
        ``mode``: "ns" (device-side negative sampling) or "hs"
        (hierarchical softmax with device-resident Huffman tables).

        The reference reaches throughput by running the hot loop as native
        batched ``AggregateSkipGram`` ops fed by a producer thread
        (``SkipGram.java:271-283``, ``SequenceVectors.java:288-307``); the
        per-sentence host path here tops out near 80k words/sec because
        Python-level emission/packing runs once per sentence.  This path
        amortizes host work over the whole corpus instead:

        1. tokens are indexed once per epoch (cached across epochs for
           corpora under ``_BULK_CACHE_LIMIT`` words),
        2. window-pair emission runs as one numpy pass per ~2^18-word chunk
           (same semantics: per-center reduced window b ~ U[0, W),
           sentence-boundary clipping, subsampling before windowing),
        3. pairs ship to the device in ~2^17-pair blocks of S steps
           (``skipgram_steps_ns`` / ``skipgram_steps_hs``: negatives are
           sampled and Huffman labels gathered ON THE DEVICE), with the
           learning rate decayed at each pair's exact corpus position.

        DeepWalk/Node2Vec (degree-Huffman HS over random walks) ride the
        "hs" mode automatically.  With ``label_width`` > 0 (ParagraphVectors
        DBOW) each sequence additionally emits label→word pairs — the
        reference's PV-DBOW is exactly skip-gram with the doc label as the
        learning row (``DBOW.java`` delegating to SkipGram aggregates).
        """
        lt = self.lookup_table
        rng = np.random.default_rng(self.seed)
        W = self.window
        # honor the configured batch_size (same stale-duplicate cap as the
        # generic path) and spend the rest of the block's budget on steps:
        # steps read fresh weights, so more steps never hurt
        B = self._rows_per_step()
        S = max(self.scan_steps, self._BULK_PAIRS_PER_DISPATCH // B)
        state = self._bulk_device_state(mode)

        def emit_chunk(idxs, sent_id, positions, labs=None):
            """All window pairs of one corpus chunk in one numpy pass;
            ``labs`` [N, L] (−1-padded per-token label rows) adds the DBOW
            label→word pairs."""
            ctx_pos, rows = _window_pairs(rng, W, idxs.size, sent_id)
            pos_o = positions[rows]
            ctx_o = idxs[ctx_pos].astype(np.int32)
            cen_o = idxs[rows].astype(np.int32)
            if labs is not None and labs.size:
                pos_l, ctx_l, cen_l = [pos_o], [ctx_o], [cen_o]
                for j in range(labs.shape[1]):
                    v = labs[:, j] >= 0
                    if v.any():
                        pos_l.append(positions[v])
                        ctx_l.append(labs[v, j].astype(np.int32))
                        cen_l.append(idxs[v].astype(np.int32))
                pos_o = np.concatenate(pos_l)
                ctx_o = np.concatenate(ctx_l)
                cen_o = np.concatenate(cen_l)
            return pos_o, ctx_o, cen_o

        dev = self.device

        def run_block(fields, n_valids, alphas):
            active = _active_steps(n_valids)
            ctxs, cens, n_valids, alphas = (
                _to_device(a, dev) for a in (*fields, n_valids, alphas))
            if mode == "ns":
                state["key"], sub = _random.split(state["key"])
                state["syn0"], state["syn_out"] = skipgram_steps_ns(
                    state["syn0"], state["syn_out"], state["table"],
                    ctxs, cens, n_valids, sub, alphas, self.negative,
                    active=active)
            else:
                state["syn0"], state["syn_out"] = skipgram_steps_hs(
                    state["syn0"], state["syn_out"], *state["hs"],
                    ctxs, cens, n_valids, alphas, active=active)

        self._bulk_run(emit_chunk, run_block, S, B, label_width=label_width)
        self._bulk_store(mode, state)

    def _bulk_device_state(self, mode: str) -> dict:
        """Device-resident weights + sampling/label tables for a bulk run."""
        lt = self.lookup_table
        dev = self.device
        if mode == "ns":
            return {"syn0": lt.syn0, "syn_out": lt.syn1neg,
                    "table": _to_device(np.asarray(lt.table, dtype=np.int32),
                                        dev),
                    "key": _random.prng_key(self.seed, dev)}
        syn_out = lt.syn1 if lt.syn1 is not None else torch.zeros_like(lt.syn0)
        _, (pts, cds, msk) = self._hs_tables()
        return {"syn0": lt.syn0, "syn_out": syn_out,
                "hs": (_to_device(pts, dev).long(), _to_device(cds, dev),
                       _to_device(msk, dev))}

    def _bulk_store(self, mode: str, state: dict) -> None:
        lt = self.lookup_table
        lt.syn0 = state["syn0"]
        if mode == "ns":
            lt.syn1neg = state["syn_out"]
        else:
            lt.syn1 = state["syn_out"]

    def _fit_bulk_cbow(self, mode: str, label_width: int = 0) -> None:
        """Corpus-level vectorized CBOW (same machinery as skip-gram's bulk
        path; each row is a CENTER with its [2W] mask-padded window —
        ``_window_matrix`` emits whole chunks in one numpy pass, and the
        S-step functions (``cbow_steps_ns`` / ``cbow_steps_hs``) average, train
        against the center's negatives / Huffman path, and scatter the
        error to every valid window row).  With ``label_width`` > 0
        (ParagraphVectors DM) the doc-label columns join every window row —
        the reference's PV-DM: label participates in the context average
        and receives the scattered error like any context word."""
        rng = np.random.default_rng(self.seed)
        W = self.window
        B = self._rows_per_step()
        # a CBOW row does ~2W gathers + scatters, several times a skip-gram
        # pair: a smaller row budget per block
        S = max(self.scan_steps, (self._BULK_PAIRS_PER_DISPATCH // 4) // B)
        state = self._bulk_device_state(mode)

        def emit_chunk(idxs, sent_id, positions, labs=None):
            posc, valid = _window_matrix(rng, W, idxs.size, sent_id)
            ctxw = idxs[posc].astype(np.int32)
            cmask = valid.astype(np.uint8)
            if labs is not None and labs.size:
                ctxw = np.hstack([ctxw, np.maximum(labs, 0).astype(np.int32)])
                cmask = np.hstack([cmask, (labs >= 0).astype(np.uint8)])
            return positions, ctxw, cmask, idxs.astype(np.int32)

        dev = self.device

        def run_block(fields, n_valids, alphas):
            active = _active_steps(n_valids)
            ctxw, cmask, cens, n_valids, alphas = (
                _to_device(a, dev) for a in (*fields, n_valids, alphas))
            if mode == "ns":
                state["key"], sub = _random.split(state["key"])
                state["syn0"], state["syn_out"] = cbow_steps_ns(
                    state["syn0"], state["syn_out"], state["table"],
                    ctxw, cmask, cens, n_valids, sub, alphas, self.negative,
                    active=active)
            else:
                state["syn0"], state["syn_out"] = cbow_steps_hs(
                    state["syn0"], state["syn_out"], *state["hs"],
                    ctxw, cmask, cens, n_valids, alphas, active=active)

        self._bulk_run(emit_chunk, run_block, S, B, label_width=label_width)
        self._bulk_store(mode, state)

    def _bulk_run(self, emit_chunk, run_block, S: int, B: int,
                  label_width: int = 0) -> None:
        """Shared bulk-training scaffolding: epoch loop with indexed-corpus
        caching, chunked emission, and generic (S, B[, ...])-block packing.

        ``emit_chunk(idxs, sent_id, positions, labs) -> (pos, field, ...)``
        where every array shares leading dim P (one entry per emitted row)
        and ``labs`` is a −1-padded [N, label_width] per-token label matrix
        (None when label_width == 0);
        ``run_block(fields, n_valids, alphas)`` consumes each field packed
        to ``(S, B) + field.shape[1:]``.  The learning rate is decayed at
        each row's corpus position.  The forced tail spreads leftover rows
        across scan steps in small sequential slices — a corpus smaller
        than one dispatch must still train sequentially enough for syn0 to
        move (the output tables start at zero).
        """
        rng = np.random.default_rng(self.seed + 1)   # subsampling stream
        keep = subsample_keep_prob(self.vocab, self.sampling)
        total = max(self.vocab.total_word_count * self.epochs, 1)
        pend: List = []          # [(pos, field, ...)] chunks awaiting dispatch
        pend_n = 0

        def alphas_for(steps_pos):
            return np.maximum(
                self.min_learning_rate,
                self.learning_rate * (1.0 - steps_pos / total)
            ).astype(np.float32)

        def dispatch(force=False):
            nonlocal pend, pend_n
            per = S * B
            if pend_n < per and not (force and pend_n):
                return
            cols = [np.concatenate([p[i] for p in pend])
                    for i in range(len(pend[0]))]
            posn, fields = cols[0], cols[1:]
            m = len(posn) // per
            for i in range(m):
                sl = slice(i * per, (i + 1) * per)
                run_block(
                    [f[sl].reshape((S, B) + f.shape[1:]) for f in fields],
                    np.full(S, B, dtype=np.int32),
                    alphas_for(posn[sl].reshape(S, B).mean(axis=1)))
            rem = [c[m * per:] for c in cols]
            if force and rem[0].size:
                t = rem[0].size
                q = max(1, -(-t // S))           # rows per step, ≤ B
                packed = [np.zeros((S, B) + f.shape[1:], f.dtype)
                          for f in rem[1:]]
                n_valids = np.zeros(S, dtype=np.int32)
                steps_pos = np.full(S, float(rem[0][-1]))
                for s in range(-(-t // q)):
                    piece = slice(s * q, min((s + 1) * q, t))
                    k = piece.stop - piece.start
                    for dst, src in zip(packed, rem[1:]):
                        dst[s, :k] = src[piece]
                    n_valids[s] = k
                    steps_pos[s] = rem[0][piece].mean()
                run_block(packed, n_valids, alphas_for(steps_pos))
                rem = [c[:0] for c in cols]
            pend = [tuple(rem)] if rem[0].size else []
            pend_n = rem[0].size

        index_map = self.vocab.index_map()
        cache: Optional[List] = ([] if self.epochs > 1 else None)
        L = label_width
        seen = 0
        for epoch in range(self.epochs):
            if cache is not None and epoch > 0:
                source = cache
            else:
                native_arrs = self._try_native_index(index_map)
                if native_arrs is not None and L == 0:
                    lab0 = np.full(0, -1, dtype=np.int64)
                    # same empty-sentence skip as the Python path below
                    source = ((a, lab0) for a in native_arrs if a.size)
                elif native_arrs is not None:
                    # labeled corpora (ParagraphVectors): native-indexed
                    # tokens joined with per-sequence label rows; the
                    # original sequence index is kept through the
                    # empty-sentence skip so labels stay aligned
                    def _native_labeled():
                        for seq_idx, a in enumerate(native_arrs):
                            if not a.size:
                                continue
                            lab = np.full(L, -1, dtype=np.int64)
                            li = self._label_indices(seq_idx)[:L]
                            lab[:len(li)] = li
                            yield a, lab
                    source = _native_labeled()
                else:
                    def _index():
                        g = index_map.get
                        for seq_idx, seq in enumerate(self._sequences()):
                            arr = np.fromiter((g(t, -1) for t in seq),
                                              np.int32, count=len(seq))
                            arr = arr[arr >= 0]
                            if not arr.size:
                                continue
                            lab = np.full(L, -1, dtype=np.int64)
                            if L:
                                li = self._label_indices(seq_idx)[:L]
                                lab[:len(li)] = li
                            yield arr, lab
                    source = _index()
            # chunk buffers — per-sentence work is just appends; sentence-id
            # and label rows expand to per-token form ONCE per chunk via
            # np.repeat (a per-sentence np.tile here measurably bounds
            # ParagraphVectors throughput: 20k docs = 20k tiny allocations)
            buf_i: List = []
            buf_sid: List = []    # one sentence id per kept sequence
            buf_cnt: List = []    # kept-token count per kept sequence
            buf_p: List = []
            buf_l: List = []      # one [L] label row per kept sequence
            buf_n = 0
            sent_no = 0

            def flush_chunk():
                nonlocal buf_i, buf_sid, buf_cnt, buf_p, buf_l, buf_n, pend_n
                if not buf_i:
                    return
                cnt = np.asarray(buf_cnt, dtype=np.int64)
                out = emit_chunk(np.concatenate(buf_i),
                                 np.repeat(np.asarray(buf_sid, np.int32), cnt),
                                 np.concatenate(buf_p),
                                 np.repeat(np.stack(buf_l, axis=0), cnt,
                                           axis=0) if L else None)
                buf_i, buf_sid, buf_cnt, buf_p, buf_l, buf_n = \
                    [], [], [], [], [], 0
                if out[0].size:
                    pend.append(out)
                    pend_n += out[0].size
                dispatch()

            for idxs, labrow in source:
                if cache is not None and epoch == 0:
                    if seen + idxs.size <= self._BULK_CACHE_LIMIT:
                        cache.append((idxs, labrow))
                    else:
                        cache = None   # corpus too big — re-index per epoch
                positions = seen + np.arange(idxs.size)
                seen += int(idxs.size)
                if self.sampling > 0:
                    m = rng.random(idxs.size) < keep[idxs]
                    idxs, positions = idxs[m], positions[m]
                # a LABELED 1-token sequence still trains (label↔word);
                # unlabeled needs 2+ tokens for any window pair.  Gated per
                # sequence (not corpus-wide) so mixed corpora stay
                # stream-aligned with the generic loop's identical gate
                min_len = 1 if (L and (labrow >= 0).any()) else 2
                if idxs.size < min_len:
                    sent_no += 1
                    continue
                buf_i.append(idxs)
                buf_sid.append(sent_no)
                buf_cnt.append(idxs.size)
                buf_p.append(positions)
                if L:
                    buf_l.append(labrow)
                buf_n += idxs.size
                sent_no += 1
                if buf_n >= self._BULK_CHUNK_WORDS:
                    flush_chunk()
            flush_chunk()
        dispatch(force=True)

    def _pending_empty(self, batcher) -> bool:
        if self.elements_algorithm == "skipgram":
            return batcher.count == 0
        return not self._cbow_buf

    def _emit_sequence(self, idxs: np.ndarray, label_idxs: List[int],
                       batcher: _PairBatcher, rng, seen: int = 0) -> None:
        """Window-pair generation: skip-gram emits (context-row, center-label)
        pairs with a reduced window b ~ U[0, window) exactly like the C
        original (``SkipGram.skipGram``, SkipGram.java:200-221)."""
        W = self.window
        if self.elements_algorithm == "skipgram":
            # all pairs of the sequence in one numpy pass (shared with the
            # bulk path so the window semantics cannot drift)
            n = len(idxs)
            ctx_pos, rows = _window_pairs(rng, W, n)
            batcher.add_many(idxs[ctx_pos], idxs[rows], seen)
            if label_idxs:  # DBOW: label row learns to predict words
                labs = np.asarray(label_idxs, dtype=np.int64)
                batcher.add_many(np.tile(labs, n), np.repeat(idxs, labs.size),
                                 seen)
        else:  # cbow / dm
            for i in range(len(idxs)):
                b = int(rng.integers(0, W))
                ctx = [int(idxs[j]) for j in range(i - W + b, i + W - b + 1)
                       if j != i and 0 <= j < len(idxs)]
                ctx += label_idxs  # DM: label participates in the average
                if ctx:
                    self._cbow_buf.append((ctx, int(idxs[i])))

    def _drain_cbow(self, vocab_words, table, rng, force, hs_tables=None):
        B = self.batch_size
        if not self._cbow_buf or (len(self._cbow_buf) < B and not force):
            return None
        take = self._cbow_buf[:B]
        self._cbow_buf = self._cbow_buf[B:]
        n = len(take)
        # a fixed window width across batches, as the JAX package's (one
        # compiled shape there); overly long contexts are clipped.
        # label-aware headroom so DM rows with many labels are never clipped
        # differently from the bulk path (which carries all label columns).
        # cached per fit — _bulk_label_width can be O(corpus)
        Wmax = getattr(self, "_cbow_wmax", None)
        if Wmax is None:
            Wmax = 2 * self.window + max(4, self._bulk_label_width() or 0)
            self._cbow_wmax = Wmax
        ctxw = np.zeros((B, Wmax), dtype=np.int32)
        cmask = np.zeros((B, Wmax), dtype=np.float32)
        center = np.zeros(B, dtype=np.int32)
        for r, (c, t) in enumerate(take):
            c = c[:Wmax]
            ctxw[r, :len(c)] = c
            cmask[r, :len(c)] = 1.0
            center[r] = t
        if hs_tables is not None:
            code_len = hs_tables[0].shape[1]   # the tables fix the width
        else:
            code_len = max((vw.code_length for vw in vocab_words), default=1)
            code_len = min(max(code_len, 1), self.max_code_length)
        rest = _label_arrays(center, n, B, code_len, self.negative,
                             vocab_words, table, rng, use_hs=self.use_hs,
                             hs_tables=hs_tables)
        return (ctxw, cmask) + rest
