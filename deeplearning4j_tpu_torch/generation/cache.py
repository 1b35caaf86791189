"""Paged KV cache of the generation engine and its host-side allocator
(port of ``generation/cache.py``).

**PagedKV**: one preallocated block pool ``[n_blocks, heads, block_size,
head_dim]`` (f32, on the model's device) per attention-carried layer,
with per-slot **block tables** kept as host int32 numpy mirrors
``[max_slots, max_blocks_per_slot]`` that the programs receive as data,
copied to the device once per call.  Physical blocks are allocated
lazily as a sequence crosses each block boundary and released when the
slot vacates.  Physical block 0 is the **trash block**: never allocated;
free table entries point at it, so padded and inactive-lane writes land
in storage no mask ever reads.  RNN-style carries (no sequence axis)
keep dense per-slot rows.

**Prefix sharing**: full prompt blocks are content-chain-hashed
(position 0 onward, so equal hash means equal token prefix, and under
one weight version bit-equal K/V) into a read-only, refcounted registry.
An admission that matches registered blocks adopts them by reference
and prefills only its unshared suffix; a match ending inside a
partially filled registered block is adopted by **copy-on-write** (the
prefill program copies the block before the slot appends).  Registered
blocks no slot references stay resident and are evicted LRU-first under
pressure; a weight version change drops the whole registry.

Host side: a free-list allocator that always hands out the LOWEST free
slot and block (deterministic order) and an **occupancy trail**, a
bounded ring of install / vacate / migrate / block_alloc /
block_release / cow / shared_hit events.

A precision policy with ``kv_dtype="int8"`` makes the pools int8 codes
with f32 scales per token and head (``ksc``/``vsc`` ``[n_blocks, h,
block]``): quantized at the cache write, dequantized at the gather
(``nn/layers/attention._kv_quantize``), as in the reference.
"""
from __future__ import annotations

import hashlib
import heapq
import threading
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..nn.precision import kv_cache_dtype
from ..observability.clock import monotonic_s, wall_s
from ..utils.device import resolve_device
from .programs import _fresh_carry, carried_layers, paged_layout

__all__ = ["PagedKV"]


class _SlotAllocatorBase:
    """Lowest-free-slot allocator + occupancy trail for the paged
    cache."""

    def __init__(self, max_slots: int, trail_len: int = 256):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.max_slots = int(max_slots)
        self._lock = threading.Lock()
        self._free: List[int] = list(range(self.max_slots))
        heapq.heapify(self._free)
        self._occupants: Dict[int, Any] = {}
        self._peak_active = 0
        self._trail: deque = deque(maxlen=trail_len)

    # ------------------------------------------------------------ allocation
    def acquire(self, occupant: Any) -> Optional[int]:
        """Claim the lowest free slot for ``occupant``; None when full."""
        with self._lock:
            if not self._free:
                return None
            slot = heapq.heappop(self._free)
            self._occupants[slot] = occupant
            if len(self._occupants) > self._peak_active:
                self._peak_active = len(self._occupants)
            self._on_acquire_locked(slot)
        return slot

    def release(self, slot: int) -> None:
        with self._lock:
            if slot in self._occupants:
                self._on_release_locked(slot)
                del self._occupants[slot]
                heapq.heappush(self._free, slot)

    def _on_acquire_locked(self, slot: int) -> None:
        pass

    def _on_release_locked(self, slot: int) -> None:
        pass

    @property
    def free_slots(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def active_slots(self) -> int:
        with self._lock:
            return len(self._occupants)

    @property
    def peak_active(self) -> int:
        """High-water mark of simultaneously occupied slots — recorded
        at acquire time, so concurrency claims don't depend on an
        external poller catching the moment."""
        with self._lock:
            return self._peak_active

    def occupants(self) -> Dict[int, Any]:
        """Snapshot of {slot: occupant} (engine iterates per decode step)."""
        with self._lock:
            return dict(self._occupants)

    # -------------------------------------------------------- occupancy trail
    def note(self, event: str, slot: int, request_id: str,
             pos: Optional[int] = None, **fields: Any) -> None:
        """Append one install/vacate/migrate/block event to the trail."""
        rec = {"ts": wall_s(), "mono": round(monotonic_s(), 6),
               "event": event, "slot": int(slot), "request": request_id}
        if pos is not None:
            rec["pos"] = int(pos)
        rec.update(fields)
        with self._lock:
            self._trail.append(rec)

    def _note_locked(self, event: str, slot: int, request_id: str,
                     **fields: Any) -> None:
        rec = {"ts": wall_s(), "mono": round(monotonic_s(), 6),
               "event": event, "slot": int(slot), "request": request_id}
        rec.update(fields)
        self._trail.append(rec)

    def trail(self) -> List[dict]:
        with self._lock:
            return list(self._trail)

    def occupancy_snapshot(self) -> dict:
        """The forensics payload a decode-exception dump attaches: who
        holds which slot right now, plus the recent install/vacate trail
        (block alloc/release/COW/shared-hit events included for the
        paged cache)."""
        with self._lock:
            occupants = {str(s): (r.debug_id() if hasattr(r, "debug_id")
                                  else repr(r))
                         for s, r in self._occupants.items()}
            snap = {"max_slots": self.max_slots,
                    "active": len(self._occupants),
                    "free": len(self._free),
                    "occupants": occupants,
                    "trail": list(self._trail)}
            snap.update(self._snapshot_extra_locked())
            return snap

    def _snapshot_extra_locked(self) -> dict:
        return {}

    @property
    def cache_bytes(self) -> int:
        """Total device bytes held by the cache tensors."""
        return sum(t.numel() * t.element_size()
                   for c in self.caches.values() for t in c.values())


class PagedKV(_SlotAllocatorBase):
    """Paged block-pool KV cache: device pools + host block tables,
    lowest-free-block allocator, refcounted prefix-sharing registry.

    All block bookkeeping is HOST state (numpy mirrors + Python maps);
    the device sees a table update only as fresh data on the next program
    call.  Engine calls arrive under the step lock; the internal lock
    also guards status and forensics readers.
    """

    #: physical block 0 — reserved write target for padded/inactive
    #: lanes; never allocated, never read through a valid mask
    TRASH = 0

    def __init__(self, conf, max_slots: int, max_seq: int,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 prefix_sharing: bool = True, trail_len: int = 256,
                 device="cuda"):
        super().__init__(max_slots, trail_len)
        if max_seq < 2:
            raise ValueError(f"max_seq must be >= 2, got {max_seq}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.max_seq = int(max_seq)
        self.block_size = int(block_size)
        self.blocks_per_slot = -(-self.max_seq // self.block_size)
        self.virtual_seq = self.blocks_per_slot * self.block_size
        if n_blocks is None:
            # full provision: every slot can hold max_seq (+ trash) — the
            # safe default; benches/serving size it down to the expected
            # actual-length workload, which is where the memory win lives
            n_blocks = self.max_slots * self.blocks_per_slot + 1
        self.n_blocks = int(n_blocks)
        if self.n_blocks < self.blocks_per_slot + 1:
            raise ValueError(
                f"n_blocks={self.n_blocks} cannot hold even one full "
                f"sequence ({self.blocks_per_slot} blocks) plus the "
                "trash block")
        self.kv_dtype = kv_cache_dtype(conf.defaults)      # None | "int8"
        self.device = resolve_device(device)
        self.layout = paged_layout(conf)
        # recurrent state is not position-functional: a suffix-only
        # prefill cannot reconstruct it, so sharing requires a stack
        # whose carries are all KV- or position-style
        self.supports_sharing = all(k != "rnn" for k in
                                    self.layout.values())
        self.sharing = bool(prefix_sharing) and self.supports_sharing
        carried = carried_layers(conf)
        self.caches: Dict[str, Any] = {}
        nb, bs = self.n_blocks, self.block_size
        for name, kind in self.layout.items():
            lc = carried[name]
            if kind == "attn":
                probe = _fresh_carry(lc, 1, bs, torch.device("meta"))
                shape = (nb, probe["k"].shape[1], bs, probe["k"].shape[3])
                if self.kv_dtype == "int8":
                    self.caches[name] = {
                        "kp": torch.zeros(shape, dtype=torch.int8,
                                          device=self.device),
                        "vp": torch.zeros(shape, dtype=torch.int8,
                                          device=self.device),
                        "ksc": torch.zeros(shape[:3], dtype=torch.float32,
                                           device=self.device),
                        "vsc": torch.zeros(shape[:3], dtype=torch.float32,
                                           device=self.device)}
                else:
                    self.caches[name] = {
                        "kp": torch.zeros(shape, dtype=torch.float32,
                                          device=self.device),
                        "vp": torch.zeros(shape, dtype=torch.float32,
                                          device=self.device)}
            elif kind == "rnn":
                self.caches[name] = _fresh_carry(lc, self.max_slots,
                                                 self.max_seq, self.device)
            # "pos" layers persist nothing: positions are engine data
        # host mirrors: the per-slot block tables + write positions the
        # programs receive as plain int32 arguments every call
        self.tables = np.full((self.max_slots, self.blocks_per_slot),
                              self.TRASH, np.int32)
        self.pos = np.zeros((self.max_slots,), np.int32)
        self._free_blocks: List[int] = list(range(1, self.n_blocks))
        heapq.heapify(self._free_blocks)
        self._ref: Dict[int, int] = {}             # block -> slot refs
        self._slot_blocks: Dict[int, List[int]] = {}
        self._slot_prompt: Dict[int, Tuple[int, ...]] = {}
        # prefix-sharing registry: chain-hash -> block (full blocks),
        # prefix-hash -> {tail tokens -> block} (partial tails), plus
        # reverse index + LRU order for pressure eviction
        self._full: "OrderedDict[bytes, int]" = OrderedDict()
        self._partial: Dict[bytes, Dict[Tuple[int, ...], int]] = {}
        self._registered: Dict[int, tuple] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._prefix_hits = 0
        self._prefix_tokens_saved = 0
        self._cow_count = 0
        self._evictions = 0

    # ----------------------------------------------------- slot lifecycle
    def _on_acquire_locked(self, slot: int) -> None:
        self.tables[slot, :] = self.TRASH
        self.pos[slot] = 0
        self._slot_blocks[slot] = []
        self._slot_prompt.pop(slot, None)

    def _on_release_locked(self, slot: int) -> None:
        self._release_blocks_locked(slot, register_tail=True)

    def reset_slot(self, slot: int) -> None:
        """Drop a slot's blocks without vacating it — the migration
        path: the occupant stays, its history re-prefills into fresh
        blocks under the new weights.  No tail registration: the old
        blocks hold old-version K/V."""
        with self._lock:
            self._release_blocks_locked(slot, register_tail=False)
            self._slot_blocks[slot] = []

    def _release_blocks_locked(self, slot: int,
                               register_tail: bool) -> None:
        blocks = self._slot_blocks.pop(slot, [])
        prompt = self._slot_prompt.pop(slot, None)
        occupant = self._occupants.get(slot)
        rid = getattr(occupant, "id", "?")
        if register_tail and self.sharing and prompt:
            self._register_partial_locked(prompt, blocks)
        freed = []
        for blk in blocks:
            self._ref[blk] = self._ref.get(blk, 1) - 1
            if self._ref[blk] <= 0 and blk not in self._registered:
                self._ref.pop(blk, None)
                heapq.heappush(self._free_blocks, blk)
                freed.append(blk)
        self.tables[slot, :] = self.TRASH
        self.pos[slot] = 0
        if blocks:
            self._note_locked("block_release", slot, rid,
                              blocks=len(blocks), freed=len(freed))

    # -------------------------------------------------------- block alloc
    def _alloc_block_locked(self) -> Optional[int]:
        if self._free_blocks:
            return heapq.heappop(self._free_blocks)
        # pressure: evict the least-recently-used registered block that
        # no slot references (shared prefixes are a cache, not a lease)
        for blk in list(self._lru):
            if self._ref.get(blk, 0) == 0:
                self._unregister_locked(blk)
                self._ref.pop(blk, None)
                self._evictions += 1
                return blk
        return None

    def _unregister_locked(self, blk: int) -> None:
        entry = self._registered.pop(blk, None)
        self._lru.pop(blk, None)
        if entry is None:
            return
        if entry[0] == "full":
            self._full.pop(entry[1], None)
        else:
            tails = self._partial.get(entry[1])
            if tails is not None:
                tails.pop(entry[2], None)
                if not tails:
                    del self._partial[entry[1]]

    def ensure_blocks(self, slot: int, rid: str, upto_tokens: int) -> bool:
        """Allocate private blocks so the slot's table covers positions
        ``< upto_tokens``; False when the pool (after eviction) cannot.
        The engine calls this at step boundaries — ONE aggregated host
        operation per step, never per-block device work."""
        need = min(-(-int(upto_tokens) // self.block_size),
                   self.blocks_per_slot)
        with self._lock:
            blocks = self._slot_blocks.setdefault(slot, [])
            grown = []
            while len(blocks) < need:
                blk = self._alloc_block_locked()
                if blk is None:
                    if grown:
                        self._note_locked("block_alloc", slot, rid,
                                          blocks=grown)
                    return False
                self.tables[slot, len(blocks)] = blk
                self._ref[blk] = 1
                blocks.append(blk)
                grown.append(blk)
            if grown:
                self._note_locked("block_alloc", slot, rid, blocks=grown)
            return True

    def check_writable(self, slot: int) -> None:
        """The COW invariant, enforced: the block the next decode write
        lands in must be private to this slot — never the trash block,
        never referenced by another slot, never registered read-only."""
        with self._lock:
            bidx = int(self.pos[slot]) // self.block_size
            blk = int(self.tables[slot, bidx])
            if blk == self.TRASH or self._ref.get(blk, 0) != 1 \
                    or blk in self._registered:
                raise RuntimeError(
                    f"paged KV invariant violated: slot {slot} decode "
                    f"write at pos {int(self.pos[slot])} targets "
                    f"{'trash' if blk == self.TRASH else 'shared'} "
                    f"block {blk}")

    # ----------------------------------------------------- prefix sharing
    @staticmethod
    def _prefix_digests(tokens, block_size: int, n: int) -> List[bytes]:
        """Chain digests ``p_0..p_n``: ``p_i`` covers the first ``i``
        full blocks from position 0 — equal digest ⇒ equal token prefix
        ⇒ (one weight version) bit-equal K/V for those positions."""
        h = hashlib.sha256(b"dl4j-tpu-kv-prefix")
        out = [h.digest()]
        arr = np.asarray(tokens[:n * block_size], np.int64)
        for i in range(n):
            h.update(arr[i * block_size:(i + 1) * block_size].tobytes())
            out.append(h.digest())
        return out

    def match_prefix(self, history: List[int]
                     ) -> Tuple[List[int], Optional[Tuple[int, int]]]:
        """Longest registered prefix of ``history``: (full shared
        blocks, optional (partial block, fill)).  Capped at
        ``len(history) - 1`` — the last token is always re-prefilled so
        the program has a real query position to sample from, and so the
        first decode write always lands in a private block."""
        if not self.sharing or len(history) < 2:
            return [], None
        bs = self.block_size
        limit = len(history) - 1
        nmax = min(limit // bs, self.blocks_per_slot)
        digests = self._prefix_digests(history, bs, nmax)
        with self._lock:
            full: List[int] = []
            for i in range(nmax):
                blk = self._full.get(digests[i + 1])
                if blk is None:
                    break
                full.append(blk)
            partial = None
            base = len(full) * bs
            tails = self._partial.get(digests[len(full)])
            if tails and len(full) < self.blocks_per_slot:
                for tail, blk in tails.items():
                    f = len(tail)
                    if base + f <= limit and f > (partial[1] if partial
                                                  else 0) \
                            and tuple(history[base:base + f]) == tail:
                        partial = (blk, f)
            return full, partial

    def adopt(self, slot: int, rid: str, blocks: List[int]) -> None:
        """Reference registered full blocks from this slot's table (in
        logical order, from position 0)."""
        with self._lock:
            own = self._slot_blocks.setdefault(slot, [])
            for blk in blocks:
                self.tables[slot, len(own)] = blk
                self._ref[blk] = self._ref.get(blk, 0) + 1
                own.append(blk)
                if blk in self._lru:
                    self._lru.move_to_end(blk)

    def cow_begin(self, slot: int, rid: str, src: int) -> Optional[int]:
        """Allocate a private copy-target for a partially-filled shared
        block; the prefill program performs the actual pool copy.  Pins
        ``src`` against eviction until :meth:`cow_end`."""
        with self._lock:
            dst = self._alloc_block_locked()
            if dst is None:
                return None
            own = self._slot_blocks.setdefault(slot, [])
            self.tables[slot, len(own)] = dst
            self._ref[dst] = 1
            own.append(dst)
            self._ref[src] = self._ref.get(src, 0) + 1
            if src in self._lru:
                self._lru.move_to_end(src)
            self._cow_count += 1
            self._note_locked("cow", slot, rid, src=src, dst=dst)
            return dst

    def cow_end(self, src: int) -> None:
        with self._lock:
            self._ref[src] = self._ref.get(src, 1) - 1
            if self._ref[src] <= 0:
                self._ref.pop(src, None)
                if src not in self._registered:
                    heapq.heappush(self._free_blocks, src)

    def note_shared_hit(self, slot: int, rid: str,
                        tokens_saved: int) -> None:
        with self._lock:
            self._prefix_hits += 1
            self._prefix_tokens_saved += int(tokens_saved)
            self._note_locked("shared_hit", slot, rid,
                              tokens_saved=int(tokens_saved))

    def register_prefix(self, slot: int, prompt: List[int]) -> None:
        """After a successful prefill: publish the slot's full PROMPT
        blocks into the registry (they are never rewritten — decode
        appends past the prompt) and remember the prompt so the partial
        tail block can register at vacate time."""
        if not self.sharing:
            return
        bs = self.block_size
        with self._lock:
            blocks = self._slot_blocks.get(slot, [])
            nfull = min(len(prompt) // bs, len(blocks))
            digests = self._prefix_digests(prompt, bs, nfull)
            for i in range(nfull):
                key = digests[i + 1]
                blk = blocks[i]
                if key in self._full or blk in self._registered:
                    continue
                self._full[key] = blk
                self._registered[blk] = ("full", key)
                self._lru[blk] = None
            self._slot_prompt[slot] = tuple(int(t) for t in prompt)

    def _register_partial_locked(self, prompt: Tuple[int, ...],
                                 blocks: List[int]) -> None:
        """At vacate: freeze the prompt's partially-filled tail block
        as a shared partial (fill = prompt tail length; generated-token
        K/V beyond the fill is mask-dead in any future match)."""
        bs = self.block_size
        nfull = len(prompt) // bs
        tail = tuple(prompt[nfull * bs:])
        if not tail or len(blocks) <= nfull:
            return
        blk = blocks[nfull]
        if blk in self._registered or self._ref.get(blk, 0) != 1:
            return
        pkey = self._prefix_digests(prompt, bs, nfull)[nfull]
        tails = self._partial.setdefault(pkey, {})
        if tail in tails:
            return
        tails[tail] = blk
        self._registered[blk] = ("partial", pkey, tail)
        self._lru[blk] = None

    def invalidate_shared(self) -> None:
        """Weight version changed: every registered block holds stale
        K/V — drop the whole registry (unreferenced blocks return to the
        free list; referenced ones free when their slots vacate)."""
        with self._lock:
            for blk in list(self._registered):
                self._unregister_locked(blk)
                if self._ref.get(blk, 0) <= 0:
                    self._ref.pop(blk, None)
                    heapq.heappush(self._free_blocks, blk)

    # ------------------------------------------------------------- status
    @property
    def blocks_free(self) -> int:
        with self._lock:
            return len(self._free_blocks)

    def stats(self) -> dict:
        with self._lock:
            return {"block_size": self.block_size,
                    "n_blocks": self.n_blocks,
                    "blocks_free": len(self._free_blocks),
                    "blocks_registered": len(self._registered),
                    "prefix_hits": self._prefix_hits,
                    "prefix_tokens_saved": self._prefix_tokens_saved,
                    "cow_copies": self._cow_count,
                    "evictions": self._evictions,
                    "prefix_sharing": self.sharing,
                    "kv_dtype": self.kv_dtype or "float32"}

    def _snapshot_extra_locked(self) -> dict:
        return {"paged": True,
                "block_size": self.block_size,
                "n_blocks": self.n_blocks,
                "blocks_free": len(self._free_blocks),
                "tables": self.tables.tolist(),
                "pos": self.pos.tolist()}
