"""Gradient sharing over a message broker (port of ``parallel/remote.py``).

Reference: the Aeron transport under ``SharedTrainingMaster`` —
``RoutedTransport``/``MulticastTransport`` carrying ``SilentUpdatesMessage``
(threshold-quantized gradients) peer-to-peer, no barrier.  The same
encoded-update messages (``parallel/accumulation.py`` formats) get a
compact binary wire format, byte for byte the JAX package's (a frame
either package encodes decodes in the other), and ride any broker with
publish/subscribe(topic): in-process, ``streaming.LocalMessageBroker``.
Dense data-parallel sharing is ``ParallelWrapper``'s all-reduce; this is
for the bandwidth-starved boundary.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Optional

import numpy as np
import torch

from .accumulation import EncodingHandler, decode

__all__ = ["encode_message_bytes", "decode_message_bytes",
           "RemoteGradientSharing"]

_MAGIC = b"GUP2"
_KINDS = ("threshold", "bitmap")


def encode_message_bytes(worker_id: int, msg: Dict[str, Any],
                         seq: int = 0) -> bytes:
    """Encoded-update message -> wire frame (the SilentUpdatesMessage
    serialization role).  ``seq`` is a dense 1-based per-sender sequence
    number: combined with per-sender FIFO delivery it lets receivers
    dedup exactly (a resynced worker skips seq <= the count its seed
    already contains)."""
    kind = _KINDS.index(msg["kind"])
    head = _MAGIC + struct.pack("<iBqfq", worker_id, kind, msg["size"],
                                msg["threshold"], seq)
    if msg["kind"] == "threshold":
        idx = np.ascontiguousarray(msg["idx"], np.int32)
        signs = np.ascontiguousarray(msg["signs"], np.int8)
        return head + struct.pack("<q", idx.size) + idx.tobytes() \
            + signs.tobytes()
    packed = np.ascontiguousarray(msg["packed"], np.uint8)
    return head + struct.pack("<q", packed.size) + packed.tobytes()


def decode_message_bytes(data: bytes):
    """Wire frame -> (worker_id, seq, message dict)."""
    if data[:4] != _MAGIC:
        raise ValueError("bad gradient-update frame magic")
    worker_id, kind, size, threshold, seq = struct.unpack_from(
        "<iBqfq", data, 4)
    n, = struct.unpack_from("<q", data, 4 + 25)
    off = 4 + 25 + 8
    if _KINDS[kind] == "threshold":
        idx = np.frombuffer(data, np.int32, count=n, offset=off)
        signs = np.frombuffer(data, np.int8, count=n, offset=off + 4 * n)
        msg = {"kind": "threshold", "size": size, "threshold": threshold,
               "idx": idx, "signs": signs}
    else:
        packed = np.frombuffer(data, np.uint8, count=n, offset=off)
        msg = {"kind": "bitmap", "size": size, "threshold": threshold,
               "packed": packed}
    return worker_id, seq, msg


class RemoteGradientSharing:
    """One worker's endpoint: publish local encoded updates, drain and
    apply peers' (reference ``SharedTrainingWrapper`` + accumulator over
    Aeron).  All workers share one ``topic``; own messages are filtered by
    worker id."""

    #: default per-call drain bound (see ``apply_updates``): high enough
    #: that a healthy step drains everything, low enough that a flooding
    #: peer cannot starve the caller's training step in one call
    DEFAULT_MAX_DRAIN = 512

    def __init__(self, broker, worker_id: int, topic: str = "gradients",
                 handler: Optional[EncodingHandler] = None,
                 ack: bool = False, seq_base: int = 0,
                 skip_seqs: Optional[Dict[int, int]] = None, sub=None,
                 max_drain: Optional[int] = None):
        self.broker = broker
        self.worker_id = worker_id
        self.topic = topic
        self.handler = handler or EncodingHandler()
        # ``sub``: adopt an existing subscription (a resynced worker must
        # keep the one it opened BEFORE requesting its seed)
        if sub is not None:
            self._sub = sub
        else:
            self._sub = broker.subscribe(topic, ack=ack) if ack \
                else broker.subscribe(topic)
        # seq_base continues a predecessor incarnation's numbering so
        # per-sender sequence numbers stay dense across respawns
        self.seq_base = seq_base
        # skip_seqs[p]: sequence numbers <= this were already folded into
        # this worker's starting table (a resync seed) — exact dedup
        self.skip_seqs: Dict[int, int] = dict(skip_seqs or {})
        self.max_drain = self.DEFAULT_MAX_DRAIN if max_drain is None \
            else int(max_drain)
        self.messages_sent = 0
        self.messages_applied = 0
        # per-sender applied tallies back the drain barrier: a worker knows
        # it holds every peer update once applied[p] >= the count p
        # declared minus what its seed already contained
        self.applied_per_peer: Dict[int, int] = {}
        # dead-peer state (fed by the master's lease/liveness authority —
        # an eviction notice): a dead peer stops counting against the
        # drain barrier, so an evicted sender can never hang it
        self.dead_peers: set = set()

    def publish_update(self, flat_grad) -> None:
        msg = self.handler.encode_update(flat_grad)
        self.messages_sent += 1
        self.broker.publish(
            self.topic,
            encode_message_bytes(self.worker_id, msg,
                                 seq=self.seq_base + self.messages_sent))

    def apply_updates(self, flat_params, timeout: float = 0.0,
                      max_messages: Optional[int] = None):
        """Drain pending peer messages into the flat param vector; returns
        the updated vector (stale messages apply late — by design).
        Messages whose seq is at or below the sender's ``skip_seqs`` entry
        are already in this worker's starting table and are discarded.

        The drain is BOUNDED: at most ``max_messages`` (default: the
        endpoint's ``max_drain``) payloads are consumed per call, so a
        peer publishing faster than this worker trains cannot starve the
        caller's step inside one "drain until momentarily empty" loop —
        leftovers stay queued for the next call.  ``max_messages=0``
        disables the bound (the drain-barrier loops call repeatedly and
        bound themselves by their own deadline)."""
        out = flat_params if isinstance(flat_params, torch.Tensor) \
            else torch.as_tensor(np.asarray(flat_params))
        limit = self.max_drain if max_messages is None else int(max_messages)
        polled = 0
        while limit <= 0 or polled < limit:
            payload = self._sub.poll(timeout=timeout or 0.001)
            if payload is None:
                return out
            polled += 1
            sender, seq, msg = decode_message_bytes(payload)
            if sender == self.worker_id:
                continue      # own broadcast echo
            if seq and seq <= self.skip_seqs.get(sender, 0):
                continue      # already folded into the resync seed
                # (seq==0 marks an unsequenced frame — never deduped)
            out = out + decode(msg).to(out.device)
            self.messages_applied += 1
            self.applied_per_peer[sender] = \
                self.applied_per_peer.get(sender, 0) + 1
        return out

    # ------------------------------------------------------- dead peers
    def mark_dead(self, peer: int) -> None:
        """Record an eviction notice from the liveness authority: ``peer``
        will never publish again, so the drain barrier stops waiting on
        its declared count and residual."""
        self.dead_peers.add(int(peer))

    def unresolved_peers(self, declared: Dict[int, int], num_workers: int,
                         *, mirror_counts: Optional[Dict[int, int]] = None,
                         resids_seen=(), resids_folded=()) -> list:
        """Peers still blocking the drain barrier: no declared sent-count
        yet, missing residual, or applied (+ resync-seed) count below the
        declared count.  Peers in ``dead_peers`` are excluded — an
        evicted sender's contribution is whatever already arrived, and
        waiting longer cannot produce more."""
        mirror_counts = mirror_counts or {}
        out = []
        for p in range(int(num_workers)):
            if p == self.worker_id or p in self.dead_peers:
                continue
            if p not in declared \
                    or (p not in resids_seen and p not in resids_folded) \
                    or self.applied_per_peer.get(p, 0) \
                    + mirror_counts.get(p, 0) < declared[p]:
                out.append(p)
        return out

    def close(self) -> None:
        if hasattr(self._sub, "close"):
            self._sub.close()
        elif hasattr(self.broker, "unsubscribe"):
            self.broker.unsubscribe(self.topic, self._sub)
