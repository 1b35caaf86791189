"""Quantized gradient sharing (port of ``parallel/accumulation.py``;
reference ``optimize/solvers/accumulation/``: ``EncodedGradientsAccumulator``,
``EncodingHandler`` threshold/bitmap encoding with residual carry and an
adaptive threshold, the multi-consumer broadcast queues).

Encoding semantics (``thresholdEncode``): values with ``|g| >= t`` are
sent as ``sign * t``; the remainder — including the clipped excess ``g -
sign*t`` of the values sent — stays in the sender's residual and
re-accumulates into later rounds, so nothing is lost, only delayed.
The messages are the JAX package's, bit for bit: the same indices (the
top-k cap keeps the largest magnitudes, ties to the lower index, as
``lax.top_k``), signs, packed bitmap bytes and residuals.

The ``device`` backend encodes with torch ops on the gradient's device;
the ``host`` backend runs the C++ codec (``utils/native``) on the host.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["threshold_encode", "threshold_decode", "bitmap_encode",
           "bitmap_decode", "decode", "EncodingHandler",
           "EncodedGradientsAccumulator"]


def _flat(a) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t.reshape(-1)


def threshold_encode(flat, threshold: float,
                     max_elements: Optional[int] = None
                     ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """Top-k thresholded sparsification of a flat vector; returns
    ``(message, residual)``."""
    flat = _flat(flat)
    n_el = flat.numel()
    k = int(max_elements or max(1, n_el // 16))
    thr = torch.tensor(threshold, dtype=flat.dtype, device=flat.device)
    mags = flat.abs()
    over = mags >= thr
    count = int(over.sum())
    scores = torch.where(over, mags, torch.full_like(mags, -1.0))
    # lax.top_k: descending, the lower index first among equal values
    order = torch.sort(scores, descending=True, stable=True).indices[:k]
    vals = scores[order]
    valid = vals > 0
    take = min(count, k)
    idx = torch.where(valid, order, torch.full_like(order, -1))
    safe = torch.where(idx >= 0, idx, torch.zeros_like(idx))
    signs = torch.where(valid, torch.sign(flat[safe]),
                        torch.zeros_like(vals))
    delta = torch.zeros_like(flat).index_put_(
        (safe,), torch.where(valid, signs * thr, torch.zeros_like(vals)),
        accumulate=True)
    residual = flat - delta
    msg = {"kind": "threshold", "size": int(n_el),
           "threshold": float(threshold),
           "idx": idx[:take].cpu().numpy().astype(np.int32),
           "signs": signs[:take].cpu().numpy().astype(np.int8)}
    return msg, residual


def threshold_decode(msg: Dict[str, Any]) -> torch.Tensor:
    out = np.zeros(msg["size"], np.float32)
    out[msg["idx"]] = msg["signs"].astype(np.float32) * msg["threshold"]
    return torch.from_numpy(out)


def _bitmap_encode_flat(flat: torch.Tensor, threshold: float):
    """2-bit dense codes (0 none, 1 +t, 2 -t) packed 4 per byte."""
    thr = torch.tensor(threshold, dtype=flat.dtype, device=flat.device)
    one = torch.ones((), dtype=torch.uint8, device=flat.device)
    codes = torch.where(flat >= thr, one,
                        torch.where(flat <= -thr, one * 2, one * 0))
    zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
    residual = flat - torch.where(codes == 1, thr,
                                  torch.where(codes == 2, -thr, zero))
    pad = (-codes.numel()) % 4
    padded = torch.cat([codes, torch.zeros(pad, dtype=torch.uint8,
                                           device=flat.device)])
    quads = padded.reshape(-1, 4)
    packed = (quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4)
              | (quads[:, 3] << 6))
    return packed, residual


def bitmap_encode(flat, threshold: float
                  ) -> Tuple[Dict[str, Any], torch.Tensor]:
    flat = _flat(flat)
    packed, residual = _bitmap_encode_flat(flat, threshold)
    return ({"kind": "bitmap", "size": int(flat.numel()),
             "threshold": float(threshold),
             "packed": packed.cpu().numpy()}, residual)


def bitmap_decode(msg: Dict[str, Any]) -> torch.Tensor:
    packed = msg["packed"]
    quads = np.stack([(packed >> s) & 0x3 for s in (0, 2, 4, 6)], axis=1)
    codes = quads.reshape(-1)[:msg["size"]]
    t = msg["threshold"]
    return torch.from_numpy(
        np.where(codes == 1, t, np.where(codes == 2, -t, 0.0))
        .astype(np.float32))


def decode(msg: Dict[str, Any]) -> torch.Tensor:
    return (threshold_decode if msg["kind"] == "threshold"
            else bitmap_decode)(msg)


class EncodingHandler:
    """Adaptive-threshold encoder with residual carry (reference
    ``EncodingHandler.java``: threshold decay/boost and the
    threshold-vs-bitmap switch at 1/16 density).  One handler per
    worker; ``encode_update`` adds the residual to the worker's flat
    update and emits a message."""

    DENSITY_SWITCH = 1.0 / 16.0  # bitmap cheaper above this (2 bits/elem)

    def __init__(self, initial_threshold: float = 1e-3,
                 min_threshold: float = 1e-9, decay: float = 0.95,
                 boost: float = 1.2, target_density: float = 1e-2,
                 backend: str = "device"):
        self.threshold = initial_threshold
        self.min_threshold = min_threshold
        self.decay = decay
        self.boost = boost
        self.target_density = target_density
        if backend not in ("device", "host"):
            raise ValueError("backend must be 'device' (torch) or 'host' "
                             "(native C++ codec)")
        self.backend = backend
        self.residual = None
        self.last_density = 0.0

    def _encode_host(self, flat: np.ndarray) -> Dict[str, Any]:
        """C++ codec path (``utils/native``): compress on the host right
        before the message leaves, no device round trip."""
        from ..utils.native import (bitmap_encode_native,
                                    threshold_encode_native)
        density = float(np.mean(np.abs(flat) >= self.threshold))
        self.last_density = density
        if density > self.DENSITY_SWITCH:
            packed, residual = bitmap_encode_native(flat, self.threshold)
            msg = {"kind": "bitmap", "size": int(flat.size),
                   "threshold": float(self.threshold), "packed": packed}
        else:
            idx, signs, residual = threshold_encode_native(
                flat, self.threshold, max(1, flat.size // 16))
            msg = {"kind": "threshold", "size": int(flat.size),
                   "threshold": float(self.threshold),
                   "idx": idx, "signs": signs}
        self.residual = residual
        return msg

    def encode_update(self, flat_grad) -> Dict[str, Any]:
        if self.backend == "host":
            flat = np.asarray(flat_grad.detach().cpu().numpy()
                              if isinstance(flat_grad, torch.Tensor)
                              else flat_grad, np.float32).reshape(-1)
            if self.residual is not None:
                flat = flat + np.asarray(self.residual, np.float32)
            msg = self._encode_host(flat)
            self._adapt()
            return msg
        flat = _flat(flat_grad)
        if self.residual is not None:
            flat = flat + self.residual
        density = float(torch.mean((flat.abs() >= self.threshold)
                                   .to(torch.float32)))
        self.last_density = density
        if density > self.DENSITY_SWITCH:
            msg, self.residual = bitmap_encode(flat, self.threshold)
        else:
            msg, self.residual = threshold_encode(flat, self.threshold)
        self._adapt()
        return msg

    def _adapt(self) -> None:
        """Too sparse -> decay the threshold; too dense -> boost it."""
        if self.last_density < self.target_density / 10.0:
            self.threshold = max(self.threshold * self.decay,
                                 self.min_threshold)
        elif self.last_density > self.target_density * 10.0:
            self.threshold *= self.boost


class EncodedGradientsAccumulator:
    """Decentralized multi-worker update exchange (reference
    ``EncodedGradientsAccumulator.java`` + ``FancyBlockingQueue``): each
    worker ``store_update``s its encoded update, which fans out to every
    *other* worker's queue; workers drain with ``apply_updates`` before
    their next local step.  No master, no barrier: stale updates apply
    late, residuals guarantee eventual delivery."""

    def __init__(self, n_workers: int, handler_factory=EncodingHandler,
                 queue_limit: int = 64):
        self.n_workers = n_workers
        self.handlers = [handler_factory() for _ in range(n_workers)]
        self.queues: List["queue.Queue"] = [queue.Queue(maxsize=queue_limit)
                                            for _ in range(n_workers)]
        self._lock = threading.Lock()
        self.messages_sent = 0
        self.bytes_sent = 0

    @staticmethod
    def _msg_bytes(msg: Dict[str, Any]) -> int:
        if msg["kind"] == "threshold":
            return msg["idx"].nbytes + msg["signs"].nbytes + 16
        return msg["packed"].nbytes + 16

    def store_update(self, worker_id: int, flat_grad) -> Dict[str, Any]:
        """Encode this worker's update and broadcast it to its peers."""
        msg = self.handlers[worker_id].encode_update(flat_grad)
        with self._lock:
            self.messages_sent += 1
            self.bytes_sent += self._msg_bytes(msg)
        for w in range(self.n_workers):
            if w != worker_id:
                self.queues[w].put(msg)
        return msg

    def apply_updates(self, worker_id: int, flat_params) -> torch.Tensor:
        """Drain this worker's queue; returns params + the sum of the
        decoded peer updates."""
        base = _flat(flat_params)
        total = None
        while True:
            try:
                msg = self.queues[worker_id].get_nowait()
            except queue.Empty:
                break
            dec = decode(msg)
            total = dec if total is None else total + dec
        if total is None:
            return base
        return base + total.to(base.device)

    def has_anything(self, worker_id: int) -> bool:
        return not self.queues[worker_id].empty()
