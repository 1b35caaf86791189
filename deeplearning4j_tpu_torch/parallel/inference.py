"""Parallel inference (port of ``parallel/inference.py``: reference
``deeplearning4j-scaleout/.../parallelism/ParallelInference.java:32`` and
``inference/observers/BatchedInferenceObservable.java``).

One model on one device serves every caller.  What the reference's
replicas-per-GPU design keeps here is *dynamic batching*: singleton
requests are coalesced into padded batches on the shared serving bucket
ladder (``data/shapes.serving_buckets``) and run on a single dispatcher
thread, while caller threads block on futures.

Modes (reference ``InferenceMode``):
  INPLACE   — the forward runs in the caller's thread (no queueing)
  BATCHED   — requests queue; the dispatcher coalesces up to
              ``max_batch_size`` items (waiting ``nano_wait`` s for
              stragglers), pads to the bucket size, runs ONE forward on
              the model's device and scatters the rows

Callers hand in and get back host arrays; the device work of BATCHED
mode happens on the dispatcher thread only.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..data.shapes import serving_buckets

__all__ = ["ParallelInference", "InferenceMode", "InvalidInputError"]


class InvalidInputError(ValueError):
    """Request rejected up front (wrong feature shape, bad ids): a
    *client* error, distinguishable from ValueErrors raised inside the
    model forward."""


class InferenceMode:
    INPLACE = "INPLACE"
    BATCHED = "BATCHED"


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    # callers split or reject before bucketing: reaching here is a bug
    raise InvalidInputError(
        f"batch of {n} exceeds the top bucket {buckets[-1]}")


def to_host(out) -> np.ndarray:
    """A forward's result as a host array: device tensors are copied back
    (half types widened to f32, which numpy lacks); anything else goes
    through ``np.asarray``."""
    if isinstance(out, torch.Tensor):
        out = out.detach()
        if out.dtype in (torch.bfloat16, torch.float16):
            out = out.float()
        return out.cpu().numpy()
    return np.asarray(out)


def feature_shape(model) -> Optional[tuple]:
    """Per-example input shape from the model's declared input type, or
    None when it declares none."""
    try:
        return tuple(model.conf.input_type.shape(-1)[1:])
    except Exception:
        return None


class ParallelInference:
    """Thread-safe inference front-end over one model.

    ``output(x)`` takes a single example ``[features...]`` or a batch
    ``[n, features...]`` and returns the model output as a host array; in
    BATCHED mode concurrent callers are coalesced into one padded batch.

    Explicit ``batch_buckets`` are used as given; a coalesced group larger
    than the top bucket follows ``oversize_policy``: ``"split"`` (default)
    dispatches it in top-bucket chunks, ``"reject"`` fails it with
    ``InvalidInputError``.
    """

    def __init__(self, model, inference_mode: str = InferenceMode.BATCHED,
                 max_batch_size: int = 32, queue_limit: int = 256,
                 nano_wait: float = 0.002,
                 batch_buckets: Optional[Sequence[int]] = None,
                 oversize_policy: str = "split"):
        if inference_mode not in (InferenceMode.INPLACE,
                                  InferenceMode.BATCHED):
            raise ValueError(
                f"unknown inference_mode '{inference_mode}'; expected "
                f"'{InferenceMode.INPLACE}' or '{InferenceMode.BATCHED}' "
                "(an unrecognized mode would queue requests with no "
                "dispatcher and hang)")
        if oversize_policy not in ("split", "reject"):
            raise ValueError(
                f"unknown oversize_policy '{oversize_policy}'; expected "
                "'split' (chunk oversize batches across dispatches) or "
                "'reject' (fail them with InvalidInputError)")
        self.model = model
        self.mode = inference_mode
        self.max_batch_size = max_batch_size
        self.nano_wait = nano_wait
        self.oversize_policy = oversize_policy
        self.buckets = serving_buckets(max_batch_size, batch_buckets)
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_limit)
        self._shutdown = threading.Event()
        self._submit_lock = threading.Lock()  # orders submits vs shutdown
        self._worker: Optional[threading.Thread] = None
        if self.mode == InferenceMode.BATCHED:
            self._worker = threading.Thread(
                target=self._dispatch_loop, daemon=True,
                name="dl4j-torch-inference-dispatch")
            self._worker.start()

    # ------------------------------------------------------------------ API
    def output(self, x) -> np.ndarray:
        x = np.asarray(x)
        expected = feature_shape(self.model)
        single = x.ndim == (len(expected) if expected is not None else 1)
        batch = x[None] if single else x
        if expected is not None and tuple(batch.shape[1:]) != expected:
            raise InvalidInputError(f"expected feature shape {expected}, "
                                    f"got {tuple(batch.shape[1:])}")
        if self.mode == InferenceMode.INPLACE or self._shutdown.is_set():
            out = to_host(self.model.output(batch))
            return out[0] if single else out
        if (self.oversize_policy == "reject"
                and len(batch) > self.buckets[-1]):
            raise InvalidInputError(
                f"request batch of {len(batch)} exceeds the top bucket "
                f"{self.buckets[-1]} (oversize_policy='reject')")
        futures = [self._submit(batch[i]) for i in range(len(batch))]
        results = np.stack([f.result() for f in futures])
        return results[0] if single else results

    def shutdown(self) -> None:
        with self._submit_lock:  # no submit can slip past the drain below
            self._shutdown.set()
        if self._worker is not None:
            try:
                self._queue.put_nowait(None)  # wake the dispatcher
            except queue.Full:
                pass  # dispatcher is draining; the flag alone stops it
            self._worker.join(timeout=5)
        # fail any future still enqueued so its caller unblocks
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[1].set_exception(
                    RuntimeError("ParallelInference shut down"))

    # ------------------------------------------------------------ internals
    def _submit(self, example: np.ndarray) -> Future:
        f: Future = Future()
        with self._submit_lock:
            if self._shutdown.is_set():
                raise RuntimeError("ParallelInference shut down")
            self._queue.put((example, f))
        return f

    def _dispatch_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                item = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is None:
                continue
            pending: List = [item]
            # wait for stragglers unless a full batch is already queued
            if self._queue.qsize() < self.max_batch_size - 1 and \
                    self.nano_wait:
                time.sleep(self.nano_wait)
            while len(pending) < self.max_batch_size:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is not None:
                    pending.append(nxt)
            # group by feature shape: one malformed request must not fail
            # the ones coalesced with it (shapes differ only when the
            # model declares no input type)
            groups: dict = {}
            for ex, fut in pending:
                groups.setdefault(tuple(np.shape(ex)), []).append((ex, fut))
            for group in groups.values():
                self._run_batch(group)

    def _run_batch(self, pending: List) -> None:
        top = self.buckets[-1]
        if len(pending) > top:
            if self.oversize_policy == "reject":
                err = InvalidInputError(
                    f"coalesced batch of {len(pending)} exceeds the top "
                    f"bucket {top} (oversize_policy='reject')")
                for _, fut in pending:
                    if not fut.done():
                        fut.set_exception(err)
                return
            # split: one dispatch per top-bucket chunk
            for i in range(0, len(pending), top):
                self._run_batch(pending[i:i + top])
            return
        try:  # a failed batch must not kill the dispatch loop
            examples = np.stack([ex for ex, _ in pending])
            n = len(examples)
            b = _bucket(n, self.buckets)
            if b > n:  # pad to the bucket by repeating the last row
                pad = np.repeat(examples[-1:], b - n, axis=0)
                batch = np.concatenate([examples, pad])
            else:
                batch = examples
            out = to_host(self.model.output(batch))[:n]
            for (_, fut), row in zip(pending, out):
                fut.set_result(row)
        except Exception as e:
            for _, fut in pending:
                if not fut.done():
                    fut.set_exception(e)
