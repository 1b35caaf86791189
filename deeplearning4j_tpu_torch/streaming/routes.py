"""Prediction routes: features topic → model → predictions topic (port
of ``streaming/routes.py``).

Reference ``dl4j-streaming/.../routes/DL4jServeRouteBuilder.java`` (Camel
route consuming Kafka records, running the net, re-publishing results) —
here a background worker thread with clean shutdown; batching happens
upstream (ParallelInference) when throughput matters.

One deliberate difference: ``model.output`` returns a tensor on the
network's device, and the route turns it into numpy with one
device-to-host copy per batch (``ndarray_client.host_array``); the JAX
code's ``np.asarray`` would not take a CUDA tensor.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

from .codec import deserialize_array, serialize_array
from .ndarray_client import host_array

__all__ = ["ServeRoute"]


class ServeRoute:
    """Consume arrays from ``in_topic``, apply ``model.output`` (or a bare
    callable without one), publish results to ``out_topic``."""

    def __init__(self, broker, model, in_topic: str, out_topic: str,
                 transform: Optional[Callable] = None):
        self.broker = broker
        self.in_topic = in_topic
        self.out_topic = out_topic
        # a port network is an nn.Module, callable on tensors: take its
        # output (numpy in, device tensor out) as the JAX route does
        self._predict = model.output if hasattr(model, "output") else model
        self.transform = transform
        self._sub = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.processed = 0

    def start(self) -> "ServeRoute":
        self._sub = self.broker.subscribe(self.in_topic)
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            payload = self._sub.poll(timeout=0.2)
            if payload is None:
                continue
            arr, _ = deserialize_array(payload)
            if self.transform is not None:
                arr = self.transform(arr)
            pred = host_array(self._predict(arr))
            self.broker.publish(self.out_topic, serialize_array(pred))
            self.processed += 1

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._sub is not None and hasattr(self._sub, "close"):
            self._sub.close()
