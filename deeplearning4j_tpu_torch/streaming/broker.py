"""In-process message broker (port of ``streaming/broker.py``'s
``LocalMessageBroker``): thread-safe named topics with per-subscriber
queues (fan-out, at-most-once like the reference's auto-commit
consumer), the transport the training masters' gradient sharing rides in
one process.  ``TcpMessageBroker`` waits for the process masters
(ROADMAP queue 1, item 8).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional

from ..observability.registry import default_registry

__all__ = ["LocalMessageBroker"]


class _Subscription:
    def __init__(self, maxsize: int, topic: str = "", broker=None):
        self.q: "queue.Queue[bytes]" = queue.Queue(maxsize)
        self.topic = topic
        self._broker = broker
        self._consumed = None      # (registry, counter child) cache

    def poll(self, timeout: Optional[float] = None) -> Optional[bytes]:
        try:
            payload = self.q.get(timeout=timeout)
        except queue.Empty:
            return None
        reg = default_registry()
        if reg.enabled:
            # child handle resolved once per registry, not per message
            cached = self._consumed
            if cached is None or cached[0] is not reg:
                child = reg.counter("broker_consumed_total",
                                    "Messages delivered to subscribers",
                                    ("topic",)).labels(self.topic)
                self._consumed = cached = (reg, child)
            cached[1].inc()
            if self._broker is not None:
                # depth = the topic's WORST backlog, so one drained
                # subscriber can't mask a backed-up sibling
                self._broker._observe_depth(self.topic)
        return payload


class LocalMessageBroker:
    """Named topics; publish fans out to every subscriber's queue.

    ``max_queue=0`` makes subscriber queues unbounded — the reliable-
    transport posture (no drop-oldest): exact-count protocols like the
    multiprocess masters' drain barrier require lossless delivery, and
    their memory is bounded by job size.  The default stays bounded with
    drop-oldest so streaming consumers can't stall producers."""

    def __init__(self, max_queue: int = 1024):
        self.max_queue = max_queue
        self._topics: Dict[str, List[_Subscription]] = {}
        self._lock = threading.Lock()
        # (registry, {topic: (published, dropped, depth) children}) —
        # per-message publishes must not pay registry name resolution
        self._metric_cache = None

    def _topic_metrics(self, reg, topic: str):
        cache = self._metric_cache
        if cache is None or cache[0] is not reg:
            self._metric_cache = cache = (reg, {})
        m = cache[1].get(topic)
        if m is None:
            m = (reg.counter("broker_published_total", "Messages published",
                             ("topic",)).labels(topic),
                 reg.counter("broker_dropped_total",
                             "Messages evicted by drop-oldest backpressure",
                             ("topic",)).labels(topic),
                 reg.gauge("broker_queue_depth",
                           "Deepest undelivered-message backlog across a "
                           "topic's subscriber queues",
                           ("topic",)).labels(topic))
            cache[1][topic] = m
        return m

    def publish(self, topic: str, payload: bytes) -> None:
        with self._lock:
            subs = list(self._topics.get(topic, ()))
        dropped = 0
        for s in subs:
            try:
                s.q.put_nowait(payload)
            except queue.Full:
                # drop-oldest keeps slow consumers from stalling producers
                dropped += 1
                try:
                    s.q.get_nowait()
                except queue.Empty:
                    pass
                try:
                    s.q.put_nowait(payload)
                except queue.Full:
                    pass
        reg = default_registry()
        if reg.enabled:
            published, dropped_c, depth = self._topic_metrics(reg, topic)
            published.inc()
            if dropped:
                dropped_c.inc(dropped)
            if subs:
                depth.set(max(s.q.qsize() for s in subs))

    def _observe_depth(self, topic: str) -> None:
        """Gauge the topic's deepest subscriber queue (publish and poll
        both route here, so the two writers agree on the semantics)."""
        reg = default_registry()
        with self._lock:
            subs = list(self._topics.get(topic, ()))
        if subs:
            self._topic_metrics(reg, topic)[2].set(
                max(s.q.qsize() for s in subs))

    def subscribe(self, topic: str, ack: bool = False) -> _Subscription:
        # in-process registration is synchronous; ``ack`` exists for API
        # parity with TcpMessageBroker (where it confirms hub registration)
        sub = _Subscription(self.max_queue, topic, broker=self)
        with self._lock:
            self._topics.setdefault(topic, []).append(sub)
        return sub

    def unsubscribe(self, topic: str, sub: _Subscription) -> None:
        with self._lock:
            subs = self._topics.get(topic, [])
            if sub in subs:
                subs.remove(sub)

    def close(self) -> None:
        with self._lock:
            self._topics.clear()
