"""Message brokers of the PyTorch port (port of ``streaming/broker.py``):
in-process topics and a TCP transport.

``LocalMessageBroker`` is thread-safe named topics with per-subscriber
queues (fan-out, at-most-once like the reference's auto-commit
consumer), the transport the training masters' gradient sharing rides
in one process.  ``TcpMessageBroker`` serves the same API across
processes over a length-prefixed socket protocol, the transport of the
process masters (``parallel/master_mp.py``).  Its wire is byte for byte
the JAX package's: a client of either package talks to a hub of the
other.
"""
from __future__ import annotations

import queue
import socket
import socketserver
import struct
import threading
from typing import Dict, List, Optional

from ..observability.registry import default_registry

__all__ = ["LocalMessageBroker", "TcpMessageBroker"]


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


# --------------------------------------------------------------------- TCP
# frame: op(1: 0=pub 1=sub 2=sub+ack) topic_len(2) topic payload_len(4)
# payload.  op 2 answers with one empty frame on the subscription socket
# the moment the hub has registered the subscription — after the client
# reads it, any subsequently published message is guaranteed to fan out
# to this subscriber (no subscribe/publish cross-connection race).
def _send_frame(sock: socket.socket, op: int, topic: str,
                payload: bytes = b"") -> None:
    t = topic.encode()
    sock.sendall(struct.pack("<BH", op, len(t)) + t
                 + struct.pack("<I", len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """``n`` bytes, or None if the peer closes first.  Read into one
    buffer: a process master's frame is hundreds of MB."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            return None
        got += k
    return bytes(buf)


class TcpMessageBroker:
    """Broker server + client in one class.  ``serve()`` starts the hub;
    clients use ``publish``/``subscribe`` pointed at host:port.

    Client endpoints survive a hub restart: a stale/refused socket is
    rebuilt under ``reconnect_policy`` (bounded attempts, seeded
    exponential backoff — the ``RetryPolicy`` the training masters use),
    counted in ``broker_reconnects_total{op}``; only an exhausted budget
    raises, with the attempt count and last error spelled out."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_queue: int = 1024, reconnect_policy=None):
        from ..faulttolerance.faults import RetryPolicy
        self.host = host
        self.port = port
        self._local = LocalMessageBroker(max_queue)
        self._server: Optional[socketserver.ThreadingTCPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._pub_sock: Optional[socket.socket] = None
        self._pub_lock = threading.Lock()
        self.reconnect_policy = reconnect_policy if reconnect_policy \
            is not None else RetryPolicy(max_retries=4, backoff_s=0.05,
                                         max_backoff_s=2.0)
        # each reconnecting endpoint draws from its OWN policy stream
        # (worker key): the publisher is stream 0 (serialized under
        # _pub_lock), every subscription gets the next id — concurrent
        # reconnects (heartbeat publish vs a poll's resubscribe) never
        # race one numpy Generator
        self._stream_seq = 0
        self._stream_lock = threading.Lock()

    def _next_stream_id(self) -> int:
        with self._stream_lock:
            self._stream_seq += 1
            return self._stream_seq

    @staticmethod
    def _count_reconnect(op: str) -> None:
        reg = default_registry()
        if reg.enabled:
            reg.counter("broker_reconnects_total",
                        "Client reconnects after a stale/refused broker "
                        "socket", ("op",)).labels(op).inc()

    # -- server side ---------------------------------------------------------
    def serve(self) -> "TcpMessageBroker":
        broker = self._local
        # live handler sockets: shutdown() severs them so clients observe
        # the hub going away promptly (a crashed hub process resets its
        # connections; an in-process shutdown must look the same)
        conns = self._conns = set()
        conns_lock = self._conns_lock = threading.Lock()

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                subs = []
                with conns_lock:
                    conns.add(sock)
                try:
                    while True:
                        head = _recv_exact(sock, 3)
                        if head is None:
                            return
                        op, tlen = struct.unpack("<BH", head)
                        topic = _recv_exact(sock, tlen)
                        plen_b = _recv_exact(sock, 4)
                        if topic is None or plen_b is None:
                            return
                        payload = _recv_exact(
                            sock, struct.unpack("<I", plen_b)[0])
                        topic = topic.decode()
                        if op == 0:
                            broker.publish(topic, payload)
                        elif op in (1, 2):
                            sub = broker.subscribe(topic)
                            subs.append((topic, sub))
                            if op == 2:   # registration ack, before any pump
                                sock.sendall(struct.pack("<I", 0))
                            t = threading.Thread(
                                target=self._pump, args=(sock, sub),
                                daemon=True)
                            t.start()
                except (ConnectionError, OSError):
                    pass
                finally:
                    with conns_lock:
                        conns.discard(sock)
                    for topic, sub in subs:
                        broker.unsubscribe(topic, sub)

            @staticmethod
            def _pump(sock, sub):
                try:
                    while True:
                        payload = sub.poll(timeout=1.0)
                        if payload is None:
                            continue
                        sock.sendall(struct.pack("<I", len(payload)) + payload)
                except (ConnectionError, OSError):
                    pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True   # handlers must not block interpreter exit

        self._server = Server((self.host, self.port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def shutdown(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
            with self._conns_lock:
                pending, self._conns = set(self._conns), set()
            for sock in pending:
                try:     # sever live client connections (crash parity)
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                sock.close()
        with self._pub_lock:
            if self._pub_sock is not None:
                self._pub_sock.close()
                self._pub_sock = None
        self._local.close()

    # -- client side ---------------------------------------------------------
    def publish(self, topic: str, payload: bytes) -> None:
        """Publish over ONE persistent connection per client object: the
        hub's handler processes a connection's frames sequentially, so a
        sender's messages are delivered per-subscriber in publish order
        (the FIFO the masters' sequence-number dedup relies on) — and no
        per-message TCP setup.  A stale socket (hub restart) is rebuilt
        under the bounded ``reconnect_policy`` backoff; the budget
        exhausting raises with the full story."""
        policy = self.reconnect_policy
        with self._pub_lock:
            last_err: Optional[BaseException] = None
            for attempt in range(policy.max_retries + 1):
                if attempt:
                    self._count_reconnect("publish")
                    policy.sleep(attempt, worker=0)
                try:
                    if self._pub_sock is None:
                        self._pub_sock = socket.create_connection(
                            (self.host, self.port), timeout=5)
                    _send_frame(self._pub_sock, 0, topic, payload)
                    return
                except (ConnectionError, OSError) as e:
                    last_err = e
                    if self._pub_sock is not None:
                        try:
                            self._pub_sock.close()
                        finally:
                            self._pub_sock = None
            raise ConnectionError(
                f"broker publish to {self.host}:{self.port} topic "
                f"{topic!r} failed after {policy.max_retries} reconnect "
                f"attempts: {last_err}") from last_err

    class _TcpSubscription:
        def __init__(self, sock: socket.socket, broker=None, topic: str = "",
                     ack: bool = False):
            self._sock = sock
            self._buf = bytearray()   # partial frame survives poll timeouts
            self._broker = broker
            self._topic = topic
            self._ack = ack
            self._eof = False         # hub closed the stream (vs timeout)
            self._closed = False
            # dedicated backoff stream (see broker._next_stream_id)
            self._stream_id = broker._next_stream_id() \
                if broker is not None else 0

        def _fill(self, n: int, timeout: Optional[float]) -> bool:
            """Buffer until n bytes are available; False on timeout/EOF
            with the partial data RETAINED for the next poll (EOF is
            remembered in ``_eof`` so poll can resubscribe)."""
            import time as _time
            deadline = None if timeout is None else _time.time() + timeout
            while len(self._buf) < n:
                if deadline is not None:
                    remaining = deadline - _time.time()
                    if remaining <= 0:
                        return False
                    self._sock.settimeout(remaining)
                else:
                    self._sock.settimeout(None)
                try:
                    chunk = self._sock.recv(65536)
                except socket.timeout:
                    return False
                except (ConnectionError, OSError):
                    self._eof = True
                    return False
                if not chunk:
                    self._eof = True
                    return False
                self._buf.extend(chunk)
            return True

        def _resubscribe(self) -> None:
            """Rebuild the subscription socket after a hub restart under
            the broker's bounded backoff.  Undelivered frames from the
            dead hub are gone (the at-most-once contract); a partial
            frame in the buffer is dropped WITH the stream it belonged
            to.  Exhausting the budget raises a clear error."""
            policy = self._broker.reconnect_policy
            last_err: Optional[BaseException] = None
            for attempt in range(1, policy.max_retries + 1):
                TcpMessageBroker._count_reconnect("subscribe")
                policy.sleep(attempt, worker=self._stream_id)
                try:
                    fresh = self._broker.subscribe(self._topic,
                                                   ack=self._ack)
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    self._sock = fresh._sock
                    self._buf = bytearray()
                    self._eof = False
                    return
                except (ConnectionError, OSError, RuntimeError) as e:
                    last_err = e
            raise ConnectionError(
                f"broker subscription to topic {self._topic!r} at "
                f"{self._broker.host}:{self._broker.port} lost and not "
                f"re-established after {policy.max_retries} reconnect "
                f"attempts: {last_err}") from last_err

        def poll(self, timeout: Optional[float] = None) -> Optional[bytes]:
            if self._eof and not self._closed and self._broker is not None:
                self._resubscribe()
            if not self._fill(4, timeout):
                return None
            size = struct.unpack("<I", bytes(self._buf[:4]))[0]
            if not self._fill(4 + size, timeout):
                return None
            payload = bytes(self._buf[4:4 + size])
            del self._buf[:4 + size]
            return payload

        def close(self):
            self._closed = True
            self._sock.close()

    def subscribe(self, topic: str, ack: bool = False) -> "_TcpSubscription":
        s = socket.create_connection((self.host, self.port), timeout=5)
        _send_frame(s, 2 if ack else 1, topic)
        sub = TcpMessageBroker._TcpSubscription(s, broker=self, topic=topic,
                                                ack=ack)
        if ack:
            first = sub.poll(timeout=10.0)
            if first != b"":
                raise RuntimeError(
                    f"no subscription ack from hub for {topic!r}")
        return sub
