"""Shared HTTP plumbing for the serving tier (port of ``utils/http.py``,
host code only): JSON request/response handler
base with built-in observability (request count/latency/error-class metrics
per route and a ``/metrics`` exposition endpoint), background-thread server
lifecycle with bounded handler concurrency, and a keep-alive JSON client.

Concurrency model: ``ThreadingHTTPServer`` spawns one thread per
connection with no cap — under a connection flood that is an unbounded
thread (and memory) blowup.  ``BackgroundHttpServer`` bounds BOTH
resources, because keep-alive makes them distinct: ``max_concurrent``
caps requests being *handled* at once (an over-cap request gets a proper
``503 + Retry-After`` on its own connection, which stays open — an idle
pooled connection never holds a handling slot), while a higher
connection cap (default ``4 x max_concurrent``) bounds handler *threads*
against raw connection floods with a minimal socket-level 503 before any
thread spawns.  ``http_inflight_requests`` (requests mid-handler) and
``http_shed_total{scope=request|connection}`` make the pressure
scrape-visible.

``JsonClient`` holds one persistent ``http.client.HTTPConnection`` per
calling thread (keep-alive), with a single bounded reconnect when a
pooled connection turns out stale (server restarted, idle timeout) —
so a concurrency bench measures the server, not TCP handshakes."""
from __future__ import annotations

import http.client
import io
import json
import socket
import threading
import urllib.error
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from ..observability import clock
from ..observability.exposition import CONTENT_TYPE, render_text
from ..observability.registry import default_registry

__all__ = ["JsonHandler", "MetricsEndpointMixin", "PredictCircuitMixin",
           "BackgroundHttpServer", "JsonClient"]


class PredictCircuitMixin:
    """Consecutive-failure readiness circuit shared by the serving
    front-ends: a streak of model-side predict failures flips /health
    unready until one success.  ONE implementation — the two servers
    must never diverge on circuit semantics.  Handler threads report
    outcomes concurrently, so the lock keeps failure streaks lossless
    (N racing ``+=`` must reach the circuit threshold, not lose
    increments)."""

    def _init_predict_circuit(self) -> None:
        self.consecutive_failures = 0
        self.last_predict_mono: Optional[float] = None
        self._health_lock = threading.Lock()

    def note_predict_result(self, ok: bool) -> None:
        """Record one predict outcome from a handler thread."""
        with self._health_lock:
            if ok:
                self.consecutive_failures = 0
                self.last_predict_mono = clock.monotonic_s()
            else:
                self.consecutive_failures += 1

# request-latency buckets: local serving sits in the 1-100 ms band;
# keep a long tail for a first request that builds kernels
_LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                    0.5, 1.0, 2.5, 10.0)


class MetricsEndpointMixin:
    """Serve the registry + observe per-route request metrics.

    Handlers bind ``metrics_registry`` (via ``BackgroundHttpServer``
    handler attrs) or fall back to the process-global default registry.
    ``GET /metrics`` renders Prometheus text format; ``GET
    /metrics?format=json`` returns the JSON snapshot.  Every response
    sent through ``_json``/``_serve_metrics`` records::

        http_requests_total{route,method,code}
        http_request_seconds{route}        (histogram)
        http_errors_total{route,class}     (class = client_error|server_error)

    Route labels are the matched path with query strings stripped; 404s
    collapse into one ``<unmatched>`` series so scrapes can't be
    cardinality-bombed by URL probing.
    """

    metrics_registry = None   # bound per-server; None -> default registry

    def _registry(self):
        return (self.metrics_registry if self.metrics_registry is not None
                else default_registry())

    def _route_label(self, code: int) -> str:
        if code == 404:
            return "<unmatched>"
        base = self.path.partition("?")[0].rstrip("/")
        return base or "/"

    def _observe_request(self, code: int) -> None:
        reg = self._registry()
        if not reg.enabled:
            return
        route = self._route_label(code)
        dur = clock.monotonic_s() - getattr(self, "_req_start_mono",
                                            clock.monotonic_s())
        reg.counter("http_requests_total", "HTTP requests served",
                    ("route", "method", "code")) \
           .labels(route, getattr(self, "command", "?") or "?",
                   str(code)).inc()
        reg.histogram("http_request_seconds", "HTTP request latency",
                      ("route",), buckets=_LATENCY_BUCKETS) \
           .labels(route).observe(dur)
        if code >= 400:
            cls = "server_error" if code >= 500 else "client_error"
            reg.counter("http_errors_total", "HTTP error responses",
                        ("route", "error_class")).labels(route, cls).inc()

    def _serve_flightrecorder(self) -> bool:
        """Answer ``GET /debug/flightrecorder``; returns False when the
        path is not the flight-recorder endpoint (caller continues its
        own routing).  Plain GET returns the live in-memory window
        (channels, spans, metric snapshots); ``?dump=1`` additionally
        commits it to an atomic checksummed artifact and returns the
        path — the manual trigger for "grab me the evidence NOW".
        ONE implementation on the mixin so every server that exposes
        ``/metrics`` exposes the same forensics route."""
        base, _, query = self.path.partition("?")
        if base.rstrip("/") != "/debug/flightrecorder":
            return False
        from ..observability.recorder import get_flight_recorder
        rec = get_flight_recorder()
        if rec is None or not rec.enabled:
            self._json({"enabled": False,
                        "error": "no flight recorder installed"}, 503)
            return True
        # dump only on an affirmative value: writing an artifact is a
        # side effect, so ?dump=0 / ?dump=false must stay the live view
        dump_vals = parse_qs(query).get("dump", [])
        if dump_vals and dump_vals[-1].lower() not in ("0", "false", "no", ""):
            try:
                path = rec.dump("manual")
            except Exception as e:
                self._json({"ok": False, "error": str(e)}, 500)
                return True
            self._json({"ok": True, "path": path})
            return True
        self._json(rec.view())
        return True

    def _serve_profile(self) -> bool:
        """Answer ``GET /debug/profile``; returns False when the path is
        not the step-profiler endpoint (caller continues its own
        routing).  Plain GET returns the live ``profile``-channel window
        (per-step phase records, serve/decode slices) plus the phase
        summary; ``?dump=1`` additionally commits a checksummed
        Chrome-trace artifact (``chrome://tracing`` / Perfetto loadable)
        and returns the path.  ONE implementation on the mixin — both
        servers expose identical profiling forensics."""
        base, _, query = self.path.partition("?")
        if base.rstrip("/") != "/debug/profile":
            return False
        from ..observability import profiler as stepprof
        from ..observability.recorder import get_flight_recorder
        rec = get_flight_recorder()
        if rec is None or not rec.enabled:
            self._json({"enabled": False,
                        "error": "no flight recorder installed"}, 503)
            return True
        # dump only on an affirmative value (side effect: writes a file)
        dump_vals = parse_qs(query).get("dump", [])
        if dump_vals and dump_vals[-1].lower() not in ("0", "false", "no", ""):
            try:
                path = stepprof.dump_chrome_trace(recorder=rec)
            except Exception as e:
                self._json({"ok": False, "error": str(e)}, 500)
                return True
            self._json({"ok": True, "path": path})
            return True
        records = rec.channel(stepprof.CHANNEL).items()
        self._json({"enabled": stepprof.stepprof_enabled(),
                    "records": records,
                    "summary": stepprof.phase_summary(records)})
        return True

    def _serve_metrics(self) -> bool:
        """Answer ``GET /metrics``; returns False when the path is not the
        metrics endpoint (caller continues its own routing)."""
        base, _, query = self.path.partition("?")
        if base.rstrip("/") != "/metrics":
            return False
        reg = self._registry()
        if "json" in query:
            self._json(reg.snapshot())
            return True
        payload = render_text(reg).encode("utf-8")
        try:
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True
            return True
        self._observe_request(200)
        return True


class JsonHandler(MetricsEndpointMixin, BaseHTTPRequestHandler):
    """Quiet handler with JSON helpers; subclasses implement do_GET/do_POST.

    HTTP/1.1 so keep-alive clients (``JsonClient``'s per-thread pooled
    connections) reuse one socket across requests; every response path
    here sends ``Content-Length``, which 1.1 persistence requires.  Idle
    connections are dropped after ``timeout`` so abandoned sockets can't
    pin handler threads (and concurrency-cap slots) forever."""

    protocol_version = "HTTP/1.1"
    timeout = 65

    def log_message(self, *a):
        pass

    def _request_gauge(self):
        return self._registry().gauge(
            "http_inflight_requests",
            "Requests currently being handled (capped at max_concurrent)")

    def parse_request(self):
        ok = super().parse_request()
        if not ok:
            return False
        # per-REQUEST concurrency slot: taken after a full request line
        # arrives (an idle keep-alive connection holds nothing), shed
        # in-protocol so the client's pooled connection survives the 503
        slots = getattr(self.server, "request_slots", None)
        if slots is not None:
            if not slots.acquire(blocking=False):
                self.server.count_shed("request")
                self._json({"error": "server at concurrency cap"}, 503,
                           headers={"Retry-After": "1"})
                return False
            self._slot_held = True
            if self._registry().enabled:
                self._request_gauge().inc()
        return True

    def handle_one_request(self):
        # stamp BEFORE parsing so the latency histogram covers the whole
        # request (read + handle + write), not just the handler body
        self._req_start_mono = clock.monotonic_s()
        self._slot_held = False
        self._body_read = False
        try:
            super().handle_one_request()
        except (ConnectionResetError, BrokenPipeError):
            # a client tearing down its socket between keep-alive
            # requests (an abandoned generation stream's dedicated
            # connection, a killed client) is routine under load — end
            # the handler quietly instead of stack-tracing per socket
            self.close_connection = True
        finally:
            if self._slot_held:
                self._slot_held = False
                self.server.request_slots.release()
                if self._registry().enabled:
                    self._request_gauge().dec()

    # largest request body worth draining to keep a connection alive; a
    # bigger one is cheaper to abandon than to read
    _DRAIN_CAP = 1 << 20

    def _drain_unread_body(self) -> None:
        """Consume an unread request body before responding.  HTTP/1.1
        keep-alive makes this mandatory: a response sent with body bytes
        still in the socket (shed 503s, 404 routes) would desync the
        client's pooled connection — the leftover body parses as the next
        request line.  Oversized bodies close the connection instead."""
        if getattr(self, "_body_read", False):
            return
        self._body_read = True
        try:
            n = int(self.headers.get("Content-Length", 0) or 0)
        except (TypeError, ValueError):
            n = 0
        if n <= 0:
            return
        if n > self._DRAIN_CAP:
            self.close_connection = True
            return
        try:
            self.rfile.read(n)
        except OSError:
            self.close_connection = True

    def _json(self, obj, code: int = 200, headers: Optional[dict] = None):
        self._drain_unread_body()     # keep-alive: never strand body bytes
        payload = json.dumps(obj).encode()
        try:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            for k, v in (headers or {}).items():
                self.send_header(k, str(v))
            self.end_headers()
            self.wfile.write(payload)
        except (BrokenPipeError, ConnectionResetError):
            # the client gave up (timeout under overload) — a dead socket
            # is routine there, not a handler error worth a stack trace
            self.close_connection = True
            return
        self._observe_request(code)

    def _read_body(self) -> bytes:
        """Read the request body.  ALWAYS consume the body through this
        (or ``_read_json``) rather than ``self.rfile`` directly — it
        marks the body consumed so the keep-alive drain in ``_json``
        doesn't block re-reading bytes that are already gone."""
        self._body_read = True
        n = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(n)

    def _read_json(self):
        return json.loads(self._read_body())

    def _stream_json_lines(self, events) -> bool:
        """Send a chunked HTTP/1.1 response of newline-delimited JSON
        objects, one chunk per event, flushed as produced — the
        token-streaming transport for ``POST /generate``.  Chunked
        framing keeps the connection keep-alive-clean (the client knows
        where the stream ends without a Content-Length).  Returns False
        when the client went away mid-stream (dead sockets are routine
        for an abandoned generation — the caller cancels the work, no
        stack trace)."""
        self._drain_unread_body()
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            for ev in events:
                data = (json.dumps(ev) + "\n").encode()
                self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True
            return False
        self._observe_request(200)
        return True


# connection-level shed response: written straight to the socket before
# any handler thread exists, so a flood can't allocate per-request state
_SHED_BODY = b'{"error": "server at concurrency cap"}'
_SHED_RESPONSE = (b"HTTP/1.1 503 Service Unavailable\r\n"
                  b"Retry-After: 1\r\n"
                  b"Content-Type: application/json\r\n"
                  b"Content-Length: " + str(len(_SHED_BODY)).encode() +
                  b"\r\nConnection: close\r\n\r\n" + _SHED_BODY)


class _BoundedThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a request-handling cap and a connection
    (thread) cap.

    ``request_slots`` (``max_concurrent``) is taken per REQUEST by the
    handler (see ``JsonHandler.parse_request``) — keep-alive connections
    idling between requests hold no slot, and an over-cap request gets a
    proper in-protocol 503 + Retry-After.  The connection cap bounds
    handler threads themselves: past it, the accepted socket gets a raw
    503 and closes before any thread spawns (flood containment).
    """

    metrics_registry = None

    def __init__(self, addr, handler, max_concurrent: int,
                 max_connections: Optional[int] = None):
        self.max_concurrent = int(max_concurrent)
        self.max_connections = int(max_connections) if max_connections \
            else max(4 * self.max_concurrent, 64)
        self.request_slots = threading.BoundedSemaphore(self.max_concurrent)
        self._conn_slots = threading.BoundedSemaphore(self.max_connections)
        super().__init__(addr, handler)

    def _registry(self):
        reg = getattr(self, "metrics_registry", None)
        return reg if reg is not None else default_registry()

    def count_shed(self, scope: str) -> None:
        reg = self._registry()
        if reg.enabled:
            reg.counter("http_shed_total",
                        "Requests/connections shed at a concurrency cap "
                        "(503 + Retry-After)", ("scope",)
                        ).labels(scope).inc()

    def process_request(self, request, client_address):
        if not self._conn_slots.acquire(blocking=False):
            self.count_shed("connection")
            try:
                request.sendall(_SHED_RESPONSE)
            except OSError:
                pass
            self.shutdown_request(request)
            return
        super().process_request(request, client_address)

    def process_request_thread(self, request, client_address):
        try:
            super().process_request_thread(request, client_address)
        finally:
            self._conn_slots.release()


class BackgroundHttpServer:
    """Owns a bounded ThreadingHTTPServer on a daemon thread; binds the
    given handler class with extra attributes (the per-instance state the
    handler needs).  ``max_concurrent`` caps requests being handled at
    once (in-protocol 503 + Retry-After past it); ``max_connections``
    (default 4x) caps handler threads against connection floods."""

    def __init__(self, handler_base, port: int = 0,
                 max_concurrent: int = 64,
                 max_connections: Optional[int] = None, **handler_attrs):
        handler = type(f"Bound{handler_base.__name__}", (handler_base,),
                       dict(handler_attrs))
        self.httpd = _BoundedThreadingHTTPServer(
            ("127.0.0.1", port), handler, max_concurrent=max_concurrent,
            max_connections=max_connections)
        # the shed path and the inflight gauge report into the same
        # registry the handlers bind
        self.httpd.metrics_registry = handler_attrs.get("metrics_registry")
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "BackgroundHttpServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        # BaseServer.shutdown() blocks on an event that only
        # serve_forever() sets on exit — calling it on a never-started
        # server would hang forever, so it only runs when the serve
        # thread exists.  Joining it stops new ACCEPTS; per-connection
        # handler threads are daemon and untracked, so a request already
        # executing may still be mid-flight after stop() returns —
        # teardown that mutates handler-visible state must tolerate that
        if self._thread is not None:
            self.httpd.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self.httpd.server_close()


class JsonClient:
    """JSON-over-HTTP client with per-thread persistent connections.

    One ``http.client.HTTPConnection`` (or ``HTTPSConnection`` for
    ``https://`` URLs) per calling thread, reused across requests
    (keep-alive).  A stale pooled connection — the server restarted or
    closed the idle socket — gets ONE bounded reconnect, and only when a
    retry cannot double-execute: the failure happened while SENDING on a
    reused connection (nothing reached the server), or the method is an
    idempotent GET.  A POST whose bytes may have been delivered (send
    succeeded but the response failed, or any timeout) always propagates
    the error — serving requests are not assumed idempotent.  Error
    responses raise :class:`urllib.error.HTTPError` with
    ``.code``/``.headers``, matching the previous ``urlopen`` behavior
    callers already handle."""

    def __init__(self, url: str, timeout: float = 10.0):
        self.url = url.rstrip("/")
        self.timeout = timeout
        parts = urlsplit(self.url if "//" in self.url
                         else "http://" + self.url)
        self._https = parts.scheme == "https"
        self._host = parts.hostname or "127.0.0.1"
        self._port = parts.port or (443 if self._https else 80)
        # base-URL path prefix (reverse proxy / mounted sub-path) rides
        # in front of every route, matching the old urlopen(url + route)
        self._base_path = parts.path.rstrip("/")
        self._tls = threading.local()

    # ------------------------------------------------------- connection pool
    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._tls, "conn", None)
        if conn is None:
            cls = http.client.HTTPSConnection if self._https \
                else http.client.HTTPConnection
            conn = cls(self._host, self._port, timeout=self.timeout)
            self._tls.conn = conn
        return conn

    def _drop_conn(self) -> None:
        conn = getattr(self._tls, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
        self._tls.conn = None

    def close(self) -> None:
        """Close this thread's pooled connection (idle cleanup)."""
        self._drop_conn()

    # -------------------------------------------------------------- requests
    def _request(self, method: str, route: str,
                 body: Optional[bytes] = None) -> bytes:
        headers = {"Content-Type": "application/json"} if body else {}
        for attempt in (0, 1):
            reused = getattr(self._tls, "conn", None) is not None
            conn = self._conn()
            sent = False
            try:
                conn.request(method, self._base_path + route, body=body,
                             headers=headers)
                sent = True               # bytes may now be at the server
                resp = conn.getresponse()
                data = resp.read()        # drain fully: keeps the socket
            except socket.timeout:        # reusable for the next request
                self._drop_conn()
                raise                     # possibly delivered: never retried
            except (http.client.HTTPException, ConnectionError, OSError):
                self._drop_conn()
                # ONE reconnect, only when it cannot double-execute: a
                # send-phase failure on a REUSED (stale keep-alive) socket
                # never reached the server, and GETs are idempotent.  A
                # POST that failed after sending propagates — the server
                # may already be acting on it.
                retriable = reused and (not sent or method == "GET")
                if attempt or not retriable:
                    raise
                continue
            if resp.will_close:
                self._drop_conn()
            if resp.status >= 400:
                raise urllib.error.HTTPError(
                    self.url + route, resp.status, resp.reason,
                    resp.headers, io.BytesIO(data))
            return data
        raise RuntimeError("unreachable")  # pragma: no cover

    def post(self, route: str, body: dict) -> dict:
        return json.loads(self._request(
            "POST", route, json.dumps(body).encode()))

    def stream_lines(self, route: str, body: dict):
        """POST and yield newline-delimited JSON objects as they arrive
        (the chunked streaming responses ``_stream_json_lines`` sends).
        Uses a DEDICATED connection, not the keep-alive pool: a stream
        can outlive many pooled requests, and abandoning one mid-body
        must never leave a desynced socket behind for the next caller —
        closing the private connection also signals the server the
        client is gone (it cancels the work)."""
        cls = http.client.HTTPSConnection if self._https \
            else http.client.HTTPConnection
        conn = cls(self._host, self._port, timeout=self.timeout)
        try:
            conn.request("POST", self._base_path + route,
                         body=json.dumps(body).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            if resp.status >= 400:
                data = resp.read()
                raise urllib.error.HTTPError(
                    self.url + route, resp.status, resp.reason,
                    resp.headers, io.BytesIO(data))
            for line in resp:
                line = line.strip()
                if line:
                    yield json.loads(line)
        finally:
            conn.close()

    def get(self, route: str) -> dict:
        return json.loads(self._request("GET", route))

    def get_text(self, route: str) -> str:
        """Raw body fetch (the Prometheus /metrics exposition is not JSON)."""
        return self._request("GET", route).decode("utf-8")
