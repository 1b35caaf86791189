"""The port's HTTP plumbing (``utils/http.py``) against the JAX package's.

Keep-alive reuse and a stale-connection reconnect; the request cap and the
connection cap shed with 503 + ``Retry-After`` and count
``http_shed_total{scope}``; ``stream_lines`` reads the chunked NDJSON
stream; ``/metrics`` (text and JSON), ``/debug/flightrecorder`` and
``/debug/profile``; and one request sequence leaves the same ``http_*``
families, label sets and counts in the port's registry as in a JAX
server's.  Every wait has its own timeout of at most 30 s.
"""
import json
import socket
import threading
import urllib.error

import pytest

from deeplearning4j_tpu.observability import MetricsRegistry as JRegistry
from deeplearning4j_tpu.utils import http as jhttp
from deeplearning4j_tpu_torch.observability import (FlightRecorder,
                                                    MetricsRegistry,
                                                    set_flight_recorder)
from deeplearning4j_tpu_torch.observability import profiler as stepprof
from deeplearning4j_tpu_torch.utils import http as thttp

WAIT_S = 30.0


def _handler(base):
    """The same small routes on either package's ``JsonHandler``."""

    class Handler(base):
        hold = None        # an Event the /slow route waits on

        def do_GET(self):
            if self._serve_metrics():
                return
            if self._serve_flightrecorder():
                return
            if self._serve_profile():
                return
            route = self.path.rstrip("/")
            if route == "/ping":
                return self._json({"ok": True})
            if route == "/bye":
                # the server drops the socket after answering without
                # telling the client: its pooled connection goes stale
                self.close_connection = True
                return self._json({"ok": True})
            if route == "/slow":
                self.hold.wait(timeout=WAIT_S)
                return self._json({"ok": True})
            return self._json({"error": "not found"}, 404)

        def do_POST(self):
            route = self.path.rstrip("/")
            if route == "/echo":
                try:
                    body = self._read_json()
                except Exception as e:
                    return self._json({"error": str(e)}, 400)
                return self._json({"echo": body})
            if route == "/stream":
                n = self._read_json()["n"]
                self._stream_json_lines({"i": i} for i in range(n))
                return
            if route == "/boom":
                return self._json({"error": "boom"}, 500)
            # never reads the body: _json's keep-alive drain must
            return self._json({"error": "not found"}, 404)

    return Handler


def _server(mod, reg, **kw):
    return mod.BackgroundHttpServer(_handler(mod.JsonHandler),
                                    metrics_registry=reg, **kw).start()


def _wait_for(pred):
    done = threading.Event()
    for _ in range(int(WAIT_S / 0.01)):
        if pred():
            return True
        done.wait(0.01)
    return False


def test_keep_alive_reuse_and_stale_reconnect():
    reg = MetricsRegistry()
    server = _server(thttp, reg)
    client = thttp.JsonClient(f"http://127.0.0.1:{server.port}",
                              timeout=WAIT_S)
    try:
        assert client.get("/ping") == {"ok": True}
        conn = client._tls.conn
        assert conn is not None
        assert client.get("/ping") == {"ok": True}
        assert client._tls.conn is conn          # keep-alive: no redial
        # the server closes the idle socket: the pooled connection is
        # stale, and a GET reconnects once
        assert client.get("/bye") == {"ok": True}
        assert client._tls.conn is conn
        assert client.get("/ping") == {"ok": True}
        assert client._tls.conn is not conn
    finally:
        client.close()
        server.stop()


def test_request_cap_sheds_503_and_drains_the_body():
    reg = MetricsRegistry()
    gate = threading.Event()
    server = thttp.BackgroundHttpServer(
        _handler(thttp.JsonHandler), max_concurrent=1,
        metrics_registry=reg, hold=gate).start()
    url = f"http://127.0.0.1:{server.port}"
    first = []
    t = threading.Thread(target=lambda: first.append(
        thttp.JsonClient(url, timeout=WAIT_S).get("/slow")))
    try:
        t.start()
        assert _wait_for(lambda: reg.get("http_inflight_requests") is not
                         None and reg.get("http_inflight_requests").value
                         >= 1)
        shed_client = thttp.JsonClient(url, timeout=WAIT_S)
        with pytest.raises(urllib.error.HTTPError) as ei:
            shed_client.post("/p", {"data": list(range(100))})
        assert ei.value.code == 503
        assert int(ei.value.headers["Retry-After"]) >= 1
        conn = shed_client._tls.conn
        gate.set()
        t.join(timeout=WAIT_S)
        assert not t.is_alive() and first == [{"ok": True}]
        # the same pooled connection serves the next request cleanly
        with pytest.raises(urllib.error.HTTPError) as ei:
            shed_client.post("/p", {"data": [1]})
        assert ei.value.code == 404
        assert shed_client._tls.conn is conn
        shed = reg.get("http_shed_total")
        assert shed.labels("request").value == 1
        assert reg.get("http_inflight_requests").value == 0
    finally:
        gate.set()
        server.stop()


def test_connection_cap_sheds_at_the_socket():
    reg = MetricsRegistry()
    gate = threading.Event()
    server = thttp.BackgroundHttpServer(
        _handler(thttp.JsonHandler), max_concurrent=1, max_connections=1,
        metrics_registry=reg, hold=gate).start()
    url = f"http://127.0.0.1:{server.port}"
    t = threading.Thread(target=lambda: thttp.JsonClient(
        url, timeout=WAIT_S).get("/slow"))
    try:
        t.start()
        assert _wait_for(lambda: reg.get("http_inflight_requests") is not
                         None and reg.get("http_inflight_requests").value
                         >= 1)
        with socket.create_connection(("127.0.0.1", server.port),
                                      timeout=WAIT_S) as s:
            s.sendall(b"GET /ping HTTP/1.1\r\nHost: x\r\n\r\n")
            raw = b""
            while True:
                chunk = s.recv(4096)
                if not chunk:
                    break
                raw += chunk
        head, _, body = raw.partition(b"\r\n\r\n")
        assert head.startswith(b"HTTP/1.1 503")
        assert b"Retry-After: 1" in head
        assert json.loads(body) == {"error": "server at concurrency cap"}
        assert reg.get("http_shed_total").labels("connection").value == 1
    finally:
        gate.set()
        t.join(timeout=WAIT_S)
        server.stop()


def test_stream_lines_reads_chunked_ndjson():
    server = _server(thttp, MetricsRegistry())
    client = thttp.JsonClient(f"http://127.0.0.1:{server.port}",
                              timeout=WAIT_S)
    try:
        assert list(client.stream_lines("/stream", {"n": 4})) == [
            {"i": 0}, {"i": 1}, {"i": 2}, {"i": 3}]
        assert list(client.stream_lines("/stream", {"n": 0})) == []
        with pytest.raises(urllib.error.HTTPError) as ei:
            list(client.stream_lines("/nope", {"n": 1}))
        assert ei.value.code == 404
        # the pooled connection is untouched by the dedicated stream ones
        assert client.get("/ping") == {"ok": True}
    finally:
        server.stop()


def test_metrics_flightrecorder_and_profile_routes(tmp_path):
    reg = MetricsRegistry()
    server = _server(thttp, reg)
    client = thttp.JsonClient(f"http://127.0.0.1:{server.port}",
                              timeout=WAIT_S)
    saved = set_flight_recorder(None)
    try:
        client.get("/ping")
        text = client.get_text("/metrics")
        assert "# TYPE http_request_seconds histogram" in text
        assert ('http_requests_total{code="200",method="GET",'
                'route="/ping"} 1') in text
        snap = client.get("/metrics?format=json")
        assert snap["http_request_seconds"]["type"] == "histogram"
        # no recorder installed: both forensics routes answer 503
        for route in ("/debug/flightrecorder", "/debug/profile"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                client.get(route)
            assert ei.value.code == 503
        rec = FlightRecorder(directory=str(tmp_path), registry=reg)
        set_flight_recorder(rec)
        rec.record("serving", "dispatch", rows=2)
        view = client.get("/debug/flightrecorder")
        assert view["channels"]["serving"][0]["rows"] == 2
        dumped = client.get("/debug/flightrecorder?dump=1")
        assert dumped["ok"] is True and dumped["path"].startswith(
            str(tmp_path))
        # ?dump=0 stays the live view
        assert "channels" in client.get("/debug/flightrecorder?dump=0")
        stepprof.record_slices("serve", queue_wait_s=0.001,
                               batch_form_s=0.002, execute_s=0.003,
                               batch=1, bucket=1, compile=False)
        prof = client.get("/debug/profile")
        assert prof["records"][-1]["type"] == "serve"
        assert "summary" in prof
        assert client.get("/debug/profile?dump=1")["ok"] is True
    finally:
        set_flight_recorder(saved)
        server.stop()


def _series(snapshot):
    """name -> sorted (labels, count-or-value) of every http_* series;
    histograms by their count (the seconds differ run to run)."""
    out = {}
    for name, m in snapshot.items():
        if not name.startswith("http_"):
            continue
        rows = []
        for s in m["samples"]:
            labels = tuple(sorted(s["labels"].items()))
            rows.append((labels, s["count"] if m["type"] == "histogram"
                         else s["value"]))
        out[name] = (m["type"], sorted(rows))
    return out


def _sequence(mod, reg):
    server = _server(mod, reg)
    client = mod.JsonClient(f"http://127.0.0.1:{server.port}",
                            timeout=WAIT_S)
    try:
        client.get("/ping")
        client.get("/ping/")
        client.post("/echo", {"a": 1})
        for route, raw in (("/echo", b"{not json"), ("/boom", b"{}"),
                           ("/missing", b"{}")):
            with pytest.raises(urllib.error.HTTPError):
                client._request("POST", route, raw)
        with pytest.raises(urllib.error.HTTPError):
            client.get("/nowhere?x=1")
        list(client.stream_lines("/stream", {"n": 2}))
        client.get_text("/metrics")
        client.get("/metrics?format=json")
    finally:
        server.stop()
    return _series(reg.snapshot())


def test_http_families_and_route_labels_match_the_jax_server():
    mine = _sequence(thttp, MetricsRegistry())
    ref = _sequence(jhttp, JRegistry())
    assert set(mine) == {"http_requests_total", "http_request_seconds",
                         "http_errors_total", "http_inflight_requests"}
    assert mine == ref
