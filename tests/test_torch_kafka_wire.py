"""The port's Kafka wire (``streaming/kafka_wire.py``) against the JAX
package's: frames byte for byte, CRC-32C on its native and Python paths,
every request and response of a client session byte for byte, and
traffic across the packages over real sockets (the port's client on the
JAX broker and the JAX client on the port's broker), including a group
consumer that resumes across instances and one hard-killed in a
subprocess."""
import gzip
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.streaming import kafka_wire as jkw
from deeplearning4j_tpu_torch.streaming import kafka_wire as tkw
from deeplearning4j_tpu_torch.streaming.codec import serialize_array
from deeplearning4j_tpu_torch.utils import native

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def fixed_gzip_mtime(monkeypatch):
    """gzip headers carry the clock's seconds: pin them so two encodes
    may be compared byte for byte."""
    monkeypatch.setattr(gzip.time, "time", lambda: 1_700_000_000.0)


def test_crc32c_native_twin_and_jax_agree():
    assert native.available()          # g++ builds the codec here
    check = b"123456789"               # the CRC-32C check value
    assert tkw.crc32c(check) == native.crc32c(check, use_native=False) \
        == 0xE3069283
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 8, 9, 63, 1000, 4099):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        want = jkw._crc32c_py(data)
        assert tkw.crc32c(data) == want == jkw.crc32c(data)
        assert native.crc32c(data, use_native=False) == want
        # a running value continues across pieces
        assert tkw.crc32c(data[n // 2:], tkw.crc32c(data[:n // 2])) == want


@pytest.mark.parametrize("n", [0, 1, 63, 64, 300, 1 << 20, -1, -65,
                               -(1 << 40), (1 << 62)])
def test_varints_equal(n):
    enc = tkw._varint(n)
    assert enc == jkw._varint(n)
    assert tkw._read_varint(enc + b"\x07", 0) == (n, len(enc))


@pytest.mark.parametrize("compression", [None, "gzip"])
def test_frames_byte_for_byte(compression, fixed_gzip_mtime):
    values = [b"hello", b"", b"z" * 700, bytes(range(256))]
    assert tkw.encode_message_set(values, 5) == \
        jkw.encode_message_set(values, 5)
    mine = tkw.encode_record_batch(values, 9, compression=compression)
    assert mine == jkw.encode_record_batch(values, 9,
                                           compression=compression)
    want = [(9 + i, v) for i, v in enumerate(values)]
    assert tkw.decode_record_batches(mine) == want
    assert jkw.decode_record_batches(mine) == want
    ms = tkw.encode_message_set(values, 5)
    assert tkw.decode_message_set(ms) == jkw.decode_message_set(ms)
    # a gzip envelope (legacy v0 compression) unwraps one level in both
    env = _gzip_envelope(tkw.encode_message_set([b"a", b"b"]))
    assert tkw.decode_message_set(env) == jkw.decode_message_set(env)
    bad = bytearray(mine)
    bad[-1] ^= 0xFF
    for mod in (tkw, jkw):
        with pytest.raises(ValueError, match="CRC32C"):
            mod.decode_record_batches(bytes(bad))


def _gzip_envelope(inner: bytes) -> bytes:
    body = struct.pack(">bb", 0, 1) + jkw._bytes(None) + \
        jkw._bytes(gzip.compress(inner))
    import zlib
    msg = struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF) + body
    return struct.pack(">qi", 0, len(msg)) + msg


def _torn(mod):
    comp = bytearray(mod.encode_record_batch([b"z" * 300],
                                             compression="gzip"))
    comp = comp[:-10]
    struct.pack_into(">i", comp, 8, len(comp) - 12)
    struct.pack_into(">I", comp, 12 + 5, mod.crc32c(bytes(comp[12 + 9:])))
    return bytes(comp)


def _bomb(mod):
    bomb = gzip.compress(b"\x00" * (100 << 20), compresslevel=1)
    batch = bytearray(mod.encode_record_batch([b"x"], compression="gzip"))
    header_len = 12 + 9 + struct.calcsize(">hiqqqhii")
    batch = batch[:header_len] + bomb
    struct.pack_into(">i", batch, 8, len(batch) - 12)
    struct.pack_into(">I", batch, 12 + 5, mod.crc32c(bytes(batch[12 + 9:])))
    return bytes(batch)


@pytest.mark.parametrize("make,match", [(_torn, "gzip"),
                                        (_bomb, "expands past")])
def test_torn_and_bomb_gzip_raise_the_same_valueerror(make, match):
    data = make(tkw)
    errors = []
    for mod in (tkw, jkw):
        with pytest.raises(ValueError, match=match) as ei:
            mod.decode_record_batches(data)
        errors.append(str(ei.value))
    assert errors[0] == errors[1]


class _Loop:
    """A socket stand-in that hands each request frame to a broker's
    ``_dispatch`` and records both sides."""

    def __init__(self, broker):
        self.broker = broker
        self.buf = b""
        self.log = []

    def sendall(self, data):
        req = data[4:]
        resp = self.broker._dispatch(req)
        self.log.append((req, resp))
        self.buf += struct.pack(">i", len(resp)) + resp

    def recv(self, n):                 # the JAX client's read
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def recv_into(self, view, n):      # the port's
        out = self.recv(n)
        view[:len(out)] = out
        return len(out)

    def close(self):
        pass


def _session(mod, broker_mod):
    broker = broker_mod.MiniKafkaBroker()
    broker._server.server_address = ("127.0.0.1", 9092)
    loop = _Loop(broker)
    c = mod.KafkaWireClient("127.0.0.1", 9092)
    c._sock = loop
    try:
        out = [c.produce("t", 0, [b"a", b"bb"]), c.fetch("t", 0, 0)]
        c.negotiate()
        out += [c.produce("t", 0, [b"c" * 200], compression="gzip"),
                c.produce("t", 0, [b"d", b"e"]), c.fetch("t", 0, 1),
                c.fetch("t", 0, 5), c.metadata(), c.metadata("t", "nope"),
                c.find_coordinator("g"), c.offset_fetch("g", "t", 0)]
        c.offset_commit("g", "t", 0, 3, metadata="m")
        out += [c.offset_fetch("g", "t", 0), c.list_offsets("t", 0),
                c.list_offsets("t", 0, timestamp=-2), c.api_versions()]
        with pytest.raises(IOError, match="error code 3"):
            c.list_offsets("nope", 0)
        with pytest.raises(IOError, match="fetch error code 1"):
            c.fetch("t", 0, 9)         # past the high watermark
    finally:
        broker._server.server_close()
    return out, loop.log


def test_a_client_session_is_byte_for_byte_the_jax_one(fixed_gzip_mtime):
    want, want_log = _session(jkw, jkw)
    for client, broker in ((tkw, tkw), (tkw, jkw), (jkw, tkw)):
        got, log = _session(client, broker)
        assert got == want
        assert log == want_log         # every request and response frame


def _serve(mod):
    return mod.MiniKafkaBroker().start()


@pytest.mark.parametrize("client,broker", [(tkw, jkw), (jkw, tkw)],
                         ids=["port_client_jax_broker",
                              "jax_client_port_broker"])
def test_traffic_across_packages_over_sockets(client, broker):
    b = _serve(broker)
    try:
        pub = client.NDArrayKafkaClient("127.0.0.1", b.port, "arrays")
        arrays = [np.full((2, 3), i, np.float32) for i in range(10)]
        pub.publish_all(arrays[:5])
        for a in arrays[5:]:
            pub.publish(a)
        assert pub._client.produce_version == 3     # negotiated v2
        # a client that never negotiated reads the log as v0 message sets
        legacy = client.KafkaWireClient("127.0.0.1", b.port)
        assert legacy.fetch("arrays", 0, 8) == [
            (8 + i, serialize_array(a))
            for i, a in enumerate(arrays[8:])]
        legacy.close()
        first = client.NDArrayKafkaClient("127.0.0.1", b.port, "arrays",
                                          group_id="trainers")
        got = first.poll(max_items=4)
        assert [int(a[0, 0]) for a in got] == [0, 1, 2, 3]
        del first                      # no clean shutdown
        again = client.NDArrayKafkaClient("127.0.0.1", b.port, "arrays",
                                          group_id="trainers")
        rest = again.poll()
        assert [int(a[0, 0]) for a in rest] == list(range(4, 10))
        for a, w in zip(got + rest, arrays):
            np.testing.assert_array_equal(a, w)
        again.close()
        pub.close()
    finally:
        b.stop()


def test_port_client_publishes_a_tensor():
    b = _serve(jkw)
    try:
        pub = tkw.NDArrayKafkaClient("127.0.0.1", b.port, "t")
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        pub.publish(x)
        pub.publish_all([x + 1])
        sub = jkw.NDArrayKafkaClient("127.0.0.1", b.port, "t")
        got = sub.poll()
        np.testing.assert_array_equal(got[0], x.numpy())
        np.testing.assert_array_equal(got[1], x.numpy() + 1)
        sub.close()
        pub.close()
    finally:
        b.stop()


def test_group_consumer_killed_subprocess_resumes():
    """A consumer process of the port, hard-killed after its first
    committed poll (no close, no commit), restarts and drains the rest:
    each array consumed exactly once."""
    broker = _serve(tkw)
    try:
        pub = tkw.NDArrayKafkaClient("127.0.0.1", broker.port, "arrays")
        pub.publish_all([np.full((2,), i, np.float32) for i in range(9)])
        prog = (
            "import os, sys\n"
            "from deeplearning4j_tpu_torch.streaming.kafka_wire import "
            "NDArrayKafkaClient\n"
            "c = NDArrayKafkaClient('127.0.0.1', {port}, 'arrays', "
            "group_id='proc')\n"
            "got = c.poll(max_items={n})\n"
            "print(' '.join(str(int(a[0])) for a in got), flush=True)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'torch', 'deeplearning4j_tpu')), flush=True)\n"
            "os._exit(9)\n")
        env = dict(os.environ, PYTHONPATH=str(REPO))
        outs = []
        for n in (3, 99):
            r = subprocess.run(
                [sys.executable, "-c", prog.format(port=broker.port, n=n)],
                capture_output=True, text=True, timeout=120, env=env)
            assert r.returncode == 9, r.stderr
            ids, loaded = r.stdout.splitlines()
            assert loaded == "[]"      # no jax, no torch in the consumer
            outs.append([int(t) for t in ids.split()])
        assert outs == [[0, 1, 2], [3, 4, 5, 6, 7, 8]]
        pub.close()
    finally:
        broker.stop()


def test_a_frame_is_read_into_one_buffer():
    """The port reads a frame with ``recv_into`` into one buffer (the JAX
    client's ``buf += chunk`` is quadratic in the frame); the same bytes
    arrive, in whatever chunks the socket hands out."""
    frame = np.random.default_rng(5).integers(
        0, 256, 3 << 20, dtype=np.uint8).tobytes()

    class Chunky:
        calls = 0

        def __init__(self):
            self.left = frame

        def recv_into(self, view, n):
            Chunky.calls += 1
            k = min(n, 65536, len(self.left))
            view[:k] = self.left[:k]
            self.left = self.left[k:]
            return k

    got = tkw.KafkaWireClient._recv_n(Chunky(), len(frame))
    assert got == frame and type(got) is bytes
    assert Chunky.calls == len(frame) // 65536
    closed = Chunky()
    closed.left = b""
    with pytest.raises(ConnectionError, match="closed"):
        tkw.KafkaWireClient._recv_n(closed, 4)
