"""Kafka wire-protocol client + dev broker, message formats v0 and v2
(port of ``streaming/kafka_wire.py``, which imports no JAX: host code,
the same frames byte for byte).

Reference ``dl4j-streaming/.../streaming/kafka/NDArrayKafkaClient.java``
talks to a real Kafka cluster through the Kafka client library.  This
module implements the **Kafka binary protocol** over stdlib sockets, so
the framework can interoperate with a real broker, and ships
``MiniKafkaBroker``, an in-process single-node broker speaking the same
frames, for dev rigs and tests (``LocalMessageBroker``/
``TcpMessageBroker`` in ``broker.py`` remain the non-Kafka transports).
A client of either package talks to a broker of the other.

One deliberate difference: CRC-32C comes from the port's native codec
library (``utils/native.crc32c``, ``dl4j_crc32c`` in
``csrc/host_codec.cpp``), with the JAX package's bytewise table loop as
its twin where the library cannot be built.  The JAX module takes
``google_crc32c`` when it is installed and that loop, ~1000x slower,
otherwise; the port never imports ``google_crc32c``.  Two more:
``NDArrayKafkaClient.publish`` also takes a torch tensor on any device
(``ndarray_client.host_array``: one device-to-host copy), and a frame is
read into one buffer with ``recv_into`` (``KafkaWireClient._recv_n``,
which the broker's handler shares), where the JAX code appends chunk by
chunk and copies the frame once a chunk: quadratic, past reach for the
~268 MB frame of a full-width LM's batch-16 probabilities.  The bytes on
the wire are the same.

Two on-wire generations are supported:

- **v0 message sets** (Produce v0 / Fetch v0, CRC32): the legacy format —
  removed from Apache Kafka 4.0, kept here for the mini-broker and old
  clusters.
- **v2 record batches** (Produce v3 / Fetch v4): varint+zigzag records,
  CRC32C (Castagnoli) over the batch, the format every broker since 0.11
  speaks and the only one after Kafka 4.0.  ``KafkaWireClient.negotiate()``
  runs ApiVersions (api_key 18) and picks the newest mutually supported
  produce/fetch pair automatically.

Protocol framing (Kafka protocol guide):
  request  = int32 size | int16 api_key | int16 api_version
             | int32 correlation_id | string client_id | body
  v0 message     = int32 crc | int8 magic(0) | int8 attrs | bytes key
                   | bytes value   (crc = CRC32 over magic..value)
  v2 recordbatch = int64 base_offset | int32 length | int32 leader_epoch
                   | int8 magic(2) | uint32 crc32c | int16 attrs
                   | int32 last_offset_delta | int64 base/max_timestamp
                   | int64 producer_id | int16 producer_epoch
                   | int32 base_sequence | int32 n_records | records
                   (crc32c covers attrs..records)
"""
from __future__ import annotations

import gzip
import socket
import socketserver
import struct
import threading
import zlib
from typing import Dict, List, Optional, Tuple

# CRC-32C (Castagnoli), the v2 record-batch checksum: the native codec's
# where the library loads, its bytewise table loop otherwise
from ..utils.native import crc32c

__all__ = ["KafkaWireClient", "MiniKafkaBroker", "NDArrayKafkaClient"]

_API_PRODUCE = 0
_API_FETCH = 1
_API_LIST_OFFSETS = 2
_API_METADATA = 3
_API_OFFSET_COMMIT = 8
_API_OFFSET_FETCH = 9
_API_FIND_COORDINATOR = 10
_API_VERSIONS = 18

# what the mini-broker advertises via ApiVersions (both generations)
_BROKER_API_VERSIONS = {_API_PRODUCE: (0, 3), _API_FETCH: (0, 4),
                        _API_LIST_OFFSETS: (0, 0), _API_METADATA: (0, 0),
                        _API_OFFSET_COMMIT: (0, 0), _API_OFFSET_FETCH: (0, 0),
                        _API_FIND_COORDINATOR: (0, 0), _API_VERSIONS: (0, 0)}


# ------------------------------------------------------------------ varints
def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _varint(n: int) -> bytes:
    """Zigzag varint (Kafka records use zigzag for all varint fields)."""
    u = _zigzag(n)
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(data: bytes, off: int) -> Tuple[int, int]:
    shift, u = 0, 0
    while True:
        b = data[off]
        off += 1
        u |= (b & 0x7F) << shift
        if not b & 0x80:
            return _unzigzag(u), off
        shift += 7


# ---------------------------------------------------------------- primitives
def _str(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def _bytes(b: Optional[bytes]) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def take(self, fmt: str):
        vals = struct.unpack_from(">" + fmt, self.data, self.off)
        self.off += struct.calcsize(">" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def string(self) -> str:
        n = self.take("h")
        if n < 0:            # nullable string: no payload bytes follow
            return ""
        s = self.data[self.off:self.off + n].decode()
        self.off += n
        return s

    def bytes_(self) -> Optional[bytes]:
        n = self.take("i")
        if n < 0:
            return None
        b = self.data[self.off:self.off + n]
        self.off += n
        return b


# ------------------------------------------------------------- message sets
def encode_message(value: bytes, key: Optional[bytes] = None) -> bytes:
    body = struct.pack(">bb", 0, 0) + _bytes(key) + _bytes(value)
    crc = zlib.crc32(body) & 0xFFFFFFFF
    return struct.pack(">I", crc) + body


def encode_message_set(values: List[bytes],
                       base_offset: int = 0) -> bytes:
    out = b""
    for i, v in enumerate(values):
        msg = encode_message(v)
        out += struct.pack(">qi", base_offset + i, len(msg)) + msg
    return out


def decode_message_set(data: bytes, _depth: int = 0) -> List[Tuple[int, bytes]]:
    """[(offset, value)] — raises on CRC mismatch (torn/corrupt message).
    gzip wrapper envelopes (legacy v0 compression) unwrap ONE level — real
    producers never nest them, and unbounded recursion on crafted input
    would escape as RecursionError."""
    out: List[Tuple[int, bytes]] = []
    off = 0
    while off + 12 <= len(data):
        offset, size = struct.unpack_from(">qi", data, off)
        off += 12
        if off + size > len(data):
            break  # partial trailing message (Kafka semantics: ignore)
        msg = data[off:off + size]
        off += size
        crc = struct.unpack_from(">I", msg, 0)[0]
        if zlib.crc32(msg[4:]) & 0xFFFFFFFF != crc:
            raise ValueError(f"message at offset {offset}: CRC mismatch")
        r = _Reader(msg)
        r.take("I")          # crc
        _magic, attrs = r.take("bb")
        codec = attrs & 0x07
        if codec not in (_CODEC_NONE, _CODEC_GZIP):
            raise ValueError(
                f"message at offset {offset}: "
                f"{_CODEC_NAMES.get(codec, codec)}-compressed message sets "
                "are not supported (the wire code decodes gzip only)")
        r.bytes_()           # key
        value = r.bytes_()
        if codec == _CODEC_GZIP:
            if _depth:
                raise ValueError(f"message at offset {offset}: nested "
                                 "compression envelopes are not valid")
            inner = _gunzip_or_raise(value or b"",
                                     f"message at offset {offset}")
            out.extend(decode_message_set(inner, _depth=1))
        else:
            out.append((offset, value or b""))
    return out


_MAX_GUNZIP = 1 << 26   # 64 MiB expansion cap — gzip-bomb guard


def _gunzip_or_raise(payload: bytes, what: str) -> bytes:
    """Bounded gzip decompression with torn/corrupt streams normalized to
    the decoder's ValueError contract (EOFError/zlib.error otherwise
    escape the broker's malformed-request guard).  The expansion cap stops
    a small crafted bomb from materializing gigabytes before record
    parsing ever runs."""
    try:
        d = zlib.decompressobj(wbits=31)          # gzip wrapper
        out = d.decompress(payload, _MAX_GUNZIP)
        if d.unconsumed_tail:
            raise ValueError(f"{what}: gzip payload expands past "
                             f"{_MAX_GUNZIP} bytes")
        if not d.eof:
            raise ValueError(f"{what}: corrupt gzip payload "
                             "(truncated stream)")
        return out
    except (EOFError, OSError, zlib.error) as e:
        raise ValueError(f"{what}: corrupt gzip payload ({e})")


# ------------------------------------------------------- v2 record batches
def _encode_record(offset_delta: int, value: bytes,
                   key: Optional[bytes] = None) -> bytes:
    body = (b"\x00"                       # record attributes
            + _varint(0)                  # timestamp delta
            + _varint(offset_delta)
            + (_varint(-1) if key is None
               else _varint(len(key)) + key)
            + _varint(len(value)) + value
            + _varint(0))                 # headers count
    return _varint(len(body)) + body


_CODEC_NONE, _CODEC_GZIP = 0, 1
_CODEC_NAMES = {0: "none", 1: "gzip", 2: "snappy", 3: "lz4", 4: "zstd"}


def encode_record_batch(values: List[bytes], base_offset: int = 0,
                        compression: Optional[str] = None) -> bytes:
    """One v2 RecordBatch holding ``values`` (no producer id).

    ``compression="gzip"`` compresses the records section and sets the
    codec bits in attributes (KIP-98 batch format: the batch header stays
    uncompressed, CRC32C covers attributes..compressed-records)."""
    if compression not in (None, "none", "gzip"):
        raise ValueError(f"unsupported compression {compression!r} "
                         "(stdlib provides gzip; snappy/lz4/zstd would need "
                         "packages the port does not use)")
    records = b"".join(_encode_record(i, v) for i, v in enumerate(values))
    attrs = _CODEC_NONE
    if compression == "gzip":
        records = gzip.compress(records)
        attrs = _CODEC_GZIP
    after_crc = (struct.pack(">hiqqqhii", attrs, len(values) - 1, 0, 0,
                             -1, -1, -1, len(values))
                 + records)
    crc = crc32c(after_crc)
    batch_tail = struct.pack(">ibI", 0, 2, crc) + after_crc
    #                        leader_epoch, magic, crc32c
    return struct.pack(">qi", base_offset, len(batch_tail)) + batch_tail


def decode_record_batches(data: bytes) -> List[Tuple[int, bytes]]:
    """[(offset, value)] from a sequence of v2 RecordBatches — raises on
    CRC32C mismatch; partial trailing batches ignored (Kafka semantics)."""
    out: List[Tuple[int, bytes]] = []
    off = 0
    while off + 12 <= len(data):
        base_offset, length = struct.unpack_from(">qi", data, off)
        if off + 12 + length > len(data):
            break                          # partial trailing batch
        _epoch, magic, crc = struct.unpack_from(">ibI", data, off + 12)
        if magic != 2:
            raise ValueError(f"record batch at {base_offset}: magic {magic}"
                             " (expected 2) — use decode_message_set for v0")
        body_off = off + 12 + 9            # past leader_epoch+magic+crc
        body = data[body_off:off + 12 + length]
        if crc32c(body) != crc:
            raise ValueError(
                f"record batch at {base_offset}: CRC32C mismatch")
        (attrs, _last_delta, _bts, _mts, _pid, _pepoch, _bseq,
         n_records) = struct.unpack_from(">hiqqqhii", body, 0)
        codec = attrs & 0x07
        p = struct.calcsize(">hiqqqhii")
        if codec == _CODEC_GZIP:
            recs = _gunzip_or_raise(
                body[p:], f"record batch at {base_offset}")
            p = 0
        elif codec == _CODEC_NONE:
            recs = body
        else:
            raise ValueError(
                f"record batch at {base_offset}: "
                f"{_CODEC_NAMES.get(codec, codec)}-compressed batches are "
                "not supported (the wire code decodes gzip only)")
        for _ in range(n_records):
            rec_len, p = _read_varint(recs, p)
            end = p + rec_len
            p += 1                         # record attributes
            _ts, p = _read_varint(recs, p)
            odelta, p = _read_varint(recs, p)
            klen, p = _read_varint(recs, p)
            if klen >= 0:
                p += klen
            vlen, p = _read_varint(recs, p)
            value = recs[p:p + vlen] if vlen >= 0 else b""
            out.append((base_offset + odelta, value))
            p = end                        # skip headers
        off += 12 + length
    return out


# ------------------------------------------------------------------ client
class KafkaWireClient:
    """Minimal Kafka client: produce/fetch/metadata against one broker.
    Requests go to the bootstrap broker; ``metadata()`` reports the real
    partition leaders so callers can verify the single-node assumption
    (cross-broker routing itself stays out of scope)."""

    def __init__(self, host: str, port: int, client_id: str = "dl4j-tpu",
                 timeout: float = 10.0):
        self.addr = (host, port)
        self.client_id = client_id
        self.timeout = timeout
        self._corr = 0
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        # wire generation: (0, 0) = legacy message sets; negotiate() raises
        # these to (3, 4) = v2 record batches when the broker allows
        self.produce_version = 0
        self.fetch_version = 0

    def _connect(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(self.addr, self.timeout)
        return self._sock

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def _roundtrip(self, api_key: int, body: bytes,
                   api_version: int = 0) -> _Reader:
        with self._lock:
            self._corr += 1
            corr = self._corr
            req = (struct.pack(">hhi", api_key, api_version, corr)
                   + _str(self.client_id) + body)
            try:
                sock = self._connect()
                sock.sendall(struct.pack(">i", len(req)) + req)
                raw = self._recv_frame(sock)
            except Exception:
                # a timeout / partial read leaves the stream desynced —
                # drop the socket so the next call reconnects cleanly
                self.close()
                raise
        r = _Reader(raw)
        got = r.take("i")
        if got != corr:
            self.close()
            raise IOError(f"correlation id mismatch: sent {corr} got {got}")
        return r

    def _recv_frame(self, sock: socket.socket) -> bytes:
        hdr = self._recv_n(sock, 4)
        (n,) = struct.unpack(">i", hdr)
        return self._recv_n(sock, n)

    @staticmethod
    def _recv_n(sock: socket.socket, n: int) -> bytes:
        """Exactly ``n`` bytes, read into one buffer (linear in ``n``; the
        JAX code's ``buf += chunk`` copies the frame once a chunk)."""
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            k = sock.recv_into(view[got:], n - got)
            if not k:
                raise ConnectionError("broker closed the connection")
            got += k
        return bytes(buf)

    def api_versions(self) -> Dict[int, Tuple[int, int]]:
        """ApiVersions (api_key 18): {api_key: (min, max)} the broker
        supports — the capability handshake every modern client starts with."""
        r = self._roundtrip(_API_VERSIONS, b"")
        err = r.take("h")
        if err:
            raise IOError(f"api_versions error code {err}")
        out: Dict[int, Tuple[int, int]] = {}
        for _ in range(r.take("i")):
            key, lo, hi = r.take("h"), r.take("h"), r.take("h")
            out[key] = (lo, hi)
        return out

    def metadata(self, *topics: str):
        """Metadata v0 (api_key 3): the cluster's brokers and, per topic,
        the leader node of every partition.  No ``topics`` = all topics.
        Returns ``{"brokers": [(node_id, host, port)], "topics": {name:
        {"error": code, "partitions": {partition: leader_node_id}}}}`` —
        the round that lets a client CHECK the bootstrap-is-leader
        assumption instead of assuming it."""
        body = struct.pack(">i", len(topics))
        for t in topics:
            body += _str(t)
        r = self._roundtrip(_API_METADATA, body)
        brokers = []
        for _ in range(r.take("i")):
            node = r.take("i")
            host = r.string()
            brokers.append((node, host, r.take("i")))
        out = {"brokers": brokers, "topics": {}}
        for _ in range(r.take("i")):
            terr = r.take("h")
            name = r.string()
            parts: Dict[int, int] = {}
            for _ in range(r.take("i")):
                _perr, pid, leader = r.take("h"), r.take("i"), r.take("i")
                for _ in range(r.take("i")):
                    r.take("i")               # replicas
                for _ in range(r.take("i")):
                    r.take("i")               # isr
                parts[pid] = leader
            out["topics"][name] = {"error": terr, "partitions": parts}
        return out

    def negotiate(self) -> "KafkaWireClient":
        """Pick the newest mutually supported produce/fetch generation:
        v2 record batches (Produce 3 / Fetch 4) when the broker allows,
        legacy message sets otherwise."""
        versions = self.api_versions()
        if versions.get(_API_PRODUCE, (0, 0))[1] >= 3:
            self.produce_version = 3
        if versions.get(_API_FETCH, (0, 0))[1] >= 4:
            self.fetch_version = 4
        return self

    def produce(self, topic: str, partition: int, values: List[bytes],
                compression: Optional[str] = None) -> int:
        """Append messages; returns the base offset assigned.  Encodes a v2
        RecordBatch after ``negotiate()`` (produce_version 3), a v0 message
        set otherwise.  ``compression="gzip"`` compresses the v2 records
        section (legacy message sets stay uncompressed — use the modern
        path for compressed payloads)."""
        v3 = self.produce_version >= 3
        if compression not in (None, "none") and not v3:
            raise ValueError("compression requires the v2 record-batch "
                             "path — call negotiate() first")
        mset = encode_record_batch(values, compression=compression) if v3 \
            else encode_message_set(values)
        body = (struct.pack(">h", -1) if v3 else b"")  # transactional_id
        body += (struct.pack(">hi", 1, int(self.timeout * 1000))  # acks=1
                 + struct.pack(">i", 1) + _str(topic)
                 + struct.pack(">i", 1)
                 + struct.pack(">i", partition)
                 + struct.pack(">i", len(mset)) + mset)
        r = self._roundtrip(_API_PRODUCE, body,
                            api_version=self.produce_version)
        n_topics = r.take("i")
        assert n_topics == 1
        r.string()
        n_parts = r.take("i")
        assert n_parts == 1
        _part, err, base = r.take("i"), r.take("h"), r.take("q")
        if err:
            raise IOError(f"produce error code {err}")
        return base

    def fetch(self, topic: str, partition: int, offset: int,
              max_bytes: int = 1 << 20) -> List[Tuple[int, bytes]]:
        """[(offset, value)] from ``offset`` onward (may be empty).
        Decodes v2 record batches after ``negotiate()`` (fetch_version 4),
        v0 message sets otherwise."""
        v4 = self.fetch_version >= 4
        body = struct.pack(">iii", -1, 100, 0)
        if v4:
            body += struct.pack(">ib", max_bytes, 0)  # max_bytes, read_uncmt
        body += (struct.pack(">i", 1) + _str(topic)
                 + struct.pack(">i", 1)
                 + struct.pack(">iqi", partition, offset, max_bytes))
        r = self._roundtrip(_API_FETCH, body, api_version=self.fetch_version)
        if v4:
            r.take("i")                    # throttle_time_ms
        n_topics = r.take("i")
        assert n_topics == 1
        r.string()
        n_parts = r.take("i")
        assert n_parts == 1
        _part, err, _hw = r.take("i"), r.take("h"), r.take("q")
        if v4:
            r.take("q")                    # last_stable_offset
            n_aborted = r.take("i")
            for _ in range(max(n_aborted, 0)):
                r.take("qq")               # producer_id, first_offset
        if err:
            raise IOError(f"fetch error code {err}")
        size = r.take("i")
        mset = r.data[r.off:r.off + size]
        # dispatch on the stored magic byte, not the request version: real
        # brokers return whatever format the log holds (old segments stay
        # magic 0/1 even under Fetch v4)
        records = (decode_record_batches(mset)
                   if len(mset) > 16 and mset[16] == 2
                   else decode_message_set(mset))
        # real brokers return whole batches (indivisible on disk); drop the
        # records below the requested offset so consumers never see repeats
        return [(o, v) for o, v in records if o >= offset]

    # -- consumer-group offset management ---------------------------------
    # The reference consumes as a managed group (groupId in the Camel route
    # URI, DL4jServeRouteBuilder.java:55) so a restarted consumer resumes at
    # its committed offset.  These four rounds are that capability on the
    # wire: FindCoordinator locates the group's offset store, OffsetCommit/
    # OffsetFetch persist and recover positions, ListOffsets resolves the
    # log's earliest/latest watermarks for consumers with no commit yet.

    def find_coordinator(self, group_id: str) -> Tuple[int, str, int]:
        """FindCoordinator v0 (api_key 10): ``(node_id, host, port)`` of the
        broker coordinating ``group_id``'s offsets.  Single-node rigs always
        get the bootstrap broker back, but going through the round keeps the
        client correct against real clusters."""
        r = self._roundtrip(_API_FIND_COORDINATOR, _str(group_id))
        err = r.take("h")
        if err:
            raise IOError(f"find_coordinator error code {err}")
        node = r.take("i")
        host = r.string()
        return node, host, r.take("i")

    def offset_commit(self, group_id: str, topic: str, partition: int,
                      offset: int, metadata: str = "") -> None:
        """OffsetCommit v0 (api_key 8): durably record ``group_id``'s next
        read position for (topic, partition)."""
        body = (_str(group_id)
                + struct.pack(">i", 1) + _str(topic)
                + struct.pack(">i", 1)
                + struct.pack(">iq", partition, offset) + _str(metadata))
        r = self._roundtrip(_API_OFFSET_COMMIT, body)
        n_topics = r.take("i")
        assert n_topics == 1
        r.string()
        n_parts = r.take("i")
        assert n_parts == 1
        _part, err = r.take("i"), r.take("h")
        if err:
            raise IOError(f"offset_commit error code {err}")

    def offset_fetch(self, group_id: str, topic: str,
                     partition: int) -> int:
        """OffsetFetch v0 (api_key 9): the committed offset for
        ``group_id`` on (topic, partition), or -1 when the group has never
        committed there (Kafka's no-offset sentinel)."""
        body = (_str(group_id)
                + struct.pack(">i", 1) + _str(topic)
                + struct.pack(">i", 1) + struct.pack(">i", partition))
        r = self._roundtrip(_API_OFFSET_FETCH, body)
        n_topics = r.take("i")
        assert n_topics == 1
        r.string()
        n_parts = r.take("i")
        assert n_parts == 1
        _part, off = r.take("i"), r.take("q")
        r.string()                       # metadata
        err = r.take("h")
        if err:
            raise IOError(f"offset_fetch error code {err}")
        return off

    def list_offsets(self, topic: str, partition: int,
                     timestamp: int = -1) -> int:
        """ListOffsets v0 (api_key 2): the log's latest offset (timestamp
        -1, the high watermark = next offset to be assigned) or earliest
        (timestamp -2).  The round a group-less or never-committed consumer
        uses to choose its starting position."""
        body = (struct.pack(">i", -1)    # replica_id
                + struct.pack(">i", 1) + _str(topic)
                + struct.pack(">i", 1)
                + struct.pack(">iqi", partition, timestamp, 1))
        r = self._roundtrip(_API_LIST_OFFSETS, body)
        n_topics = r.take("i")
        assert n_topics == 1
        r.string()
        n_parts = r.take("i")
        assert n_parts == 1
        _part, err = r.take("i"), r.take("h")
        if err:
            raise IOError(f"list_offsets error code {err}")
        n_offsets = r.take("i")
        offsets = [r.take("q") for _ in range(n_offsets)]
        if not offsets:
            raise IOError("list_offsets returned no offsets")
        return offsets[0]


# ------------------------------------------------------------------ broker
class MiniKafkaBroker:
    """Single-node in-process broker speaking Produce v0 / Fetch v0 — the
    dev/test stand-in for a real cluster (role of an embedded Kafka in the
    reference's test rigs).  Logs live in memory per (topic, partition)."""

    def __init__(self, port: int = 0):
        self._logs: Dict[Tuple[str, int], List[bytes]] = {}
        # consumer-group offset store: (group, topic, partition) ->
        # (offset, metadata) — the __consumer_offsets topic's role
        self._offsets: Dict[Tuple[str, str, int], Tuple[int, str]] = {}
        self._lock = threading.Lock()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        raw = self._frame()
                        if raw is None:
                            return
                        try:
                            resp = outer._dispatch(raw)
                        except (ValueError, struct.error, IndexError):
                            # malformed/corrupt request: close the
                            # connection cleanly instead of a traceback
                            return
                        self.request.sendall(
                            struct.pack(">i", len(resp)) + resp)
                except (ConnectionError, OSError):
                    return

            def _frame(self):
                try:
                    hdr = KafkaWireClient._recv_n(self.request, 4)
                except ConnectionError:
                    return None
                (n,) = struct.unpack(">i", hdr)
                return KafkaWireClient._recv_n(self.request, n)

        self._server = socketserver.ThreadingTCPServer(("127.0.0.1", port),
                                                       Handler)
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "MiniKafkaBroker":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    # -- request dispatch -------------------------------------------------
    def _dispatch(self, raw: bytes) -> bytes:
        r = _Reader(raw)
        api_key, ver, corr = r.take("h"), r.take("h"), r.take("i")
        r.string()  # client_id
        if api_key == _API_PRODUCE:
            return struct.pack(">i", corr) + self._produce(r, ver)
        if api_key == _API_FETCH:
            return struct.pack(">i", corr) + self._fetch(r, ver)
        if api_key == _API_METADATA:
            return struct.pack(">i", corr) + self._metadata(r, ver)
        if api_key == _API_LIST_OFFSETS:
            return struct.pack(">i", corr) + self._list_offsets(r, ver)
        if api_key == _API_OFFSET_COMMIT:
            return struct.pack(">i", corr) + self._offset_commit(r, ver)
        if api_key == _API_OFFSET_FETCH:
            return struct.pack(">i", corr) + self._offset_fetch(r, ver)
        if api_key == _API_FIND_COORDINATOR:
            return struct.pack(">i", corr) + self._find_coordinator(r, ver)
        if api_key == _API_VERSIONS:
            return struct.pack(">i", corr) + self._api_versions()
        return struct.pack(">i", corr)

    def _find_coordinator(self, r: _Reader, ver: int) -> bytes:
        """FindCoordinator v0: a single-node broker coordinates every
        group itself."""
        if ver != 0:
            raise ValueError(f"find_coordinator v{ver} not supported")
        r.string()                                   # group_id
        host, port = self._server.server_address
        return (struct.pack(">h", 0) + struct.pack(">i", 0)
                + _str(host) + struct.pack(">i", port))

    def _offset_commit(self, r: _Reader, ver: int) -> bytes:
        if ver != 0:
            raise ValueError(f"offset_commit v{ver} not supported")
        group = r.string()
        out = b""
        n_topics = r.take("i")
        out += struct.pack(">i", n_topics)
        for _ in range(n_topics):
            topic = r.string()
            out += _str(topic)
            n_parts = r.take("i")
            out += struct.pack(">i", n_parts)
            for _ in range(n_parts):
                part, offset = r.take("i"), r.take("q")
                meta = r.string()
                with self._lock:
                    self._offsets[(group, topic, part)] = (offset, meta)
                out += struct.pack(">ih", part, 0)
        return out

    def _offset_fetch(self, r: _Reader, ver: int) -> bytes:
        if ver != 0:
            raise ValueError(f"offset_fetch v{ver} not supported")
        group = r.string()
        out = b""
        n_topics = r.take("i")
        out += struct.pack(">i", n_topics)
        for _ in range(n_topics):
            topic = r.string()
            out += _str(topic)
            n_parts = r.take("i")
            out += struct.pack(">i", n_parts)
            for _ in range(n_parts):
                part = r.take("i")
                with self._lock:
                    offset, meta = self._offsets.get(
                        (group, topic, part), (-1, ""))
                # no committed offset = offset -1, error 0 (Kafka contract)
                out += struct.pack(">iq", part, offset) + _str(meta)
                out += struct.pack(">h", 0)
        return out

    def _list_offsets(self, r: _Reader, ver: int) -> bytes:
        if ver != 0:
            raise ValueError(f"list_offsets v{ver} not supported")
        r.take("i")                                  # replica_id
        out = b""
        n_topics = r.take("i")
        out += struct.pack(">i", n_topics)
        for _ in range(n_topics):
            topic = r.string()
            out += _str(topic)
            n_parts = r.take("i")
            out += struct.pack(">i", n_parts)
            for _ in range(n_parts):
                part, ts = r.take("i"), r.take("q")
                r.take("i")                          # max_num_offsets
                with self._lock:
                    known = (topic, part) in self._logs
                    high = len(self._logs.get((topic, part), ()))
                if not known:
                    # error 3: UNKNOWN_TOPIC_OR_PARTITION, empty offsets
                    out += struct.pack(">ihi", part, 3, 0)
                    continue
                offset = 0 if ts == -2 else high     # -2 earliest, -1 latest
                out += struct.pack(">ihi", part, 0, 1)
                out += struct.pack(">q", offset)
        return out

    def _metadata(self, r: _Reader, ver: int) -> bytes:
        """Metadata v0: this single node is broker 0 and leads every
        partition it has a log for; unknown requested topics answer
        error 3 (UNKNOWN_TOPIC_OR_PARTITION) rather than auto-creating.
        v1+ layouts differ (controller_id, racks) — close cleanly instead
        of serving a v0 body a v1 parser would silently desync on."""
        if ver != 0:
            raise ValueError(f"metadata v{ver} not supported")
        wanted = [r.string() for _ in range(r.take("i"))]
        host, port = self._server.server_address
        out = struct.pack(">i", 1)                      # one broker
        out += struct.pack(">i", 0) + _str(host) + struct.pack(">i", port)
        with self._lock:
            known: Dict[str, List[int]] = {}
            for (topic, part) in self._logs:
                known.setdefault(topic, []).append(part)
        names = wanted or sorted(known)
        out += struct.pack(">i", len(names))
        for name in names:
            parts = sorted(known.get(name, ()))
            err = 0 if parts else 3     # UNKNOWN_TOPIC_OR_PARTITION
            out += struct.pack(">h", err) + _str(name)
            out += struct.pack(">i", len(parts))
            for pid in parts:
                out += struct.pack(">hii", 0, pid, 0)   # leader: node 0
                out += struct.pack(">ii", 1, 0)         # replicas [0]
                out += struct.pack(">ii", 1, 0)         # isr [0]
        return out

    @staticmethod
    def _api_versions() -> bytes:
        out = struct.pack(">hi", 0, len(_BROKER_API_VERSIONS))
        for key, (lo, hi) in sorted(_BROKER_API_VERSIONS.items()):
            out += struct.pack(">hhh", key, lo, hi)
        return out

    def _produce(self, r: _Reader, ver: int) -> bytes:
        if ver >= 3:
            r.string()   # transactional_id (nullable string)
        r.take("h")  # acks
        r.take("i")  # timeout
        out = b""
        n_topics = r.take("i")
        out += struct.pack(">i", n_topics)
        for _ in range(n_topics):
            topic = r.string()
            out += _str(topic)
            n_parts = r.take("i")
            out += struct.pack(">i", n_parts)
            for _ in range(n_parts):
                part = r.take("i")
                size = r.take("i")
                mset = r.data[r.off:r.off + size]
                r.off += size
                # sniff the generation from the magic byte (offset 16 in a
                # v2 batch; offset 16 in a v0 entry is inside the message) —
                # Kafka brokers key on magic the same way
                magic = mset[16] if len(mset) > 16 else 0
                values = ([v for _, v in decode_record_batches(mset)]
                          if magic == 2
                          else [v for _, v in decode_message_set(mset)])
                with self._lock:
                    log = self._logs.setdefault((topic, part), [])
                    base = len(log)
                    log.extend(values)
                out += struct.pack(">ihq", part, 0, base)
                if ver >= 2:
                    out += struct.pack(">q", -1)   # log_append_time
        if ver >= 1:
            out += struct.pack(">i", 0)            # throttle_time_ms
        return out

    def _fetch(self, r: _Reader, ver: int) -> bytes:
        r.take("i")  # replica_id
        r.take("i")  # max_wait
        r.take("i")  # min_bytes
        if ver >= 3:
            r.take("i")  # top-level max_bytes
        if ver >= 4:
            r.take("b")  # isolation_level
        out = struct.pack(">i", 0) if ver >= 1 else b""   # throttle_time
        n_topics = r.take("i")
        out += struct.pack(">i", n_topics)
        for _ in range(n_topics):
            topic = r.string()
            out += _str(topic)
            n_parts = r.take("i")
            out += struct.pack(">i", n_parts)
            for _ in range(n_parts):
                part, offset, max_bytes = r.take("i"), r.take("q"), r.take("i")
                with self._lock:
                    log = self._logs.get((topic, part), [])
                    high = len(log)
                    tail = log[offset:] if 0 <= offset <= high else None
                if tail is None:     # Kafka error 1: OFFSET_OUT_OF_RANGE
                    out += struct.pack(">ihq", part, 1, high)
                    if ver >= 4:
                        out += struct.pack(">qi", high, 0)
                    out += struct.pack(">i", 0)
                    continue
                chunk: List[bytes] = []
                total = 0
                for v in tail:
                    total += len(v) + 70
                    if chunk and total > max_bytes:
                        break
                    chunk.append(v)
                mset = (encode_record_batch(chunk, base_offset=offset)
                        if ver >= 4 and chunk
                        else encode_message_set(chunk, base_offset=offset)
                        if chunk else b"")
                out += struct.pack(">ihq", part, 0, high)
                if ver >= 4:
                    out += struct.pack(">qi", high, 0)  # lso, aborted_txns
                out += struct.pack(">i", len(mset)) + mset
        return out


# ------------------------------------------------------- NDArray transport
class NDArrayKafkaClient:
    """Publish/consume NDArrays over the Kafka wire protocol (reference
    ``NDArrayKafkaClient.java``): arrays ride as codec-serialized message
    values; consumption is offset-tracked per client.

    With ``group_id`` the client consumes as a managed group member (the
    reference's ``kafka:...&groupId=...`` route,
    ``DL4jServeRouteBuilder.java:55``): the first poll resumes from the
    group's committed offset (or the log's earliest when the group has
    never committed), and every poll commits the new position after its
    records are returned — so a restarted consumer continues exactly
    where the previous incarnation's last completed poll left off."""

    def __init__(self, host: str, port: int, topic: str,
                 partition: int = 0, negotiate: bool = True,
                 group_id: Optional[str] = None):
        self._client = KafkaWireClient(host, port)
        self.topic = topic
        self.partition = partition
        self.group_id = group_id
        self._offset: Optional[int] = None if group_id else 0
        # lazy: no I/O in the constructor (broker may not be up yet);
        # first use runs ApiVersions and falls back to the v0 generation
        # for brokers that don't speak it (pre-0.10 closes the connection)
        self._want_negotiate = negotiate

    def _ensure_negotiated(self) -> None:
        if not self._want_negotiate:
            return
        self._want_negotiate = False
        try:
            self._client.negotiate()
        except Exception:
            self._client.close()     # resync; stay on the v0 generation

    def publish(self, arr) -> int:
        from .codec import serialize_array
        from .ndarray_client import host_array
        self._ensure_negotiated()
        return self._client.produce(self.topic, self.partition,
                                    [serialize_array(host_array(arr))])

    def publish_all(self, arrays) -> int:
        from .codec import serialize_array
        from .ndarray_client import host_array
        self._ensure_negotiated()
        return self._client.produce(
            self.topic, self.partition,
            [serialize_array(host_array(a)) for a in arrays])

    def _resolve_start(self) -> int:
        """Group members resume at the committed offset; a group with no
        commit yet starts at the log's earliest (auto.offset.reset=earliest,
        the reference route's implicit default for training data — losing
        the head of the stream would silently skew the model)."""
        committed = self._client.offset_fetch(self.group_id, self.topic,
                                              self.partition)
        if committed >= 0:
            return committed
        try:
            return self._client.list_offsets(self.topic, self.partition,
                                             timestamp=-2)
        except IOError:
            return 0                     # topic not created yet

    def poll(self, max_items: int = 64):
        """Arrays appended since the last poll.  Group members commit the
        advanced position to the coordinator after the batch is decoded
        (per-poll auto-commit: a consumer killed between polls restarts
        with no loss and no duplication); group-less clients track the
        offset in memory only."""
        from .codec import deserialize_array
        self._ensure_negotiated()
        if self._offset is None:
            self._offset = self._resolve_start()
        msgs = self._client.fetch(self.topic, self.partition, self._offset)
        out = []
        for off, val in msgs[:max_items]:
            out.append(deserialize_array(val)[0])
            self._offset = off + 1
        if self.group_id is not None and out:
            self.commit()
        return out

    def commit(self) -> None:
        """Commit the current position for this client's group."""
        if self.group_id is None:
            raise ValueError("commit() requires a group_id")
        if self._offset is not None:
            self._client.offset_commit(self.group_id, self.topic,
                                       self.partition, self._offset)

    def close(self) -> None:
        self._client.close()
