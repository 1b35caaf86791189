"""Minimal HDF5 writer (port of ``modelimport/hdf5_writer.py``):
superblock v0, v1 object headers, symbol-table groups, contiguous or
chunked (+gzip) datasets, fixed/vlen string and numeric attributes.

It writes models in the Keras weight layout without h5py
(``keras_export``), and the fixtures of the reader's tests.  The format
features it emits (old-style groups, GCOL vlen strings) are the ones
libhdf5 writes for Keras files.  Output is deterministic: the same tree
and attributes give the same bytes as the JAX package's writer.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

__all__ = ["Hdf5Writer", "write_hdf5"]

UNDEF = 0xFFFFFFFFFFFFFFFF
# placeholder for not-yet-known global-heap addresses; patched in finalize.
# 8 high-entropy bytes make an accidental match in real data vanishingly rare
_ADDR_MAGIC = b"\xde\xad\xbe\xef\xfe\xed\xfa\xce"


def _pad8(b: bytes) -> bytes:
    return b + b"\x00" * ((-len(b)) % 8)


class _VlenStr:
    def __init__(self, values: List[str], dims: Tuple[int, ...]):
        self.values = values
        self.dims = dims


class Hdf5Writer:
    """``tree`` is nested dicts; leaves are np.ndarray.  ``attrs`` maps
    group-path -> {name: value} where value is str | [str] | int | float |
    np.ndarray | bytes (fixed string)."""

    def __init__(self):
        self.buf = bytearray()
        self._gheap: List[bytes] = []       # pending vlen payloads
        # (start, end) of each object header that holds a vlen reference
        self._ref_spans: List[Tuple[int, int]] = []

    # ---------------------------------------------------------------- alloc
    def _alloc(self, size: int, align: int = 8) -> int:
        while len(self.buf) % align:
            self.buf.append(0)
        off = len(self.buf)
        self.buf.extend(b"\x00" * size)
        return off

    def _put(self, off: int, data: bytes):
        self.buf[off:off + len(data)] = data

    # ------------------------------------------------------------- messages
    @staticmethod
    def _msg(mtype: int, body: bytes) -> bytes:
        body = _pad8(body)
        return struct.pack("<HHB3x", mtype, len(body), 0) + body

    @staticmethod
    def _dataspace(dims: Tuple[int, ...]) -> bytes:
        body = struct.pack("<BBB5x", 1, len(dims), 0)
        for d in dims:
            body += struct.pack("<Q", d)
        return body

    @staticmethod
    def _dt_float(size: int) -> bytes:
        # class 1 (float) v1, little-endian IEEE; second bit-field byte is
        # the sign-bit position (31 for f32, 63 for f64)
        if size == 4:
            props = struct.pack("<HHBBBBI", 0, 32, 23, 8, 0, 23, 127)
        else:
            props = struct.pack("<HHBBBBI", 0, 64, 52, 11, 0, 52, 1023)
        sign_pos = size * 8 - 1
        return struct.pack("<BBBBI", 0x11, 0x20, sign_pos, 0x00,
                           size) + props

    @staticmethod
    def _dt_int(size: int, signed: bool = True) -> bytes:
        b0 = 0x08 if signed else 0
        return struct.pack("<BBBBI", 0x10, b0, 0, 0, size) + struct.pack(
            "<HH", 0, size * 8)

    @staticmethod
    def _dt_fixed_str(size: int) -> bytes:
        return struct.pack("<BBBBI", 0x13, 0, 0, 0, size)

    @staticmethod
    def _dt_vlen_str() -> bytes:
        base = Hdf5Writer._dt_fixed_str(1)
        return struct.pack("<BBBBI", 0x19, 0x01, 0, 0, 16) + base

    @staticmethod
    def _np_datatype(arr: np.ndarray) -> bytes:
        if arr.dtype.kind == "f":
            return Hdf5Writer._dt_float(arr.dtype.itemsize)
        if arr.dtype.kind in "iu":
            return Hdf5Writer._dt_int(arr.dtype.itemsize,
                                      arr.dtype.kind == "i")
        raise ValueError(f"unsupported dtype {arr.dtype}")

    # ----------------------------------------------------------- attributes
    def _attr_msg(self, name: str, value: Any) -> bytes:
        nameb = name.encode() + b"\x00"
        if isinstance(value, str):
            value = _VlenStr([value], ())
        elif (isinstance(value, (list, tuple)) and value
              and isinstance(value[0], str)):
            value = _VlenStr(list(value), (len(value),))
        if isinstance(value, _VlenStr):
            dt = self._dt_vlen_str()
            ds = self._dataspace(value.dims)
            data = b""
            for s in value.values:
                payload = s.encode()
                self._gheap.append(payload)
                idx = len(self._gheap)
                # size(4) addr(8, magic placeholder patched in finalize) idx(4)
                data += struct.pack("<I", len(payload)) + _ADDR_MAGIC \
                    + struct.pack("<I", idx)
        elif isinstance(value, bytes):
            dt = self._dt_fixed_str(len(value))
            ds = self._dataspace(())
            data = value
        else:
            arr = np.atleast_1d(np.asarray(value))
            scalar = np.asarray(value).ndim == 0
            dt = self._np_datatype(arr)
            ds = self._dataspace(() if scalar else arr.shape)
            data = arr.tobytes()
        body = struct.pack("<BxHHH", 1, len(nameb), len(dt), len(ds))
        body += _pad8(nameb) + _pad8(dt) + _pad8(ds) + data
        return self._msg(0x000C, body)

    # ------------------------------------------------------------- datasets
    def _write_dataset(self, arr: np.ndarray, attrs: Dict[str, Any],
                       chunks: Optional[Tuple[int, ...]] = None,
                       gzip_level: Optional[int] = None) -> int:
        arr = np.ascontiguousarray(arr)
        msgs = [
            self._msg(0x0001, self._dataspace(arr.shape)),
            self._msg(0x0003, self._np_datatype(arr)),
        ]
        if chunks is None:
            data_addr = self._alloc(arr.nbytes)
            self._put(data_addr, arr.tobytes())
            msgs.append(self._msg(0x0008, struct.pack(
                "<BBQQ", 3, 1, data_addr, arr.nbytes)))
        else:
            msgs.extend(self._write_chunked(arr, chunks, gzip_level))
        for k, v in (attrs or {}).items():
            msgs.append(self._attr_msg(k, v))
        return self._write_object_header(msgs)

    def _write_chunked(self, arr: np.ndarray, chunks: Tuple[int, ...],
                       gzip_level: Optional[int]) -> List[bytes]:
        import zlib as _zlib
        ndims = arr.ndim
        es = arr.dtype.itemsize
        entries = []  # (offsets, size, addr)
        grid = [range(0, arr.shape[d], chunks[d]) for d in range(ndims)]
        import itertools
        for origin in itertools.product(*grid):
            sl = tuple(slice(o, min(o + chunks[d], arr.shape[d]))
                       for d, o in enumerate(origin))
            block = np.zeros(chunks, arr.dtype)
            block[tuple(slice(0, s.stop - s.start) for s in sl)] = arr[sl]
            raw = block.tobytes()
            if gzip_level is not None:
                raw = _zlib.compress(raw, gzip_level)
            addr = self._alloc(len(raw))
            self._put(addr, raw)
            entries.append((origin, len(raw), addr))
        key_size = 8 + 8 * (ndims + 1)
        tree_addr = self._alloc(8 + 16 + len(entries) * (key_size + 8)
                                + key_size)
        self._put(tree_addr, b"TREE" + struct.pack(
            "<BBHQQ", 1, 0, len(entries), UNDEF, UNDEF))
        p = tree_addr + 24
        for (origin, size, addr) in entries:
            key = struct.pack("<II", size, 0)
            for o in origin:
                key += struct.pack("<Q", o)
            key += struct.pack("<Q", 0)  # element-offset dim (always 0)
            self._put(p, key)
            self._put(p + key_size, struct.pack("<Q", addr))
            p += key_size + 8
        # final (upper-bound) key: one chunk past the end in every dim —
        # libhdf5 binary-searches the keys, a zeroed bound breaks lookup
        # of edge chunks
        bound = struct.pack("<II", 0, 0)
        for d in range(ndims):
            end = ((arr.shape[d] + chunks[d] - 1) // chunks[d]) * chunks[d]
            bound += struct.pack("<Q", end)
        bound += struct.pack("<Q", 0)
        self._put(p, bound)
        msgs = [self._msg(0x0008, struct.pack(
            "<BBBQ", 3, 2, ndims + 1, tree_addr)
            + b"".join(struct.pack("<I", c) for c in chunks)
            + struct.pack("<I", es))]
        if gzip_level is not None:
            # filter pipeline v1: gzip (id 1), one client value (level)
            body = struct.pack("<BB6x", 1, 1)
            body += struct.pack("<HHHH", 1, 0, 1, 1)  # id,namelen,flags,ncv
            body += struct.pack("<I", gzip_level) + b"\x00" * 4  # pad ncv odd
            msgs.append(self._msg(0x000B, body))
        return msgs

    def _write_object_header(self, msgs: List[bytes]) -> int:
        total = sum(len(m) for m in msgs)
        addr = self._alloc(16 + total)
        if any(_ADDR_MAGIC in m for m in msgs):
            self._ref_spans.append((addr, addr + 16 + total))
        self._put(addr, struct.pack("<BxHII4x", 1, len(msgs), 1, total))
        off = addr + 16
        for m in msgs:
            self._put(off, m)
            off += len(m)
        return addr

    # --------------------------------------------------------------- groups
    def _write_group(self, children: Dict[str, int],
                     attrs: Dict[str, Any]) -> int:
        # local heap with child names
        names = sorted(children)
        heap_data = bytearray(b"\x00" * 8)  # offset 0 reserved (empty name)
        offsets = {}
        for n in names:
            offsets[n] = len(heap_data)
            heap_data.extend(n.encode() + b"\x00")
            while len(heap_data) % 8:
                heap_data.append(0)
        heap_data_addr = self._alloc(max(len(heap_data), 8))
        self._put(heap_data_addr, bytes(heap_data))
        heap_addr = self._alloc(32)
        # free-list head = 1 (H5HL_FREE_NULL): no free blocks
        self._put(heap_addr, b"HEAP" + struct.pack(
            "<B3xQQQ", 0, len(heap_data), 1, heap_data_addr))
        # single SNOD with all entries (names must be heap-offset sorted)
        snod_addr = self._alloc(8 + 40 * len(names))
        self._put(snod_addr, b"SNOD" + struct.pack("<BxH", 1, len(names)))
        p = snod_addr + 8
        for n in names:
            self._put(p, struct.pack("<QQI4x16x", offsets[n], children[n], 0))
            p += 40
        # btree with one entry -> snod
        btree_addr = self._alloc(8 + 16 + 8 + 16)
        self._put(btree_addr, b"TREE" + struct.pack(
            "<BBHQQ", 0, 0, 1, UNDEF, UNDEF))
        p = btree_addr + 24
        self._put(p, struct.pack("<Q", 0))            # key0
        self._put(p + 8, struct.pack("<Q", snod_addr))  # child
        self._put(p + 16, struct.pack("<Q", offsets[names[-1]] if names
                                      else 0))       # key1
        msgs = [self._msg(0x0011, struct.pack("<QQ", btree_addr, heap_addr))]
        for k, v in (attrs or {}).items():
            msgs.append(self._attr_msg(k, v))
        return self._write_object_header(msgs)

    # -------------------------------------------------------------- finalize
    def write(self, tree: Dict[str, Any],
              attrs: Optional[Dict[str, Dict[str, Any]]] = None) -> bytes:
        """tree: nested dicts, leaves np.ndarray (or (array, attr_dict)).
        attrs: {"/": {...}, "/group/path": {...}} extra group attributes."""
        attrs = attrs or {}
        self.buf = bytearray(b"\x00" * 96)  # superblock v0 placeholder
        self._gheap, self._ref_spans = [], []

        def build(node: Dict[str, Any], path: str) -> int:
            children = {}
            for name, sub in node.items():
                if isinstance(sub, dict):
                    children[name] = build(sub, f"{path}{name}/")
                elif isinstance(sub, tuple):
                    # (array, attrs[, chunks[, gzip_level]])
                    extra = list(sub[2:]) + [None, None]
                    children[name] = self._write_dataset(
                        np.asarray(sub[0]), sub[1], chunks=extra[0],
                        gzip_level=extra[1])
                else:
                    children[name] = self._write_dataset(np.asarray(sub), {})
            return self._write_group(children,
                                     attrs.get(path.rstrip("/") or "/", {}))

        root_addr = build(tree, "/")
        gheap_addr = self._write_gheap()
        self._patch_refs(gheap_addr)
        # superblock v0
        sb = b"\x89HDF\r\n\x1a\n" + struct.pack(
            "<BBBxBBBxHHI", 0, 0, 0, 0, 8, 8, 4, 16, 0)
        sb += struct.pack("<QQQQ", 0, UNDEF, len(self.buf), UNDEF)
        sb += struct.pack("<QQI4x16x", 0, root_addr, 0)
        self.buf[:len(sb)] = sb
        return bytes(self.buf)

    def _write_gheap(self) -> int:
        if not self._gheap:
            return UNDEF
        objs = b""
        for i, payload in enumerate(self._gheap, start=1):
            objs += struct.pack("<HH4xQ", i, 1, len(payload))
            objs += _pad8(payload)
        # libhdf5 requires collections of at least 4096 bytes; the tail is
        # a free-space object (index 0, size = remaining bytes incl. its
        # own 16-byte header)
        total = max(16 + len(objs) + 16, 4096)
        free = total - 16 - len(objs)
        addr = self._alloc(total)
        self._put(addr, b"GCOL" + struct.pack("<B3xQ", 1, total) + objs
                  + struct.pack("<HH4xQ", 0, 0, free))
        return addr

    def _patch_refs(self, gheap_addr: int):
        """Patch the global-heap address into every vlen reference: the
        references were emitted with a magic 8-byte placeholder (attr bytes
        are built before their final file position is known).  Only the
        object headers that hold one are searched, not the datasets'
        bytes: a Keras file of a full-width model is hundreds of MB."""
        addr = struct.pack("<Q", gheap_addr)
        for lo, hi in self._ref_spans:
            start = lo
            while True:
                pos = self.buf.find(_ADDR_MAGIC, start, hi)
                if pos < 0:
                    break
                self._put(pos, addr)
                start = pos + 8


def write_hdf5(path: str, tree: Dict[str, Any],
               attrs: Optional[Dict[str, Dict[str, Any]]] = None) -> None:
    data = Hdf5Writer().write(tree, attrs)
    with open(path, "wb") as fh:
        fh.write(data)
