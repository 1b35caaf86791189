"""Minimal pure-Python read-only HDF5 parser (port of
``modelimport/hdf5.py``; numpy, struct and zlib only).

The reference reads Keras files through a JavaCPP binding of libhdf5
(``deeplearning4j-modelimport/.../Hdf5Archive.java``); neither machine
has h5py, and the subset that Keras 1.x/2.x files use is small:
superblock v0/v2, v1 ("old-style") object headers with symbol-table
groups (libhdf5's default unless libver='latest'), v2 headers with
compact link messages, contiguous or chunked (+gzip/shuffle) datasets of
fixed-point/float data (v1-v4 layouts, with the v4 single-chunk,
implicit and fixed-array indexes), and attributes holding fixed or
variable-length strings (vlen through global heap collections).  A
dataset reads back as a numpy array over one copy of its bytes.

Layout references: the HDF5 File Format Specification v2/v3 (public).
Unsupported features (fractal-heap "new-style" dense groups, paged
fixed arrays, v2 b-tree chunk indexes, szip) raise ``Hdf5FormatError``
naming the feature rather than misparsing.
"""
from __future__ import annotations

import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Hdf5File", "Hdf5Group", "Hdf5Dataset", "Hdf5FormatError"]

_SIG = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF


class Hdf5FormatError(ValueError):
    pass


def _u(data: bytes, off: int, n: int) -> int:
    return int.from_bytes(data[off:off + n], "little")


class _Datatype:
    def __init__(self, cls: int, size: int, raw: bytes):
        self.cls = cls          # 0 fixed, 1 float, 3 string, 9 vlen
        self.size = size
        self.raw = raw
        self.signed = True
        self.vlen_string = False
        self.base: Optional["_Datatype"] = None

    @property
    def numpy_dtype(self):
        if self.cls == 0:
            return np.dtype(f"{'i' if self.signed else 'u'}{self.size}")
        if self.cls == 1:
            return np.dtype(f"f{self.size}")
        if self.cls == 3:
            return np.dtype(f"S{self.size}")
        raise Hdf5FormatError(f"unsupported datatype class {self.cls}")


def _parse_datatype(body: bytes) -> _Datatype:
    b0 = body[0]
    cls = b0 & 0x0F
    bits0 = body[1]
    size = _u(body, 4, 4)
    dt = _Datatype(cls, size, body)
    if cls == 0:
        dt.signed = bool(bits0 & 0x08)
    elif cls == 9:
        # vlen: bits0 low nibble: 0 sequence, 1 string
        dt.vlen_string = (bits0 & 0x0F) == 1
        dt.base = _parse_datatype(body[8:])
    return dt


class _Dataspace:
    def __init__(self, dims: Tuple[int, ...]):
        self.dims = dims

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n


def _parse_dataspace(body: bytes) -> _Dataspace:
    ver = body[0]
    ndims = body[1]
    flags = body[2]
    if ver == 1:
        off = 8
    elif ver == 2:
        off = 4
    else:
        raise Hdf5FormatError(f"dataspace version {ver}")
    dims = tuple(_u(body, off + 8 * i, 8) for i in range(ndims))
    return _Dataspace(dims)


class _Filter:
    def __init__(self, fid: int, client: List[int]):
        self.id = fid
        self.client = client


def _parse_filters(body: bytes) -> List[_Filter]:
    ver = body[0]
    nf = body[1]
    filters = []
    if ver == 1:
        off = 8
    elif ver == 2:
        off = 2
    else:
        raise Hdf5FormatError(f"filter pipeline version {ver}")
    for _ in range(nf):
        fid = _u(body, off, 2)
        name_len = _u(body, off + 2, 2)
        ncv = _u(body, off + 6, 2)
        off += 8
        if ver == 1 or fid >= 256:
            nl = name_len + (-name_len) % 8 if ver == 1 else name_len
            off += nl
        cvals = [_u(body, off + 4 * i, 4) for i in range(ncv)]
        off += 4 * ncv
        if ver == 1 and ncv % 2 == 1:
            off += 4
        filters.append(_Filter(fid, cvals))
    return filters


class _Layout:
    def __init__(self):
        self.kind = None          # 'contiguous' | 'chunked' | 'compact'
        self.address = UNDEF
        self.size = 0
        self.chunk_dims: Tuple[int, ...] = ()
        self.elem_size = 0
        self.compact_data = b""
        self.chunk_index = 0      # 0 = v1 btree; v4: 1 single, 2 implicit,
        self.single_size = 0      # 3 fixed array (5 = v2 btree unsupported)
        self.single_mask = 0


def _parse_layout(body: bytes) -> _Layout:
    ver = body[0]
    lay = _Layout()
    if ver == 3:
        cls = body[1]
        if cls == 0:
            size = _u(body, 2, 2)
            lay.kind = "compact"
            lay.compact_data = body[4:4 + size]
        elif cls == 1:
            lay.kind = "contiguous"
            lay.address = _u(body, 2, 8)
            lay.size = _u(body, 10, 8)
        elif cls == 2:
            ndims = body[2]
            lay.kind = "chunked"
            lay.address = _u(body, 3, 8)
            lay.chunk_dims = tuple(_u(body, 11 + 4 * i, 4)
                                   for i in range(ndims - 1))
            lay.elem_size = _u(body, 11 + 4 * (ndims - 1), 4)
        else:
            raise Hdf5FormatError(f"layout class {cls}")
    elif ver in (1, 2):
        ndims = body[1]
        cls = body[2]
        if cls == 1:
            lay.kind = "contiguous"
            lay.address = _u(body, 8, 8)
        elif cls == 2:
            lay.kind = "chunked"
            lay.address = _u(body, 8, 8)
            dims = [_u(body, 16 + 4 * i, 4) for i in range(ndims)]
            lay.chunk_dims = tuple(dims[:-1])
            lay.elem_size = dims[-1]
        else:
            raise Hdf5FormatError(f"layout v1 class {cls}")
    elif ver == 4:
        cls = body[1]
        if cls == 0:
            size = _u(body, 2, 2)
            lay.kind = "compact"
            lay.compact_data = body[4:4 + size]
        elif cls == 1:
            lay.kind = "contiguous"
            lay.address = _u(body, 2, 8)
            lay.size = _u(body, 10, 8)
        elif cls == 2:
            flags = body[2]
            ndims = body[3]
            enc = body[4]
            off = 5
            lay.kind = "chunked"
            # like v3, dimensionality = rank + 1 with element size last
            dims = tuple(_u(body, off + enc * i, enc) for i in range(ndims))
            lay.chunk_dims = dims[:-1]
            lay.elem_size = dims[-1]
            off += enc * ndims
            itype = body[off]
            off += 1
            lay.chunk_index = itype
            if itype == 1:      # single chunk
                if flags & 0x2:  # filtered: explicit size + mask
                    lay.single_size = _u(body, off, 8)
                    lay.single_mask = _u(body, off + 8, 4)
                    off += 12
            elif itype == 2:    # implicit (contiguous chunk array)
                pass
            elif itype == 3:    # fixed array
                off += 1        # page bits (re-read from the FAHD header)
            elif itype == 4:    # extensible array params
                off += 6
            elif itype == 5:    # v2 btree params
                off += 6
            else:
                raise Hdf5FormatError(f"chunk index type {itype}")
            lay.address = _u(body, off, 8)
        else:
            raise Hdf5FormatError(f"layout v4 class {cls}")
    else:
        raise Hdf5FormatError(f"layout version {ver} not supported")
    return lay


class _Message:
    def __init__(self, mtype: int, body: bytes):
        self.type = mtype
        self.body = body


class Hdf5Dataset:
    def __init__(self, f: "Hdf5File", name: str, dtype: _Datatype,
                 space: _Dataspace, layout: _Layout,
                 filters: List[_Filter], attrs: Dict[str, Any]):
        self._f = f
        self.name = name
        self.dtype = dtype
        self.shape = space.dims
        self._layout = layout
        self._filters = filters
        self.attrs = attrs

    def __getitem__(self, key) -> np.ndarray:
        return self.read()[key]

    def read(self) -> np.ndarray:
        dt = self.dtype
        if dt.cls == 9:
            return self._read_vlen()
        npdt = dt.numpy_dtype
        raw = self._raw_bytes(npdt.itemsize)
        n = 1
        for d in self.shape:
            n *= d
        arr = np.frombuffer(raw[:n * npdt.itemsize], dtype=npdt)
        return arr.reshape(self.shape) if self.shape else arr.reshape(())

    def _read_vlen(self) -> np.ndarray:
        if not self.dtype.vlen_string:
            raise Hdf5FormatError("vlen non-string dataset")
        raw = self._raw_bytes(16)
        n = 1
        for d in self.shape:
            n *= d
        out = [self._f._read_gheap_object(raw, i * 16) for i in range(n)]
        arr = np.asarray(out, dtype=object)
        return arr.reshape(self.shape) if self.shape else arr.reshape(())

    def _raw_bytes(self, elem_size: int) -> bytes:
        lay = self._layout
        if lay.kind == "compact":
            return lay.compact_data
        if lay.kind == "contiguous":
            if lay.address == UNDEF:
                return b"\x00" * (self._n_elems() * elem_size)
            total = self._n_elems() * elem_size
            return self._f.data[lay.address:lay.address + total]
        if lay.kind == "chunked":
            return self._read_chunked(elem_size)
        raise Hdf5FormatError(f"layout {lay.kind}")

    def _n_elems(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def _apply_filters(self, raw: bytes, mask: int) -> bytes:
        for i, flt in enumerate(reversed(self._filters)):
            pos = len(self._filters) - 1 - i
            if mask & (1 << pos):
                continue
            if flt.id == 1:        # gzip
                raw = zlib.decompress(raw)
            elif flt.id == 2:      # shuffle
                es = flt.client[0] if flt.client else 4
                n = len(raw) // es
                arr = np.frombuffer(raw[:n * es], np.uint8).reshape(es, n)
                raw = arr.T.tobytes() + raw[n * es:]
            elif flt.id == 3:      # fletcher32: strip trailing checksum
                raw = raw[:-4]
            else:
                raise Hdf5FormatError(f"filter id {flt.id}")
        return raw

    def _read_chunked(self, elem_size: int) -> bytes:
        lay = self._layout
        ndims = len(self.shape)
        full = np.zeros(self._n_elems() * elem_size, np.uint8)
        view = full.reshape(self.shape + (elem_size,)) if ndims else full
        if lay.chunk_index:
            nbytes = int(np.prod(lay.chunk_dims)) * elem_size if ndims else \
                elem_size
            chunks = self._f._iter_chunks_v4(lay, self.shape, nbytes)
        else:
            chunks = self._f._iter_chunks(lay.address, ndims)
        for (offsets, size, mask, addr) in chunks:
            raw = self._f.data[addr:addr + size]
            raw = self._apply_filters(raw, mask)
            cdims = lay.chunk_dims
            carr = np.frombuffer(
                raw[: int(np.prod(cdims)) * elem_size], np.uint8
            ).reshape(tuple(cdims) + (elem_size,))
            # clip chunk to the dataset bounds
            slices = tuple(
                slice(offsets[d], min(offsets[d] + cdims[d], self.shape[d]))
                for d in range(ndims))
            csl = tuple(slice(0, s.stop - s.start) for s in slices)
            view[slices] = carr[csl]
        return full.tobytes()


class Hdf5Group:
    def __init__(self, f: "Hdf5File", name: str):
        self._f = f
        self.name = name
        self.attrs: Dict[str, Any] = {}
        self._children: Dict[str, int] = {}   # name -> object header addr

    def keys(self) -> List[str]:
        return list(self._children)

    def __contains__(self, name: str) -> bool:
        return name in self._children or name.split("/")[0] in self._children

    def __getitem__(self, path: str):
        parts = [p for p in path.split("/") if p]
        node: Any = self
        for p in parts:
            if not isinstance(node, Hdf5Group) or p not in node._children:
                raise KeyError(f"{p!r} not in group {node.name!r}")
            node = self._f._load_object(node._children[p],
                                        f"{node.name.rstrip('/')}/{p}")
        return node

    def items(self):
        return [(k, self[k]) for k in self.keys()]


class Hdf5File(Hdf5Group):
    """Read-only HDF5 file over an in-memory byte buffer."""

    def __init__(self, path_or_bytes):
        if isinstance(path_or_bytes, (bytes, bytearray)):
            self.data = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as fh:
                self.data = fh.read()
        super().__init__(self, "/")
        self._cache: Dict[int, Any] = {}
        root_addr = self._parse_superblock()
        root = self._load_object(root_addr, "/")
        self._children = root._children
        self.attrs = root.attrs

    # -------------------------------------------------------------- plumbing
    def _parse_superblock(self) -> int:
        if self.data[:8] != _SIG:
            raise Hdf5FormatError("not an HDF5 file (bad signature)")
        ver = self.data[8]
        if ver == 0:
            so, sl = self.data[13], self.data[14]
            if (so, sl) != (8, 8):
                raise Hdf5FormatError("only 8-byte offsets/lengths supported")
            # 24B fixed part, 4 file addresses (base/freespace/eof/driver),
            # then the root symbol-table entry: name off(8) + OH addr(8)
            return _u(self.data, 24 + 32 + 8, 8)
        if ver in (2, 3):
            so = self.data[9]
            if so != 8:
                raise Hdf5FormatError("only 8-byte offsets supported")
            return _u(self.data, 12 + 8 * 3, 8)
        raise Hdf5FormatError(f"superblock version {ver}")

    # ---- object headers ---------------------------------------------------
    def _read_messages_v1(self, addr: int) -> List[_Message]:
        d = self.data
        nmsgs = _u(d, addr + 2, 2)
        hdr_size = _u(d, addr + 8, 4)
        blocks = [(addr + 16, hdr_size)]
        msgs: List[_Message] = []
        while blocks and len(msgs) < nmsgs:
            off, remaining = blocks.pop(0)
            while remaining >= 8 and len(msgs) < nmsgs:
                mtype = _u(d, off, 2)
                size = _u(d, off + 2, 2)
                body = d[off + 8:off + 8 + size]
                if mtype == 0x0010:  # continuation
                    blocks.append((_u(body, 0, 8), _u(body, 8, 8)))
                else:
                    msgs.append(_Message(mtype, body))
                off += 8 + size
                remaining -= 8 + size
        return msgs

    def _read_messages_v2(self, addr: int) -> List[_Message]:
        d = self.data
        if d[addr:addr + 4] != b"OHDR":
            raise Hdf5FormatError("bad v2 object header signature")
        flags = d[addr + 5]
        off = addr + 6
        if flags & 0x20:
            off += 16  # times
        if flags & 0x10:
            off += 4   # max compact/dense
        size_bytes = 1 << (flags & 0x3)
        chunk_size = _u(d, off, size_bytes)
        off += size_bytes
        msgs: List[_Message] = []
        # chunk-0 size covers the messages + gap but not prefix/checksum;
        # continuation length covers OCHK signature + messages + checksum.
        # blocks carry (start, end-of-message-region) with both excluded.
        blocks = [(off, off + chunk_size)]
        creation_tracked = bool(flags & 0x04)
        hdr = 6 if creation_tracked else 4
        while blocks:
            p, end = blocks.pop(0)
            while p + hdr <= end:
                mtype = d[p]
                size = _u(d, p + 1, 2)
                p += hdr
                body = d[p:p + size]
                if mtype == 0x10:
                    caddr, clen = _u(body, 0, 8), _u(body, 8, 8)
                    blocks.append((caddr + 4, caddr + clen - 4))
                else:
                    msgs.append(_Message(mtype, body))
                p += size
        return msgs

    def _load_object(self, addr: int, name: str):
        if addr in self._cache:
            return self._cache[addr]
        d = self.data
        if d[addr:addr + 4] == b"OHDR":
            msgs = self._read_messages_v2(addr)
        else:
            msgs = self._read_messages_v1(addr)
        attrs: Dict[str, Any] = {}
        dtype = space = layout = None
        filters: List[_Filter] = []
        children: Dict[str, int] = {}
        is_group = False
        for m in msgs:
            if m.type == 0x0001:
                space = _parse_dataspace(m.body)
            elif m.type == 0x0003:
                dtype = _parse_datatype(m.body)
            elif m.type == 0x0008:
                layout = _parse_layout(m.body)
            elif m.type == 0x000B:
                filters = _parse_filters(m.body)
            elif m.type == 0x000C:
                k, v = self._parse_attribute(m.body)
                attrs[k] = v
            elif m.type == 0x0011:  # symbol table (old-style group)
                is_group = True
                btree, heap = _u(m.body, 0, 8), _u(m.body, 8, 8)
                children.update(self._read_group_btree(btree, heap))
            elif m.type == 0x0006:  # link message (new-style compact group)
                is_group = True
                lname, laddr = self._parse_link(m.body)
                children[lname] = laddr
            elif m.type == 0x0015:  # attribute info: dense attrs unsupported
                ai_flags = m.body[1] if len(m.body) >= 2 else 0
                pos = 2 + (2 if ai_flags & 0x1 else 0)
                afheap = (_u(m.body, pos, 8)
                          if len(m.body) >= pos + 8 else UNDEF)
                if afheap != UNDEF:
                    raise Hdf5FormatError(
                        "dense attribute storage (fractal heap) unsupported")
            elif m.type == 0x0002:  # link info: dense storage unsupported
                # body: version(1) flags(1) [max creation index(8) if
                # flags&1] fractal-heap addr(8) name-index btree(8) …
                li_flags = m.body[1] if len(m.body) >= 2 else 0
                pos = 2 + (8 if li_flags & 0x1 else 0)
                fheap = (_u(m.body, pos, 8)
                         if len(m.body) >= pos + 8 else UNDEF)
                # only reject if links actually live in a fractal heap
                if fheap != UNDEF:
                    raise Hdf5FormatError(
                        "new-style dense groups (fractal heap) unsupported — "
                        "write the file with libver='earliest'")
        if is_group or (dtype is None and layout is None):
            g = Hdf5Group(self, name)
            g.attrs = attrs
            g._children = children
            self._cache[addr] = g
            return g
        ds = Hdf5Dataset(self, name, dtype, space or _Dataspace(()),
                         layout, filters, attrs)
        self._cache[addr] = ds
        return ds

    def _parse_link(self, body: bytes) -> Tuple[str, int]:
        ver, flags = body[0], body[1]
        off = 2
        if flags & 0x08:
            off += 1  # link type (0 = hard)
        if flags & 0x04:
            off += 8  # creation order
        if flags & 0x10:
            off += 1  # charset
        ln_size = 1 << (flags & 0x3)
        ln = _u(body, off, ln_size)
        off += ln_size
        lname = body[off:off + ln].decode()
        off += ln
        return lname, _u(body, off, 8)

    # ---- old-style groups -------------------------------------------------
    def _read_group_btree(self, btree_addr: int, heap_addr: int
                          ) -> Dict[str, int]:
        d = self.data
        heap_data_addr = _u(d, heap_addr + 24, 8)
        out: Dict[str, int] = {}

        def heap_name(off: int) -> str:
            end = d.index(b"\x00", heap_data_addr + off)
            return d[heap_data_addr + off:end].decode()

        def walk(addr: int):
            if d[addr:addr + 4] == b"SNOD":
                nsyms = _u(d, addr + 6, 2)
                p = addr + 8
                for _ in range(nsyms):
                    name_off = _u(d, p, 8)
                    oh_addr = _u(d, p + 8, 8)
                    out[heap_name(name_off)] = oh_addr
                    p += 40
                return
            if d[addr:addr + 4] != b"TREE":
                raise Hdf5FormatError("expected TREE/SNOD node")
            entries = _u(d, addr + 6, 2)
            p = addr + 8 + 16  # skip left/right siblings
            p += 8  # key0
            for _ in range(entries):
                child = _u(d, p, 8)
                walk(child)
                p += 16  # child + next key

        if btree_addr != UNDEF:
            walk(btree_addr)
        return out

    # ---- chunk b-tree -----------------------------------------------------
    def _iter_chunks(self, btree_addr: int, ndims: int):
        d = self.data
        results = []

        def walk(addr: int):
            if d[addr:addr + 4] != b"TREE":
                raise Hdf5FormatError("expected chunk TREE node")
            level = d[addr + 5]
            entries = _u(d, addr + 6, 2)
            p = addr + 8 + 16
            key_size = 8 + 8 * (ndims + 1)
            for _ in range(entries):
                size = _u(d, p, 4)
                mask = _u(d, p + 4, 4)
                offsets = tuple(_u(d, p + 8 + 8 * i, 8) for i in range(ndims))
                child = _u(d, p + key_size, 8)
                if level == 0:
                    results.append((offsets, size, mask, child))
                else:
                    walk(child)
                p += key_size + 8

        if btree_addr != UNDEF:
            walk(btree_addr)
        return results

    # ---- v4 chunk indexes (HDF5 1.10+ "latest" files) ---------------------
    def _iter_chunks_v4(self, lay: _Layout, shape: Tuple[int, ...],
                        chunk_nbytes: int):
        cdims = lay.chunk_dims
        ndims = len(shape)
        grid = [max(1, -(-shape[i] // cdims[i])) for i in range(ndims)]

        def origin(idx: int) -> Tuple[int, ...]:
            out = []
            for g, c in zip(reversed(grid), reversed(cdims)):
                out.append((idx % g) * c)
                idx //= g
            return tuple(reversed(out))

        if lay.address == UNDEF:
            return []
        if lay.chunk_index == 1:    # single chunk: address is the data
            size = lay.single_size or chunk_nbytes
            return [((0,) * ndims, size, lay.single_mask, lay.address)]
        if lay.chunk_index == 2:    # implicit: dense row-major chunk array
            n = 1
            for g in grid:
                n *= g
            return [(origin(i), chunk_nbytes, 0,
                     lay.address + i * chunk_nbytes) for i in range(n)]
        if lay.chunk_index == 3:    # fixed array
            return self._read_fixed_array(lay.address, origin, chunk_nbytes)
        raise Hdf5FormatError(
            f"chunk index type {lay.chunk_index} unsupported")

    def _read_fixed_array(self, addr: int, origin, chunk_nbytes: int):
        d = self.data
        if d[addr:addr + 4] != b"FAHD":
            raise Hdf5FormatError("bad fixed-array header signature")
        client = d[addr + 5]            # 0 plain, 1 filtered chunks
        entry_size = d[addr + 6]
        page_bits = d[addr + 7]
        nentries = _u(d, addr + 8, 8)
        dblock = _u(d, addr + 16, 8)
        if nentries > (1 << page_bits):
            raise Hdf5FormatError("paged fixed-array chunk index unsupported")
        if dblock == UNDEF:
            return []
        if d[dblock:dblock + 4] != b"FADB":
            raise Hdf5FormatError("bad fixed-array data block signature")
        p = dblock + 6 + 8              # sig+ver+client, header address
        out = []
        for i in range(nentries):
            caddr = _u(d, p, 8)
            if client == 0:
                size, mask = chunk_nbytes, 0
            else:
                sz_len = entry_size - 12
                size = _u(d, p + 8, sz_len)
                mask = _u(d, p + 8 + sz_len, 4)
            if caddr != UNDEF:
                out.append((origin(i), size, mask, caddr))
            p += entry_size
        return out

    # ---- attributes -------------------------------------------------------
    def _parse_attribute(self, body: bytes) -> Tuple[str, Any]:
        ver = body[0]
        if ver == 1:
            name_size = _u(body, 2, 2)
            dt_size = _u(body, 4, 2)
            ds_size = _u(body, 6, 2)
            off = 8
            name = body[off:off + name_size].split(b"\x00")[0].decode()
            off += name_size + (-name_size) % 8
            dt = _parse_datatype(body[off:off + dt_size])
            off += dt_size + (-dt_size) % 8
            space = _parse_dataspace(body[off:off + ds_size])
            off += ds_size + (-ds_size) % 8
        elif ver in (2, 3):
            name_size = _u(body, 2, 2)
            dt_size = _u(body, 4, 2)
            ds_size = _u(body, 6, 2)
            off = 8 + (1 if ver == 3 else 0)
            name = body[off:off + name_size].split(b"\x00")[0].decode()
            off += name_size
            dt = _parse_datatype(body[off:off + dt_size])
            off += dt_size
            space = _parse_dataspace(body[off:off + ds_size])
            off += ds_size
        else:
            raise Hdf5FormatError(f"attribute version {ver}")
        data = body[off:]
        return name, self._attr_value(dt, space, data)

    def _attr_value(self, dt: _Datatype, space: _Dataspace, data: bytes):
        n = space.n_elements
        if dt.cls == 9 and dt.vlen_string:
            vals = [self._read_gheap_object(data, 16 * i) for i in range(n)]
        elif dt.cls == 3:
            vals = [data[i * dt.size:(i + 1) * dt.size].split(b"\x00")[0]
                    .decode("utf-8", "replace") for i in range(n)]
        else:
            npdt = dt.numpy_dtype
            arr = np.frombuffer(data[:n * npdt.itemsize], npdt)
            vals = list(arr)
        if not space.dims:
            return vals[0]
        return np.asarray(vals, dtype=object if dt.cls in (3, 9) else None
                          ).reshape(space.dims)

    # ---- global heap (vlen strings) ---------------------------------------
    def _read_gheap_object(self, ref: bytes, off: int) -> str:
        size = _u(ref, off, 4)
        gaddr = _u(ref, off + 4, 8)
        gidx = _u(ref, off + 12, 4)
        d = self.data
        if d[gaddr:gaddr + 4] != b"GCOL":
            raise Hdf5FormatError("bad global heap signature")
        total = _u(d, gaddr + 8, 8)
        p = gaddr + 16
        end = gaddr + total
        while p < end:
            idx = _u(d, p, 2)
            osize = _u(d, p + 8, 8)
            if idx == 0:
                break
            if idx == gidx:
                return d[p + 16:p + 16 + size].decode("utf-8", "replace")
            p += 16 + osize + (-osize) % 8
        raise Hdf5FormatError(f"global heap object {gidx} not found")
