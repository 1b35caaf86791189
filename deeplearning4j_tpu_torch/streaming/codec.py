"""Wire codec for arrays and DataSets (a copy of the JAX package's
``streaming/codec.py``, which imports no JAX: the same bytes either way).

Reference serializes NDArrays base64-inside-Kafka-JSON
(``dl4j-streaming/.../kafka/NDArrayKafkaClient.java`` via RecordConverter);
here: a compact self-describing binary frame (magic, dtype, rank, dims,
raw little-endian data) — zero-copy on decode via ``np.frombuffer``.
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

_MAGIC = b"DTA1"
_DTYPES = ["float32", "float64", "int32", "int64", "uint8", "bool"]


def serialize_array(arr) -> bytes:
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype.name not in _DTYPES:
        raise ValueError(f"unsupported wire dtype {a.dtype}")
    head = _MAGIC + struct.pack(
        "<BB", _DTYPES.index(a.dtype.name), a.ndim)
    head += struct.pack(f"<{a.ndim}q", *a.shape)
    return head + a.tobytes()


def deserialize_array(data: bytes, offset: int = 0
                      ) -> Tuple[np.ndarray, int]:
    """Returns (array, next_offset) so frames can be concatenated."""
    if data[offset:offset + 4] != _MAGIC:
        raise ValueError("bad array frame magic")
    dt_idx, ndim = struct.unpack_from("<BB", data, offset + 4)
    dims = struct.unpack_from(f"<{ndim}q", data, offset + 6)
    dtype = np.dtype(_DTYPES[dt_idx])
    start = offset + 6 + 8 * ndim
    nbytes = int(np.prod(dims)) * dtype.itemsize if ndim else dtype.itemsize
    arr = np.frombuffer(data, dtype, count=int(np.prod(dims)) if ndim else 1,
                        offset=start).reshape(dims)
    return arr, start + nbytes


def serialize_dataset(features, labels=None, features_mask=None,
                      labels_mask=None) -> bytes:
    """DataSet frame: presence bitmap + up to four array frames (the
    reference's DataSet-over-Kafka role)."""
    parts = [features, labels, features_mask, labels_mask]
    bitmap = sum(1 << i for i, p in enumerate(parts) if p is not None)
    out = b"DSB1" + struct.pack("<B", bitmap)
    for p in parts:
        if p is not None:
            out += serialize_array(p)
    return out


def deserialize_dataset(data: bytes):
    """Returns (features, labels, features_mask, labels_mask)."""
    if data[:4] != b"DSB1":
        raise ValueError("bad dataset frame magic")
    bitmap = data[4]
    off = 5
    parts = []
    for i in range(4):
        if bitmap & (1 << i):
            arr, off = deserialize_array(data, off)
            parts.append(arr)
        else:
            parts.append(None)
    return tuple(parts)
