"""ctypes loader for the host codecs (port of ``utils/native.py``):
``csrc/host_codec.cpp``, built
with g++ at first use into ``build/native/`` at the repository root (or
``$DL4J_TPU_TORCH_NATIVE_BUILD_DIR``) and cached.

The gradient codec (threshold and bitmap encode/decode) serves the
training masters; the decodes (``u8_to_f32``, ``decode_cifar``,
``parse_csv``) serve the data readers; ``index_corpus`` serves the
embedding trainers (``nlp/sequence_vectors``); ``crc32c`` serves the
Kafka wire (``streaming/kafka_wire``: the v2 record-batch checksum,
where the JAX package takes ``google_crc32c`` when it is installed and
its bytewise Python loop otherwise).  Every entry point has a
NumPy or Python
twin, used where the library cannot be built or loaded (no g++, a
read-only tree), exactly as the JAX package's loader does, or where the
caller passes ``use_native=False``; ``available()`` reports which path
is active.  The native path releases the GIL while it runs, so worker
threads overlap their codec and decode work.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["available", "threshold_encode_native", "threshold_decode_native",
           "bitmap_encode_native", "bitmap_decode_native", "decode_cifar",
           "u8_to_f32", "parse_csv", "index_corpus", "crc32c"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "host_codec.cpp"
_BUILD_DIR = Path(os.environ.get(
    "DL4J_TPU_TORCH_NATIVE_BUILD_DIR",
    str(Path(__file__).resolve().parents[2] / "build" / "native")))
_SO = _BUILD_DIR / "libdl4j_torch_codec.so"

_i8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def _compile() -> Optional[Path]:
    """Build (or reuse) the shared library; None where that fails.  The
    build writes a per-process temp name and publishes it atomically, so
    concurrent processes never load a half-written library."""
    tmp = None
    try:
        if _SO.exists() and (not _SRC.exists()
                             or _SO.stat().st_mtime >= _SRC.stat().st_mtime):
            return _SO
        if not _SRC.exists():
            return None
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = _SO.with_suffix(f".tmp{os.getpid()}.so")
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
               "-o", str(tmp), str(_SRC)]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return _SO
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if tmp is not None and tmp.exists():
            try:
                tmp.unlink()
            except OSError:
                pass


def _bind(lib: ctypes.CDLL) -> None:
    lib.dl4j_threshold_encode.restype = ctypes.c_int64
    lib.dl4j_threshold_encode.argtypes = [
        _f32, ctypes.c_int64, ctypes.c_float, ctypes.c_int64,
        _i32, _i8, _f32]
    lib.dl4j_threshold_decode.restype = None
    lib.dl4j_threshold_decode.argtypes = [
        _i32, _i8, ctypes.c_int64, ctypes.c_float, _f32, ctypes.c_int64]
    lib.dl4j_bitmap_encode.restype = ctypes.c_int64
    lib.dl4j_bitmap_encode.argtypes = [
        _f32, ctypes.c_int64, ctypes.c_float, _u8, _f32]
    lib.dl4j_bitmap_decode.restype = None
    lib.dl4j_bitmap_decode.argtypes = [
        _u8, ctypes.c_int64, ctypes.c_float, _f32]
    lib.dl4j_u8_to_f32.restype = None
    lib.dl4j_u8_to_f32.argtypes = [_u8, ctypes.c_int64, ctypes.c_float,
                                   _f32]
    lib.dl4j_decode_cifar.restype = None
    lib.dl4j_decode_cifar.argtypes = [_u8, ctypes.c_int64, ctypes.c_float,
                                      _i32, _f32]
    lib.dl4j_parse_csv.restype = ctypes.c_int64
    lib.dl4j_parse_csv.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char, _f32,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    lib.dl4j_index_corpus.restype = ctypes.c_int64
    lib.dl4j_index_corpus.argtypes = [
        ctypes.c_char_p, _i64, ctypes.c_int64, ctypes.c_char_p,
        ctypes.c_int64, _i32, ctypes.c_int64, _i64]
    lib.dl4j_crc32c.restype = ctypes.c_uint32
    lib.dl4j_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.c_uint32]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("DL4J_TPU_DISABLE_NATIVE"):
            return None
        so = _compile()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
            _bind(lib)
        except (OSError, AttributeError):
            return None
        _lib = lib
        return _lib


def available() -> bool:
    """True when the compiled codec library is loadable."""
    return _load() is not None


def threshold_encode_native(grad: np.ndarray, threshold: float,
                            max_k: Optional[int] = None, *,
                            use_native: bool = True
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(idx int32[count], signs int8[count], residual f32[n])``.
    ``use_native=False`` runs the NumPy twin."""
    grad = np.ascontiguousarray(grad, np.float32)
    n = grad.size
    k = int(max_k or max(1, n // 16))
    lib = _load() if use_native else None
    if lib is not None:
        idx = np.empty(k, np.int32)
        signs = np.empty(k, np.int8)
        residual = np.empty(n, np.float32)
        cnt = lib.dl4j_threshold_encode(grad, n, threshold, k, idx, signs,
                                        residual)
        return idx[:cnt].copy(), signs[:cnt].copy(), residual
    over = np.flatnonzero(np.abs(grad) >= threshold)
    if len(over) > k:
        sel = np.argpartition(-np.abs(grad[over]), k - 1)[:k]
        over = np.sort(over[sel])
    signs = np.sign(grad[over]).astype(np.int8)
    signs[signs == 0] = 1
    residual = grad.copy()
    residual[over] -= signs * np.float32(threshold)
    return over.astype(np.int32), signs, residual


def threshold_decode_native(idx, signs, threshold: float, n: int, *,
                            use_native: bool = True) -> np.ndarray:
    idx = np.ascontiguousarray(idx, np.int32)
    signs = np.ascontiguousarray(signs, np.int8)
    lib = _load() if use_native else None
    out = np.empty(n, np.float32)
    if lib is not None:
        lib.dl4j_threshold_decode(idx, signs, len(idx), threshold, out, n)
        return out
    out[:] = 0
    out[idx] = signs.astype(np.float32) * threshold
    return out


def bitmap_encode_native(grad: np.ndarray, threshold: float, *,
                         use_native: bool = True
                         ) -> Tuple[np.ndarray, np.ndarray]:
    grad = np.ascontiguousarray(grad, np.float32)
    n = grad.size
    lib = _load() if use_native else None
    if lib is not None:
        packed = np.empty((n + 3) // 4, np.uint8)
        residual = np.empty(n, np.float32)
        lib.dl4j_bitmap_encode(grad, n, threshold, packed, residual)
        return packed, residual
    codes = np.where(grad >= threshold, 1,
                     np.where(grad <= -threshold, 2, 0)).astype(np.uint8)
    residual = grad - np.where(codes == 1, threshold,
                               np.where(codes == 2, -threshold, 0)
                               ).astype(np.float32)
    pad = (-n) % 4
    q = np.concatenate([codes, np.zeros(pad, np.uint8)]).reshape(-1, 4)
    packed = q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)
    return packed.astype(np.uint8), residual


def bitmap_decode_native(packed: np.ndarray, threshold: float, n: int, *,
                         use_native: bool = True) -> np.ndarray:
    packed = np.ascontiguousarray(packed, np.uint8)
    lib = _load() if use_native else None
    if lib is not None:
        out = np.empty(n, np.float32)
        lib.dl4j_bitmap_decode(packed, n, threshold, out)
        return out
    quads = np.stack([(packed >> s) & 0x3 for s in (0, 2, 4, 6)], 1)
    codes = quads.reshape(-1)[:n]
    return np.where(codes == 1, threshold,
                    np.where(codes == 2, -threshold, 0.0)).astype(np.float32)


def u8_to_f32(data: np.ndarray, scale: float = 1.0 / 255.0, *,
              use_native: bool = True) -> np.ndarray:
    """u8 array -> f32 of the same shape, times ``scale``."""
    data = np.ascontiguousarray(data, np.uint8)
    lib = _load() if use_native else None
    if lib is not None:
        out = np.empty(data.size, np.float32)
        lib.dl4j_u8_to_f32(data.reshape(-1), data.size, scale, out)
        return out.reshape(data.shape)
    return data.astype(np.float32) * scale


def decode_cifar(raw: bytes, scale: float = 1.0 / 255.0, *,
                 use_native: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR binary batch -> (labels int32[n], images f32 NHWC [n,32,32,3])."""
    buf = np.frombuffer(raw, np.uint8)
    if buf.size % 3073:
        raise ValueError("CIFAR batch not a multiple of 3073 bytes")
    n = buf.size // 3073
    lib = _load() if use_native else None
    if lib is not None:
        labels = np.empty(n, np.int32)
        images = np.empty(n * 3072, np.float32)
        lib.dl4j_decode_cifar(np.ascontiguousarray(buf), n, scale, labels,
                              images)
        return labels, images.reshape(n, 32, 32, 3)
    rec = buf.reshape(n, 3073)
    labels = rec[:, 0].astype(np.int32)
    chw = rec[:, 1:].reshape(n, 3, 32, 32)
    return labels, chw.transpose(0, 2, 3, 1).astype(np.float32) * scale


def parse_csv(text: bytes, delimiter: str = ",", *,
              use_native: bool = True) -> np.ndarray:
    """ASCII float CSV -> [rows, cols] f32.  Both paths take the same
    strict grammar (one value between delimiters, rows of one width) and
    raise ``ValueError`` on what it rejects."""
    if isinstance(text, str):
        text = text.encode()
    lib = _load() if use_native else None
    if lib is not None:
        max_out = max(len(text) // 2 + 16, 64)  # >= one value per 2 chars
        out = np.empty(max_out, np.float32)
        ncols = ctypes.c_int64(0)
        nvals = lib.dl4j_parse_csv(text, len(text),
                                   delimiter.encode()[0], out, max_out,
                                   ctypes.byref(ncols))
        if nvals < 0:
            raise ValueError("malformed CSV (native parser)")
        c = ncols.value
        if c == 0:
            return np.empty((0, 0), np.float32)
        return out[:nvals].reshape(-1, c).copy()
    rows = [r for r in text.decode().splitlines() if r.strip()]
    return np.asarray([[float(v) for v in r.split(delimiter)] for r in rows],
                      np.float32)


def index_corpus(sentences, index_map, *, use_native: bool = True):
    """Tokenize and vocab-index ``sentences`` (a list of str): a list of
    per-sentence int32 index arrays, out-of-vocabulary tokens dropped.
    Tokens are exactly ``str.split()``'s.

    ``None`` where the Python path of the caller must index instead: an
    empty ``index_map``, an index space that is not ``0..V-1``, text that
    does not encode to UTF-8 (lone surrogates), and, on the native path,
    text with Unicode whitespace (the library returns -2: only ASCII
    whitespace is handled natively) or an output that would overflow its
    buffer (-3).  The native path returns views into one buffer;
    ``use_native=False`` (or no library) runs the Python twin, which
    tokenizes with ``str.split`` and needs no bail for whitespace."""
    if not index_map:
        return None
    try:
        parts = [s.encode() for s in sentences]
    except UnicodeEncodeError:
        return None
    words = [None] * len(index_map)
    for w, i in index_map.items():
        if not 0 <= i < len(words) or words[i] is not None:
            return None
        words[i] = w
    lib = _load() if use_native else None
    if lib is None:
        get = index_map.get
        out = []
        for s in sentences:
            arr = np.fromiter((get(t, -1) for t in s.split()), np.int32)
            out.append(arr[arr >= 0])
        return out
    offsets = np.zeros(len(parts) + 1, np.int64)
    np.cumsum([len(b) for b in parts], out=offsets[1:])
    text = b"".join(parts)
    blob = "\n".join(words).encode()
    # at most one token per 2 bytes within a sentence; sentence boundaries
    # take no separator byte, hence the + len(parts)
    cap = max((len(text) + len(parts)) // 2 + 16, 64)
    out_idx = np.empty(cap, np.int32)
    out_counts = np.zeros(len(parts), np.int64)
    total = lib.dl4j_index_corpus(text, offsets, len(parts), blob,
                                  len(blob), out_idx, cap, out_counts)
    if total < 0:
        return None
    return np.split(out_idx[:total],
                    np.cumsum(out_counts)[:-1].astype(np.int64))


def _make_crc32c_table():
    poly = 0x82F63B78
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C_TABLE = _make_crc32c_table()


def crc32c(data: bytes, crc: int = 0, *, use_native: bool = True) -> int:
    """CRC-32C (Castagnoli) of ``data``, continuing from ``crc`` (0 to
    start).  ``use_native=False`` (or no library) runs the bytewise table
    loop, the JAX package's ``_crc32c_py``."""
    data = bytes(data)
    lib = _load() if use_native else None
    if lib is not None:
        return int(lib.dl4j_crc32c(data, len(data), crc & 0xFFFFFFFF))
    crc = ~crc & 0xFFFFFFFF
    table = _CRC32C_TABLE            # local ref: hot loop
    for b in data:
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    return ~crc & 0xFFFFFFFF
