"""ctypes loader for the host gradient codec (port of the codec half of
``utils/native.py``): ``csrc/host_codec.cpp``, built with g++ at first use
into ``build/native/`` at the repository root (or
``$DL4J_TPU_TORCH_NATIVE_BUILD_DIR``) and cached.

Every entry point has a NumPy twin, used where the library cannot be
built or loaded (no g++, a read-only tree), exactly as the JAX
package's loader does; ``available()`` reports which path is active.
The native path releases the GIL while it encodes, so worker threads
overlap their codec work.
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
           "bitmap_encode_native", "bitmap_decode_native"]

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
