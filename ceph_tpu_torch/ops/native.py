"""ctypes binding for the native GF kernels (native/gf_native.cc).

Builds the shared library on demand with g++ into the repo's ignored
``build/`` directory (the JAX package keeps its own copy beside the
source; this package never writes there) and binds it with ctypes.
Falls back cleanly if no compiler is available — callers check
``available()``.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "gf_native.cc")
_SO = os.path.join(_ROOT, "build", "libceph_tpu_torch_gf.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _build() -> bool:
    try:
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        # build beside the target and rename: processes that build at
        # once never load a half-written library
        tmp = f"{_SO}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or (
                os.path.exists(_SRC) and
                os.path.getmtime(_SRC) > os.path.getmtime(_SO)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.gf8_init()
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.gf8_region_mul_xor.argtypes = [ctypes.c_uint8, u8p, u8p,
                                           ctypes.c_size_t]
        lib.gf8_matrix_encode.argtypes = [
            ctypes.c_int, ctypes.c_int, u8p, u8p, u8p, ctypes.c_size_t,
            ctypes.c_size_t]
        lib.gf8_bitmatrix_packets.argtypes = [
            ctypes.c_int, ctypes.c_int, u8p, u8p, u8p, ctypes.c_size_t,
            ctypes.c_size_t]
        lib.crc32c.argtypes = [ctypes.c_uint32, u8p, ctypes.c_size_t]
        lib.crc32c.restype = ctypes.c_uint32
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def crc32c(data: bytes | np.ndarray, crc: int = 0) -> int:
    lib = _load()
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, bytes) \
        else np.ascontiguousarray(data, dtype=np.uint8)
    if lib is None:
        # slow pure-python fallback
        c = ~crc & 0xFFFFFFFF
        for byte in arr.tobytes():
            c ^= byte
            for _ in range(8):
                c = (0x82F63B78 ^ (c >> 1)) if c & 1 else (c >> 1)
        return ~c & 0xFFFFFFFF
    return int(lib.crc32c(ctypes.c_uint32(crc), _ptr(arr), arr.size))


class NativeBackend:
    """CodecCore backend running the C++ kernels (w=8 byte-domain matrix
    codes and packet-domain bitmatrix codes)."""

    name = "native"
    supported_widths = (8,)

    def __init__(self):
        self.lib = _load()
        if self.lib is None:
            raise RuntimeError("native GF library unavailable")

    def apply_matrix(self, M: np.ndarray, data: np.ndarray, w: int
                     ) -> np.ndarray:
        if w != 8:
            raise NotImplementedError("native path supports w=8 only")
        rows, k = M.shape
        squeeze = data.ndim == 2
        if squeeze:
            data = data[None]
        lead = data.shape[:-2]
        L = data.shape[-1]
        flat = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1, k, L)
        batch = flat.shape[0]
        out = np.empty((batch, rows, L), dtype=np.uint8)
        Mu = np.ascontiguousarray(M, dtype=np.uint8)
        self.lib.gf8_matrix_encode(k, rows, _ptr(Mu), _ptr(flat), _ptr(out),
                                   L, batch)
        out = out.reshape(lead + (rows, L))
        return out[0] if squeeze else out

    def apply_bitmatrix_packets(self, B: np.ndarray, pk: np.ndarray
                                ) -> np.ndarray:
        R, C = B.shape
        lead = pk.shape[:-2]
        ps = pk.shape[-1]
        flat = np.ascontiguousarray(pk, dtype=np.uint8).reshape(-1, C, ps)
        nw = flat.shape[0]
        out = np.empty((nw, R, ps), dtype=np.uint8)
        Bu = np.ascontiguousarray(B, dtype=np.uint8)
        self.lib.gf8_bitmatrix_packets(R, C, _ptr(Bu), _ptr(flat), _ptr(out),
                                       nw, ps)
        return out.reshape(lead + (R, ps))
