"""CRC32C (Castagnoli) with a native kernel + pure-Python fallback.

Python-native equivalent of the reference's crc32c facade (reference
src/common/crc32c.h choosing intel-fast / aarch64 / sctp at runtime):
``crc32c(data, crc=0)`` dispatches to the repo's native/crc32c.cc,
built on demand with g++ into build/ and loaded with ctypes, and falls
back to a table-driven Python implementation when no compiler is
present.

The library is loaded as a ``ctypes.PyDLL``, whose calls keep the
interpreter lock: a call takes about a microsecond a 4 KiB block, and a
``CDLL`` call, which drops the lock and must win it back, waited up to
tens of milliseconds for it among a crimson cluster's runnable reactor
threads, so a store read that checks 128 block checksums held its
reactor for seconds.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "crc32c.cc")
_SO = os.path.join(_ROOT, "build", "libceph_tpu_torch_crc32c.so")

_lib: Optional[ctypes.PyDLL] = None
_tried = False
_lock = threading.Lock()


def _load() -> Optional[ctypes.PyDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or (
                os.path.exists(_SRC) and
                os.path.getmtime(_SRC) > os.path.getmtime(_SO)):
            try:
                os.makedirs(os.path.dirname(_SO), exist_ok=True)
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared",
                     "-fPIC", "-o", _SO, _SRC],
                    check=True, capture_output=True, timeout=120)
            except (OSError, subprocess.SubprocessError):
                return None
        try:
            lib = ctypes.PyDLL(_SO)
        except OSError:
            return None
        lib.crc32c_init()
        lib.crc32c.restype = ctypes.c_uint32
        lib.crc32c.argtypes = [ctypes.c_uint32,
                               ctypes.POINTER(ctypes.c_uint8),
                               ctypes.c_size_t]
        _lib = lib
        return _lib


# -- pure-python fallback (table-driven, reference crc32c_sctp) --------
_PY_TABLE: Optional[list] = None


def _py_table() -> list:
    global _PY_TABLE
    if _PY_TABLE is None:
        poly = 0x82F63B78
        tbl = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (poly ^ (c >> 1)) if (c & 1) else (c >> 1)
            tbl.append(c)
        _PY_TABLE = tbl
    return _PY_TABLE


def _py_crc32c(data: bytes, crc: int) -> int:
    tbl = _py_table()
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def available_native() -> bool:
    return _load() is not None


def crc32c(data, crc: int = 0) -> int:
    """Running CRC32C over any bytes-like; chain by passing the
    previous value.  Writable buffers (bytearray, memoryview, uint8
    ndarray) are checksummed in place; immutable bytes need the ctypes
    copy (from_buffer rejects them)."""
    lib = _load()
    if lib is None:
        if not isinstance(data, (bytes, bytearray)):
            data = bytes(data)
        return _py_crc32c(data, crc)
    n = len(data)
    try:
        buf = (ctypes.c_uint8 * n).from_buffer(data)
    except (TypeError, ValueError, BufferError):
        buf = (ctypes.c_uint8 * n).from_buffer_copy(data)
    return lib.crc32c(crc, buf, n)
