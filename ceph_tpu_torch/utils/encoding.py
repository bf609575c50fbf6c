"""Wire/disk encoding primitives.

Python-native equivalent of the reference's bufferlist encode/decode
layer (reference src/include/encoding.h: little-endian fixed-width
integers, length-prefixed strings/buffers, containers encoded as
count + elements; versioned struct envelopes via ENCODE_START /
DECODE_START with struct_v + compat_v + length so old decoders can
skip unknown trailing fields).

Used by the object-store Transaction encoding and the messenger's
typed message payloads, so on-wire and on-disk formats share one
codec — as in the reference, where both are bufferlists.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple


class DecodeError(ValueError):
    """Malformed or truncated buffer (maps buffer::malformed_input)."""


# Buffers at/above this size are appended by reference (as a flat
# memoryview) instead of being copied into the encoder.  Callers hand
# over ownership: a buffer passed to Encoder.bytes()/bytes_parts()
# must not be mutated until the encoded output has been consumed.
ZC_MIN = 2048


def _flat_view(v) -> Optional[memoryview]:
    """1-D byte view of any C-contiguous bytes-like / ndarray, else
    None (caller falls back to a copy)."""
    try:
        m = memoryview(v)
    except TypeError:
        return None
    if not m.c_contiguous:
        return None
    return m.cast("B") if (m.ndim != 1 or m.format != "B") else m


class Encoder:
    """Append-only little-endian encoder (reference encode(..., bl)).

    Large buffers (>= ZC_MIN) are held by reference; ``build()`` joins
    everything into one bytes, while ``build_parts()`` returns a short
    iovec-style list (small parts coalesced, large buffers untouched)
    suitable for scatter-gather ``socket.sendmsg``."""

    def __init__(self) -> None:
        self._parts: List[bytes] = []

    # -- fixed-width integers ---------------------------------------------
    def u8(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<B", v)); return self

    def u16(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<H", v)); return self

    def u32(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<I", v)); return self

    def u64(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<Q", v)); return self

    def i32(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<i", v)); return self

    def i64(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<q", v)); return self

    def f64(self, v: float) -> "Encoder":
        self._parts.append(struct.pack("<d", v)); return self

    def bool(self, v: bool) -> "Encoder":
        return self.u8(1 if v else 0)

    # -- length-prefixed payloads -----------------------------------------
    def bytes(self, v) -> "Encoder":
        """u32 length + raw bytes (reference encode(bufferlist)).
        bytes pass through untouched; other bytes-likes (bytearray,
        memoryview, uint8 ndarray) are referenced without a copy when
        large, so the payload rides as an iovec to the socket."""
        if type(v) is bytes:
            self.u32(len(v))
            self._parts.append(v)
            return self
        m = _flat_view(v)
        if m is None:
            b = bytes(v)
            self.u32(len(b))
            self._parts.append(b)
            return self
        self.u32(m.nbytes)
        self._parts.append(m if m.nbytes >= ZC_MIN else m.tobytes())
        return self

    def bytes_parts(self, parts) -> "Encoder":
        """One length-prefixed buffer supplied as a list of fragments
        (e.g. Transaction.encode_parts()); fragments are referenced,
        never joined."""
        views = []
        total = 0
        for p in parts:
            m = _flat_view(p)
            if m is None:
                m = bytes(p)
                total += len(m)
            else:
                total += m.nbytes
            views.append(m)
        self.u32(total)
        self._parts.extend(views)
        return self

    def str(self, v: str) -> "Encoder":
        return self.bytes(v.encode("utf-8"))

    def str_list(self, vs) -> "Encoder":
        vs = list(vs)
        self.u32(len(vs))
        for v in vs:
            self.str(v)
        return self

    def i64_list(self, vs) -> "Encoder":
        vs = list(vs)
        self.u32(len(vs))
        for v in vs:
            self.i64(v)
        return self

    def str_bytes_map(self, m: Dict[str, bytes]) -> "Encoder":
        self.u32(len(m))
        for k in sorted(m):
            self.str(k).bytes(m[k])
        return self

    def str_str_map(self, m: Dict[str, str]) -> "Encoder":
        self.u32(len(m))
        for k in sorted(m):
            self.str(k).str(m[k])
        return self

    # -- versioned envelope (ENCODE_START/ENCODE_FINISH) ------------------
    def struct(self, struct_v: int, compat_v: int,
               body: "Encoder") -> "Encoder":
        self.u8(struct_v).u8(compat_v).u32(body.nbytes())
        self._parts.extend(body._parts)
        return self

    def nbytes(self) -> int:
        return sum(len(p) for p in self._parts)

    def build(self) -> bytes:
        return b"".join(self._parts)

    def build_parts(self) -> List:
        """Iovec-style part list: runs of small fragments are joined
        into one bytes each; large by-reference buffers stay as-is so
        no payload byte is copied."""
        out: List = []
        run: List[bytes] = []
        for p in self._parts:
            if len(p) >= ZC_MIN:
                if run:
                    out.append(run[0] if len(run) == 1 else b"".join(run))
                    run = []
                out.append(p)
            else:
                run.append(p)
        if run:
            out.append(run[0] if len(run) == 1 else b"".join(run))
        return out


class Decoder:
    """Cursor-based decoder over one buffer (reference decode(..., bl))."""

    def __init__(self, buf: bytes, pos: int = 0, end: Optional[int] = None):
        self._buf = buf
        self._pos = pos
        self._end = len(buf) if end is None else end

    def _take(self, n: int) -> bytes:
        if self._pos + n > self._end:
            raise DecodeError(
                f"truncated: need {n} bytes at {self._pos}, "
                f"have {self._end - self._pos}")
        v = self._buf[self._pos:self._pos + n]
        self._pos += n
        return v

    def remaining(self) -> int:
        return self._end - self._pos

    # -- fixed-width integers ---------------------------------------------
    def u8(self) -> int:
        return struct.unpack("<B", self._take(1))[0]

    def u16(self) -> int:
        return struct.unpack("<H", self._take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self._take(8))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self._take(8))[0]

    def bool(self) -> bool:
        return self.u8() != 0

    # -- length-prefixed payloads -----------------------------------------
    def bytes(self) -> bytes:
        return self._take(self.u32())

    def str(self) -> str:
        try:
            return self.bytes().decode("utf-8")
        except UnicodeDecodeError as e:
            raise DecodeError(f"bad utf-8 string: {e}")

    def str_list(self) -> List[str]:
        return [self.str() for _ in range(self.u32())]

    def i64_list(self) -> List[int]:
        return [self.i64() for _ in range(self.u32())]

    def str_bytes_map(self) -> Dict[str, bytes]:
        return {self.str(): self.bytes() for _ in range(self.u32())}

    def str_str_map(self) -> Dict[str, str]:
        return {self.str(): self.str() for _ in range(self.u32())}

    # -- versioned envelope (DECODE_START/DECODE_FINISH) ------------------
    def struct(self, max_known_v: int) -> Tuple[int, "Decoder"]:
        """-> (struct_v, sub-decoder bounded to the struct payload).
        Skips trailing unknown bytes, as DECODE_FINISH does; raises if
        the peer requires a newer decoder (compat_v > max_known_v)."""
        struct_v = self.u8()
        compat_v = self.u8()
        length = self.u32()
        if compat_v > max_known_v:
            raise DecodeError(
                f"struct compat_v {compat_v} > decoder version "
                f"{max_known_v}")
        if self._pos + length > self._end:
            raise DecodeError("truncated struct payload")
        sub = Decoder(self._buf, self._pos, self._pos + length)
        self._pos += length
        return struct_v, sub
