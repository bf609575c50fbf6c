"""Typed wire messages: base class, registry, frame codec.

Python-native equivalent of the reference's Message layer (reference
src/msg/Message.h: one class per wire message with a u16 type code,
encode_payload/decode_payload over bufferlists; the 163 headers in
src/messages/).  Framing follows the msgr2 shape (reference
msg/async/frames_v2.h): a fixed preamble (magic, type, seq, payload
length) followed by the payload and a CRC32 over both — the framework's
"crc mode"; there is no secure mode yet.

Each concrete message defines TYPE, encode_payload() -> bytes and a
classmethod decode_payload(buf); @register adds it to the decode
registry keyed by TYPE.
"""
from __future__ import annotations

import abc
import struct
import time
import zlib
from typing import Callable, Dict, Optional, Type

from ..utils import copytrack
from ..utils.encoding import DecodeError

FRAME_MAGIC = 0x43455048  # "CEPH" — version 2 framing
_PREAMBLE = struct.Struct("<IHQI")  # magic, type, seq, payload_len
_CRC = struct.Struct("<I")

MSG_REGISTRY: Dict[int, Type["Message"]] = {}


def register(cls: Type["Message"]) -> Type["Message"]:
    assert cls.TYPE not in MSG_REGISTRY, \
        f"duplicate message type {cls.TYPE}"
    MSG_REGISTRY[cls.TYPE] = cls
    return cls


class Message(abc.ABC):
    """One wire message (reference msg/Message.h).  ``seq`` is stamped
    by the connection for at-most-once redelivery filtering after
    reconnect (reference out_seq/in_seq in ProtocolV1/V2)."""

    TYPE: int = 0

    def __init__(self) -> None:
        self.seq = 0                  # connection-stamped
        self.connection = None        # receive side: originating conn
        # cumulative hop ledger (utils/hops.py): hop name -> absolute
        # timestamp.  None until the first stamp; data-path messages
        # carry it as a trailing wire field, everything else keeps it
        # process-local.
        self.hops = None

    def stamp_hop(self, name: str, _now=time.time) -> None:
        """Record a hop timestamp, FIRST stamp wins: replies carry the
        request's ledger, so the generic messenger stamps on the reply
        leg (msgr_enqueue/wire_sent/recv) must not clobber the request
        leg's — the reply leg's wire time reads out of the final
        client_complete interval instead."""
        h = self.hops
        if h is None:
            h = self.hops = {}
        if name not in h:
            h[name] = _now()

    @abc.abstractmethod
    def encode_payload(self) -> bytes: ...

    def encode_payload_parts(self) -> list:
        """Payload as an iovec-style list of buffers for scatter-gather
        sends.  Hot-path messages override this to keep large data
        buffers by reference; the default materialises once."""
        return [self.encode_payload()]

    @classmethod
    @abc.abstractmethod
    def decode_payload(cls, buf: bytes) -> "Message": ...

    def get_type_name(self) -> str:
        return type(self).__name__

    def __repr__(self) -> str:
        return f"<{self.get_type_name()} seq={self.seq}>"


# type-field flag: payload is [1-byte codec id][compressed bytes]
# (reference msgr2 negotiates compression per-connection; here each
# frame is self-describing)
COMPRESSED_FLAG = 0x8000


def encode_frame_parts(msg: Message, compressor=None,
                       compress_min: int = 4096,
                       crc_data: bool = True) -> list:
    """Frame as an iovec list [head, *payload, crc] for scatter-gather
    ``socket.sendmsg`` — no payload byte is copied on the plain path.
    The CRC is folded incrementally over the parts, so it is identical
    to the joined-frame CRC."""
    parts = msg.encode_payload_parts()
    plen = sum(len(p) for p in parts)
    mtype = msg.TYPE
    if compressor is not None and plen >= compress_min:
        # compressors need one contiguous input; this join is the
        # price of compression, not of the framing
        payload = parts[0] if len(parts) == 1 \
            else b"".join(parts)  # copycheck: ok - compressor needs one contiguous input (copytracked below)
        if not isinstance(payload, bytes):
            payload = bytes(payload)  # copycheck: ok - compressor input materialisation
        if len(parts) > 1:
            copytrack.note_copy(plen, "msg.compress_join")
        comp = compressor.compress(payload)
        # require a REAL win, not a few bytes: a sub-percent size edge
        # is not worth the receiver's decompress cost (reference's
        # required-ratio idea, e.g. compression_required_ratio)
        if len(comp) + 1 < plen - (plen >> 3):
            parts = [bytes([compressor.numeric_id]) + comp]  # copycheck: ok - 1-byte codec id onto already-compressed data
            plen = len(parts[0])
            mtype |= COMPRESSED_FLAG
        else:
            parts = [payload]
    head = _PREAMBLE.pack(FRAME_MAGIC, mtype, msg.seq, plen)
    # reference ms_crc_data: a 0 sentinel skips the payload checksum
    # (secure mode's AEAD already authenticates; crc is then pure
    # overhead) — receivers accept the sentinel unconditionally
    if crc_data:
        crc = zlib.crc32(head)
        for p in parts:
            crc = zlib.crc32(p, crc)
    else:
        crc = 0
    return [head, *parts, _CRC.pack(crc)]


def encode_frame(msg: Message, compressor=None,
                 compress_min: int = 4096,
                 crc_data: bool = True) -> bytes:
    return b"".join(encode_frame_parts(  # copycheck: ok - joined-frame convenience form; senders use the parts
        msg, compressor=compressor, compress_min=compress_min,
        crc_data=crc_data))


def decode_frame_header(head: bytes):
    """-> (type, seq, payload_len); raises DecodeError on bad magic."""
    magic, mtype, seq, plen = _PREAMBLE.unpack(head)
    if magic != FRAME_MAGIC:
        raise DecodeError(f"bad frame magic {magic:#x}")
    return mtype, seq, plen


HEADER_LEN = _PREAMBLE.size
CRC_LEN = _CRC.size


def decode_frame_body(mtype: int, seq: int, head: bytes, payload: bytes,
                      crc_bytes: bytes) -> Message:
    (crc,) = _CRC.unpack(crc_bytes)
    if crc != 0:                         # 0 = sender ran ms_crc_data=false
        actual = zlib.crc32(payload, zlib.crc32(head))
        if crc != actual:
            raise DecodeError(
                f"payload crc mismatch: {crc:#x} != {actual:#x}")
    if mtype & COMPRESSED_FLAG:
        mtype &= ~COMPRESSED_FLAG
        if not payload:
            raise DecodeError("empty compressed payload")
        from ..compressor import registry
        try:
            codec = registry().create_by_id(payload[0])
            payload = codec.decompress(payload[1:])
        except Exception as e:
            raise DecodeError(f"decompress failed: {e}")
    cls = MSG_REGISTRY.get(mtype)
    if cls is None:
        raise DecodeError(f"unknown message type {mtype}")
    try:
        msg = cls.decode_payload(payload)
    except DecodeError:
        raise
    except Exception as e:
        # malformed payload from a buggy peer must read as a corrupt
        # stream, not kill the reader (json/KeyError/etc.)
        raise DecodeError(f"{cls.__name__} payload decode failed: {e}")
    msg.seq = seq
    return msg
