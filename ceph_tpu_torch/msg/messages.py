"""The typed message catalog.

Python-native equivalents of the reference's per-message headers
(reference src/messages/): the ~15 messages the OSD data path, the
monitor control plane, heartbeats, and recovery need (SURVEY §7 step 6).
Data-plane payloads (client ops, EC sub-ops, pushes) are tight binary
via utils/encoding.py; low-rate control-plane structures (cluster
maps, mon commands, PG log entries) ride as JSON blobs of their
to_wire_dict forms, the framework's moral equivalent of the reference's
versioned struct encodings.

Message -> reference mapping:
  MOSDOp/MOSDOpReply           messages/MOSDOp.h, MOSDOpReply.h
  MOSDECSubOpWrite/...Reply    messages/MOSDECSubOpWrite.h (ECSubWrite)
  MOSDECSubOpRead/...Reply     messages/MOSDECSubOpRead.h (ECSubRead)
  MOSDRepOp/MOSDRepOpReply     messages/MOSDRepOp.h (replicated backend)
  MOSDPGPush/MOSDPGPushReply   messages/MOSDPGPush.h (recovery PushOp)
  MOSDPing                     messages/MOSDPing.h
  MOSDMap                      messages/MOSDMap.h
  MOSDBoot/MOSDFailure         messages/MOSDBoot.h, MOSDFailure.h
  MMonCommand/MMonCommandAck   messages/MMonCommand.h, MMonCommandAck.h
  MMonSubscribe                messages/MMonSubscribe.h
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..utils.encoding import Decoder, Encoder
from ..utils.hops import decode_ledger, encode_ledger
from .message import Message, register


def _enc_json(obj) -> bytes:
    return json.dumps(obj, separators=(",", ":")).encode()


def _dec_json(buf: bytes):
    return json.loads(buf.decode())


# ---------------------------------------------------------------------------
# transport control
# ---------------------------------------------------------------------------

@register
class MAck(Message):
    """Delivery ack: everything up to ``acked_seq`` arrived; the sender
    trims its resend queue (reference ProtocolV1/V2 per-message ACK
    tags).  Handled inside the messenger, never dispatched; not itself
    seq-stamped or retained."""
    TYPE = 1

    def __init__(self, acked_seq: int = 0):
        super().__init__()
        self.acked_seq = acked_seq

    def encode_payload(self) -> bytes:
        return Encoder().u64(self.acked_seq).build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MAck":
        return cls(acked_seq=Decoder(buf).u64())


# ---------------------------------------------------------------------------
# client ops
# ---------------------------------------------------------------------------

@dataclass
class OSDOp:
    """One sub-operation of a client op (reference OSDOp / the op codes
    of PrimaryLogPG::do_osd_ops' switch, osd/PrimaryLogPG.cc:5737).
    ``op`` is a name: write, writefull, read, stat, delete, truncate,
    append, setxattr, getxattr, omap_set, omap_get, ..."""
    op: str
    offset: int = 0
    length: int = 0
    data: bytes = b""
    name: str = ""          # xattr/omap key where applicable

    def encode(self, e: Encoder) -> None:
        e.str(self.op).u64(self.offset).u64(self.length)
        e.bytes(self.data).str(self.name)

    @classmethod
    def decode(cls, d: Decoder) -> "OSDOp":
        return cls(op=d.str(), offset=d.u64(), length=d.u64(),
                   data=d.bytes(), name=d.str())


@register
class MOSDOp(Message):
    TYPE = 42  # reference CEPH_MSG_OSD_OP

    def __init__(self, client: str = "", tid: int = 0, epoch: int = 0,
                 pool: int = 0, oid: str = "",
                 ops: Optional[List[OSDOp]] = None,
                 pgid_seed: int = 0, flags: int = 0,
                 trace_id: int = 0, snap_seq: int = 0,
                 snaps: Optional[List[int]] = None, snapid: int = 0,
                 parent_span_id: int = 0):
        super().__init__()
        self.client = client
        self.tid = tid
        self.epoch = epoch           # client's map epoch
        self.pool = pool
        self.oid = oid
        self.ops = ops or []
        self.pgid_seed = pgid_seed
        self.flags = flags
        self.trace_id = trace_id     # blkin-style trace context (0=off)
        self.parent_span_id = parent_span_id   # client root span
        # write SnapContext (reference MOSDOp snapc) + read snap
        self.snap_seq = snap_seq
        self.snaps = snaps or []
        self.snapid = snapid         # 0 = head (reference CEPH_NOSNAP)

    def _enc(self) -> Encoder:
        e = Encoder()
        e.str(self.client).u64(self.tid).u32(self.epoch)
        e.i64(self.pool).str(self.oid).u32(self.pgid_seed)
        e.u32(self.flags).u64(self.trace_id)
        e.u64(self.snap_seq).i64_list(self.snaps).u64(self.snapid)
        e.u32(len(self.ops))
        for op in self.ops:
            op.encode(e)
        e.u64(self.parent_span_id)
        encode_ledger(e, self.hops)
        return e

    def encode_payload(self) -> bytes:
        return self._enc().build()

    def encode_payload_parts(self) -> list:
        # op data buffers (write payloads) ride by reference
        return self._enc().build_parts()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MOSDOp":
        d = Decoder(buf)
        m = cls(client=d.str(), tid=d.u64(), epoch=d.u32(), pool=d.i64(),
                oid=d.str(), pgid_seed=d.u32(), flags=d.u32(),
                trace_id=d.u64())
        m.snap_seq = d.u64()
        m.snaps = [int(x) for x in d.i64_list()]
        m.snapid = d.u64()
        m.ops = [OSDOp.decode(d) for _ in range(d.u32())]
        m.parent_span_id = d.u64()
        m.hops = decode_ledger(d)
        return m


@register
class MOSDOpReply(Message):
    TYPE = 43  # reference CEPH_MSG_OSD_OPREPLY

    def __init__(self, tid: int = 0, result: int = 0, epoch: int = 0,
                 out_data: Optional[List[bytes]] = None,
                 extra: Optional[dict] = None):
        super().__init__()
        self.tid = tid
        self.result = result         # 0 or -errno
        self.epoch = epoch           # replier's map epoch
        self.out_data = out_data or []
        self.extra = extra or {}     # op-specific structured outputs

    def _enc(self) -> Encoder:
        e = Encoder()
        e.u64(self.tid).i32(self.result).u32(self.epoch)
        e.u32(len(self.out_data))
        for b in self.out_data:
            e.bytes(b)
        e.bytes(_enc_json(self.extra))
        encode_ledger(e, self.hops)
        return e

    def encode_payload(self) -> bytes:
        return self._enc().build()

    def encode_payload_parts(self) -> list:
        return self._enc().build_parts()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MOSDOpReply":
        d = Decoder(buf)
        m = cls(tid=d.u64(), result=d.i32(), epoch=d.u32())
        m.out_data = [d.bytes() for _ in range(d.u32())]
        m.extra = _dec_json(d.bytes())
        m.hops = decode_ledger(d)
        return m


# ---------------------------------------------------------------------------
# EC backend sub-ops (reference osd/ECMsgTypes.h)
# ---------------------------------------------------------------------------

@register
class MOSDECSubOpWrite(Message):
    """Primary -> shard: apply this shard's transaction (reference
    ECSubWrite carried by messages/MOSDECSubOpWrite.h).

    Parity-delta RMW sub-writes (ecbackend._try_delta_rmw) use this
    SAME message: the transaction simply carries ``xor_write`` store
    ops for parity shards (identical wire shape to ``write``; the
    store XORs the payload into the committed chunk) and plain writes
    for dirty data shards — no schema or TYPE change, so mixed-version
    acting sets keep interoperating."""
    TYPE = 108

    def __init__(self, pgid: str = "", shard: int = -1,
                 from_osd: int = -1, tid: int = 0, epoch: int = 0,
                 txn: bytes = b"", log_entries: Optional[list] = None,
                 at_version: Tuple[int, int] = (0, 0),
                 trace_id: int = 0, parent_span_id: int = 0,
                 seg: int = 0):
        super().__init__()
        self.pgid = pgid             # str(PGid), shard-free
        self.shard = shard           # destination shard position
        self.from_osd = from_osd     # primary's osd id
        self.tid = tid
        self.epoch = epoch
        self.seg = seg               # pipeline segment index within
                                     # the tid (deadline re-requests
                                     # dedup on (from, tid, seg))
        # encoded store Transaction: bytes, or a list of buffer
        # fragments (Transaction.encode_parts()) kept by reference
        # until the socket — receivers always see joined bytes
        self.txn = txn
        self.log_entries = log_entries or []   # pg-log dicts
        self.at_version = at_version
        self.trace_id = trace_id     # blkin-style trace context
        self.parent_span_id = parent_span_id   # primary's osd_op span

    def _enc(self) -> Encoder:
        e = Encoder()
        e.str(self.pgid).i32(self.shard).i32(self.from_osd)
        e.u64(self.tid).u32(self.epoch)
        if isinstance(self.txn, (list, tuple)):
            e.bytes_parts(self.txn)
        else:
            e.bytes(self.txn)
        e.bytes(_enc_json(self.log_entries))
        e.u32(self.at_version[0]).u64(self.at_version[1])
        e.u64(self.trace_id)
        e.u64(self.parent_span_id)
        e.u32(self.seg)
        encode_ledger(e, self.hops)
        return e

    def encode_payload(self) -> bytes:
        return self._enc().build()

    def encode_payload_parts(self) -> list:
        # shard chunk buffers inside txn ride by reference to sendmsg
        return self._enc().build_parts()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MOSDECSubOpWrite":
        d = Decoder(buf)
        m = cls(pgid=d.str(), shard=d.i32(), from_osd=d.i32(),
                tid=d.u64(), epoch=d.u32(), txn=d.bytes())
        m.log_entries = _dec_json(d.bytes())
        m.at_version = (d.u32(), d.u64())
        m.trace_id = d.u64()
        m.parent_span_id = d.u64()
        m.seg = d.u32()
        m.hops = decode_ledger(d)
        return m


@register
class MOSDECSubOpWriteReply(Message):
    TYPE = 109

    def __init__(self, pgid: str = "", shard: int = -1,
                 from_osd: int = -1, tid: int = 0, epoch: int = 0,
                 committed: bool = True, result: int = 0,
                 seg: int = 0):
        super().__init__()
        self.pgid = pgid
        self.shard = shard           # replying shard
        self.from_osd = from_osd
        self.tid = tid
        self.epoch = epoch
        self.committed = committed
        self.result = result
        self.seg = seg               # acked segment index (primary
                                     # drops duplicate seg acks)

    def encode_payload(self) -> bytes:
        e = Encoder()
        e.str(self.pgid).i32(self.shard).i32(self.from_osd)
        e.u64(self.tid).u32(self.epoch).bool(self.committed)
        e.i32(self.result)
        e.u32(self.seg)
        encode_ledger(e, self.hops)
        return e.build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MOSDECSubOpWriteReply":
        d = Decoder(buf)
        m = cls(pgid=d.str(), shard=d.i32(), from_osd=d.i32(),
                tid=d.u64(), epoch=d.u32(), committed=d.bool(),
                result=d.i32(), seg=d.u32())
        m.hops = decode_ledger(d)
        return m


@register
class MOSDECSubOpRead(Message):
    """Primary -> shard: read chunk extents (+ attrs) for reconstruction
    or recovery (reference ECSubRead, messages/MOSDECSubOpRead.h:21)."""
    TYPE = 110

    def __init__(self, pgid: str = "", shard: int = -1,
                 from_osd: int = -1, tid: int = 0, epoch: int = 0,
                 reads: Optional[List[Tuple[str, int, int]]] = None,
                 attrs_to_read: Optional[List[str]] = None,
                 for_recovery: bool = False, trace_id: int = 0,
                 parent_span_id: int = 0):
        super().__init__()
        self.pgid = pgid
        self.shard = shard
        self.from_osd = from_osd
        self.tid = tid
        self.epoch = epoch
        self.reads = reads or []     # (oid, offset, length)
        self.attrs_to_read = attrs_to_read or []
        self.for_recovery = for_recovery
        self.trace_id = trace_id     # blkin-style trace context
        self.parent_span_id = parent_span_id

    def encode_payload(self) -> bytes:
        e = Encoder()
        e.str(self.pgid).i32(self.shard).i32(self.from_osd)
        e.u64(self.tid).u32(self.epoch)
        e.u32(len(self.reads))
        for oid, off, length in self.reads:
            e.str(oid).u64(off).i64(length)
        e.str_list(self.attrs_to_read)
        e.bool(self.for_recovery)
        e.u64(self.trace_id).u64(self.parent_span_id)
        encode_ledger(e, self.hops)
        return e.build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MOSDECSubOpRead":
        d = Decoder(buf)
        m = cls(pgid=d.str(), shard=d.i32(), from_osd=d.i32(),
                tid=d.u64(), epoch=d.u32())
        m.reads = [(d.str(), d.u64(), d.i64()) for _ in range(d.u32())]
        m.attrs_to_read = d.str_list()
        m.for_recovery = d.bool()
        m.trace_id = d.u64()
        m.parent_span_id = d.u64()
        m.hops = decode_ledger(d)
        return m


@register
class MOSDECSubOpReadReply(Message):
    TYPE = 111

    def __init__(self, pgid: str = "", shard: int = -1,
                 from_osd: int = -1, tid: int = 0, epoch: int = 0,
                 buffers: Optional[List[Tuple[str, int, bytes]]] = None,
                 attrs: Optional[List[Tuple[str, Dict[str, bytes]]]] = None,
                 errors: Optional[List[Tuple[str, int]]] = None):
        super().__init__()
        self.pgid = pgid
        self.shard = shard           # replying shard position
        self.from_osd = from_osd     # replying osd id
        self.tid = tid
        self.epoch = epoch
        self.buffers = buffers or []   # (oid, offset, data)
        self.attrs = attrs or []       # (oid, {attr: value})
        self.errors = errors or []     # (oid, -errno)

    def encode_payload(self) -> bytes:
        e = Encoder()
        e.str(self.pgid).i32(self.shard).i32(self.from_osd)
        e.u64(self.tid).u32(self.epoch)
        e.u32(len(self.buffers))
        for oid, off, data in self.buffers:
            e.str(oid).u64(off).bytes(data)
        e.u32(len(self.attrs))
        for oid, attrs in self.attrs:
            e.str(oid).str_bytes_map(attrs)
        e.u32(len(self.errors))
        for oid, err in self.errors:
            e.str(oid).i32(err)
        encode_ledger(e, self.hops)
        return e.build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MOSDECSubOpReadReply":
        d = Decoder(buf)
        m = cls(pgid=d.str(), shard=d.i32(), from_osd=d.i32(),
                tid=d.u64(), epoch=d.u32())
        m.buffers = [(d.str(), d.u64(), d.bytes())
                     for _ in range(d.u32())]
        m.attrs = [(d.str(), d.str_bytes_map()) for _ in range(d.u32())]
        m.errors = [(d.str(), d.i32()) for _ in range(d.u32())]
        m.hops = decode_ledger(d)
        return m


# ---------------------------------------------------------------------------
# replicated backend sub-ops (reference messages/MOSDRepOp.h)
# ---------------------------------------------------------------------------

@register
class MOSDRepOp(Message):
    TYPE = 112

    def __init__(self, pgid: str = "", from_osd: int = -1, tid: int = 0,
                 epoch: int = 0, txn: bytes = b"",
                 log_entries: Optional[list] = None,
                 at_version: Tuple[int, int] = (0, 0),
                 trace_id: int = 0, parent_span_id: int = 0):
        super().__init__()
        self.pgid = pgid
        self.from_osd = from_osd
        self.tid = tid
        self.epoch = epoch
        self.txn = txn
        self.log_entries = log_entries or []
        self.at_version = at_version
        self.trace_id = trace_id
        self.parent_span_id = parent_span_id

    def encode_payload(self) -> bytes:
        e = Encoder()
        e.str(self.pgid).i32(self.from_osd).u64(self.tid)
        e.u32(self.epoch).bytes(self.txn)
        e.bytes(_enc_json(self.log_entries))
        e.u32(self.at_version[0]).u64(self.at_version[1])
        e.u64(self.trace_id)
        e.u64(self.parent_span_id)
        encode_ledger(e, self.hops)
        return e.build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MOSDRepOp":
        d = Decoder(buf)
        m = cls(pgid=d.str(), from_osd=d.i32(), tid=d.u64(),
                epoch=d.u32(), txn=d.bytes())
        m.log_entries = _dec_json(d.bytes())
        m.at_version = (d.u32(), d.u64())
        m.trace_id = d.u64()
        m.parent_span_id = d.u64()
        m.hops = decode_ledger(d)
        return m


@register
class MOSDRepOpReply(Message):
    TYPE = 113

    def __init__(self, pgid: str = "", from_osd: int = -1, tid: int = 0,
                 epoch: int = 0, result: int = 0):
        super().__init__()
        self.pgid = pgid
        self.from_osd = from_osd
        self.tid = tid
        self.epoch = epoch
        self.result = result

    def encode_payload(self) -> bytes:
        e = Encoder()
        e.str(self.pgid).i32(self.from_osd).u64(self.tid)
        e.u32(self.epoch).i32(self.result)
        encode_ledger(e, self.hops)
        return e.build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MOSDRepOpReply":
        d = Decoder(buf)
        m = cls(pgid=d.str(), from_osd=d.i32(), tid=d.u64(),
                epoch=d.u32(), result=d.i32())
        m.hops = decode_ledger(d)
        return m


# ---------------------------------------------------------------------------
# recovery pushes (reference messages/MOSDPGPush.h)
# ---------------------------------------------------------------------------

@dataclass
class PushOp:
    """One object (or object chunk) being pushed to a shard that is
    missing it (reference PushOp in osd/osd_types.h)."""
    oid: str
    data_offset: int = 0
    data: bytes = b""
    attrs: Dict[str, bytes] = field(default_factory=dict)
    omap: Dict[str, bytes] = field(default_factory=dict)
    complete: bool = True      # last chunk of the object
    version: Tuple[int, int] = (0, 0)

    def encode(self, e: Encoder) -> None:
        e.str(self.oid).u64(self.data_offset).bytes(self.data)
        e.str_bytes_map(self.attrs).str_bytes_map(self.omap)
        e.bool(self.complete)
        e.u32(self.version[0]).u64(self.version[1])

    @classmethod
    def decode(cls, d: Decoder) -> "PushOp":
        return cls(oid=d.str(), data_offset=d.u64(), data=d.bytes(),
                   attrs=d.str_bytes_map(), omap=d.str_bytes_map(),
                   complete=d.bool(), version=(d.u32(), d.u64()))


@register
class MOSDPGPush(Message):
    TYPE = 105  # reference MSG_OSD_PG_PUSH

    def __init__(self, pgid: str = "", shard: int = -1,
                 from_osd: int = -1, epoch: int = 0,
                 pushes: Optional[List[PushOp]] = None):
        super().__init__()
        self.pgid = pgid
        self.shard = shard
        self.from_osd = from_osd
        self.epoch = epoch
        self.pushes = pushes or []

    def encode_payload(self) -> bytes:
        e = Encoder()
        e.str(self.pgid).i32(self.shard).i32(self.from_osd)
        e.u32(self.epoch).u32(len(self.pushes))
        for p in self.pushes:
            p.encode(e)
        encode_ledger(e, self.hops)
        return e.build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MOSDPGPush":
        d = Decoder(buf)
        m = cls(pgid=d.str(), shard=d.i32(), from_osd=d.i32(),
                epoch=d.u32())
        m.pushes = [PushOp.decode(d) for _ in range(d.u32())]
        m.hops = decode_ledger(d)
        return m


@register
class MOSDPGPull(Message):
    """Primary -> surviving replica: send me these objects — the
    primary itself is missing them (reference MSG_OSD_PG_PULL,
    messages/MOSDPGPull.h; the holder answers with MOSDPGPush)."""
    TYPE = 107

    def __init__(self, pgid: str = "", shard: int = -1,
                 from_osd: int = -1, epoch: int = 0,
                 oids: Optional[List[str]] = None):
        super().__init__()
        self.pgid = pgid
        self.shard = shard           # the holder's shard position
        self.from_osd = from_osd
        self.epoch = epoch
        self.oids = oids or []

    def encode_payload(self) -> bytes:
        e = Encoder()
        e.str(self.pgid).i32(self.shard).i32(self.from_osd)
        e.u32(self.epoch).str_list(self.oids)
        encode_ledger(e, self.hops)
        return e.build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MOSDPGPull":
        d = Decoder(buf)
        m = cls(pgid=d.str(), shard=d.i32(), from_osd=d.i32(),
                epoch=d.u32(), oids=d.str_list())
        m.hops = decode_ledger(d)
        return m


@register
class MOSDPGPushReply(Message):
    TYPE = 106

    def __init__(self, pgid: str = "", shard: int = -1,
                 from_osd: int = -1, epoch: int = 0,
                 oids: Optional[List[str]] = None):
        super().__init__()
        self.pgid = pgid
        self.shard = shard
        self.from_osd = from_osd
        self.epoch = epoch
        self.oids = oids or []

    def encode_payload(self) -> bytes:
        e = Encoder()
        e.str(self.pgid).i32(self.shard).i32(self.from_osd)
        e.u32(self.epoch).str_list(self.oids)
        encode_ledger(e, self.hops)
        return e.build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MOSDPGPushReply":
        d = Decoder(buf)
        m = cls(pgid=d.str(), shard=d.i32(), from_osd=d.i32(),
                epoch=d.u32(), oids=d.str_list())
        m.hops = decode_ledger(d)
        return m


# ---------------------------------------------------------------------------
# heartbeat / maps / boot / failure (reference MOSDPing.h, MOSDMap.h, ...)
# ---------------------------------------------------------------------------

@register
class MOSDPing(Message):
    TYPE = 70
    PING = 0
    PING_REPLY = 1

    def __init__(self, op: int = PING, from_osd: int = -1,
                 epoch: int = 0, stamp: float = 0.0,
                 padding: str = ""):
        super().__init__()
        self.op = op
        self.from_osd = from_osd
        self.epoch = epoch
        self.stamp = stamp           # echoed for RTT accounting
        self.padding = padding       # osd_heartbeat_min_size filler
                                     # (exposes MTU blackholes)

    def encode_payload(self) -> bytes:
        e = Encoder()
        e.u8(self.op).i32(self.from_osd).u32(self.epoch).f64(self.stamp)
        e.str(self.padding)
        return e.build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MOSDPing":
        d = Decoder(buf)
        return cls(op=d.u8(), from_osd=d.i32(), epoch=d.u32(),
                   stamp=d.f64(), padding=d.str())


@register
class MOSDMap(Message):
    """Full maps keyed by epoch, JSON of OSDMap.to_wire_dict (the
    reference ships encoded OSDMap + Incrementals; full maps keep the
    control plane simple at these cluster sizes)."""
    TYPE = 41  # reference CEPH_MSG_OSD_MAP

    def __init__(self, maps: Optional[Dict[int, dict]] = None):
        super().__init__()
        self.maps = maps or {}       # epoch -> wire dict

    def encode_payload(self) -> bytes:
        e = Encoder()
        e.u32(len(self.maps))
        for epoch in sorted(self.maps):
            e.u32(epoch).bytes(_enc_json(self.maps[epoch]))
        return e.build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MOSDMap":
        d = Decoder(buf)
        m = cls()
        for _ in range(d.u32()):
            epoch = d.u32()
            m.maps[epoch] = _dec_json(d.bytes())
        return m


@register
class MOSDBoot(Message):
    TYPE = 71

    def __init__(self, osd: int = -1, addr: Tuple[str, int] = ("", 0)):
        super().__init__()
        self.osd = osd
        self.addr = addr

    def encode_payload(self) -> bytes:
        e = Encoder()
        e.i32(self.osd).str(self.addr[0]).u16(self.addr[1])
        return e.build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MOSDBoot":
        d = Decoder(buf)
        return cls(osd=d.i32(), addr=(d.str(), d.u16()))


@register
class MOSDFailure(Message):
    TYPE = 72

    def __init__(self, target_osd: int = -1, from_osd: int = -1,
                 failed_for: float = 0.0, epoch: int = 0):
        super().__init__()
        self.target_osd = target_osd
        self.from_osd = from_osd
        self.failed_for = failed_for   # seconds without a ping reply
        self.epoch = epoch

    def encode_payload(self) -> bytes:
        e = Encoder()
        e.i32(self.target_osd).i32(self.from_osd)
        e.f64(self.failed_for).u32(self.epoch)
        return e.build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MOSDFailure":
        d = Decoder(buf)
        return cls(target_osd=d.i32(), from_osd=d.i32(),
                   failed_for=d.f64(), epoch=d.u32())


# ---------------------------------------------------------------------------
# peering (reference MOSDPGQuery.h, MOSDPGNotify.h, MOSDPGLog.h)
# ---------------------------------------------------------------------------

@register
class MOSDPGQuery(Message):
    """Primary -> acting member: report your PG info + log (reference
    messages/MOSDPGQuery.h; the payload the reference splits across
    pg_query_t variants is collapsed to one full-info query)."""
    TYPE = 80

    def __init__(self, pgid: str = "", shard: int = -1,
                 from_osd: int = -1, epoch: int = 0):
        super().__init__()
        self.pgid = pgid
        self.shard = shard           # queried shard position
        self.from_osd = from_osd
        self.epoch = epoch

    def encode_payload(self) -> bytes:
        e = Encoder()
        e.str(self.pgid).i32(self.shard).i32(self.from_osd)
        e.u32(self.epoch)
        return e.build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MOSDPGQuery":
        d = Decoder(buf)
        return cls(pgid=d.str(), shard=d.i32(), from_osd=d.i32(),
                   epoch=d.u32())


@register
class MOSDPGRemove(Message):
    """Child-PG primary -> split-stray holder: the child is clean on
    its acting set; delete your stray copy (reference
    messages/MOSDPGRemove.h, sent by the reference when strays are no
    longer needed after peering)."""
    TYPE = 96

    def __init__(self, pgid: str = "", from_osd: int = -1,
                 epoch: int = 0):
        super().__init__()
        self.pgid = pgid
        self.from_osd = from_osd
        self.epoch = epoch

    def encode_payload(self) -> bytes:
        e = Encoder()
        e.str(self.pgid).i32(self.from_osd).u32(self.epoch)
        return e.build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MOSDPGRemove":
        d = Decoder(buf)
        return cls(pgid=d.str(), from_osd=d.i32(), epoch=d.u32())


@register
class MOSDPGNotify(Message):
    """Acting member -> primary: my info + full (bounded) log + my
    persistent missing set (reference messages/MOSDPGNotify.h carries
    pg_info_t; the missing set rides MOSDPGLog in the reference —
    shipping it in the notify keeps peering one round trip).  The
    missing set matters when a shard's *log* is current but its *data*
    is not (log adopted, recovery interrupted by an interval change):
    without it the primary would see no log delta and wrongly assume
    the shard is whole."""
    TYPE = 81

    def __init__(self, pgid: str = "", shard: int = -1,
                 from_osd: int = -1, epoch: int = 0,
                 log: Optional[dict] = None,
                 missing: Optional[dict] = None,
                 stray: bool = False,
                 objects: Optional[dict] = None,
                 stray_shard: int = -1,
                 split_adopted: bool = False):
        super().__init__()
        self.pgid = pgid
        self.shard = shard           # replying shard position
        self.from_osd = from_osd
        self.epoch = epoch
        self.log = log or {}         # PGLog.to_dict()
        self.missing = missing or {}  # MissingSet.to_dict()
        # split-stray self-notify (no reference message carries these:
        # the reference's past_intervals machinery makes the primary
        # query strays; here strays announce themselves — see
        # PG.maybe_split / PG._notify_as_stray)
        self.stray = stray
        self.objects = objects or {}  # oid -> [epoch, v] (stray only)
        self.stray_shard = stray_shard  # EC shard the stray holds
        # True when this copy was produced by a parent PG's split
        # (adopt_split): its content IS the ancestry's answer, so a
        # child primary may activate on (0,0) heads without a stray
        self.split_adopted = split_adopted

    def encode_payload(self) -> bytes:
        e = Encoder()
        e.str(self.pgid).i32(self.shard).i32(self.from_osd)
        e.u32(self.epoch).bytes(_enc_json(self.log))
        e.bytes(_enc_json(self.missing))
        e.u8(1 if self.stray else 0)
        e.bytes(_enc_json(self.objects)).i32(self.stray_shard)
        e.u8(1 if self.split_adopted else 0)
        return e.build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MOSDPGNotify":
        d = Decoder(buf)
        return cls(pgid=d.str(), shard=d.i32(), from_osd=d.i32(),
                   epoch=d.u32(), log=_dec_json(d.bytes()),
                   missing=_dec_json(d.bytes()), stray=bool(d.u8()),
                   objects=_dec_json(d.bytes()), stray_shard=d.i32(),
                   split_adopted=bool(d.u8()))


@register
class MOSDPGLog(Message):
    """Primary -> acting member: activation with the authoritative log
    (reference messages/MOSDPGLog.h): either the catch-up entries past
    the member's head, or ``backfill`` objects (oid -> version) when
    the log no longer reaches back far enough."""
    TYPE = 82

    def __init__(self, pgid: str = "", shard: int = -1,
                 from_osd: int = -1, epoch: int = 0,
                 last_update: Tuple[int, int] = (0, 0),
                 entries: Optional[list] = None,
                 backfill: Optional[Dict[str, list]] = None):
        super().__init__()
        self.pgid = pgid
        self.shard = shard           # destination shard position
        self.from_osd = from_osd
        self.epoch = epoch
        self.last_update = last_update
        self.entries = entries or []         # LogEntry.to_dict()s
        self.backfill = backfill             # None = log-based

    def encode_payload(self) -> bytes:
        e = Encoder()
        e.str(self.pgid).i32(self.shard).i32(self.from_osd)
        e.u32(self.epoch)
        e.u32(self.last_update[0]).u64(self.last_update[1])
        e.bytes(_enc_json(self.entries))
        e.bool(self.backfill is not None)
        if self.backfill is not None:
            e.bytes(_enc_json(self.backfill))
        return e.build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MOSDPGLog":
        d = Decoder(buf)
        m = cls(pgid=d.str(), shard=d.i32(), from_osd=d.i32(),
                epoch=d.u32())
        m.last_update = (d.u32(), d.u64())
        m.entries = _dec_json(d.bytes())
        if d.bool():
            m.backfill = _dec_json(d.bytes())
        return m


@register
class MPGStats(Message):
    """OSD -> mon: per-PG health stats from the PGs this OSD leads
    (reference messages/MPGStats.h / pg_stat_t), aggregated by the
    monitor into cluster health ("active+clean" gating
    wait_for_clean)."""
    TYPE = 83

    def __init__(self, from_osd: int = -1, epoch: int = 0,
                 pg_stats: Optional[Dict[str, dict]] = None,
                 osd_stat: Optional[dict] = None):
        super().__init__()
        self.from_osd = from_osd
        self.epoch = epoch
        self.pg_stats = pg_stats or {}   # pgid -> stat dict
        self.osd_stat = osd_stat or {}   # osd_stat_t: store usage

    def encode_payload(self) -> bytes:
        e = Encoder()
        e.i32(self.from_osd).u32(self.epoch)
        e.bytes(_enc_json(self.pg_stats))
        e.bytes(_enc_json(self.osd_stat))
        return e.build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MPGStats":
        d = Decoder(buf)
        return cls(from_osd=d.i32(), epoch=d.u32(),
                   pg_stats=_dec_json(d.bytes()),
                   osd_stat=_dec_json(d.bytes()))


# ---------------------------------------------------------------------------
# scrub (reference messages/MOSDScrub.h, MOSDRepScrub.h, MOSDRepScrubMap.h)
# ---------------------------------------------------------------------------

@register
class MOSDScrub(Message):
    """mon/admin -> primary OSD: scrub this PG (reference
    messages/MOSDScrub.h; triggered by 'ceph pg scrub|deep-scrub|
    repair', mon/MonCommands.h)."""
    TYPE = 90

    def __init__(self, pgid: str = "", deep: bool = False,
                 repair: bool = False):
        super().__init__()
        self.pgid = pgid
        self.deep = deep
        self.repair = repair

    def encode_payload(self) -> bytes:
        return (Encoder().str(self.pgid)
                .u8(int(self.deep)).u8(int(self.repair)).build())

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MOSDScrub":
        d = Decoder(buf)
        return cls(pgid=d.str(), deep=bool(d.u8()), repair=bool(d.u8()))


@register
class MRepScrub(Message):
    """Primary -> replica/shard: build and return your scrub map for
    this PG (reference messages/MOSDRepScrub.h)."""
    TYPE = 91

    def __init__(self, pgid: str = "", shard: int = -1,
                 from_osd: int = -1, tid: int = 0, epoch: int = 0,
                 deep: bool = False):
        super().__init__()
        self.pgid = pgid
        self.shard = shard
        self.from_osd = from_osd
        self.tid = tid
        self.epoch = epoch
        self.deep = deep

    def encode_payload(self) -> bytes:
        return (Encoder().str(self.pgid).i32(self.shard)
                .i32(self.from_osd).u64(self.tid).u32(self.epoch)
                .u8(int(self.deep)).build())

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MRepScrub":
        d = Decoder(buf)
        return cls(pgid=d.str(), shard=d.i32(), from_osd=d.i32(),
                   tid=d.u64(), epoch=d.u32(), deep=bool(d.u8()))


@register
class MRepScrubMap(Message):
    """Replica/shard -> primary: my scrub map (reference
    messages/MOSDRepScrubMap.h; ScrubMap in osd/scrubber types).
    ``scrub_map`` is oid -> {size, oi_version, data_crc, omap_crc,
    attrs_crc, stored_crc, error}."""
    TYPE = 92

    def __init__(self, pgid: str = "", shard: int = -1,
                 from_osd: int = -1, tid: int = 0,
                 scrub_map: Optional[Dict[str, dict]] = None):
        super().__init__()
        self.pgid = pgid
        self.shard = shard
        self.from_osd = from_osd
        self.tid = tid
        self.scrub_map = scrub_map or {}

    def encode_payload(self) -> bytes:
        return (Encoder().str(self.pgid).i32(self.shard)
                .i32(self.from_osd).u64(self.tid)
                .bytes(_enc_json(self.scrub_map)).build())

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MRepScrubMap":
        d = Decoder(buf)
        return cls(pgid=d.str(), shard=d.i32(), from_osd=d.i32(),
                   tid=d.u64(), scrub_map=_dec_json(d.bytes()))


@register
class MCommand(Message):
    """Daemon-direct command (reference messages/MCommand.h — the
    transport behind ``ceph tell <daemon> ...`` and the mgr's perf
    collection)."""
    TYPE = 94

    def __init__(self, tid: int = 0, cmd: Optional[dict] = None):
        super().__init__()
        self.tid = tid
        self.cmd = cmd or {}

    def encode_payload(self) -> bytes:
        return Encoder().u64(self.tid).bytes(_enc_json(self.cmd)).build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MCommand":
        d = Decoder(buf)
        return cls(tid=d.u64(), cmd=_dec_json(d.bytes()))


@register
class MCommandReply(Message):
    """Reply to MCommand (reference messages/MCommandReply.h)."""
    TYPE = 95

    def __init__(self, tid: int = 0, retcode: int = 0, rs: str = "",
                 out: Optional[dict] = None):
        super().__init__()
        self.tid = tid
        self.retcode = retcode
        self.rs = rs
        self.out = out or {}

    def encode_payload(self) -> bytes:
        return (Encoder().u64(self.tid).i32(self.retcode).str(self.rs)
                .bytes(_enc_json(self.out)).build())

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MCommandReply":
        d = Decoder(buf)
        return cls(tid=d.u64(), retcode=d.i32(), rs=d.str(),
                   out=_dec_json(d.bytes()))


@register
class MMonMon(Message):
    """Mon <-> mon quorum traffic (reference messages/MMonElection.h +
    MMonPaxos.h collapsed into one op-tagged frame).  ``op`` is one of:
    election ops ``propose``/``ack``/``victory``; paxos ops ``begin``/
    ``accept``/``commit``/``lease``; catch-up ops ``sync_req``/``sync``.
    ``value``/``maps`` carry full OSDMap wire dicts (low-rate control
    plane, JSON like the mon command path)."""
    TYPE = 93

    def __init__(self, op: str = "", from_rank: int = -1,
                 epoch: int = 0, version: int = 0,
                 last_committed: int = 0,
                 value: Optional[dict] = None,
                 quorum: Optional[List[int]] = None,
                 maps: Optional[Dict[int, dict]] = None,
                 pn: int = 0):
        super().__init__()
        self.op = op
        self.from_rank = from_rank
        self.epoch = epoch                  # election epoch
        self.version = version              # paxos version (map epoch)
        self.last_committed = last_committed
        self.value = value                  # proposed full-map wire dict
        self.quorum = quorum or []
        self.maps = maps or {}              # epoch -> wire dict (sync)
        self.pn = pn                        # proposal number of a carried
                                            # accepted-but-uncommitted value
                                            # (reference Paxos uncommitted_pn)

    def encode_payload(self) -> bytes:
        e = Encoder()
        e.str(self.op).i32(self.from_rank).u32(self.epoch)
        e.u32(self.version).u32(self.last_committed)
        e.bytes(_enc_json(self.value))
        e.i64_list(self.quorum)
        e.bytes(_enc_json({str(k): v for k, v in self.maps.items()}))
        e.u32(self.pn)
        return e.build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MMonMon":
        d = Decoder(buf)
        out = cls(op=d.str(), from_rank=d.i32(), epoch=d.u32(),
                  version=d.u32(), last_committed=d.u32())
        out.value = _dec_json(d.bytes())
        out.quorum = [int(x) for x in d.i64_list()]
        out.maps = {int(k): v for k, v in _dec_json(d.bytes()).items()}
        out.pn = d.u32()
        return out


# ---------------------------------------------------------------------------
# monitor control plane (reference MMonCommand.h, MMonSubscribe.h)
# ---------------------------------------------------------------------------

@register
class MMonCommand(Message):
    TYPE = 50

    def __init__(self, tid: int = 0, cmd: Optional[dict] = None):
        super().__init__()
        self.tid = tid
        self.cmd = cmd or {}         # {"prefix": "osd pool create", ...}

    def encode_payload(self) -> bytes:
        e = Encoder()
        e.u64(self.tid).bytes(_enc_json(self.cmd))
        return e.build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MMonCommand":
        d = Decoder(buf)
        return cls(tid=d.u64(), cmd=_dec_json(d.bytes()))


@register
class MMonCommandAck(Message):
    TYPE = 51

    def __init__(self, tid: int = 0, retcode: int = 0, rs: str = "",
                 out: Optional[dict] = None):
        super().__init__()
        self.tid = tid
        self.retcode = retcode
        self.rs = rs                 # human-readable status
        self.out = out or {}         # structured output

    def encode_payload(self) -> bytes:
        e = Encoder()
        e.u64(self.tid).i32(self.retcode).str(self.rs)
        e.bytes(_enc_json(self.out))
        return e.build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MMonCommandAck":
        d = Decoder(buf)
        return cls(tid=d.u64(), retcode=d.i32(), rs=d.str(),
                   out=_dec_json(d.bytes()))


@register
class MMonSubscribe(Message):
    """Subscribe to map deliveries from this epoch on (reference
    MMonSubscribe.h; deliveries arrive as MOSDMap)."""
    TYPE = 52

    def __init__(self, what: Optional[Dict[str, int]] = None):
        super().__init__()
        self.what = what or {}       # {"osdmap": start_epoch}

    def encode_payload(self) -> bytes:
        e = Encoder()
        e.u32(len(self.what))
        for name in sorted(self.what):
            e.str(name).u32(self.what[name])
        return e.build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MMonSubscribe":
        d = Decoder(buf)
        return cls(what={d.str(): d.u32() for _ in range(d.u32())})


# ---------------------------------------------------------------------------
# watch/notify (reference messages/MWatchNotify.h + osd/Watch.cc)
# ---------------------------------------------------------------------------

@register
class MWatchNotify(Message):
    """OSD -> watching client push: a notify on an object the client
    watches (reference MWatchNotify.h).  The client answers with a
    ``notify_ack`` OSD op carrying the same notify_id."""
    TYPE = 44  # reference CEPH_MSG_WATCH_NOTIFY

    def __init__(self, oid: str = "", pool: int = 0, cookie: int = 0,
                 notify_id: int = 0, payload: bytes = b"",
                 notifier: str = ""):
        super().__init__()
        self.oid = oid
        self.pool = pool
        self.cookie = cookie         # the watcher's registration handle
        self.notify_id = notify_id
        self.payload = payload
        self.notifier = notifier     # notifying client's name

    def encode_payload(self) -> bytes:
        e = Encoder()
        e.str(self.oid).i64(self.pool).u64(self.cookie)
        e.u64(self.notify_id).bytes(self.payload).str(self.notifier)
        return e.build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MWatchNotify":
        d = Decoder(buf)
        return cls(oid=d.str(), pool=d.i64(), cookie=d.u64(),
                   notify_id=d.u64(), payload=d.bytes(),
                   notifier=d.str())


# ---------------------------------------------------------------------------
# MDS (reference messages/MClientRequest.h / MClientReply.h /
# MClientCaps.h collapsed to op-tagged frames)
# ---------------------------------------------------------------------------

@register
class MMDSOp(Message):
    """Client -> MDS metadata operation (reference MClientRequest):
    ``op`` names the handler (mkdir, create, open, stat, listdir,
    unlink, rmdir, rename, setattr, cap_release, truncate...), args
    ride as a JSON dict (control-plane rates)."""
    TYPE = 45

    def __init__(self, client: str = "", tid: int = 0, op: str = "",
                 args: Optional[dict] = None):
        super().__init__()
        self.client = client
        self.tid = tid
        self.op = op
        self.args = args or {}

    def encode_payload(self) -> bytes:
        e = Encoder()
        e.str(self.client).u64(self.tid).str(self.op)
        e.bytes(_enc_json(self.args))
        return e.build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MMDSOp":
        d = Decoder(buf)
        return cls(client=d.str(), tid=d.u64(), op=d.str(),
                   args=_dec_json(d.bytes()))


@register
class MMDSOpReply(Message):
    """MDS -> client reply (reference MClientReply)."""
    TYPE = 46

    def __init__(self, tid: int = 0, result: int = 0,
                 out: Optional[dict] = None):
        super().__init__()
        self.tid = tid
        self.result = result         # 0 or -errno
        self.out = out or {}

    def encode_payload(self) -> bytes:
        e = Encoder()
        e.u64(self.tid).i32(self.result)
        e.bytes(_enc_json(self.out))
        return e.build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MMDSOpReply":
        d = Decoder(buf)
        return cls(tid=d.u64(), result=d.i32(),
                   out=_dec_json(d.bytes()))


@register
class MMDSCapRecall(Message):
    """MDS -> client push: give back the write capability on ``ino``
    (reference MClientCaps CAP_OP_REVOKE).  The client answers with a
    ``cap_release`` MMDSOp carrying its buffered size/mtime."""
    TYPE = 47

    def __init__(self, ino: int = 0, cap_id: int = 0,
                 rank: int = 0):
        super().__init__()
        self.ino = ino
        self.cap_id = cap_id
        # granting rank (multi-MDS): the client's release must come
        # BACK here — ino alone cannot be path-routed
        self.rank = rank

    def encode_payload(self) -> bytes:
        return Encoder().u64(self.ino).u64(self.cap_id) \
            .u64(self.rank).build()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "MMDSCapRecall":
        d = Decoder(buf)
        return cls(ino=d.u64(), cap_id=d.u64(), rank=d.u64())
