"""The port's message layer and hop ledger (ceph_tpu_torch.msg,
ceph_tpu_torch.utils.hops) against the JAX package's.

Twins of tests/test_msg.py's frame tests that need no socket and of
tests/test_waterfall.py's ledger unit tests, run on the port; then every
sample message framed by one package and decoded by the other, both
ways, with byte-equal frames and equal fields.  The socket Messenger is
not ported yet, so its tests have no twin here.
"""
import os

import pytest

from ceph_tpu.msg import message as ref_message
from ceph_tpu.msg import messages as RM
from ceph_tpu_torch.compressor import registry as compressor_registry
from ceph_tpu_torch.msg import message as port_message
from ceph_tpu_torch.msg import messages as M
from ceph_tpu_torch.msg.message import (HEADER_LEN, MSG_REGISTRY,
                                        decode_frame_body,
                                        decode_frame_header, encode_frame,
                                        encode_frame_parts)
from ceph_tpu_torch.utils.encoding import Decoder, DecodeError, Encoder
from ceph_tpu_torch.utils.hops import (CHARGE_ORDER, CONDITIONAL_HOPS,
                                       HOP_BOUNDS, HOP_ORDER, HopAccum,
                                       charge, decode_ledger, encode_ledger,
                                       merge_dumps, waterfall_block)


def sample_messages(M):
    """One instance of every registered message type, built from the
    message module ``M`` of either package."""
    return [
        M.MAck(acked_seq=17),
        M.MOSDOp(client="client.7", tid=3, epoch=9, pool=1, oid="obj-a",
                 ops=[M.OSDOp("write", 0, 5, b"hello"),
                      M.OSDOp("setxattr", data=b"v", name="k")],
                 pgid_seed=12, flags=1),
        M.MOSDOpReply(tid=3, result=-2, epoch=9,
                      out_data=[b"", b"payload"], extra={"v": 1}),
        M.MOSDECSubOpWrite(pgid="1.2", shard=3, from_osd=0, tid=8,
                           epoch=4, txn=b"\x01\x02",
                           log_entries=[{"op": "modify"}],
                           at_version=(4, 17)),
        M.MOSDECSubOpWriteReply(pgid="1.2", shard=3, from_osd=2, tid=8,
                                epoch=4, committed=True, result=0),
        M.MOSDECSubOpRead(pgid="1.2", shard=1, from_osd=0, tid=9,
                          epoch=4, reads=[("obj-a", 0, 4096)],
                          attrs_to_read=["hinfo_key"],
                          for_recovery=True),
        M.MOSDECSubOpReadReply(pgid="1.2", shard=1, from_osd=1, tid=9,
                               epoch=4, buffers=[("obj-a", 0, b"\xff")],
                               attrs=[("obj-a", {"hinfo_key": b"\x00"})],
                               errors=[("obj-b", -5)]),
        M.MOSDRepOp(pgid="2.0", from_osd=1, tid=5, epoch=3,
                    txn=b"tx", log_entries=[], at_version=(3, 2)),
        M.MOSDRepOpReply(pgid="2.0", from_osd=2, tid=5, epoch=3,
                         result=0),
        M.MOSDPGPush(pgid="1.0", shard=2, from_osd=0, epoch=7,
                     pushes=[M.PushOp(oid="x", data=b"d",
                                      attrs={"a": b"1"},
                                      omap={"k": b"v"},
                                      version=(7, 3))]),
        M.MOSDPGPushReply(pgid="1.0", shard=2, from_osd=2, epoch=7,
                          oids=["x"]),
        M.MOSDPGPull(pgid="1.0", shard=1, from_osd=0, epoch=7,
                     oids=["x", "y"]),
        M.MOSDPing(op=M.MOSDPing.PING_REPLY, from_osd=3, epoch=2,
                   stamp=123.5),
        M.MOSDMap(maps={3: {"epoch": 3}, 4: {"epoch": 4}}),
        M.MOSDBoot(osd=2, addr=("127.0.0.1", 7001)),
        M.MOSDFailure(target_osd=1, from_osd=0, failed_for=4.5, epoch=8),
        M.MOSDPGQuery(pgid="1.3", shard=2, from_osd=0, epoch=11),
        M.MOSDPGNotify(pgid="1.3", shard=2, from_osd=4, epoch=11,
                       log={"head": [11, 7], "entries": []},
                       missing={"o": {"need": [11, 7], "have": None}},
                       stray=True, objects={"o": [11, 7]},
                       stray_shard=1),
        M.MOSDPGRemove(pgid="1.9", from_osd=3, epoch=21),
        M.MOSDPGLog(pgid="1.3", shard=2, from_osd=0, epoch=11,
                    last_update=(11, 7),
                    entries=[{"op": "modify", "oid": "o"}],
                    backfill={"o2": [10, 1]}),
        M.MPGStats(from_osd=4, epoch=11,
                   pg_stats={"1.3": {"state": "active+clean"}}),
        M.MMonCommand(tid=1, cmd={"prefix": "osd pool create",
                                  "pool": "ec"}),
        M.MMonCommandAck(tid=1, retcode=0, rs="created",
                         out={"pool_id": 1}),
        M.MMonSubscribe(what={"osdmap": 5}),
        M.MOSDScrub(pgid="1.4", deep=True, repair=False),
        M.MRepScrub(pgid="1.4", shard=2, from_osd=0, tid=5, epoch=9,
                    deep=True),
        M.MRepScrubMap(pgid="1.4", shard=2, from_osd=1, tid=5,
                       scrub_map={"obj": {"size": 512, "data_crc": 7,
                                          "hinfo_ok": True}}),
        M.MCommand(tid=4, cmd={"prefix": "perf dump"}),
        M.MCommandReply(tid=4, retcode=0, rs="",
                        out={"osd": {"op": 12}}),
        M.MMonMon(op="begin", from_rank=0, epoch=6, version=9,
                  last_committed=8, value={"epoch": 9},
                  quorum=[0, 1, 2], maps={8: {"epoch": 8}},
                  pn=3),
        M.MWatchNotify(oid="hdr", pool=2, cookie=5, notify_id=9,
                       payload=b"ping", notifier="client.77"),
        M.MMDSOp(client="client.9", tid=4, op="mkdir",
                 args={"path": "/a/b"}),
        M.MMDSOpReply(tid=4, result=0, out={"ino": 7}),
        M.MMDSCapRecall(ino=7, cap_id=3),
    ]


SAMPLE_NAMES = [m.get_type_name() for m in sample_messages(M)]


def _decode(frame, message_mod):
    mtype, seq, plen = message_mod.decode_frame_header(frame[:HEADER_LEN])
    return message_mod.decode_frame_body(
        mtype, seq, frame[:HEADER_LEN], frame[HEADER_LEN:HEADER_LEN + plen],
        frame[HEADER_LEN + plen:])


def fields(obj):
    """A message's fields as plain data, the same for both packages:
    nested wire structs become (class name, fields), buffers bytes."""
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return bytes(obj)
    if isinstance(obj, dict):
        return {k: fields(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [fields(v) for v in obj]
    if hasattr(obj, "__dict__"):
        return (type(obj).__name__,
                {k: fields(v) for k, v in vars(obj).items()
                 if k != "connection"})
    return obj


# ------------------------------------------ twins of tests/test_msg.py
@pytest.mark.parametrize("msg", sample_messages(M),
                         ids=lambda m: m.get_type_name())
def test_frame_roundtrip(msg):
    msg.seq = 77
    frame = encode_frame(msg)
    mtype, seq, plen = decode_frame_header(frame[:HEADER_LEN])
    assert mtype == msg.TYPE and seq == 77
    out = decode_frame_body(mtype, seq, frame[:HEADER_LEN],
                            frame[HEADER_LEN:HEADER_LEN + plen],
                            frame[HEADER_LEN + plen:])
    assert type(out) is type(msg)
    assert out.encode_payload() == msg.encode_payload()


def test_every_sample_type_covered():
    covered = {type(m).TYPE for m in sample_messages(M)}
    assert covered == set(MSG_REGISTRY), \
        f"untested message types: {set(MSG_REGISTRY) - covered}"


def test_corrupt_frame_rejected():
    msg = M.MOSDPing(op=0, from_osd=1)
    frame = bytearray(encode_frame(msg))
    frame[-6] ^= 0xFF              # flip a payload byte
    mtype, seq, plen = decode_frame_header(bytes(frame[:HEADER_LEN]))
    with pytest.raises(DecodeError):
        decode_frame_body(mtype, seq, bytes(frame[:HEADER_LEN]),
                          bytes(frame[HEADER_LEN:HEADER_LEN + plen]),
                          bytes(frame[HEADER_LEN + plen:]))


def test_osdmap_wire_roundtrip():
    """OSDMap + CRUSH survive the MOSDMap wire form with identical
    placements (what OSDs receiving the map rely on)."""
    from ceph_tpu_torch.crush.wrapper import build_flat_map
    from ceph_tpu_torch.osd.osdmap import Incremental, OSDMap, PGPool, PGid

    m = OSDMap()
    inc = Incremental(1)
    inc.new_crush = build_flat_map(6, osds_per_host=2)
    rid = inc.new_crush.add_simple_rule("ec-rule", "default", "host",
                                        mode="indep",
                                        pool_type="erasure")
    inc.new_pools[1] = PGPool(name="ecpool", pool_id=1, type="erasure",
                              size=3, min_size=2, pg_num=16,
                              crush_rule=rid,
                              erasure_code_profile="gpu-prof")
    inc.new_profiles["gpu-prof"] = {"plugin": "gpu", "k": "2", "m": "1"}
    for o in range(6):
        inc.new_up[o] = ("127.0.0.1", 7000 + o)
    m.apply_incremental(inc)

    out = _decode(encode_frame(M.MOSDMap(maps={1: m.to_wire_dict()})),
                  port_message)
    m2 = OSDMap.from_wire_dict(out.maps[1])
    assert m2.epoch == m.epoch
    assert m2.erasure_code_profiles["gpu-prof"]["plugin"] == "gpu"
    for seed in range(16):
        pgid = PGid(1, seed)
        assert m2.pg_to_up_acting_osds(pgid) == \
            m.pg_to_up_acting_osds(pgid)


@pytest.mark.parametrize("msg", sample_messages(M),
                         ids=lambda m: m.get_type_name())
def test_frame_parts_bitexact_with_joined_frame(msg):
    """The scatter-gather iovec list serializes to EXACTLY the bytes of
    the joined frame (CRC folded over parts included)."""
    msg.seq = 31
    parts = encode_frame_parts(msg)
    assert b"".join(parts) == encode_frame(msg)


def test_large_payload_rides_frame_parts_by_reference():
    """An EC sub-write's transaction buffer appears in the frame iovecs
    as the SAME object — the wire path may not copy it."""
    blob = os.urandom(64 << 10)
    m = M.MOSDECSubOpWrite(pgid="1.2", shard=3, from_osd=0, tid=8,
                           epoch=4, txn=blob, log_entries=[],
                           at_version=(4, 17))
    m.seq = 1
    parts = encode_frame_parts(m)
    assert any(p is blob for p in parts), \
        "txn payload was copied into the frame instead of riding " \
        "the iovec list by reference"


# ------------------------------------------- the two packages, one wire
def test_registries_assign_the_same_type_ids():
    assert {t: c.__name__ for t, c in MSG_REGISTRY.items()} == \
        {t: c.__name__ for t, c in ref_message.MSG_REGISTRY.items()}


@pytest.mark.parametrize("i", range(len(SAMPLE_NAMES)),
                         ids=SAMPLE_NAMES)
@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_frames_cross_between_packages(i, direction):
    """A frame built by either package is byte-equal to the other's
    and decodes there to the same fields."""
    port, ref = sample_messages(M)[i], sample_messages(RM)[i]
    for msg in (port, ref):
        msg.seq = 9
        msg.stamp_hop("client_send", _now=lambda: 1000.0)
        msg.stamp_hop("recv", _now=lambda: 1000.25)
    pf, rf = encode_frame(port), ref_message.encode_frame(ref)
    assert pf == rf
    if direction == "port_to_ref":
        out, want = _decode(pf, ref_message), port
    else:
        out, want = _decode(rf, port_message), ref
    assert type(out).__name__ == type(want).__name__
    got = fields(out)[1]
    exp = fields(want)[1]
    if want.hops is not None and out.hops is None:
        exp.pop("hops")             # a carrier-less type keeps it local
        got.pop("hops")
    assert got == exp


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_compressed_frames_cross_between_packages(direction):
    """A sub-write framed with compression decodes in the other package
    (the codec id byte and the payload are the same)."""
    blob = bytes(range(256)) * 64
    port = M.MOSDECSubOpWrite(pgid="1.2", shard=3, from_osd=0, tid=8,
                              epoch=4, txn=blob, log_entries=[],
                              at_version=(4, 17))
    ref = RM.MOSDECSubOpWrite(pgid="1.2", shard=3, from_osd=0, tid=8,
                              epoch=4, txn=blob, log_entries=[],
                              at_version=(4, 17))
    codec = compressor_registry().create("zlib")
    from ceph_tpu.compressor import registry as ref_compressors
    rcodec = ref_compressors().create("zlib")
    pf = encode_frame(port, compressor=codec)
    rf = ref_message.encode_frame(ref, compressor=rcodec)
    assert pf == rf
    mtype = decode_frame_header(pf[:HEADER_LEN])[0]
    assert mtype & port_message.COMPRESSED_FLAG
    out = _decode(pf, ref_message) if direction == "port_to_ref" \
        else _decode(rf, port_message)
    assert bytes(out.txn) == blob and out.tid == 8


# ------------------------------- twins of tests/test_waterfall.py's units
def _carriers():
    """One instance of every ledger-bearing message type."""
    return [
        M.MOSDOp(client="client.7", tid=3, epoch=9, pool=1, oid="obj",
                 ops=[M.OSDOp("write", 0, 5, b"hello")],
                 pgid_seed=2, flags=1),
        M.MOSDOpReply(tid=3, result=0, epoch=9, out_data=[b"x"],
                      extra={"v": 1}),
        M.MOSDECSubOpWrite(pgid="1.2", shard=3, from_osd=0, tid=8,
                           epoch=4, txn=b"\x01\x02", log_entries=[],
                           at_version=(4, 17)),
        M.MOSDECSubOpWriteReply(pgid="1.2", shard=3, from_osd=2, tid=8,
                                epoch=4, committed=True, result=0),
        M.MOSDRepOp(pgid="2.0", from_osd=1, tid=5, epoch=3, txn=b"tx",
                    log_entries=[], at_version=(3, 2)),
        M.MOSDRepOpReply(pgid="2.0", from_osd=2, tid=5, epoch=3,
                         result=0),
        M.MOSDECSubOpRead(pgid="1.2", shard=1, from_osd=0, tid=9,
                          epoch=4, reads=[("obj", 0, 4096)],
                          attrs_to_read=["_"], for_recovery=True),
        M.MOSDECSubOpReadReply(pgid="1.2", shard=1, from_osd=3, tid=9,
                               epoch=4, buffers=[("obj", 0, b"d")],
                               attrs=[("obj", {"_": b"v"})],
                               errors=[("gone", -2)]),
        M.MOSDPGPush(pgid="1.2", shard=2, from_osd=0, epoch=4),
        M.MOSDPGPull(pgid="1.2", shard=2, from_osd=1, epoch=4,
                     oids=["obj"]),
        M.MOSDPGPushReply(pgid="1.2", shard=2, from_osd=2, epoch=4,
                          oids=["obj"]),
    ]


def _stamp(msg, names, t0=1000.0):
    for i, name in enumerate(names):
        msg.stamp_hop(name, _now=lambda t=t0 + i / 100.0: t)
    return msg


@pytest.mark.parametrize("msg", _carriers(),
                         ids=lambda m: m.get_type_name())
def test_ledger_rides_every_carrier(msg):
    _stamp(msg, ("client_send", "recv", "store_apply", "commit_sent"))
    out = type(msg).decode_payload(msg.encode_payload())
    assert out.hops == msg.hops


@pytest.mark.parametrize("msg", _carriers(),
                         ids=lambda m: m.get_type_name())
def test_old_peer_payload_decodes_with_no_ledger(msg):
    """A pre-ledger sender's payload (today's minus the trailing ledger)
    decodes to the same message with hops None — never raises."""
    _stamp(msg, ("client_send", "recv"))
    new_payload = msg.encode_payload()
    e = Encoder()
    encode_ledger(e, msg.hops)
    tail = len(e.build())
    assert tail == 1 + 9 * len(msg.hops)
    out = type(msg).decode_payload(new_payload[:-tail])
    assert out.hops is None
    ref = type(msg).decode_payload(new_payload)
    ref.hops = None
    assert out.encode_payload() == ref.encode_payload()


def test_new_payload_readable_by_old_decoder():
    """A pre-ledger decoder reads the prefix fields and never looks at
    the trailing ledger."""
    m = _stamp(M.MOSDECSubOpWriteReply(pgid="1.2", shard=3, from_osd=2,
                                       tid=8, epoch=4, committed=True,
                                       result=-5, seg=2),
               ("recv", "store_apply", "commit_sent"))
    d = Decoder(m.encode_payload())
    assert (d.str(), d.i32(), d.i32(), d.u64(), d.u32(), d.bool(),
            d.i32(), d.u32()) == ("1.2", 3, 2, 8, 4, True, -5, 2)
    assert d.remaining() == 1 + 9 * 3
    r = _stamp(M.MOSDRepOpReply(pgid="2.0", from_osd=1, tid=5, epoch=3,
                                result=0), ("recv",))
    d = Decoder(r.encode_payload())
    assert (d.str(), d.i32(), d.u64(), d.u32(), d.i32()) == \
        ("2.0", 1, 5, 3, 0)
    assert d.remaining() == 1 + 9


def test_decoder_skips_unknown_hop_ids():
    e = Encoder()
    e.u8(2)
    e.u8(0)
    e.f64(1000.0)
    e.u8(200)                               # from the future
    e.f64(1001.0)
    assert decode_ledger(Decoder(e.build())) == {"client_send": 1000.0}


def test_garbled_ledger_trailer_reads_as_none():
    e = Encoder()
    e.u8(5)                                 # claims 5 entries, has 0
    assert decode_ledger(Decoder(e.build())) is None
    assert decode_ledger(Decoder(b"")) is None


def test_frame_roundtrip_keeps_ledger():
    msg = _stamp(_carriers()[0], ("client_send", "msgr_enqueue",
                                  "wire_sent"))
    msg.seq = 5
    assert _decode(encode_frame(msg), port_message).hops == msg.hops


def test_charge_sum_equals_wall_with_gaps():
    hops = {"client_send": 10.0, "msgr_enqueue": 10.002,
            "wire_sent": 10.003, "recv": 10.010,
            "dispatch_queued": 10.011, "pg_locked": 10.020,
            "store_apply": 10.090, "commit_sent": 10.091,
            "client_complete": 10.100}
    charged = charge(hops)
    assert abs(sum(dt for _, dt in charged) - 0.100) < 1e-12
    names = [n for n, _ in charged]
    assert "client_send" not in names
    assert "pg_queued" not in names
    assert dict(charged)["pg_locked"] == pytest.approx(0.009)


def test_stamp_hop_first_wins():
    m = M.MOSDOpReply(tid=1)
    m.stamp_hop("recv", _now=lambda: 5.0)
    m.stamp_hop("recv", _now=lambda: 9.0)
    assert m.hops == {"recv": 5.0}


def test_hop_accum_and_waterfall_block():
    acc = HopAccum()
    for _ in range(4):
        acc.observe_wire({"client_send": 0.0, "recv": 0.010,
                          "store_apply": 0.030,
                          "client_complete": 0.040})
    acc.observe_wire(None)
    acc.observe_wire({"recv": 1.0})
    d = acc.dump()
    assert d["ops"] == 4
    assert d["op_seconds"] == pytest.approx(4 * 0.040)
    wf = waterfall_block(d, wall_s=0.32)
    assert wf["sum_of_shares"] == pytest.approx(1.0, abs=1e-3)
    assert wf["vs_wall"] == pytest.approx(1.0, abs=1e-3)
    assert sum(wf["scaled_s"].values()) == pytest.approx(0.32, rel=1e-3)
    assert wf["top_hop"] == "store_apply"
    assert set(wf["p99_s"]) == {"recv", "store_apply",
                                "client_complete"}


def test_merge_dumps_adds_buckets_and_recomputes_percentiles():
    a, b = HopAccum(), HopAccum()
    a.observe_wire({"client_send": 0.0, "recv": 0.001})
    b.observe_wire({"client_send": 0.0, "recv": 0.200})
    merged = merge_dumps([a.dump(), b.dump(), {}])
    assert merged["ops"] == 2
    assert merged["hop_counts"]["recv"] == 2
    assert sum(merged["buckets"]["recv"]) == 2
    assert merged["p99_s"]["recv"] >= 0.200 * 0.9
    assert len(merged["bounds"]) == len(HOP_BOUNDS)


def test_xshard_hop_wire_id_stable():
    assert HOP_ORDER.index("xshard_handoff") == 10
    assert set(CHARGE_ORDER) == set(HOP_ORDER)
    i = CHARGE_ORDER.index
    assert i("pg_queued") < i("xshard_handoff") < i("pg_locked")


def test_charge_places_xshard_between_queue_and_lock():
    hops = {"client_send": 0.0, "msgr_enqueue": 0.001,
            "wire_sent": 0.002, "recv": 0.010,
            "dispatch_queued": 0.011, "pg_queued": 0.012,
            "xshard_handoff": 0.030, "pg_locked": 0.031,
            "store_apply": 0.090, "commit_sent": 0.091,
            "client_complete": 0.100}
    charged = dict(charge(hops))
    assert charged["xshard_handoff"] == pytest.approx(0.018)
    assert charged["pg_locked"] == pytest.approx(0.001)
    assert sum(charged.values()) == pytest.approx(0.100)
    e = Encoder()
    encode_ledger(e, hops)
    assert decode_ledger(Decoder(e.build())) == hops


def test_read_hop_wire_ids_stable():
    assert [HOP_ORDER.index(h) for h in
            ("read_queued", "shard_read", "decode_dispatch",
             "decode_complete", "scrub_window")] == [11, 12, 13, 14, 15]
    assert set(CHARGE_ORDER) == set(HOP_ORDER)
    i = CHARGE_ORDER.index
    assert i("pg_locked") < i("read_queued") < i("shard_read") \
        < i("decode_dispatch") < i("decode_complete") \
        < i("store_apply")
    assert CHARGE_ORDER[-1] == "scrub_window"
    assert {"read_queued", "shard_read", "decode_dispatch",
            "decode_complete", "scrub_window"} <= CONDITIONAL_HOPS


def test_peer_ack_wait_hop_wire_id_stable():
    assert HOP_ORDER.index("peer_ack_wait") == 16
    assert set(CHARGE_ORDER) == set(HOP_ORDER)
    i = CHARGE_ORDER.index
    assert i("store_apply") < i("peer_ack_wait") < i("commit_sent")


def test_charge_splits_local_commit_from_peer_ack_wait():
    hops = {"client_send": 0.0, "msgr_enqueue": 0.001,
            "wire_sent": 0.002, "recv": 0.010,
            "dispatch_queued": 0.011, "pg_queued": 0.012,
            "pg_locked": 0.013, "store_apply": 0.020,
            "peer_ack_wait": 0.090, "commit_sent": 0.091,
            "client_complete": 0.100}
    charged = dict(charge(hops))
    assert charged["store_apply"] == pytest.approx(0.007)
    assert charged["peer_ack_wait"] == pytest.approx(0.070)
    assert sum(charged.values()) == pytest.approx(0.100)
    hops2 = dict(hops, store_apply=0.090, peer_ack_wait=0.090)
    charged2 = dict(charge(hops2))
    assert charged2["store_apply"] == pytest.approx(0.077)
    assert charged2["peer_ack_wait"] == pytest.approx(0.0)
    e = Encoder()
    encode_ledger(e, hops)
    assert decode_ledger(Decoder(e.build())) == hops


def test_charge_read_path_ledger():
    hops = {"client_send": 0.0, "msgr_enqueue": 0.001,
            "wire_sent": 0.002, "recv": 0.010,
            "dispatch_queued": 0.011, "pg_queued": 0.012,
            "pg_locked": 0.013, "read_queued": 0.014,
            "decode_dispatch": 0.050, "decode_complete": 0.055,
            "commit_sent": 0.056, "client_complete": 0.060}
    charged = dict(charge(hops))
    assert charged["decode_dispatch"] == pytest.approx(0.036)
    assert charged["decode_complete"] == pytest.approx(0.005)
    assert "store_apply" not in charged
    assert sum(charged.values()) == pytest.approx(0.060)
