"""Port twins of the JAX package's socket messenger tests
(tests/test_msg.py, test_send_receive through
test_plain_wire_path_notes_no_copies; the frame-only tests there are
twinned in tests/test_torch_msg.py) and of tests/test_auth_compress.py:
the keyring, the auth commands, cephx sessions, the compressor registry,
compressed frames and secure (AES-GCM) frames, on ceph_tpu_torch.
Clusters run classic OSDs (osd_backend="classic"), except the twin of
test_thread_count_documented_at_scale, which runs at the config
default, crimson OSDs, as its reference does: with classic OSDs the
threads-per-daemon-pair slope depends on how many heartbeat connections
are open when it counts, and measured 6.1 to 8.8 in the port over a few
runs, against the bound of 8.  The secure-mode
tests need the `cryptography` package and skip without it, as the
messenger imports it only in secure mode."""
import os
import threading
import time

import pytest

from ceph_tpu_torch.auth.keyring import Keyring, generate_key
from ceph_tpu_torch.cluster import Cluster
from ceph_tpu_torch.cluster import test_config as cluster_conf
from ceph_tpu_torch.compressor import registry
from ceph_tpu_torch.msg import messages as M
from ceph_tpu_torch.msg.message import (COMPRESSED_FLAG, HEADER_LEN,
                                        decode_frame_body,
                                        decode_frame_header, encode_frame)
from ceph_tpu_torch.msg.messenger import Dispatcher, Messenger
from ceph_tpu_torch.utils.config import Config


def make_conf(**over):
    """The cluster test timings, with classic OSDs."""
    over.setdefault("osd_backend", "classic")
    return cluster_conf(**over)


# ------------------------------------------------------------ sockets
class Collector(Dispatcher):
    def __init__(self):
        self.msgs = []
        self.resets = []
        self.cond = threading.Condition()

    def ms_dispatch(self, conn, msg):
        with self.cond:
            self.msgs.append(msg)
            self.cond.notify_all()
        return True

    def ms_handle_reset(self, conn):
        self.resets.append(conn)

    def wait_for(self, n, timeout=10.0):
        deadline = time.monotonic() + timeout
        with self.cond:
            while len(self.msgs) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self.cond.wait(left)
        return True


class Echo(Dispatcher):
    """Replies to pings (server side of the RTT test)."""

    def ms_dispatch(self, conn, msg):
        if isinstance(msg, M.MOSDPing) and msg.op == M.MOSDPing.PING:
            conn.send_message(M.MOSDPing(op=M.MOSDPing.PING_REPLY,
                                         from_osd=99, stamp=msg.stamp))
            return True
        return False


@pytest.fixture
def pair():
    conf = Config()
    server = Messenger("osd.0", conf=conf)
    client = Messenger("client.1", conf=conf)
    addr = server.bind(("127.0.0.1", 0))
    server.start()
    client.start()
    yield server, client, addr, conf
    client.shutdown()
    server.shutdown()


def test_send_receive(pair):
    server, client, addr, _ = pair
    sink = Collector()
    server.add_dispatcher(sink)
    conn = client.connect_to(addr)
    conn.send_message(M.MOSDBoot(osd=5, addr=("127.0.0.1", 1234)))
    assert sink.wait_for(1)
    assert isinstance(sink.msgs[0], M.MOSDBoot)
    assert sink.msgs[0].osd == 5
    assert sink.msgs[0].connection.peer_name == "client.1"


def test_bidirectional(pair):
    server, client, addr, _ = pair
    server.add_dispatcher(Echo())
    pong = Collector()
    client.add_dispatcher(pong)
    conn = client.connect_to(addr)
    conn.send_message(M.MOSDPing(op=M.MOSDPing.PING, from_osd=1,
                                 stamp=42.0))
    assert pong.wait_for(1)
    assert pong.msgs[0].op == M.MOSDPing.PING_REPLY
    assert pong.msgs[0].stamp == 42.0


def test_many_messages_in_order(pair):
    server, client, addr, _ = pair
    sink = Collector()
    server.add_dispatcher(sink)
    conn = client.connect_to(addr)
    for i in range(200):
        conn.send_message(M.MOSDOp(client="client.1", tid=i, oid=f"o{i}"))
    assert sink.wait_for(200)
    assert [m.tid for m in sink.msgs] == list(range(200))


def test_lossless_survives_socket_failures(pair):
    """With 1-in-8 sends killing the socket, every message still
    arrives exactly once, in order (reconnect + resend + seq dedup)."""
    server, client, addr, conf = pair
    sink = Collector()
    server.add_dispatcher(sink)
    conn = client.connect_to(addr)
    conn.send_message(M.MOSDPing(op=0, from_osd=0))   # establish
    assert sink.wait_for(1)
    conf.set("ms_inject_socket_failures", 8)
    try:
        for i in range(150):
            conn.send_message(
                M.MOSDOp(client="client.1", tid=i, oid=f"o{i}"))
        assert sink.wait_for(151, timeout=30.0)
    finally:
        conf.set("ms_inject_socket_failures", 0)
    tids = [m.tid for m in sink.msgs[1:]]
    assert tids == list(range(150))


def test_bidirectional_lossless_under_injection(pair):
    """Request/reply traffic with both directions' sockets being shot
    out 1-in-5: every reply arrives exactly once, in order, without
    thread churn (regression: the per-socket-thread design stranded
    sessions when close() failed to wake a blocked recv)."""
    server, client, addr, conf = pair
    replies = Collector()
    client.add_dispatcher(replies)

    class ReplyingServer(Dispatcher):
        def ms_dispatch(self, conn, msg):
            if isinstance(msg, M.MOSDECSubOpWrite):
                conn.send_message(M.MOSDECSubOpWriteReply(
                    pgid=msg.pgid, shard=msg.shard, tid=msg.tid))
                return True
            return False

    server.add_dispatcher(ReplyingServer())
    conn = client.connect_to(addr)
    conf.set("ms_inject_socket_failures", 5)
    try:
        for tid in range(100):
            conn.send_message(M.MOSDECSubOpWrite(
                pgid="1.0", shard=1, tid=tid, txn=b"\x00" * 2048))
        assert replies.wait_for(100, timeout=60.0)
    finally:
        conf.set("ms_inject_socket_failures", 0)
    tids = [m.tid for m in replies.msgs]
    assert tids == list(range(100))
    assert len(threading.enumerate()) < 20   # persistent pumps, no churn


def test_reconnect_after_server_side_kill(pair):
    server, client, addr, _ = pair
    sink = Collector()
    server.add_dispatcher(sink)
    conn = client.connect_to(addr)
    conn.send_message(M.MOSDBoot(osd=1))
    assert sink.wait_for(1)
    # server kills its socket out from under the session
    with server.lock:
        sconn = server.conns_by_name["client.1"]
    sconn.sock.close()
    time.sleep(0.1)
    conn.send_message(M.MOSDBoot(osd=2))
    assert sink.wait_for(2, timeout=10.0)
    assert sink.msgs[1].osd == 2


def test_acks_bound_resend_queue(pair):
    """Steady-state acks trim unacked: it must not grow with traffic
    on a healthy connection (regression: unbounded resend queue)."""
    server, client, addr, _ = pair
    sink = Collector()
    server.add_dispatcher(sink)
    conn = client.connect_to(addr)
    for i in range(300):
        conn.send_message(M.MOSDOp(client="client.1", tid=i, oid="o"))
    assert sink.wait_for(300)
    deadline = time.monotonic() + 5
    while len(conn.unacked) > 64 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert len(conn.unacked) <= 64   # bounded by the ack cadence


def test_peer_restart_reincarnation(pair):
    """A peer that restarts (new nonce, seqs from 1) must not have its
    messages dropped by the stale session's dedup floor."""
    server, client, addr, conf = pair
    sink = Collector()
    server.add_dispatcher(sink)
    conn = client.connect_to(addr)
    for i in range(50):
        conn.send_message(M.MOSDOp(client="client.1", tid=i, oid="o"))
    assert sink.wait_for(50)
    client.shutdown()                  # "process dies"
    # same entity name, fresh nonce and seq space
    client2 = Messenger("client.1", conf=conf)
    client2.start()
    conn2 = client2.connect_to(addr)
    conn2.send_message(M.MOSDOp(client="client.1", tid=1000, oid="o"))
    assert sink.wait_for(51), \
        "restarted peer's messages were dropped as duplicates"
    assert sink.msgs[-1].tid == 1000
    client2.shutdown()


def test_connection_reuse(pair):
    server, client, addr, _ = pair
    c1 = client.connect_to(addr)
    c2 = client.connect_to(addr)
    assert c1 is c2


def test_garbage_connection_does_not_kill_acceptor(pair):
    server, client, addr, _ = pair
    import socket as pysocket
    s = pysocket.create_connection(addr)
    s.sendall(b"GET / HTTP/1.0\r\n\r\n")
    s.close()
    # messenger still accepts valid peers afterwards
    sink = Collector()
    server.add_dispatcher(sink)
    conn = client.connect_to(addr)
    conn.send_message(M.MOSDBoot(osd=3))
    assert sink.wait_for(1)


def test_plain_wire_path_notes_no_copies(pair):
    """Sending a large message over the plain (no compression, no
    secure mode) wire must record ZERO tracked hot-path copies: the
    payload rides sendmsg iovecs straight from the caller's buffer."""
    from ceph_tpu_torch.utils import copytrack
    server, client, addr, _ = pair
    sink = Collector()
    server.add_dispatcher(sink)
    conn = client.connect_to(addr)
    copytrack.reset()
    blob = os.urandom(256 << 10)
    conn.send_message(M.MOSDECSubOpWrite(
        pgid="1.2", shard=0, from_osd=0, tid=1, epoch=1, txn=blob,
        log_entries=[], at_version=(1, 1)))
    assert sink.wait_for(1)
    assert bytes(sink.msgs[0].txn) == blob
    snap = copytrack.snapshot()
    assert snap["bytes"] == 0, snap


def test_thread_count_documented_at_scale():
    """The messenger is thread-per-connection by design, so threads grow
    with daemon pairs: the slope (threads per daemon pair across two
    cluster sizes, at the config default, crimson OSDs) stays inside the
    documented ~6 a pair, under the bound of 8, and the absolute count
    at the larger size stays sane."""
    def threads_at(n_osds: int) -> int:
        with Cluster(n_osds=n_osds, conf=cluster_conf()) as c:
            for i in range(n_osds):
                c.wait_for_osd_up(i, 30)
            assert all(type(o).__name__ == "CrimsonOSD"
                       for o in c.osds.values())
            c.create_pool(f"tc{n_osds}", "replicated", size=3)
            io = c.rados(timeout=30).open_ioctx(f"tc{n_osds}")
            io.write_full("x", b"y" * 1000)
            return threading.active_count()

    counts = {n: threads_at(n) for n in (3, 6)}
    # daemons = OSDs + mon; connection pairs grow quadratically
    pairs = {n: (n + 1) * n // 2 for n in counts}
    slope = (counts[6] - counts[3]) / (pairs[6] - pairs[3])
    assert slope < 8.0, (
        f"threads per daemon pair {slope:.1f} blew the documented "
        f"~6/pair envelope ({counts}); the 12-OSD extrapolation "
        f"would leave the measured hundreds")
    # and the absolute stays sane at the larger size
    assert counts[6] < 300, counts


@pytest.mark.parametrize("kind", ["classic", "crimson"])
def test_dial_of_the_race_winner_is_not_grafted_onto_our_connector(kind):
    """Two daemons dial each other at once.  osd.1's own dial to osd.0
    is up (its connector session, whose partner on osd.0 is an accepted
    one) when osd.0's dial, the race's winner by name, lands: that dial
    comes from a NEW session of osd.0's.  osd.1 used to graft it onto its
    connector, whose in_seq counts what osd.0's accepted session sent,
    so the new session's first frames were dropped as duplicates and
    osd.0's accepted session lost its socket with its queue: a PG's
    peering messages never arrived and a fresh crimson cluster's first
    op timed out (about 3 in 100 fresh 3-OSD clusters, six at once).
    Now osd.1 gives the dial an accepted session of its own; everything
    either side sends arrives, in order."""
    reactors = []

    def messenger(name):
        if kind == "classic":
            return Messenger(name, conf=Config())
        from ceph_tpu_torch.crimson.net import CrimsonMessenger
        from ceph_tpu_torch.crimson.reactor import Reactor
        r = Reactor(name=f"t-{name}")
        r.start()
        reactors.append(r)
        return CrimsonMessenger(name, conf=Config(), reactor=r)

    m0, m1 = messenger("osd.0"), messenger("osd.1")
    sink0, sink1 = Collector(), Collector()
    m0.add_dispatcher(sink0)
    m1.add_dispatcher(sink1)
    a0, a1 = m0.bind(("127.0.0.1", 0)), m1.bind(("127.0.0.1", 0))
    m0.start()
    m1.start()
    try:
        c1 = m1.connect_to(a0, peer_name="osd.0")
        c1.send_message(M.MOSDBoot(osd=1, addr=a1))
        assert sink0.wait_for(1)
        # osd.0 answers over the session it accepted from osd.1
        for i in range(5):
            m0.connect_to(a1, peer_name="osd.1").send_message(
                M.MOSDBoot(osd=100 + i, addr=a0))
        assert sink1.wait_for(5)
        assert c1.in_seq == 5
        # osd.0's own dial, in flight while the accepted session stood
        # unregistered: the state the race leaves
        with m0.lock:
            accepted = m0.conns_by_name.pop("osd.1")
        assert not accepted.connector
        dial = m0.connect_to(a1, peer_name="osd.1")
        assert dial is not accepted and dial.connector
        for i in range(3):
            dial.send_message(M.MOSDBoot(osd=200 + i, addr=a0))
        assert sink1.wait_for(8), [m.osd for m in sink1.msgs]
        assert [m.osd for m in sink1.msgs] == \
            [100, 101, 102, 103, 104, 200, 201, 202]
        # both of osd.1's sessions to osd.0 still deliver
        c1.send_message(M.MOSDBoot(osd=2, addr=a1))
        m1.connect_to(a0, peer_name="osd.0").send_message(
            M.MOSDBoot(osd=3, addr=a1))
        assert sink0.wait_for(3), [m.osd for m in sink0.msgs]
        assert sorted(m.osd for m in sink0.msgs) == [1, 2, 3]
        assert accepted.state == "open"
    finally:
        m0.shutdown()
        m1.shutdown()
        for r in reactors:
            r.stop()


FIRST_OP_LOOP = """
import sys, time
from ceph_tpu_torch.client.rados import RadosError
from ceph_tpu_torch.cluster import Cluster, test_config
n = stalls = 0
end = time.monotonic() + float(sys.argv[1])
while time.monotonic() < end:
    with Cluster(n_osds=3, conf=test_config()) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 30)
        c.create_pool("p", "replicated", size=3)
        r = c.rados(timeout=30)
        r.op_timeout = 10.0
        try:
            r.open_ioctx("p").write_full("x", b"y" * 1000)
        except RadosError:
            stalls += 1
        n += 1
print(n, stalls)
"""


@pytest.mark.slow
def test_fresh_crimson_clusters_answer_their_first_op():
    """The connection race's cost, counted: six processes at once each
    boot fresh 3-OSD crimson clusters for FIRST_OP_SECONDS (150 by
    default) and time out a first write after 10 s.  Before the race
    repair above, 35 first writes in 2,639 clusters timed out this way
    on an 8-core CPU box (the PG never peered); after it, 0 in 4,027.
    Run it from another checkout to count that one."""
    import subprocess
    import sys
    secs = os.environ.get("FIRST_OP_SECONDS", "150")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen([sys.executable, "-c", FIRST_OP_LOOP, secs],
                              cwd=repo, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL, text=True)
             for _ in range(6)]
    counts = [tuple(map(int, p.communicate(timeout=float(secs) + 300)[0]
                        .split()[-2:])) for p in procs]
    clusters, stalls = (sum(c[i] for c in counts) for i in (0, 1))
    print(f"{clusters} fresh clusters, {stalls} first writes timed out")
    assert clusters > 0 and stalls == 0, counts


# ------------------------------------------------------------ keyring
def test_keyring_roundtrip_text():
    kr = Keyring()
    kr.get_or_create("client.admin", {"mon": "allow *",
                                      "osd": "allow *"})
    kr.get_or_create("osd.0", {"mon": "allow profile osd"})
    text = kr.to_text()
    assert "[client.admin]" in text and "key = " in text
    kr2 = Keyring.from_text(text)
    assert kr2.names() == kr.names()
    assert kr2.get("client.admin").key == kr.get("client.admin").key
    assert kr2.get("osd.0").caps == {"mon": "allow profile osd"}


def test_keyring_persistence_dump_load():
    kr = Keyring()
    kr.get_or_create("client.x")
    kr2 = Keyring.load(kr.dump())
    assert kr2.get("client.x").key == kr.get("client.x").key


def test_keyring_text_crosses_between_packages():
    """A keyring file written by either package loads in the other
    with the same keys and caps."""
    from ceph_tpu.auth.keyring import Keyring as RefKeyring
    ref = RefKeyring()
    ref.get_or_create("client.admin", {"mon": "allow *"})
    ref.get_or_create("osd.3", {"osd": "allow rwx"})
    port = Keyring.from_text(ref.to_text())
    assert port.to_text() == ref.to_text()
    back = RefKeyring.from_text(port.to_text())
    assert back.dump() == port.dump() == ref.dump()


def test_generate_key_is_base64_and_unique():
    import base64
    keys = {generate_key() for _ in range(20)}
    assert len(keys) == 20
    for k in keys:
        assert len(base64.b64decode(k)) == 16


def test_auth_commands_over_cluster():
    with Cluster(n_osds=1, conf=make_conf()) as c:
        ret, rs, out = c.mon_command(
            {"prefix": "auth get-or-create", "entity": "client.rbd",
             "caps": ["mon", "allow r", "osd", "allow rwx"]})
        assert ret == 0
        key1 = out["key"]
        assert "[client.rbd]" in rs
        # idempotent: same key back
        ret, _, out = c.mon_command(
            {"prefix": "auth get", "entity": "client.rbd"})
        assert ret == 0 and out["key"] == key1
        ret, rs, _ = c.mon_command(
            {"prefix": "auth print-key", "entity": "client.rbd"})
        assert ret == 0 and rs == key1
        ret, _, out = c.mon_command({"prefix": "auth ls"})
        names = [e["entity"] for e in out["entities"]]
        assert "client.admin" in names and "client.rbd" in names
        ret, _, _ = c.mon_command(
            {"prefix": "auth rm", "entity": "client.rbd"})
        assert ret == 0
        ret, _, _ = c.mon_command(
            {"prefix": "auth get", "entity": "client.rbd"})
        assert ret == -2


def test_cluster_auth_allows_matching_keys_blocks_mismatched():
    key = generate_key()
    conf = make_conf(auth_cluster_required="cephx", auth_key=key)
    with Cluster(n_osds=2, conf=conf) as c:
        for i in range(2):
            c.wait_for_osd_up(i, 20)
        c.create_pool("authp", "replicated", size=2)
        io = c.rados().open_ioctx("authp")
        io.write_full("a", b"secret payload")
        assert io.read("a") == b"secret payload"

        # an intruder with the wrong key cannot establish a session
        from ceph_tpu_torch.client.rados import Rados, RadosError
        bad_conf = make_conf(auth_cluster_required="cephx",
                         auth_key="wrong-key")
        intruder = Rados(c.mon_addr, conf=bad_conf, op_timeout=3.0)
        with pytest.raises(RadosError):
            intruder.connect(timeout=3.0)
        intruder.shutdown()

        # ... and one with no auth at all is also rejected
        off_conf = make_conf()
        intruder2 = Rados(c.mon_addr, conf=off_conf, op_timeout=3.0)
        with pytest.raises(RadosError):
            intruder2.connect(timeout=3.0)
        intruder2.shutdown()


def test_registry_roundtrip_all_codecs():
    reg = registry()
    payload = b"the quick brown fox " * 1000
    for name in reg.supported():
        codec = reg.create(name)
        comp = codec.compress(payload)
        assert len(comp) < len(payload)
        assert codec.decompress(comp) == payload
        assert reg.create_by_id(codec.numeric_id).decompress(comp) \
            == payload


def test_registry_unknown_rejected():
    with pytest.raises(KeyError):
        registry().create("nope")
    with pytest.raises(KeyError):
        registry().create_by_id(99)


def test_frame_compression_roundtrip():
    codec = registry().create("zlib")
    msg = M.MOSDOp(client="client.1", tid=9, epoch=3, pool=1,
                   oid="big", pgid_seed=2,
                   ops=[M.OSDOp("write", 0, 1 << 16,
                                b"z" * (1 << 16))])
    frame = encode_frame(msg, compressor=codec, compress_min=1024)
    plain = encode_frame(msg)
    assert len(frame) < len(plain) // 4
    mtype, seq, plen = decode_frame_header(frame[:HEADER_LEN])
    assert mtype & COMPRESSED_FLAG
    out = decode_frame_body(mtype, seq, frame[:HEADER_LEN],
                            frame[HEADER_LEN:HEADER_LEN + plen],
                            frame[HEADER_LEN + plen:])
    assert out.ops[0].data == msg.ops[0].data


def test_frame_compression_skips_small_and_incompressible():
    codec = registry().create("zlib")
    small = M.MOSDPing(op=0, from_osd=1)
    frame = encode_frame(small, compressor=codec, compress_min=1024)
    mtype, _, _ = decode_frame_header(frame[:HEADER_LEN])
    assert not (mtype & COMPRESSED_FLAG)
    # incompressible payload stays uncompressed (no size win)
    rnd = M.MOSDOp(client="c", tid=1, epoch=1, pool=1, oid="r",
                   pgid_seed=0,
                   ops=[M.OSDOp("write", 0, 8192, os.urandom(8192))])
    frame = encode_frame(rnd, compressor=codec, compress_min=1024)
    mtype, _, _ = decode_frame_header(frame[:HEADER_LEN])
    assert not (mtype & COMPRESSED_FLAG)


def test_cluster_io_with_wire_compression():
    conf = make_conf(ms_compress_mode="zlib",
                       ms_compress_min_size=1024)
    with Cluster(n_osds=2, conf=conf) as c:
        for i in range(2):
            c.wait_for_osd_up(i, 20)
        c.create_pool("zp", "replicated", size=2)
        io = c.rados().open_ioctx("zp")
        data = (b"compressible " * 10000)
        io.write_full("z1", data)
        assert io.read("z1") == data
        c.wait_for_clean(20)


def test_secure_cluster_io_and_wire_ciphertext():
    """ms_secure_mode: full cluster IO over AES-GCM frames; a raw
    socket peek at the listener traffic must show NO plaintext; a
    client without encryption is refused (mode negotiation)."""
    pytest.importorskip("cryptography")
    key = generate_key()
    conf = make_conf(auth_cluster_required="cephx", auth_key=key,
                       ms_secure_mode=True)
    with Cluster(n_osds=2, conf=conf) as c:
        for i in range(2):
            c.wait_for_osd_up(i, 20)
        c.create_pool("sec", "replicated", size=2)
        io = c.rados().open_ioctx("sec")
        marker = b"TOP-SECRET-PAYLOAD-" * 40
        io.write_full("s1", marker)
        assert io.read("s1") == marker

        # plaintext-mode client with the right KEY but no encryption:
        # negotiation must refuse it
        from ceph_tpu_torch.client.rados import Rados, RadosError
        plain_conf = make_conf(auth_cluster_required="cephx",
                                 auth_key=key)
        intruder = Rados(c.mon_addr, conf=plain_conf, op_timeout=3.0)
        with pytest.raises(RadosError):
            intruder.connect(timeout=3.0)
        intruder.shutdown()


def test_secure_frames_not_plaintext_and_tamper_detected():
    """Direct messenger-level check: sniff the bytes between two
    secure endpoints via a tap, assert the payload marker never
    appears; flip ciphertext bits and assert the session drops the
    socket (GCM tag failure) instead of delivering garbage."""
    import socket
    import threading as thr

    pytest.importorskip("cryptography")

    key = generate_key()
    conf = make_conf(auth_cluster_required="cephx", auth_key=key,
                       ms_secure_mode=True)

    got = []
    ev = thr.Event()

    class Sink(Dispatcher):
        def ms_dispatch(self, conn, msg):
            got.append(msg)
            ev.set()
            return True

    a = Messenger("osd.91", conf=conf)
    b = Messenger("osd.92", conf=conf)
    b.add_dispatcher(Sink())
    addr_b = b.bind(("127.0.0.1", 0))
    b.start()

    # tap proxy between a and b records every byte on the wire
    captured = bytearray()
    tap = socket.socket()
    tap.bind(("127.0.0.1", 0))
    tap.listen(4)

    def proxy():
        cli, _ = tap.accept()
        srv = socket.create_connection(addr_b)

        def pump(src, dst):
            while True:
                try:
                    buf = src.recv(65536)
                except OSError:
                    return
                if not buf:
                    return
                captured.extend(buf)
                try:
                    dst.sendall(buf)
                except OSError:
                    return
        thr.Thread(target=pump, args=(cli, srv), daemon=True).start()
        thr.Thread(target=pump, args=(srv, cli), daemon=True).start()
    thr.Thread(target=proxy, daemon=True).start()

    marker = b"WIRE-MARKER-MUST-NOT-LEAK" * 4
    conn = a.connect_to(tap.getsockname())
    conn.send_message(M.MOSDOp(client="c", tid=1, epoch=1, pool=1,
                               oid="o",
                               ops=[M.OSDOp("write", 0, len(marker),
                                            marker)]))
    assert ev.wait(10), "secure message not delivered"
    assert got[0].ops[0].data == marker
    assert marker not in bytes(captured), \
        "payload visible in plaintext on the wire"
    a.shutdown()
    b.shutdown()
    tap.close()


def test_secure_socket_tamper_detected():
    """A flipped ciphertext bit must kill the stream (GCM tag check),
    never deliver corrupted plaintext."""
    import socket
    import struct

    pytest.importorskip("cryptography")
    from ceph_tpu_torch.msg.messenger import _read_exact, _SecureSocket

    s1, s2 = socket.socketpair()
    key = os.urandom(32)
    tx = _SecureSocket(s1, key, b"CNCT", b"ACPT")
    rx = _SecureSocket(s2, key, b"ACPT", b"CNCT")
    tx.sendall(b"hello world")
    assert _read_exact(rx, 11) == b"hello world"

    # craft the next valid segment, then flip one ciphertext bit
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    nonce = b"CNCT" + (1).to_bytes(8, "little")
    ct = bytearray(AESGCM(key).encrypt(nonce, b"payload two", None))
    ct[3] ^= 0x40
    s1.sendall(struct.pack("<I", len(ct)) + bytes(ct))
    with pytest.raises(ConnectionError):
        rx.recv(1)
    s1.close()
    s2.close()

