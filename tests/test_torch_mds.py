"""The metadata server in the port (ceph_tpu_torch.mds) and its client
(ceph_tpu_torch.fs.mdsclient): namespace ops through the MDS, journal
replay, caps and recall, standby failover, fencing, subtree pins.

Port twins of all 14 tests of tests/test_mds.py (reference analog:
src/mds/ driven by client/Client.cc-style calls), on the port's
cluster at the config default (crimson OSDs).  Then the slice held
against the JAX package: the seeded namespace script of
tests/test_torch_fs.py through an MDSClient and an MDSDaemon of each
package, data on a k=2 m=1 pool, with the walk, every entry's type,
size and bytes, the data pool's (object, size) list and the count of
journaled mutations equal."""
import os
import time

import pytest

from ceph_tpu_torch.cluster import Cluster
from ceph_tpu_torch.fs.filesystem import FileSystem, FSError
from ceph_tpu_torch.fs.mdsclient import MDSClient
from ceph_tpu_torch.mds import MDSDaemon


@pytest.fixture(scope="module")
def cl():
    with Cluster(n_osds=3) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        c.create_pool("fsmeta", "replicated", size=2)
        c.create_pool("fsdata", "replicated", size=2)
        yield c


@pytest.fixture
def mds(cl):
    d = MDSDaemon(cl.mon_addr, "fsmeta", "fsdata",
                  conf=cl.conf).start()
    yield d
    d.shutdown()


def client(cl, mds):
    r = cl.rados()
    return MDSClient(r, mds.my_addr, "fsdata")


def test_namespace_ops_through_mds(cl, mds):
    fs = client(cl, mds)
    fs.mkdir("/a")
    fs.mkdir("/a/b")
    data = os.urandom(200_000)
    fs.write_file("/a/b/f.bin", data)
    assert fs.read_file("/a/b/f.bin") == data
    assert fs.stat("/a/b/f.bin")["size"] == len(data)
    assert [e["name"] for e in fs.listdir("/a")] == ["b"]
    fs.rename("/a/b/f.bin", "/a/g.bin")
    assert fs.read_file("/a/g.bin") == data
    assert not fs.exists("/a/b/f.bin")
    fs.truncate("/a/g.bin", 1000)
    assert fs.read_file("/a/g.bin") == data[:1000]
    fs.unlink("/a/g.bin")
    fs.rmdir("/a/b")
    with pytest.raises(FSError):
        fs.rmdir("/a/missing")
    # library-mode FileSystem sees the same namespace (same pools)
    lib = FileSystem(cl.rados().open_ioctx("fsmeta"),
                     cl.rados().open_ioctx("fsdata"))
    assert [e["name"] for e in lib.listdir("/")] == ["a"]


def test_journal_replay_on_restart(cl):
    """Entries journaled but NOT applied (crash between WAL append
    and the multi-object apply) must materialize on the next start —
    restart is resume (reference MDLog replay)."""
    d1 = MDSDaemon(cl.mon_addr, "fsmeta", "fsdata",
                   conf=cl.conf).start()
    fs = client(cl, d1)
    fs.mkdir("/jr")
    fs.write_file("/jr/applied.txt", b"applied")

    # crash window: journal the next ops without applying them
    real_apply = d1._apply
    d1._apply = lambda ent: None
    fs.mkdir("/jr/lost-dir")
    with pytest.raises(FSError):
        # create under the un-applied dir resolves nothing: expected
        fs.write_file("/jr/lost-dir/x", b"y")
    d1._apply = real_apply
    d1.shutdown()

    d2 = MDSDaemon(cl.mon_addr, "fsmeta", "fsdata",
                   conf=cl.conf).start()
    try:
        fs2 = client(cl, d2)
        names = {e["name"] for e in fs2.listdir("/jr")}
        assert "lost-dir" in names, "journal tail not replayed"
        assert fs2.read_file("/jr/applied.txt") == b"applied"
        # and the replayed dir is fully usable
        fs2.write_file("/jr/lost-dir/x", b"now works")
        assert fs2.read_file("/jr/lost-dir/x") == b"now works"
    finally:
        d2.shutdown()


def test_cap_recall_coherence(cl, mds):
    """Writer caps buffer size locally; another client's stat recalls
    the cap and must observe the flushed size (reference MClientCaps
    revoke -> flush)."""
    a = client(cl, mds)
    b = client(cl, mds)
    fh = a.open("/shared.bin", "w")
    assert fh.cap_id is not None
    payload = os.urandom(150_000)
    fh.write(payload)                  # size buffered client-side
    st = b.stat("/shared.bin")         # forces recall + flush
    assert st["size"] == len(payload), \
        "buffered writer size not visible after recall"
    # the writer degraded to sync-through but keeps working
    assert fh.cap_id is None
    fh.write(b"tail")
    assert b.stat("/shared.bin")["size"] == len(payload) + 4
    assert b.read_file("/shared.bin") == payload + b"tail"
    fh.close()


def test_two_writers_serialize_via_recall(cl, mds):
    a = client(cl, mds)
    b = client(cl, mds)
    fa = a.open("/w2.bin", "w")
    fa.write(b"A" * 1000)
    fb = b.open("/w2.bin", "w")        # recalls A's cap
    assert fb.size == 1000, "B must see A's flushed size on open"
    fb.write(b"B" * 500, 1000)
    fb.close()
    assert a.stat("/w2.bin")["size"] == 1500
    assert a.read_file("/w2.bin") == b"A" * 1000 + b"B" * 500
    fa.close()


def test_dead_holder_recall_times_out(cl, mds):
    """A cap holder that vanishes must not wedge other clients: the
    recall times out and the cap is revoked (unflushed attrs lost —
    the reference's contract for clients dying with dirty caps)."""
    r = cl.rados()
    a = MDSClient(r, mds.my_addr, "fsdata")
    fh = a.open("/dead.bin", "w")
    fh.write(b"x" * 100)
    r.shutdown()                       # holder disappears
    b = client(cl, mds)
    t0 = time.monotonic()
    st = b.stat("/dead.bin")
    assert time.monotonic() - t0 < 10
    # unflushed size may be lost, but the namespace is consistent
    assert st["size"] in (0, 100)


def test_own_write_then_stat_visibility(cl, mds):
    """A client that writes through an open capped handle and then
    stats the PATH must see its own size (the stat recalls even the
    caller's own cap — write-then-stat visibility)."""
    fs = client(cl, mds)
    fh = fs.open("/self.bin", "w")
    fh.write(b"q" * 12_345)
    assert fs.stat("/self.bin")["size"] == 12_345
    fh.close()


def test_same_client_reopen_flushes_prior_handle(cl, mds):
    fs = client(cl, mds)
    f1 = fs.open("/re.bin", "w")
    f1.write(b"1" * 2000)
    f2 = fs.open("/re.bin", "w")       # recalls f1's cap
    assert f2.size == 2000
    f2.write(b"2" * 1000, 2000)
    f2.close()
    f1.close()                         # stale handle: harmless
    assert fs.stat("/re.bin")["size"] == 3000


def test_mds_standby_failover():
    """Kill the active MDS with a standby registered: the monitor's
    beacon grace promotes the standby, which adopts the journal; a
    client resolving through the MDSMap completes in-flight and new
    ops with no namespace tears (reference MDSMonitor beacon failover
    + MDSRank replay)."""
    from ceph_tpu_torch.cluster import test_config as _mc
    conf = _mc(mds_beacon_interval=0.2, mds_beacon_grace=1.2)
    with Cluster(n_osds=3, conf=conf) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        c.create_pool("fom", "replicated", size=2)
        c.create_pool("fod", "replicated", size=2)
        a = MDSDaemon(c.mon_addr, "fom", "fod", conf=conf,
                      name="mds.a").start()
        b = MDSDaemon(c.mon_addr, "fom", "fod", conf=conf,
                      name="mds.b").start()
        assert a.active and not b.active
        fs = MDSClient(c.rados(), None, "fod")   # mdsmap-resolved
        fs.mkdir("/fo")
        data = os.urandom(120_000)
        fs.write_file("/fo/x.bin", data)

        a.shutdown()                     # beacons stop; no handoff
        # new ops must complete via the promoted standby (the client
        # retries + re-resolves internally)
        fs.mkdir("/fo/after")
        assert fs.read_file("/fo/x.bin") == data
        fs.write_file("/fo/after/y.bin", b"post-failover")
        assert fs.read_file("/fo/after/y.bin") == b"post-failover"
        assert b.active, "standby was not promoted"
        names = {e["name"] for e in fs.listdir("/fo")}
        assert names == {"x.bin", "after"}, names
        b.shutdown()


def test_mdsmap_survives_monitor_restart():
    """The MDSMap is monitor state (reference MDSMonitor's paxos-
    persisted FSMap): a monitor restart must come back with the same
    active assignment and a non-regressing epoch, not reset to epoch 0
    where the first beacon would steal active."""
    import tempfile

    from ceph_tpu_torch.cluster import test_config as _mc
    conf = _mc(mds_beacon_interval=0.2, mds_beacon_grace=30)
    with tempfile.TemporaryDirectory() as td, \
            Cluster(n_osds=3, conf=conf, data_dir=td) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        c.create_pool("mrm", "replicated", size=2)
        a = MDSDaemon(c.mon_addr, "mrm", conf=conf,
                      name="mds.a").start()
        b = MDSDaemon(c.mon_addr, "mrm", conf=conf,
                      name="mds.b").start()
        assert a.active and not b.active
        ret, _, out = c.mon_command({"prefix": "mds getmap"})
        assert ret == 0 and out["active"] == "mds.a"
        epoch_before = out["epoch"]

        c.kill_mon(0)
        c.revive_mon(0)
        ret, _, out = c.mon_command({"prefix": "mds getmap"})
        assert ret == 0
        assert out["active"] == "mds.a", \
            "monitor restart lost the active MDS assignment"
        assert out["epoch"] >= epoch_before
        # a later-registering daemon still must NOT steal active
        bb = MDSDaemon(c.mon_addr, "mrm", conf=conf,
                       name="mds.c").start()
        time.sleep(0.3)
        ret, _, out = c.mon_command({"prefix": "mds getmap"})
        assert out["active"] == "mds.a"
        for d in (a, b, bb):
            d.shutdown()


def test_zombie_active_is_fenced():
    """A beacon-silent active that KEEPS RUNNING (partition / long GC
    pause — exactly the failover trigger) must not interleave journal
    appends with the promoted standby: the promotion raises the
    cls_fence epoch on the journal object, so the zombie's next
    mutation is rejected inside the OSD and it demotes itself
    (reference blocklists the old active's addr via the OSDMap before
    promoting)."""
    from ceph_tpu_torch.cluster import test_config as _mc
    conf = _mc(mds_beacon_interval=0.2, mds_beacon_grace=1.2)
    with Cluster(n_osds=3, conf=conf) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        c.create_pool("zfm", "replicated", size=2)
        c.create_pool("zfd", "replicated", size=2)
        a = MDSDaemon(c.mon_addr, "zfm", "zfd", conf=conf,
                      name="mds.a").start()
        b = MDSDaemon(c.mon_addr, "zfm", "zfd", conf=conf,
                      name="mds.b").start()
        assert a.active and not b.active
        fs_a = MDSClient(c.rados(), a.my_addr, "zfd")  # pinned to a
        fs_a.mkdir("/pre")

        # partition a from the monitor only: beacons stop, but a still
        # believes it is active and can still reach the OSDs
        a._send_beacon = lambda: None
        deadline = time.time() + 10
        while not b.active and time.time() < deadline:
            time.sleep(0.1)
        assert b.active, "standby was not promoted"

        # the zombie's mutation must be fenced out, not applied
        with pytest.raises(FSError):
            fs_a.mkdir("/zombie-dir")
        assert not a.active, "fenced active did not demote itself"

        # namespace integrity: the promoted active never sees the
        # zombie's rejected mutation, and keeps serving
        fs = MDSClient(c.rados(), None, "zfd")
        fs.mkdir("/post")
        names = {e["name"] for e in fs.listdir("/")}
        assert "zombie-dir" not in names
        assert {"pre", "post"} <= names
        a.shutdown()
        b.shutdown()


def test_zombie_checkpoint_is_fenced():
    """The zombie's CHECKPOINT (watermark write + journal trim) must
    be fenced like its appends — an unguarded trim would erase the
    successor's journal entries and a stale watermark write would
    regress the applied-through seq."""
    from ceph_tpu_torch.client.rados import RadosError
    from ceph_tpu_torch.cluster import test_config as _mc
    from ceph_tpu_torch.mds.daemon import JOURNAL_OID
    conf = _mc(mds_beacon_interval=0.2, mds_beacon_grace=1.2)
    with Cluster(n_osds=3, conf=conf) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        c.create_pool("zcm", "replicated", size=2)
        a = MDSDaemon(c.mon_addr, "zcm", conf=conf,
                      name="mds.a").start()
        b = MDSDaemon(c.mon_addr, "zcm", conf=conf,
                      name="mds.b").start()
        assert a.active and not b.active
        a._send_beacon = lambda: None    # partition a from the mon
        deadline = time.time() + 10
        while not b.active and time.time() < deadline:
            time.sleep(0.1)
        assert b.active

        # the promoted active journals a mutation
        fs = MDSClient(c.rados(), None, "zcm")
        fs.mkdir("/survives")
        io = c.rados().open_ioctx("zcm")
        journal_before = io.read(JOURNAL_OID)
        assert b"survives" in journal_before

        # the zombie tries to checkpoint: fenced + demoted, and the
        # successor's journal entries remain intact
        with pytest.raises(RadosError):
            a._checkpoint()
        assert not a.active
        assert io.read(JOURNAL_OID) == journal_before
        a.shutdown()
        b.shutdown()


def _wait_for(pred, timeout=10.0, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.1)
    raise TimeoutError(what)


def test_multi_mds_two_actives_with_subtree_pins():
    """Two active ranks serving disjoint pinned subtrees (reference
    multi-MDS via Migrator subtree auth, reduced to static pins): ops under a pinned path journal at its rank,
    reads cross subtrees freely (shared backing store), and a
    cross-subtree rename runs the master/slave 2-phase protocol in
    both directions."""
    from ceph_tpu_torch.cluster import test_config as _mc
    conf = _mc(mds_beacon_interval=0.2, mds_beacon_grace=30)
    with Cluster(n_osds=3, conf=conf) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        c.create_pool("mmm", "replicated", size=2)
        c.create_pool("mmd", "replicated", size=2)
        a = MDSDaemon(c.mon_addr, "mmm", "mmd", conf=conf,
                      name="mds.a").start()
        b = MDSDaemon(c.mon_addr, "mmm", "mmd", conf=conf,
                      name="mds.b").start()
        assert a.active and a.rank == 0 and not b.active
        rc, msg, _ = c.mon_command({"prefix": "fs set",
                                    "var": "max_mds", "val": "2"})
        assert rc == 0, msg
        rc, msg, _ = c.mon_command({"prefix": "fs pin",
                                    "path": "/b", "rank": "1"})
        assert rc == 0, msg
        _wait_for(lambda: b.active and b.rank == 1, 10,
                  "standby never took rank 1")
        _wait_for(lambda: a._pins.get("/b") == 1, 10,
                  "rank 0 never learned the pin table")

        fs = MDSClient(c.rados(), None, "mmd")
        fs.mkdir("/a")
        fs.mkdir("/b")                   # dentry in "/" -> rank 0
        d1 = os.urandom(150_000)
        d2 = os.urandom(90_000)
        fs.write_file("/a/f1.bin", d1)   # rank 0 subtree
        fs.write_file("/b/f2.bin", d2)   # rank 1 subtree
        assert b._applied > 0, \
            "pinned-subtree ops never journaled at rank 1"
        assert fs.read_file("/a/f1.bin") == d1
        assert fs.read_file("/b/f2.bin") == d2
        assert [e["name"] for e in fs.listdir("/b")] == ["f2.bin"]
        assert fs.stat("/b/f2.bin")["size"] == len(d2)

        # cross-subtree rename, rank 0 -> rank 1 (master at rank 0)
        fs.rename("/a/f1.bin", "/b/moved.bin")
        assert fs.read_file("/b/moved.bin") == d1
        assert not fs.exists("/a/f1.bin")
        # ... and rank 1 -> rank 0 (master at rank 1), over a target
        fs.write_file("/a/target.bin", b"old")
        fs.rename("/b/f2.bin", "/a/target.bin")
        assert fs.read_file("/a/target.bin") == d2
        assert not fs.exists("/b/f2.bin")
        # both masters resolved their prepares (no dangling 2-phase)
        assert not a._pending_renames and not b._pending_renames
        for d in (a, b):
            d.shutdown()


def test_multi_mds_rank_failover():
    """Either rank fails over independently: kill the rank-1 holder,
    a standby takes exactly rank 1 (fence + per-rank journal replay),
    and the pinned subtree keeps serving with data intact."""
    from ceph_tpu_torch.cluster import test_config as _mc
    conf = _mc(mds_beacon_interval=0.2, mds_beacon_grace=1.2)
    with Cluster(n_osds=3, conf=conf) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        c.create_pool("mfm", "replicated", size=2)
        c.create_pool("mfd", "replicated", size=2)
        a = MDSDaemon(c.mon_addr, "mfm", "mfd", conf=conf,
                      name="mds.a").start()
        b = MDSDaemon(c.mon_addr, "mfm", "mfd", conf=conf,
                      name="mds.b").start()
        s = MDSDaemon(c.mon_addr, "mfm", "mfd", conf=conf,
                      name="mds.s").start()
        rc, msg, _ = c.mon_command({"prefix": "fs set",
                                    "var": "max_mds", "val": "2"})
        assert rc == 0, msg
        rc, msg, _ = c.mon_command({"prefix": "fs pin",
                                    "path": "/p", "rank": "1"})
        assert rc == 0, msg
        _wait_for(lambda: b.active and b.rank == 1, 10,
                  "no rank 1 holder")
        fs = MDSClient(c.rados(), None, "mfd")
        fs.mkdir("/p")
        data = os.urandom(120_000)
        fs.write_file("/p/x.bin", data)
        assert b._applied > 0

        b.shutdown()                     # rank 1 dies
        _wait_for(lambda: s.active and s.rank == 1, 15,
                  "standby never took over rank 1")
        # the pinned subtree serves again: reads see the old data,
        # writes land at the new rank-1 holder
        assert fs.read_file("/p/x.bin") == data
        fs.write_file("/p/y.bin", b"after-failover")
        assert fs.read_file("/p/y.bin") == b"after-failover"
        names = {e["name"] for e in fs.listdir("/p")}
        assert names == {"x.bin", "y.bin"}
        assert a.active and a.rank == 0  # rank 0 untouched
        for d in (a, s):
            d.shutdown()


def test_cross_rename_tick_retry_keeps_client_reqid():
    """Regression: a cross-rank rename whose
    slave round trip times out replies EAGAIN and leaves the prepare
    pending; the TICK retry re-drives it with ``reqid=None``.  The
    retry must recover the client reqid journaled in the prepare
    record, so the committed rename lands in the dedup table and the
    client's resend gets a dup-hit (result 0) — NOT a re-execute
    that ENOENTs on the already-moved source."""
    import threading

    from ceph_tpu_torch.cluster import test_config as _mc
    from ceph_tpu_torch.msg.messages import MMDSOp

    conf = _mc(mds_beacon_interval=0.2, mds_beacon_grace=30)
    with Cluster(n_osds=3, conf=conf) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        c.create_pool("xrm", "replicated", size=2)
        c.create_pool("xrd", "replicated", size=2)
        a = MDSDaemon(c.mon_addr, "xrm", "xrd", conf=conf,
                      name="mds.a").start()
        b = MDSDaemon(c.mon_addr, "xrm", "xrd", conf=conf,
                      name="mds.b").start()
        rc, msg_, _ = c.mon_command({"prefix": "fs set",
                                     "var": "max_mds", "val": "2"})
        assert rc == 0, msg_
        rc, msg_, _ = c.mon_command({"prefix": "fs pin",
                                     "path": "/b", "rank": "1"})
        assert rc == 0, msg_
        _wait_for(lambda: b.active and b.rank == 1, 10,
                  "standby never took rank 1")
        _wait_for(lambda: a._pins.get("/b") == 1, 10,
                  "rank 0 never learned the pin table")
        fs = MDSClient(c.rados(), None, "xrd")
        fs.mkdir("/a")
        fs.mkdir("/b")
        fs.write_file("/a/f1.bin", b"payload")

        # first slave round trip times out; later calls go through
        real_peer = a._peer_request
        fail_once = {"left": 1}

        def flaky_peer(rank, op, args, prep):
            if op == "peer_link" and fail_once["left"]:
                fail_once["left"] -= 1
                raise TimeoutError("injected slave timeout")
            return real_peer(rank, op, args, prep)

        a._peer_request = flaky_peer

        class _Conn:
            def __init__(self):
                self.replies = []
                self.ev = threading.Event()

            def send_message(self, m):
                self.replies.append(m)
                self.ev.set()

        op = MMDSOp(client="xrc", tid=77, op="rename",
                    args={"old": "/a/f1.bin", "new": "/b/moved.bin"})
        conn1 = _Conn()
        a._handle_op(op, conn1)
        assert conn1.ev.wait(10), "no reply to the first rename"
        assert conn1.replies[0].result == -11     # EAGAIN
        assert a._pending_renames, "prepare was not kept"
        prep = next(iter(a._pending_renames))
        assert a._pending_renames[prep]["client_reqid"] == \
            ["xrc", 77], "prepare record lost the client reqid"

        # the tick retry's exact call shape: reqid=None, no conn
        a._drive_cross_rename(prep, None)
        assert not a._pending_renames, "retry did not resolve"
        assert ("xrc", 77) in a._reqids, \
            "tick retry committed without the recovered reqid"

        # client resend of the SAME (client, tid): dup-hit, result 0
        conn2 = _Conn()
        a._handle_op(op, conn2)
        assert conn2.ev.wait(10), "no reply to the resend"
        assert conn2.replies[0].result == 0, \
            f"resend re-executed: {conn2.replies[0].result}"
        # the rename happened exactly once
        assert fs.read_file("/b/moved.bin") == b"payload"
        assert not fs.exists("/a/f1.bin")
        for d in (a, b):
            d.shutdown()


# ------------------------------------------ the slice against the JAX package
def _mds_on(cluster_mod, mds_mod, mdsclient_mod, profile):
    """The namespace script of tests/test_torch_fs.py through an
    MDSClient of ``cluster_mod``'s package, its MDS keeping metadata on
    a replicated pool and data on a k=2 m=1 pool."""
    from test_torch_fs import ec_fs_cluster, run_fs_script
    c = ec_fs_cluster(cluster_mod, profile)
    d = None
    try:
        d = mds_mod.MDSDaemon(c.mon_addr, "eqmeta", "eqdata",
                              conf=c.conf).start()
        r = c.rados(timeout=30)
        r.wait_for_epoch(c.mon.osdmap.epoch, 10)
        fs = mdsclient_mod.MDSClient(r, d.my_addr, "eqdata")
        tree, objs = run_fs_script(fs, r.open_ioctx("eqdata"))
        return tree, objs, d._applied
    finally:
        if d is not None:
            d.shutdown()
        c.stop()


def test_mds_namespace_script_equals_jax_package():
    from ceph_tpu import cluster as ref_cluster
    from ceph_tpu import mds as ref_mds
    from ceph_tpu.fs import mdsclient as ref_client
    from ceph_tpu_torch import cluster as port_cluster
    from ceph_tpu_torch import mds as port_mds
    from ceph_tpu_torch.fs import mdsclient as port_client
    from test_torch_fs import GPU_K2M1, TPU_K2M1
    port_tree, port_objs, port_applied = _mds_on(
        port_cluster, port_mds, port_client, GPU_K2M1)
    ref_tree, ref_objs, ref_applied = _mds_on(
        ref_cluster, ref_mds, ref_client, TPU_K2M1)
    assert [t[:3] for t in port_tree] == [t[:3] for t in ref_tree]
    for p, r in zip(port_tree, ref_tree):
        assert p[3] == r[3], p[:3]
    assert port_objs == ref_objs
    # every mutation went through the MDS journal, as many on each
    assert port_applied == ref_applied > 0
    paths = {t[0] for t in port_tree}
    assert "/d3" in paths and "/d0/renamed.bin" in paths
