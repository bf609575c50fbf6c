"""RBD images in the port (ceph_tpu_torch.rbd): block images striped
over RADOS objects, with selfmanaged snapshots, clones, resize,
exclusive lock, journaling, object map and mirroring, on the port's
cluster at the config default (crimson OSDs).

Port twins of the 17 tests of tests/test_rbd.py (reference analog:
src/test/librbd/), test_rbd_cli_roundtrip through the port's rbd
command-line tool (ceph_tpu_torch.tools.rbd_cli).  Then the slice held against the JAX package: one seeded script of
writes, a snapshot, overwrites, a clone, resizes and a flatten on a
k=2 m=1 pool (the `gpu` plugin on the CPU against the reference's
`tpu`) of a 3-OSD cluster of each package, with every view's bytes and
the pool's (object, size) list equal."""
import os

import numpy as np
import pytest

from ceph_tpu_torch.client.rados import RadosError
from ceph_tpu_torch.cluster import Cluster
from ceph_tpu_torch.rbd import RBD, Image, ImageNotFound

ORDER = 14                           # 16 KiB objects: test-scale


@pytest.fixture(scope="module")
def cl():
    with Cluster(n_osds=3) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        c.create_pool("rbdp", "replicated", size=2)
        yield c


@pytest.fixture(scope="module")
def io(cl):
    return cl.rados().open_ioctx("rbdp")


def test_image_lifecycle(io):
    rbd = RBD(io)
    rbd.create("life", 1 << 20, order=ORDER)
    assert "life" in rbd.list()
    img = Image(io, "life")
    st = img.stat()
    assert st["size"] == 1 << 20 and st["object_size"] == 1 << ORDER
    with pytest.raises(RadosError):
        rbd.create("life", 1 << 20)
    rbd.remove("life")
    assert "life" not in rbd.list()
    with pytest.raises(ImageNotFound):
        Image(io, "life")


def test_image_io_across_objects(io):
    rbd = RBD(io)
    rbd.create("io1", 256 << 10, order=ORDER)
    img = Image(io, "io1")
    data = os.urandom(100_000)
    img.write(5_000, data)
    assert img.read(5_000, len(data)) == data
    # unwritten space reads zeros
    assert img.read(0, 5_000) == b"\0" * 5_000
    # overwrite spanning object boundaries
    patch = os.urandom(40_000)
    img.write(30_000, patch)
    got = img.read(0, 256 << 10)
    assert got[30_000:70_000] == patch
    assert got[5_000:30_000] == data[:25_000]
    with pytest.raises(RadosError):
        img.write((256 << 10) - 10, b"x" * 20)   # past the end


def test_snapshots_cow_and_rollback(io):
    rbd = RBD(io)
    rbd.create("snp", 128 << 10, order=ORDER)
    img = Image(io, "snp")
    v1 = os.urandom(64 << 10)
    img.write(0, v1)
    img.snap_create("s1")
    # post-snap writes must not alter the snapshot view
    v2 = os.urandom(64 << 10)
    img.write(0, v2)
    assert img.read(0, 64 << 10) == v2
    snap_view = Image(io, "snp", snap_name="s1")
    assert snap_view.read(0, 64 << 10) == v1
    with pytest.raises(RadosError):
        snap_view.write(0, b"nope")
    # second snapshot layers on the first
    img.snap_create("s2")
    v3 = os.urandom(32 << 10)
    img.write(10_000, v3)
    assert Image(io, "snp", "s1").read(0, 64 << 10) == v1
    assert Image(io, "snp", "s2").read(0, 64 << 10) == v2
    names = [s["name"] for s in img.snap_list()]
    assert names == ["s1", "s2"]
    # rollback to s1: head == v1 again
    img.snap_rollback("s1")
    assert img.read(0, 64 << 10) == v1
    # snapshots still intact after rollback
    assert Image(io, "snp", "s2").read(0, 64 << 10) == v2


def test_rollback_shadows_post_snap_holes(io):
    """An object unwritten at snap time but written afterwards must
    read as zeros after rollback (not the post-snap write)."""
    rbd = RBD(io)
    rbd.create("hole", 64 << 10, order=ORDER)
    img = Image(io, "hole")
    pre = os.urandom(16 << 10)
    img.write(0, pre)                 # object 0 exists at snap time
    img.snap_create("s")
    late = os.urandom(16 << 10)
    img.write(32 << 10, late)         # object 2: born after the snap
    img.snap_rollback("s")
    assert img.read(0, 16 << 10) == pre
    assert img.read(32 << 10, 16 << 10) == b"\0" * (16 << 10)
    # and writes after rollback behave normally
    img.write(32 << 10, b"z" * 100)
    assert img.read(32 << 10, 200) == b"z" * 100 + b"\0" * 100


def test_shrink_grow_with_snapshot_exposes_zeros(io):
    """Shrink-then-grow must re-expose zeros, not stale bytes, even
    while a snapshot pins the old data in an older generation."""
    rbd = RBD(io)
    rbd.create("szg", 64 << 10, order=ORDER)
    img = Image(io, "szg")
    data = os.urandom(64 << 10)
    img.write(0, data)
    img.snap_create("pin")
    img.resize(20 << 10)              # mid-object boundary at 20 KiB
    img.resize(64 << 10)
    got = img.read(0, 64 << 10)
    assert got[:20 << 10] == data[:20 << 10]
    assert got[20 << 10:] == b"\0" * (44 << 10)
    # the snapshot still sees the original content
    assert Image(io, "szg", "pin").read(0, 64 << 10) == data


def test_snap_rm_and_gc(io):
    rbd = RBD(io)
    rbd.create("gc", 64 << 10, order=ORDER)
    img = Image(io, "gc")
    a = os.urandom(32 << 10)
    img.write(0, a)
    img.snap_create("keep")
    b = os.urandom(32 << 10)
    img.write(0, b)
    img.snap_create("drop")
    c0 = os.urandom(32 << 10)
    img.write(0, c0)
    img.snap_rm("drop")
    # head and the remaining snap both still correct
    assert img.read(0, 32 << 10) == c0
    assert Image(io, "gc", "keep").read(0, 32 << 10) == a
    with pytest.raises(RadosError):
        img.snap_rm("missing")


def test_clone_and_flatten(io):
    rbd = RBD(io)
    rbd.create("par", 96 << 10, order=ORDER)
    parent = Image(io, "par")
    base = os.urandom(96 << 10)
    parent.write(0, base)
    parent.snap_create("golden")
    rbd.clone("par", "golden", "child")
    assert rbd.children("par", "golden") == ["child"]

    child = Image(io, "child")
    # unwritten extents come from the parent snapshot
    assert child.read(0, 96 << 10) == base
    # child writes COW, parent untouched
    patch = os.urandom(20_000)
    child.write(8_000, patch)
    got = child.read(0, 96 << 10)
    assert got[8_000:28_000] == patch
    assert got[:8_000] == base[:8_000]
    assert parent.read(0, 96 << 10) == base
    # parent snap is protected while the clone exists
    with pytest.raises(RadosError):
        parent.snap_rm("golden")
    # flatten severs the dependency
    child.flatten()
    assert Image(io, "child").header["parent"] is None
    parent2 = Image(io, "par")
    parent2.snap_rm("golden")
    assert Image(io, "child").read(0, 96 << 10)[:8_000] == base[:8_000]


def test_resize(io):
    rbd = RBD(io)
    rbd.create("rz", 128 << 10, order=ORDER)
    img = Image(io, "rz")
    data = os.urandom(128 << 10)
    img.write(0, data)
    img.resize(40 << 10)
    assert img.size() == 40 << 10
    assert img.read(0, 128 << 10) == data[:40 << 10]
    img.resize(80 << 10)
    got = img.read(0, 80 << 10)
    assert got[:40 << 10] == data[:40 << 10]
    assert got[40 << 10:] == b"\0" * (40 << 10)


def test_rbd_cli_roundtrip(cl, tmp_path, capsys):
    from ceph_tpu_torch.tools import rbd_cli
    host, port = cl.mon_addr
    m = f"{host}:{port}"
    src = tmp_path / "disk.img"
    src.write_bytes(os.urandom(150_000))
    assert rbd_cli.main(["-m", m, "-p", "rbdp", "import", str(src),
                         "cliimg", "--order", str(ORDER)]) == 0
    assert rbd_cli.main(["-m", m, "-p", "rbdp", "ls"]) == 0
    assert "cliimg" in capsys.readouterr().out.split()
    assert rbd_cli.main(["-m", m, "-p", "rbdp", "snap", "create",
                         "cliimg@s1"]) == 0
    assert rbd_cli.main(["-m", m, "-p", "rbdp", "clone", "cliimg@s1",
                         "clichild"]) == 0
    dst = tmp_path / "out.img"
    assert rbd_cli.main(["-m", m, "-p", "rbdp", "export", "clichild",
                         str(dst)]) == 0
    assert dst.read_bytes() == src.read_bytes()
    assert rbd_cli.main(["-m", m, "-p", "rbdp", "info",
                         "clichild"]) == 0
    import json
    info = json.loads(capsys.readouterr().out)
    assert info["parent"]["image"] == "cliimg"


def test_clone_shrink_grow_exposes_zeros(io):
    """Shrinking a clone below parent-backed extents and growing back
    must read zeros there, not the parent's bytes (whiteouts block
    the parent fallthrough)."""
    rbd = RBD(io)
    rbd.create("cpar", 64 << 10, order=ORDER)
    parent = Image(io, "cpar")
    base = os.urandom(64 << 10)
    parent.write(0, base)
    parent.snap_create("g")
    rbd.clone("cpar", "g", "cshrink")
    ch = Image(io, "cshrink")
    assert ch.read(0, 64 << 10) == base
    ch.resize(20 << 10)                # mid-object shrink
    ch.resize(64 << 10)
    got = Image(io, "cshrink").read(0, 64 << 10)
    assert got[:20 << 10] == base[:20 << 10]
    assert got[20 << 10:] == b"\0" * (44 << 10), \
        "parent bytes re-exposed after clone shrink+grow"


def test_clone_shrink_remove_leaks_nothing(io):
    """Whiteouts written past the shrunk size must be reclaimed when
    the image is removed (high-water-mark scan)."""
    rbd = RBD(io)
    rbd.create("lkp", 96 << 10, order=ORDER)
    parent = Image(io, "lkp")
    parent.write(0, os.urandom(96 << 10))
    parent.snap_create("g")
    rbd.clone("lkp", "g", "lkc")
    ch = Image(io, "lkc")
    ch.resize(16 << 10)                # whiteouts past 16 KiB
    rbd.remove("lkc")
    left = [o for o in io.list_objects() if "lkc" in o]
    assert not left, f"leaked: {left}"
    Image(io, "lkp").snap_rm("g")
    rbd.remove("lkp")


def test_exclusive_lock_blocks_second_writer():
    """exclusive-lock feature (reference librbd/exclusive_lock/ over
    cls_lock): a second client cannot write while the lock is held;
    force-acquire breaks a dead holder's lock."""
    from ceph_tpu_torch.client.rados import RadosError
    from ceph_tpu_torch.cluster import Cluster, test_config
    from ceph_tpu_torch.rbd.image import Image, RBD
    with Cluster(n_osds=3, conf=test_config()) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        c.create_pool("rbl", "replicated", size=2)
        io_a = c.rados().open_ioctx("rbl")
        io_b = c.rados().open_ioctx("rbl")
        RBD(io_a).create("locked", size=1 << 22, order=20,
                         features=("layering", "exclusive-lock"))
        a = Image(io_a, "locked")
        a.write(0, b"A" * 4096)          # lazy-acquires the lock
        assert a._lock_held
        b = Image(io_b, "locked")
        with pytest.raises(RadosError) as ei:
            b.write(0, b"B" * 4096)
        assert ei.value.errno == 16      # EBUSY
        # dead holder: the next writer force-breaks
        b.acquire_lock(force=True)
        b.write(0, b"B" * 4096)
        assert b.read(0, 4096) == b"B" * 4096
        b.close()


def test_journaling_replays_acked_writes_after_crash():
    """journaling feature (reference librbd/journal/): every write is
    journaled BEFORE data objects change; a client that dies between
    the two loses nothing — the next opener replays (no lost acked
    writes)."""
    import os as _os

    from ceph_tpu_torch.cluster import Cluster, test_config
    from ceph_tpu_torch.rbd.image import Image, RBD
    with Cluster(n_osds=3, conf=test_config()) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        c.create_pool("rbj", "replicated", size=2)
        io = c.rados().open_ioctx("rbj")
        RBD(io).create("wal", size=1 << 22, order=20,
                       features=("layering", "exclusive-lock",
                                 "journaling"))
        a = Image(io, "wal")
        base = _os.urandom(8192)
        a.write(0, base)                 # journaled + applied
        lost = _os.urandom(4096)
        a._inject_crash_after_journal = True
        a.write(4096, lost)              # acked, journaled, NOT applied
        # the writer "crashes" here (no release, no apply)
        io2 = c.rados().open_ioctx("rbj")
        b = Image(io2, "wal")
        b.acquire_lock(force=True)       # break + REPLAY
        got = b.read(0, 8192)
        assert got[:4096] == base[:4096]
        assert got[4096:] == lost, "acked journaled write was lost"
        b.close()


def test_journal_fences_zombie_writer():
    """A deposed lock holder's journal appends are rejected inside
    the OSD (cls_fence at the lock generation) — the same guarantee
    as MDS zombie fencing, so a paused writer can never corrupt the
    successor's image."""
    from ceph_tpu_torch.client.rados import RadosError
    from ceph_tpu_torch.cluster import Cluster, test_config
    from ceph_tpu_torch.rbd.image import Image, RBD
    with Cluster(n_osds=3, conf=test_config()) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        c.create_pool("rbz", "replicated", size=2)
        io_a = c.rados().open_ioctx("rbz")
        io_b = c.rados().open_ioctx("rbz")
        RBD(io_a).create("z", size=1 << 22, order=20,
                         features=("layering", "exclusive-lock",
                                   "journaling"))
        a = Image(io_a, "z")
        a.write(0, b"A" * 4096)
        # B evicts A (A is "wedged", not dead)
        b = Image(io_b, "z")
        b.acquire_lock(force=True)
        b.write(0, b"B" * 4096)
        # the zombie's next write must fail, not interleave
        with pytest.raises(RadosError) as ei:
            a.write(1 << 20, b"ZOMBIE")
        assert ei.value.errno in (16, 108)
        assert b.read(0, 4096) == b"B" * 4096
        b.close()


def test_object_map_and_fast_diff(cl):
    """object-map + fast-diff (reference librbd/object_map/): written objects mark EXISTS, snapshots
    freeze the map and reset the dirty bits, and fast_diff reports
    exactly the objects touched between two points in time — without
    reading any data."""
    from ceph_tpu_torch.rbd.image import (OM_EXISTS, OM_EXISTS_CLEAN,
                                    OM_NONEXISTENT)
    io = cl.rados().open_ioctx("rbdp")
    rbd = RBD(io)
    feats = ("layering", "exclusive-lock", "journaling", "fast-diff")
    rbd.create("om1", size=1 << 22, order=18, features=feats)  # 16 objs
    img = Image(io, "om1")
    assert img.has_feature("object-map")
    osz = img.object_size
    img.write(0, b"a" * 100)             # obj 0
    img.write(3 * osz, b"b" * osz)       # obj 3
    om = img._om_load()
    assert img._om_get(om, 0) == OM_EXISTS
    assert img._om_get(om, 3) == OM_EXISTS
    assert img._om_get(om, 1) == OM_NONEXISTENT

    img.snap_create("s1")
    om = img._om_load()
    assert img._om_get(om, 0) == OM_EXISTS_CLEAN  # dirty bits reset
    sid1 = img.header["snaps"]["s1"]["id"]
    som = img._om_load(sid1)
    assert img._om_get(som, 0) == OM_EXISTS      # frozen at the snap

    img.write(5 * osz, b"c" * 10)        # obj 5: new since s1
    img.write(0, b"z" * 8)               # obj 0: rewritten since s1
    assert sorted(img.fast_diff("s1")) == [0, 5]

    img.snap_create("s2")
    img.write(7 * osz, b"d")             # only obj 7 after s2
    assert sorted(img.fast_diff("s2")) == [7]
    # diff across BOTH intervals unions the per-snap dirty bits
    assert sorted(img.fast_diff("s1")) == [0, 5, 7]
    assert sorted(img.fast_diff("s1", "s2")) == [0, 5]

    # rebuild re-derives the same existence picture
    img.rebuild_object_map()
    om = img._om_load()
    assert img._om_get(om, 3) == OM_EXISTS
    assert img._om_get(om, 1) == OM_NONEXISTENT
    img.close()


def test_mirroring_bootstrap_replay_failover(cl):
    """Journal-based mirroring end-to-end (reference
    tools/rbd_mirror): bootstrap deep-copy, incremental
    journal replay, journal retention until the peer catches up,
    non-primary write refusal, and demote/promote failover."""
    from ceph_tpu_torch.rbd.image import _journal_oid
    from ceph_tpu_torch.rbd.mirror import MirrorDaemon
    cl.create_pool("rbdm2", "replicated", size=2)
    src = cl.rados().open_ioctx("rbdp")
    dst = cl.rados().open_ioctx("rbdm2")
    rbd = RBD(src)
    feats = ("layering", "exclusive-lock", "journaling")
    rbd.create("mir1", size=1 << 22, order=18, features=feats)
    img = Image(src, "mir1")
    img.mirror_enable(primary=True)
    d1 = os.urandom(300_000)
    img.write(0, d1)
    img.write(1 << 20, b"tail-data")

    daemon = MirrorDaemon(src, dst)
    out = daemon.sync_once()
    assert out["mir1"]["bootstrapped"], out
    dimg = Image(dst, "mir1")
    assert dimg.read(0, len(d1)) == d1
    assert dimg.read(1 << 20, 9) == b"tail-data"
    # the secondary refuses ordinary writes
    with pytest.raises(RadosError):
        dimg.write(0, b"nope")

    # incremental: new writes ride the journal, which is RETAINED
    # until the peer consumes it (trim gated on peer position)
    d2 = os.urandom(64_000)
    img.write(2 << 20, d2)
    img._journal_commit()                # would trim without a peer
    assert src.read(_journal_oid("mir1")), \
        "journal trimmed before the mirror peer consumed it"
    out = daemon.sync_once()
    assert out["mir1"]["replayed"] >= 1, out
    dimg = Image(dst, "mir1")
    assert dimg.read(2 << 20, len(d2)) == d2
    # peer caught up: the next commit may trim
    img._journal_commit()
    try:
        raw = src.read(_journal_oid("mir1"))
    except RadosError:
        raw = b""
    assert raw == b""

    # failover: demote old primary, promote the secondary
    daemon.demote_primary("mir1")
    daemon.promote("mir1")
    old = Image(src, "mir1")
    with pytest.raises(RadosError):
        old.write(0, b"stale-site write")
    new_primary = Image(dst, "mir1")
    new_primary.write(0, b"failover-write")
    assert new_primary.read(0, 14) == b"failover-write"
    img.close()


def test_mirroring_replicates_resize_at_object_level(cl):
    """Shrink-then-grow must not diverge: resize
    rides the journal and the secondary sheds its truncated objects,
    so after a grow both sites read zeros where the primary does."""
    from ceph_tpu_torch.rbd.mirror import MirrorDaemon
    cl.create_pool("rbdm3", "replicated", size=2)
    src = cl.rados().open_ioctx("rbdp")
    dst = cl.rados().open_ioctx("rbdm3")
    rbd = RBD(src)
    feats = ("layering", "exclusive-lock", "journaling")
    rbd.create("mir2", size=1 << 22, order=18, features=feats)
    img = Image(src, "mir2")
    img.mirror_enable(primary=True)
    stale = os.urandom(1 << 20)
    img.write(3 << 20, stale)            # data in the last MiB
    daemon = MirrorDaemon(src, dst)
    daemon.sync_once()                   # bootstrap carries it over
    assert Image(dst, "mir2").read(3 << 20, 64) == stale[:64]
    img.resize(1 << 20)                  # shrink: sheds objects
    img.resize(1 << 22)                  # grow: zeros there now
    assert img.read(3 << 20, 64) == b"\x00" * 64
    daemon.sync_once()
    dimg = Image(dst, "mir2")
    assert dimg.size() == 1 << 22
    assert dimg.read(3 << 20, 64) == b"\x00" * 64, \
        "secondary kept pre-shrink bytes the primary no longer has"
    # failover with unreplicated tail writes: demote FIRST, then
    # promote — the journal tail must drain into the secondary
    tail = os.urandom(5000)
    img.write(0, tail)
    daemon.demote_primary("mir2")
    daemon.promote("mir2")
    assert Image(dst, "mir2").read(0, len(tail)) == tail, \
        "demote-then-promote lost the unreplicated journal tail"
    img.close()


# ------------------------------------------ the slice against the JAX package
RBD_SEED = 20261018
RBD_ORDER = 16                       # 64 KiB objects over an 8 KiB stripe
RBD_SIZE = 6 << 16                   # six objects


def _rbd_script():
    """Seeded (offset, bytes) of the first writes and the overwrites
    of the parent image, and of the writes to the clone."""
    rng = np.random.default_rng(RBD_SEED)

    def writes(n, size, longest):
        out = []
        for _ in range(n):
            length = int(rng.integers(1, longest))
            off = int(rng.integers(0, size - length))
            out.append((off, rng.integers(0, 256, length,
                                          dtype=np.uint8).tobytes()))
        return out
    return (writes(6, RBD_SIZE, 100_000), writes(8, RBD_SIZE, 20_000),
            writes(3, RBD_SIZE, 30_000))


def _run_rbd_script(cluster_mod, rbd_mod, profile):
    """The script on an EC pool (k=2 m=1, ``allow_ec_overwrites``) of a
    3-OSD cluster of ``cluster_mod``'s package: an image created with
    the default feature set, written, snapshotted, overwritten, cloned
    from the snapshot, the clone written, shrunk mid-object and grown,
    then flattened and the parent snapshot removed.  -> (every view's
    bytes by step, the sorted (name, size) of the pool's objects)."""
    first, over, child_writes = _rbd_script()
    views = []
    with cluster_mod.Cluster(n_osds=3) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 30)
        c.create_ec_profile("rbdeq", **profile)
        c.create_pool("rbdec", "erasure", erasure_code_profile="rbdeq")
        ret, rs, _ = c.mon_command({"prefix": "osd pool set",
                                    "pool": "rbdec",
                                    "var": "allow_ec_overwrites",
                                    "val": "true"})
        assert ret == 0, rs
        r = c.rados(timeout=30)
        r.wait_for_epoch(c.mon.osdmap.epoch, 10)
        io = r.open_ioctx("rbdec")
        rbd = rbd_mod.RBD(io)
        rbd.create("vol", RBD_SIZE, order=RBD_ORDER)

        def view(step, name, snap=None):
            img = rbd_mod.Image(io, name, snap_name=snap)
            views.append((step, name, snap, img.size(),
                          img.read(0, img.size())))

        img = rbd_mod.Image(io, "vol")
        for off, data in first:
            img.write(off, data)
        view("written", "vol")
        img.snap_create("s1")
        for off, data in over:
            img.write(off, data)
        view("overwritten", "vol")
        view("overwritten", "vol", "s1")
        rbd.clone("vol", "s1", "child")
        child = rbd_mod.Image(io, "child")
        for off, data in child_writes:
            child.write(off, data)
        view("cloned", "child")
        child.resize(RBD_SIZE // 3 + 1000)
        child.resize(RBD_SIZE)
        img.resize(RBD_SIZE // 2)
        view("resized", "child")
        view("resized", "vol")
        view("resized", "vol", "s1")
        child.flatten()
        rbd_mod.Image(io, "vol").snap_rm("s1")
        view("flattened", "child")
        view("flattened", "vol")
        objects = sorted((o, io.stat(o)[0]) for o in io.list_objects())
    return views, objects


def test_rbd_script_equals_jax_package():
    from ceph_tpu import cluster as ref_cluster
    from ceph_tpu import rbd as ref_rbd
    from ceph_tpu_torch import cluster as port_cluster
    from ceph_tpu_torch import rbd as port_rbd
    port_views, port_objects = _run_rbd_script(
        port_cluster, port_rbd,
        {"plugin": "gpu", "k": "2", "m": "1", "device": "cpu"})
    ref_views, ref_objects = _run_rbd_script(
        ref_cluster, ref_rbd, {"plugin": "tpu", "k": "2", "m": "1"})
    assert len(port_views) == len(ref_views) == 9
    for p, r in zip(port_views, ref_views):
        assert p[:4] == r[:4]
        assert p[4] == r[4], p[:4]
    assert port_objects == ref_objects
    # the script reached what it was written for: the snapshot kept the
    # first writes, the head the overwrites, the clone its own writes,
    # and the flattened clone stands alone with its data objects
    first, over, child_writes = _rbd_script()
    want = bytearray(RBD_SIZE)
    for off, data in first:
        want[off:off + len(data)] = data
    snap = bytes(want)
    for off, data in over:
        want[off:off + len(data)] = data
    by_view = {(s, n, sn): b for s, n, sn, _, b in port_views}
    assert by_view[("overwritten", "vol", "s1")] == snap
    assert by_view[("overwritten", "vol", None)] == bytes(want)
    assert by_view[("flattened", "vol", None)] == \
        bytes(want[:RBD_SIZE // 2])
    names = [o for o, _ in port_objects]
    assert "rbd_header.child" in names and \
        any(o.startswith("rbd_data.child.") for o in names)
