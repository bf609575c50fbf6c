"""RADOS object snapshots in the port (ceph_tpu_torch.osd.snaps and the
OSDs' clone paths): SnapSet algebra, then selfmanaged snaps, rollback,
snapdir survival across head deletion, snap trimming and pool snaps on
the port's cluster at the config default (crimson OSDs), on a
replicated pool and on a k=2 m=1 pool of the `gpu` plugin on the CPU,
whose clones are per-shard store clones.

Port twins of all 10 tests of tests/test_snaps.py (reference analog:
src/test/librados/snapshots.cc and the snap workloads of
qa/suites/rados/thrash-erasure-code)."""
import os
import time

import pytest

from ceph_tpu_torch.client.rados import RadosError
from ceph_tpu_torch.cluster import Cluster
from ceph_tpu_torch.osd.snaps import SnapContext, SnapSet


# ---------------------------------------------------------------------------
# unit: SnapSet algebra
# ---------------------------------------------------------------------------

def test_snapset_clone_and_resolution():
    ss = SnapSet()
    # first write under snapc(seq=2, snaps=[2,1]) on an existing object
    assert ss.needs_clone(SnapContext(2, [2, 1]))
    cid = ss.add_clone(SnapContext(2, [2, 1]), head_size=100)
    assert cid == 2 and ss.seq == 2
    assert ss.clone_snaps[2] == [1, 2]
    # snap 1 and 2 both resolve to the clone; snap 3 (>seq) to head
    assert ss.resolve_read(1) == ("clone", 2)
    assert ss.resolve_read(2) == ("clone", 2)
    assert ss.resolve_read(3) == ("head", None)
    # second era: snap 5 taken, next write clones again covering 3..5
    cid2 = ss.add_clone(SnapContext(5, [5, 4, 3]), head_size=64)
    assert cid2 == 5
    assert ss.resolve_read(4) == ("clone", 5)
    assert ss.resolve_read(1) == ("clone", 2)


def test_snapset_nonexistence_resolves_enoent():
    ss = SnapSet()
    ss.advance_seq(SnapContext(4, [4]))  # object created in era 4
    # snaps 3 and 4 predate the object's existence (its creating
    # write already carried snapc.seq=4); only later snaps see it
    assert ss.resolve_read(3) == ("enoent", None)
    assert ss.resolve_read(4) == ("enoent", None)
    assert ss.resolve_read(5) == ("head", None)


def test_snapset_trim():
    ss = SnapSet()
    ss.add_clone(SnapContext(2, [2, 1]), 10)
    ss.add_clone(SnapContext(4, [4, 3]), 20)
    gone = ss.trim({1, 2})
    assert gone == [2] and ss.clones == [4]
    gone = ss.trim({3})
    assert gone == [] and ss.clone_snaps[4] == [4]
    gone = ss.trim({4})
    assert gone == [4] and ss.empty
    # wire round trip
    ss2 = SnapSet.decode(ss.encode())
    assert ss2.seq == ss.seq and ss2.clones == ss.clones


# ---------------------------------------------------------------------------
# live cluster
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cl():
    with Cluster(n_osds=3) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        c.create_pool("rp", "replicated", size=2)
        c.create_ec_profile("esnap", plugin="gpu", k="2", m="1",
                            device="cpu")
        c.create_pool("ecp", "erasure", erasure_code_profile="esnap")
        yield c


@pytest.fixture(scope="module")
def rio(cl):
    return cl.rados().open_ioctx("rp")


@pytest.fixture(scope="module")
def eio(cl):
    return cl.rados().open_ioctx("ecp")


def _snap_roundtrip(io, tag):
    v1 = os.urandom(8192)
    v2 = os.urandom(8192)
    io.write_full(f"{tag}.a", v1)
    s1 = io.selfmanaged_snap_create()
    io.set_snap_context(s1, [s1])
    io.write_full(f"{tag}.a", v2)          # clones the head first
    # head reads the new data, the snap reads the old
    assert io.read(f"{tag}.a") == v2
    io.snap_set_read(s1)
    assert io.read(f"{tag}.a") == v1
    assert io.stat(f"{tag}.a")[0] == len(v1)
    io.snap_set_read(0)
    assert io.read(f"{tag}.a") == v2
    # an object born after the snap does not exist at the snap
    io.write_full(f"{tag}.late", b"post-snap")
    io.snap_set_read(s1)
    with pytest.raises(RadosError):
        io.read(f"{tag}.late")
    io.snap_set_read(0)
    # clone inventory
    snaps = io.list_snaps(f"{tag}.a")
    assert snaps["seq"] == s1
    assert [c["id"] for c in snaps["clones"]] == [s1]
    assert snaps["clones"][0]["snaps"] == [s1]
    return v1, v2, s1


def test_selfmanaged_snap_replicated(rio):
    _snap_roundtrip(rio, "r")


def test_selfmanaged_snap_ec(eio):
    """The same snap semantics on an EC pool: clones are per-shard
    store clones — no re-encode."""
    _snap_roundtrip(eio, "e")


def test_rollback_replicated(rio):
    v1, v2, s1 = _snap_roundtrip(rio, "rb")
    rio.selfmanaged_snap_rollback("rb.a", s1)
    assert rio.read("rb.a") == v1          # head content restored
    # snapshots survive the rollback
    rio.snap_set_read(s1)
    assert rio.read("rb.a") == v1
    rio.snap_set_read(0)
    # rollback of a post-snap object = delete (did not exist then)
    rio.selfmanaged_snap_rollback("rb.late", s1)
    with pytest.raises(RadosError):
        rio.read("rb.late")


def test_rollback_ec(eio):
    v1, v2, s1 = _snap_roundtrip(eio, "erb")
    eio.selfmanaged_snap_rollback("erb.a", s1)
    assert eio.read("erb.a") == v1


def test_snapdir_survives_head_delete(rio):
    v1 = os.urandom(4096)
    rio.write_full("sd.a", v1)
    s1 = rio.selfmanaged_snap_create()
    rio.set_snap_context(s1, [s1])
    rio.remove("sd.a")                     # clones, then deletes head
    with pytest.raises(RadosError):
        rio.read("sd.a")                   # head is gone
    rio.snap_set_read(s1)
    assert rio.read("sd.a") == v1          # the snap still readable
    rio.snap_set_read(0)
    # heads-only listing must not show the deleted object
    assert "sd.a" not in rio.list_objects()
    # recreate: the SnapSet moves back from the snapdir
    v2 = os.urandom(1024)
    rio.write_full("sd.a", v2)
    assert rio.read("sd.a") == v2
    rio.snap_set_read(s1)
    assert rio.read("sd.a") == v1
    rio.snap_set_read(0)
    snaps = rio.list_snaps("sd.a")
    assert [c["id"] for c in snaps["clones"]] == [s1]


def test_snap_trim(cl, rio):
    v1 = os.urandom(2048)
    rio.write_full("tr.a", v1)
    s1 = rio.selfmanaged_snap_create()
    rio.set_snap_context(s1, [s1])
    rio.write_full("tr.a", os.urandom(2048))
    assert [c["id"] for c in rio.list_snaps("tr.a")["clones"]] == [s1]
    rio.selfmanaged_snap_remove(s1)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if not rio.list_snaps("tr.a")["clones"]:
            break
        time.sleep(0.3)
    assert not rio.list_snaps("tr.a")["clones"], "clone not trimmed"
    # the trimmed snap no longer resolves
    rio.snap_set_read(s1)
    with pytest.raises(RadosError):
        rio.read("tr.a")
    rio.snap_set_read(0)


def test_pool_snaps(rio):
    rio._snapc = None                      # back to pool-snap mode
    v1 = os.urandom(1000)
    rio.write_full("ps.a", v1)
    rio.create_snap("before")
    # wait for the client's map to show the new pool snap
    deadline = time.monotonic() + 10
    sid = 0
    while time.monotonic() < deadline:
        try:
            sid = rio.lookup_snap("before")
            break
        except RadosError:
            time.sleep(0.1)
    assert sid > 0
    # pool-snap mode: writes pick up the pool's implicit snap context
    v2 = os.urandom(1000)
    rio.write_full("ps.a", v2)
    rio.snap_set_read(sid)
    assert rio.read("ps.a") == v1
    rio.snap_set_read(0)
    assert rio.read("ps.a") == v2
    rio.remove_snap("before")
    with pytest.raises(RadosError):
        rio.lookup_snap("before")
