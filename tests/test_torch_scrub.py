"""Port twins of tests/test_scrub.py: scrub, repair and EIO on the port's
daemons.

Deep scrub compares replica hashes and EC shard CRCs against HashInfo
(reference ReplicatedBackend::be_deep_scrub, ECBackend::be_deep_scrub);
a corrupted shard surfaces as EIO, reads reconstruct from the
survivors, and repair rebuilds the bad copy.  The twins keep the
reference's cluster sizes and payloads; the EC one runs on a `gpu` pool
(``device="cpu"``) where the reference's uses jerasure, so the corrupt
shard is found and rebuilt through the port's device route.

Reference tests not twinned here:

- ``test_ec_corrupt_shard_read_survives_and_repairs`` and
  ``test_scrub_concurrent_with_writes_no_false_errors``: the tests of
  the same names in tests/test_torch_cluster_ec.py.
- ``test_replicated_deep_scrub_detects_and_repairs`` waits: it is red in
  the full runs of the suite for the JAX package too (ROADMAP C, "The
  reference's own red tests").
"""
import os
import time

import pytest

from ceph_tpu_torch.cluster import Cluster
from ceph_tpu_torch.cluster import test_config as make_conf


@pytest.fixture
def cl():
    with Cluster(n_osds=3) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        yield c


def pg_stat_of(cluster, oid, pool_name):
    ret, _, out = cluster.mon_command({"prefix": "pg dump"})
    assert ret == 0
    r = cluster.rados()
    io = r.open_ioctx(pool_name)
    with r.objecter.lock:
        pgid = r.objecter.osdmap.object_locator_to_pg(oid, io.pool_id)
    return str(pgid), out["pg_stats"].get(str(pgid), {})


def wait_scrub_errors(cluster, pgid, predicate, timeout=30.0):
    deadline = time.monotonic() + timeout
    stat = None
    while time.monotonic() < deadline:
        ret, _, out = cluster.mon_command({"prefix": "pg dump"})
        if ret == 0:
            stat = out["pg_stats"].get(pgid, {})
            if predicate(stat):
                return stat
        time.sleep(0.2)
    raise TimeoutError(f"pg {pgid} never matched: last={stat}")


def repair_until_clean(cluster, pgid, deep=True):
    ret, rs, _ = cluster.mon_command({"prefix": "pg repair",
                                      "pgid": pgid})
    assert ret == 0, rs
    deadline = time.monotonic() + 60
    stat = None
    while time.monotonic() < deadline:
        cluster.mon_command({"prefix": "pg deep-scrub", "pgid": pgid})
        ret, _, out = cluster.mon_command({"prefix": "pg dump"})
        stat = out["pg_stats"].get(pgid, {})
        if stat.get("num_scrub_errors", 1) == 0 and \
                stat.get("num_missing", 1) == 0 and \
                (not deep or stat.get("last_deep_scrub", 0) > 0):
            return stat
        time.sleep(0.3)
    raise TimeoutError(f"repair never converged: {stat}")


def test_ec_injected_write_corruption_scrub_repair_roundtrip(cl):
    """Fault-registry store.apply corruption: ONE shard write of one
    object is bit-flipped as it enters the store (in-flight bit rot,
    not post-hoc file surgery).  The client read must still return good
    bytes via parity, deep scrub must localize exactly one bad shard,
    and repair must round-trip back to clean."""
    from ceph_tpu_torch.utils import faults as faultlib

    cl.create_ec_profile("fin", plugin="gpu", k="2", m="1", device="cpu")
    cl.create_pool("finp", "erasure", erasure_code_profile="fin")
    io = cl.rados().open_ioctx("finp")
    payload = os.urandom(16384)

    def only_victim(txns):
        return any(op[0] == "write" and op[2].oid == "fvic"
                   for t in txns for op in t.ops)

    reg = faultlib.registry()
    reg.reset()
    reg.arm(faultlib.STORE_APPLY, mode="corrupt", every=1,
            max_trips=1, match=only_victim, seed=3)
    try:
        io.write_full("fvic", payload)
        assert reg.trips(faultlib.STORE_APPLY) == 1, \
            "the write never passed the store gate"
    finally:
        reg.reset()
    cl.wait_for_clean(20)

    # reads reconstruct around the rotten shard
    assert io.read("fvic") == payload

    pgid, _ = pg_stat_of(cl, "fvic", "finp")
    ret, rs, _ = cl.mon_command({"prefix": "pg deep-scrub",
                                 "pgid": pgid})
    assert ret == 0, rs
    stat = wait_scrub_errors(
        cl, pgid, lambda s: s.get("num_scrub_errors", 0) > 0)
    bad_shards = stat["inconsistent"].get("fvic")
    assert bad_shards is not None and len(bad_shards) == 1, stat

    repair_until_clean(cl, pgid)
    assert io.read("fvic") == payload
    cl.wait_for_clean(20)


def test_periodic_background_scrub(tmp_path):
    """osd_scrub_interval drives automatic scrubbing from the OSD tick
    (reference OSD::sched_scrub)."""
    conf = make_conf(osd_scrub_interval=0.5,
                     osd_deep_scrub_interval=0.5)
    with Cluster(n_osds=3, conf=conf) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        c.create_pool("bg", "replicated", size=2)
        io = c.rados().open_ioctx("bg")
        io.write_full("auto", b"scrubme" * 100)
        c.wait_for_clean(20)
        deadline = time.monotonic() + 20
        seen = False
        while time.monotonic() < deadline and not seen:
            ret, _, out = c.mon_command({"prefix": "pg dump"})
            if ret == 0:
                for stat in out["pg_stats"].values():
                    if stat.get("last_deep_scrub", 0) > 0:
                        seen = True
            time.sleep(0.3)
        assert seen, "background scrub never ran"


def test_blockstore_bitrot_eio_and_repair(tmp_path):
    """End-to-end media corruption on the durable store: flip bytes in an
    OSD's raw block device UNDER the extent map — the per-block CRC turns
    the read into EIO at the store boundary (reference BlueStore
    _verify_csum), deep scrub localizes the bad replica, and repair
    re-homes good bytes over the rot."""
    from ceph_tpu_torch.store.blockstore import BLOCK

    with Cluster(n_osds=3, data_dir=str(tmp_path),
                 store_kind="block") as cl:
        for i in range(3):
            cl.wait_for_osd_up(i, 20)
        cl.create_pool("bp", "replicated", size=3)
        io = cl.rados().open_ioctx("bp")
        payload = os.urandom(12288)
        io.write_full("victim", payload)
        cl.wait_for_clean(20)

        pgid, _ = pg_stat_of(cl, "victim", "bp")
        ret, _, out = cl.mon_command({"prefix": "pg dump"})
        primary = out["pg_stats"][pgid]["acting"][0]
        bad_osd = next(o for o in cl.stores if o != primary)
        store = cl.stores[bad_osd]
        coll, gobj = next(
            (c, o) for c in store.list_collections()
            for o in store.collection_list(c) if o.oid == "victim")
        ext = store._load_extents(coll, gobj)
        phys = next(p for p in ext.blocks if p >= 0)
        with open(os.path.join(store.path, "block.dev"), "r+b") as f:
            f.seek(phys * BLOCK + 9)
            b = f.read(1)
            f.seek(phys * BLOCK + 9)
            f.write(bytes([b[0] ^ 0xA5]))

        # the store read is now EIO, not silent garbage
        with pytest.raises(OSError):
            store.read(coll, gobj)
        assert store.usage()["csum_failures"] >= 1

        # deep scrub flags exactly this replica; repair recovers it
        ret, rs, _ = cl.mon_command({"prefix": "pg deep-scrub",
                                     "pgid": pgid})
        assert ret == 0, rs
        stat = wait_scrub_errors(
            cl, pgid, lambda s: s.get("num_scrub_errors", 0) > 0)
        assert "victim" in stat["inconsistent"]
        repair_until_clean(cl, pgid, deep=False)
        assert io.read("victim", len(payload)) == payload
        assert store.read(coll, gobj) == payload
