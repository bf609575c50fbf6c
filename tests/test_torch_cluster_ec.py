"""The port's daemons on erasure-coded pools, continued from
tests/test_torch_cluster.py: port twins of the JAX package's EC pipeline
tests (tests/test_ec_pipeline.py, the EC-pool ones and the fast_read
refusal on a replicated pool), the cluster tests
of tests/test_rmw_delta.py and two of tests/test_scrub.py, each with
the `gpu` plugin on the CPU (``device=cpu`` in the profile) and classic
OSDs; then the north-star geometry, k=8 m=4 on 13 OSDs, on the port
alone."""
import os
import random
import threading
import time

import numpy as np
import pytest

from ceph_tpu_torch.client.rados import RadosError
from ceph_tpu_torch.cluster import Cluster
from ceph_tpu_torch.msg.messages import OSDOp
from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.store.objectstore import Transaction

from test_torch_cluster import gpu_profile, make_conf, set_overwrites


# ------------------------------------------------ tests/test_ec_pipeline.py
@pytest.fixture
def pipe():
    with Cluster(n_osds=3, conf=make_conf()) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        gpu_profile(c, "pipe", 2, 1)
        c.create_pool("pp", "erasure", erasure_code_profile="pipe")
        set_overwrites(c, "pp")
        yield c


def _find_primary_backend(c, io, oid):
    osdmap = c.rados().objecter.osdmap
    pgid = osdmap.object_locator_to_pg(oid, io.pool_id)
    _, _, _, primary = osdmap.pg_to_up_acting_osds(pgid)
    return c.osds[primary].pgs[pgid].backend


def test_pipelined_overwrites_single_object(pipe):
    """Concurrent partial overwrites of ONE object must pipeline
    (depth >= 2 observed in the backend) and still produce exactly
    the bytes of in-order application."""
    client = pipe.rados(timeout=30)
    client.op_timeout = 60.0
    io = client.open_ioctx("pp")
    size = 256 << 10
    base = os.urandom(size)
    io.write_full("big", base)            # barrier: settles first
    pipe.rados().wait_for_epoch(client.objecter.osdmap.epoch)

    model = bytearray(base)
    rng = random.Random(7)
    comps = []
    for i in range(16):
        off = rng.randrange(0, size - 5000)
        data = rng.randbytes(rng.randrange(1, 5000))
        # async writes on one connection arrive in submission order
        comps.append(client.objecter.submit(
            io.pool_id, "big",
            [OSDOp("write", offset=off, length=len(data), data=data)]))
        model[off:off + len(data)] = data
    for comp in comps:
        assert comp.wait(60) == 0
    assert io.read("big") == bytes(model), "pipelined writes diverged"

    be = _find_primary_backend(pipe, io, "big")
    assert be.max_concurrent_ops >= 2, \
        (f"no pipelined EXECUTION observed "
         f"(concurrent {be.max_concurrent_ops}, "
         f"queued {be.max_pipeline_depth})")


def test_overlapping_writes_read_inflight_extents(pipe):
    """Back-to-back writes overlapping the SAME stripes: the later
    op's RMW must see the earlier op's un-committed bytes (overlay),
    not stale shard state."""
    client = pipe.rados(timeout=30)
    client.op_timeout = 60.0
    io = client.open_ioctx("pp")
    size = 64 << 10
    io.write_full("ov", os.urandom(size))
    model = bytearray(io.read("ov"))
    comps = []
    # every write hits the same stripe range [0, 8K): maximal overlap
    for i in range(8):
        data = bytes([i]) * 3000
        off = (i * 700) % 4000
        comps.append(client.objecter.submit(
            io.pool_id, "ov",
            [OSDOp("write", offset=off, length=len(data),
                   data=data)]))
        model[off:off + len(data)] = data
    for comp in comps:
        assert comp.wait(60) == 0
    assert io.read("ov") == bytes(model)


def test_barrier_ops_serialize_with_pipeline(pipe):
    """A delete between pipelined writes must act as a barrier: the
    final state reflects strict submission order."""
    client = pipe.rados(timeout=30)
    client.op_timeout = 60.0
    io = client.open_ioctx("pp")
    io.write_full("bar", b"A" * 20000)
    comps = [client.objecter.submit(
        io.pool_id, "bar",
        [OSDOp("write", offset=0, length=5000, data=b"B" * 5000)])]
    comps.append(client.objecter.submit(
        io.pool_id, "bar", [OSDOp("delete")]))
    comps.append(client.objecter.submit(
        io.pool_id, "bar",
        [OSDOp("writefull", data=b"C" * 1000)]))
    for comp in comps:
        assert comp.wait(60) == 0
    assert io.read("bar") == b"C" * 1000


def test_fast_read_survives_undetected_dead_shard():
    """fast_read pools (reference ECBackend.cc:1043) fan reads to all
    shards and reconstruct from the first k — a freshly dead OSD that
    heartbeats have NOT yet flagged must not stall reads for the whole
    failure-detection grace."""
    import time as _t

    with Cluster(n_osds=4, conf=make_conf()) as c:
        for i in range(4):
            c.wait_for_osd_up(i, 20)
        gpu_profile(c, "fr", 2, 2)
        c.create_pool("frp", "erasure", erasure_code_profile="fr")
        rc, msg, _ = c.mon_command(
            {"prefix": "osd pool set", "pool": "frp",
             "var": "fast_read", "val": "true"})
        assert rc == 0, msg
        io = c.rados(timeout=20).open_ioctx("frp")
        import os as _os
        blob = _os.urandom(16384)
        io.write_full("fr0", blob)
        c.wait_for_clean(30)
        # find fr0's PG and kill a NON-primary member abruptly
        osd0 = next(o for o in c.osds.values() if o is not None)
        osdmap = osd0.osdmap
        pool_id = osdmap.pool_name_to_id["frp"]
        pgid = osdmap.object_locator_to_pg("fr0", pool_id)
        _, _, acting, primary = osdmap.pg_to_up_acting_osds(pgid)
        victim = next(o for o in acting
                      if o is not None and o != primary)
        c.kill_osd(victim)
        # read IMMEDIATELY, before heartbeats notice: fast_read
        # reconstructs from the first k answers instead of waiting on
        # the dead shard for the whole grace period
        t0 = _t.monotonic()
        assert io.read("fr0", len(blob)) == blob
        elapsed = _t.monotonic() - t0
        grace = c.conf["osd_heartbeat_grace"]
        assert elapsed < grace, \
            f"fast_read read took {elapsed:.1f}s >= grace {grace}s"


def test_fast_read_rejected_on_replicated_pool():
    """``fast_read`` is an EC pool flag: the monitor refuses it on a
    replicated pool with -EINVAL."""
    from ceph_tpu_torch.cluster import test_config as default_conf
    with Cluster(n_osds=3, conf=default_conf()) as c:
        c.create_pool("rp", "replicated")
        rc, _, _ = c.mon_command(
            {"prefix": "osd pool set", "pool": "rp",
             "var": "fast_read", "val": "true"})
        assert rc == -22


def test_copy_budget_8mib_write(pipe):
    """Zero-copy regression pin: one 8 MiB client write may move at
    most 1.5x its payload through tracked full-payload copies (today:
    exactly 1.0x — the single contiguous shard-column gather on the
    encode output).  A new bytes()/tobytes() round trip anywhere on
    the striper->messenger->batcher->store path lands here."""
    from ceph_tpu_torch.utils import copytrack
    client = pipe.rados(timeout=60)
    io = client.open_ioctx("pp")
    data = os.urandom(8 << 20)
    copytrack.reset()
    assert io.aio_write_full("budget", data).wait(60) == 0
    snap = copytrack.snapshot()
    assert 0 < snap["bytes"] <= int(1.5 * len(data)), snap
    allowed = {"batcher.shard_gather", "batcher.batch_concat",
               "ecbackend.rmw_gather", "striper.write_gather"}
    assert set(snap["sites"]) <= allowed, snap["sites"]
    assert io.read("budget") == data


def test_segmented_write_pipelines_and_roundtrips():
    """Writes larger than osd_ec_pipeline_segment_bytes are split into
    pipelined segments (encode of N+1 overlaps fanout of N) and must
    stay bit-exact: full write, cross-segment partial overwrite, an
    append continuing the running hinfo, and back-to-back full
    rewrites that exercise segment/pipeline ordering."""
    conf = make_conf(osd_ec_pipeline_segment_bytes=128 << 10)
    with Cluster(n_osds=3, conf=conf) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        gpu_profile(c, "seg", 2, 1)
        c.create_pool("sp", "erasure", erasure_code_profile="seg")
        ret, rs, _ = c.mon_command({"prefix": "osd pool set",
                                    "pool": "sp",
                                    "var": "allow_ec_overwrites",
                                    "val": "true"})
        assert ret == 0, rs
        client = c.rados(timeout=60)
        io = client.open_ioctx("sp")
        size = 1 << 20                   # 8 segments of 128 KiB
        # non-vacuous: the knob reached every EC backend, so a 1 MiB
        # write deterministically takes the segmented path
        segs = {pg.backend.seg_bytes for o in c.osds.values()
                if o is not None for pg in o.pgs.values()
                if hasattr(pg.backend, "seg_bytes")}
        assert segs == {128 << 10}, segs
        model = bytearray(os.urandom(size))
        assert io.aio_write_full("seg", bytes(model)).wait(60) == 0
        assert io.read("seg") == bytes(model)

        # partial overwrite spanning several segment boundaries
        off, span = 200_000, 400_000
        patch = os.urandom(span)
        model[off:off + span] = patch
        io.write("seg", patch, off)
        assert io.read("seg") == bytes(model)

        # append keeps the running hinfo consistent past the rewrite
        tail = os.urandom(300_000)
        io.write("seg", tail, size)
        model += tail
        assert io.read("seg") == bytes(model)

        # two overlapping full rewrites on one connection must apply
        # in submission order despite segment pipelining
        v1 = os.urandom(size)
        v2 = os.urandom(size)
        c1 = io.aio_write_full("seg", v1)
        c2 = io.aio_write_full("seg", v2)
        assert c1.wait(60) == 0 and c2.wait(60) == 0
        assert io.read("seg") == v2

        # no stranded in-flight state on any primary
        for o in c.osds.values():
            if o is None:
                continue
            for pg in o.pgs.values():
                be = pg.backend
                if hasattr(be, "waiting_commit"):
                    assert not be.waiting_commit



# --------------------------------- tests/test_rmw_delta.py, cluster tests
def test_cluster_delta_rmw_bit_exact_and_counted():
    """Sub-stripe overwrites over a committed object route through the
    delta path (backend counters prove it) and every byte reads back
    exactly — including after an OSD dies mid-workload."""
    with Cluster(n_osds=4, conf=make_conf()) as cl:
        for i in range(4):
            cl.wait_for_osd_up(i, 20)
        gpu_profile(cl, "drw", 2, 1)
        cl.create_pool("drwp", "erasure", erasure_code_profile="drw")
        ret, rs, _ = cl.mon_command({"prefix": "osd pool set",
                                     "pool": "drwp",
                                     "var": "allow_ec_overwrites",
                                     "val": "true"})
        assert ret == 0, rs
        r = cl.rados()
        r.wait_for_epoch(cl.mon.osdmap.epoch, 10)
        io = r.open_ioctx("drwp")
        size = 256 << 10
        base = os.urandom(size)
        io.write_full("obj", base)
        cl.wait_for_clean(20)
        expect = bytearray(base)
        deadline = time.monotonic() + 10
        while True:                   # flag propagation to the OSDs
            try:
                io.write("obj", b"Z" * 100, 10)
                break
            except RadosError as e:
                if e.errno != 95 or time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        expect[10:110] = b"Z" * 100
        rng = random.Random(0xBEEF)
        for _ in range(25):
            off = rng.randrange(0, size - 4096)
            ln = rng.choice([512, 2048, 4096])
            patch = os.urandom(ln)
            io.write("obj", patch, off)
            expect[off:off + ln] = patch
        assert io.read("obj", length=size) == bytes(expect)
        deltas = sum(getattr(pg.backend, "delta_rmw_ops", 0)
                     for o in cl.osds.values() if o is not None
                     for pg in o.pgs.values())
        assert deltas > 0, "no overwrite took the delta path"
        # survive a shard loss: reads and further overwrites stay exact
        cl.kill_osd(0, lose_data=True)
        cl.wait_for_osd_down(0)
        patch = os.urandom(2048)
        io.write("obj", patch, 4096)
        expect[4096:4096 + 2048] = patch
        assert io.read("obj", length=size) == bytes(expect)


def test_cluster_truncate_below_write_in_one_op():
    """Satellite regression: ONE compound op [truncate(T), write(off)]
    with T < off must (a) zero — not resurrect — the discarded bytes
    in [T, off), (b) keep the written bytes (the shard truncate must
    not chop the fresh write), (c) leave size == off+len."""
    with Cluster(n_osds=4, conf=make_conf()) as cl:
        for i in range(4):
            cl.wait_for_osd_up(i, 20)
        gpu_profile(cl, "tbw", 2, 1)
        cl.create_pool("tbwp", "erasure", erasure_code_profile="tbw")
        ret, rs, _ = cl.mon_command({"prefix": "osd pool set",
                                     "pool": "tbwp",
                                     "var": "allow_ec_overwrites",
                                     "val": "true"})
        assert ret == 0, rs
        r = cl.rados()
        r.wait_for_epoch(cl.mon.osdmap.epoch, 10)
        io = r.open_ioctx("tbwp")
        base = os.urandom(32768)
        io.write_full("o", base)
        deadline = time.monotonic() + 10
        while True:
            try:
                io.write("o", b"y", 0)
                break
            except RadosError as e:
                if e.errno != 95 or time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        patch = os.urandom(3000)
        io._obj_op("o", [OSDOp("truncate", offset=2000),
                         OSDOp("write", offset=5000, length=len(patch),
                               data=patch)])
        want = bytearray(base[:2000])      # survives the truncate
        want[0:1] = b"y"
        want += bytes(3000)                # [2000,5000): zeros, not
        want += patch                      # resurrected stale bytes
        got = io.read("o", length=65536)
        assert len(got) == 8000, f"size wrong: {len(got)}"
        assert got == bytes(want)



# ---------------------------------------------- tests/test_scrub.py
def corrupt_object(cluster, oid, shard=None, skip_osd=None):
    """Flip bytes of one stored copy of ``oid`` directly in an OSD's
    store, under the daemon — simulated bit-rot (reference
    test-erasure-eio.sh corrupting shard files on disk)."""
    for osd_id, store in cluster.stores.items():
        if osd_id == skip_osd:
            continue
        for coll in store.list_collections():
            for obj in store.collection_list(coll):
                if obj.oid != oid:
                    continue
                if shard is not None and obj.shard != shard:
                    continue
                st = store.stat(coll, obj)
                if st.size == 0:
                    continue
                garbage = bytes((b ^ 0xFF) for b in
                                store.read(coll, obj, 0, 64))
                t = Transaction()
                t.write(coll, obj, 0, garbage)
                store.apply_transaction(t)
                return osd_id, coll, obj
    raise AssertionError(f"no copy of {oid} found to corrupt")


def pg_stat_of(cluster, oid, pool_name):
    ret, _, out = cluster.mon_command({"prefix": "pg dump"})
    assert ret == 0
    # find the pg holding oid: any pg stat listing it is fine; instead
    # key by pgid computed client-side
    r = cluster.rados()
    io = r.open_ioctx(pool_name)
    with r.objecter.lock:
        pgid = r.objecter.osdmap.object_locator_to_pg(oid, io.pool_id)
    return str(pgid), out["pg_stats"].get(str(pgid), {})


def wait_scrub_errors(cluster, pgid, predicate, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        ret, _, out = cluster.mon_command({"prefix": "pg dump"})
        if ret == 0:
            stat = out["pg_stats"].get(pgid, {})
            if predicate(stat):
                return stat
        time.sleep(0.2)
    raise TimeoutError(f"pg {pgid} never matched: last={stat}")


@pytest.fixture
def scrub3():
    with Cluster(n_osds=3, conf=make_conf()) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        yield c


def test_ec_corrupt_shard_read_survives_and_repairs(scrub3):
    """Bit-rot on a data shard: reads must reconstruct from parity
    (hinfo CRC check -> EIO -> retry), deep scrub must localize the
    bad shard, repair must rewrite it."""
    cl = scrub3
    gpu_profile(cl, "sep", 2, 1)
    cl.create_pool("sep1", "erasure", erasure_code_profile="sep")
    io = cl.rados().open_ioctx("sep1")
    payload = os.urandom(16384)
    io.write_full("ecv", payload)
    cl.wait_for_clean(20)

    # corrupt data shard 0 wherever it lives
    bad_osd, coll, obj = corrupt_object(cl, "ecv", shard=0)
    assert obj.shard == 0

    # client read still returns correct bytes via parity
    assert io.read("ecv") == payload

    pgid, _ = pg_stat_of(cl, "ecv", "sep1")
    ret, rs, _ = cl.mon_command({"prefix": "pg deep-scrub",
                                "pgid": pgid})
    assert ret == 0, rs
    stat = wait_scrub_errors(
        cl, pgid, lambda s: s.get("num_scrub_errors", 0) > 0)
    assert stat["inconsistent"].get("ecv") == [0]

    ret, rs, _ = cl.mon_command({"prefix": "pg repair", "pgid": pgid})
    assert ret == 0, rs
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        cl.mon_command({"prefix": "pg deep-scrub", "pgid": pgid})
        ret, _, out = cl.mon_command({"prefix": "pg dump"})
        stat = out["pg_stats"].get(pgid, {})
        if stat.get("num_scrub_errors", 1) == 0 and \
                stat.get("num_missing", 1) == 0 and \
                stat.get("last_deep_scrub", 0) > 0:
            break
        time.sleep(0.3)
    else:
        raise TimeoutError(f"EC repair never converged: {stat}")
    # the shard object itself must be restored bit-exact
    store = cl.stores[bad_osd]
    data = store.read(coll, obj)
    assert data[:64] != bytes((b ^ 0xFF) for b in data[:64])
    assert io.read("ecv") == payload
    cl.wait_for_clean(20)


@pytest.mark.parametrize("pool_type", ["replicated", "erasure"])
def test_scrub_concurrent_with_writes_no_false_errors(scrub3, pool_type):
    """Scrub must snapshot one committed state: writes racing the
    round queue behind it instead of producing phantom mismatches
    (reference write blocking on the scrubbed range).  The reference
    runs a replicated pool; the erasure case runs the same race on a
    k=2 m=1 `gpu` pool, whose deep scrub compares shard CRCs."""
    cl = scrub3
    if pool_type == "erasure":
        gpu_profile(cl, "cwp", 2, 1)
        cl.create_pool("cw", "erasure", erasure_code_profile="cwp")
    else:
        cl.create_pool("cw", "replicated", size=3)
    io = cl.rados().open_ioctx("cw")
    io.write_full("hot", b"a" * 4096)
    cl.wait_for_clean(20)
    pgid, _ = pg_stat_of(cl, "hot", "cw")

    stop = []
    errors = []

    def writer():
        i = 0
        while not stop:
            try:
                io.write_full("hot", bytes([i % 256]) * 4096)
            except Exception as e:      # noqa: BLE001
                errors.append(e)
            i += 1

    t = threading.Thread(target=writer)
    t.start()
    try:
        for _ in range(4):
            cl.mon_command({"prefix": "pg deep-scrub", "pgid": pgid})
            time.sleep(0.8)
    finally:
        stop.append(1)
        t.join()
    assert not errors, errors
    stat = wait_scrub_errors(cl, pgid,
                             lambda s: s.get("last_deep_scrub", 0) > 0)
    assert stat.get("num_scrub_errors", 0) == 0, stat
    # writes queued behind scrub all landed
    assert len(io.read("hot")) == 4096


# ------------------------------------------ the north-star geometry
def test_north_star_k8m4_end_to_end():
    """The north-star geometry through the port's whole cluster stack:
    13 classic OSDs, a `gpu` k=8 m=4 pool on the CPU with 4 PGs —
    write, read back, degraded read with an OSD lost, rebuild back to
    active+clean, read back, and every shard equal to the jerasure
    encode of its object."""
    from ceph_tpu_torch.ec import registry as ecreg
    conf = make_conf(osd_heartbeat_interval=0.5, osd_heartbeat_grace=6.0,
                     osd_pool_default_pg_num=4,
                     mon_osd_down_out_interval=60.0)
    rng = np.random.default_rng(20260819)
    payloads = {f"ns{i}": rng.integers(0, 256, 40_000 + 1000 * i,
                                       dtype=np.uint8).tobytes()
                for i in range(6)}
    with Cluster(n_osds=13, conf=conf) as c:
        for i in range(13):
            c.wait_for_osd_up(i, 60)
        gpu_profile(c, "ns", 8, 4)
        c.create_pool("nsp", "erasure", erasure_code_profile="ns")
        client = c.rados(timeout=30)
        client.op_timeout = 120.0
        io = client.open_ioctx("nsp")
        for k, v in payloads.items():
            io.write_full(k, v)
        for k, v in payloads.items():
            assert io.read(k) == v
        c.wait_for_clean(60)
        c.kill_osd(0, lose_data=True)
        c.wait_for_osd_down(0)
        for k, v in payloads.items():
            assert io.read(k) == v, "reconstructing read failed"
        c.revive_osd(0)
        c.wait_for_osd_up(0)
        took = c.wait_for_clean(180)
        assert took < 180
        for k, v in payloads.items():
            assert io.read(k) == v
        # each shard on the OSD its acting set names, equal to jerasure
        jer = ecreg.instance().factory("jerasure", {"k": "8", "m": "4"})
        sinfo = ecutil.StripeInfo(8, 8 * 4096)
        osdmap = c.mon.osdmap
        for oid, data in payloads.items():
            pgid = osdmap.object_locator_to_pg(oid, io.pool_id)
            _, _, acting, _ = osdmap.pg_to_up_acting_osds(pgid)
            padded = data + bytes(-len(data) % sinfo.stripe_width)
            want = ecutil.encode(sinfo, jer, padded, set(range(12)))
            for shard, osd_id in enumerate(acting):
                store = c.stores[osd_id]
                got = [bytes(store.read(coll, obj))
                       for coll in store.list_collections()
                       for obj in store.collection_list(coll)
                       if obj.oid == oid and obj.shard == shard]
                assert got == [bytes(want[shard])], (oid, shard, osd_id)
