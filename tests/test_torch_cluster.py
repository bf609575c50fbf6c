"""The port's daemons end to end: an in-process cluster of classic OSDs
(ceph_tpu_torch.cluster) over the loopback-TCP messenger.

Port twins of the JAX package's live-cluster tests of tests/test_cluster.py
(pools, degraded reads, rebuild, overwrites, client resends), each with
the `gpu` plugin on the CPU (``device=cpu`` in the profile) where the
reference names a codec, and osd_backend="classic" (the crimson OSD is
not ported).  Then the slice held against the JAX package: one seeded
sequence (writes, two-column overwrites, an OSD lost and rebuilt)
through a 7-OSD cluster of each package, with placements, shard bytes,
hinfo and reads equal.  Last, what many daemons in one process share:
a process that stops its cluster exits cleanly, and one backend serves
thirteen batchers at once.  The twins of the EC pipeline, RMW and scrub
tests and the 13-OSD k=8 m=4 run are in tests/test_torch_cluster_ec.py."""
import os
import time

import numpy as np
import pytest

from ceph_tpu_torch.client.rados import RadosError
from ceph_tpu_torch.cluster import Cluster
from ceph_tpu_torch.cluster import test_config as cluster_conf
from ceph_tpu_torch.osd import ecutil


def make_conf(**over):
    """The cluster test timings, with classic OSDs."""
    over.setdefault("osd_backend", "classic")
    return cluster_conf(**over)


def gpu_profile(cluster, name, k, m, **kv):
    cluster.create_ec_profile(name, plugin="gpu", k=str(k), m=str(m),
                              device="cpu", **kv)


def set_overwrites(cluster, pool):
    ret, rs, _ = cluster.mon_command({"prefix": "osd pool set",
                                      "pool": pool,
                                      "var": "allow_ec_overwrites",
                                      "val": "true"})
    assert ret == 0, rs


def write_retrying_eopnotsupp(io, oid, data, off, timeout=10.0):
    """An overwrite right after ``allow_ec_overwrites`` may reach an
    OSD that has not seen the flag's map yet (-EOPNOTSUPP)."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            io.write(oid, data, off)
            return
        except RadosError as e:
            if e.errno != 95 or time.monotonic() > deadline:
                raise
            time.sleep(0.2)


@pytest.fixture
def cl():
    with Cluster(n_osds=4, conf=make_conf()) as c:
        for i in range(4):
            c.wait_for_osd_up(i, 20)
        yield c


# ------------------------------------------------- tests/test_cluster.py
def test_ec_pool_end_to_end(cl):
    gpu_profile(cl, "e1", 2, 1)
    cl.create_pool("ec1", "erasure", erasure_code_profile="e1")
    r = cl.rados()
    io = r.open_ioctx("ec1")
    payloads = {f"o{i}": os.urandom(3000 + 17 * i) for i in range(8)}
    for k, v in payloads.items():
        io.write_full(k, v)
    for k, v in payloads.items():
        assert io.read(k) == v
    assert sorted(io.list_objects()) == sorted(payloads)
    cl.wait_for_clean(20)


def test_ec_degraded_read_after_osd_down(cl):
    """reference test-erasure-code.sh:66-98 — 'ceph osd out' forces
    reconstructing reads from surviving shards."""
    gpu_profile(cl, "e2", 2, 1)
    cl.create_pool("ec2", "erasure", erasure_code_profile="e2")
    r = cl.rados()
    io = r.open_ioctx("ec2")
    data = {f"obj{i}": os.urandom(4096 * (i + 1)) for i in range(6)}
    for k, v in data.items():
        io.write_full(k, v)
    cl.wait_for_clean(20)

    cl.kill_osd(0, lose_data=True)
    cl.wait_for_osd_down(0)
    for k, v in data.items():       # every read must still succeed
        assert io.read(k) == v


def test_rebuild_after_disk_loss(cl):
    """Kill an OSD with data loss, revive empty, wait until recovery
    fills it back (BASELINE.json config 5: rebuild timing)."""
    gpu_profile(cl, "e3", 2, 1)
    cl.create_pool("ec3", "erasure", erasure_code_profile="e3")
    r = cl.rados()
    io = r.open_ioctx("ec3")
    blob = os.urandom(64 << 10)
    for i in range(10):
        io.write_full(f"big{i}", blob)
    cl.wait_for_clean(20)

    cl.kill_osd(1, lose_data=True)
    cl.wait_for_osd_down(1)
    cl.revive_osd(1)
    cl.wait_for_osd_up(1)
    took = cl.wait_for_clean(60)
    assert took < 60
    for i in range(10):
        assert io.read(f"big{i}") == blob


def test_ec_overwrites_pool(cl):
    """allow_ec_overwrites=true enables partial overwrites and
    truncate on EC pools (reference allows_ecoverwrites,
    osd_types.h:1600; RMW path ECBackend try_state_to_reads)."""
    gpu_profile(cl, "ovw", 2, 1)
    cl.create_pool("ecow", "erasure", erasure_code_profile="ovw")
    r = cl.rados()
    io = r.open_ioctx("ecow")
    base = os.urandom(16384)
    io.write_full("o", base)
    # without the flag: overwrite rejected EOPNOTSUPP
    with pytest.raises(RadosError) as ei:
        io.write("o", b"X" * 100, 50)
    assert ei.value.errno == 95
    set_overwrites(cl, "ecow")
    r.wait_for_epoch(cl.mon.osdmap.epoch, 10)
    # RMW overwrite mid-object + truncate now work, bytes exact
    patch = os.urandom(5000)
    write_retrying_eopnotsupp(io, "o", patch, 3000)
    expect = bytearray(base)
    expect[3000:8000] = patch
    assert io.read("o") == bytes(expect)
    io.truncate("o", 6000)
    assert io.read("o") == bytes(expect[:6000])


def test_pool_delete_frees_objects(cl):
    cl.create_pool("tmp1", "replicated", size=2)
    r = cl.rados()
    io = r.open_ioctx("tmp1")
    io.write_full("x", b"y")
    ret, rs, _ = cl.mon_command({"prefix": "osd pool delete",
                                 "pool": "tmp1"})
    assert ret == 0
    # the deletion reaches this client via its next map update; poll
    # until the pool disappears from its view
    deadline = time.monotonic() + 10
    while True:
        try:
            r.open_ioctx("tmp1")
        except RadosError:
            break
        assert time.monotonic() < deadline, "pool still visible"
        time.sleep(0.1)


def test_client_resend_on_primary_death(cl):
    """Objecter must retarget+resend when the acting primary dies
    mid-stream (reference Objecter resend on map change)."""
    cl.create_pool("rp2", "replicated", size=2)
    r = cl.rados()
    io = r.open_ioctx("rp2")
    for i in range(4):
        io.write_full(f"pre{i}", b"a" * 1000)
    # find and kill the primary of one object, then keep writing to it
    with r.objecter.lock:
        osdmap = r.objecter.osdmap
    pgid = osdmap.object_locator_to_pg("pre0", io.pool_id)
    _, primary, _, _ = osdmap.pg_to_up_acting_osds(pgid)
    cl.kill_osd(primary)
    cl.wait_for_osd_down(primary)
    io.write_full("pre0", b"b" * 1000)      # must retarget, not hang
    assert io.read("pre0") == b"b" * 1000


def test_client_resend_on_shard_death_interval_change(cl):
    """A write caught in flight when a NON-primary acting shard dies
    must complete via resend-on-interval-change, not hang to the op
    timeout: the PG discards its in-flight ops on the interval change
    and relies on the client to resend (reqid dedup makes that
    exactly-once), but a primary-move-only resend rule never fires —
    the op wedged until rados_osd_op_timeout (surfaced by the
    overwrite-heavy chaos profile, ISSUE 20)."""
    gpu_profile(cl, "eird", 2, 1)
    cl.create_pool("ecird", "erasure", erasure_code_profile="eird")
    r = cl.rados()
    io = r.open_ioctx("ecird")
    io.write_full("tgt", b"a" * 9000)
    cl.wait_for_clean(20)
    with r.objecter.lock:
        osdmap = r.objecter.osdmap
    pgid = osdmap.object_locator_to_pg("tgt", io.pool_id)
    _, _, acting, primary = osdmap.pg_to_up_acting_osds(pgid)
    shard = next(o for o in acting if o is not None and o != primary)
    # kill the shard and write BEFORE the mon marks it down: the op
    # wedges on the dead shard's sub-write ack with the primary still
    # up, so only the interval change can unstick it
    cl.kill_osd(shard)
    comp = io.aio_write_full("tgt", b"b" * 9000)
    cl.wait_for_osd_down(shard)
    assert comp.wait(30) == 0, \
        "in-flight write hung across the interval change"
    assert io.read("tgt") == b"b" * 9000


# ---------------------------------------- the slice against the JAX package
SEQ_SEED = 20260817
SEQ_SIZES = [49152, 10000, 70001, 16384, 1, 65536, 33333, 4096, 98304,
             20000, 8191, 131072]
SEQ_OVERWRITTEN = (0, 2, 5, 8)


def _seq_payloads():
    rng = np.random.default_rng(SEQ_SEED)
    return {f"s{i}": rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for i, n in enumerate(SEQ_SIZES)}


def _seq_patches():
    """Two data columns of the first stripe (4 KiB stripe unit, columns
    1 and 2), on 4 objects."""
    rng = np.random.default_rng(SEQ_SEED + 1)
    return {f"s{i}": rng.integers(0, 256, 8192, dtype=np.uint8).tobytes()
            for i in SEQ_OVERWRITTEN}


def _seq_snapshot(c, io, names):
    """Each PG's acting set, every shard's bytes and hinfo on every
    OSD's store, and the client's reads."""
    osdmap = c.mon.osdmap
    pool = osdmap.pools[io.pool_id]
    from importlib import import_module
    pgid_cls = import_module(type(osdmap).__module__).PGid
    acting = {}
    for seed in range(pool.pg_num):
        up, up_primary, act, primary = osdmap.pg_to_up_acting_osds(
            pgid_cls(io.pool_id, seed))
        acting[seed] = (list(up), up_primary, list(act), primary)
    shards = {}
    for osd_id, store in sorted(c.stores.items()):
        for coll in store.list_collections():
            for obj in store.collection_list(coll):
                if obj.oid not in names:
                    continue
                attrs = store.getattrs(coll, obj)
                shards[(osd_id, coll, obj.oid, obj.shard)] = (
                    bytes(store.read(coll, obj)),
                    bytes(attrs.get(ecutil.HINFO_KEY, b"")))
    reads = {n: io.read(n, length=1 << 20) for n in names}
    return acting, shards, reads


def _run_sequence(cluster_mod, profile):
    """Writes, two-column overwrites, then osd.3 lost and rebuilt, on a
    7-OSD cluster of ``cluster_mod``'s package; a snapshot after each
    step."""
    conf = cluster_mod.test_config(osd_backend="classic",
                                   osd_pool_default_pg_num=4,
                                   mon_osd_down_out_interval=60.0)
    payloads, patches = _seq_payloads(), _seq_patches()
    names = sorted(payloads)
    snaps = []
    # OSDs boot one at a time: the monitor gives each OSD's host bucket
    # the next crush id as its boot arrives, so the boot order sets the
    # placements, and both packages must see the same order
    with cluster_mod.Cluster(n_osds=0, conf=conf) as c:
        for i in range(7):
            c.start_osd(i)
            c.wait_for_osd_up(i, 30)
        c.create_ec_profile("eq", **profile)
        c.create_pool("eqp", "erasure", erasure_code_profile="eq",
                      pg_num=4)
        ret, rs, _ = c.mon_command({"prefix": "osd pool set",
                                    "pool": "eqp",
                                    "var": "allow_ec_overwrites",
                                    "val": "true"})
        assert ret == 0, rs
        r = c.rados(timeout=30)
        r.op_timeout = 60.0
        r.wait_for_epoch(c.mon.osdmap.epoch, 10)
        io = r.open_ioctx("eqp")
        for n in names:
            io.write_full(n, payloads[n])
        c.wait_for_clean(30)
        snaps.append(_seq_snapshot(c, io, names))
        for n, patch in sorted(patches.items()):
            write_retrying_eopnotsupp(io, n, patch, 4096)
        c.wait_for_clean(30)
        snaps.append(_seq_snapshot(c, io, names))
        c.kill_osd(3, lose_data=True)
        c.wait_for_osd_down(3)
        c.revive_osd(3)
        c.wait_for_osd_up(3)
        c.wait_for_clean(60)
        snaps.append(_seq_snapshot(c, io, names))
    return snaps


def test_cluster_shards_equal_jax_package():
    """The same seeded sequence through a 7-OSD cluster of each package
    (classic OSDs, pg_num 4, k=4 m=2): the JAX package with its `tpu`
    plugin on the CPU, the port with `gpu` on the CPU.  After the
    writes, the overwrites and the rebuild, every PG's acting set,
    every shard's bytes and hinfo on every OSD, and every read are
    equal, byte for byte."""
    from ceph_tpu import cluster as ref_cluster
    from ceph_tpu_torch import cluster as port_cluster
    port = _run_sequence(port_cluster, {"plugin": "gpu", "k": "4",
                                        "m": "2", "device": "cpu"})
    ref = _run_sequence(ref_cluster, {"plugin": "tpu", "k": "4",
                                      "m": "2"})
    payloads, patches = _seq_payloads(), _seq_patches()
    expect = dict(payloads)
    for n, patch in patches.items():
        b = bytearray(expect[n])
        if len(b) < 4096 + len(patch):
            b.extend(bytes(4096 + len(patch) - len(b)))
        b[4096:4096 + len(patch)] = patch
        expect[n] = bytes(b)
    for step, (p, r) in enumerate(zip(port, ref)):
        p_acting, p_shards, p_reads = p
        r_acting, r_shards, r_reads = r
        assert p_acting == r_acting, step
        assert sorted(p_shards) == sorted(r_shards), step
        for key in r_shards:
            assert p_shards[key][0] == r_shards[key][0], (step, key)
            assert p_shards[key][1] == r_shards[key][1], (step, key)
        assert p_reads == r_reads, step
        want = payloads if step == 0 else expect
        assert p_reads == want, step
    # every object has k + m = 6 shards after each step, on 6 OSDs
    for _, shards, _ in port:
        per_obj = {}
        for (osd_id, _, oid, shard) in shards:
            per_obj.setdefault(oid, set()).add((osd_id, shard))
        assert all(len(v) == 6 for v in per_obj.values()), per_obj
    # osd.3 was rebuilt: it holds shards again after the last step
    assert any(k[0] == 3 for k in port[2][1])


def test_process_exits_cleanly_after_cluster_stop():
    """A PG's activation warm runs on a thread of its own; one still
    inside a torch call when the interpreter exits aborts the process.
    The cluster joins those warms when it stops, so a script that stops
    its cluster and exits at once exits 0."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import os\n"
        "from ceph_tpu_torch.cluster import Cluster, test_config\n"
        "c = Cluster(n_osds=3, conf=test_config(osd_backend='classic'))"
        ".start()\n"
        "c.create_ec_profile('p', plugin='gpu', k='2', m='1',"
        " device='cpu')\n"
        "c.create_pool('ecx', 'erasure', erasure_code_profile='p',"
        " pg_num=8)\n"
        "io = c.rados().open_ioctx('ecx')\n"
        "io.write_full('o', os.urandom(10000))\n"
        "c.stop()\n"
        "print('stopped')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=120)
    assert "terminate called" not in res.stderr, res.stderr[-2000:]
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "stopped"


def test_one_backend_serves_thirteen_batchers_at_once(monkeypatch):
    """As in a 13-OSD cluster, thirteen EncodeBatchers share the `gpu`
    plugin's one backend per device (its staging rings and operand
    cache).  Writes submitted to all of them at once from eight threads,
    with a short switch interval, all come back equal to jerasure's
    encode, and no staging slot is ever checked out twice at once."""
    import sys
    import threading

    from ceph_tpu_torch.ec import registry
    from ceph_tpu_torch.ec.plugins.gpu import shared_backend
    from ceph_tpu_torch.osd.batcher import EncodeBatcher

    codec = registry.instance().factory("gpu", {"k": "8", "m": "4",
                                                "device": "cpu"})
    jer = registry.instance().factory("jerasure", {"k": "8", "m": "4"})
    sinfo = ecutil.StripeInfo(8, 8 * 4096)
    pool = shared_backend("cpu").staging
    out_now, twice, lock = set(), [], threading.Lock()
    acquire, release = pool.acquire, pool.release

    def counted_acquire(shape):
        slot = acquire(shape)
        with lock:
            if id(slot) in out_now:
                twice.append(shape)
            out_now.add(id(slot))
        return slot

    def counted_release(shape, slot, fence):
        with lock:
            out_now.discard(id(slot))
        release(shape, slot, fence)
    monkeypatch.setattr(pool, "acquire", counted_acquire)
    monkeypatch.setattr(pool, "release", counted_release)

    rng = np.random.default_rng(SEQ_SEED + 3)
    n = 52
    objs = [rng.integers(0, 256, 4 * sinfo.stripe_width,
                         dtype=np.uint8).tobytes() for _ in range(n)]
    results, done = {}, threading.Semaphore(0)
    EncodeBatcher.reset_learning()
    batchers = [EncodeBatcher({"ec_tpu_fallback_cpu": False,
                               "ec_tpu_queue_window_us": 500})
                for _ in range(13)]

    def submit(i):
        def cb(chunks, i=i):
            results[i] = chunks
            done.release()
        batchers[i % 13].submit(codec, sinfo, objs[i], cb)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(
            target=lambda j=j: [submit(i) for i in range(j, n, 8)])
            for j in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        for _ in range(n):
            assert done.acquire(timeout=60)
    finally:
        sys.setswitchinterval(switch)
        for b in batchers:
            b.stop()
    assert not twice
    assert sum(b.cpu_reqs + b.device_errors for b in batchers) == 0
    assert sum(b.calls for b in batchers) >= 13
    for i, data in enumerate(objs):
        want = ecutil.encode(sinfo, jer, data)
        assert {s: bytes(v) for s, v in results[i].items()} == \
            {s: bytes(v) for s, v in want.items()}, i
