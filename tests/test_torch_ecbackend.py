"""The port's PG backends (ceph_tpu_torch.osd.ecbackend,
replicatedbackend) over fake in-process clusters, against the JAX
package's.

* Twins of every test of tests/test_backends.py, on the port's `gpu`
  plugin with device="cpu" (the replicated two against the port's
  ReplicatedBackend).
* One seeded sequence through both packages' ECBackend, without a
  batcher and with each package's EncodeBatcher: writes, an unaligned
  append, a column overwrite (the parity-delta lane when a batcher is
  wired), a degraded read with shards (1, 5, 9, 11) down, recovery of
  one wiped shard and a deep scrub with syndromes.  Every sub-op crosses
  the package's frame codec.  Stores, shipped log entries, read results
  and scrub maps must match byte for byte.
* The host routes that stand in for the card are counted: a scrub
  window whose apply raises, a decode the crossover sends to the CPU
  twin, a decode that raises on the device codec.
* Packet codes keep their route: an ECBackend write of a cauchy_good
  pool through the batcher equals jerasure's encode.
* An LRC pool and a CLAY pool, their inner codes on the gpu plugin,
  through both packages' ECBackend; and CLAY's sub-chunk repair of an
  object of many stripes.
"""
import importlib
import threading

import numpy as np
import pytest


class Pkg:
    """One package's modules, so a test can drive either."""

    def __init__(self, name):
        root = "ceph_tpu" if name == "ref" else "ceph_tpu_torch"

        def mod(path):
            return importlib.import_module(f"{root}.{path}")
        self.name = name
        self.backend = mod("osd.backend")
        self.ecbackend = mod("osd.ecbackend")
        self.repbackend = mod("osd.replicatedbackend")
        self.pglog = mod("osd.pglog")
        self.ecutil = mod("osd.ecutil")
        self.batcher = mod("osd.batcher")
        self.registry = mod("ec.registry")
        self.memstore = mod("store.memstore")
        self.objectstore = mod("store.objectstore")
        self.message = mod("msg.message")
        self.crc = mod("utils.crc")
        self.plugin = "tpu" if name == "ref" else "gpu"
        self.host_cls = _host_class(self)

    def codec(self, **profile):
        prof = {k: str(v) for k, v in profile.items()}
        if self.name == "port":
            prof["device"] = "cpu"
        return self.registry.instance().factory(self.plugin, prof)


def _host_class(pkg):
    class FakeHost(pkg.backend.PGHost):
        """Minimal PGHost: shared router, per-OSD MemStore, trivial
        log.  With a cluster lock it is also the PG lock the batcher's
        continuations re-enter under."""

        def __init__(self, osd_id, shard, pgid, cluster):
            self._osd = osd_id
            self._shard = shard
            self._pgid = pgid
            self.cluster = cluster
            self._store = pkg.memstore.MemStore()
            self._store.mount()
            self._store.mkfs()
            self.logged = []
            self.backend = None
            self._lock = cluster.lock or threading.RLock()
            if cluster.lock is not None:
                self.lock = cluster.lock
            if cluster.conf is not None:
                self.conf = cluster.conf
            self.encode_batcher = cluster.batcher if osd_id == 0 else None

        @property
        def whoami(self):
            return self._osd

        @property
        def pgid_str(self):
            return self._pgid

        @property
        def own_shard(self):
            return self._shard

        @property
        def store(self):
            return self._store

        @property
        def epoch(self):
            return 1

        def coll_of(self, shard):
            return self._pgid if shard < 0 else f"{self._pgid}s{shard}"

        def acting_shards(self):
            return self.cluster.acting

        def send_shard(self, osd, msg):
            self.cluster.route(osd, msg)

        def prepare_log_txn(self, txn, log_entries):
            self.logged.extend(log_entries)

        def on_local_commit(self, fn):
            with self._lock:
                fn()

        def ec_profile(self):
            return self.cluster.profile
    return FakeHost


class FakeCluster:
    """Synchronous router + host factory.  ``wire`` sends every sub-op
    through the package's frame codec; ``lock`` is one PG lock for the
    whole cluster (routes and commits take it, so completions arriving
    on store and batcher threads serialize)."""

    def __init__(self, pkg, n_osds, pgid="1.0", ec=True, profile=None,
                 conf=None, batcher=None, wire=False, lock=False):
        self.pkg = pkg
        self.profile = profile or {}
        self.conf = conf
        self.batcher = batcher
        self.wire = wire
        self.lock = threading.RLock() if lock else None
        self.acting = [(s, s) for s in range(n_osds)]
        self.hosts = {i: pkg.host_cls(i, i if ec else -1, pgid, self)
                      for i in range(n_osds)}
        for host in self.hosts.values():
            txn = pkg.objectstore.Transaction()
            if ec:
                for s in range(n_osds):
                    txn.create_collection(f"{pgid}s{s}")
            else:
                txn.create_collection(pgid)
            host.store.queue_transactions([txn])
            host.store.flush()

    def route(self, osd, msg):
        if self.wire:
            mm = self.pkg.message
            parts = mm.encode_frame_parts(msg)
            head = parts[0]
            mtype, seq, plen = mm.decode_frame_header(head)
            msg = mm.decode_frame_body(
                mtype, seq, head, b"".join(parts[1:-1]), parts[-1])
        if self.lock is not None:
            with self.lock:
                handled = self.hosts[osd].backend.handle_message(msg)
        else:
            handled = self.hosts[osd].backend.handle_message(msg)
        assert handled, f"unhandled {type(msg).__name__} at osd.{osd}"

    def locked(self):
        import contextlib
        return self.lock if self.lock is not None \
            else contextlib.nullcontext()

    def flush(self):
        for host in self.hosts.values():
            host.store.flush()

    def shutdown(self):
        if self.batcher is not None:
            self.batcher.stop()
        for host in self.hosts.values():
            host.store.umount()


PORT = Pkg("port")


def _wait(event, timeout=20):
    assert event.wait(timeout), "timed out"


def _write(cl, backend, oid, data, version, offset=0, log=True):
    done = threading.Event()
    res = []
    entries = [cl.pkg.pglog.LogEntry(cl.pkg.pglog.MODIFY, oid, version)] \
        if log else []
    with cl.locked():
        backend.submit_transaction(
            oid, cl.pkg.backend.Mutation(writes=[(offset, data)]), version,
            entries, lambda r: (res.append(r), done.set()))
    _wait(done)
    return res[0]


def _read(cl, backend, oid, off, length):
    done = threading.Event()
    out = []
    with cl.locked():
        backend.objects_read(oid, off, length,
                             lambda r, d: (out.append((r, bytes(d))),
                                           done.set()))
    _wait(done)
    return out[0]


def _recover(cl, backend, oid, version, missing_on):
    done = threading.Event()
    res = []
    with cl.locked():
        backend.recover_object(oid, version, missing_on,
                               lambda r: (res.append(r), done.set()))
    _wait(done)
    cl.flush()
    return res[0]


def _remove(cl, osd, coll, obj):
    txn = cl.pkg.objectstore.Transaction()
    txn.remove(coll, obj)
    cl.hosts[osd].store.queue_transactions([txn])
    cl.hosts[osd].store.flush()


# --------------------------------- twins of tests/test_backends.py
@pytest.fixture()
def ec_cluster():
    profile = {"plugin": "gpu", "technique": "reed_sol_van",
               "k": "2", "m": "1", "device": "cpu"}
    cl = FakeCluster(PORT, 3, ec=True, profile=profile)
    ec_impl = PORT.codec(technique="reed_sol_van", k=2, m=1)
    for host in cl.hosts.values():
        host.backend = PORT.ecbackend.ECBackend(host, ec_impl,
                                                stripe_width=256)
    yield cl
    cl.shutdown()


def GH(oid, shard):
    return PORT.objectstore.GHObject(oid, shard)


def test_ec_write_read_roundtrip(ec_cluster):
    cl = ec_cluster
    primary = cl.hosts[0].backend
    data = bytes(range(256)) * 3
    assert _write(cl, primary, "obj1", data, (1, 1)) == 0
    cl.flush()
    for osd, host in cl.hosts.items():
        obj = GH("obj1", osd)
        chunk = host.store.read(f"1.0s{osd}", obj)
        assert len(chunk) == 3 * 128
        oi = PORT.backend.ObjectInfo.decode(
            host.store.getattr(f"1.0s{osd}", obj, PORT.backend.OI_ATTR))
        assert oi.size == len(data)
        assert oi.version == (1, 1)
    res, out = _read(cl, primary, "obj1", 0, len(data))
    assert res == 0 and out == data
    res, out = _read(cl, primary, "obj1", 100, 300)
    assert res == 0 and out == data[100:400]


def test_ec_unaligned_append_pads(ec_cluster):
    cl = ec_cluster
    primary = cl.hosts[0].backend
    data = b"x" * 100
    assert _write(cl, primary, "small", data, (1, 1)) == 0
    res, out = _read(cl, primary, "small", 0, 1000)
    assert res == 0 and out == data


def test_ec_rmw_overwrite(ec_cluster):
    cl = ec_cluster
    primary = cl.hosts[0].backend
    base = bytes(range(256)) * 2
    assert _write(cl, primary, "rmw", base, (1, 1)) == 0
    patch = b"\xff" * 50
    assert _write(cl, primary, "rmw", patch, (1, 2), offset=10) == 0
    expect = bytearray(base)
    expect[10:60] = patch
    res, out = _read(cl, primary, "rmw", 0, len(base))
    assert res == 0 and out == bytes(expect)


def test_ec_degraded_read_with_hole(ec_cluster):
    cl = ec_cluster
    primary = cl.hosts[0].backend
    data = bytes(range(256)) * 4
    assert _write(cl, primary, "deg", data, (1, 1)) == 0
    cl.flush()
    cl.acting = [(0, 0), (1, None), (2, 2)]
    res, out = _read(cl, primary, "deg", 0, len(data))
    assert res == 0 and out == data


def test_ec_read_retry_on_corrupt_shard(ec_cluster):
    cl = ec_cluster
    primary = cl.hosts[0].backend
    data = bytes(range(256)) * 2
    assert _write(cl, primary, "eio", data, (1, 1)) == 0
    cl.flush()
    _remove(cl, 1, "1.0s1", GH("eio", 1))
    res, out = _read(cl, primary, "eio", 0, len(data))
    assert res == 0 and out == data


def test_ec_delete(ec_cluster):
    cl = ec_cluster
    primary = cl.hosts[0].backend
    assert _write(cl, primary, "gone", b"y" * 300, (1, 1)) == 0
    done = threading.Event()
    primary.submit_transaction(
        "gone", PORT.backend.Mutation(delete=True), (1, 2),
        [PORT.pglog.LogEntry("delete", "gone", (1, 2))],
        lambda r: done.set())
    _wait(done)
    cl.flush()
    for osd, host in cl.hosts.items():
        assert not host.store.exists(f"1.0s{osd}", GH("gone", osd))
    res, _ = _read(cl, primary, "gone", 0, 10)
    assert res == -2


def test_ec_recovery_rebuild_shard(ec_cluster):
    cl = ec_cluster
    primary = cl.hosts[0].backend
    data = bytes(range(256)) * 5
    assert _write(cl, primary, "rec", data, (1, 1)) == 0
    cl.flush()
    _remove(cl, 2, "1.0s2", GH("rec", 2))
    assert _recover(cl, primary, "rec", (1, 1), [(2, 2)]) == 0
    chunk = cl.hosts[2].store.read("1.0s2", GH("rec", 2))
    chunk0 = cl.hosts[0].store.read("1.0s0", GH("rec", 0))
    assert len(chunk) == len(chunk0)
    oi = PORT.backend.ObjectInfo.decode(cl.hosts[2].store.getattr(
        "1.0s2", GH("rec", 2), PORT.backend.OI_ATTR))
    assert oi.size == len(data)
    res2, out = _read(cl, primary, "rec", 0, len(data))
    assert res2 == 0 and out == data


def test_ec_recovery_onto_primary(ec_cluster):
    cl = ec_cluster
    primary = cl.hosts[0].backend
    data = bytes(range(256)) * 2
    assert _write(cl, primary, "selfrec", data, (1, 1)) == 0
    cl.flush()
    _remove(cl, 0, "1.0s0", GH("selfrec", 0))
    assert _recover(cl, primary, "selfrec", (1, 1), [(0, 0)]) == 0
    res2, out = _read(cl, primary, "selfrec", 0, len(data))
    assert res2 == 0 and out == data


def test_ec_writefull_replace_and_exclusive_create(ec_cluster):
    cl = ec_cluster
    primary = cl.hosts[0].backend
    assert _write(cl, primary, "excl", b"a" * 256, (1, 1)) == 0
    done = threading.Event()
    res = []
    primary.submit_transaction(
        "excl", PORT.backend.Mutation(writes=[(0, b"b" * 100)],
                                      truncate=100),
        (1, 2), [], lambda r: (res.append(r), done.set()))
    _wait(done)
    assert res == [0]
    r, out = _read(cl, primary, "excl", 0, 1000)
    assert r == 0 and out == b"b" * 100
    done2 = threading.Event()
    primary.submit_transaction(
        "excl", PORT.backend.Mutation(create=True, writes=[(0, b"c" * 256)]),
        (1, 3), [], lambda r: (res.append(r), done2.set()))
    _wait(done2)
    assert res == [0, -17]


def test_ec_short_shard_treated_as_error(ec_cluster):
    cl = ec_cluster
    primary = cl.hosts[0].backend
    data = bytes(range(256)) * 2
    assert _write(cl, primary, "short", data, (1, 1)) == 0
    cl.flush()
    txn = PORT.objectstore.Transaction()
    txn.truncate("1.0s1", GH("short", 1), 17)
    cl.hosts[1].store.queue_transactions([txn])
    cl.hosts[1].store.flush()
    res, out = _read(cl, primary, "short", 0, len(data))
    assert res == 0 and out == data


def test_ec_recovery_push_clears_stale_attrs(ec_cluster):
    cl = ec_cluster
    primary = cl.hosts[0].backend
    assert _write(cl, primary, "stale", b"s" * 256, (1, 1)) == 0
    cl.flush()
    txn = PORT.objectstore.Transaction()
    txn.setattr("1.0s2", GH("stale", 2), "u_old", b"junk")
    cl.hosts[2].store.queue_transactions([txn])
    cl.hosts[2].store.flush()
    _recover(cl, primary, "stale", (1, 1), [(2, 2)])
    attrs = cl.hosts[2].store.getattrs("1.0s2", GH("stale", 2))
    assert "u_old" not in attrs


def test_ec_log_entries_ship_with_subwrites(ec_cluster):
    cl = ec_cluster
    primary = cl.hosts[0].backend
    _write(cl, primary, "logged", b"z" * 256, (1, 1))
    for host in cl.hosts.values():
        assert any(e["oid"] == "logged" for e in host.logged)


@pytest.fixture()
def rep_cluster():
    cl = FakeCluster(PORT, 3, ec=False)
    for host in cl.hosts.values():
        host.backend = PORT.repbackend.ReplicatedBackend(host)
    yield cl
    cl.shutdown()


def test_replicated_write_read_and_omap(rep_cluster):
    cl = rep_cluster
    primary = cl.hosts[0].backend
    done = threading.Event()
    primary.submit_transaction(
        "r1", PORT.backend.Mutation(writes=[(0, b"hello")],
                                    omap_set={"k1": b"v1"},
                                    attrs={"mykey": b"myval"}),
        (1, 1), [PORT.pglog.LogEntry(PORT.pglog.MODIFY, "r1", (1, 1))],
        lambda r: done.set())
    _wait(done)
    cl.flush()
    for host in cl.hosts.values():
        obj = GH("r1", -1)
        assert host.store.read("1.0", obj) == b"hello"
        assert host.store.omap_get("1.0", obj) == {"k1": b"v1"}
        assert host.store.getattr("1.0", obj, "u_mykey") == b"myval"
    res, out = _read(cl, primary, "r1", 0, 5)
    assert res == 0 and out == b"hello"


def test_replicated_recovery_push(rep_cluster):
    cl = rep_cluster
    primary = cl.hosts[0].backend
    done = threading.Event()
    primary.submit_transaction(
        "r2", PORT.backend.Mutation(writes=[(0, b"payload")]), (1, 1),
        [PORT.pglog.LogEntry(PORT.pglog.MODIFY, "r2", (1, 1))],
        lambda r: done.set())
    _wait(done)
    cl.flush()
    _remove(cl, 2, "1.0", GH("r2", -1))
    assert _recover(cl, primary, "r2", (1, 1), [(2, 2)]) == 0
    assert cl.hosts[2].store.read("1.0", GH("r2", -1)) == b"payload"


# ------------------------------- one seeded sequence, both packages
ERASED = (1, 5, 9, 11)


def build(pkg, k, m, stripe_width, with_batcher):
    conf = {"osd_deep_scrub_syndrome": True}
    batcher = None
    if with_batcher:
        B = pkg.batcher.EncodeBatcher
        B.reset_learning()
        batcher = B({"ec_tpu_batch_stripes": 256,
                     "ec_tpu_queue_window_us": 500,
                     "osd_ec_prewarm": False})
    cl = FakeCluster(pkg, k + m, profile={"k": str(k), "m": str(m)},
                     conf=conf, batcher=batcher, wire=True, lock=True)
    ec_impl = pkg.codec(technique="reed_sol_van", k=k, m=m)
    for host in cl.hosts.values():
        host.backend = pkg.ecbackend.ECBackend(host, ec_impl,
                                               stripe_width=stripe_width)
    return cl


def run_sequence(pkg, k, m, stripe_width, with_batcher, seed):
    """Drive the sequence; returns everything the two packages must
    agree on."""
    rng = np.random.default_rng(seed)
    n = k + m
    cs = stripe_width // k
    cl = build(pkg, k, m, stripe_width, with_batcher)
    primary = cl.hosts[0].backend
    out = {"results": []}
    try:
        objs = {}
        for i, nstripes in enumerate((4, 3, 1)):
            data = rng.integers(0, 256, nstripes * stripe_width,
                                dtype=np.uint8).tobytes()
            objs[f"obj{i}"] = data
            out["results"].append(_write(cl, primary, f"obj{i}", data,
                                         (1, i + 1)))
        # unaligned append: past the end of obj1, ending mid-stripe
        tail = rng.integers(0, 256, stripe_width // 2 + 37,
                            dtype=np.uint8).tobytes()
        out["results"].append(_write(cl, primary, "obj1", tail, (1, 4),
                                     offset=len(objs["obj1"])))
        objs["obj1"] += tail
        # column overwrite inside committed stripe 1 of obj0: two
        # columns at k=8 (the delta lane's 2/8), one at k=2
        cols = (2, 6) if k >= 8 else (1,)
        cl.flush()
        base = stripe_width
        obj0 = bytearray(objs["obj0"])
        for j, c in enumerate(cols):
            patch = rng.integers(0, 256, cs, dtype=np.uint8).tobytes()
            off = base + c * cs
            out["results"].append(_write(cl, primary, "obj0", patch,
                                         (1, 5 + j), offset=off))
            obj0[off:off + cs] = patch
        objs["obj0"] = bytes(obj0)
        cl.flush()
        out["delta_rmw_ops"] = primary.delta_rmw_ops
        out["delta_rmw_fallbacks"] = primary.delta_rmw_fallbacks
        out["reads"] = {oid: _read(cl, primary, oid, 0, len(d))
                        for oid, d in objs.items()}
        for oid, d in objs.items():
            assert out["reads"][oid] == (0, d), (pkg.name, oid)
        # degraded read: shards ERASED down
        down = {s for s in ERASED if s < n}
        cl.acting = [(s, None if s in down else s) for s in range(n)]
        out["degraded"] = {oid: _read(cl, primary, oid, 0, len(d))
                           for oid, d in objs.items()}
        for oid, d in objs.items():
            assert out["degraded"][oid] == (0, d), (pkg.name, oid)
        cl.acting = [(s, s) for s in range(n)]
        # recovery of one wiped shard, for every object
        lost = min(3, n - 1)
        coll = f"1.0s{lost}"
        GHO = pkg.objectstore.GHObject
        before = {oid: cl.hosts[lost].store.read(coll, GHO(oid, lost))
                  for oid in objs}
        for oid in objs:
            _remove(cl, lost, coll, GHO(oid, lost))
        out["recovery"] = [
            _recover(cl, primary, oid,
                     primary.get_object_info(oid).version,
                     [(lost, lost)]) for oid in sorted(objs)]
        for oid in objs:
            assert cl.hosts[lost].store.read(coll, GHO(oid, lost)) == \
                before[oid]
        cl.flush()
        # deep scrub with syndromes on every shard
        out["scrub"] = {s: cl.hosts[s].backend.build_scrub_map(deep=True)
                        for s in range(n)}
        out["scrub_counters"] = {
            s: (h.backend.scrub_windows, h.backend.scrub_device_windows,
                getattr(h.backend, "scrub_host_fallbacks", 0))
            for s, h in cl.hosts.items()}
        out["stores"] = snapshot(cl)
        out["logged"] = {s: list(h.logged) for s, h in cl.hosts.items()}
        out["coding_matrix"] = ec_matrix(cl)
    finally:
        cl.shutdown()
    return out


def ec_matrix(cl):
    core = cl.hosts[0].backend.ec_impl.core
    return np.asarray(core.coding_matrix, dtype=np.int64)


def snapshot(cl):
    """Every object of every store: bytes, xattrs and omap."""
    snap = {}
    for osd, host in cl.hosts.items():
        st = host.store
        for coll in st.list_collections():
            for obj in st.collection_list(coll):
                snap[(osd, coll, obj.oid, obj.shard)] = (
                    bytes(st.read(coll, obj)),
                    {k: bytes(v) for k, v in st.getattrs(coll, obj).items()},
                    {k: bytes(v) for k, v in st.omap_get(coll, obj).items()})
    return snap


@pytest.fixture(scope="module")
def ref_pkg():
    return Pkg("ref")


@pytest.mark.parametrize("with_batcher", [False, True],
                         ids=["inline", "batcher"])
@pytest.mark.parametrize("k,m,stripe_width", [(8, 4, 32768), (2, 1, 256)],
                         ids=["k8m4", "k2m1"])
def test_sequence_matches_jax_package(ref_pkg, k, m, stripe_width,
                                      with_batcher):
    seed = 7000 + k * 10 + m
    port = run_sequence(PORT, k, m, stripe_width, with_batcher, seed)
    ref = run_sequence(ref_pkg, k, m, stripe_width, with_batcher, seed)
    assert port["results"] == ref["results"]
    assert all(r == 0 for r in port["results"])
    assert port["reads"] == ref["reads"]
    assert port["degraded"] == ref["degraded"]
    assert port["recovery"] == ref["recovery"] == [0, 0, 0]
    assert port["delta_rmw_ops"] == ref["delta_rmw_ops"]
    if with_batcher:
        assert port["delta_rmw_ops"] == len((2, 6) if k >= 8 else (1,))
    assert port["delta_rmw_fallbacks"] == ref["delta_rmw_fallbacks"] == 0
    assert port["stores"].keys() == ref["stores"].keys()
    for key, val in port["stores"].items():
        assert val == ref["stores"][key], key
    assert port["logged"] == ref["logged"]
    assert port["scrub"] == ref["scrub"]
    assert port["scrub_counters"] == {
        s: (w, d, 0) for s, (w, d, _f) in ref["scrub_counters"].items()}

    # the port's log entries and hinfo read back in the JAX package
    for entries in port["logged"].values():
        for e in entries:
            assert ref_pkg.pglog.LogEntry.from_dict(e).to_dict() == e
    hkey = ref_pkg.ecutil.HINFO_KEY
    for (osd, coll, oid, shard), (data, attrs, _o) in \
            port["stores"].items():
        if hkey in attrs:
            h = ref_pkg.ecutil.HashInfo.decode(attrs[hkey])
            if h.total_chunk_size == len(data) and h.crcs:
                assert h.crcs[shard] == ref_pkg.crc.crc32c(data)

    # scrub: data CRCs are crc32c, syndrome partials cancel per object
    n = k + m
    for s, smap in port["scrub"].items():
        for oid, e in smap.items():
            data = port["stores"][(s, f"1.0s{s}", oid, s)][0]
            assert e["data_crc"] == PORT.crc.crc32c(data)
    for oid in port["scrub"][0]:
        syn = np.zeros(m, dtype=np.uint64)
        for s in range(n):
            syn ^= np.asarray(port["scrub"][s][oid]["syndrome_partials"],
                              dtype=np.uint64)
        assert not syn.any(), oid


# ------------------------- the layered and coupled-layer codes, both packages
# (pool profile, stripe unit, stripes of each object, shard sets down for
# the degraded reads, the shard lost and recovered); the device code is
# the gpu plugin here (device=cpu) and the tpu plugin in the JAX package
CODEC_POOLS = {
    "lrc": ({"plugin": "lrc", "k": "4", "m": "2", "l": "3",
             "inner": "gpu"}, 4096, (4, 3, 1), [(1,), (2, 5)], 2),
    "clay": ({"plugin": "clay", "k": "4", "m": "2", "scalar_mds": "gpu"},
             4096, (1, 1, 1), [(1,), (0, 5)], 3),
}


def pool_codec(pkg, profile):
    prof = dict(profile)
    for key in ("inner", "scalar_mds"):
        if prof.get(key) == "gpu":
            if pkg.name == "port":
                prof["device"] = "cpu"
            else:
                prof[key] = "tpu"
    return pkg.registry.instance().factory(prof["plugin"], prof)


def run_pool_sequence(pkg, pool, seed):
    """Writes, reads, degraded reads, one shard's recovery and a deep
    scrub of an LRC or CLAY pool; returns what the packages must agree
    on."""
    profile, su, stripes, downs, lost = CODEC_POOLS[pool]
    codec = pool_codec(pkg, profile)
    n, k = codec.get_chunk_count(), codec.get_data_chunk_count()
    sw = su * k
    assert codec.get_chunk_size(sw) == su
    cl = FakeCluster(pkg, n, profile=profile,
                     conf={"osd_deep_scrub_syndrome": True}, wire=True,
                     lock=True)
    for host in cl.hosts.values():
        host.backend = pkg.ecbackend.ECBackend(host, codec, stripe_width=sw)
    primary = cl.hosts[0].backend
    rng = np.random.default_rng(seed)
    out = {"objs": {}, "results": []}
    try:
        for i, nst in enumerate(stripes):
            data = rng.integers(0, 256, nst * sw, dtype=np.uint8).tobytes()
            out["objs"][f"obj{i}"] = data
            out["results"].append(_write(cl, primary, f"obj{i}", data,
                                         (1, i + 1)))
        cl.flush()
        objs = out["objs"]
        out["written"] = snapshot(cl)
        out["reads"] = {o: _read(cl, primary, o, 0, len(d))
                        for o, d in objs.items()}
        out["degraded"] = {}
        for down in downs:
            cl.acting = [(s, None if s in down else s) for s in range(n)]
            out["degraded"][down] = {o: _read(cl, primary, o, 0, len(d))
                                     for o, d in objs.items()}
        cl.acting = [(s, s) for s in range(n)]
        coll = f"1.0s{lost}"
        GHO = pkg.objectstore.GHObject
        out["before"] = {o: cl.hosts[lost].store.read(coll, GHO(o, lost))
                         for o in objs}
        for o in objs:
            _remove(cl, lost, coll, GHO(o, lost))
        read0 = primary.read_bytes_total
        out["recovery"] = [
            _recover(cl, primary, o, primary.get_object_info(o).version,
                     [(lost, lost)]) for o in sorted(objs)]
        out["recovery_read"] = primary.read_bytes_total - read0
        out["repairs"] = (primary.subchunk_repairs,
                          primary.repair_read_bytes,
                          primary.repair_whole_bytes)
        out["after"] = {o: cl.hosts[lost].store.read(coll, GHO(o, lost))
                        for o in objs}
        cl.flush()
        out["scrub"] = {s: cl.hosts[s].backend.build_scrub_map(deep=True)
                        for s in range(n)}
        out["stores"] = snapshot(cl)
        out["logged"] = {s: list(h.logged) for s, h in cl.hosts.items()}
    finally:
        cl.shutdown()
    return out


@pytest.mark.parametrize("pool", sorted(CODEC_POOLS))
def test_layered_and_coupled_pools_match_jax_package(ref_pkg, pool):
    """An LRC pool (k=4 m=2 l=3, 8 shards) and a CLAY pool (k=4 m=2
    d=5, 6 shards) through both packages' ECBackend.  Writes, shards,
    hinfo, log entries and reads must be equal; every degraded read
    returns the bytes written, every recovered shard the shard it
    replaces.  CLAY's objects are one stripe each, and there the
    degraded reads, the recovery and the scrub maps are equal too.
    The JAX package's ECBackend gives other bytes for LRC's degraded
    reads and recoveries and for CLAY's recovery of objects of many
    stripes (ROADMAP faults C4 and C5), so those are held to the bytes
    written alone."""
    _profile, _su, stripes, _downs, lost = CODEC_POOLS[pool]
    seed = 7100 + len(pool)
    port = run_pool_sequence(PORT, pool, seed)
    ref = run_pool_sequence(ref_pkg, pool, seed)
    objs = port["objs"]
    assert port["results"] == ref["results"] == [0] * len(objs)
    assert port["written"] == ref["written"]
    assert port["logged"] == ref["logged"]
    assert port["reads"] == ref["reads"] == \
        {o: (0, d) for o, d in objs.items()}
    for down, reads in port["degraded"].items():
        assert reads == {o: (0, d) for o, d in objs.items()}, down
    assert port["recovery"] == [0] * len(objs)
    assert port["after"] == port["before"] == ref["before"]
    assert port["stores"] == port["written"]
    hkey = ref_pkg.ecutil.HINFO_KEY
    for (osd, coll, oid, shard), (data, attrs, _o) in \
            port["stores"].items():
        h = ref_pkg.ecutil.HashInfo.decode(attrs[hkey])
        assert h.crcs[shard] == ref_pkg.crc.crc32c(data)
        assert port["scrub"][shard][oid]["data_crc"] == \
            PORT.crc.crc32c(data)
    shard_bytes = sum(len(b) for b in port["before"].values())
    if pool == "lrc":
        # a chunk of a local group is rebuilt from the l = 3 others of
        # its group, not from k = 4
        assert port["recovery_read"] == 3 * shard_bytes
        assert port["repairs"] == (0, 0, 0)
    else:
        assert port["degraded"] == ref["degraded"]
        assert port["recovery"] == ref["recovery"]
        assert port["after"] == ref["after"]
        assert port["stores"] == ref["stores"]
        assert port["scrub"] == ref["scrub"]
        assert port["repairs"] == ref["repairs"]
        repairs, took, whole = port["repairs"]
        assert repairs == len(objs) and took < 0.8 * whole


def test_clay_repair_of_objects_of_many_stripes():
    """CLAY's sub-chunk repair of a shard of many stripes repairs each
    stripe's chunk from that stripe's repair sub-chunks (ROADMAP fault
    C5: the JAX package repairs the whole shard as one chunk and writes
    other bytes)."""
    profile = {"plugin": "clay", "k": "4", "m": "2", "scalar_mds": "gpu"}
    codec = pool_codec(PORT, profile)
    n, sw = 6, 4 * 4096
    cl = FakeCluster(PORT, n, profile=profile, wire=True, lock=True)
    try:
        for host in cl.hosts.values():
            host.backend = PORT.ecbackend.ECBackend(host, codec,
                                                    stripe_width=sw)
        primary = cl.hosts[0].backend
        data = np.random.default_rng(72).integers(
            0, 256, 5 * sw - 100, dtype=np.uint8).tobytes()
        assert _write(cl, primary, "c", data, (1, 1)) == 0
        cl.flush()
        version = primary.get_object_info("c").version
        for lost in range(1, n):
            coll = f"1.0s{lost}"
            before = cl.hosts[lost].store.read(coll, GH("c", lost))
            _remove(cl, lost, coll, GH("c", lost))
            assert _recover(cl, primary, "c", version,
                            [(lost, lost)]) == 0
            assert cl.hosts[lost].store.read(coll, GH("c", lost)) == \
                before, lost
        assert primary.subchunk_repairs == n - 1
        assert primary.repair_read_bytes < 0.8 * primary.repair_whole_bytes
        cl.acting = [(s, None if s in (1, 4) else s) for s in range(n)]
        assert _read(cl, primary, "c", 0, len(data)) == (0, data)
    finally:
        cl.shutdown()


# ------------------------------------------------ counted host routes
def small_cluster(conf=None, batcher=None):
    cl = FakeCluster(PORT, 3, profile={"k": "2", "m": "1"}, conf=conf,
                     batcher=batcher, lock=True)
    ec_impl = PORT.codec(technique="reed_sol_van", k=2, m=1)
    for host in cl.hosts.values():
        host.backend = PORT.ecbackend.ECBackend(host, ec_impl,
                                                stripe_width=256)
    return cl, ec_impl


def test_scrub_window_fault_is_counted_and_host_crcs_stand():
    cl, ec_impl = small_cluster(conf={"osd_deep_scrub_syndrome": True})
    try:
        primary = cl.hosts[0].backend
        data = bytes(range(256)) * 3
        assert _write(cl, primary, "s", data, (1, 1)) == 0
        cl.flush()
        backend = ec_impl.core.backend

        def broken(*a, **kw):
            raise RuntimeError("device apply failed")
        backend.apply_bitmatrix_bytes = broken
        try:
            smap = primary.build_scrub_map(deep=True)
        finally:
            del backend.apply_bitmatrix_bytes
        stored = cl.hosts[0].store.read("1.0s0", GH("s", 0))
        assert smap["s"]["data_crc"] == PORT.crc.crc32c(stored)
        assert smap["s"]["hinfo_ok"] is True
        assert primary.scrub_host_fallbacks == 1
        assert primary.scrub_device_windows == 0
        assert "device apply failed" in str(primary.scrub_last_error)
        # the same window with a working apply: no fallback counted
        smap2 = primary.build_scrub_map(deep=True)
        assert smap2["s"]["data_crc"] == smap["s"]["data_crc"]
        assert primary.scrub_host_fallbacks == 1
        assert primary.scrub_device_windows == 1
    finally:
        cl.shutdown()


def test_scrub_host_routing_without_syndromes_is_not_a_fallback():
    """On the CPU with syndromes off the host loop is the route, not a
    fallback: nothing is counted against the card."""
    cl, _ = small_cluster()
    try:
        primary = cl.hosts[0].backend
        assert _write(cl, primary, "s", b"q" * 512, (1, 1)) == 0
        cl.flush()
        smap = primary.build_scrub_map(deep=True)
        assert smap["s"]["hinfo_ok"] is True
        assert (primary.scrub_windows, primary.scrub_device_windows,
                primary.scrub_host_fallbacks) == (1, 0, 0)
    finally:
        cl.shutdown()


class _TwinBatcher:
    """A batcher without a decode lane whose crossover always picks
    the CPU twin: degraded reads take ``_decode_impl``."""

    def __init__(self, twin):
        self.twin = twin

    def route_decode(self, nbytes):
        return True

    def cpu_twin(self, ec_impl, sinfo):
        return self.twin

    def prewarm(self, ec_impl, sinfo):
        return None

    def submit(self, ec_impl, sinfo, data, cb, tracked=None):
        cb(PORT.ecutil.encode(sinfo, ec_impl, data))

    def stop(self):
        pass


def test_decode_twin_route_is_counted():
    twin = PORT.registry.instance().factory(
        "jerasure", {"k": "2", "m": "1", "technique": "reed_sol_van"})
    cl, ec_impl = small_cluster(batcher=_TwinBatcher(twin))
    try:
        primary = cl.hosts[0].backend
        # hide the decode lane: the read takes _decode_impl
        primary.ec_impl = _NoBatchDecode(ec_impl)
        data = bytes(range(256)) * 2
        assert _write(cl, primary, "t", data, (1, 1)) == 0
        cl.flush()
        cl.acting = [(0, 0), (1, None), (2, 2)]
        assert _read(cl, primary, "t", 0, len(data)) == (0, data)
        assert primary.twin_routes == 1 and primary.device_errors == 0
    finally:
        cl.shutdown()


class _NoBatchDecode:
    """The codec with its batched decode hidden; everything else is the
    codec's own.  ``fail`` makes its decode raise."""

    def __init__(self, base, fail=False):
        self._base = base
        self._fail = fail

    def __getattr__(self, name):
        if name == "decode_batch":
            raise AttributeError(name)
        return getattr(self._base, name)

    def decode(self, *a, **kw):
        if self._fail:
            raise RuntimeError("device decode failed")
        return self._base.decode(*a, **kw)


def test_decode_device_error_is_counted():
    cl, ec_impl = small_cluster()
    try:
        primary = cl.hosts[0].backend
        data = bytes(range(256)) * 2
        assert _write(cl, primary, "e", data, (1, 1)) == 0
        cl.flush()
        primary.ec_impl = _NoBatchDecode(ec_impl, fail=True)
        cl.acting = [(0, 0), (1, None), (2, 2)]
        assert _read(cl, primary, "e", 0, len(data)) == (-5, b"")
        assert primary.device_errors == 1
        assert "device decode failed" in str(primary.last_device_error)
        assert primary.twin_routes == 0
    finally:
        cl.shutdown()


# ----------------------------------------- packet codes keep their route
def test_packet_code_writes_match_jerasure_through_the_batcher():
    """A cauchy_good pool's writes go through the batcher to the port's
    encode_batch_async (B2/B3 on the card, their plain versions here),
    never the byte-domain apply: every shard equals jerasure's encode."""
    k, m, ps = 4, 2, 128
    B = PORT.batcher.EncodeBatcher
    B.reset_learning()
    batcher = B({"ec_tpu_batch_stripes": 64, "ec_tpu_queue_window_us": 500,
                 "osd_ec_prewarm": False, "ec_tpu_fallback_cpu": False})
    cl = FakeCluster(PORT, k + m, profile={}, batcher=batcher, wire=True,
                     lock=True)
    prof = {"technique": "cauchy_good", "k": str(k), "m": str(m),
            "packetsize": str(ps)}
    codec = PORT.registry.instance().factory("gpu",
                                             dict(prof, device="cpu"))
    ref = PORT.registry.instance().factory("jerasure", prof)
    sw = k * 8 * ps * 4     # the plugin's alignment: 4 super-words a chunk
    try:
        for host in cl.hosts.values():
            host.backend = PORT.ecbackend.ECBackend(host, codec,
                                                    stripe_width=sw)
        primary = cl.hosts[0].backend
        data = np.random.default_rng(5).integers(
            0, 256, 3 * sw, dtype=np.uint8).tobytes()
        calls = batcher.calls
        assert _write(cl, primary, "p", data, (1, 1)) == 0
        cl.flush()
        assert batcher.calls == calls + 1 and batcher.cpu_reqs == 0
        want = PORT.ecutil.encode(PORT.ecutil.StripeInfo(k, sw), ref, data)
        for s in range(k + m):
            got = cl.hosts[s].store.read(f"1.0s{s}", GH("p", s))
            assert got == bytes(want[s]), s
        assert _read(cl, primary, "p", 0, len(data)) == (0, data)
    finally:
        cl.shutdown()
