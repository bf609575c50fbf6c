"""The port's store stack on the CPU (ceph_tpu_torch.store and the
utils and compressor registry under it).

Twins, with the port's classes, of tests/test_store.py (the 4-store
suite), tests/test_bluestore.py, the store tests of
tests/test_store_waterfall.py (the cluster and trace-export tests wait
for the port's cluster) and the registry tests of
tests/test_compressor.py (the messenger tests wait for the port's msg/).
Then the slice held against the JAX package: one seeded transaction
sequence through both packages' BlueStore gives equal bytes, per-block
CRCs, xattrs, omap and allocator and compression counters; and the
port's checksum fold through crclinear on a CPU TorchBackend whose
device gate is forced open gives the host loop's CRCs.
"""
import os
import threading

import numpy as np
import pytest

import ceph_tpu.store as ref_store
import ceph_tpu_torch.store as port_store
from ceph_tpu.store.blockstore import _Extents as RefExtents
from ceph_tpu_torch.compressor import registry
from ceph_tpu_torch.ops import crclinear
from ceph_tpu_torch.ops.torch_engine import TorchBackend
from ceph_tpu_torch.store import (BlockStore, BlueStore, FileStore,
                                  GHObject, LogDB, MemStore, Transaction,
                                  WriteBatch)
from ceph_tpu_torch.store.blockstore import BLOCK, _Extents
from ceph_tpu_torch.utils.config import Config
from ceph_tpu_torch.utils.crc import crc32c
from ceph_tpu_torch.utils.store_ledger import (PHASE_ORDER,
                                               StoreLedgerAccum, charge,
                                               merge_dumps, op_family,
                                               store_waterfall_block)

C = "1.0s0"
C2 = "2.0s0"
SEED = 20261017


# ====================== the slice against the JAX package's BlueStore

class ForcedGate:
    """A CPU TorchBackend that passes BlueStore's device gate, so the
    checksum fold goes through crclinear and B1's plain version."""
    is_cuda = True

    def __init__(self):
        self.base = TorchBackend("cpu")
        self.calls = 0

    def apply_bitmatrix_bytes(self, B, data, w):
        self.calls += 1
        return self.base.apply_bitmatrix_bytes(B, data, w)


def txn_plan(seed):
    """A seeded sequence of transactions as plain tuples: writes at
    offsets, overwrites, zero, truncate, clone, rename, xattrs, omap,
    and runs of whole compressible blocks (zlib segments)."""
    rng = np.random.default_rng(seed)

    def data(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    plan = [[("mkcoll", C)], [("mkcoll", C2)]]
    names = [f"obj{i}" for i in range(5)]
    for rnd in range(4):
        for name in names:
            off = int(rng.integers(0, 3 * BLOCK))
            plan.append([("write", C, name, off,
                          data(int(rng.integers(1, 5 * BLOCK))))])
        # an overwrite inside an object and one across its end
        plan.append([("write", C, "obj0", int(rng.integers(0, BLOCK)),
                      data(int(rng.integers(1, 2 * BLOCK)))),
                     ("write", C, "obj1", int(rng.integers(2, 6) * BLOCK),
                      data(BLOCK))])
        # whole compressible blocks: a zlib segment, then a write into it
        pattern = data(64) * (BLOCK // 64)
        plan.append([("write", C, "obj4", 0,
                      pattern * int(rng.integers(4, 9)))])
        plan.append([("write", C, "obj4", BLOCK + 100, data(300))])
        plan.append([("zero", C, "obj1", int(rng.integers(0, BLOCK)),
                      int(rng.integers(1, 2 * BLOCK)))])
        plan.append([("truncate", C, "obj2",
                      int(rng.integers(0, 4 * BLOCK)))])
        plan.append([("clone", C, "obj0", f"clone{rnd}")])
        plan.append([("rename", C, "obj3", C2, f"moved{rnd}"),
                     ("write", C, "obj3", 0, data(BLOCK + 7))])
        plan.append([("setattr", C, "obj0", f"a{rnd}", data(20)),
                     ("setattr", C, f"clone{rnd}", "_", data(5)),
                     ("omap", C, "obj1", {f"k{rnd}.{j}": data(12)
                                          for j in range(3)})])
        if rnd:
            plan.append([("rmattr", C, "obj0", f"a{rnd - 1}"),
                         ("omap_rm", C, "obj1", [f"k{rnd - 1}.1"])])
    return plan


def run_plan(mod, store, plan):
    G, T = mod.GHObject, mod.Transaction
    for ops in plan:
        t = T()
        for op in ops:
            kind, args = op[0], op[1:]
            if kind == "mkcoll":
                t.create_collection(args[0])
            elif kind == "write":
                t.write(args[0], G(args[1], 0), args[2], args[3])
            elif kind == "zero":
                t.zero(args[0], G(args[1], 0), args[2], args[3])
            elif kind == "truncate":
                t.truncate(args[0], G(args[1], 0), args[2])
            elif kind == "clone":
                t.clone(args[0], G(args[1], 0), G(args[2], 0))
            elif kind == "rename":
                t.collection_move_rename(args[0], G(args[1], 0), args[2],
                                         G(args[3], 0))
            elif kind == "setattr":
                t.setattr(args[0], G(args[1], 0), args[2], args[3])
            elif kind == "rmattr":
                t.rmattr(args[0], G(args[1], 0), args[2])
            elif kind == "omap":
                t.omap_setkeys(args[0], G(args[1], 0), args[2])
            else:
                t.omap_rmkeys(args[0], G(args[1], 0), args[2])
        store.queue_transactions([t])
    store.flush()


def snapshot(store, extents_cls):
    """Everything a client can read back, plus the per-block CRCs and
    the allocator and compression counters."""
    objs = {}
    for coll in sorted(store.list_collections()):
        for o in store.collection_list(coll):
            key = (coll, o.oid, o.shard)
            objs[key] = (store.read(coll, o), store.getattrs(coll, o),
                         store.omap_get(coll, o))
    crcs = {k: (extents_cls.load(raw).size, extents_cls.load(raw).crcs)
            for k, raw in store._db.iterate("X/")}
    use = store.usage()
    counters = {k: use[k] for k in ("blocks_used", "compress_logical_bytes",
                                    "compress_stored_bytes")}
    return objs, crcs, counters


@pytest.mark.parametrize("route", ["host", "crclinear"])
def test_bluestore_matches_jax_package(route):
    plan = txn_plan(SEED)
    ref = ref_store.BlueStore(compression="zlib")
    port = port_store.BlueStore(compression="zlib")
    gate = ForcedGate()
    if route == "crclinear":
        port.attach_device_batcher(lambda: gate)
    fallbacks = crclinear.shared().host_fallbacks
    snaps = []
    for mod, store, ext in ((ref_store, ref, RefExtents),
                            (port_store, port, _Extents)):
        store.mkfs()
        store.mount()
        try:
            run_plan(mod, store, plan)
            snaps.append(snapshot(store, ext))
            if store is port:
                csum = store.usage()["csum"]
        finally:
            store.umount()
    (ref_objs, ref_crcs, ref_cnt), (objs, crcs, cnt) = snaps
    assert set(objs) == set(ref_objs) and len(objs) >= 10
    for key, want in ref_objs.items():
        assert objs[key] == want, key
    assert crcs == ref_crcs
    assert any(any(c) for _, c in crcs.values())
    assert cnt == ref_cnt and cnt["compress_stored_bytes"] > 0
    assert csum["device_errors"] == 0
    if route == "crclinear":
        assert csum["device_batches"] > 0 and gate.calls > 0
        assert crclinear.shared().host_fallbacks == fallbacks
    else:
        assert csum["device_batches"] == 0 and gate.calls == 0


def test_crc_batch_forced_gate_matches_host_loop():
    rng = np.random.default_rng(SEED + 1)
    blocks = [rng.integers(0, 256, BLOCK, dtype=np.uint8).tobytes()
              for _ in range(37)]
    blocks.append(bytes(BLOCK))
    store = BlueStore()
    gate = ForcedGate()
    store.attach_device_batcher(lambda: gate)
    got = store._crc_batch(blocks)
    assert got == [crc32c(b) for b in blocks]
    assert gate.calls == 1
    assert (store.csum_device_batches, store.csum_device_errors) == (1, 0)
    # one block, or a backend on no card, takes the host loop
    assert store._crc_batch(blocks[:1]) == [crc32c(blocks[0])]
    store.attach_device_batcher(lambda: TorchBackend("cpu"))
    assert store._crc_batch(blocks[:3]) == [crc32c(b) for b in blocks[:3]]
    assert gate.calls == 1 and store.csum_device_batches == 1


def test_crc_batch_counts_a_failed_device_pass():
    class Broken(ForcedGate):
        def apply_bitmatrix_bytes(self, B, data, w):
            raise RuntimeError("injected device fault")

    store = BlueStore()
    store.mkfs()
    store.mount()
    store.attach_device_batcher(lambda: Broken())
    fallbacks = crclinear.shared().host_fallbacks
    blocks = [bytes([i]) * BLOCK for i in range(4)]
    # crclinear serves the window from the host and counts it
    assert store._crc_batch(blocks) == [crc32c(b) for b in blocks]
    assert crclinear.shared().host_fallbacks == fallbacks + 1
    assert isinstance(crclinear.shared().last_error, RuntimeError)
    # a pass that raises past crclinear is the store's own fallback
    store.attach_device_batcher(lambda: 1 / 0)
    assert store._crc_batch(blocks) == [crc32c(b) for b in blocks]
    assert store.csum_device_errors == 1
    assert isinstance(store.csum_last_error, ZeroDivisionError)
    assert store.usage()["csum"]["device_errors"] == 1
    store.umount()


# ===================================== twins of tests/test_store.py
@pytest.fixture(params=["mem", "file", "block", "bluestore"])
def store(request, tmp_path):
    if request.param == "mem":
        s = MemStore()
    elif request.param == "block":
        s = BlockStore(str(tmp_path / "store"))
    elif request.param == "bluestore":
        s = BlueStore(str(tmp_path / "store"))
    else:
        s = FileStore(str(tmp_path / "store"))
    s.mkfs()
    s.mount()
    t = Transaction().create_collection(C)
    s.queue_transactions([t])
    yield s
    s.umount()


def obj(name="foo", shard=0):
    return GHObject(name, shard)


def test_write_read_roundtrip(store):
    t = Transaction().write(C, obj(), 0, b"hello world")
    store.queue_transactions([t])
    assert store.read(C, obj()) == b"hello world"
    assert store.read(C, obj(), 6, 5) == b"world"
    assert store.stat(C, obj()).size == 11


def test_write_at_offset_pads_with_zeros(store):
    store.queue_transactions([Transaction().write(C, obj(), 4, b"data")])
    assert store.read(C, obj()) == b"\x00\x00\x00\x00data"


def test_overwrite_extends(store):
    store.queue_transactions([Transaction().write(C, obj(), 0, b"aaaa")])
    store.queue_transactions([Transaction().write(C, obj(), 2, b"bbbb")])
    assert store.read(C, obj()) == b"aabbbb"


def test_zero_and_truncate(store):
    store.queue_transactions([Transaction().write(C, obj(), 0, b"x" * 8)])
    store.queue_transactions([Transaction().zero(C, obj(), 2, 3)])
    assert store.read(C, obj()) == b"xx\x00\x00\x00xxx"
    store.queue_transactions([Transaction().truncate(C, obj(), 4)])
    assert store.read(C, obj()) == b"xx\x00\x00"
    store.queue_transactions([Transaction().truncate(C, obj(), 6)])
    assert store.read(C, obj()) == b"xx\x00\x00\x00\x00"


def test_touch_remove_exists(store):
    assert not store.exists(C, obj())
    store.queue_transactions([Transaction().touch(C, obj())])
    assert store.exists(C, obj())
    assert store.stat(C, obj()).size == 0
    store.queue_transactions([Transaction().remove(C, obj())])
    assert not store.exists(C, obj())
    with pytest.raises(FileNotFoundError):
        store.read(C, obj())


def test_missing_object_raises(store):
    with pytest.raises(FileNotFoundError):
        store.read(C, obj("nope"))
    with pytest.raises(FileNotFoundError):
        store.stat(C, obj("nope"))


def test_missing_collection_raises(store):
    with pytest.raises(FileNotFoundError):
        store.read("9.9s9", obj())


def test_xattrs(store):
    t = Transaction().setattrs(C, obj(), {"hinfo": b"\x01\x02", "v": b"3"})
    store.queue_transactions([t])
    assert store.getattr(C, obj(), "hinfo") == b"\x01\x02"
    assert store.getattrs(C, obj()) == {"hinfo": b"\x01\x02", "v": b"3"}
    store.queue_transactions([Transaction().rmattr(C, obj(), "v")])
    assert store.getattrs(C, obj()) == {"hinfo": b"\x01\x02"}
    with pytest.raises(KeyError):
        store.getattr(C, obj(), "v")


def test_omap(store):
    t = Transaction().omap_setkeys(
        C, obj(), {"k1": b"v1", "k2": b"v2", "k3": b"v3"})
    t.omap_setheader(C, obj(), b"HDR")
    store.queue_transactions([t])
    assert store.omap_get(C, obj()) == {
        "k1": b"v1", "k2": b"v2", "k3": b"v3"}
    assert store.omap_get_header(C, obj()) == b"HDR"
    assert store.omap_get_keys(C, obj()) == ["k1", "k2", "k3"]
    assert store.omap_get_keys(C, obj(), start_after="k1") == ["k2", "k3"]
    assert store.omap_get_keys(C, obj(), max_return=2) == ["k1", "k2"]
    store.queue_transactions([Transaction().omap_rmkeys(C, obj(), ["k2"])])
    assert store.omap_get(C, obj()) == {"k1": b"v1", "k3": b"v3"}
    store.queue_transactions([Transaction().omap_clear(C, obj())])
    assert store.omap_get(C, obj()) == {}
    assert store.omap_get_header(C, obj()) == b"HDR"


def test_clone_is_deep(store):
    t = Transaction().write(C, obj(), 0, b"original")
    t.setattr(C, obj(), "a", b"1")
    t.omap_setkeys(C, obj(), {"k": b"v"})
    store.queue_transactions([t])
    dst = obj("foo-clone")
    store.queue_transactions([Transaction().clone(C, obj(), dst)])
    assert store.read(C, dst) == b"original"
    assert store.getattrs(C, dst) == {"a": b"1"}
    assert store.omap_get(C, dst) == {"k": b"v"}
    store.queue_transactions([Transaction().write(C, dst, 0, b"CLONED!!")])
    assert store.read(C, obj()) == b"original"


def test_coll_move_rename(store):
    C2 = "1.1s0"
    store.queue_transactions([Transaction().create_collection(C2)])
    t = Transaction().write(C, obj(), 0, b"payload")
    t.setattr(C, obj(), "a", b"1")
    t.omap_setkeys(C, obj(), {"k": b"v"})
    store.queue_transactions([t])
    dst = obj("foo", shard=1)
    store.queue_transactions(
        [Transaction().collection_move_rename(C, obj(), C2, dst)])
    assert not store.exists(C, obj())
    assert store.read(C2, dst) == b"payload"
    assert store.getattrs(C2, dst) == {"a": b"1"}
    assert store.omap_get(C2, dst) == {"k": b"v"}


def test_collections(store):
    assert store.collection_exists(C)
    assert C in store.list_collections()
    C2 = "2.0s-1"
    store.queue_transactions([Transaction().create_collection(C2)])
    store.queue_transactions([Transaction().touch(C2, obj("a"))])
    store.queue_transactions([Transaction().remove_collection(C2)])
    assert not store.collection_exists(C2)


def test_collection_list_sorted(store):
    t = Transaction()
    for name in ("zeta", "alpha", "mu"):
        t.touch(C, obj(name))
    store.queue_transactions([t])
    names = [o.oid for o in store.collection_list(C)]
    assert names == ["alpha", "mu", "zeta"]
    assert [o.oid for o in store.collection_list(C, start_after="alpha")] \
        == ["mu", "zeta"]
    assert len(store.collection_list(C, max_return=2)) == 2


def test_commit_callbacks(store):
    applied = threading.Event()
    committed = threading.Event()
    aggregate = threading.Event()
    t = Transaction().write(C, obj(), 0, b"x")
    t.register_on_applied(applied.set)
    t.register_on_commit(committed.set)
    store.queue_transactions([t], on_commit=aggregate.set)
    assert committed.wait(5)      # commit via finisher thread
    assert aggregate.wait(5)
    # synchronous backends deliver on_applied inline; deferred-apply
    # backends (BlueStore) deliver it from the applier — flush()
    # bounds both
    store.flush()
    assert applied.wait(5)


def test_transaction_atomic_ordering(store):
    # ops within one transaction apply in order (write then truncate)
    t = Transaction().write(C, obj(), 0, b"abcdef").truncate(C, obj(), 3)
    store.queue_transactions([t])
    assert store.read(C, obj()) == b"abc"


def test_transaction_encode_decode_roundtrip():
    t = Transaction()
    t.create_collection(C)
    t.touch(C, obj())
    t.write(C, obj(), 16, b"\xff" * 8)
    t.zero(C, obj(), 0, 4)
    t.truncate(C, obj(), 20)
    t.setattr(C, obj(), "hinfo_key", b"\x00\x01")
    t.rmattr(C, obj(), "old")
    t.omap_setkeys(C, obj(), {"pglog_1": b"entry"})
    t.omap_rmkeys(C, obj(), ["pglog_0"])
    t.omap_setheader(C, obj(), b"hdr")
    t.omap_clear(C, obj("other", 2))
    t.clone(C, obj(), obj("dup", 1))
    t.collection_move_rename(C, obj(), "1.1s1", obj("moved", 1))
    t.remove(C, obj("gone"))
    t.remove_collection("1.2s0")
    rt = Transaction.decode(t.encode())
    assert rt.ops == t.ops


def test_shard_qualified_objects_distinct(store):
    store.queue_transactions([Transaction().write(C, obj("x", 0), 0, b"s0")])
    store.queue_transactions([Transaction().write(C, obj("x", 1), 0, b"s1")])
    assert store.read(C, obj("x", 0)) == b"s0"
    assert store.read(C, obj("x", 1)) == b"s1"


def test_clone_sees_same_transaction_writes(store):
    """clone of an object created earlier in the same transaction."""
    t = Transaction()
    t.touch(C, obj("fresh"))
    t.write(C, obj("fresh"), 0, b"hello")
    t.setattr(C, obj("fresh"), "a", b"1")
    t.clone(C, obj("fresh"), obj("fresh-copy"))
    store.queue_transactions([t])
    assert store.read(C, obj("fresh-copy")) == b"hello"
    assert store.getattrs(C, obj("fresh-copy")) == {"a": b"1"}


def test_move_rename_into_collection_created_same_txn(store):
    t = Transaction()
    t.create_collection("7.0s0")
    t.touch(C, obj("mover"))
    t.collection_move_rename(C, obj("mover"), "7.0s0", obj("mover", 3))
    store.queue_transactions([t])
    assert store.exists("7.0s0", obj("mover", 3))
    assert not store.exists(C, obj("mover"))


def test_invalid_transaction_rejected_whole(store):
    """An invalid op anywhere rejects the transaction before any
    mutation (atomicity contract)."""
    t = Transaction()
    t.write(C, obj("partial"), 0, b"data")
    t.clone(C, obj("never-existed"), obj("dup"))
    with pytest.raises(FileNotFoundError):
        store.queue_transactions([t])
    assert not store.exists(C, obj("partial"))
    assert not store.exists(C, obj("dup"))


def test_invalid_txn_leaves_no_journal(tmp_path):
    path = str(tmp_path / "fs")
    s = FileStore(path)
    s.mkfs()
    s.mount()
    s.queue_transactions([Transaction().create_collection(C)])
    with pytest.raises(FileNotFoundError):
        s.queue_transactions(
            [Transaction().write("no.such.coll", obj(), 0, b"x")])
    assert list(s._db.get_prefix("J/")) == []
    # the store still works and a remount sees nothing of the failure
    s.queue_transactions([Transaction().write(C, obj(), 0, b"v2")])
    s.umount()
    s2 = FileStore(path)
    s2.mount()
    assert s2.read(C, obj()) == b"v2"
    s2.umount()


def test_non_ascii_keys_cleared(store):
    """omap_clear / remove must cover keys above U+007F."""
    t = Transaction().omap_setkeys(C, obj(), {"ékey": b"v", "日本": b"w"})
    t.setattr(C, obj(), "áttr", b"x")
    store.queue_transactions([t])
    assert store.omap_get(C, obj()) == {"ékey": b"v", "日本": b"w"}
    store.queue_transactions([Transaction().omap_clear(C, obj())])
    assert store.omap_get(C, obj()) == {}
    store.queue_transactions([Transaction().remove(C, obj())])
    store.queue_transactions([Transaction().touch(C, obj())])
    assert store.getattrs(C, obj()) == {}
    assert store.omap_get(C, obj()) == {}


def test_clone_and_move_replace_destination_wholesale(store):
    """An existing destination's metadata/data must not leak through
    clone or coll_move_rename."""
    t = Transaction()
    t.write(C, obj("dst"), 0, b"OLDDATA")
    t.setattr(C, obj("dst"), "stale", b"S")
    t.omap_setkeys(C, obj("dst"), {"stalek": b"sv"})
    t.omap_setheader(C, obj("dst"), b"OLDHDR")
    t.touch(C, obj("src"))             # data-less, metadata-less source
    store.queue_transactions([t])
    store.queue_transactions([Transaction().clone(C, obj("src"),
                                                  obj("dst"))])
    assert store.read(C, obj("dst")) == b""
    assert store.getattrs(C, obj("dst")) == {}
    assert store.omap_get(C, obj("dst")) == {}
    assert store.omap_get_header(C, obj("dst")) == b""

    t2 = Transaction()
    t2.write(C, obj("dst2"), 0, b"OLDDATA")
    t2.omap_setheader(C, obj("dst2"), b"OLDHDR")
    t2.touch(C, obj("src2"))
    store.queue_transactions([t2])
    store.queue_transactions([Transaction().collection_move_rename(
        C, obj("src2"), C, obj("dst2"))])
    assert store.read(C, obj("dst2")) == b""
    assert store.omap_get_header(C, obj("dst2")) == b""
    assert not store.exists(C, obj("src2"))


def test_logdb_empty_file_is_fresh_log(tmp_path):
    """Crash between creation and magic flush leaves a 0-byte log; it
    must open as empty, not fail forever."""
    path = str(tmp_path / "kv.log")
    open(path, "wb").close()
    db = LogDB(path)
    db.open()
    db.submit(WriteBatch().set("k", b"v"))
    db.close()
    db2 = LogDB(path)
    db2.open()
    assert db2.get("k") == b"v"
    db2.close()


# -- FileStore persistence ------------------------------------------------

def test_filestore_survives_remount(tmp_path):
    path = str(tmp_path / "fs")
    s = FileStore(path)
    s.mkfs()
    s.mount()
    t = Transaction().create_collection(C)
    t.write(C, obj(), 0, b"durable")
    t.setattr(C, obj(), "a", b"1")
    t.omap_setkeys(C, obj(), {"k": b"v"})
    s.queue_transactions([t])
    s.umount()

    s2 = FileStore(path)
    s2.mount()
    assert s2.read(C, obj()) == b"durable"
    assert s2.getattr(C, obj(), "a") == b"1"
    assert s2.omap_get(C, obj()) == {"k": b"v"}
    assert s2.list_collections() == [C]
    s2.umount()


def test_filestore_replays_pending_journal(tmp_path):
    """A journaled-but-unapplied transaction applies on mount (crash
    between WAL append and apply)."""
    path = str(tmp_path / "fs")
    s = FileStore(path)
    s.mkfs()
    s.mount()
    s.queue_transactions([Transaction().create_collection(C)])
    # simulate the crash: journal a txn directly without applying it
    t = Transaction().write(C, obj(), 0, b"replayed")
    s._db.submit(WriteBatch().set("J/0000000000000099", t.encode()),
                 sync=True)
    s.umount()

    s2 = FileStore(path)
    s2.mount()
    assert s2.read(C, obj()) == b"replayed"
    assert list(s2._db.get_prefix("J/")) == []   # journal drained
    s2.umount()


def test_filestore_mount_requires_mkfs(tmp_path):
    with pytest.raises(IOError):
        FileStore(str(tmp_path / "missing")).mount()


# -- LogDB ----------------------------------------------------------------

def test_logdb_replay(tmp_path):
    path = str(tmp_path / "kv.log")
    db = LogDB(path)
    db.open()
    db.submit(WriteBatch().set("a", b"1").set("b", b"2"))
    db.submit(WriteBatch().rm("a").set("c", b"3"))
    db.close()
    db2 = LogDB(path)
    db2.open()
    assert db2.get("a") is None
    assert db2.get("b") == b"2"
    assert db2.get("c") == b"3"
    db2.close()


def test_logdb_discards_torn_tail(tmp_path):
    path = str(tmp_path / "kv.log")
    db = LogDB(path)
    db.open()
    db.submit(WriteBatch().set("good", b"1"))
    db.close()
    with open(path, "ab") as fh:        # simulate a torn write
        fh.write(b"\xff\xff\xff\x7f partial record")
    db2 = LogDB(path)
    db2.open()
    assert db2.get("good") == b"1"
    db2.submit(WriteBatch().set("after", b"2"))
    db2.close()
    db3 = LogDB(path)
    db3.open()
    assert db3.get("after") == b"2"
    db3.close()


def test_logdb_compaction_preserves_data(tmp_path):
    path = str(tmp_path / "kv.log")
    db = LogDB(path, compact_factor=2)
    db.open()
    for i in range(200):                # churn one key to bloat the log
        db.submit(WriteBatch().set("hot", bytes(64)).set(f"k{i}", b"v"))
    size_after = os.path.getsize(path)
    live = sum(len(k) + 64 + 13 for k in ["hot"]) + 200 * 20
    assert size_after < live * 20       # compaction actually ran
    db.close()
    db2 = LogDB(path)
    db2.open()
    assert db2.get("hot") == bytes(64)
    assert all(db2.get(f"k{i}") == b"v" for i in range(200))
    db2.close()


def test_logdb_rm_range(tmp_path):
    db = LogDB(str(tmp_path / "kv.log"))
    db.open()
    db.submit(WriteBatch().set("p/a", b"1").set("p/b", b"2")
              .set("q/a", b"3"))
    db.submit(WriteBatch().rm_range("p/", "p/\x7f"))
    assert db.get_prefix("p/") == {}
    assert db.get("q/a") == b"3"
    db.close()


# -- BlockStore (reference os/bluestore) ----------------------------------


def test_blockstore_survives_remount(tmp_path):
    path = str(tmp_path / "bs")
    s = BlockStore(path)
    s.mkfs()
    s.mount()
    t = Transaction().create_collection(C)
    t.write(C, obj("p"), 0, b"block-data" * 1000)
    t.setattr(C, obj("p"), "a1", b"v1")
    t.omap_setkeys(C, obj("p"), {"k": b"v"})
    s.queue_transactions([t])
    s.umount()
    s2 = BlockStore(path)
    s2.mount()
    assert s2.read(C, obj("p")) == b"block-data" * 1000
    assert s2.getattr(C, obj("p"), "a1") == b"v1"
    assert s2.omap_get(C, obj("p"))["k"] == b"v"
    s2.umount()


def test_blockstore_cow_frees_blocks(tmp_path):
    """Overwrites COW into new blocks and release the old ones; delete
    returns everything (reference allocator accounting/statfs)."""
    s = BlockStore(str(tmp_path / "bs"))
    s.mkfs()
    s.mount()
    s.queue_transactions([Transaction().create_collection(C)])
    payload = bytes(range(256)) * 64          # 16 KiB = 4 blocks
    s.queue_transactions([Transaction().write(C, obj("o"), 0, payload)])
    used_after_write = s.usage()["blocks_used"]
    assert used_after_write >= 4
    # full overwrite: usage stays flat (old blocks freed)
    s.queue_transactions([Transaction().write(C, obj("o"), 0, payload)])
    assert s.usage()["blocks_used"] == used_after_write
    assert s.read(C, obj("o")) == payload
    # partial overwrite mid-block: RMW preserved
    s.queue_transactions([Transaction().write(C, obj("o"), 100,
                                              b"PATCH")])
    want = bytearray(payload)
    want[100:105] = b"PATCH"
    assert s.read(C, obj("o")) == bytes(want)
    assert s.usage()["blocks_used"] == used_after_write
    # delete releases all data blocks
    s.queue_transactions([Transaction().remove(C, obj("o"))])
    assert s.usage()["blocks_used"] == 0
    s.umount()


def test_blockstore_replays_pending_journal(tmp_path):
    """Crash between WAL and apply: the journaled txn applies on the
    next mount (reference deferred-write replay)."""
    path = str(tmp_path / "bs")
    s = BlockStore(path)
    s.mkfs()
    s.mount()
    s.queue_transactions([Transaction().create_collection(C)])
    t = Transaction().write(C, obj("j"), 0, b"journaled!")
    enc = t.encode()
    s._db.submit(WriteBatch().set("J/9999999999999999", enc),
                 sync=True)
    s.umount()                           # "crash" before apply
    s2 = BlockStore(path)
    s2.mount()                           # replay
    assert s2.read(C, obj("j")) == b"journaled!"
    assert list(s2._db.iterate("J/")) == []
    s2.umount()


def test_blockstore_sparse_and_truncate(tmp_path):
    s = BlockStore(str(tmp_path / "bs"))
    s.mkfs()
    s.mount()
    s.queue_transactions([Transaction().create_collection(C)])
    # sparse write far into the object: holes read as zeros
    s.queue_transactions([Transaction().write(C, obj("sp"), 20000,
                                              b"tail")])
    data = s.read(C, obj("sp"))
    assert data[:20000] == b"\x00" * 20000 and data[20000:] == b"tail"
    # truncate shrinks + frees whole blocks past the end
    used = s.usage()["blocks_used"]
    s.queue_transactions([Transaction().truncate(C, obj("sp"), 100)])
    assert s.stat(C, obj("sp")).size == 100
    assert s.usage()["blocks_used"] <= used
    s.umount()


def test_blockstore_grow_truncate_and_rmcoll(tmp_path):
    """Review regressions: grow-truncate must zero-pad like the other
    stores; removing a collection must purge objects AND free blocks
    (no resurrection on recreate)."""
    s = BlockStore(str(tmp_path / "bs"))
    s.mkfs()
    s.mount()
    s.queue_transactions([Transaction().create_collection(C)])
    s.queue_transactions([Transaction().write(C, obj("g"), 0, b"abc")])
    s.queue_transactions([Transaction().truncate(C, obj("g"), 10000)])
    data = s.read(C, obj("g"))
    assert len(data) == 10000
    assert data[:3] == b"abc" and data[3:] == b"\x00" * 9997
    # zero punches holes without allocating
    used0 = s.usage()["blocks_used"]
    s.queue_transactions([Transaction().zero(C, obj("g"), 0, 8192)])
    assert s.read(C, obj("g"))[:8192] == b"\x00" * 8192
    assert s.usage()["blocks_used"] <= used0
    # rmcoll purge + allocator reclaim
    s.queue_transactions([Transaction().remove_collection(C)])
    assert s.usage()["blocks_used"] == 0
    s.queue_transactions([Transaction().create_collection(C)])
    assert not s.exists(C, obj("g"))
    with pytest.raises(FileNotFoundError):
        s.read(C, obj("g"))
    s.umount()


def test_blockstore_csum_detects_bitrot(tmp_path):
    """Every read verifies the per-block CRC32C (reference BlueStore
    _verify_csum, BlueStore.cc:10425): flipping bits in the raw block
    device surfaces as EIO, not silent corruption (VERDICT r4 Next
    #9)."""
    path = str(tmp_path / "bs")
    s = BlockStore(path)
    s.mkfs()
    s.mount()
    s.queue_transactions([Transaction().create_collection(C)])
    payload = bytes(range(256)) * 64
    s.queue_transactions([Transaction().write(C, obj("rot"), 0,
                                              payload)])
    assert s.read(C, obj("rot")) == payload
    # find the object's first physical block and flip a byte under
    # the store's feet
    ext = s._load_extents(C, obj("rot"))
    phys = next(p for p in ext.blocks if p >= 0)
    with open(os.path.join(path, "block.dev"), "r+b") as f:
        f.seek(phys * 4096 + 17)
        b = f.read(1)
        f.seek(phys * 4096 + 17)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(OSError):
        s.read(C, obj("rot"))
    assert s.usage()["csum_failures"] >= 1
    s.umount()


def test_blockstore_compression_roundtrip(tmp_path):
    """Inline compression (reference bluestore_compression_algorithm):
    a large compressible write stores as a compressed segment (fewer
    blocks than logical), reads back bit-exact — including after a
    partial overwrite that re-materializes the segment — and the
    ratio shows in usage()."""
    s = BlockStore(str(tmp_path / "bs"), compression="zlib")
    s.mkfs()
    s.mount()
    s.queue_transactions([Transaction().create_collection(C)])
    payload = b"compress me! " * 5000          # 65 KB, compressible
    s.queue_transactions([Transaction().write(C, obj("z"), 0,
                                              payload)])
    u = s.usage()
    logical_blocks = (len(payload) + 4095) // 4096
    assert u["blocks_used"] < logical_blocks
    assert u["compress_stored_bytes"] < u["compress_logical_bytes"]
    assert s.read(C, obj("z")) == payload
    # partial overwrite inside the compressed span: the segment's
    # survivors re-home as raw blocks, content stays exact
    patch_at = 10000
    s.queue_transactions([Transaction().write(C, obj("z"), patch_at,
                                              b"PATCH")])
    want = bytearray(payload)
    want[patch_at:patch_at + 5] = b"PATCH"
    assert s.read(C, obj("z")) == bytes(want)
    # truncate into the (re-homed or remaining) span
    s.queue_transactions([Transaction().truncate(C, obj("z"), 9000)])
    assert s.read(C, obj("z")) == bytes(want)[:9000]
    # clone of a compressed object is deep and exact
    s.queue_transactions([Transaction().write(C, obj("z2"), 0,
                                              payload)])
    s.queue_transactions([Transaction().clone(C, obj("z2"),
                                              obj("z3"))])
    assert s.read(C, obj("z3")) == payload
    # remove releases the segment's physical blocks too
    for o in ("z", "z2", "z3"):
        s.queue_transactions([Transaction().remove(C, obj(o))])
    assert s.usage()["blocks_used"] == 0
    s.umount()


def test_blockstore_compressed_survives_remount_and_detects_rot(
        tmp_path):
    """Segments persist across remount (decompression follows the
    segment's recorded algorithm, not the mount option) and a
    corrupted compressed block still surfaces as EIO through the
    per-logical-block CRC."""
    path = str(tmp_path / "bs")
    s = BlockStore(path, compression="zlib")
    s.mkfs()
    s.mount()
    s.queue_transactions([Transaction().create_collection(C)])
    payload = b"persistent segment " * 4000
    s.queue_transactions([Transaction().write(C, obj("ps"), 0,
                                              payload)])
    s.umount()
    s2 = BlockStore(path)                      # compression OFF
    s2.mount()
    assert s2.read(C, obj("ps")) == payload
    ext = s2._load_extents(C, obj("ps"))
    assert ext.segs, "expected a compressed segment"
    phys = next(iter(ext.segs.values()))["phys"][0]
    with open(os.path.join(path, "block.dev"), "r+b") as f:
        f.seek(phys * 4096 + 5)
        b = f.read(1)
        f.seek(phys * 4096 + 5)
        f.write(bytes([b[0] ^ 0x55]))
    with pytest.raises(OSError):
        s2.read(C, obj("ps"))
    assert s2.usage()["csum_failures"] >= 1
    s2.umount()


def test_blockstore_overwrite_of_rotten_segment_succeeds(tmp_path):
    """A full overwrite needs none of the old bytes, so a CORRUPT
    compressed segment must not brick the write that would replace it
    (flatten skips decompression when every member is dropped);
    reads of the new data then verify clean."""
    path = str(tmp_path / "bs")
    s = BlockStore(path, compression="zlib")
    s.mkfs()
    s.mount()
    s.queue_transactions([Transaction().create_collection(C)])
    payload = b"rotting segment " * 4000
    s.queue_transactions([Transaction().write(C, obj("rw"), 0,
                                              payload)])
    ext = s._load_extents(C, obj("rw"))
    phys = next(iter(ext.segs.values()))["phys"][0]
    with open(os.path.join(path, "block.dev"), "r+b") as f:
        f.seek(phys * 4096 + 3)
        b = f.read(1)
        f.seek(phys * 4096 + 3)
        f.write(bytes([b[0] ^ 0x3C]))
    with pytest.raises(OSError):
        s.read(C, obj("rw"))
    # full-cover overwrite (writefull shape: new size >= old): every
    # old segment member is replaced, so no decompression is needed
    fresh = b"fresh bytes " * 6000
    assert len(fresh) >= len(payload)
    t = Transaction().write(C, obj("rw"), 0, fresh)
    t.truncate(C, obj("rw"), len(fresh))
    s.queue_transactions([t])            # must not raise
    assert s.read(C, obj("rw")) == fresh
    s.umount()


def test_blockstore_rmw_over_rot_raises_and_store_survives(tmp_path):
    """A partial overwrite whose RMW base block is rotten must fail
    with EIO — NOT merge over the garbage and stamp a fresh CRC
    (which would launder the corruption as valid data) — and the
    failed, already-journaled transaction must not poison the WAL:
    the store stays mountable and later writes work."""
    path = str(tmp_path / "bs")
    s = BlockStore(path)
    s.mkfs()
    s.mount()
    s.queue_transactions([Transaction().create_collection(C)])
    payload = bytes(range(256)) * 64
    s.queue_transactions([Transaction().write(C, obj("rm"), 0,
                                              payload)])
    ext = s._load_extents(C, obj("rm"))
    phys = ext.blocks[0]
    with open(os.path.join(path, "block.dev"), "r+b") as f:
        f.seek(phys * 4096 + 200)
        b = f.read(1)
        f.seek(phys * 4096 + 200)
        f.write(bytes([b[0] ^ 0x11]))
    with pytest.raises(OSError):
        s.queue_transactions([Transaction().write(C, obj("rm"), 0,
                                                  b"tiny")])
    # the rot is still detected (not laundered under a fresh CRC)
    with pytest.raises(OSError):
        s.read(C, obj("rm"))
    s.umount()
    # the failed txn's WAL entry must not brick the next mount
    s2 = BlockStore(path)
    s2.mount()
    with pytest.raises(OSError):
        s2.read(C, obj("rm"))
    # and the store still takes writes (full overwrite needs no base)
    s2.queue_transactions([Transaction().write(C, obj("other"), 0,
                                               b"fine")])
    assert s2.read(C, obj("other")) == b"fine"
    s2.umount()


def test_blockstore_live_apply_rollback_covers_all_exceptions(
        tmp_path):
    """Regression (PR 5 fix, PR 6 test): a LIVE transaction that
    fails with a non-OSError mid-apply (here: a malformed write
    payload raising TypeError after an earlier write op already
    allocated blocks) must roll those allocations back — only the
    replay path may swallow OSErrors, and no path may leak bitmap
    blocks from a transaction whose batch never commits.  The
    malformed op passes check_ops (which validates names and
    existence, not payloads), so the failure lands mid-apply."""
    s = BlockStore(str(tmp_path / "bsrb"))
    s.mkfs()
    s.mount()
    try:
        s.queue_transactions([Transaction().create_collection(C)])
        s.queue_transactions(
            [Transaction().write(C, obj("keep"), 0, b"k" * 4096)])
        used_before = s._alloc.used()
        t = Transaction().write(C, obj("doomed"), 0, b"d" * 8192)
        t.ops.append(("write", C, obj("doomed"), 0, None))
        with pytest.raises(TypeError):
            s.queue_transactions([t])
        assert s._alloc.used() == used_before, \
            "failed live apply leaked allocator blocks"
        # the store stays consistent and writable after the rollback
        assert not s.exists(C, obj("doomed"))
        assert s.read(C, obj("keep")) == b"k" * 4096
        s.queue_transactions(
            [Transaction().write(C, obj("after"), 0, b"a" * 4096)])
        assert s.read(C, obj("after")) == b"a" * 4096
    finally:
        s.umount()


# ================================== twins of tests/test_bluestore.py
class _SimCrash(BaseException):
    """Simulated daemon death: BaseException so the stores' own
    ``except Exception`` recovery paths cannot swallow it — exactly
    like a SIGKILL, nothing after the kill point runs."""


# ------------------------------------------------------- commit-vs-apply
def test_read_your_writes_in_apply_pending_window(tmp_path):
    """With the applier parked, committed-but-unapplied state must be
    fully readable: existence from the admission overlay, content via
    the read barrier's work-stealing apply."""
    s = BlueStore(str(tmp_path / "bs"), start_applier=False)
    s.mkfs()
    s.mount()
    try:
        s.queue_transactions([Transaction().create_collection(C)])
        t = Transaction().write(C, obj("w"), 0, b"pending" * 1000)
        t.setattr(C, obj("w"), "a", b"v")
        s.queue_transactions([t])
        with s._qcond:
            assert s._applied_seq < s._wal_seq   # genuinely pending
        # overlay answers existence without forcing the apply
        assert s.exists(C, obj("w"))
        assert s.collection_exists(C)
        assert not s.exists(C, obj("ghost"))
        # content reads steal the apply and see the committed txn
        assert s.read(C, obj("w")) == b"pending" * 1000
        assert s.getattr(C, obj("w"), "a") == b"v"
        assert s.stat(C, obj("w")).size == 7000
        # remove in the pending window: overlay flips existence back
        s.queue_transactions([Transaction().remove(C, obj("w"))])
        assert not s.exists(C, obj("w"))
        with pytest.raises(FileNotFoundError):
            s.queue_transactions(
                [Transaction().clone(C, obj("w"), obj("w2"))])
    finally:
        s.umount()


def test_xattr_overlay_serves_pending_values_without_apply(tmp_path):
    """getattr on a pending setattr must resolve from the admission
    overlay without forcing the apply — the EC write path reads the
    hinfo/object-info xattrs before every sub-write, so a barrier here
    would re-serialize the deferred pipeline."""
    s = BlueStore(str(tmp_path / "bs"), start_applier=False)
    s.mkfs()
    s.mount()
    try:
        s.queue_transactions([Transaction().create_collection(C)])
        t = Transaction().write(C, obj("x"), 0, b"d" * 4096)
        t.setattr(C, obj("x"), "hi", b"v1")
        s.queue_transactions([t])
        applied_before = s._applied_seq
        # pending value served, apply untouched
        assert s.getattr(C, obj("x"), "hi") == b"v1"
        assert s._applied_seq == applied_before
        # newer pending setattr wins over the older one
        t = Transaction().setattr(C, obj("x"), "hi", b"v2")
        s.queue_transactions([t])
        assert s.getattr(C, obj("x"), "hi") == b"v2"
        assert s._applied_seq == applied_before
        # pending rmattr is a tombstone, not a fall-through to the KV
        s.queue_transactions([Transaction().rmattr(C, obj("x"), "hi")])
        with pytest.raises(KeyError):
            s.getattr(C, obj("x"), "hi")
        assert s._applied_seq == applied_before
        # attr never set on an object created in the window: KeyError,
        # not FileNotFoundError, and still no apply
        with pytest.raises(KeyError):
            s.getattr(C, obj("x"), "other")
        assert s._applied_seq == applied_before
        # missing object stays FileNotFoundError
        with pytest.raises(FileNotFoundError):
            s.getattr(C, obj("ghost"), "hi")
        # identity change (clone dst) can't be synthesized: the read
        # barriers and sees the post-apply truth
        t = Transaction().setattr(C, obj("x"), "hi", b"v3")
        t.clone(C, obj("x"), obj("y"))
        s.queue_transactions([t])
        assert s.getattr(C, obj("y"), "hi") == b"v3"
        assert s._applied_seq > applied_before
        # after full drain the KV agrees with everything served above
        s.flush()
        assert s.getattr(C, obj("x"), "hi") == b"v3"
        with pytest.raises(KeyError):
            s.getattr(C, obj("x"), "other")
    finally:
        s.umount()


def test_on_commit_fires_before_apply(tmp_path):
    """The ack semantics the rewrite exists for: on_commit callbacks
    ride WAL durability and must fire while apply is still pending;
    on_applied waits for the applier."""
    s = BlueStore(str(tmp_path / "bs"), start_applier=False)
    s.mkfs()
    s.mount()
    try:
        s.queue_transactions([Transaction().create_collection(C)])
        committed = threading.Event()
        applied = threading.Event()
        t = Transaction().write(C, obj("o"), 0, b"x" * 4096)
        t.register_on_commit(committed.set)
        t.register_on_applied(applied.set)
        s.queue_transactions([t])
        assert committed.wait(5)
        assert not applied.is_set()      # applier is parked
        s.flush()                        # drains via work-stealing
        assert applied.wait(5)
    finally:
        s.umount()


def test_group_commit_amortizes_fsyncs_and_orders_callbacks(tmp_path):
    """Concurrent committers share WAL fsyncs (group_syncs < txns)
    and per-thread on_commit ordering is preserved — the EC backend's
    sub-write acks are exactly these callbacks, so their ordering IS
    the peer-ack ordering."""
    s = BlueStore(str(tmp_path / "bs"),
                  group_commit_window_s=0.002)
    s.mkfs()
    s.mount()
    try:
        s.queue_transactions([Transaction().create_collection(C)])
        base_syncs = s.wal_group_syncs
        per_thread = 12
        n_threads = 8
        orders = {w: [] for w in range(n_threads)}

        def worker(wid):
            for i in range(per_thread):
                t = Transaction().write(C, obj(f"g{wid}_{i}"), 0,
                                        b"z" * 8192)
                t.register_on_commit(
                    lambda w=wid, j=i: orders[w].append(j))
                s.queue_transactions([t])

        ws = [threading.Thread(target=worker, args=(w,))
              for w in range(n_threads)]
        for w in ws:
            w.start()
        for w in ws:
            w.join()
        s.flush()
        total = per_thread * n_threads
        assert s.wal_group_txns >= total
        # amortization: strictly fewer fsyncs than transactions
        assert 0 < s.wal_group_syncs - base_syncs < total
        # per-submitter commit order preserved under the group
        for w in range(n_threads):
            assert orders[w] == list(range(per_thread))
        # every write readable after the drain
        for w in range(n_threads):
            for i in range(per_thread):
                assert s.stat(C, obj(f"g{w}_{i}")).size == 8192
    finally:
        s.umount()


def test_deferred_ledgers_keep_charge_sum_equals_wall(tmp_path):
    """The async split must not break the store-ledger invariant:
    every finalized ledger's charged phases sum to its wall exactly,
    with the deferred_queue phase present and stamps monotone —
    commit acks riding WAL durability change WHERE time is charged,
    never the total."""
    s = BlueStore(str(tmp_path / "bs"))
    s.mkfs()
    s.mount()
    try:
        s.queue_transactions([Transaction().create_collection(C)])

        def worker(wid):
            for i in range(6):
                s.queue_transactions(
                    [Transaction().write(C, obj(f"l{wid}_{i}"), 0,
                                         b"y" * 16384)],
                    op="client_write")

        ws = [threading.Thread(target=worker, args=(w,))
              for w in range(4)]
        for w in ws:
            w.start()
        for w in ws:
            w.join()
        s.flush()
        recent = s._store_accum().recent()
        assert len(recent) >= 25
        saw_deferred = False
        for led in recent:
            stamps = [led[p] for p in PHASE_ORDER if p in led]
            assert stamps == sorted(stamps)     # monotone
            assert sum(dt for _, dt in charge(led)) == \
                pytest.approx(stamps[-1] - stamps[0], abs=1e-9)
            # no backend-private handshake keys may leak into the
            # observed ledgers
            assert not any(isinstance(k, str) and k.startswith("_")
                           for k in led)
            saw_deferred |= "deferred_queue" in led
        assert saw_deferred
        dump = s.dump_store()
        assert dump["phase_seconds"].get("deferred_queue", 0) >= 0
        assert sum(dump["phase_seconds"].values()) == \
            pytest.approx(dump["txn_seconds"], abs=1e-6)
    finally:
        s.umount()


# --------------------------------------------------- abort-path hygiene
def test_abort_discards_ledger_whole(tmp_path):
    """A queue_transactions call that raises (check_ops reject or
    mid-apply error) must discard its TLS ledger WHOLE — no dangling
    stamps bleeding into the next transaction on the same thread —
    and count the abort."""
    s = BlueStore(str(tmp_path / "bs"))
    s.mkfs()
    s.mount()
    try:
        s.queue_transactions([Transaction().create_collection(C)])
        s.flush()
        accum = s._store_accum()
        before = len(accum.recent())
        aborts0 = accum.aborts
        # check_ops reject: missing clone source
        with pytest.raises(FileNotFoundError):
            s.queue_transactions(
                [Transaction().clone(C, obj("nope"), obj("dst"))])
        assert accum.aborts == aborts0 + 1
        # the aborted call observed NO ledger
        s.flush()
        assert len(accum.recent()) == before
        # the next txn on this same thread starts clean: its ledger
        # carries only its own stamps and sums to its own wall
        s.queue_transactions(
            [Transaction().write(C, obj("clean"), 0, b"c" * 4096)])
        s.flush()
        recent = accum.recent()
        assert len(recent) == before + 1
        led = recent[-1]
        stamps = [led[p] for p in PHASE_ORDER if p in led]
        assert stamps == sorted(stamps)
        assert sum(dt for _, dt in charge(led)) == \
            pytest.approx(stamps[-1] - stamps[0], abs=1e-9)
        assert s.dump_store()["aborts"] == aborts0 + 1
    finally:
        s.umount()


def test_abort_mid_apply_blockstore_ledger_hygiene(tmp_path):
    """Same hygiene on the synchronous backend, with the failure
    landing mid-apply (malformed payload passes check_ops)."""
    s = BlockStore(str(tmp_path / "bs"))
    s.mkfs()
    s.mount()
    try:
        s.queue_transactions([Transaction().create_collection(C)])
        accum = s._store_accum()
        before = len(accum.recent())
        t = Transaction()
        t.ops.append(("write", C, obj("bad"), 0, None))
        with pytest.raises(TypeError):
            s.queue_transactions([t])
        assert accum.aborts == 1
        assert len(accum.recent()) == before
        s.queue_transactions(
            [Transaction().write(C, obj("ok"), 0, b"o" * 4096)])
        led = accum.recent()[-1]
        stamps = [led[p] for p in PHASE_ORDER if p in led]
        assert stamps == sorted(stamps)
    finally:
        s.umount()


# ------------------------------------------------- crash torture matrix
def _stamp_killer(store, phase):
    """Kill the daemon the instant ``phase`` is stamped (the stamp is
    the last instruction of that pipeline step, so state is exactly
    post-step)."""
    orig = store._stamp_txn

    def stamp(name):
        orig(name)
        if name == phase:
            raise _SimCrash(phase)
    store._stamp_txn = stamp


def _write_block_killer(store, after_blocks):
    """Kill mid-apply: after ``after_blocks`` device block writes the
    daemon dies with the extent maps un-flipped."""
    orig = store._write_block
    seen = [0]

    def wb(phys, data):
        seen[0] += 1
        if seen[0] > after_blocks:
            raise _SimCrash("mid_apply")
        orig(phys, data)
    store._write_block = wb


def _flush_dev_killer(store):
    """Kill pre-kv_commit: data landed and flushed, the atomic KV
    flip never ran."""
    orig = store._flush_dev

    def fd(dirty):
        orig(dirty)
        raise _SimCrash("pre_kv_commit")
    store._flush_dev = fd


def _alloc_leak_audit(store):
    """Every allocator-used block must be referenced by some extent
    map (direct phys or compressed segment) — anything else leaked."""
    referenced = set()
    for _, raw in store._db.iterate("X/"):
        ext = _Extents.load(raw)
        for v in ext.blocks:
            if v >= 0:
                referenced.add(v)
        for seg in ext.segs.values():
            referenced.update(seg["phys"])
    assert store._alloc.used() == len(referenced), \
        f"allocator holds {store._alloc.used()} blocks, extent maps " \
        f"reference {len(referenced)} — leak"


_KILL_POINTS = ("journal_append", "journal_fsync", "mid_apply",
                "pre_kv_commit")


@pytest.mark.parametrize("kill", _KILL_POINTS)
@pytest.mark.parametrize("backend", ["blockstore", "bluestore"])
def test_crash_torture(tmp_path, kill, backend):
    path = str(tmp_path / "bs")
    zombies = []          # crashed instances stay referenced so no
    #                       gc-time flush races the remount

    def make(arm=None):
        if backend == "bluestore":
            s = BlueStore(path, start_applier=False)
        else:
            s = BlockStore(path)
        if not zombies:
            s.mkfs()
        s.mount()
        if arm:
            arm(s)
        zombies.append(s)
        return s

    # durable baseline state, cleanly unmounted
    s = make()
    s.queue_transactions([Transaction().create_collection(C)])
    base = bytes(range(256)) * 32            # 8 KiB
    s.queue_transactions([Transaction().write(C, obj("keep"), 0,
                                              base)])
    if backend == "bluestore":
        s.flush()
    zombies.pop()
    s.umount()

    # the doomed transaction: overwrite + a fresh object
    doomed = Transaction()
    doomed.write(C, obj("keep"), 4096, b"P" * 4096)
    doomed.write(C, obj("fresh"), 0, b"F" * 12288)

    def arm(s):
        if kill in ("journal_append", "journal_fsync"):
            _stamp_killer(s, kill)
        elif kill == "mid_apply":
            _write_block_killer(s, 2)
        else:
            _flush_dev_killer(s)

    s = make(arm)
    with pytest.raises(_SimCrash):
        s.queue_transactions([doomed])
        if backend == "bluestore":
            # client-side kill points raise from queue_transactions;
            # apply-side ones raise from the work-stealing pump
            s.flush()
    # CRASH: no umount, instance abandoned mid-pipeline

    # -- remount #1: replay must yield a consistent, exact state ----
    s2 = make()
    assert s2.read(C, obj("keep"), 0, 4096) == base[:4096]
    tail = s2.read(C, obj("keep"), 4096)
    applied = s2.exists(C, obj("fresh"))
    if applied:
        # the whole txn replayed: every op of it, bit-exact
        assert tail == b"P" * 4096
        assert s2.read(C, obj("fresh")) == b"F" * 12288
    else:
        # the whole txn vanished: the overwrite too (atomicity)
        assert tail == base[4096:]
    if backend == "bluestore":
        s2.flush()
    _alloc_leak_audit(s2)
    state1 = (s2.read(C, obj("keep")),
              s2.read(C, obj("fresh")) if applied else None)
    used1 = s2._alloc.used()
    zombies.pop()
    s2.umount()

    # -- remount #2: re-apply is idempotent ---------------------------
    s3 = make()
    assert s3.read(C, obj("keep")) == state1[0]
    assert s3.exists(C, obj("fresh")) == applied
    if applied:
        assert s3.read(C, obj("fresh")) == state1[1]
    assert s3._alloc.used() == used1
    _alloc_leak_audit(s3)
    # the store stays writable after recovery
    s3.queue_transactions(
        [Transaction().write(C, obj("post"), 0, b"alive" * 100)])
    assert s3.read(C, obj("post")) == b"alive" * 100
    zombies.pop()
    s3.umount()


def test_torture_durability_of_committed_txns(tmp_path):
    """The commit contract under crash: every transaction whose
    on_commit fired BEFORE the crash must survive the remount, even
    though apply never ran (WAL durability is the promise the async
    ack makes)."""
    path = str(tmp_path / "bs")
    s = BlueStore(path, start_applier=False)
    s.mkfs()
    s.mount()
    s.queue_transactions([Transaction().create_collection(C)])
    committed = []
    for i in range(8):
        t = Transaction().write(C, obj(f"d{i}"), 0,
                                bytes([i]) * 8192)
        t.register_on_commit(lambda j=i: committed.append(j))
        s.queue_transactions([t])
    s._finisher.wait_for_empty()     # drain acks, NOT the applier
    assert sorted(committed) == list(range(8))
    with s._qcond:
        assert s._applied_seq < s._wal_seq   # nothing applied yet
    # crash (no umount), remount fresh
    s2 = BlueStore(path)
    s2.mount()
    try:
        for i in range(8):
            assert s2.read(C, obj(f"d{i}")) == bytes([i]) * 8192
        _alloc_leak_audit(s2)
    finally:
        s2.umount()
    del s


# --------------------------------------------------------- persistence
def test_bluestore_survives_remount_with_wal_retire(tmp_path):
    """Clean-shutdown path: WAL segments retire once applied, applied
    watermark persists, and a remount serves everything without
    replay work."""
    path = str(tmp_path / "bs")
    s = BlueStore(path, wal_segment_bytes=1 << 20)
    s.mkfs()
    s.mount()
    t = Transaction().create_collection(C)
    s.queue_transactions([t])
    for i in range(6):
        s.queue_transactions(
            [Transaction().write(C, obj(f"r{i}"), 0, b"R" * (256 << 10))])
    s.queue_transactions(
        [Transaction().omap_setkeys(C, obj("r0"), {"k": b"v"})])
    s.flush()
    s.umount()
    s2 = BlueStore(path)
    s2.mount()
    try:
        for i in range(6):
            assert s2.read(C, obj(f"r{i}")) == b"R" * (256 << 10)
        assert s2.omap_get(C, obj("r0"))["k"] == b"v"
        u = s2.usage()
        assert u["wal"]["records"] == 0      # nothing replayed
    finally:
        s2.umount()


def test_backpressure_bounds_deferred_queue(tmp_path):
    """deferred_queue_depth bounds the commit→apply window: a
    submitter that finds the queue full becomes an applier
    (work-steal) instead of parking — so even with no applier thread
    at all, writes complete and the queue never grows past the
    bound."""
    s = BlueStore(str(tmp_path / "bs"), start_applier=False,
                  deferred_queue_depth=4, apply_batch_txns=2)
    s.mkfs()
    s.mount()
    try:
        s.queue_transactions([Transaction().create_collection(C)])
        hwm = [0]
        orig_pump = s._pump_once

        def pump():
            with s._qcond:
                hwm[0] = max(hwm[0], len(s._pending))
            return orig_pump()

        s._pump_once = pump
        for i in range(20):
            s.queue_transactions(
                [Transaction().write(C, obj(f"b{i}"), 0,
                                     b"q" * 4096)])
        # every admission held the bound (small overshoot allowed for
        # concurrent racers; single-threaded here, so exact)
        assert hwm[0] <= 4
        with s._qcond:
            assert len(s._pending) <= 4
        s.flush()
        for i in range(20):
            assert s.read(C, obj(f"b{i}")) == b"q" * 4096
    finally:
        s.umount()


# ========= twins of the store tests of test_store_waterfall.py
def _led(t0, **over):
    led = {"txn_queued": t0,
           "journal_append": t0 + 0.002,
           "journal_fsync": t0 + 0.005,
           "data_write": t0 + 0.011,
           "kv_commit": t0 + 0.013,
           "flush": t0 + 0.014,
           "apply_done": t0 + 0.015,
           "op": "client_write", "txns": 1, "bytes_written": 4096}
    led.update(over)
    return led


# ------------------------------------------------------------- units
def test_charge_sum_equals_txn_wall():
    led = _led(1000.0)
    charged = charge(led)
    # every interval charged to the phase ending it; meta fields
    # (op, txns, bytes) never appear as phases; deferred_queue is the
    # async-store stamp, absent from this synchronous-shape ledger
    names = [n for n, _ in charged]
    assert names == [n for n in PHASE_ORDER[1:]
                     if n not in ("alloc", "compress",
                                  "deferred_queue")]
    assert sum(dt for _, dt in charged) == \
        pytest.approx(led["apply_done"] - led["txn_queued"], abs=1e-12)
    # the deferred-apply shape (BlueStore): a deferred_queue stamp
    # between WAL durability and the apply batch slots into order and
    # keeps the sum exact
    led2 = _led(1000.0, deferred_queue=1000.0 + 0.007)
    charged2 = charge(led2)
    assert [n for n, _ in charged2] == \
        [n for n in PHASE_ORDER[1:] if n not in ("alloc", "compress")]
    assert sum(dt for _, dt in charged2) == \
        pytest.approx(led2["apply_done"] - led2["txn_queued"],
                      abs=1e-12)


def test_charge_carves_alloc_and_compress_out_of_data_write():
    led = _led(2000.0, alloc_s=0.002, compress_s=0.001)
    charged = dict(charge(led))
    # the 6 ms journal_fsync -> data_write interval splits three ways
    assert charged["alloc"] == pytest.approx(0.002, abs=1e-9)
    assert charged["compress"] == pytest.approx(0.001, abs=1e-9)
    assert charged["data_write"] == pytest.approx(0.003, abs=1e-9)
    # ...and the per-txn sum stays exact
    assert sum(charge(led)[i][1] for i in range(len(charge(led)))) == \
        pytest.approx(led["apply_done"] - led["txn_queued"], abs=1e-9)
    # carve order follows PHASE_ORDER (alloc before data_write)
    names = [n for n, _ in charge(led)]
    assert names.index("alloc") < names.index("data_write") < \
        names.index("compress")


def test_charge_clamps_oversized_carve_meta():
    # a meta accumulator gone wild can never push the sum past the
    # wall: the carve is clamped to the enclosing data_write interval
    led = _led(3000.0, alloc_s=10.0, compress_s=5.0)
    charged = dict(charge(led))
    assert charged["data_write"] == pytest.approx(0.0, abs=1e-9)
    assert charged["alloc"] == pytest.approx(0.006, abs=1e-9)
    assert "compress" not in charged      # nothing left to carve
    assert sum(dt for _, dt in charge(led)) == \
        pytest.approx(led["apply_done"] - led["txn_queued"], abs=1e-9)


def test_charge_partial_ledger_stays_exact():
    # the MemStore shape: no journal, no KV — the whole wall folds
    # into data_write / flush / apply_done (absent phases zero-width)
    led = {"txn_queued": 5.0, "data_write": 5.02, "flush": 5.021,
           "apply_done": 5.021}
    charged = dict(charge(led))
    assert charged["data_write"] == pytest.approx(0.02, abs=1e-12)
    assert sum(charge(led)[i][1] for i in range(3)) == \
        pytest.approx(0.021, abs=1e-12)
    assert charge({"apply_done": 1.0}) == []
    assert charge({}) == []
    assert charge({"bytes_written": 4096}) == []


def test_op_family_mapping():
    assert op_family("write") == "write"
    assert op_family("zero") == "write"
    assert op_family("omap_rmkeys") == "omap"
    assert op_family("setattrs") == "setattr"
    assert op_family("coll_move_rename") == "clone"
    assert op_family("create_collection") == "other"
    assert op_family("never_heard_of_it") == "other"


def test_accum_census_and_io_accounting():
    accum = StoreLedgerAccum()
    for j in range(8):
        accum.observe(_led(100.0 + j * 0.02, journal_bytes=512,
                           blocks_allocated=2, alloc_s=0.001),
                      op_counts={"write": 2, "omap": 1})
    accum.observe(None)                      # tolerated, not counted
    accum.observe({"bytes_written": 4096})   # stamp-free: not counted
    dump = accum.dump()
    assert dump["txns"] == 8
    # accumulated phase seconds == accumulated txn walls (the
    # invariant, summed), with the alloc carve folded in
    assert sum(dump["phase_seconds"].values()) == \
        pytest.approx(dump["txn_seconds"], abs=1e-9)
    assert dump["phase_seconds"]["alloc"] == \
        pytest.approx(8 * 0.001, abs=1e-9)
    io = dump["io"]
    assert io["op_counts"] == {"write": 16, "omap": 8}
    assert io["bytes_written"] == 8 * 4096
    assert io["journal_bytes"] == 8 * 512
    assert io["blocks_allocated"] == 16
    assert io["txn_batch_occupancy"] == pytest.approx(1.0)
    assert set(dump["p99_s"]) >= {"journal_fsync", "data_write",
                                  "kv_commit"}


def test_merge_dumps_and_waterfall_block():
    a, b = StoreLedgerAccum(), StoreLedgerAccum()
    for j in range(4):
        a.observe(_led(50.0 + j * 0.02), op_counts={"write": 1})
        b.observe(_led(80.0 + j * 0.02), op_counts={"write": 1})
    b.note_stall()
    merged = merge_dumps([a.dump(), b.dump(), None, {}])
    assert merged["txns"] == 8
    assert merged["stalls"] == 1
    assert merged["io"]["op_counts"]["write"] == 8
    assert sum(merged["phase_seconds"].values()) == \
        pytest.approx(merged["txn_seconds"], abs=1e-9)
    blk = store_waterfall_block(merged, wall_s=2.0)
    assert blk["sum_of_shares"] == pytest.approx(1.0, abs=1e-3)
    assert blk["vs_wall"] == pytest.approx(1.0, abs=1e-3)
    # data_write dominates the synthetic ledger (6 ms of 15 ms)
    assert blk["top_phase"] == "data_write"
    assert sum(blk["scaled_s"].values()) == pytest.approx(2.0, abs=1e-2)
    assert blk["stalls"] == 1
    assert blk["io"]["bytes_written"] == 8 * 4096
    # degenerate: an idle store produces an empty, non-crashing block
    empty = store_waterfall_block(merge_dumps([]), wall_s=0.0)
    assert empty["txns"] == 0 and empty["top_phase"] is None


# --------------------------------------- live stores, all 3 backends
def test_backend_ledgers_charge_sum_equals_wall(store):
    """Writes through a real backend must leave ledgers whose charged
    phases sum to the transaction wall exactly — BlockStore with its
    journal/alloc/kv stamps, FileStore, and the stamp-sparse MemStore
    all under the same rule."""
    payload = os.urandom(8192)
    for i in range(6):
        store.queue_transactions(
            [Transaction().write(C, GHObject(f"o{i}", 0), 0, payload)],
            op="client_write")
    store.queue_transactions(
        [Transaction().setattr(C, GHObject("o0", 0), "k", b"v")])
    # deferred-apply backends (BlueStore) finalize ledgers from the
    # applier — flush() guarantees every observation has landed
    store.flush()
    accum = store._store_accum()
    recent = accum.recent()
    assert len(recent) >= 7              # + the fixture's collection
    for led in recent:
        stamps = [led[p] for p in PHASE_ORDER if p in led]
        assert len(stamps) >= 2
        assert sum(dt for _, dt in charge(led)) == \
            pytest.approx(stamps[-1] - stamps[0], abs=1e-9)
    dump = store.dump_store()
    assert dump["backend"] == type(store).__name__
    assert dump["txns"] == len(recent)
    assert sum(dump["phase_seconds"].values()) == \
        pytest.approx(dump["txn_seconds"], abs=1e-6)
    io = dump["io"]
    assert io["op_counts"]["write"] == 6
    assert io["op_counts"]["setattr"] == 1
    assert io["bytes_written"] == 6 * len(payload)
    # the op tag rides the ledger for the forensics/trace lanes
    assert any(led.get("op") == "client_write" for led in recent)
    if isinstance(store, BlockStore):
        # the journal/alloc/kv path actually stamped its phases
        assert dump["phase_seconds"].get("journal_append", 0) > 0
        assert dump["phase_seconds"].get("kv_commit", 0) > 0
        assert io["journal_bytes"] > 0
        assert io["blocks_allocated"] > 0


# ================== twins of the registry tests of test_compressor.py
def test_numeric_ids_are_wire_stable():
    # these ids are ON THE WIRE (first byte of a compressed frame):
    # renumbering breaks rolling upgrades between peers, so pin them
    reg = registry()
    for name, nid in (("zlib", 1), ("bz2", 2), ("lzma", 3)):
        codec = reg.create(name)
        assert codec.numeric_id == nid
        assert type(reg.create_by_id(nid)) is type(codec)


def test_unknown_name_and_id_raise_keyerror():
    reg = registry()
    with pytest.raises(KeyError) as ei:
        reg.create("lz77-imaginary")
    # the message names the supported set: operators fixing a conf
    # typo see their choices
    assert "lz77-imaginary" in str(ei.value)
    assert "zlib" in str(ei.value)
    with pytest.raises(KeyError):
        reg.create_by_id(0)
    with pytest.raises(KeyError):
        reg.create_by_id(250)


def test_zlib_level_plumbs_from_conf():
    # compressor_zlib_level flows caller-conf -> create() -> codec
    fast = registry().create("zlib", conf=Config(
        {"compressor_zlib_level": 1}))
    best = registry().create("zlib", conf=Config(
        {"compressor_zlib_level": 9}))
    assert fast.level == 1 and best.level == 9
    # default path (no conf) uses the global default (5)
    assert registry().create("zlib").level == 5
    # levels are not cosmetic: level 9 must not lose to level 1
    blob = (b"abcd" * 7 + b"\n") * 4096
    assert len(best.compress(blob)) <= len(fast.compress(blob))
    # and both decode back regardless of the sender's level
    assert best.decompress(fast.compress(blob)) == blob
