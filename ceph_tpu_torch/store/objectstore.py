"""Transactional local object store interface.

Python-native equivalent of the reference's ObjectStore seam (reference
src/os/ObjectStore.h): named collections (one per PG shard) holding
objects with byte data, xattrs and an omap (sorted key/value map);
all mutations expressed as ordered op lists inside a ``Transaction``
applied atomically by ``queue_transactions`` (reference
os/ObjectStore.h:222), with on_applied / on_commit completion
callbacks registered on the transaction itself (reference
Transaction::register_on_applied / register_on_commit).

Transactions are encodable (utils/encoding.py) because the EC
write path ships them shard-to-shard inside ECSubWrite messages, as
the reference does (reference osd/ECMsgTypes.h ECSubWrite::t).

Implementations: MemStore (store/memstore.py, the reference's test
double os/memstore/MemStore.cc) and FileStore (store/filestore.py,
persistent directory-backed).
"""
from __future__ import annotations

import abc
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from ..utils import faults as faultlib
from ..utils import store_ledger
from ..utils.encoding import Decoder, Encoder

#: thread-local current store-transaction ledger: backends stamp
#: phases through _stamp_txn without any signature change to
#: _do_queue_transactions (apply runs synchronously on the queueing
#: thread in every backend, so thread-local is exact)
_TXN_TLS = threading.local()

# Collection ids are strings: str(SPGid) for PG collections, "meta" for
# the OSD's bookkeeping collection (reference coll_t, osd/osd_types.h).
COLL_META = "meta"


def xor_into(buf: bytearray, offset: int, data) -> None:
    """XOR ``data`` into ``buf[offset:offset+len(data)]`` in place.
    Caller guarantees the region exists.  Wide-int XOR: CPython
    bignum ^ runs word-at-a-time, ~100x a Python byte loop on
    chunk-sized parity deltas."""
    n = len(data)
    end = offset + n
    a = int.from_bytes(buf[offset:end], "little")
    b = int.from_bytes(data, "little")
    buf[offset:end] = (a ^ b).to_bytes(n, "little")


@dataclass(frozen=True, order=True)
class GHObject:
    """Store-level object identity (reference ghobject_t): object name
    plus the EC shard the local copy holds (-1 = whole object /
    replicated, reference shard_id_t::NO_SHARD)."""
    oid: str
    shard: int = -1

    def __str__(self) -> str:
        return self.oid if self.shard < 0 else f"{self.oid}(s{self.shard})"


class Transaction:
    """Ordered mutation list (reference ObjectStore::Transaction).

    Ops are (name, args...) tuples; the op vocabulary is the subset of
    the reference's Transaction::Op codes the OSD data path uses
    (reference os/ObjectStore.h enum: OP_TOUCH..OP_COLL_MOVE_RENAME).
    """

    def __init__(self) -> None:
        self.ops: List[Tuple] = []
        self.on_applied: List[Callable[[], None]] = []
        self.on_commit: List[Callable[[], None]] = []

    def empty(self) -> bool:
        return not self.ops

    # -- completion hooks (reference register_on_applied/:commit) ---------
    def register_on_applied(self, fn: Callable[[], None]) -> None:
        self.on_applied.append(fn)

    def register_on_commit(self, fn: Callable[[], None]) -> None:
        self.on_commit.append(fn)

    def append(self, other: "Transaction") -> None:
        self.ops.extend(other.ops)
        self.on_applied.extend(other.on_applied)
        self.on_commit.extend(other.on_commit)

    # -- object data ops ---------------------------------------------------
    def touch(self, coll: str, obj: GHObject) -> "Transaction":
        self.ops.append(("touch", coll, obj)); return self

    def write(self, coll: str, obj: GHObject, offset: int,
              data: bytes) -> "Transaction":
        # bytes/memoryview/uint8-ndarray payloads ride BY REFERENCE
        # (the EC write path hands over encoded shard views; copying
        # here would undo the zero-copy data path).  Ownership
        # transfers: the caller must not mutate the buffer after
        # queueing.  Mutable bytearrays still snapshot.
        if isinstance(data, bytearray):
            data = bytes(data)  # copycheck: ok - snapshot of a caller-mutable buffer
        self.ops.append(("write", coll, obj, offset, data))
        return self

    def xor_write(self, coll: str, obj: GHObject, offset: int,
                  data: bytes) -> "Transaction":
        """XOR ``data`` into the stored bytes at ``offset`` (zero-extend
        if the object is shorter): the parity-delta RMW carrier.  The
        EC primary ships Δparity = M·Δdata and each parity shard folds
        it in locally — GF(2^8) addition IS xor, so the store never
        needs codec knowledge.  Payload rides by reference like write.
        """
        if isinstance(data, bytearray):
            data = bytes(data)  # copycheck: ok - snapshot of a caller-mutable buffer
        self.ops.append(("xor_write", coll, obj, offset, data))
        return self

    def zero(self, coll: str, obj: GHObject, offset: int,
             length: int) -> "Transaction":
        self.ops.append(("zero", coll, obj, offset, length)); return self

    def truncate(self, coll: str, obj: GHObject,
                 size: int) -> "Transaction":
        self.ops.append(("truncate", coll, obj, size)); return self

    def remove(self, coll: str, obj: GHObject) -> "Transaction":
        self.ops.append(("remove", coll, obj)); return self

    def clone(self, coll: str, src: GHObject,
              dst: GHObject) -> "Transaction":
        self.ops.append(("clone", coll, src, dst)); return self

    # -- xattrs ------------------------------------------------------------
    def setattr(self, coll: str, obj: GHObject, name: str,
                value: bytes) -> "Transaction":
        self.ops.append(("setattr", coll, obj, name, bytes(value)))
        return self

    def setattrs(self, coll: str, obj: GHObject,
                 attrs: Dict[str, bytes]) -> "Transaction":
        for name in sorted(attrs):
            self.setattr(coll, obj, name, attrs[name])
        return self

    def rmattr(self, coll: str, obj: GHObject,
               name: str) -> "Transaction":
        self.ops.append(("rmattr", coll, obj, name)); return self

    # -- omap --------------------------------------------------------------
    def omap_setkeys(self, coll: str, obj: GHObject,
                     kvs: Dict[str, bytes]) -> "Transaction":
        self.ops.append(("omap_setkeys", coll, obj,
                         {k: bytes(v) for k, v in kvs.items()}))
        return self

    def omap_rmkeys(self, coll: str, obj: GHObject,
                    keys: Iterable[str]) -> "Transaction":
        self.ops.append(("omap_rmkeys", coll, obj, list(keys)))
        return self

    def omap_clear(self, coll: str, obj: GHObject) -> "Transaction":
        self.ops.append(("omap_clear", coll, obj)); return self

    def omap_setheader(self, coll: str, obj: GHObject,
                       header: bytes) -> "Transaction":
        self.ops.append(("omap_setheader", coll, obj, bytes(header)))
        return self

    # -- collections -------------------------------------------------------
    def create_collection(self, coll: str) -> "Transaction":
        self.ops.append(("mkcoll", coll)); return self

    def remove_collection(self, coll: str) -> "Transaction":
        self.ops.append(("rmcoll", coll)); return self

    def collection_move_rename(self, src_coll: str, src: GHObject,
                               dst_coll: str,
                               dst: GHObject) -> "Transaction":
        self.ops.append(("coll_move_rename", src_coll, src,
                         dst_coll, dst))
        return self

    # -- wire form (reference Transaction::encode/decode) ------------------
    _OBJ_OPS = {"touch", "remove", "omap_clear"}

    def encode(self) -> bytes:
        return Encoder().struct(1, 1, self._encode_body()).build()

    @classmethod
    def _encode_op(cls, body: Encoder, op: Tuple) -> None:
        name = op[0]
        body.str(name)
        if name in cls._OBJ_OPS:
            _, coll, obj = op
            body.str(coll).str(obj.oid).i32(obj.shard)
        elif name in ("write", "xor_write"):
            _, coll, obj, offset, data = op
            body.str(coll).str(obj.oid).i32(obj.shard)
            body.u64(offset).bytes(data)
        elif name in ("zero",):
            _, coll, obj, offset, length = op
            body.str(coll).str(obj.oid).i32(obj.shard)
            body.u64(offset).u64(length)
        elif name == "truncate":
            _, coll, obj, size = op
            body.str(coll).str(obj.oid).i32(obj.shard).u64(size)
        elif name == "clone":
            _, coll, src, dst = op
            body.str(coll).str(src.oid).i32(src.shard)
            body.str(dst.oid).i32(dst.shard)
        elif name == "setattr":
            _, coll, obj, attr, value = op
            body.str(coll).str(obj.oid).i32(obj.shard)
            body.str(attr).bytes(value)
        elif name == "rmattr":
            _, coll, obj, attr = op
            body.str(coll).str(obj.oid).i32(obj.shard).str(attr)
        elif name == "omap_setkeys":
            _, coll, obj, kvs = op
            body.str(coll).str(obj.oid).i32(obj.shard)
            body.str_bytes_map(kvs)
        elif name == "omap_rmkeys":
            _, coll, obj, keys = op
            body.str(coll).str(obj.oid).i32(obj.shard)
            body.str_list(keys)
        elif name == "omap_setheader":
            _, coll, obj, header = op
            body.str(coll).str(obj.oid).i32(obj.shard).bytes(header)
        elif name in ("mkcoll", "rmcoll"):
            _, coll = op
            body.str(coll)
        elif name == "coll_move_rename":
            _, src_coll, src, dst_coll, dst = op
            body.str(src_coll).str(src.oid).i32(src.shard)
            body.str(dst_coll).str(dst.oid).i32(dst.shard)
        else:
            raise ValueError(f"unencodable op {name!r}")

    def encode_parts(self) -> List:
        """Wire form as a fragment list: small framing fields coalesce,
        large write payloads stay as by-reference views — the messenger
        sends the list as scatter-gather iovecs without ever joining
        them (ECSubWrite's txn never round-trips through one big
        bytes)."""
        body = self._encode_body()
        return Encoder().struct(1, 1, body).build_parts()

    def _encode_body(self) -> Encoder:
        body = Encoder()
        body.u32(len(self.ops))
        for op in self.ops:
            self._encode_op(body, op)
        return body

    @classmethod
    def decode(cls, buf) -> "Transaction":
        if isinstance(buf, (list, tuple)):
            # locally-looped message carrying encode_parts() fragments
            buf = b"".join(buf)
        _, d = Decoder(buf).struct(1)
        t = cls()
        for _ in range(d.u32()):
            name = d.str()
            if name in cls._OBJ_OPS:
                t.ops.append((name, d.str(), GHObject(d.str(), d.i32())))
            elif name in ("write", "xor_write"):
                coll, obj = d.str(), GHObject(d.str(), d.i32())
                t.ops.append((name, coll, obj, d.u64(), d.bytes()))
            elif name == "zero":
                coll, obj = d.str(), GHObject(d.str(), d.i32())
                t.ops.append((name, coll, obj, d.u64(), d.u64()))
            elif name == "truncate":
                coll, obj = d.str(), GHObject(d.str(), d.i32())
                t.ops.append((name, coll, obj, d.u64()))
            elif name == "clone":
                coll, src = d.str(), GHObject(d.str(), d.i32())
                t.ops.append((name, coll, src, GHObject(d.str(), d.i32())))
            elif name == "setattr":
                coll, obj = d.str(), GHObject(d.str(), d.i32())
                t.ops.append((name, coll, obj, d.str(), d.bytes()))
            elif name == "rmattr":
                coll, obj = d.str(), GHObject(d.str(), d.i32())
                t.ops.append((name, coll, obj, d.str()))
            elif name == "omap_setkeys":
                coll, obj = d.str(), GHObject(d.str(), d.i32())
                t.ops.append((name, coll, obj, d.str_bytes_map()))
            elif name == "omap_rmkeys":
                coll, obj = d.str(), GHObject(d.str(), d.i32())
                t.ops.append((name, coll, obj, d.str_list()))
            elif name == "omap_setheader":
                coll, obj = d.str(), GHObject(d.str(), d.i32())
                t.ops.append((name, coll, obj, d.bytes()))
            elif name in ("mkcoll", "rmcoll"):
                t.ops.append((name, d.str()))
            elif name == "coll_move_rename":
                src_coll, src = d.str(), GHObject(d.str(), d.i32())
                t.ops.append((name, src_coll, src, d.str(),
                              GHObject(d.str(), d.i32())))
            else:
                raise ValueError(f"undecodable op {name!r}")
        return t


@dataclass
class ObjectStat:
    """reference struct stat subset returned by ObjectStore::stat."""
    size: int


def check_ops(ops, coll_exists: Callable[[str], bool],
              obj_exists: Callable[[str, GHObject], bool]) -> None:
    """Validate a transaction's ops before any mutation, simulating
    intra-transaction creates/removes over the store's existence
    predicates, so an invalid transaction is rejected whole (the
    atomicity contract; the reference treats an op failure mid-apply
    as fatal store corruption — ceph_abort in
    BlueStore::_txc_add_transaction — so validating up front is the
    recoverable equivalent).  Raises FileNotFoundError on a missing
    source; I/O errors during the subsequent apply are the only
    remaining mid-transaction failures and are fatal.
    """
    colls: Dict[str, bool] = {}          # overlay: name -> exists
    objs: Dict[Tuple[str, GHObject], bool] = {}
    wiped: set = set()                   # colls rmcoll'd in this txn

    def has_coll(coll: str) -> bool:
        if coll in colls:
            return colls[coll]
        return coll_exists(coll)

    def has_obj(coll: str, obj: GHObject) -> bool:
        key = (coll, obj)
        if key in objs:
            return objs[key]
        if coll in wiped:
            return False
        return obj_exists(coll, obj)

    def need_coll(coll):
        if not has_coll(coll):
            raise FileNotFoundError(f"no collection {coll!r}")

    def need_obj(coll, obj):
        need_coll(coll)
        if not has_obj(coll, obj):
            raise FileNotFoundError(f"no object {obj} in {coll!r}")

    creates = {"touch", "write", "xor_write", "zero", "truncate",
               "setattr", "omap_setkeys", "omap_setheader"}
    requires = {"rmattr", "omap_rmkeys", "omap_clear"}
    for op in ops:
        name = op[0]
        if name in creates:
            need_coll(op[1])
            objs[(op[1], op[2])] = True
        elif name in requires:
            need_obj(op[1], op[2])
        elif name == "remove":
            need_coll(op[1])
            objs[(op[1], op[2])] = False
        elif name == "clone":
            _, coll, src, dst = op
            need_obj(coll, src)
            objs[(coll, dst)] = True
        elif name == "mkcoll":
            colls[op[1]] = True
        elif name == "rmcoll":
            colls[op[1]] = False
            wiped.add(op[1])
            for key in [k for k in objs if k[0] == op[1]]:
                del objs[key]
        elif name == "coll_move_rename":
            _, src_coll, src, dst_coll, dst = op
            need_obj(src_coll, src)
            need_coll(dst_coll)
            objs[(src_coll, src)] = False
            objs[(dst_coll, dst)] = True
        else:
            raise ValueError(f"unknown op {name!r}")


class ObjectStore(abc.ABC):
    """Abstract store API (reference os/ObjectStore.h).

    All mutations go through queue_transactions; reads are direct.
    Transactions are applied atomically and in submission order per
    collection (the reference serializes per-collection via op
    sequencers).
    """

    # -- lifecycle ---------------------------------------------------------
    @abc.abstractmethod
    def mount(self) -> None:
        """Load state (reference ObjectStore::mount)."""

    @abc.abstractmethod
    def umount(self) -> None:
        """Flush and release (reference ObjectStore::umount)."""

    @abc.abstractmethod
    def mkfs(self) -> None:
        """Initialize an empty store (reference ObjectStore::mkfs)."""

    # -- observability seams (utils/store_ledger.py) -----------------------
    # ObjectStore subclasses never call super().__init__, so all
    # ledger state is created lazily: any store — including a future
    # BlueStore-class rewrite — inherits the full instrumentation by
    # merely routing mutations through queue_transactions and
    # (optionally) stamping its internal phases via _stamp_txn.

    def _store_accum(self) -> store_ledger.StoreLedgerAccum:
        accum = getattr(self, "_sl_accum", None)
        if accum is None:
            accum = store_ledger.StoreLedgerAccum()
            self._sl_accum = accum
        return accum

    def attach_observability(self, perf_coll=None, recorder=None,
                             stall_threshold_s: float = 0.0
                             ) -> store_ledger.StoreLedgerAccum:
        """Wire the store's ledger into a daemon: register the
        ``store`` perf subsystem in ``perf_coll`` (-> ``ceph_store_*``
        prometheus), flight-record ``store_stall`` events into
        ``recorder`` for phases at/over ``stall_threshold_s``.
        Idempotent, and safe for stores surviving an OSD restart:
        accumulated state is kept, counters rebind into the new
        daemon's collection."""
        accum = self._store_accum()
        if perf_coll is not None:
            accum.bind_perf(perf_coll)
        self._sl_recorder = recorder
        self._sl_stall_s = float(stall_threshold_s)
        return accum

    def _stamp_txn(self, phase: str) -> None:
        """Backend seam: stamp the current transaction's ledger.
        No-op outside queue_transactions (mount-time replay)."""
        led = getattr(_TXN_TLS, "led", None)
        if led is not None:
            led[phase] = time.time()

    def _txn_meta(self, field_name: str, value) -> None:
        """Backend seam: accumulate a meta field (carved phase
        seconds, IO accounting counts) on the current ledger."""
        led = getattr(_TXN_TLS, "led", None)
        if led is not None:
            led[field_name] = led.get(field_name, 0) + value

    def dump_store(self) -> dict:
        """``dump_store`` admin payload: the accumulator dump plus
        backend identity (merge-compatible across backends)."""
        out = self._store_accum().dump()
        out["backend"] = type(self).__name__
        return out

    def store_stall_signals(self) -> dict:
        """Health-check feed: stall count + txn volume."""
        accum = self._store_accum()
        return {"stalls": accum.stalls, "txns": accum.txns}

    def _observe_txn(self, led: Dict[str, float],
                     txns: List["Transaction"]) -> None:
        bytes_written = 0
        op_counts: Dict[str, int] = {}
        fam_of = store_ledger.op_family
        for txn in txns:
            for o in txn.ops:
                fam = fam_of(o[0])
                op_counts[fam] = op_counts.get(fam, 0) + 1
                if o[0] in ("write", "xor_write"):
                    bytes_written += len(o[4])
        led["txns"] = len(txns)
        led["bytes_written"] = bytes_written
        accum = self._store_accum()
        charged = accum.observe(led, op_counts=op_counts)
        stall_s = getattr(self, "_sl_stall_s", 0.0)
        if stall_s > 0:
            for phase, dt in charged:
                if dt >= stall_s:
                    accum.note_stall()
                    rec = getattr(self, "_sl_recorder", None)
                    if rec is not None:
                        rec.note("store_stall", phase=phase,
                                 ms=round(dt * 1e3, 3),
                                 backend=type(self).__name__,
                                 op=led.get("op"))
                        rec.auto_dump("store-phase-stall")

    # -- mutation ----------------------------------------------------------
    def queue_transactions(self, txns: List[Transaction],
                           on_commit: Optional[Callable[[], None]] = None,
                           op: Optional[str] = None) -> None:
        """Apply atomically; deliver per-transaction on_applied inline
        and on_commit (plus the aggregate callback) via the finisher
        (reference os/ObjectStore.h:222).

        Template method: the ``store.apply`` injection point
        (utils/faults.py) gates admission — error mode raises before
        any mutation, stall sleeps in place like a wedged disk,
        corrupt mode bit-flips one queued write payload (planted bit
        rot for the scrub/repair machinery) — then the backend's
        ``_do_queue_transactions`` applies.  ``op`` tags the txn's
        store ledger with the enclosing client op's identity.

        The ledger's ``txn_queued`` t0 lands BEFORE the fault gate so
        an injected store.apply stall is charged into the following
        phase interval — exactly where a real wedged journal/device
        would surface."""
        led: Dict[str, float] = {"txn_queued": time.time()}
        if op is not None:
            led["op"] = op
        prev = getattr(_TXN_TLS, "led", None)
        _TXN_TLS.led = led
        try:
            faultlib.registry().store_apply(txns)
            self._do_queue_transactions(txns, on_commit)
        except BaseException:
            # abort-path ledger hygiene: a txn that raises (check_ops
            # reject, fault-site error, mid-apply I/O error) leaves
            # dangling phase stamps — discard the ledger WHOLE rather
            # than charge a partial waterfall, and count the abort.
            # BaseException: a simulated crash in the torture test
            # must not leak ledger state into the next txn either.
            led.pop("_deferred", None)
            self._store_accum().note_abort()
            raise
        finally:
            _TXN_TLS.led = prev
        if led.pop("_deferred", False):
            # a deferred-apply backend (BlueStore) took ownership: the
            # txn is WAL-durable but not yet applied; the apply driver
            # stamps the remaining phases and calls _finalize_txn when
            # the batch lands, keeping charge-sum == txn wall.
            return
        self._finalize_txn(led, txns)

    def _finalize_txn(self, led: Dict[str, float],
                      txns: List["Transaction"]) -> None:
        """Close a transaction's ledger: final stamp + accumulate.
        Synchronous backends reach here from queue_transactions;
        deferred-apply backends call it from the apply driver."""
        led["apply_done"] = time.time()
        self._observe_txn(led, txns)

    def flush(self) -> None:
        """Block until previously queued transactions are applied and
        their callbacks delivered (reference ObjectStore::flush).
        Synchronous backends have nothing pending; deferred-apply
        backends override."""

    @abc.abstractmethod
    def _do_queue_transactions(self, txns: List[Transaction],
                               on_commit: Optional[Callable[[], None]]
                               = None) -> None:
        """Backend apply (see queue_transactions)."""

    def apply_transaction(self, txn: Transaction) -> None:
        self.queue_transactions([txn])

    # -- reads -------------------------------------------------------------
    @abc.abstractmethod
    def read(self, coll: str, obj: GHObject, offset: int = 0,
             length: Optional[int] = None) -> bytes:
        """Byte extent; length=None reads to EOF.  Raises FileNotFoundError
        for a missing object (maps -ENOENT)."""

    @abc.abstractmethod
    def stat(self, coll: str, obj: GHObject) -> ObjectStat:
        ...

    @abc.abstractmethod
    def exists(self, coll: str, obj: GHObject) -> bool:
        ...

    @abc.abstractmethod
    def getattr(self, coll: str, obj: GHObject, name: str) -> bytes:
        ...

    @abc.abstractmethod
    def getattrs(self, coll: str, obj: GHObject) -> Dict[str, bytes]:
        ...

    @abc.abstractmethod
    def omap_get(self, coll: str, obj: GHObject) -> Dict[str, bytes]:
        ...

    @abc.abstractmethod
    def omap_get_header(self, coll: str, obj: GHObject) -> bytes:
        ...

    @abc.abstractmethod
    def omap_get_keys(self, coll: str, obj: GHObject,
                      start_after: str = "",
                      max_return: Optional[int] = None) -> List[str]:
        """Sorted key range scan (reference omap iterator)."""

    # -- collections -------------------------------------------------------
    @abc.abstractmethod
    def list_collections(self) -> List[str]:
        ...

    @abc.abstractmethod
    def collection_exists(self, coll: str) -> bool:
        ...

    @abc.abstractmethod
    def collection_list(self, coll: str, start_after: str = "",
                        max_return: Optional[int] = None
                        ) -> List[GHObject]:
        """Objects in name order (reference collection_list)."""
