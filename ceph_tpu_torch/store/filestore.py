"""Persistent directory-backed object store.

The framework's durable ObjectStore (the reference's BlueStore seat,
reference src/os/bluestore/BlueStore.cc, with FileStore's
file-per-object layout, reference src/os/filestore/): object byte data
in per-object files under the store root, metadata (existence, xattrs,
omap) in a LogDB key/value store (store/kv.py — the RocksDB
seat, as BlueStore keeps metadata in RocksDB), and a write-ahead
transaction journal in the same KV so a transaction's data-file writes
and metadata batch apply atomically across a crash (reference
FileStore's FileJournal; journal entries replay on mount).

Ordering per transaction: validate (reject invalid transactions whole,
see objectstore.check_ops) → journal the encoded transaction with
fsync → apply data-file writes and the metadata batch → fsync touched
data files and directories → durably retire the journal entry.  A
crash anywhere before retirement replays the whole transaction on the
next mount (apply is written to be replay-tolerant).  Metadata reads
during apply go through a read-your-writes view over (KV, pending
batch) so ops see earlier ops of the same transaction.

An OSD restart is resume: mount() replays any journaled-but-unretired
transactions, then collections/objects are exactly as committed
(reference SURVEY §5 checkpoint/resume).
"""
from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..utils.finisher import Finisher
from .kv import LogDB, WriteBatch
from .objectstore import (GHObject, ObjectStat, ObjectStore, Transaction,
                          check_ops, xor_into)


def _objkey(obj: GHObject) -> str:
    return f"{obj.oid.encode().hex()}_{obj.shard}"


def _unobjkey(key: str) -> GHObject:
    hexoid, shard = key.rsplit("_", 1)
    return GHObject(bytes.fromhex(hexoid).decode(), int(shard))


class _BatchView:
    """Read-your-writes view over (db, pending WriteBatch): metadata
    reads during apply see earlier ops of the same transaction."""

    def __init__(self, db: LogDB, batch: WriteBatch):
        self.db = db
        self.batch = batch

    def get(self, key: str) -> Optional[bytes]:
        val = self.db.get(key)
        for op, k, v in self.batch.ops:
            if op == "set" and k == key:
                val = v
            elif op == "rm" and k == key:
                val = None
            elif op == "rm_prefix" and key.startswith(k):
                val = None
            elif op == "rm_range" and k <= key < v.decode():
                val = None
        return val

    def iterate(self, prefix: str) -> List[Tuple[str, bytes]]:
        data = dict(self.db.iterate(prefix))
        for op, k, v in self.batch.ops:
            if op == "set":
                if k.startswith(prefix):
                    data[k] = v
            elif op == "rm":
                data.pop(k, None)
            elif op == "rm_prefix":
                for kk in [kk for kk in data if kk.startswith(k)]:
                    del data[kk]
            elif op == "rm_range":
                end = v.decode()
                for kk in [kk for kk in data if k <= kk < end]:
                    del data[kk]
        return sorted(data.items())


class _ApplyCtx:
    """Per-transaction apply state: the metadata batch, its view, and
    the data files/dirs needing fsync before journal retirement."""

    def __init__(self, db: LogDB):
        self.batch = WriteBatch()
        self.view = _BatchView(db, self.batch)
        self.dirty_files: Set[str] = set()
        self.dirty_dirs: Set[str] = set()


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class FileStore(ObjectStore):
    """Data files + LogDB metadata + journaled transactions."""

    medium = "hdd"

    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        # filestore_fsync: the per-txn data fsync is the machine-crash
        # durability knob; process restarts replay the WAL either way
        self.fsync = fsync
        self._lock = threading.RLock()
        self._db: Optional[LogDB] = None
        self._finisher: Optional[Finisher] = None
        self._journal_seq = 0

    # -- paths -------------------------------------------------------------
    def _data_dir(self, coll: str) -> str:
        return os.path.join(self.path, "data", coll)

    def _data_path(self, coll: str, obj: GHObject) -> str:
        return os.path.join(self._data_dir(coll), _objkey(obj))

    # -- lifecycle ---------------------------------------------------------
    def mkfs(self) -> None:
        os.makedirs(os.path.join(self.path, "data"), exist_ok=True)
        db = LogDB(os.path.join(self.path, "meta.kv"))
        db.open()
        db.close()

    def mount(self) -> None:
        with self._lock:
            if self._db is not None:
                return
            if not os.path.exists(os.path.join(self.path, "meta.kv")):
                raise IOError(f"{self.path}: not a FileStore (run mkfs)")
            self._db = LogDB(os.path.join(self.path, "meta.kv"))
            self._db.open()
            self._finisher = Finisher("filestore-finisher")
            self._replay_journal()

    def umount(self) -> None:
        with self._lock:
            if self._db is None:
                return
            db, fin = self._db, self._finisher
            self._db = None
            self._finisher = None
        if fin:
            fin.wait_for_empty()
            fin.stop()
        db.close()

    def flush(self) -> None:
        fin = self._finisher
        if fin:
            fin.wait_for_empty()

    def _replay_journal(self) -> None:
        pending = sorted(self._db.get_prefix("J/").items())
        for key, payload in pending:
            txn = Transaction.decode(payload)
            ctx = _ApplyCtx(self._db)
            for op in txn.ops:
                self._apply_op(op, ctx, replay=True)
            self._sync_dirty(ctx)
            ctx.batch.rm(key)
            self._db.submit(ctx.batch, sync=True)
        self._journal_seq = 0

    # -- mutation ----------------------------------------------------------
    def _do_queue_transactions(self, txns: List[Transaction],
                               on_commit: Optional[Callable[[], None]] = None
                               ) -> None:
        with self._lock:
            if self._db is None:
                raise RuntimeError("store not mounted")
            merged = Transaction()
            for txn in txns:
                merged.ops.extend(txn.ops)
            # 1. validate: nothing durable happens for an invalid txn
            check_ops(merged.ops,
                      lambda c: self._db.get(f"C/{c}") is not None,
                      lambda c, o: self._db.get(
                          self._exists_key(c, o)) is not None)
            # 2. journal (WAL): the whole txn durable before any apply;
            #    on an I/O failure past this point the entry stays and
            #    replays on the next mount.  Append and fsync are
            #    stamped separately so the ledger splits WAL write
            #    cost from WAL durability cost.
            self._journal_seq += 1
            jkey = f"J/{self._journal_seq:016d}"
            record = merged.encode()
            self._txn_meta("journal_bytes", len(record))
            self._db.submit(WriteBatch().set(jkey, record))
            self._stamp_txn("journal_append")
            self._db.sync()
            self._stamp_txn("journal_fsync")
            # 3. apply data-file writes + metadata batch
            ctx = _ApplyCtx(self._db)
            for op in merged.ops:
                self._apply_op(op, ctx)
            # 4. data durable before the journal entry is retired
            self._sync_dirty(ctx)
            self._stamp_txn("data_write")
            ctx.batch.rm(jkey)
            self._db.submit(ctx.batch, sync=True)
            self._stamp_txn("kv_commit")
            fin = self._finisher
        for txn in txns:
            for fn in txn.on_applied:
                fn()
        self._stamp_txn("flush")
        callbacks = [fn for txn in txns for fn in txn.on_commit]
        if on_commit is not None:
            callbacks.append(on_commit)
        assert fin is not None
        for fn in callbacks:
            fin.queue(fn)

    def _sync_dirty(self, ctx: _ApplyCtx) -> None:
        if not self.fsync:
            return
        for path in ctx.dirty_files:
            if os.path.exists(path):
                _fsync_path(path)
        for path in ctx.dirty_dirs:
            if os.path.isdir(path):
                _fsync_path(path)

    def _exists_key(self, coll: str, obj: GHObject) -> str:
        return f"E/{coll}/{_objkey(obj)}"

    def _require_coll_view(self, coll: str, ctx: _ApplyCtx) -> None:
        if ctx.view.get(f"C/{coll}") is None:
            raise FileNotFoundError(f"no collection {coll!r}")

    def _ensure_obj(self, coll: str, obj: GHObject,
                    ctx: _ApplyCtx) -> str:
        """Mark existence; return the data file path."""
        self._require_coll_view(coll, ctx)
        ctx.batch.set(self._exists_key(coll, obj), b"")
        path = self._data_path(coll, obj)
        ctx.dirty_files.add(path)
        ctx.dirty_dirs.add(self._data_dir(coll))
        return path

    def _apply_op(self, op, ctx: _ApplyCtx, replay: bool = False) -> None:
        """Apply one op: file I/O immediately, metadata into the batch.
        replay=True tolerates missing sources (the op may have fully or
        partially applied before the crash)."""
        try:
            self._apply_op_inner(op[0], op, ctx)
        except FileNotFoundError:
            if not replay:
                raise

    def _apply_op_inner(self, name, op, ctx: _ApplyCtx) -> None:
        if name == "touch":
            _, coll, obj = op
            path = self._ensure_obj(coll, obj, ctx)
            if not os.path.exists(path):
                open(path, "wb").close()
        elif name == "write":
            _, coll, obj, offset, data = op
            path = self._ensure_obj(coll, obj, ctx)
            with open(path, "ab" if not os.path.exists(path) else "r+b") \
                    as fh:
                size = fh.seek(0, 2)
                if size < offset:
                    fh.write(b"\x00" * (offset - size))
                fh.seek(offset)
                fh.write(data)
        elif name == "xor_write":
            _, coll, obj, offset, data = op
            path = self._ensure_obj(coll, obj, ctx)
            if not os.path.exists(path):
                open(path, "wb").close()
            with open(path, "r+b") as fh:
                size = fh.seek(0, 2)
                end = offset + len(data)
                if size < end:
                    fh.write(b"\x00" * (end - size))
                fh.seek(offset)
                cur = bytearray(fh.read(len(data)))
                xor_into(cur, 0, data)
                fh.seek(offset)
                fh.write(cur)
        elif name == "zero":
            _, coll, obj, offset, length = op
            self._apply_op_inner(
                "write", ("write", coll, obj, offset, b"\x00" * length),
                ctx)
        elif name == "truncate":
            _, coll, obj, size = op
            path = self._ensure_obj(coll, obj, ctx)
            if not os.path.exists(path):
                open(path, "wb").close()
            with open(path, "r+b") as fh:
                cur = fh.seek(0, 2)
                if cur < size:
                    fh.write(b"\x00" * (size - cur))
                else:
                    fh.truncate(size)
        elif name == "remove":
            _, coll, obj = op
            self._require_coll_view(coll, ctx)
            k = _objkey(obj)
            ctx.batch.rm(self._exists_key(coll, obj))
            ctx.batch.rm(f"H/{coll}/{k}")
            ctx.batch.rm_prefix(f"A/{coll}/{k}/")
            ctx.batch.rm_prefix(f"M/{coll}/{k}/")
            try:
                os.unlink(self._data_path(coll, obj))
                ctx.dirty_dirs.add(self._data_dir(coll))
            except FileNotFoundError:
                pass
        elif name == "clone":
            _, coll, src, dst = op
            self._require_coll_view(coll, ctx)
            if ctx.view.get(self._exists_key(coll, src)) is None:
                raise FileNotFoundError(f"no object {src} in {coll!r}")
            sk, dk = _objkey(src), _objkey(dst)
            ctx.batch.set(self._exists_key(coll, dst), b"")
            for pfx in ("A", "M"):
                src_pfx = f"{pfx}/{coll}/{sk}/"
                ctx.batch.rm_prefix(f"{pfx}/{coll}/{dk}/")
                for k, v in ctx.view.iterate(src_pfx):
                    ctx.batch.set(
                        f"{pfx}/{coll}/{dk}/{k[len(src_pfx):]}", v)
            ctx.batch.rm(f"H/{coll}/{dk}")    # dst replaced wholesale
            hdr = ctx.view.get(f"H/{coll}/{sk}")
            if hdr is not None:
                ctx.batch.set(f"H/{coll}/{dk}", hdr)
            spath = self._data_path(coll, src)
            data = b""
            if os.path.exists(spath):
                with open(spath, "rb") as fh:
                    data = fh.read()
            dpath = self._data_path(coll, dst)
            with open(dpath, "wb") as fh:
                fh.write(data)
            ctx.dirty_files.add(dpath)
            ctx.dirty_dirs.add(self._data_dir(coll))
        elif name == "setattr":
            _, coll, obj, attr, value = op
            self._ensure_obj(coll, obj, ctx)
            ctx.batch.set(f"A/{coll}/{_objkey(obj)}/{attr}", value)
        elif name == "rmattr":
            _, coll, obj, attr = op
            ctx.batch.rm(f"A/{coll}/{_objkey(obj)}/{attr}")
        elif name == "omap_setkeys":
            _, coll, obj, kvs = op
            self._ensure_obj(coll, obj, ctx)
            for k, v in kvs.items():
                ctx.batch.set(f"M/{coll}/{_objkey(obj)}/{k}", v)
        elif name == "omap_rmkeys":
            _, coll, obj, keys = op
            for k in keys:
                ctx.batch.rm(f"M/{coll}/{_objkey(obj)}/{k}")
        elif name == "omap_clear":
            _, coll, obj = op
            ctx.batch.rm_prefix(f"M/{coll}/{_objkey(obj)}/")
        elif name == "omap_setheader":
            _, coll, obj, header = op
            self._ensure_obj(coll, obj, ctx)
            ctx.batch.set(f"H/{coll}/{_objkey(obj)}", header)
        elif name == "mkcoll":
            _, coll = op
            ctx.batch.set(f"C/{coll}", b"")
            os.makedirs(self._data_dir(coll), exist_ok=True)
            ctx.dirty_dirs.add(self._data_dir(coll))
            ctx.dirty_dirs.add(os.path.join(self.path, "data"))
        elif name == "rmcoll":
            _, coll = op
            ctx.batch.rm(f"C/{coll}")
            for pfx in ("E", "H", "A", "M"):
                ctx.batch.rm_prefix(f"{pfx}/{coll}/")
            ddir = self._data_dir(coll)
            if os.path.isdir(ddir):
                for f in os.listdir(ddir):
                    os.unlink(os.path.join(ddir, f))
                os.rmdir(ddir)
                ctx.dirty_dirs.add(os.path.join(self.path, "data"))
        elif name == "coll_move_rename":
            _, src_coll, src, dst_coll, dst = op
            self._require_coll_view(dst_coll, ctx)
            if ctx.view.get(self._exists_key(src_coll, src)) is None:
                raise FileNotFoundError(
                    f"no object {src} in {src_coll!r}")
            sk, dk = _objkey(src), _objkey(dst)
            # dst is replaced wholesale, as MemStore's dict assignment does
            for pfx in ("A", "M"):
                ctx.batch.rm_prefix(f"{pfx}/{dst_coll}/{dk}/")
                src_pfx = f"{pfx}/{src_coll}/{sk}/"
                for k, v in ctx.view.iterate(src_pfx):
                    ctx.batch.set(
                        f"{pfx}/{dst_coll}/{dk}/{k[len(src_pfx):]}", v)
                ctx.batch.rm_prefix(src_pfx)
            ctx.batch.rm(f"H/{dst_coll}/{dk}")
            hdr = ctx.view.get(f"H/{src_coll}/{sk}")
            if hdr is not None:
                ctx.batch.set(f"H/{dst_coll}/{dk}", hdr)
                ctx.batch.rm(f"H/{src_coll}/{sk}")
            ctx.batch.rm(self._exists_key(src_coll, src))
            ctx.batch.set(self._exists_key(dst_coll, dst), b"")
            spath = self._data_path(src_coll, src)
            dpath = self._data_path(dst_coll, dst)
            if os.path.exists(spath):
                os.replace(spath, dpath)
                ctx.dirty_files.add(dpath)
                ctx.dirty_dirs.add(self._data_dir(src_coll))
                ctx.dirty_dirs.add(self._data_dir(dst_coll))
            elif os.path.exists(dpath):
                os.unlink(dpath)      # data-less src: drop dst's old data
                ctx.dirty_dirs.add(self._data_dir(dst_coll))
        else:
            raise ValueError(f"unknown op {name!r}")

    # -- reads -------------------------------------------------------------
    def _check_obj(self, coll: str, obj: GHObject) -> None:
        if self._db is None:
            raise RuntimeError("store not mounted")
        if self._db.get(f"C/{coll}") is None:
            raise FileNotFoundError(f"no collection {coll!r}")
        if self._db.get(self._exists_key(coll, obj)) is None:
            raise FileNotFoundError(f"no object {obj} in {coll!r}")

    def read(self, coll: str, obj: GHObject, offset: int = 0,
             length: Optional[int] = None) -> bytes:
        with self._lock:
            self._check_obj(coll, obj)
            path = self._data_path(coll, obj)
            if not os.path.exists(path):
                return b""
            with open(path, "rb") as fh:
                # clamp to EOF: callers pass huge sentinels for
                # "whole object" and fh.read preallocates the buffer
                size = os.fstat(fh.fileno()).st_size
                if length is None or offset + length > size:
                    length = max(0, size - offset)
                fh.seek(offset)
                return fh.read(length)

    def stat(self, coll: str, obj: GHObject) -> ObjectStat:
        with self._lock:
            self._check_obj(coll, obj)
            path = self._data_path(coll, obj)
            size = os.path.getsize(path) if os.path.exists(path) else 0
            return ObjectStat(size=size)

    def exists(self, coll: str, obj: GHObject) -> bool:
        with self._lock:
            if self._db is None:
                raise RuntimeError("store not mounted")
            return self._db.get(self._exists_key(coll, obj)) is not None

    def getattr(self, coll: str, obj: GHObject, name: str) -> bytes:
        with self._lock:
            self._check_obj(coll, obj)
            v = self._db.get(f"A/{coll}/{_objkey(obj)}/{name}")
            if v is None:
                raise KeyError(name)
            return v

    def getattrs(self, coll: str, obj: GHObject) -> Dict[str, bytes]:
        with self._lock:
            self._check_obj(coll, obj)
            pfx = f"A/{coll}/{_objkey(obj)}/"
            return {k[len(pfx):]: v for k, v in self._db.iterate(pfx)}

    def omap_get(self, coll: str, obj: GHObject) -> Dict[str, bytes]:
        with self._lock:
            self._check_obj(coll, obj)
            pfx = f"M/{coll}/{_objkey(obj)}/"
            return {k[len(pfx):]: v for k, v in self._db.iterate(pfx)}

    def omap_get_header(self, coll: str, obj: GHObject) -> bytes:
        with self._lock:
            self._check_obj(coll, obj)
            return self._db.get(f"H/{coll}/{_objkey(obj)}") or b""

    def omap_get_keys(self, coll: str, obj: GHObject,
                      start_after: str = "",
                      max_return: Optional[int] = None) -> List[str]:
        with self._lock:
            self._check_obj(coll, obj)
            pfx = f"M/{coll}/{_objkey(obj)}/"
            keys = [k[len(pfx):] for k, _ in self._db.iterate(pfx)
                    if k[len(pfx):] > start_after]
        return keys if max_return is None else keys[:max_return]

    # -- collections -------------------------------------------------------
    def list_collections(self) -> List[str]:
        with self._lock:
            if self._db is None:
                raise RuntimeError("store not mounted")
            return [k[2:] for k, _ in self._db.iterate("C/")]

    def collection_exists(self, coll: str) -> bool:
        with self._lock:
            if self._db is None:
                raise RuntimeError("store not mounted")
            return self._db.get(f"C/{coll}") is not None

    def collection_list(self, coll: str, start_after: str = "",
                        max_return: Optional[int] = None
                        ) -> List[GHObject]:
        with self._lock:
            if self._db is None:
                raise RuntimeError("store not mounted")
            if self._db.get(f"C/{coll}") is None:
                raise FileNotFoundError(f"no collection {coll!r}")
            pfx = f"E/{coll}/"
            objs = sorted((_unobjkey(k[len(pfx):])
                           for k, _ in self._db.iterate(pfx)),
                          key=lambda o: (o.oid, o.shard))
            objs = [o for o in objs if o.oid > start_after]
        return objs if max_return is None else objs[:max_return]
