"""In-RAM transactional object store.

Python-native equivalent of the reference's MemStore test double
(reference src/os/memstore/MemStore.cc, ~1.8k LoC): the full
ObjectStore contract with no persistence, used to run OSD logic
without disks (reference src/test/objectstore/store_test.cc runs the
common store suite over it).  Mutations apply synchronously under the
store lock; on_commit callbacks are delivered from a Finisher thread
to preserve the asynchronous commit contract the OSD relies on
(reference MemStore::queue_transactions → finisher.queue).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from ..utils.finisher import Finisher
from .objectstore import (GHObject, ObjectStat, ObjectStore, Transaction,
                          check_ops, xor_into)


class _Object:
    __slots__ = ("data", "xattrs", "omap", "omap_header")

    def __init__(self) -> None:
        self.data = bytearray()
        self.xattrs: Dict[str, bytes] = {}
        self.omap: Dict[str, bytes] = {}
        self.omap_header = b""

    def clone(self) -> "_Object":
        o = _Object()
        o.data = bytearray(self.data)
        o.xattrs = dict(self.xattrs)
        o.omap = dict(self.omap)
        o.omap_header = self.omap_header
        return o


class MemStore(ObjectStore):
    def __init__(self, path: str = "", max_bytes: int = 0) -> None:
        self.path = path          # unused; kept for ObjectStore symmetry
        self.max_bytes = max_bytes   # reference memstore_device_bytes;
        self._data_bytes = 0         # 0 = unlimited
        self._lock = threading.RLock()
        self._colls: Dict[str, Dict[GHObject, _Object]] = {}
        self._finisher: Optional[Finisher] = None
        self._mounted = False

    def _grow(self, delta: int) -> None:
        if delta > 0 and self.max_bytes and \
                self._data_bytes + delta > self.max_bytes:
            raise OSError(28, "memstore full")   # ENOSPC
        self._data_bytes += delta

    # -- lifecycle ---------------------------------------------------------
    def mkfs(self) -> None:
        with self._lock:
            self._colls = {}

    def mount(self) -> None:
        with self._lock:
            if self._mounted:
                return
            self._finisher = Finisher("memstore-finisher")
            self._mounted = True

    def umount(self) -> None:
        with self._lock:
            if not self._mounted:
                return
            self._mounted = False
            fin = self._finisher
            self._finisher = None
        if fin:
            fin.wait_for_empty()
            fin.stop()

    def flush(self) -> None:
        """Drain pending commit callbacks (reference store flush)."""
        fin = self._finisher
        if fin:
            fin.wait_for_empty()

    # -- mutation ----------------------------------------------------------
    def _do_queue_transactions(self, txns: List[Transaction],
                               on_commit: Optional[Callable[[], None]] = None
                               ) -> None:
        with self._lock:
            if not self._mounted:
                raise RuntimeError("store not mounted")
            # reject invalid transactions whole before mutating anything
            check_ops(
                [op for txn in txns for op in txn.ops],
                lambda c: c in self._colls,
                lambda c, o: c in self._colls and o in self._colls[c])
            for txn in txns:
                for op in txn.ops:
                    self._apply_op(op)
            # no journal, no KV: those ledger phases never stamp and
            # fold to zero-width — the whole apply charges here
            self._stamp_txn("data_write")
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

    def _coll(self, coll: str) -> Dict[GHObject, _Object]:
        try:
            return self._colls[coll]
        except KeyError:
            raise FileNotFoundError(f"no collection {coll!r}")

    def _obj(self, coll: str, obj: GHObject,
             create: bool = False) -> _Object:
        c = self._coll(coll)
        if obj not in c:
            if not create:
                raise FileNotFoundError(f"no object {obj} in {coll!r}")
            c[obj] = _Object()
        return c[obj]

    def _apply_op(self, op) -> None:
        name = op[0]
        if name == "touch":
            self._obj(op[1], op[2], create=True)
        elif name == "write":
            _, coll, obj, offset, data = op
            o = self._obj(coll, obj, create=True)
            end = offset + len(data)
            if len(o.data) < end:
                self._grow(end - len(o.data))
                o.data.extend(b"\x00" * (end - len(o.data)))
            o.data[offset:end] = data
        elif name == "xor_write":
            _, coll, obj, offset, data = op
            o = self._obj(coll, obj, create=True)
            end = offset + len(data)
            if len(o.data) < end:
                self._grow(end - len(o.data))
                o.data.extend(b"\x00" * (end - len(o.data)))
            xor_into(o.data, offset, data)
        elif name == "zero":
            _, coll, obj, offset, length = op
            o = self._obj(coll, obj, create=True)
            end = offset + length
            if len(o.data) < end:
                self._grow(end - len(o.data))
                o.data.extend(b"\x00" * (end - len(o.data)))
            o.data[offset:end] = b"\x00" * length
        elif name == "truncate":
            _, coll, obj, size = op
            o = self._obj(coll, obj, create=True)
            if len(o.data) > size:
                self._grow(size - len(o.data))
                del o.data[size:]
            else:
                self._grow(size - len(o.data))
                o.data.extend(b"\x00" * (size - len(o.data)))
        elif name == "remove":
            _, coll, obj = op
            gone = self._coll(coll).pop(obj, None)
            if gone is not None:
                self._data_bytes -= len(gone.data)
        elif name == "clone":
            _, coll, src, dst = op
            prev = self._coll(coll).get(dst)
            src_o = self._obj(coll, src)
            self._grow(len(src_o.data)
                       - (len(prev.data) if prev else 0))
            self._coll(coll)[dst] = src_o.clone()
        elif name == "setattr":
            _, coll, obj, attr, value = op
            self._obj(coll, obj, create=True).xattrs[attr] = value
        elif name == "rmattr":
            _, coll, obj, attr = op
            self._obj(coll, obj).xattrs.pop(attr, None)
        elif name == "omap_setkeys":
            _, coll, obj, kvs = op
            self._obj(coll, obj, create=True).omap.update(kvs)
        elif name == "omap_rmkeys":
            _, coll, obj, keys = op
            o = self._obj(coll, obj)
            for k in keys:
                o.omap.pop(k, None)
        elif name == "omap_clear":
            _, coll, obj = op
            self._obj(coll, obj).omap.clear()
        elif name == "omap_setheader":
            _, coll, obj, header = op
            self._obj(coll, obj, create=True).omap_header = header
        elif name == "mkcoll":
            self._colls.setdefault(op[1], {})
        elif name == "rmcoll":
            dropped = self._colls.pop(op[1], None)
            if dropped:
                self._data_bytes -= sum(len(o.data)
                                        for o in dropped.values())
        elif name == "coll_move_rename":
            _, src_coll, src, dst_coll, dst = op
            o = self._coll(src_coll).pop(src)
            self._coll(dst_coll)[dst] = o
        else:
            raise ValueError(f"unknown op {name!r}")

    # -- reads -------------------------------------------------------------
    def read(self, coll: str, obj: GHObject, offset: int = 0,
             length: Optional[int] = None) -> bytes:
        with self._lock:
            o = self._obj(coll, obj)
            if length is None:
                return bytes(o.data[offset:])
            return bytes(o.data[offset:offset + length])

    def stat(self, coll: str, obj: GHObject) -> ObjectStat:
        with self._lock:
            return ObjectStat(size=len(self._obj(coll, obj).data))

    def exists(self, coll: str, obj: GHObject) -> bool:
        with self._lock:
            return coll in self._colls and obj in self._colls[coll]

    def getattr(self, coll: str, obj: GHObject, name: str) -> bytes:
        with self._lock:
            attrs = self._obj(coll, obj).xattrs
            if name not in attrs:
                raise KeyError(name)
            return attrs[name]

    def getattrs(self, coll: str, obj: GHObject) -> Dict[str, bytes]:
        with self._lock:
            return dict(self._obj(coll, obj).xattrs)

    def omap_get(self, coll: str, obj: GHObject) -> Dict[str, bytes]:
        with self._lock:
            return dict(self._obj(coll, obj).omap)

    def omap_get_header(self, coll: str, obj: GHObject) -> bytes:
        with self._lock:
            return self._obj(coll, obj).omap_header

    def omap_get_keys(self, coll: str, obj: GHObject,
                      start_after: str = "",
                      max_return: Optional[int] = None) -> List[str]:
        with self._lock:
            keys = sorted(k for k in self._obj(coll, obj).omap
                          if k > start_after)
        return keys if max_return is None else keys[:max_return]

    # -- collections -------------------------------------------------------
    def list_collections(self) -> List[str]:
        with self._lock:
            return sorted(self._colls)

    def collection_exists(self, coll: str) -> bool:
        with self._lock:
            return coll in self._colls

    def collection_list(self, coll: str, start_after: str = "",
                        max_return: Optional[int] = None
                        ) -> List[GHObject]:
        with self._lock:
            objs = sorted(o for o in self._coll(coll)
                          if o.oid > start_after)
        return objs if max_return is None else objs[:max_return]
