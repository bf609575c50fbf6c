"""Object classes: in-OSD compute plugins (RADOS "UDFs").

Python-native equivalent of the reference's objclass mechanism
(reference ``src/objclass/`` + ``src/cls/`` 39.2k LoC): a client op
``call <class>.<method> <input>`` (reference CEPH_OSD_OP_CALL) runs a
registered handler INSIDE the OSD, atomically with the op — the
handler reads the target object and stages mutations that commit
through the normal replicated write path, so class side effects obey
the same durability/ordering as plain writes (reference
cls_cxx_read/cls_cxx_map_set_val staging into the op's transaction).

Classes return -ENOTSUP on EC pools, as the reference does
(doc "Object Classes" in ecbackend.rst).

Registration (reference cls_register/cls_register_cxx_method)::

    @cls_method("lock", "lock")
    def lock(ctx, indata: bytes) -> Tuple[int, bytes]: ...

``ctx`` (reference cls_method_context_t) exposes reads of the
committed object state and staged writes via the pending Mutation.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

CLASS_REGISTRY: Dict[str, Dict[str, Tuple[Callable, bool]]] = {}


def cls_method(cls_name: str, method: str, write: bool = True):
    """Decorator registering ``<cls>.<method>`` (reference
    CLS_METHOD_RD/CLS_METHOD_WR flags).  ``write=False`` methods run
    on the read path: no transaction, no object creation, no PG-log
    entry for a mere probe."""
    def wrap(fn):
        CLASS_REGISTRY.setdefault(cls_name, {})[method] = (fn, write)
        return fn
    return wrap


def call_is_write(spec: str) -> bool:
    """Write-classification for op routing; unknown methods classify
    as write so the error surfaces on the serialized path."""
    if "." not in spec:
        return True
    cls_name, method = spec.split(".", 1)
    entry = CLASS_REGISTRY.get(cls_name, {}).get(method)
    return True if entry is None else entry[1]


class MethodContext:
    """What a class method may do to its object (reference
    cls_cxx_* helpers).  Reads see committed state OVERLAID with the
    op's already-staged mutation, so sequential calls inside one
    client op observe each other's effects (the reference executes
    ops sequentially against the in-progress transaction); writes
    stage into the Mutation and commit with it."""

    def __init__(self, pg, oid: str, mutation) -> None:
        self._pg = pg
        self.oid = oid
        self._mut = mutation
        self._obj = None

    # -- reads (committed state + staged overlay) ----------------------
    def _handle(self):
        from ..store.objectstore import GHObject
        if self._obj is None:
            self._obj = GHObject(self.oid, self._pg.own_shard)
        return self._pg.store, self._pg.coll, self._obj

    def exists(self) -> bool:
        if self._mut.delete:
            return False
        if self._mut.create or self._mut.writes or self._mut.attrs:
            return True
        store, coll, obj = self._handle()
        return store.exists(coll, obj)

    def read(self, offset: int = 0, length=None) -> bytes:
        store, coll, obj = self._handle()
        try:
            base = bytearray(store.read(coll, obj))
        except FileNotFoundError:
            base = bytearray()
        if self._mut.delete:
            base = bytearray()
        for off, data in self._mut.writes:
            if off + len(data) > len(base):
                base.extend(b"\0" * (off + len(data) - len(base)))
            base[off:off + len(data)] = data
        if self._mut.truncate is not None:
            base = base[:self._mut.truncate]
        end = len(base) if length is None else offset + length
        return bytes(base[offset:end])

    def stat(self):
        store, coll, obj = self._handle()
        return store.stat(coll, obj)

    def getxattr(self, name: str) -> bytes:
        # staged attrs win (class attrs share the client path's user
        # prefix so plain getxattr sees them too)
        if name in self._mut.attrs:
            val = self._mut.attrs[name]
            if val is None:
                raise KeyError(name)
            return val
        store, coll, obj = self._handle()
        return store.getattr(coll, obj, "u_" + name)

    def getxattrs(self) -> Dict[str, bytes]:
        store, coll, obj = self._handle()
        try:
            out = {k[2:]: v for k, v in
                   store.getattrs(coll, obj).items()
                   if k.startswith("u_")}
        except FileNotFoundError:
            out = {}
        for name, val in self._mut.attrs.items():
            if val is None:
                out.pop(name, None)
            else:
                out[name] = val
        return out

    def omap_get(self) -> Dict[str, bytes]:
        store, coll, obj = self._handle()
        try:
            out = dict(store.omap_get(coll, obj))
        except FileNotFoundError:
            out = {}
        if self._mut.omap_clear:
            out = {}
        out.update(self._mut.omap_set)
        for k in self._mut.omap_rm:
            out.pop(k, None)
        return out

    def omap_get_keys(self, start_after: str = "",
                      max_return=None):
        keys = sorted(self.omap_get())
        keys = [k for k in keys if k > start_after]
        return keys[:max_return] if max_return else keys

    # -- staged writes (commit with the op) ----------------------------
    def write(self, offset: int, data: bytes) -> None:
        self._mut.writes.append((offset, data))

    def write_full(self, data: bytes) -> None:
        self._mut.writes.append((0, data))
        self._mut.truncate = len(data)

    def create(self) -> None:
        self._mut.create = True

    def truncate(self, size: int) -> None:
        self._mut.truncate = size

    def remove(self) -> None:
        self._mut.delete = True

    def setxattr(self, name: str, value: bytes) -> None:
        self._mut.attrs[name] = value

    def rmxattr(self, name: str) -> None:
        self._mut.attrs[name] = None

    def omap_set(self, kvs: Dict[str, bytes]) -> None:
        self._mut.omap_set.update(kvs)

    def omap_rm(self, keys) -> None:
        self._mut.omap_rm.extend(keys)


def dispatch_call(pg, oid: str, spec: str, indata: bytes,
                  mutation) -> Tuple[int, bytes]:
    """Run ``<class>.<method>`` (reference ClassHandler::open_class +
    method exec in do_osd_ops' CEPH_OSD_OP_CALL arm).  ``mutation``
    is None on the read path — a read-only method staging writes is a
    bug and fails EINVAL."""
    if "." not in spec:
        return -22, b""
    cls_name, method = spec.split(".", 1)
    entry = CLASS_REGISTRY.get(cls_name, {}).get(method)
    if entry is None:
        return -95, b""                  # EOPNOTSUPP: unknown class
    fn, _writes = entry
    from ..osd.backend import Mutation
    mut = mutation if mutation is not None else Mutation()
    ctx = MethodContext(pg, oid, mut)
    try:
        ret, out = fn(ctx, indata)
    except Exception as e:
        from ..utils.log import Dout
        Dout("objclass").dwarn(
            "class method %s on %s failed: %r", spec, oid, e)
        return -22, b""
    if mutation is None and (mut.writes or mut.attrs or mut.delete
                             or mut.create or mut.omap_set
                             or mut.omap_rm or mut.omap_clear
                             or mut.truncate is not None):
        return -22, b""                  # RD method tried to write
    return ret, out


# ship the built-in classes (reference src/cls/ is linked in-tree too)
from . import cls_fence, cls_lock, cls_version  # noqa: E402,F401
