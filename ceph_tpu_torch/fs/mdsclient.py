"""CephFS client speaking to the MDS daemon.

Python-native equivalent of the reference's fs client (reference
``src/client/Client.cc``): metadata ops go to the MDS over the
messenger; file DATA is striped directly to the data pool's OSDs
(reference Client file IO through the Objecter — the MDS never sees
data bytes).  Write-capability handling mirrors MClientCaps:

* ``open(path, "w")`` grants an exclusive cap: writes stream to the
  OSDs while size/mtime buffer locally;
* an ``MMDSCapRecall`` push (another client wants the file) flushes
  the buffered size back and degrades the handle to sync-through
  (every later write updates the MDS immediately);
* ``close()`` releases the cap with a final flush.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from ..client.rados import Rados, RadosError
from ..client.striper import Layout, StripedIoCtx
from ..msg.messages import MMDSCapRecall, MMDSOp
from ..msg.messenger import Connection, Dispatcher
from ..utils.config import Config
from .filesystem import FSError, _data_soid, parent_path, pin_rank_of


class MDSClient(Dispatcher):
    """Filesystem handle bound to one MDS + the data pool."""

    def __init__(self, rados: Rados,
                 mds_addr: Optional[Tuple[str, int]],
                 data_pool: str):
        self.rados = rados
        self.name = rados.msgr.name
        self.lock = threading.RLock()
        self._next_tid = 0
        self._pending: Dict[int, threading.Event] = {}
        self._replies: Dict[int, object] = {}
        self._handles: Dict[int, "FileHandle"] = {}   # ino -> capped
        data = rados.open_ioctx(data_pool)
        # same layout as FileSystem so library-mode and daemon-mode
        # interoperate on the same pools
        self.striper = StripedIoCtx(
            data, Layout(stripe_unit=64 << 10, stripe_count=1,
                         object_size=4 << 20))
        rados.msgr.add_dispatcher(self)
        # mds_addr=None resolves the active MDS through the monitor's
        # MDSMap (reference Client consults the mdsmap; a fixed addr
        # keeps solo/test deployments working).  Multi-MDS: the map's
        # pin table routes each request to its subtree's rank
        # (reference Client::choose_target_mds walking dir auth).
        self._fixed_addr = mds_addr is not None
        self._map: dict = {}            # actives: {rank: addr}, pins
        self._rank_conns: Dict[str, Connection] = {}
        if mds_addr is None:
            mds_addr = self._resolve_active(timeout=15.0)
        self.mds_addr = mds_addr
        self._conn = rados.msgr.connect_to(mds_addr, lossless=False)

    def _resolve_active(self, timeout: float) -> Tuple[str, int]:
        deadline = threading.TIMEOUT_MAX if timeout <= 0 else \
            __import__("time").monotonic() + timeout
        import time as _t
        while True:
            try:
                ret, _, out = self.rados.mon_command(
                    {"prefix": "mds getmap"}, timeout=5.0)
                if ret == 0 and out.get("addr"):
                    self._map = out
                    return tuple(out["addr"])
            except Exception:
                pass
            if _t.monotonic() >= deadline:
                raise FSError(110, "no active MDS")
            _t.sleep(0.25)

    # -- multi-MDS routing (the daemon applies the same shared rule,
    # filesystem.pin_rank_of, so client and server cannot drift) ------
    def _route_rank(self, op: str, args: dict) -> int:
        if "_rank" in args:
            return int(args["_rank"])    # explicit (cap releases)
        pins = self._map.get("pins") or {}
        if not pins:
            return 0
        if op == "listdir":
            p = args.get("path", "/")
        elif op == "rename":
            p = parent_path(args.get("old", "/"))
        else:
            p = parent_path(args.get("path", "/"))
        return pin_rank_of(pins, p)

    def _conn_for(self, rank: int) -> Connection:
        if rank == 0 or self._fixed_addr:
            return self._conn
        addr = (self._map.get("actives") or {}).get(str(rank))
        if addr is None:
            # stale map: refresh once; rank 0 serves as last resort
            # (it forwards again if it disagrees)
            self._resolve_active(timeout=5.0)
            addr = (self._map.get("actives") or {}).get(str(rank))
            if addr is None:
                return self._conn
        key = f"{rank}:{addr}"
        conn = self._rank_conns.get(key)
        if conn is None or not conn.is_connected():
            conn = self.rados.msgr.connect_to(tuple(addr),
                                              lossless=False)
            self._rank_conns[key] = conn
        return conn

    # -- transport -----------------------------------------------------
    def ms_dispatch(self, conn: Connection, msg) -> bool:
        from ..msg.messages import MMDSOpReply
        if isinstance(msg, MMDSOpReply):
            with self.lock:
                self._replies[msg.tid] = msg
                ev = self._pending.pop(msg.tid, None)
            if ev:
                ev.set()
            return True
        if isinstance(msg, MMDSCapRecall):
            threading.Thread(target=self._recalled,
                             args=(msg.ino, msg.cap_id,
                                   getattr(msg, "rank", 0)),
                             daemon=True).start()
            return True
        return False

    def _recalled(self, ino: int, cap_id: int,
                  rank: int = 0) -> None:
        # a recall can race the open reply (cap granted, handle not
        # yet registered): wait briefly for the handle so its
        # buffered size flushes instead of being dropped
        import time as _t
        fh = None
        deadline = _t.monotonic() + 1.0
        while _t.monotonic() < deadline:
            with self.lock:
                fh = self._handles.get(ino)
            if fh is not None:
                break
            _t.sleep(0.02)
        if fh is not None:
            fh._flush_and_drop_cap()
        else:
            # no handle left to supply a path: route by the GRANTING
            # rank the recall carried (a release landing at the wrong
            # rank would silently no-op and the recall would stall to
            # its timeout)
            self.request("cap_release", {"ino": ino,
                                         "cap_id": cap_id,
                                         "_rank": rank})

    def request(self, op: str, args: dict,
                timeout: float = 30.0) -> dict:
        """One MDS op, transparently resent across MDS failover: a
        standby's ESTALE or a dead active's silence re-resolves the
        MDSMap and retries (the daemon's journal-backed reqid table
        makes retried mutations exactly-once)."""
        import time as _t
        with self.lock:
            self._next_tid += 1
            tid = self._next_tid
        deadline = _t.monotonic() + timeout
        # fixed-addr clients keep single-shot semantics (no failover)
        attempt_wait = timeout if self._fixed_addr \
            else min(5.0, timeout)
        forced_rank = None           # set by a forward (-108) verdict
        while True:
            rank = forced_rank if forced_rank is not None \
                else self._route_rank(op, args)
            conn = self._conn_for(rank)
            with self.lock:
                ev = threading.Event()
                self._pending[tid] = ev
            conn.send_message(MMDSOp(client=self.name, tid=tid,
                                     op=op, args=args))
            got = ev.wait(attempt_wait)
            with self.lock:
                self._pending.pop(tid, None)
                reply = self._replies.pop(tid, None)
            if got and reply is not None and reply.result == -108:
                # forward verdict: the op belongs to another rank's
                # subtree (our pin table was stale) — refresh and
                # follow the daemon's word.  Deadline-bounded: a pin
                # to a VACANT rank bounces every attempt back to rank
                # 0, which must end in ETIMEDOUT, not a busy-loop
                if _t.monotonic() >= deadline:
                    raise FSError(110, f"mds op {op} timed out "
                                  f"(forwarded to rank "
                                  f"{(reply.out or {}).get('rank')} "
                                  f"with no serving daemon)")
                forced_rank = int((reply.out or {}).get("rank", 0))
                try:
                    self._resolve_active(
                        timeout=max(0.5, deadline - _t.monotonic()))
                except FSError:
                    raise FSError(110, f"mds op {op} timed out")
                _t.sleep(0.1)        # pace re-forwards
                continue
            stale = got and reply is not None and reply.result == -116
            if got and not stale:
                if reply.result < 0:
                    raise FSError(-reply.result,
                                  f"{op}: {reply.result}")
                return reply.out
            # silent (MDS died?) or ESTALE (standby): re-resolve
            if self._fixed_addr or _t.monotonic() >= deadline:
                raise FSError(110, f"mds op {op} timed out")
            try:
                addr = self._resolve_active(
                    timeout=max(0.5, deadline - _t.monotonic()))
            except FSError:
                raise FSError(110, f"mds op {op} timed out")
            forced_rank = None       # failover: re-route by fresh map
            self._rank_conns.clear()
            if addr != self.mds_addr or not self._conn.is_connected():
                self.mds_addr = addr
                self._conn = self.rados.msgr.connect_to(
                    addr, lossless=False)

    # -- namespace API (reference Client_*) ----------------------------
    def mkdir(self, path: str) -> int:
        return self.request("mkdir", {"path": path})["ino"]

    def listdir(self, path: str = "/") -> List[dict]:
        return self.request("listdir", {"path": path})["entries"]

    def stat(self, path: str) -> dict:
        return self.request("stat", {"path": path})

    def exists(self, path: str) -> bool:
        try:
            self.stat(path)
            return True
        except FSError:
            return False

    def unlink(self, path: str) -> None:
        self.request("unlink", {"path": path})

    def rmdir(self, path: str) -> None:
        self.request("rmdir", {"path": path})

    def rename(self, old: str, new: str) -> None:
        self.request("rename", {"old": old, "new": new})

    def truncate(self, path: str, size: int) -> None:
        self.request("truncate", {"path": path, "size": size})

    def open(self, path: str, mode: str = "r") -> "FileHandle":
        out = self.request("open", {"path": path, "mode": mode})
        fh = FileHandle(self, path, out["ino"], mode,
                        out.get("cap_id"), out["size"])
        if mode == "w":
            with self.lock:
                self._handles[out["ino"]] = fh
        return fh

    # convenience (parity with FileSystem)
    def write_file(self, path: str, data: bytes,
                   offset: int = 0) -> None:
        fh = self.open(path, "w")
        try:
            fh.write(data, offset)
        finally:
            fh.close()

    def read_file(self, path: str, length: int = 0,
                  offset: int = 0) -> bytes:
        fh = self.open(path, "r")
        try:
            return fh.read(length, offset)
        finally:
            fh.close()


class FileHandle:
    """One open file (reference Fh + CapRef)."""

    def __init__(self, client: MDSClient, path: str, ino: int,
                 mode: str, cap_id: Optional[int], size: int):
        self.client = client
        self.path = path
        self.ino = ino
        self.mode = mode
        self.cap_id = cap_id         # None = no cap (sync-through)
        self.size = size
        self._lock = threading.RLock()
        self._dirty = False

    # -- data path: straight to the OSDs -------------------------------
    def write(self, data: bytes, offset: Optional[int] = None) -> int:
        if self.mode != "w":
            raise FSError(9, "not open for write")
        with self._lock:
            off = self.size if offset is None else offset
            self.client.striper.write(_data_soid(self.ino), data, off)
            new_size = max(self.size, off + len(data))
            if self.cap_id is not None:
                # capped: buffer the size locally (flushed on
                # recall/close) — the CephFS fast path
                self.size = new_size
                self._dirty = True
            else:
                # sync-through after a recall
                out = self.client.request(
                    "setattr", {"path": self.path, "size": new_size,
                                "grow_only": True})
                self.size = out["size"]
        return len(data)

    def read(self, length: int = 0, offset: int = 0) -> bytes:
        with self._lock:
            size = self.size
        if self.cap_id is None and self.mode != "w":
            size = self.client.stat(self.path)["size"]
        if size == 0 or offset >= size:
            return b""
        want = size - offset if length == 0 \
            else min(length, size - offset)
        try:
            return self.client.striper.read(_data_soid(self.ino),
                                            want, offset)
        except RadosError:
            return b""

    # -- caps -----------------------------------------------------------
    def _flush_and_drop_cap(self) -> None:
        with self._lock:
            if self.cap_id is None:
                return
            # path rides along purely for ROUTING: the cap lives at
            # the rank that granted it (the file's subtree rank)
            args = {"ino": self.ino, "cap_id": self.cap_id,
                    "path": self.path}
            if self._dirty:
                args["size"] = self.size
            self.cap_id = None
            self._dirty = False
        self.client.request("cap_release", args)
        with self.client.lock:
            self.client._handles.pop(self.ino, None)

    def close(self) -> None:
        self._flush_and_drop_cap()
