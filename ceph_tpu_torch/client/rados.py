"""Client stack: Objecter op engine + a librados-style API.

Python-native equivalents of the reference's client layers:

* **Objecter** (reference src/osdc/Objecter.cc 5.3k LoC): op
  submission with map-based targeting (``op_submit`` :2263 ->
  ``_calc_target`` :2766 — object -> PG via rjenkins+stable_mod ->
  acting primary via CRUSH), resend on every map change that moves the
  target or on connection reset, and completion matching by tid.
  Connections to OSDs are lossy: a dead socket just resets and the
  Objecter resends (reference Objecter resend-on-reset policy,
  msg/Policy.h lossy client).
* **Rados / IoCtx** (reference src/librados/ RadosClient + IoCtxImpl):
  cluster handle bound to a monitor (map subscription + commands), and
  per-pool IO contexts exposing the synchronous object API the tools
  and tests drive: write/write_full/append/read/remove/stat/
  getxattr/setxattr/omap/list_objects (reference
  librados/IoCtxImpl.cc:595-672 routing into the Objecter).

Async forms return ``Completion`` handles (reference aio_*); the sync
forms wrap them.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..mon.client import MonClient
from ..msg.messages import MOSDOp, MOSDOpReply, MWatchNotify, OSDOp
from ..msg.messenger import Connection, Dispatcher, Messenger
from ..osd.osdmap import OSDMap, PGid
from ..utils.config import Config, default_config
from ..utils.hops import HopAccum
from ..utils.log import Dout

# reply code the OSD uses for "wrong primary / stale map, refresh and
# resend" (reference: the client resends on a newer map rather than on
# an errno, but a sentinel keeps the framework's reply path explicit)
EAGAIN_WRONG_PRIMARY = -108


class RadosError(OSError):
    pass


class RadosTimeoutError(RadosError, TimeoutError):
    """An op outlived rados_osd_op_timeout: surfaced as ETIMEDOUT
    (reference Objecter op_cancel(-ETIMEDOUT) on osd_timeout)."""

    def __init__(self, msg: str):
        super().__init__(110, msg)       # errno 110 = ETIMEDOUT


class Completion:
    """One in-flight op (reference librados AioCompletion)."""

    def __init__(self, objecter: "Objecter", tid: int):
        self._objecter = objecter
        self.tid = tid
        self._ev = threading.Event()
        self.result: Optional[int] = None
        self.reply: Optional[MOSDOpReply] = None

    def _complete(self, reply: MOSDOpReply) -> None:
        self.reply = reply
        self.result = reply.result
        self._ev.set()

    def wait(self, timeout: Optional[float] = None) -> int:
        if not self._ev.wait(timeout):
            # vacate the objecter's inflight window (a timed-out op
            # left in place would permanently shrink the
            # objecter_inflight_ops/bytes window until the whole
            # client wedged)
            self._objecter.cancel(self.tid)
            raise RadosTimeoutError(f"op tid={self.tid} timed out")
        return self.result

    def is_complete(self) -> bool:
        return self._ev.is_set()


class _InflightOp:
    def __init__(self, tid: int, pool: int, oid: str,
                 ops: List[OSDOp], completion: Completion,
                 pgid_seed: Optional[int] = None):
        self.tid = tid
        self.pool = pool
        self.oid = oid
        self.ops = ops
        self.completion = completion
        self.pgid_seed = pgid_seed     # explicit PG target (pgls)
        self.is_write = False          # tier routing (write_tier)
        self.bypass_tier = False       # IGNORE_OVERLAY (internal IO)
        self.target_osd: Optional[int] = None
        self.sent_epoch = 0
        self.trace_id = 0
        self.parent_span_id = 0        # client root span id
        self.snapc: Tuple[int, List[int]] = (0, [])  # write SnapContext
        self.snapid = 0                # read snap (0 = head)


class Objecter(Dispatcher):
    """Client op engine (reference osdc/Objecter.cc)."""

    def __init__(self, msgr: Messenger, monc: MonClient,
                 conf: Optional[Config] = None):
        self.msgr = msgr
        self.monc = monc
        self.conf = conf or default_config()
        self.log = Dout("client", f"objecter({msgr.name}) ")
        self.lock = threading.RLock()
        self.osdmap = OSDMap()
        self.map_ready = threading.Event()
        self._next_tid = 0
        self.inflight: Dict[int, _InflightOp] = {}
        # client op/byte windows (reference objecter_inflight_ops /
        # objecter_inflight_op_bytes throttles, osdc/Objecter.cc
        # op_throttle_*): submit blocks while the window is full
        self._max_inflight = self.conf["objecter_inflight_ops"]
        self._max_inflight_bytes = \
            self.conf["objecter_inflight_op_bytes"]
        self._inflight_bytes = 0
        self._window = threading.Condition(self.lock)
        # lingering registrations (reference Objecter linger ops):
        # re-sent whenever the target moves — the watch machinery
        self.lingers: Dict[int, _InflightOp] = {}
        # (pool, oid, cookie) -> callback(notifier, payload)
        self.watch_callbacks: Dict[Tuple[int, str, int], Callable] = {}
        self._osd_conns: Dict[int, Connection] = {}
        # end-to-end waterfall: the client sees the WHOLE ledger when
        # the reply returns it (client_send .. client_complete), so
        # the client owns the authoritative per-op hop accumulator
        self.hops = HopAccum()
        # read-class ops keep their own accumulator: read waterfalls
        # visit different hops (read_queued/shard_read/decode_*) and
        # folding them into the write view would skew both
        self.hops_read = HopAccum(subsystem="hops_read")
        msgr.add_dispatcher(self)

    # ------------------------------------------------------------------
    # map intake (MonClient delivers via handle_osdmap)
    # ------------------------------------------------------------------
    def handle_osdmap(self, wire: dict) -> None:
        newmap = OSDMap.from_wire_dict(wire)
        with self.lock:
            if newmap.epoch <= self.osdmap.epoch:
                return
            oldmap, self.osdmap = self.osdmap, newmap
            resend = list(self.inflight.values())
        self.map_ready.set()
        # resend ops whose target moved OR whose PG interval changed
        # (reference _scan_requests / need_resend on every new map).
        # The primary-only check is not enough: when a NON-primary
        # acting shard dies, the PG discards its in-flight ops on the
        # interval change and relies on the client to resend (pg.py
        # documents that contract next to the reqid dedup that makes
        # the resend exactly-once) — without this, a write caught
        # mid-flight by a replica/shard death hangs until
        # rados_osd_op_timeout
        for op in resend:
            target = self._target_of(op)
            if target != op.target_osd:
                self._send_op(op)
                continue
            try:
                pgid = self._pgid_of(newmap, op)
                if op.pool in oldmap.pools and \
                        oldmap.pg_to_up_acting_osds(pgid) != \
                        newmap.pg_to_up_acting_osds(pgid):
                    self._send_op(op)
            except Exception:
                self._send_op(op)
        # lingers re-register on EVERY new map, even when the target
        # primary is unchanged: any interval change (a replica dying)
        # wipes the PG's volatile watcher registry on that same
        # primary, so "target moved" is not the right trigger
        with self.lock:
            lingers = list(self.lingers.values())
        for op in lingers:
            self._send_op(op)

    # ------------------------------------------------------------------
    # op submission (reference op_submit :2263)
    # ------------------------------------------------------------------
    def submit(self, pool: int, oid: str, ops: List[OSDOp],
               pgid_seed: Optional[int] = None,
               bypass_tier: bool = False,
               trace_id: int = 0,
               snapc: Tuple[int, List[int]] = (0, []),
               snapid: int = 0,
               parent_span_id: int = 0) -> Completion:
        from ..osd.pg import WRITE_OPS
        is_write = any(o.op in WRITE_OPS for o in ops)
        nbytes = sum(len(o.data) for o in ops if o.data)
        with self.lock:
            while self.inflight and (
                    len(self.inflight) >= self._max_inflight
                    or self._inflight_bytes + nbytes
                    > self._max_inflight_bytes):
                self._window.wait(1.0)
            self._next_tid += 1
            tid = self._next_tid
            completion = Completion(self, tid)
            op = _InflightOp(tid, pool, oid, ops, completion,
                             pgid_seed=pgid_seed)
            op.nbytes = nbytes
            op.is_write = is_write
            op.bypass_tier = bypass_tier
            op.trace_id = trace_id
            op.parent_span_id = parent_span_id
            op.snapc = snapc
            op.snapid = snapid
            self.inflight[tid] = op
            self._inflight_bytes += nbytes
        self._send_op(op)
        return completion

    def _route_pool(self, osdmap: OSDMap, op: _InflightOp) -> int:
        """Cache-tier overlay routing (reference Objecter::
        _calc_target honoring pg_pool_t read_tier/write_tier,
        osdc/Objecter.cc:2766): ops on a base pool with an overlay go
        to the tier pool; the tier's PGs promote/serve/flush."""
        pool = osdmap.pools.get(op.pool)
        if pool is None or op.pgid_seed is not None or \
                getattr(op, "bypass_tier", False):
            return op.pool
        if op.is_write:
            return pool.write_tier if pool.write_tier >= 0 else op.pool
        return pool.read_tier if pool.read_tier >= 0 else op.pool

    def _pgid_of(self, osdmap: OSDMap, op: _InflightOp) -> PGid:
        if op.pgid_seed is not None:
            return PGid(op.pool, op.pgid_seed)
        routed = self._route_pool(osdmap, op)
        return osdmap.object_locator_to_pg(op.oid, routed)

    def _target_of(self, op: _InflightOp) -> Optional[int]:
        with self.lock:
            osdmap = self.osdmap
        if op.pool not in osdmap.pools:
            return None
        pgid = self._pgid_of(osdmap, op)
        _, _, _, primary = osdmap.pg_to_up_acting_osds(pgid)
        return primary

    def _send_op(self, op: _InflightOp) -> None:
        with self.lock:
            osdmap = self.osdmap
        if op.pool not in osdmap.pools:
            self._fail_op(op, -2)        # pool gone: ENOENT
            return
        pgid = self._pgid_of(osdmap, op)
        _, _, _, primary = osdmap.pg_to_up_acting_osds(pgid)
        op.target_osd = primary
        op.sent_epoch = osdmap.epoch
        if primary is None:
            # no primary (pool below min_size): hold until a new map
            # (reference: op waits on PG to go active)
            self.log.dout(10, f"tid {op.tid}: no primary for "
                          f"{pgid}, waiting for map")
            return
        addr = osdmap.get_addr(primary)
        if addr is None:
            return
        conn = self.msgr.connect_to(addr, lossless=False)
        with self.lock:
            self._osd_conns[primary] = conn
        m = MOSDOp(
            client=self.msgr.name, tid=op.tid, epoch=osdmap.epoch,
            pool=self._route_pool(osdmap, op), oid=op.oid, ops=op.ops,
            pgid_seed=pgid.seed, trace_id=op.trace_id,
            snap_seq=op.snapc[0], snaps=list(op.snapc[1]),
            snapid=op.snapid, parent_span_id=op.parent_span_id)
        m.stamp_hop("client_send")
        conn.send_message(m)

    def cancel(self, tid: int) -> None:
        """Drop a timed-out/abandoned op from the window (reference
        Objecter::op_cancel).  A reply that already raced in wins."""
        with self.lock:
            self._retire(tid)

    def _retire(self, tid: int) -> None:
        op = self.inflight.pop(tid, None)
        if op is not None:
            self._inflight_bytes -= getattr(op, "nbytes", 0)
            self._window.notify_all()

    def _fail_op(self, op: _InflightOp, result: int) -> None:
        with self.lock:
            self._retire(op.tid)
        op.completion._complete(MOSDOpReply(tid=op.tid, result=result))

    # ------------------------------------------------------------------
    # replies + resets
    # ------------------------------------------------------------------
    def ms_dispatch(self, conn: Connection, msg) -> bool:
        if isinstance(msg, MWatchNotify):
            self._handle_watch_notify(msg)
            return True
        if not isinstance(msg, MOSDOpReply):
            return False
        with self.lock:
            op = self.inflight.get(msg.tid)
            linger = self.lingers.get(msg.tid)
        if op is None:
            if linger is not None:
                if msg.result == EAGAIN_WRONG_PRIMARY:
                    # stale targeting during failover: refresh + retry
                    # — the exact event lingers exist to survive.
                    # Re-check registration at fire time: a ghost
                    # re-send after linger_cancel would re-register a
                    # watch nobody owns
                    self.monc.subscribe_osdmap(msg.epoch)
                    threading.Timer(0.05, self._resend_linger,
                                    args=(linger.tid,)).start()
                elif msg.result < 0:
                    # re-registration REJECTED (object gone): tell the
                    # owner instead of silently losing every notify
                    self._linger_error(linger, msg.result)
            return True                  # late duplicate
        if msg.result == EAGAIN_WRONG_PRIMARY:
            # stale targeting: refresh the map and resend (reference
            # resend-on-new-map); retry after the map catches up
            self.monc.subscribe_osdmap(msg.epoch)
            threading.Timer(0.05, self._send_op, args=(op,)).start()
            return True
        with self.lock:
            self._retire(msg.tid)
        # final hop: the reply carried the op's cumulative ledger back;
        # close it and fold the completed waterfall into the client view
        msg.stamp_hop("client_complete")
        if getattr(op, "is_write", True):
            self.hops.observe_wire(msg.hops)
        else:
            self.hops_read.observe_wire(msg.hops)
        op.completion._complete(msg)
        return True

    def trace_bundle(self) -> dict:
        """Client half of the unified trace surface (the OSD side is
        ``dump_trace``; tools/trace_export.py merges both): recent
        end-to-end MOSDOp ledgers by op class."""
        return {"daemon": "client",
                "ledgers": {"write": self.hops.recent(),
                            "read": self.hops_read.recent()},
                "ops": [], "flight": {}, "reactors": [], "folded": []}

    def linger_submit(self, pool: int, oid: str,
                      ops: List[OSDOp]) -> Tuple[int, Completion]:
        """Submit an op that stays registered (reference
        Objecter::linger_register): re-sent on every map change that
        moves the target and on session reset, so server-side volatile
        registrations (watch) survive failover.  Linger ops must be
        read-class (re-execution is their point)."""
        with self.lock:
            self._next_tid += 1
            tid = self._next_tid
            completion = Completion(self, tid)
            op = _InflightOp(tid, pool, oid, ops, completion)
            self.inflight[tid] = op
            self.lingers[tid] = op
        self._send_op(op)
        return tid, completion

    def linger_cancel(self, linger_id: int) -> None:
        with self.lock:
            self.lingers.pop(linger_id, None)

    def _resend_linger(self, tid: int) -> None:
        with self.lock:
            op = self.lingers.get(tid)
        if op is not None:
            self._send_op(op)

    def _linger_error(self, op: "_InflightOp", result: int) -> None:
        """A linger re-registration was rejected (object deleted, for
        example): drop it and fire the owner's error callback
        (reference watch error callback / rados_watcherrcb_t)."""
        cookie = op.ops[0].offset if op.ops else 0
        with self.lock:
            self.lingers.pop(op.tid, None)
            cbs = self.watch_callbacks.pop(
                (op.pool, op.oid, cookie), None)
        if cbs is not None and getattr(cbs, "on_error", None):
            try:
                cbs.on_error(result)
            except Exception:
                pass

    def ms_handle_reset(self, conn: Connection) -> None:
        """Lossy OSD session died: resend everything targeted at it
        (reference Objecter::ms_handle_reset)."""
        with self.lock:
            dead = [osd for osd, c in self._osd_conns.items()
                    if c is conn]
            for osd in dead:
                del self._osd_conns[osd]
            resend = [op for op in self.inflight.values()
                      if op.target_osd in dead]
            resend += [op for op in self.lingers.values()
                       if op.target_osd in dead
                       and op.tid not in self.inflight]
        for op in resend:
            # the target may be freshly down; refresh then resend
            threading.Timer(0.1, self._send_op, args=(op,)).start()

    def _handle_watch_notify(self, msg: MWatchNotify) -> None:
        """A notify arrived for one of our watches: run the callback
        off the dispatch thread, then ack so the notifier completes
        (reference librados WatchContext + notify_ack)."""
        cb = self.watch_callbacks.get((msg.pool, msg.oid, msg.cookie))
        if cb is None:
            return

        def run():
            try:
                cb(msg.notifier, msg.payload)
            except Exception:
                pass
            # cookie rides in length so the ack names the exact watch
            self.submit(msg.pool, msg.oid, [OSDOp(
                "notify_ack", offset=msg.notify_id,
                length=msg.cookie)])
        threading.Thread(target=run, daemon=True,
                         name="watch-notify-cb").start()

    def wait_for_map(self, timeout: float = 10.0) -> None:
        if not self.map_ready.wait(timeout):
            raise RadosError("no osdmap from monitor")


class IoCtx:
    """Per-pool IO handle (reference librados::IoCtx / IoCtxImpl)."""

    def __init__(self, rados: "Rados", pool_id: int, pool_name: str):
        self.rados = rados
        self.pool_id = pool_id
        self.pool_name = pool_name
        # selfmanaged write SnapContext; None = derive from pool snaps
        # (reference librados snapc handling, IoCtxImpl snapc member)
        self._snapc: Optional[Tuple[int, List[int]]] = None
        # tier-overlay bypass (reference CEPH_OSD_FLAG_IGNORE_OVERLAY):
        # the OSD's internal promote/flush IO must hit the BASE pool
        # directly or it would loop through its own cache redirect
        self._bypass_tier = False
        self._read_snap = 0            # snap_set_read target (0 = head)
        self._watch_lingers: Dict[Tuple[str, int], int] = {}

    # -- internals ---------------------------------------------------------
    def _write_snapc(self) -> Tuple[int, List[int]]:
        """SnapContext for writes: the selfmanaged one when set, else
        the pool's implicit context (pool snaps — reference IoCtxImpl
        uses the pool's snap_seq/snaps unless selfmanaged)."""
        if self._snapc is not None:
            return self._snapc
        with self.rados.objecter.lock:
            pool = self.rados.objecter.osdmap.pools.get(self.pool_id)
        if pool is None or not pool.pool_snaps:
            return (0, [])
        removed = set(pool.removed_snaps)
        live = sorted((s for s in pool.pool_snaps.values()
                       if s not in removed), reverse=True)
        return (pool.snap_seq, live)

    def _obj_op(self, oid: str, ops: List[OSDOp],
                timeout: Optional[float] = None) -> MOSDOpReply:
        timeout = timeout or self.rados.op_timeout
        span = self.rados.tracer.maybe_start("rados_op") \
            if self.rados.tracer else None
        from ..osd.pg import HEAD_PINNED_OPS, WRITE_OPS
        is_write = any(o.op in WRITE_OPS for o in ops)
        head_pinned = any(o.op in HEAD_PINNED_OPS for o in ops)
        c = self.rados.objecter.submit(
            self.pool_id, oid, ops,
            trace_id=span.trace_id if span else 0,
            parent_span_id=span.span_id if span else 0,
            snapc=self._write_snapc() if is_write else (0, []),
            snapid=0 if (is_write or head_pinned)
            else self._read_snap,
            bypass_tier=self._bypass_tier)
        try:
            res = c.wait(timeout)
        finally:
            if span is not None:
                span.tag("oid", oid).tag(
                    "op", "+".join(o.op for o in ops)).finish()
        if res < 0:
            raise RadosError(-res, f"{ops[0].op} {oid!r}: {res}")
        return c.reply

    # -- write class -------------------------------------------------------
    def write_full(self, oid: str, data: bytes) -> None:
        self._obj_op(oid, [OSDOp("writefull", data=data)])

    def write(self, oid: str, data: bytes, offset: int = 0) -> None:
        self._obj_op(oid, [OSDOp("write", offset=offset, data=data)])

    def append(self, oid: str, data: bytes) -> None:
        self._obj_op(oid, [OSDOp("append", data=data)])

    def remove(self, oid: str) -> None:
        self._obj_op(oid, [OSDOp("delete")])

    def truncate(self, oid: str, size: int) -> None:
        self._obj_op(oid, [OSDOp("truncate", offset=size)])

    def create(self, oid: str) -> None:
        self._obj_op(oid, [OSDOp("create")])

    def setxattr(self, oid: str, name: str, value: bytes) -> None:
        self._obj_op(oid, [OSDOp("setxattr", name=name, data=value)])

    def rmxattr(self, oid: str, name: str) -> None:
        self._obj_op(oid, [OSDOp("rmxattr", name=name)])

    def omap_set(self, oid: str, kvs: Dict[str, bytes]) -> None:
        ops = [OSDOp("omap_set", name=k, data=v)
               for k, v in kvs.items()]
        self._obj_op(oid, ops)

    def omap_rm_keys(self, oid: str, keys: List[str]) -> None:
        self._obj_op(oid, [OSDOp("omap_rm", name=k) for k in keys])

    def cache_flush(self, oid: str) -> None:
        """Force a dirty tier object back to the base pool (reference
        CEPH_OSD_OP_CACHE_FLUSH; address the CACHE pool directly)."""
        self._obj_op(oid, [OSDOp("cache_flush")])

    def cache_evict(self, oid: str) -> None:
        """Drop a clean object from the cache tier (reference
        CEPH_OSD_OP_CACHE_EVICT)."""
        self._obj_op(oid, [OSDOp("cache_evict")])

    def exec_cls(self, oid: str, cls: str, method: str,
                 indata: bytes = b"") -> bytes:
        """Run an object-class method (reference rados_exec /
        IoCtx::exec): the handler executes inside the primary OSD
        atomically with the op; -> its output payload."""
        reply = self._obj_op(oid, [OSDOp("call", name=f"{cls}.{method}",
                                         data=indata)])
        return reply.out_data[0] if reply.out_data else b""

    def dup(self) -> "IoCtx":
        """A sibling handle on the same pool with INDEPENDENT snap
        state (snap context / read snap) — librados ioctx duplication
        semantics; cheap (shares the Rados client)."""
        return IoCtx(self.rados, self.pool_id, self.pool_name)

    # -- snapshots (reference librados snap API) ---------------------------
    def set_snap_context(self, seq: int, snaps: List[int]) -> None:
        """Selfmanaged SnapContext for subsequent writes (reference
        rados_ioctx_selfmanaged_snap_set_write_ctx): ``snaps`` newest
        first."""
        self._snapc = (seq, list(snaps))

    def snap_set_read(self, snapid: int) -> None:
        """Subsequent reads observe this snap; 0 = head (reference
        rados_ioctx_snap_set_read)."""
        self._read_snap = snapid

    def selfmanaged_snap_create(self) -> int:
        """Allocate a new snap id from the pool (reference
        rados_ioctx_selfmanaged_snap_create)."""
        ret, rs, out = self.rados.mon_command(
            {"prefix": "osd pool selfmanaged-snap create",
             "pool": self.pool_name})
        if ret != 0:
            raise RadosError(-ret, rs)
        return out["snapid"]

    def selfmanaged_snap_remove(self, snapid: int) -> None:
        """Delete a snap id; OSDs trim its clones (reference
        rados_ioctx_selfmanaged_snap_remove)."""
        ret, rs, _ = self.rados.mon_command(
            {"prefix": "osd pool selfmanaged-snap rm",
             "pool": self.pool_name, "snapid": snapid})
        if ret != 0:
            raise RadosError(-ret, rs)

    def selfmanaged_snap_rollback(self, oid: str, snapid: int) -> None:
        """Roll one object back to its state at ``snapid`` (reference
        rados_ioctx_selfmanaged_snap_rollback)."""
        self._obj_op(oid, [OSDOp("rollback", offset=snapid)])

    def create_snap(self, name: str) -> None:
        """Pool-wide named snapshot (reference rados_ioctx_snap_create
        -> mksnap)."""
        ret, rs, _ = self.rados.mon_command(
            {"prefix": "osd pool mksnap", "pool": self.pool_name,
             "snap": name})
        if ret != 0:
            raise RadosError(-ret, rs)

    def remove_snap(self, name: str) -> None:
        ret, rs, _ = self.rados.mon_command(
            {"prefix": "osd pool rmsnap", "pool": self.pool_name,
             "snap": name})
        if ret != 0:
            raise RadosError(-ret, rs)

    def lookup_snap(self, name: str) -> int:
        with self.rados.objecter.lock:
            pool = self.rados.objecter.osdmap.pools.get(self.pool_id)
        if pool is None or name not in pool.pool_snaps:
            raise RadosError(2, f"no snap {name!r}")
        return pool.pool_snaps[name]

    def list_snaps(self, oid: str) -> Dict:
        """Clone inventory of one object (reference
        rados_ioctx_snap_list / LIST_SNAPS op)."""
        reply = self._obj_op(oid, [OSDOp("list_snaps")])
        return reply.extra["snaps"]

    # -- watch/notify (reference rados_watch3 / rados_notify2) -------------
    def watch(self, oid: str, callback: Callable[[str, bytes], None]
              ) -> int:
        """Register interest in ``oid``: ``callback(notifier_name,
        payload)`` fires on every notify.  -> cookie for unwatch.
        Survives primary failover (lingering registration)."""
        objecter = self.rados.objecter
        with objecter.lock:
            cookie = len(objecter.watch_callbacks) + 1
            while (self.pool_id, oid, cookie) in                     objecter.watch_callbacks:
                cookie += 1
            objecter.watch_callbacks[(self.pool_id, oid, cookie)] =                 callback
        lid, c = objecter.linger_submit(
            self.pool_id, oid, [OSDOp("watch", offset=cookie)])
        res = c.wait(self.rados.op_timeout)
        if res < 0:
            objecter.linger_cancel(lid)
            with objecter.lock:
                objecter.watch_callbacks.pop(
                    (self.pool_id, oid, cookie), None)
            raise RadosError(-res, f"watch {oid!r}: {res}")
        self._watch_lingers[(oid, cookie)] = lid
        return cookie

    def unwatch(self, oid: str, cookie: int) -> None:
        objecter = self.rados.objecter
        lid = self._watch_lingers.pop((oid, cookie), None)
        if lid is not None:
            objecter.linger_cancel(lid)
        with objecter.lock:
            objecter.watch_callbacks.pop(
                (self.pool_id, oid, cookie), None)
        self._obj_op(oid, [OSDOp("unwatch", offset=cookie)])

    def notify(self, oid: str, payload: bytes = b"",
               timeout_ms: int = 5000) -> Dict:
        """Notify every watcher; blocks until all acked or timeout.
        -> {"acks": [client names], "timed_out": [...]}."""
        reply = self._obj_op(
            oid, [OSDOp("notify", offset=timeout_ms, data=payload)],
            timeout=timeout_ms / 1000.0 + self.rados.op_timeout)
        return {"acks": reply.extra.get("acks", []),
                "timed_out": reply.extra.get("timed_out", [])}

    def list_watchers(self, oid: str) -> List[str]:
        reply = self._obj_op(oid, [OSDOp("list_watchers")])
        return reply.extra.get("watchers", [])

    # -- read class --------------------------------------------------------
    def read(self, oid: str, length: int = 0, offset: int = 0) -> bytes:
        reply = self._obj_op(
            oid, [OSDOp("read", offset=offset, length=length)])
        return reply.out_data[0]

    def stat(self, oid: str) -> Tuple[int, Tuple[int, int]]:
        """-> (size, version)."""
        reply = self._obj_op(oid, [OSDOp("stat")])
        return reply.extra["size"], tuple(reply.extra["version"])

    def getxattr(self, oid: str, name: str) -> bytes:
        reply = self._obj_op(oid, [OSDOp("getxattr", name=name)])
        return reply.out_data[0]

    def getxattrs(self, oid: str) -> Dict[str, bytes]:
        reply = self._obj_op(oid, [OSDOp("getxattrs")])
        return {k: v.encode("latin1")
                for k, v in reply.extra["xattrs"].items()}

    def omap_get_by_key(self, oid: str, key: str) -> Optional[bytes]:
        """Single omap entry, None when absent (reference
        omap_get_vals_by_keys) — O(entry), not O(index)."""
        try:
            reply = self._obj_op(oid, [OSDOp("omap_get_by_key",
                                             name=key)])
        except RadosError as e:
            if e.errno == 61:            # ENODATA: key absent
                return None
            raise
        return reply.out_data[0] if reply.out_data else None

    def copy_from(self, dst_oid: str, src_oid: str) -> None:
        """Server-side object copy (reference CEPH_OSD_OP_COPY_FROM,
        librados copy_from): the destination's primary fetches the
        source — data, user xattrs and (replicated) omap — with no
        client round trip for the payload."""
        self._obj_op(dst_oid, [OSDOp("copy_from", name=src_oid)])

    def omap_get(self, oid: str) -> Dict[str, bytes]:
        reply = self._obj_op(oid, [OSDOp("omap_get")])
        return {k: v.encode("latin1")
                for k, v in reply.extra["omap"].items()}

    def list_objects(self) -> List[str]:
        """Pool listing = pgls across every PG (reference
        librados nobjects_begin -> per-PG pgls)."""
        with self.rados.objecter.lock:
            osdmap = self.rados.objecter.osdmap
        pool = osdmap.pools.get(self.pool_id)
        if pool is None:
            raise RadosError(2, "pool is gone")
        out: List[str] = []
        for pgid in osdmap.pgs_for_pool(self.pool_id):
            c = self.rados.objecter.submit(
                self.pool_id, f".pgls.{pgid.seed}", [OSDOp("pgls")],
                pgid_seed=pgid.seed)
            res = c.wait(self.rados.op_timeout)
            if res < 0:
                raise RadosError(-res, f"pgls {pgid}: {res}")
            out.extend(c.reply.extra.get("objects", []))
        return sorted(set(out))

    # -- async forms (reference aio_*) -------------------------------------
    def aio_write_full(self, oid: str, data: bytes) -> Completion:
        return self.rados.objecter.submit(
            self.pool_id, oid, [OSDOp("writefull", data=data)],
            snapc=self._write_snapc())

    def aio_write(self, oid: str, data: bytes,
                  offset: int = 0) -> Completion:
        return self.rados.objecter.submit(
            self.pool_id, oid,
            [OSDOp("write", offset=offset, data=data)],
            snapc=self._write_snapc())

    def aio_read(self, oid: str, length: int = 0,
                 offset: int = 0) -> Completion:
        return self.rados.objecter.submit(
            self.pool_id, oid,
            [OSDOp("read", offset=offset, length=length)],
            snapid=self._read_snap)


class Rados:
    """Cluster handle (reference librados::Rados / RadosClient).

    The client id MUST be globally unique: PG-log dup detection keys
    on (client_name, tid), so two processes both named "client.1"
    issuing tid 2 would have the second's write silently swallowed as
    a resend of the first's — an acknowledged lost write.  The
    reference gets a mon-assigned global_id at authentication; here a
    random 48-bit id makes collisions negligible without a round
    trip."""

    def __init__(self, mon_addr: Tuple[str, int],
                 conf: Optional[Config] = None,
                 op_timeout: Optional[float] = None):
        import secrets
        n = secrets.randbits(48)
        self.conf = conf or default_config()
        if op_timeout is None:
            # reference rados_osd_op_timeout (now defaulting nonzero);
            # an explicit 0 would mean wait-forever — a hang in tests,
            # so it still falls back to the library default
            op_timeout = self.conf["rados_osd_op_timeout"] or 30.0
        self.op_timeout = op_timeout
        self.tracer = None
        if self.conf["rados_tracing"]:
            from ..utils.tracer import Tracer
            self.tracer = Tracer(
                "client", enabled=True,
                sample_every=self.conf["trace_sample_every"],
                keep=self.conf["trace_keep_spans"])
        self.msgr = Messenger(f"client.{n}", conf=self.conf)
        self.monc = MonClient(self.msgr, mon_addr,
                              map_cb=self._on_map)
        self.objecter = Objecter(self.msgr, self.monc, self.conf)

    def _on_map(self, wire: dict) -> None:
        self.objecter.handle_osdmap(wire)

    # ------------------------------------------------------------------
    def connect(self, timeout: float = 10.0) -> "Rados":
        self.msgr.start()
        self.monc.subscribe_osdmap()
        self.objecter.wait_for_map(timeout)
        return self

    def shutdown(self) -> None:
        self.msgr.shutdown()

    def __enter__(self) -> "Rados":
        return self.connect()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ------------------------------------------------------------------
    def mon_command(self, cmd: dict,
                    timeout: Optional[float] = None
                    ) -> Tuple[int, str, dict]:
        if timeout is None:              # reference rados_mon_op_timeout
            timeout = self.conf["rados_mon_op_timeout"]
        return self.monc.command(cmd, timeout)

    def open_ioctx(self, pool_name: str) -> IoCtx:
        with self.objecter.lock:
            pool = self.objecter.osdmap.get_pool(pool_name)
        if pool is None:
            # the pool may be newer than our map: refresh once
            self.monc.subscribe_osdmap(self.objecter.osdmap.epoch + 1)
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                with self.objecter.lock:
                    pool = self.objecter.osdmap.get_pool(pool_name)
                if pool is not None:
                    break
                time.sleep(0.05)
        if pool is None:
            raise RadosError(2, f"no pool {pool_name!r}")
        return IoCtx(self, pool.pool_id, pool_name)

    def wait_for_epoch(self, epoch: int, timeout: float = 10.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self.objecter.lock:
                if self.objecter.osdmap.epoch >= epoch:
                    return
            time.sleep(0.02)
        raise RadosError(110, f"epoch {epoch} not reached")
