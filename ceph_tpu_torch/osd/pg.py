"""Placement-group state machine: op execution, peering, recovery.

Python-native equivalent of the reference's PG / PrimaryLogPG /
PeeringState stack (reference src/osd/PG.cc, PrimaryLogPG.cc 15.5k LoC,
PeeringState.{h,cc} boost::statechart) reduced to the states the
framework drives:

* **op execution** (primary): ``do_request`` -> ``do_op`` -> the op
  switch (reference PrimaryLogPG::do_osd_ops' giant switch, :5737) —
  write-class ops lower to one logical ``Mutation`` and go through
  ``backend.submit_transaction`` with a PG-log entry (reference
  issue_repop, :10650); read-class ops run against the backend
  (EC reads reconstruct asynchronously);
* **peering** (reference PeeringState): on every map interval change
  the primary Queries the acting set, members Notify with their
  bounded full log, the primary picks the authoritative log (best
  last_update), adopts it if behind, computes per-shard missing sets
  and Activates everyone with catch-up entries — or a ``backfill``
  object list when a shard's log no longer overlaps (reference
  GetInfo/GetLog/GetMissing/Activate collapsed to one round trip);
* **recovery** (primary): ``start_recovery_ops(budget)`` drains the
  union of missing sets through ``backend.recover_object`` (reference
  PrimaryLogPG::start_recovery_ops / recover_primary + recover_
  replicas), prioritizing objects client ops are blocked on
  (``waiting_for_degraded``, the reference's wait_for_degraded_object);
* EC pools reject omap and truncate unless ``ec_overwrites``
  (reference pg_pool_t::allows_ecoverwrites, osd_types.h:1600).

Degraded writes block until the object recovers, as the reference does
(PrimaryLogPG::wait_for_degraded_object), keeping all acting shards
write-consistent.

Locking: one RLock per PG serializes every entry point (the
reference's PG lock); store-commit callbacks re-enter through
``on_local_commit`` which takes the lock.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..msg.messages import (MOSDOp, MOSDOpReply, MOSDPGLog, MOSDPGNotify,
                            MOSDPGQuery, MOSDPGRemove, OSDOp)
from ..store.objectstore import GHObject, Transaction
from ..utils.log import Dout
from .backend import OI_ATTR, Mutation, ObjectInfo, build_pg_backend
from .ecbackend import ECBackend
from .osdmap import OSDMap, PGPool, PGid, POOL_TYPE_ERASURE
from .pglog import (DELETE, MODIFY, Eversion, LogEntry, MissingSet,
                    PGLog)

PGMETA_OID = "_pgmeta"          # reference pgmeta_oid
LOG_KEY_PREFIX = "log."
INFO_KEY = "info"
SPLIT_KEY = "split_pgnum"       # pool pg_num this PG last split at
STRAY_SHARD_KEY = "stray_shard"  # EC shard identity kept while stray
SPLIT_SRC_KEY = "split_src"     # parent shard whose chunks we hold
MERGE_SRC_KEY = "merge_srcs"    # all child shards a merge folded here
SPLIT_ADOPTED_KEY = "split_adopted"  # a local parent split fed us
MISSING_KEY = "missing"         # persisted pg_missing_t (reference
                                # PGLog write_log_and_missing)

STATE_INACTIVE = "inactive"
STATE_PEERING = "peering"
STATE_ACTIVE = "active"

WRITE_OPS = {"write", "writefull", "append", "create", "delete",
             "truncate", "setxattr", "rmxattr", "rmxattrs",
             "omap_set", "omap_rm",
             "omap_clear", "call", "rollback", "copy_from",
             "cache_flush", "cache_evict"}
READ_OPS = {"read", "stat", "getxattr", "getxattrs", "omap_get",
            "omap_get_by_key", "pgls", "list_snaps",
            "watch", "unwatch", "notify", "notify_ack",
            "list_watchers"}
# read-class ops that always address the HEAD (never snap-resolved
# even while the client holds a read snap)
HEAD_PINNED_OPS = {"watch", "unwatch", "notify", "notify_ack",
                   "list_watchers", "list_snaps", "pgls"}


class PG:
    """One placement group as hosted by one OSD (primary or replica
    shard).  ``service`` is the hosting OSD's service surface (see
    osd.OSDService): whoami, conf, store, send_osd, get_osdmap."""

    def __init__(self, service, pgid: PGid, pool: PGPool):
        self.service = service
        self.pgid = pgid
        self.pool = pool
        # PG lock with contention telemetry when the host provides a
        # sink (utils/locks.py); bare hosts in unit tests fall back to
        # an untimed lockdep lock
        from ..utils.locks import TimedLock
        self.lock = TimedLock("pg_lock",
                              stats=getattr(service, "contention", None))
        # shard-per-core (crimson): the reactor shard that owns this
        # PG's state — every client op, sub-op and recovery item for
        # the PG executes there (hash(pgid) % n_reactors), so the
        # lock above is uncontended on the data path.  None on the
        # classic backend.
        self.home_shard: Optional[int] = None
        self.state = STATE_INACTIVE
        self.up: List[Optional[int]] = []
        self.acting: List[Optional[int]] = []
        self.primary_osd: Optional[int] = None
        self.interval_start = 0          # epoch of last acting change
        try:                             # reference osd_max_pg_log_entries
            max_entries = service.conf["osd_max_pg_log_entries"]
        except (AttributeError, KeyError):
            max_entries = PGLog.DEFAULT_MAX_ENTRIES
        self.log = PGLog(max_entries)
        self.missing = MissingSet()      # objects THIS shard lacks
        self.peer_missing: Dict[int, MissingSet] = {}
        self._peer_notifies: Dict[int, dict] = {}
        self.waiting_for_active: deque = deque()
        # backend sub-ops that raced our map: an EC shard message
        # arriving before this OSD's map places it in the acting set
        # has no home shard collection yet (own_shard -1) — applying
        # it would write to a collection that does not exist.  Queued
        # until advance_map assigns the shard (reference: op queue
        # waits on waiting_for_map / waiting_peering)
        self.waiting_for_shard: deque = deque()
        self.waiting_for_degraded: Dict[str, deque] = {}
        # per-object write tracking at the PG level (oid -> in-flight
        # count).  Most write classes serialize per object so size-
        # dependent logic (appends, snapshots) can't go stale; plain
        # partial overwrites on EC-overwrites pools PIPELINE instead —
        # the backend's extent overlay (ExtentCache) keeps their RMW
        # reads coherent
        self.inflight_writes: Dict[str, int] = {}
        # oid -> newest in-flight version (prior_version chaining for
        # pipelined writes); dropped when the object settles
        self._pending_versions: Dict[str, Eversion] = {}
        self.waiting_for_obj: Dict[str, deque] = {}
        self.waiting_for_scrub: deque = deque()
        # recent committed-op outputs for dup-resend replay (class
        # call payloads); insertion-ordered, bounded
        self._reply_cache: Dict[Tuple[str, int], List[bytes]] = {}
        # every client op this PG currently holds, by reqid; on an
        # interval change they all bounce back to the client for
        # re-targeting (reference on_change requeue + client resend)
        self._client_ops: Dict[Tuple[str, int], Tuple] = {}
        self._last_assigned: Eversion = (0, 0)
        # oid -> start time; recovery sub-ops can be dropped by peers
        # that raced a map epoch, so stale entries are requeued by the
        # OSD tick (the reference retries via peering-event machinery)
        self.recovering: Dict[str, float] = {}
        # cache tiering (reference PrimaryLogPG cache machinery,
        # PrimaryLogPG.cc:2700 maybe_handle_cache_detail): in-flight
        # promotes (oid -> parked (msg, conn) waiters), objects being
        # flushed to the base pool, and observability counters
        self._promoting: Dict[str, List[Tuple]] = {}
        self._flushing: Set[str] = set()
        self._evicting: Set[str] = set()
        self._base_deleting: Set[str] = set()
        self.cache_promotes = 0
        self.cache_flushes = 0
        self.cache_evicts = 0
        # watch/notify (reference osd/Watch.cc): primary-side watcher
        # registry, volatile — clients re-register through lingering
        # ops on every map change, so failover self-heals
        self.watchers: Dict[str, Dict[Tuple[str, int], object]] = {}
        self._notifies: Dict[int, Dict] = {}
        self._next_notify_id = 0
        # -- PG split (reference OSD::split_pgs, osd/OSD.cc:8926) ------
        # pool pg_num this PG has split to; growth beyond it triggers
        # maybe_split().  Fresh PGs start current; the persisted value
        # (pgmeta) wins on restart so growth-while-down still splits.
        self._last_split_pgnum = pool.created_pg_num or pool.pg_num
        # stray side (we hold data for a PG whose acting set excludes
        # us — split children start life this way on the parent's
        # holders; the reference's past_intervals machinery is replaced
        # by strays announcing themselves to the current primary):
        self._stray_shard = -1       # EC shard identity we held
        # EC split: the parent shard whose physical chunks this copy
        # holds.  EC positions are NOT interchangeable (reference
        # ecbackend.rst "Distinguished acting set positions"): a child
        # acting member may hold parent-shard-s chunks while being
        # assigned position j != s — its position data is then MISSING
        # (audited on activation) while its s-chunks serve as a
        # recovery source.
        self._split_source_shard = -1
        # EC merge: ALL distinct child shards whose chunks a merge
        # folded into our collections (a parent may absorb several
        # children, each at a different position).  Every one is
        # audited at merge time and re-audited on interval change
        # until recovery homes our own position's chunks.
        self._merge_source_shards: List[int] = []
        # True once a local parent split adopted this copy: its content
        # (even empty) is the ancestry's authoritative answer for this
        # child seed
        self._split_adopted = False
        # primary side: stray notifies (osd -> notify payload) and the
        # object sets they can serve as recovery sources
        self._stray_notifies: Dict[int, dict] = {}
        self._stray_sources: Dict[int, Dict[str, Eversion]] = {}
        self.backend = build_pg_backend(self, pool, service.ec_registry)
        from .scrub import Scrubber
        self.scrubber = Scrubber(self)
        self._ensure_collections()
        self._load_pgmeta()

    # ------------------------------------------------------------------
    # PGHost surface (consumed by the backend)
    # ------------------------------------------------------------------
    @property
    def whoami(self) -> int:
        return self.service.whoami

    @property
    def pgid_str(self) -> str:
        return str(self.pgid)

    @property
    def own_shard(self) -> int:
        if not self.pool.is_erasure():
            return -1
        for i, osd in enumerate(self.acting):
            if osd == self.whoami:
                return i
        # a split/migration stray keeps serving the shard it held when
        # it left the acting set (collection + read identity)
        return self._stray_shard

    @property
    def store(self):
        return self.service.store

    @property
    def conf(self):
        return self.service.conf

    @property
    def epoch(self) -> int:
        return self.service.get_osdmap().epoch

    def coll_of(self, shard: int) -> str:
        if shard < 0:
            return str(self.pgid)
        return f"{self.pgid}s{shard}"

    @property
    def coll(self) -> str:
        return self.coll_of(self.own_shard)

    def acting_shards(self) -> List[Tuple[int, Optional[int]]]:
        return list(enumerate(self.acting))

    def send_shard(self, osd: int, msg) -> None:
        self.service.send_osd(osd, msg)

    def observe_hops(self, hops, kind: str = "write") -> None:
        """Fold a completed sub-op round-trip ledger into this OSD's
        hops accumulator for the given op class — "write" (sub-write
        round trips), "read" (client-facing shard reads) or "recovery"
        (pushes/pulls, recovery reads, decode/scrub windows).  Bare
        test hosts have no accumulators."""
        attr = {"read": "hops_read",
                "recovery": "hops_recovery"}.get(kind, "hops")
        acc = getattr(self.service, attr, None)
        if acc is not None:
            acc.observe_wire(hops)

    def prepare_log_txn(self, txn: Transaction,
                        log_entries: List[dict]) -> None:
        """Persist log entries + info into the pgmeta object's omap in
        the same transaction as the data (reference: pgmeta omap)."""
        for e in log_entries:
            entry = LogEntry.from_dict(e)
            if entry.version > self.log.last_update:
                self.log.add(entry)
        self._append_pgmeta_ops(txn)

    def on_local_commit(self, fn: Callable[[], None]) -> None:
        with self.lock:
            fn()

    @property
    def encode_batcher(self):
        """The OSD-wide cross-op encode coalescer (osd/batcher.py);
        None under hosts without one (unit-test stubs) — the backend
        then encodes synchronously."""
        return getattr(self.service, "encode_batcher", None)

    def ec_profile(self) -> Dict[str, str]:
        prof = self.service.get_osdmap().erasure_code_profiles.get(
            self.pool.erasure_code_profile)
        return dict(prof or {"plugin": "jerasure", "k": "2", "m": "1"})

    def trace_span(self, name: str, trace_id: int,
                   parent_id: int = 0):
        tracer = getattr(self.service, "tracer", None)
        if tracer is None:
            return None
        return tracer.start(name, trace_id, parent_id)

    @property
    def osd_perf(self):
        """The hosting OSD's perf counters (None under test stubs)."""
        return getattr(self.service, "perf", None)

    @property
    def flight_recorder(self):
        """The hosting OSD's flight recorder (None under test
        stubs) — backends note routing/fault events into it."""
        return getattr(self.service, "flight_recorder", None)

    def call_later(self, delay: float, fn):
        """One-shot cancellable timer via the hosting OSD (EC
        sub-write deadlines); None under hosts without timers."""
        call = getattr(self.service, "call_later", None)
        if call is None:
            return None
        return call(delay, fn)

    def report_laggard(self, osd: int, elapsed: float) -> None:
        """Report a peer that sat on a sub-write past its deadline."""
        rep = getattr(self.service, "report_laggard", None)
        if rep is not None:
            rep(osd, elapsed)

    def note_object_recovered(self, oid: str, version) -> None:
        """A recovery push committed on THIS shard: durable missing-set
        update (reference recover_got)."""
        with self.lock:
            if self.missing.is_missing(oid):
                self.missing.got(oid, tuple(version))
                self._persist_pgmeta()

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def _meta_obj(self) -> GHObject:
        return GHObject(PGMETA_OID, self.own_shard)

    def _ensure_collections(self) -> None:
        """Create this OSD's collection(s) for the PG.  EC shards are
        positional so the collection is created lazily per interval;
        all possible shard collections are created up front so a
        position change never races transaction application."""
        txn = Transaction()
        made = False
        if self.pool.is_erasure():
            for s in range(self.pool.size):
                if not self.store.collection_exists(self.coll_of(s)):
                    txn.create_collection(self.coll_of(s))
                    made = True
        else:
            if not self.store.collection_exists(self.coll_of(-1)):
                txn.create_collection(self.coll_of(-1))
                made = True
        if made:
            self.store.queue_transactions([txn], op="pg_create")

    def _append_pgmeta_ops(self, txn: Transaction) -> None:
        import json as _json
        kvs = {INFO_KEY: self.log.encode(),
               MISSING_KEY: _json.dumps(
                   self.missing.to_dict()).encode(),
               SPLIT_KEY: str(self._last_split_pgnum).encode(),
               STRAY_SHARD_KEY: str(self._stray_shard).encode(),
               SPLIT_SRC_KEY: str(self._split_source_shard).encode(),
               MERGE_SRC_KEY: _json.dumps(
                   self._merge_source_shards).encode(),
               SPLIT_ADOPTED_KEY:
                   (b"1" if self._split_adopted else b"0")}
        txn.omap_setkeys(self.coll, self._meta_obj(), kvs)

    def _persist_pgmeta(self) -> None:
        if self.pool.is_erasure() and self.own_shard < 0:
            return    # not in the acting set (late completion after an
                      # interval change): no home shard to persist to
        txn = Transaction()
        self._append_pgmeta_ops(txn)
        self.store.queue_transactions([txn], op="pgmeta")

    def _load_pgmeta(self) -> None:
        """Restart is resume (reference OSD::init loads PGs from disk):
        the log (and through it last_update) and the persistent missing
        set come back from omap — a shard that adopted log entries but
        never finished recovering them must still know it lacks the
        data (reference PGLog::read_log_and_missing)."""
        import json as _json
        for s in ([self.own_shard] if not self.pool.is_erasure()
                  else range(self.pool.size)):
            coll = self.coll_of(s if self.pool.is_erasure() else -1)
            obj = GHObject(PGMETA_OID, s if self.pool.is_erasure() else -1)
            try:
                omap = self.store.omap_get(coll, obj)
            except FileNotFoundError:
                continue
            data = omap.get(INFO_KEY)
            if data:
                log = PGLog.decode(data)
                if log.last_update > self.log.last_update:
                    self.log = log
                    raw = omap.get(MISSING_KEY)
                    if raw:
                        self.missing = MissingSet.from_dict(
                            _json.loads(raw.decode()))
            raw = omap.get(SPLIT_KEY)
            if raw:                  # persisted split anchor wins: a
                self._last_split_pgnum = int(raw)  # restart must still
            raw = omap.get(STRAY_SHARD_KEY)        # split past growth
            if raw and int(raw) >= 0:
                self._stray_shard = int(raw)
            raw = omap.get(SPLIT_SRC_KEY)
            if raw and int(raw) >= 0:
                self._split_source_shard = int(raw)
            raw = omap.get(MERGE_SRC_KEY)
            if raw:
                merged = _json.loads(raw.decode())
                if merged:
                    self._merge_source_shards = sorted(
                        set(self._merge_source_shards) | set(merged))
            raw = omap.get(SPLIT_ADOPTED_KEY)
            if raw == b"1":
                self._split_adopted = True

    # ------------------------------------------------------------------
    # PG split (reference OSDMonitor pg_num pool-set -> OSD::split_pgs,
    # osd/OSD.cc:8926, PG.cc split_colls / PGLog::split_out_child)
    # ------------------------------------------------------------------
    def maybe_split(self, osdmap: OSDMap) -> None:
        """If the pool's pg_num grew past our split anchor, rehash our
        objects into the child PGs this seed feeds (created locally
        even when we are not in a child's acting set — such children
        are split STRAYS that announce themselves to the child's
        primary and serve as recovery sources until purged).

        Runs on every replica independently; all replicas move the
        same oids and produce identical child logs (split_out keeps
        head/tail), so child peering elections are trivial.  Idempotent
        and anchored on the persisted split pg_num, so growth while an
        OSD was down still splits on restart."""
        pool = osdmap.get_pool(self.pgid.pool)
        if pool is None:
            return
        new = pool.pg_num
        with self.lock:
            old = self._last_split_pgnum
            if new < old:
                # a merge shrank the pool under us: follow the anchor
                # down (every OSD, child-holder or not) so future
                # growth re-splits from the new baseline
                self._last_split_pgnum = old = new
                self._persist_pgmeta()
            if new <= old:
                return
            if self.pgid.seed >= old:
                # we ARE a child of this growth (or fresh): just move
                # the anchor forward
                self._last_split_pgnum = new
                self._persist_pgmeta()
                return
            from .osdmap import pg_split_children
            children = pg_split_children(self.pgid.seed, old, new)
        # create the children OUTSIDE our lock (ensure_pg may take
        # other PG locks — no pg->pg nesting); their collections must
        # exist before the move transaction below lands
        child_pgs = []
        for c in children:
            child = self.service.ensure_pg(PGid(self.pgid.pool, c))
            if child is not None:
                child_pgs.append((c, child))
        with self.lock:
            if self._last_split_pgnum != old:
                return               # raced a concurrent map advance

            def rehash(oid: str) -> int:
                # snapshot clones ride with their head, matching
                # client targeting (head/clone colocation invariant)
                return osdmap.object_locator_to_pg(
                    oid.split("@", 1)[0], self.pgid.pool).seed

            moves: Dict[int, List[str]] = {}
            for oid in self.backend.list_objects():
                if oid == PGMETA_OID:
                    continue
                target = rehash(oid)
                if target != self.pgid.seed:
                    moves.setdefault(target, []).append(oid)
            # snapshot BEFORE the destructive in-place work below
            # (split_out strips log entries/reqids, missing.rm drops
            # tracking): if the move txn fails — e.g. a replica-op
            # delete raced the object listing — EVERYTHING rolls back
            # so the next map advance retries the split instead of
            # stranding parent data with a half-stripped log
            import copy
            log_snapshot = copy.deepcopy(self.log)
            missing_snapshot = copy.deepcopy(self.missing)
            prev_adopted = self._split_adopted
            # split the LOG by rehash too (covers deleted/missing oids
            # that no longer exist as store objects)
            entry_moves: Dict[int, set] = {c: set() for c in children}
            for e in self.log.entries:
                t = rehash(e.oid)
                if t != self.pgid.seed and t in entry_moves:
                    entry_moves[t].add(e.oid)
            child_logs = {c: self.log.split_out(entry_moves[c])
                          for c in children}
            # child missing entries follow their objects
            child_missing: Dict[int, Dict[str, tuple]] = {}
            for oid in list(self.missing.items.keys()):
                target = rehash(oid)
                if target != self.pgid.seed:
                    need, have = self.missing.items[oid]
                    child_missing.setdefault(target, {})[oid] = (need,
                                                                 have)
                    self.missing.rm(oid)
            shard = self.own_shard
            my_head = self.log.last_update
            self._last_split_pgnum = new
            self._split_adopted = True   # we answered our own split
            txn = Transaction()
            for c, oids in moves.items():
                ccoll = self._child_coll(c, shard)
                for oid in oids:
                    txn.collection_move_rename(
                        self.coll, GHObject(oid, shard),
                        ccoll, GHObject(oid, shard))
            self._append_pgmeta_ops(txn)
            # apply UNDER the lock: no client write can interleave
            # between the in-memory split and its durable txn, so the
            # rollback above can never clobber a concurrent append
            try:
                self.store.queue_transactions([txn], op="pg_split")
            except Exception as e:
                self.log = log_snapshot
                self.missing = missing_snapshot
                self._last_split_pgnum = old
                self._split_adopted = prev_adopted
                Dout("osd").dwarn(
                    "pg %s split %d->%d move txn failed (%r); split "
                    "state rolled back, will retry on next map "
                    "advance", self.pgid, old, new, e)
                return
        for c, child in child_pgs:
            child.adopt_split(my_head, child_logs.get(c),
                              child_missing.get(c, {}), new, shard)

    def _child_coll(self, seed: int, shard: int) -> str:
        base = f"{self.pgid.pool}.{seed:x}"
        return base if shard < 0 else f"{base}s{shard}"

    def adopt_split(self, parent_head, child_log, missing: Dict,
                    split_pgnum: int, parent_shard: int) -> None:
        """Child side of maybe_split (same OSD): adopt the parent's
        log head (and its entries for our objects), inherit missing
        entries for objects the parent shard itself lacked, and record
        the shard identity in case we are a stray here."""
        with self.lock:
            if child_log is not None and \
                    child_log.last_update > self.log.last_update:
                self.log = child_log
            elif parent_head > self.log.last_update:
                self.log = PGLog.from_dict(
                    {"last_update": list(parent_head),
                     "tail": list(parent_head), "entries": []})
            for oid, (need, have) in missing.items():
                self.missing.add(oid, tuple(need),
                                 tuple(have) if have else None)
            self._last_split_pgnum = max(self._last_split_pgnum,
                                         split_pgnum)
            self._split_adopted = True
            if parent_shard >= 0:
                self._split_source_shard = parent_shard
            if self.whoami not in [o for o in self.acting
                                   if o is not None]:
                self._stray_shard = parent_shard
            self._persist_pgmeta()

    def adopt_merge(self, child_log, child_missing,
                    merge_pgnum: int,
                    merged_locs: Optional[Dict[str, int]] = None,
                    merge_epoch: int = 0) -> None:
        """Parent side of a PG merge (reference PG::merge_from): the
        child's objects were just folded into our collection by the
        OSD.  The child's log entries are REBASED onto our log with
        fresh versions — deterministically (same child log + same
        parent head on every holder), so merging replicas produce an
        identical advanced log and ordinary peering/catch-up teaches
        everyone else: a parent holder with no child collection (e.g.
        the new primary) sees a peer with a newer head, elects its
        log, and log-recovers the merged objects."""
        with self.lock:
            # the rebase epoch is pinned to the epoch the POOL shrank
            # (passed from the map that carries the shrink — the PG's
            # own pool snapshot may be stale here): every holder uses
            # the same value no matter when it merges, so a late
            # merger (down during the shrink) produces versions BEHIND
            # the cluster's and gets corrected by catch-up instead of
            # overriding fresher state
            merge_epoch = merge_epoch or self.pool.pg_num_epoch \
                or self.epoch
            acting_here = self.whoami in [o for o in self.acting
                                          if o is not None]
            stray_here = not acting_here
            if stray_here:
                # a NON-acting holder must not rebase the child log
                # into its (possibly empty) parent log: a fresh PG's
                # (0,0) base would yield a high-epoch head carrying
                # ONLY the child's history, win the next election, and
                # backfill everyone else DOWN to two objects.  A stray
                # just serves its folded data (stray sources).
                child_log = None
            seq = max(self.log.last_update[1],
                      self._last_assigned[1])
            if child_log is not None:
                for e in child_log.entries:
                    seq += 1
                    v = (merge_epoch, seq)
                    ne = LogEntry(e.op, e.oid, v,
                                  prior_version=(0, 0),
                                  reqid=e.reqid)
                    self.log.entries.append(ne)
                    if e.reqid is not None:
                        self.log.reqids[e.reqid] = v
                if child_log.entries:
                    self.log.last_update = (merge_epoch, seq)
                    self._last_assigned = (merge_epoch, seq)
                # reqids of entries the child already trimmed still
                # guard against very old client resends
                for reqid, ver in child_log.reqids.items():
                    self.log.reqids.setdefault(reqid, ver)
            if child_missing is not None:
                for oid, (need, have) in child_missing.items.items():
                    self.missing.add(oid, tuple(need),
                                     tuple(have) if have else None)
            self._last_split_pgnum = min(self._last_split_pgnum,
                                         merge_pgnum)
            merged_locs = merged_locs or {}
            shards = {s for s in merged_locs.values() if s >= 0}
            if stray_here and merged_locs:
                # we hold merged data without being in the parent's
                # acting set: serve as a stray source until purged
                # (same machinery as split strays; for EC the folded
                # chunks keep their CHILD shard identity)
                if shards:
                    self._stray_shard = sorted(shards)[0]
            elif shards:
                # EC acting member: a merge may fold chunks from
                # SEVERAL children, each at its own CHILD acting
                # position.  Any position other than ours means our
                # position data is missing until recovery
                # reconstructs it, while each folded shard serves as
                # a shard-qualified recovery source — the split audit
                # machinery in reverse (reference merge_from + the
                # distinguished-position rule of ecbackend.rst; chunk
                # bytes are portable between PGs because shard s of
                # an object encodes identically wherever it is
                # placed).  Audit once per DISTINCT folded shard —
                # including one that equals own_shard (its audit is
                # the own-position existence check) — so mispositioned
                # chunks are caught now, not deferred to scrub.
                self._merge_source_shards = sorted(
                    set(self._merge_source_shards) | shards)
                foreign = [s for s in sorted(shards)
                           if s != self.own_shard]
                if foreign:
                    self._split_source_shard = foreign[0]
                osdmap_now = self.service.get_osdmap()
                for s in sorted(shards):
                    self._audit_split_shard(osdmap_now, src=s)
            self._persist_pgmeta()
            if self.is_primary():
                # our log advanced: re-peer so activation pushes the
                # rebased entries to every member (they mark missing
                # and recovery fills them in)
                self.state = STATE_PEERING
                self._peer_notifies.clear()
                self._start_peering()
            else:
                # tell the primary we are ahead: the stray-notify
                # ACTIVE path re-peers when our head outruns its log
                self._merge_notify_pending = True

    def maybe_announce_merge(self, osdmap: OSDMap) -> None:
        """Acting member after a merge: announce our advanced log to
        the primary (the stray-notify handler's head comparison
        triggers its re-peer).  Called from map advance + the OSD
        tick until sent."""
        with self.lock:
            if not getattr(self, "_merge_notify_pending", False):
                return
            _, _, acting, primary = osdmap.pg_to_up_acting_osds(
                self.pgid)
            if primary is None or primary == self.whoami:
                self._merge_notify_pending = False
                return
            auth = self._authoritative_objects()
            objects = {oid: list(auth.get(oid, (0, 0)))
                       for oid in self.backend.list_objects()
                       if oid != PGMETA_OID}
            msg = MOSDPGNotify(
                pgid=str(self.pgid), shard=self.own_shard,
                from_osd=self.whoami,
                epoch=osdmap.epoch, log=self.log.to_dict(),
                missing=self.missing.to_dict(), stray=True,
                objects=objects,
                stray_shard=self._stray_shard
                if self._stray_shard >= 0 else self.own_shard,
                split_adopted=self._split_adopted)
            self._merge_notify_pending = False
        self.service.send_osd(primary, msg)

    # -- stray side ----------------------------------------------------
    def is_stray(self) -> bool:
        with self.lock:
            return self.whoami not in [o for o in self.acting
                                       if o is not None]

    def maybe_notify_stray(self, osdmap: OSDMap) -> None:
        """Announce our data to the PG's current primary (reference
        strays notify the primary via past-interval queries; here the
        stray speaks first).  Called on map advance and from the OSD
        tick until the primary purges us."""
        with self.lock:
            if self.whoami in [o for o in self.acting if o is not None]:
                return
            _, _, acting, primary = osdmap.pg_to_up_acting_osds(
                self.pgid)
            if primary is None or primary == self.whoami:
                return
            # advertise what we can physically SERVE: on-disk objects
            # only (our own missing set covers log-adopted objects we
            # never recovered — offering those would send recovery to
            # a holder with no data)
            auth = self._authoritative_objects()
            objects = {oid: list(auth.get(oid, (0, 0)))
                       for oid in self.backend.list_objects()
                       if oid != PGMETA_OID}
            msg = MOSDPGNotify(
                pgid=str(self.pgid), shard=-1, from_osd=self.whoami,
                epoch=osdmap.epoch, log=self.log.to_dict(),
                missing=self.missing.to_dict(), stray=True,
                objects=objects, stray_shard=self._stray_shard,
                split_adopted=self._split_adopted)
        self.service.send_osd(primary, msg)

    def handle_pg_remove(self, msg) -> None:
        """The current primary no longer needs our stray copy: delete
        it (reference MOSDPGRemove -> PG removal)."""
        with self.lock:
            osdmap = self.service.get_osdmap()
            _, _, acting, primary = osdmap.pg_to_up_acting_osds(
                self.pgid)
            if msg.from_osd != primary:
                return               # stale sender
            if self.whoami in [o for o in acting if o is not None]:
                return               # we're acting: never self-delete
            txn = Transaction()
            if self.pool.is_erasure():
                for s in range(self.pool.size):
                    if self.store.collection_exists(self.coll_of(s)):
                        txn.remove_collection(self.coll_of(s))
            else:
                if self.store.collection_exists(self.coll_of(-1)):
                    txn.remove_collection(self.coll_of(-1))
            self.store.queue_transactions([txn], op="pg_delete")
            self.state = STATE_INACTIVE
            self.log = PGLog()
            self.missing = MissingSet()
        self.service.forget_pg(self.pgid)

    def _audit_split_shard(self, osdmap: OSDMap,
                           src: int = None) -> None:
        """EC acting member holding chunks from a foreign shard
        position (split child whose chunks came from parent shard
        ``_split_source_shard``, or merge parent that folded a child
        shard ``src``): our acting POSITION may differ — position
        data we don't physically hold is missing (recoverable by
        decode), while the chunks we do hold are advertised to the
        primary as a shard-qualified source.  Idempotent
        (existence-checked), so re-running on every interval is safe
        and converges to a no-op once recovery lands our position's
        chunks."""
        own = self.own_shard
        if own < 0:
            return
        audited = 0
        for oid, ver in self._authoritative_objects().items():
            obj = GHObject(oid, own)
            if not self.store.exists(self.coll_of(own), obj):
                if not self.missing.is_missing(oid):
                    self.missing.add(oid, ver, None)
                    audited += 1
        if audited:
            self._persist_pgmeta()
        if src is None:
            src = self._split_source_shard
        if src == own:
            return                   # lucky position match: data home
        objects = {}
        try:
            for oid in self.store.collection_list(self.coll_of(src)):
                name = oid.oid if hasattr(oid, "oid") else str(oid)
                if name != PGMETA_OID:
                    objects[name] = None
        except FileNotFoundError:
            return
        if not objects:
            return
        versions = self._authoritative_objects()
        objects = {o: list(versions.get(o, (0, 0)))
                   for o in objects}
        _, _, _, primary = osdmap.pg_to_up_acting_osds(self.pgid)
        if primary is None:
            return
        msg = MOSDPGNotify(
            pgid=str(self.pgid), shard=-1, from_osd=self.whoami,
            epoch=osdmap.epoch, log=self.log.to_dict(),
            missing=self.missing.to_dict(), stray=True,
            objects=objects, stray_shard=src,
            split_adopted=self._split_adopted)
        if primary == self.whoami:
            self._handle_stray_notify(msg)
        else:
            self.service.send_osd(primary, msg)

    # -- primary side --------------------------------------------------
    def extra_recovery_sources(self, oid: str):
        """Stray holders that can serve ``oid`` (shard, osd) — extends
        the backends' acting-set source selection during post-split
        recovery."""
        out = []
        for osd, objs in self._stray_sources.items():
            if oid in objs:
                nd = self._stray_notifies.get(osd, {})
                out.append((nd.get("stray_shard", -1), osd))
        return out

    def _maybe_purge_strays(self) -> None:
        """Once the acting set is whole, retire every stray copy
        (reference: strays are removed after peering declares them
        unneeded).  "Whole" means FULLY clean — no missing objects, no
        acting-set holes, full pool size: purging while a position is
        a hole would delete the only redundant copy and turn the next
        failure into data loss."""
        if not self.is_primary() or self.state != STATE_ACTIVE:
            return
        if self.num_missing() > 0:
            return
        alive = [o for o in self.acting if o is not None]
        if None in self.acting or len(alive) < self.pool.size:
            return
        acting = {o for o in self.acting if o is not None}
        for osd in list(self._stray_notifies):
            if osd in acting:        # mispositioned acting member:
                continue             # never remove, it IS the PG
            self.service.send_osd(osd, MOSDPGRemove(
                pgid=str(self.pgid), from_osd=self.whoami,
                epoch=self.epoch))
        self._stray_notifies.clear()
        self._stray_sources.clear()

    # ------------------------------------------------------------------
    # map / interval handling (reference PG::handle_advance_map)
    # ------------------------------------------------------------------
    def advance_map(self, osdmap: OSDMap) -> None:
        with self.lock:
            pool = osdmap.get_pool(self.pgid.pool)
            if pool is None:
                return
            self.pool = pool
            up, up_p, acting, acting_p = \
                osdmap.pg_to_up_acting_osds(self.pgid)
            if acting == self.acting and self.state != STATE_INACTIVE:
                return                   # same interval
            prev_shard = self.own_shard  # before acting changes
            self.up, self.acting = up, acting
            self.primary_osd = acting_p
            self.interval_start = osdmap.epoch
            self.backend.on_change()
            self.scrubber.reset()
            self._peer_notifies.clear()
            self.peer_missing.clear()
            self.recovering.clear()
            # NOTE: self.missing survives the interval change — it is
            # persistent state ("I adopted log entries whose data I do
            # not have"), not peering scratch.  Clearing it here would
            # let a data-less shard with a current log masquerade as
            # whole after re-peering (reference pg_missing_t is
            # likewise durable, PGLog write_log_and_missing).
            self.waiting_for_degraded.clear()
            # bounce every held client op: the backend just dropped its
            # sub-ops; the client re-targets against the new map and
            # resends, reqid dedup suppressing re-application of
            # anything that already committed (reference: requeue_ops
            # on interval change + osd_reqid_t dup detection)
            # watchers re-register through lingering client ops; in-
            # flight notifies bounce with the other held client ops
            self.watchers.clear()
            for state in self._notifies.values():
                state["timer"].cancel()
            self._notifies.clear()
            held = list(self._client_ops.values())
            self._client_ops.clear()
            self.waiting_for_active.clear()
            self.waiting_for_obj.clear()
            self._evicting.clear()
            self.inflight_writes.clear()
            self._pending_versions.clear()
            for m, conn in held:
                tracked = getattr(m, "tracked", None)
                if tracked is not None:
                    tracked.finish()
                if conn is not None:
                    reply = MOSDOpReply(tid=m.tid, result=-108,
                                        epoch=osdmap.epoch)
                    conn.send_message(reply)
            if self.whoami not in [o for o in acting if o is not None]:
                if self._stray_shard < 0 and prev_shard >= 0:
                    self._stray_shard = prev_shard  # keep EC identity
                # sub-ops parked for a shard assignment that never
                # came are from a dead interval: drop (the primary's
                # new interval re-issues what still matters)
                self.waiting_for_shard.clear()
                self.state = STATE_INACTIVE
                # announce ourselves to the current primary — WITH data
                # (recovery source) or EMPTY (the split-child gate needs
                # an explicit "my ancestry holds nothing" answer or an
                # empty child would wait forever)
                self.maybe_notify_stray(osdmap)
                return
            self._stray_shard = -1       # back in the acting set
            if self.pool.is_erasure():
                if self._split_source_shard >= 0:
                    self._audit_split_shard(osdmap)
                # merge-folded shards are re-audited per distinct
                # source until recovery homes our position's chunks
                for s in self._merge_source_shards:
                    if s != self._split_source_shard:
                        self._audit_split_shard(osdmap, src=s)
            # back in the acting set with a shard collection: apply
            # the backend sub-ops that raced this map (queued by
            # ms_dispatch while own_shard was -1)
            if self.own_shard >= 0 or not self.pool.is_erasure():
                self._ensure_collections()
                while self.waiting_for_shard:
                    self.backend.handle_message(
                        self.waiting_for_shard.popleft())
            self.state = STATE_PEERING
            if self.is_primary():
                self._start_peering()

    def is_primary(self) -> bool:
        return self.primary_osd == self.whoami

    def _other_members(self) -> List[Tuple[int, int]]:
        return [(s, o) for s, o in enumerate(self.acting)
                if o is not None and o != self.whoami]

    def _start_peering(self) -> None:
        """Query every other acting member (reference GetInfo)."""
        others = self._other_members()
        if not others:
            # still routes through the election so the split-child
            # gate and stray adoption apply even to 1-wide acting sets
            self._choose_and_activate()
            return
        for shard, osd in others:
            self.service.send_osd(osd, MOSDPGQuery(
                pgid=str(self.pgid), shard=shard,
                from_osd=self.whoami, epoch=self.epoch))

    # -- peering message handlers --------------------------------------
    def handle_pg_query(self, msg: MOSDPGQuery) -> None:
        with self.lock:
            self.service.send_osd(msg.from_osd, MOSDPGNotify(
                pgid=str(self.pgid), shard=msg.shard,
                from_osd=self.whoami, epoch=self.epoch,
                log=self.log.to_dict(),
                missing=self.missing.to_dict(),
                split_adopted=self._split_adopted))

    def handle_pg_notify(self, msg: MOSDPGNotify) -> None:
        with self.lock:
            if getattr(msg, "stray", False):
                self._handle_stray_notify(msg)
                return
            if not self.is_primary() or self.state != STATE_PEERING:
                return
            self._peer_notifies[msg.shard] = {
                "log": msg.log, "missing": msg.missing,
                "split_adopted": getattr(msg, "split_adopted", False)}
            wanted = {s for s, _ in self._other_members()}
            if wanted <= set(self._peer_notifies):
                self._choose_and_activate()

    def _handle_stray_notify(self, msg: MOSDPGNotify) -> None:
        """A non-acting holder announced data for this PG (split child
        stray or migrated-away copy).  Record it as an election
        candidate + recovery source; purge it once we're whole."""
        if not self.is_primary():
            return
        self._stray_notifies[msg.from_osd] = {
            "log": msg.log, "missing": msg.missing,
            "objects": msg.objects, "stray_shard": msg.stray_shard,
            "split_adopted": getattr(msg, "split_adopted", False)}
        self._stray_sources[msg.from_osd] = {
            oid: tuple(v) for oid, v in msg.objects.items()}
        # an ACTING member can send these too (EC split: mispositioned
        # chunks — see _audit_split_shard): fold its self-reported
        # missing into peer_missing so recovery pushes reach it even
        # when its audit raced our peering round
        for shard, osd_a in enumerate(self.acting):
            if osd_a == msg.from_osd and osd_a != self.whoami:
                ms = self.peer_missing.get(shard) or MissingSet()
                for oid, ent in MissingSet.from_dict(
                        msg.missing).items.items():
                    if not ms.is_missing(oid):
                        ms.add(oid, tuple(ent[0]),
                               tuple(ent[1]) if ent[1] else None)
                self.peer_missing[shard] = ms
        if self.state == STATE_PEERING:
            wanted = {s for s, _ in self._other_members()}
            if wanted <= set(self._peer_notifies):
                self._choose_and_activate()
            return
        if self.state != STATE_ACTIVE:
            return
        stray_head = tuple(msg.log.get("last_update", (0, 0)))
        if stray_head > self.log.last_update:
            # the stray is AHEAD of the elected authority (e.g. an old
            # primary resurfacing): re-run peering to fold it in —
            # terminates because the next election adopts its head
            self.state = STATE_PEERING
            self._peer_notifies.clear()
            self._start_peering()
        elif self.num_missing() == 0:
            self._maybe_purge_strays()
        else:
            self.service.kick_recovery(self)

    def _adopt_stray_objects(self, osd: int, head) -> None:
        """Backfill-style adoption of a stray's authoritative object
        set (mirrors the replica side of handle_pg_log's backfill
        path): our log restarts at the stray's head and every object
        we lack at its version becomes missing, recoverable from the
        stray via extra_recovery_sources."""
        objs = self._stray_sources.get(osd, {})
        for oid in self.backend.list_objects():
            if oid == PGMETA_OID:
                continue
            if oid not in objs:
                obj = GHObject(oid, self.own_shard)
                txn = Transaction()
                txn.remove(self.coll, obj)
                self.store.queue_transactions([txn],
                                              op="recovery_trim")
        for oid, ver in objs.items():
            oi = self.backend.get_object_info(oid)
            local = oi.version if oi is not None else None
            if local != ver:
                self.missing.add(oid, ver, local)
        self.log = PGLog.from_dict(
            {"last_update": list(head), "tail": list(head),
             "entries": []})
        self._persist_pgmeta()

    def _choose_and_activate(self) -> None:
        """Pick the authoritative log; adopt it if a peer is ahead
        (reference GetLog); then activate (reference Activate).
        Split-children and migrated-away strays participate in the
        election; a child seed refuses to activate empty before its
        ancestry has spoken (the past-intervals stand-in)."""
        best_shard, best_head = None, self.log.last_update
        for shard, nd in self._peer_notifies.items():
            head = tuple(nd["log"]["last_update"])
            if head > best_head:
                best_shard, best_head = shard, head
        best_stray, best_stray_head = None, (0, 0)
        for osd, nd in self._stray_notifies.items():
            head = tuple(nd["log"]["last_update"])
            if head > best_stray_head:
                best_stray, best_stray_head = osd, head
        created = self.pool.created_pg_num or self.pool.pg_num
        # only an ANCESTRY-DERIVED answer lifts the gate: a copy fed
        # by a local parent split (split_adopted, even when empty), or
        # a stray that actually carries history — a random fresh empty
        # copy answering would let a child activate empty while the
        # real data sits with a slower holder
        answered = (self._split_adopted
                    or any(nd.get("split_adopted")
                           for nd in self._peer_notifies.values())
                    or any(nd.get("split_adopted")
                           or tuple(nd["log"]["last_update"]) > (0, 0)
                           for nd in self._stray_notifies.values()))
        if (self.pgid.seed >= created and best_head == (0, 0)
                and not answered):
            # we are a split child and NOBODY in the acting set has
            # data yet: activating now could present an empty PG while
            # the parent's holders still have our objects.  Stay in
            # PEERING; strays self-notify (and re-notify on the OSD
            # tick) until one arrives.
            return
        if best_stray is not None and best_stray_head > best_head:
            self._adopt_stray_objects(best_stray, best_stray_head)
            # _activate's per-peer pass sees our fresh log with tail =
            # head, so every behind peer takes the backfill path
            self._activate()
            return
        if best_shard is not None:
            peer = PGLog.from_dict(self._peer_notifies[best_shard]["log"])
            self.log.merge_authoritative(
                peer.entries, peer.last_update,
                lambda oid, need, have: self.missing.add(oid, need,
                                                         have),
                lambda oid, prior: self._roll_back_local(oid, prior))
            # the authoritative shard may itself lack data for entries
            # it logged (its own persistent missing): those objects are
            # missing everywhere we can't prove otherwise — but for
            # *us* only if we don't have them; our own missing already
            # reflects our state, so nothing more to adopt here.
            self._persist_pgmeta()
        self._activate()

    def _roll_back_local(self, oid: str, prior: Eversion) -> None:
        """Divergent local entry: drop our copy and re-recover it at the
        authoritative version (log-based rollback stand-in; reference
        EC rollback uses per-op rollback info, ecbackend.rst:10-27)."""
        obj = GHObject(oid, self.own_shard)
        if self.store.exists(self.coll, obj):
            txn = Transaction()
            txn.remove(self.coll, obj)
            self.store.queue_transactions([txn],
                                          op="recovery_trim")
        if prior > (0, 0):
            self.missing.add(oid, prior, None)

    def _authoritative_objects(self) -> Dict[str, Eversion]:
        """oid -> version of every live object the primary knows:
        on-disk objects (their OI) overlaid with in-log versions."""
        out: Dict[str, Eversion] = {}
        for oid in self.backend.list_objects():
            if oid == PGMETA_OID:
                continue
            oi = self.backend.get_object_info(oid)
            if oi is not None:
                out[oid] = oi.version
        out.update(self.log.object_versions())
        for oid, (need, _) in list(self.missing.items.items()):
            out[oid] = need
        return out

    def _activate(self) -> None:
        """Primary side: compute per-peer missing, send activation,
        go active (reference PeeringState::Activate).  A peer's
        missing = its self-reported persistent missing (log current,
        data absent) ∪ the log delta we're about to send it."""
        auth_objects = None
        for shard, nd in self._peer_notifies.items():
            peer_head = tuple(nd["log"]["last_update"])
            entries = self.log.entries_since(peer_head)
            osd = self.acting[shard]
            ms = MissingSet.from_dict(nd.get("missing", {}))
            if entries is None:
                # no log overlap: backfill everything
                if auth_objects is None:
                    auth_objects = self._authoritative_objects()
                for oid, ver in auth_objects.items():
                    ms.add(oid, ver, None)
                self.peer_missing[shard] = ms
                self.service.send_osd(osd, MOSDPGLog(
                    pgid=str(self.pgid), shard=shard,
                    from_osd=self.whoami, epoch=self.epoch,
                    last_update=self.log.last_update,
                    backfill={oid: list(ver) for oid, ver
                              in auth_objects.items()}))
            else:
                known: Dict[str, Eversion] = {}
                for e in entries:
                    if e.is_error():
                        continue
                    if e.is_delete():
                        ms.rm(e.oid)
                    else:
                        ms.add(e.oid, e.version, known.get(e.oid))
                    known[e.oid] = e.version
                self.peer_missing[shard] = ms
                self.service.send_osd(osd, MOSDPGLog(
                    pgid=str(self.pgid), shard=shard,
                    from_osd=self.whoami, epoch=self.epoch,
                    last_update=self.log.last_update,
                    entries=[e.to_dict() for e in entries]))
        self.state = STATE_ACTIVE
        self._peer_notifies.clear()
        # pool geometry goes hot NOW, not on the first client write:
        # compile the encode executables and preallocate the device
        # staging rings for this pool's (k, m, stripe) while the
        # client is still discovering the map (background thread,
        # idempotent per geometry)
        warm = getattr(self.backend, "prewarm_geometry", None)
        if warm is not None:
            try:
                warm()
            except Exception:
                pass
        self._requeue_waiting()
        self.service.pg_activated(self)

    def handle_pg_log(self, msg: MOSDPGLog) -> None:
        """Replica side: adopt the authoritative log and go active
        (reference PG::RecoveryState::ReplicaActive)."""
        with self.lock:
            if self.pool.is_erasure() and self.own_shard < 0:
                # our map hasn't placed us in this PG yet (activation
                # raced the map); drop — the primary's stuck-peering
                # retry re-sends once our map catches up
                return
            if msg.backfill is not None:
                # authoritative object set: drop extras, note that the
                # primary will push everything (stale copies get
                # overwritten by pushes)
                auth = {oid: tuple(v) for oid, v in msg.backfill.items()}
                local: Dict[str, Eversion] = {}
                for oid in self.backend.list_objects():
                    if oid == PGMETA_OID:
                        continue
                    if oid not in auth:
                        obj = GHObject(oid, self.own_shard)
                        txn = Transaction()
                        txn.remove(self.coll, obj)
                        self.store.queue_transactions(
                            [txn], op="recovery_trim")
                    else:
                        oi = self.backend.get_object_info(oid)
                        if oi is not None:
                            local[oid] = oi.version
                self.log = PGLog.from_dict(
                    {"last_update": list(msg.last_update),
                     "tail": list(msg.last_update), "entries": []})
                # durable missing: the log head we just adopted claims
                # objects our store lacks — record that, or an interval
                # change would strand them (see advance_map note)
                self.missing = MissingSet()
                for oid, ver in auth.items():
                    if local.get(oid) != ver:
                        self.missing.add(oid, ver, local.get(oid))
            else:
                entries = [LogEntry.from_dict(e) for e in msg.entries]
                self.log.merge_authoritative(
                    entries, msg.last_update,
                    lambda oid, need, have: self.missing.add(oid, need,
                                                             have),
                    lambda oid, prior: self._roll_back_local(oid,
                                                             prior))
                # apply deletes that happened while we were away
                for e in entries:
                    if e.is_delete():
                        obj = GHObject(e.oid, self.own_shard)
                        if self.store.exists(self.coll, obj):
                            txn = Transaction()
                            txn.remove(self.coll, obj)
                            self.store.queue_transactions(
                                [txn], op="recovery_trim")
                        self.missing.rm(e.oid)
            self._persist_pgmeta()
            self.state = STATE_ACTIVE
            self._requeue_waiting()

    def _requeue_waiting(self) -> None:
        while self.waiting_for_active:
            msg, conn = self.waiting_for_active.popleft()
            self._do_op(msg, conn)

    @staticmethod
    def _mark_waiting(msg, event: str) -> None:
        """Stamp a park on the op's tracker timeline; ops whose latest
        event is a wait surface through dump_blocked_ops (reference
        OpTracker blocked-op accounting)."""
        tracked = getattr(msg, "tracked", None)
        if tracked is not None:
            tracked.mark_event(event)

    # ------------------------------------------------------------------
    # client op execution (reference do_request -> do_op -> do_osd_ops)
    # ------------------------------------------------------------------
    def do_request(self, msg: MOSDOp, conn) -> None:
        with self.lock:
            msg.stamp_hop("pg_locked")
            if getattr(self, "_merged_away", False):
                # this PG was folded into its split parent (pg merge):
                # the client refreshes its map and re-targets
                self._reply(conn, msg, -108, [])
                return
            if not self.is_primary():
                # client raced a map change: reply with our epoch so it
                # refreshes and resends (reference resend-on-new-map)
                self._reply(conn, msg, -108, [])   # -ESHUTDOWN marker
                return
            self._client_ops[(msg.client, msg.tid)] = (msg, conn)
            if self.state != STATE_ACTIVE:
                self._mark_waiting(msg, "waiting for active")
                self.waiting_for_active.append((msg, conn))
                return
            self._do_op(msg, conn)

    def _get_snapset(self, oid: str):
        """-> (SnapSet | None, came_from_snapdir).  The SnapSet lives
        on the head, or on the snapdir companion while the head is
        deleted (reference find_object_context's snapdir path)."""
        from .snaps import SS_ATTR, SnapSet, snapdir_oid
        for target, from_sd in ((oid, False),
                                (snapdir_oid(oid), True)):
            try:
                buf = self.store.getattr(
                    self.coll, GHObject(target, self.own_shard),
                    SS_ATTR)
                return SnapSet.decode(buf), from_sd
            except (FileNotFoundError, KeyError, ValueError):
                continue
        return None, False

    def _is_degraded(self, oid: str) -> bool:
        if self.missing.is_missing(oid):
            return True
        return any(ms.is_missing(oid)
                   for s, ms in self.peer_missing.items()
                   if self.acting[s] is not None)

    @staticmethod
    def _op_is_write(op) -> bool:
        if op.op == "call":
            # method flags decide (reference CLS_METHOD_WR)
            from ..objclass import call_is_write
            return call_is_write(op.name)
        return op.op in WRITE_OPS

    def _do_op(self, msg: MOSDOp, conn) -> None:
        has_write = any(self._op_is_write(op) for op in msg.ops)
        oid = msg.oid
        # reference osd_client_message_size_cap: bound a single op's
        # payload before any of it is staged
        payload = sum(len(op.data) for op in msg.ops if op.data)
        cap = self.conf["osd_client_message_size_cap"]
        if cap and payload > cap:
            self._reply(conn, msg, -90, [])      # EMSGSIZE
            return
        if "@" in oid and not oid.startswith(".pgls."):
            # '@' is the snapshot-object namespace (oid@snap,
            # oid@snapdir): a client object named 'foo@10' would
            # collide with clones — be hidden from listings, served
            # for snap reads, even deleted by the trimmer.  EINVAL,
            # like the reference reserving internal namespaces.
            self._reply(conn, msg, -22, [])
            return
        if not oid.startswith(".pgls."):
            # misdirected op (client targeted us from a pre-split map):
            # bounce so it refreshes and re-targets the child PG
            # (reference PrimaryLogPG::do_op "misdirected op" check)
            target = self.service.get_osdmap().object_locator_to_pg(
                oid, self.pgid.pool)
            if target.seed != self.pgid.seed:
                self._client_ops.pop((msg.client, msg.tid), None)
                self._reply(conn, msg, -108, [])
                return
        if any(op.op in ("cache_flush", "cache_evict")
               for op in msg.ops):
            # explicit tier maintenance (reference
            # CEPH_OSD_OP_CACHE_FLUSH/CACHE_EVICT): addressed AT the
            # cache pool, never promoted
            self._do_cache_op(msg, conn)
            return
        if not oid.startswith(".pgls.") and \
                self._maybe_handle_cache(msg, conn, has_write):
            return                       # parked / promoted / rejected
        if has_write and self.scrubber.write_blocked():
            # scrub snapshots must describe one committed state; new
            # writes wait for the round (reference write blocking on
            # the scrubbed chunk)
            self._mark_waiting(msg, "waiting for scrub")
            self.waiting_for_scrub.append((msg, conn))
            return
        if has_write and self._is_degraded(oid):
            # block until recovered (reference wait_for_degraded_object)
            self._mark_waiting(msg, "waiting for degraded object")
            self.waiting_for_degraded.setdefault(oid, deque()).append(
                (msg, conn))
            self.service.kick_recovery(self)
            return
        if has_write:
            if any(op.op == "copy_from" for op in msg.ops):
                self._start_copy_from(msg, conn)
                return
            if oid in self.inflight_writes and \
                    not self._can_pipeline(msg, oid):
                self._mark_waiting(msg, "waiting for object")
                self.waiting_for_obj.setdefault(oid, deque()).append(
                    (msg, conn))
                return
            self._do_write(msg, conn)
        else:
            if self.missing.is_missing(oid):
                # the primary's own copy is unreadable until recovery
                # (reference wait_for_unreadable_object)
                self._mark_waiting(msg, "waiting for degraded object")
                self.waiting_for_degraded.setdefault(
                    oid, deque()).append((msg, conn))
                self.service.kick_recovery(self)
                return
            self._do_reads(msg, conn)

    # ------------------------------------------------------------------
    # cache tiering (reference PrimaryLogPG::maybe_handle_cache_detail,
    # PrimaryLogPG.cc:2700, called from do_op at :8084): this PG is the
    # CACHE pool; misses promote from the base pool, writes are marked
    # dirty for the tier agent to flush, deletes write through to the
    # base (in place of the reference's whiteouts — simpler, same
    # no-resurrection guarantee for the model checker)
    # ------------------------------------------------------------------
    CACHE_DIRTY_ATTR = "cache_dirty"     # user-ns xattr on dirty heads

    def _maybe_handle_cache(self, msg: MOSDOp, conn,
                            has_write: bool) -> bool:
        """True when the op was consumed (parked, being promoted, or
        rejected); False lets it continue down the normal path."""
        pool = self.pool
        if not pool.is_tier() or pool.cache_mode == "none":
            return False
        oid = msg.oid
        if "@" in oid:
            return False                 # snap namespace: no tiering
        if pool.cache_mode == "readonly" and has_write:
            self._reply(conn, msg, -30, [])      # EROFS
            return True
        if oid in self._flushing:
            # a flush holds the object stable; ops resume when the
            # clean-mark commits (its done callback drains the queue)
            self.waiting_for_obj.setdefault(oid, deque()).append(
                (msg, conn))
            return True
        if oid in self._evicting:
            # mid-evict window (internal delete in flight): a read
            # probing now finds the object gone but can't promote
            # (the delete holds inflight_writes) and would ENOENT an
            # object that still exists in the base — park until the
            # evict commits, then the re-run promotes it back
            # (reference: ops wait on the blocked object context
            # during evict)
            self.waiting_for_obj.setdefault(oid, deque()).append(
                (msg, conn))
            return True
        if not getattr(msg, "_promote_checked", False) and \
                self.backend.get_object_info(oid) is None and \
                not self._is_degraded(oid) and \
                oid not in self.inflight_writes:
            # absent AND not merely unrecovered: a backfilling primary
            # that promoted every locally-missing object would install
            # stale base copies over acked cache state — degraded
            # objects instead fall through to the recovery parking in
            # _do_op (reference waits for recovery before promote)
            self._start_promote(msg, conn)
            return True
        if pool.cache_mode == "writeback" and \
                any(op.op == "delete" for op in msg.ops) and \
                not getattr(msg, "_base_deleted", False):
            self._start_base_delete(msg, conn)
            return True
        return False

    def _do_cache_op(self, msg: MOSDOp, conn) -> None:
        """cache_flush / cache_evict client ops (reference
        CEPH_OSD_OP_CACHE_FLUSH/CACHE_EVICT in do_osd_ops): operator-
        driven tier maintenance, e.g. `rados cache-flush-evict-all`."""
        if not self.pool.is_tier():
            self._reply(conn, msg, -22, [])
            return
        oid = msg.oid
        if self.backend.get_object_info(oid) is None:
            self._reply(conn, msg, -2, [])
            return
        try:
            self.store.getattr(self.coll,
                               GHObject(oid, self.own_shard),
                               "u_" + self.CACHE_DIRTY_ATTR)
            dirty = True
        except (FileNotFoundError, KeyError):
            dirty = False
        if msg.ops[0].op == "cache_flush":
            if not dirty:
                self._reply(conn, msg, 0, [])
                return
            if not self._flush_object(oid):
                self._reply(conn, msg, -16, [])      # EBUSY
                return
            # park; the flush's clean-mark re-runs us and the now-
            # clean object answers 0
            self.waiting_for_obj.setdefault(oid, deque()).append(
                (msg, conn))
        else:                            # cache_evict
            if dirty:
                self._reply(conn, msg, -16, [])      # flush first
                return
            ok = self._evict_object(oid)
            self._reply(conn, msg, 0 if ok else -16, [])

    def _cache_reenter(self, entries: List[Tuple]) -> None:
        """Re-run ops after an async cache step (lock held); each is
        stamped so the presence probe doesn't loop on objects that
        exist nowhere.  One op's failure must not starve the rest —
        a leaked waiter is a client op wedged until its timeout."""
        for m, c in entries:
            m._promote_checked = True
            try:
                self._do_op(m, c)
            except Exception:
                import traceback
                traceback.print_exc()
                try:
                    self._client_ops.pop((m.client, m.tid), None)
                    self._reply(c, m, -5, [])
                except Exception:
                    pass

    def _start_promote(self, msg: MOSDOp, conn) -> None:
        """Fetch the object from the base pool and install it in the
        cache (a clean, replicated, logged internal write), then
        re-run the op (reference promote_object)."""
        oid = msg.oid
        waiters = self._promoting.get(oid)
        if waiters is not None:
            waiters.append((msg, conn))
            return
        self._promoting[oid] = []
        base_pool = self.pool.tier_of
        base = self.service.get_osdmap().pools.get(base_pool)
        base_has_omap = base is not None and not base.is_erasure()

        def fetch() -> None:
            data = attrs = None
            omap = {}
            err = 0
            try:
                io = self.service.objecter_ioctx(base_pool)
                data = io.read(oid)
                attrs = io.getxattrs(oid)
                if base_has_omap:
                    omap = io.omap_get(oid)
            except Exception as e:
                errno = getattr(e, "errno", 0) or 5
                if errno != 2:
                    err = errno          # base unreachable: fail ops
                data = None
            with self.lock:
                waiting = self._promoting.pop(oid, [])
                all_ops = [(msg, conn)] + waiting
                if not self.is_primary() or \
                        self.state != STATE_ACTIVE:
                    # lost the PG mid-promote (thrash failover): a
                    # non-primary install would fan out split-brain
                    # sub-writes; bounce the clients to re-target
                    for m, c in all_ops:
                        self._client_ops.pop((m.client, m.tid), None)
                        self._reply(c, m, -108, [])
                    return
                if err:
                    for m, c in all_ops:
                        self._client_ops.pop((m.client, m.tid), None)
                        self._reply(c, m, -err, [])
                    return
                if data is None or \
                        self.backend.get_object_info(oid) is not None \
                        or oid in self.inflight_writes:
                    # nothing to promote (absent in base too, or a
                    # racing write created it): just re-run
                    self._cache_reenter(all_ops)
                    return
                mut = Mutation()
                mut.writes.append((0, data))
                mut.truncate = len(data)
                for k, v in attrs.items():
                    if k != self.CACHE_DIRTY_ATTR:
                        mut.attrs[k] = v
                mut.omap_set.update(omap)
                self.cache_promotes += 1
                try:
                    self._submit_internal(
                        oid, mut,
                        on_done=lambda res: self._cache_reenter(
                            all_ops))
                except Exception:
                    # install failed outright: answer every waiter
                    # rather than leaking them until client timeout
                    for m, c in all_ops:
                        self._client_ops.pop((m.client, m.tid), None)
                        self._reply(c, m, -5, [])

        threading.Thread(target=fetch, name="cache-promote",
                         daemon=True).start()

    def _start_base_delete(self, msg: MOSDOp, conn) -> None:
        """Write-through delete: remove the base copy BEFORE the cache
        delete is applied/acked, so a later miss can never resurrect a
        deleted object from the base pool.  ``_base_deleting`` fences
        the tier agent — a flush racing this window would rewrite the
        base copy we just removed (resurrection via flush)."""
        base_pool = self.pool.tier_of
        self._base_deleting.add(msg.oid)

        def run() -> None:
            try:
                self.service.objecter_ioctx(base_pool).remove(msg.oid)
            except Exception as e:
                if getattr(e, "errno", 0) != 2:
                    with self.lock:
                        self._base_deleting.discard(msg.oid)
                        self._client_ops.pop((msg.client, msg.tid),
                                             None)
                        self._reply(conn, msg,
                                    -(getattr(e, "errno", 0) or 5), [])
                    return
            msg._base_deleted = True
            with self.lock:
                msg._promote_checked = True
                try:
                    # the local delete submits inside _do_op, so the
                    # object is inflight (flush-proof) before we lift
                    # the fence
                    self._do_op(msg, conn)
                except RuntimeError:
                    pass                 # teardown raced (store gone)
                finally:
                    self._base_deleting.discard(msg.oid)

        threading.Thread(target=run, name="cache-basedel",
                         daemon=True).start()

    def cache_agent(self) -> Tuple[int, int]:
        """One tier-agent pass (reference TierAgentState / agent_work):
        flush dirty objects past the dirty ratio, evict clean ones
        while the cache exceeds its targets; -> (flushed, evicted).
        Runs from the OSD tick on the primary."""
        pool = self.pool
        if not pool.is_tier() or pool.cache_mode != "writeback":
            return (0, 0)
        with self.lock:
            if not self.is_primary() or self.state != STATE_ACTIVE:
                return (0, 0)
            objs: List[Tuple[str, int, bool]] = []   # oid, size, dirty
            for oid in self.backend.list_objects():
                if oid == PGMETA_OID or "@" in oid:
                    continue
                if self._is_degraded(oid):
                    continue             # local copy may be stale:
                                         # recover first, then flush
                info = self.backend.get_object_info(oid)
                if info is None:
                    continue
                try:
                    self.store.getattr(
                        self.coll, GHObject(oid, self.own_shard),
                        "u_" + self.CACHE_DIRTY_ATTR)
                    dirty = True
                except (FileNotFoundError, KeyError):
                    dirty = False
                objs.append((oid, info.size, dirty))
            total = len(objs)
            total_bytes = sum(s for _, s, _ in objs)
            dirty_objs = [o for o in objs if o[2]]
            # pool-wide targets scale to this PG's share (reference
            # TierAgentState: agent targets divide by pg_num)
            pg_num = max(1, pool.pg_num)
            obj_target = pool.target_max_objects / pg_num \
                if pool.target_max_objects else 0
            byte_target = pool.target_max_bytes / pg_num \
                if pool.target_max_bytes else 0
            over_objs = obj_target and total > obj_target
            over_bytes = byte_target and total_bytes > byte_target
            over_dirty = dirty_objs and (
                (obj_target and
                 len(dirty_objs) > pool.cache_target_dirty_ratio
                 * obj_target)
                or over_objs or over_bytes)
            flush_list = [o for o, _, d in objs if d][:4] \
                if over_dirty else []
            evict_budget = 0
            if over_objs:
                evict_budget = int(total - obj_target) + 1
            if over_bytes:
                evict_budget = max(evict_budget, 4)
            evict_list = [o for o, _, d in objs
                          if not d and o not in self.inflight_writes
                          and o not in self._flushing][:evict_budget]
        flushed = 0
        for oid in flush_list:
            if self._flush_object(oid):
                flushed += 1
        evicted = 0
        for oid in evict_list:
            if self._evict_object(oid):
                evicted += 1
        return (flushed, evicted)

    def _flush_object(self, oid: str) -> bool:
        """Write a dirty object back to the base pool, then mark it
        clean (reference agent_maybe_flush / start_flush).  Ops on the
        object park while the flush holds it stable."""
        with self.lock:
            if oid in self.inflight_writes or oid in self._flushing \
                    or oid in self._promoting \
                    or oid in self._base_deleting \
                    or self._is_degraded(oid):
                # a log-recovering primary's LOCAL copy can be stale —
                # flushing it would overwrite the base with old bytes
                # that a later evict+promote would resurrect
                return False
            obj = GHObject(oid, self.own_shard)
            try:
                data = self.store.read(self.coll, obj)
                raw_attrs = self.store.getattrs(self.coll, obj)
                omap = self.store.omap_get(self.coll, obj)
            except OSError:
                # missing OR store-csum EIO: skip this object (scrub
                # repair re-homes good bytes) instead of aborting the
                # whole agent pass
                return False
            attrs = {k[2:]: v for k, v in raw_attrs.items()
                     if k.startswith("u_")
                     and k[2:] != self.CACHE_DIRTY_ATTR}
            base = self.service.get_osdmap().pools.get(
                self.pool.tier_of)
            if omap and (base is None or base.is_erasure()):
                # omap can't land on an EC base (ENOTSUP there): the
                # object stays dirty in the cache — this is exactly
                # how a cache tier gives an EC pool omap support
                # (reference: omap-bearing objects pin in the tier)
                return False
            self._flushing.add(oid)
        base_pool = self.pool.tier_of

        def run() -> None:
            try:
                from ..msg.messages import OSDOp
                io = self.service.objecter_ioctx(base_pool)
                # ONE compound op: content + attr/omap replacement
                # land atomically at the base PG — a flush interrupted
                # by a kill can never leave the base with new content
                # but missing xattrs (a later promote would serve the
                # torn copy)
                ops = [OSDOp("rmxattrs"),
                       OSDOp("writefull", 0, len(data), data)]
                for k, v in attrs.items():
                    ops.append(OSDOp("setxattr", data=v, name=k))
                if omap:
                    ops.append(OSDOp("omap_clear"))
                    for k, v in omap.items():
                        ops.append(OSDOp("omap_set", data=v, name=k))
                io._obj_op(oid, ops)
            except Exception:
                with self.lock:
                    self._flushing.discard(oid)
                    q = self.waiting_for_obj.pop(oid, None)
                    if q:
                        for m, c in q:
                            self._do_op(m, c)
                return
            with self.lock:
                mut = Mutation()
                mut.attrs[self.CACHE_DIRTY_ATTR] = None
                self.cache_flushes += 1

                def done(res: int) -> None:
                    self._flushing.discard(oid)
                    q = self.waiting_for_obj.pop(oid, None)
                    if q:
                        for m, c in q:
                            try:
                                self._do_op(m, c)
                            except Exception:
                                import traceback
                                traceback.print_exc()
                try:
                    self._submit_internal(oid, mut, on_done=done)
                except Exception:
                    done(-5)

        threading.Thread(target=run, name="cache-flush",
                         daemon=True).start()
        return True

    def _evict_object(self, oid: str) -> bool:
        """Drop a CLEAN object from the cache (reference
        agent_maybe_evict): the base pool holds it; the next miss
        promotes it back.  Goes through _submit_internal directly, so
        the write-through base delete never fires."""
        with self.lock:
            if oid in self.inflight_writes or oid in self._flushing \
                    or oid in self._promoting \
                    or self._is_degraded(oid):
                return False
            if self.backend.get_object_info(oid) is None:
                return False
            # re-check cleanliness UNDER THE LOCK: a client write may
            # have re-dirtied the object after the agent's listing —
            # evicting it would drop acked data and a later miss
            # would promote the stale base copy
            try:
                self.store.getattr(self.coll,
                                   GHObject(oid, self.own_shard),
                                   "u_" + self.CACHE_DIRTY_ATTR)
                return False             # dirty again: flush first
            except (FileNotFoundError, KeyError):
                pass
            mut = Mutation()
            mut.delete = True
            self.cache_evicts += 1
            self._evicting.add(oid)

            def done(res: int) -> None:
                self._evicting.discard(oid)
                q = self.waiting_for_obj.pop(oid, None)
                if q:
                    for m, c in q:
                        try:
                            self._do_op(m, c)
                        except Exception:
                            import traceback
                            traceback.print_exc()
            try:
                self._submit_internal(oid, mut, on_done=done)
            except Exception:
                done(-5)
                return False
        return True

    def _can_pipeline(self, msg: MOSDOp, oid: str) -> bool:
        """May this write run concurrently with in-flight writes on
        the same object?  Plain partial overwrites on EC-overwrites
        pools pipeline through the backend's extent overlay (reference
        ExtentCache, ECBackend.cc:1891-1920).  Anything that depends
        on settled object state — appends, snapshot contexts (the
        SnapSet must be fresh for the clone decision), waiting
        same-object ops (order!) — serializes as before."""
        return (self.pool.is_erasure() and self.pool.ec_overwrites
                and msg.snap_seq == 0
                and oid not in self.waiting_for_obj
                and all(op.op == "write" for op in msg.ops))

    def _inflight_add(self, oid: str) -> None:
        self.inflight_writes[oid] = \
            self.inflight_writes.get(oid, 0) + 1

    def _inflight_remove(self, oid: str) -> None:
        n = self.inflight_writes.get(oid, 0) - 1
        if n <= 0:
            self.inflight_writes.pop(oid, None)
        else:
            self.inflight_writes[oid] = n

    def _next_version(self) -> Eversion:
        """Monotonic even while earlier writes are still in the async
        pipeline (log.last_update only advances at local apply)."""
        v = max(self._last_assigned[1], self.log.last_update[1]) + 1
        self._last_assigned = (self.epoch, v)
        return self._last_assigned

    def _start_copy_from(self, msg: MOSDOp, conn) -> None:
        """CEPH_OSD_OP_COPY_FROM (reference PrimaryLogPG.cc:2816
        do_copy_from): the primary fetches the SOURCE object — possibly
        homed in another PG — through the OSD's internal objecter, then
        folds it into this op as a full replace (data + user xattrs +
        omap on replicated pools).  The fetch runs off the PG lock;
        the op re-enters the normal write path when it lands, so dup
        detection/snapshots/EC rules all apply unchanged."""
        src = next(op for op in msg.ops if op.op == "copy_from")
        src_oid = src.name
        # on a cache-tier pool the source resolves through the
        # OVERLAY: it may live only in the base after an evict, and
        # the overlay read promotes it back before serving
        if self.pool.is_tier():
            pool_id, bypass = self.pool.tier_of, False
        else:
            pool_id, bypass = self.pgid.pool, True
        replicated = not self.pool.is_erasure()

        def fetch() -> None:
            try:
                io = self.service.objecter_ioctx(pool_id, bypass)
                # ONE compound read: data+xattrs+omap snapshot the
                # source atomically at its PG — separate ops would
                # leave windows where a tier evict/promote (or any
                # concurrent writer) changes the object between them
                fetch_ops = [OSDOp("read"), OSDOp("getxattrs")]
                if replicated:
                    fetch_ops.append(OSDOp("omap_get"))
                reply = io._obj_op(src_oid, fetch_ops)
                data = reply.out_data[0]
                attrs = {k: v.encode("latin1") for k, v in
                         reply.extra.get("xattrs", {}).items()}
                omap = {k: v.encode("latin1") for k, v in
                        reply.extra.get("omap", {}).items()} \
                    if replicated else {}
            except Exception as e:
                code = getattr(e, "errno", 0) or 5
                with self.lock:
                    self._client_ops.pop((msg.client, msg.tid), None)
                    self._reply(conn, msg, -code, [])
                return
            with self.lock:
                if not self.is_primary() or self.state != STATE_ACTIVE:
                    self._client_ops.pop((msg.client, msg.tid), None)
                    self._reply(conn, msg, -108, [])
                    return
                # the result must be an EXACT copy: pre-existing
                # destination xattrs/omap keys absent from the source
                # must not survive (reference CEPH_OSD_OP_COPY_FROM
                # replaces the object wholesale).  The clearing ops
                # resolve at EXECUTION time ("rmxattrs" enumerates the
                # dest's attrs in _do_write) — this op may yet park
                # behind an in-flight write whose attrs must also be
                # cleared, so a name list computed here would be stale.
                new_ops: List[OSDOp] = []
                for op in msg.ops:
                    if op.op != "copy_from":
                        new_ops.append(op)
                        continue
                    new_ops.append(OSDOp("rmxattrs"))
                    if replicated:
                        new_ops.append(OSDOp("omap_clear"))
                    new_ops.append(OSDOp("writefull", 0, len(data),
                                         data))
                    for k, v in attrs.items():
                        new_ops.append(OSDOp("setxattr", data=v,
                                             name=k))
                    for k, v in omap.items():
                        new_ops.append(OSDOp("omap_set", data=v,
                                             name=k))
                msg.ops = new_ops
                self._do_op(msg, conn)

        threading.Thread(target=fetch, name="copy-from",
                         daemon=True).start()

    def _do_write(self, msg: MOSDOp, conn) -> None:
        # dup detection: a resend of an already-committed op must not
        # re-apply (reference PGLog dup handling / already_complete)
        if self.log.has_reqid(msg.client, msg.tid) is not None:
            # resend of a committed op: replay its outputs so calls
            # with payloads (class methods) don't lose their result
            # (reference keeps completed-op reply data with the log)
            cached = self._reply_cache.get((msg.client, msg.tid), [])
            self._reply(conn, msg, 0, cached)
            return
        mut = Mutation()
        mut.trace_id = msg.trace_id
        # child spans (EC shard sub-writes) hang off the primary's
        # osd_op span; the tracked op rides along so the backend /
        # batcher can stamp stage events on the client op's timeline
        mut.parent_span_id = getattr(msg, "osd_span_id", 0)
        mut.tracked_op = getattr(msg, "tracked", None)
        mut.client_msg = msg
        err = 0
        ec = self.pool.is_erasure()
        full_replace = any(op.op == "writefull" for op in msg.ops)
        info = self.backend.get_object_info(msg.oid)
        cur_size = info.size if info else 0
        rollback_snap: Optional[int] = None
        call_outputs: List[bytes] = [b""] * len(msg.ops)
        for i, op in enumerate(msg.ops):
            o = op.op
            if o == "call":
                # object classes run at the primary and stage their
                # effects into this op's mutation (reference
                # CEPH_OSD_OP_CALL); ENOTSUP on EC pools like the
                # reference (ecbackend.rst "Object Classes")
                if ec:
                    err = -95
                    break
                from ..objclass import dispatch_call
                ret, out = dispatch_call(self, msg.oid, op.name,
                                         op.data, mut)
                call_outputs[i] = out
                if ret < 0:
                    err = ret
                    break
            elif o == "write":
                mut.writes.append((op.offset, op.data))
            elif o == "writefull":
                mut.writes.append((0, op.data))
                mut.truncate = len(op.data)
            elif o == "append":
                mut.writes.append((cur_size, op.data))
                cur_size += len(op.data)
            elif o == "create":
                mut.create = True
            elif o == "delete":
                mut.delete = True
            elif o == "truncate":
                if ec and not self.pool.ec_overwrites:
                    err = -95
                    break
                mut.truncate = op.offset
            elif o == "rollback":
                # selfmanaged snap rollback: snapid rides in offset
                # (reference CEPH_OSD_OP_ROLLBACK)
                rollback_snap = op.offset
            elif o == "setxattr":
                mut.attrs[op.name] = op.data
            elif o == "rmxattr":
                mut.attrs[op.name] = None
            elif o == "rmxattrs":
                # clear ALL user xattrs, resolved at EXECUTION time
                # (copy_from's exact-copy clearing: resolving earlier
                # — at fetch completion — would miss attrs written by
                # ops this one parked behind)
                try:
                    cur = self.store.getattrs(
                        self.coll, GHObject(msg.oid, self.own_shard))
                except FileNotFoundError:
                    cur = {}
                for name in cur:
                    if name.startswith("u_"):
                        mut.attrs.setdefault(name[2:], None)
            elif o in ("omap_set", "omap_rm", "omap_clear"):
                if ec:
                    err = -95            # ENOTSUP on EC pools
                    break
                if o == "omap_set":
                    mut.omap_set[op.name] = op.data
                elif o == "omap_rm":
                    mut.omap_rm.append(op.name)
                else:
                    mut.omap_clear = True
            elif o in READ_OPS:
                err = -22                # no mixed read/write ops
                break
            else:
                err = -95
                break
        # reference osd_max_object_size: reject objects growing past
        # the cap (checked on the projected write extent)
        if not err:
            limit = self.conf["osd_max_object_size"]
            projected = mut.truncate if mut.truncate is not None \
                else cur_size
            for off, data in mut.writes:
                projected = max(projected, off + len(data))
            if limit and projected > limit:
                err = -27                # EFBIG
        if ec and not self.pool.ec_overwrites and not mut.delete \
                and not full_replace \
                and not mut.append_only_at(info.size if info else 0):
            err = -95                    # overwrite needs ec_overwrites
        if err:
            self._reply(conn, msg, err, [])
            return
        if self.pool.is_tier() and self.pool.cache_mode == "writeback" \
                and not mut.delete:
            # dirty marker for the tier agent's flush pass (reference
            # object_info_t FLAG_DIRTY)
            mut.attrs[self.CACHE_DIRTY_ATTR] = b"1"

        # -- snapshots (reference PrimaryLogPG::make_writeable) --------
        from .snaps import SnapContext, SnapSet, clone_oid, snapdir_oid
        # stale client contexts may still list deleted snaps: filter
        # against the pool's removed set (reference filter_snapc) so
        # no clone is ever created covering a snap the trimmer already
        # processed
        removed = set(self.pool.removed_snaps)
        snapc = SnapContext(msg.snap_seq,
                            [s for s in msg.snaps if s not in removed])
        ss, ss_from_snapdir = self._get_snapset(msg.oid)
        entries: List[LogEntry] = []
        if rollback_snap is not None:
            solo = len(msg.ops) == 1
            kind, cid = (ss or SnapSet()).resolve_read(rollback_snap)
            if kind == "head" and solo:
                # the head already IS the state at that snap: pure
                # no-op — crucially it must NOT advance the SnapSet
                # seq, or the snaps between ss.seq and snapc.seq
                # (whose state is the head) become unresolvable.
                # (Bundled with other ops, those still apply below;
                # the rollback component simply contributes nothing.)
                self._reply(conn, msg, 0, call_outputs)
                return
            if kind == "clone":
                if not solo:
                    # rollback replaces the whole head; mixing it with
                    # other mutations in one op has no sound ordering
                    # (the EC write plan would RMW pre-rollback bytes)
                    self._reply(conn, msg, -22, [])
                    return
                src = clone_oid(msg.oid, cid)
                if self._is_degraded(src):
                    self.waiting_for_degraded.setdefault(
                        src, deque()).append((msg, conn))
                    self.service.kick_recovery(self)
                    return
                mut.rollback_from = src
                mut.rollback_size = ss.clone_size[cid]
            elif kind == "enoent":
                # rolling back to before the object existed = delete
                # (reference _rollback_to ENOENT -> whiteout/delete)
                if not solo:
                    # delete-then-apply-other-ops is inexpressible in
                    # one Mutation; reject the mix instead of silently
                    # dropping either half
                    self._reply(conn, msg, -22, [])
                    return
                if info is None:
                    self._reply(conn, msg, 0, call_outputs)
                    return
                mut.delete = True
        if snapc and info is not None and \
                (ss or SnapSet()).needs_clone(snapc):
            # COW the head before this write/delete/ROLLBACK mutates
            # it — a rollback destroys the head too, and a snap taken
            # since the last write still needs the pre-rollback state
            # (reference: rollback goes through make_writeable)
            if ss is None:
                ss = SnapSet()
            cver = self._next_version()
            cid = ss.add_clone(snapc, info.size)
            coid = clone_oid(msg.oid, cid)
            mut.clone_to = coid
            mut.clone_attrs = {OI_ATTR: ObjectInfo(
                size=info.size, version=cver).encode()}
            entries.append(LogEntry(
                MODIFY, coid, cver, prior_version=(0, 0),
                reqid=(f"{msg.client}.clone", msg.tid)))
        elif snapc and info is None:
            # creating under a snap context: the era advances so snap
            # reads at or before the creating snapc resolve to ENOENT.
            # Existing objects never advance without cloning — the
            # snaps in between see the (unchanged) head.
            if ss is None:
                ss = SnapSet()
            ss.advance_seq(snapc)
        if mut.delete:
            if ss is not None and not ss.empty:
                # clones outlive the head: SnapSet moves to snapdir.
                # The snapdir's creation is LOGGED at its own version —
                # unlogged object lifecycle diverges peering's missing
                # sets from the store under thrash
                sd_oid = snapdir_oid(msg.oid)
                sd_ver = self._next_version()
                mut.snapdir_set = (sd_oid, ss.encode(), ObjectInfo(
                    size=0, version=sd_ver).encode())
                sd_info = self.backend.get_object_info(sd_oid)
                entries.append(LogEntry(
                    MODIFY, sd_oid, sd_ver,
                    prior_version=(sd_info.version if sd_info
                                   else (0, 0)),
                    reqid=(f"{msg.client}.snapdir", msg.tid)))
        else:
            if ss_from_snapdir:
                # head recreated: the SnapSet moves back home; the
                # snapdir's removal is likewise logged
                sd_oid = snapdir_oid(msg.oid)
                mut.aux_remove.append(sd_oid)
                sd_ver = self._next_version()
                sd_info = self.backend.get_object_info(sd_oid)
                entries.append(LogEntry(
                    DELETE, sd_oid, sd_ver,
                    prior_version=(sd_info.version if sd_info
                                   else (0, 0)),
                    reqid=(f"{msg.client}.snapdir", msg.tid)))
            if ss is not None:
                mut.snapset = ss.encode()

        version = self._next_version()
        # prior_version chains through IN-FLIGHT writes on the object
        # (committed store state lags pipelined ops; divergent-log
        # handling in peering depends on the true predecessor)
        prior = self._pending_versions.get(
            msg.oid, info.version if info else (0, 0))
        entries.append(LogEntry(DELETE if mut.delete else MODIFY,
                                msg.oid, version, prior_version=prior,
                                reqid=(msg.client, msg.tid)))
        self._pending_versions[msg.oid] = version
        self._inflight_add(msg.oid)
        if mut.tracked_op is not None:
            mut.tracked_op.mark_event("started_write")
        # the commit pipeline owns the tracker entry from here: the
        # shard worker must not retire it when do_request returns
        msg._tracked_async = True
        self.backend.submit_transaction(
            msg.oid, mut, version, entries,
            lambda res: self._op_committed(msg, conn, res,
                                           call_outputs))

    def _op_committed(self, msg: MOSDOp, conn, res: int,
                      out_data: Optional[List[bytes]] = None) -> None:
        tracked = getattr(msg, "tracked", None)
        if tracked is not None:
            tracked.mark_event("op_commit")
        # the backend stamped store_apply at the primary's LOCAL store
        # commit (first-stamp-wins makes this a no-op then); the time
        # from there to the full acting-set ack is peer_ack_wait — an
        # async store that acks fast must not have the distributed
        # round trip charged against it
        msg.stamp_hop("store_apply")
        msg.stamp_hop("peer_ack_wait")
        self._inflight_remove(msg.oid)
        if msg.oid not in self.inflight_writes:
            self._pending_versions.pop(msg.oid, None)
        if res == 0 and out_data and any(out_data):
            self._reply_cache[(msg.client, msg.tid)] = out_data
            while len(self._reply_cache) > 128:
                self._reply_cache.pop(
                    next(iter(self._reply_cache)))
        self._reply(conn, msg, res, out_data or [])
        # serialize-class waiters run only once the object is fully
        # settled — popping one while pipelined writes are still in
        # flight would requeue it BEHIND later waiters, inverting the
        # client's submission order
        q = self.waiting_for_obj.get(msg.oid) \
            if msg.oid not in self.inflight_writes else None
        if q:
            nmsg, nconn = q.popleft()
            if not q:
                del self.waiting_for_obj[msg.oid]
            self._do_op(nmsg, nconn)
        # a scrub waiting for the write pipeline to drain may now run
        self.scrubber.kick()

    def _do_reads(self, msg: MOSDOp, conn) -> None:
        out_data: List[bytes] = [b""] * len(msg.ops)
        extra: Dict = {}

        # snap read resolution (reference find_object_context): a
        # snapid resolves to the head, a clone object, or ENOENT
        oid = msg.oid
        if msg.snapid:
            from .snaps import clone_oid
            ss, _ = self._get_snapset(msg.oid)
            if ss is not None:
                kind, cid = ss.resolve_read(msg.snapid)
                if kind == "clone":
                    oid = clone_oid(msg.oid, cid)
                    if self.missing.is_missing(oid):
                        self.waiting_for_degraded.setdefault(
                            oid, deque()).append((msg, conn))
                        self.service.kick_recovery(self)
                        return
                elif kind == "enoent":
                    self._reply(conn, msg, -2, out_data)
                    return
            # no SnapSet: the object was never written under a snap
            # context, so the head (if any) is its state at every snap

        def finish(res: int) -> None:
            self._reply(conn, msg, res, out_data, extra)

        def run(i: int) -> None:
            if i >= len(msg.ops):
                finish(0)
                return
            op = msg.ops[i]
            o = op.op
            if o == "read":
                def cb(res: int, data: bytes, i=i) -> None:
                    if res < 0:
                        finish(res)
                    else:
                        out_data[i] = data
                        run(i + 1)
                length = op.length if op.length else (1 << 62)
                self.backend.objects_read(oid, op.offset, length, cb,
                                          hop_msg=msg)
                return
            if o == "call":
                # read-only class method (reference CLS_METHOD_RD):
                # no transaction; staging writes fails in dispatch
                if self.pool.is_erasure():
                    finish(-95)
                    return
                from ..objclass import dispatch_call
                ret, out = dispatch_call(self, msg.oid, op.name,
                                         op.data, None)
                if ret < 0:
                    finish(ret)
                    return
                out_data[i] = out
            elif o == "stat":
                info = self.backend.get_object_info(oid)
                if info is None:
                    finish(-2)
                    return
                extra["size"] = info.size
                extra["version"] = list(info.version)
            elif o == "list_snaps":
                # reference CEPH_OSD_OP_LIST_SNAPS: the object's clone
                # inventory from its SnapSet
                ss, _ = self._get_snapset(msg.oid)
                if ss is None:
                    extra["snaps"] = {"seq": 0, "clones": []}
                else:
                    extra["snaps"] = {
                        "seq": ss.seq,
                        "clones": [{"id": c,
                                    "snaps": ss.clone_snaps.get(c, []),
                                    "size": ss.clone_size.get(c, 0)}
                                   for c in ss.clones]}
            elif o == "getxattr":
                try:
                    out_data[i] = self.store.getattr(
                        self.coll, GHObject(oid, self.own_shard),
                        "u_" + op.name)
                except (FileNotFoundError, KeyError):
                    finish(-61)          # -ENODATA
                    return
            elif o == "getxattrs":
                try:
                    attrs = self.store.getattrs(
                        self.coll, GHObject(oid, self.own_shard))
                except FileNotFoundError:
                    finish(-2)
                    return
                extra["xattrs"] = {k[2:]: v.decode("latin1")
                                   for k, v in attrs.items()
                                   if k.startswith("u_")}
            elif o == "omap_get":
                if self.pool.is_erasure():
                    finish(-95)
                    return
                try:
                    omap = self.store.omap_get(
                        self.coll, GHObject(oid, self.own_shard))
                except FileNotFoundError:
                    finish(-2)
                    return
                extra["omap"] = {k: v.decode("latin1")
                                 for k, v in omap.items()}
            elif o == "omap_get_by_key":
                # single-key lookup (reference omap_get_vals_by_keys):
                # avoids shipping a huge index to read one entry
                if self.pool.is_erasure():
                    finish(-95)
                    return
                try:
                    omap = self.store.omap_get(
                        self.coll, GHObject(oid, self.own_shard))
                except FileNotFoundError:
                    finish(-2)
                    return
                if op.name not in omap:
                    finish(-61)          # -ENODATA
                    return
                out_data[i] = omap[op.name]
            elif o == "watch":
                # register this session as a watcher (reference
                # CEPH_OSD_OP_WATCH, osd/Watch.cc); cookie in offset
                if self.backend.get_object_info(msg.oid) is None:
                    finish(-2)
                    return
                self.watchers.setdefault(msg.oid, {})[
                    (msg.client, op.offset)] = conn
            elif o == "unwatch":
                ws = self.watchers.get(msg.oid, {})
                ws.pop((msg.client, op.offset), None)
                if not ws:
                    self.watchers.pop(msg.oid, None)
            elif o == "list_watchers":
                extra["watchers"] = sorted(
                    f"{cl}:{ck}" for cl, ck in
                    self.watchers.get(msg.oid, {}))
            elif o == "notify":
                self._do_notify(msg, conn, op)
                return               # reply deferred to acks/timeout
            elif o == "notify_ack":
                # notify_id in offset, acking watch's cookie in length
                self._notify_acked(op.offset, msg.client, op.length)
            elif o == "pgls":
                from .snaps import is_snap_oid
                objs = []
                for o2 in self.backend.list_objects():
                    if o2 == PGMETA_OID or is_snap_oid(o2):
                        continue         # clients list heads only
                    objs.append(o2)
                for o2, (need, _) in self.missing.items.items():
                    if o2 not in objs and not is_snap_oid(o2):
                        objs.append(o2)
                extra["objects"] = sorted(objs)
            else:
                finish(-95)
                return
            run(i + 1)

        run(0)

    # ------------------------------------------------------------------
    # watch/notify (reference osd/Watch.cc + PrimaryLogPG::do_osd_ops
    # NOTIFY/NOTIFY_ACK handling)
    # ------------------------------------------------------------------
    def _do_notify(self, msg: MOSDOp, conn, op) -> None:
        """Fan a notify out to every watcher session; the notifier's
        reply waits for all acks or the timeout (reference Notify
        completion)."""
        from ..msg.messages import MWatchNotify
        self._next_notify_id += 1
        nid = self._next_notify_id
        # pending keyed by (client, cookie): one client may hold
        # several watches on the object, each must ack independently
        pending: Set[Tuple[str, int]] = set()
        watchers = self.watchers.get(msg.oid, {})
        for (client, cookie), wconn in list(watchers.items()):
            try:
                wconn.send_message(MWatchNotify(
                    oid=msg.oid, pool=msg.pool, cookie=cookie,
                    notify_id=nid, payload=op.data,
                    notifier=msg.client))
                pending.add((client, cookie))
            except Exception:
                # dead session: the watch dies with it (reference
                # watch timeout/con reset teardown)
                watchers.pop((client, cookie), None)
        if not pending:
            self._reply(conn, msg, 0, [b""] * len(msg.ops),
                        {"acks": [], "timed_out": []})
            return
        state = {"pending": pending, "acks": [], "msg": msg,
                 "conn": conn, "nops": len(msg.ops)}
        self._notifies[nid] = state
        timeout = (op.offset or
                   self.conf["osd_default_notify_timeout"] * 1000) \
            / 1000.0
        # hosted OSDs supply a wheel timer; stubs without one fall back
        # to a plain thread timer
        t = self.call_later(timeout,
                            lambda: self._notify_timeout(nid))
        if t is None:
            t = threading.Timer(timeout, self._notify_timeout,
                                args=(nid,))
            t.daemon = True
            t.start()
        state["timer"] = t

    def _notify_acked(self, nid: int, client: str,
                      cookie: int) -> None:
        state = self._notifies.get(nid)
        if state is None:
            return
        state["pending"].discard((client, cookie))
        tag = f"{client}:{cookie}"
        if tag not in state["acks"]:
            state["acks"].append(tag)
        if not state["pending"]:
            del self._notifies[nid]
            state["timer"].cancel()
            self._reply(state["conn"], state["msg"], 0,
                        [b""] * state["nops"],
                        {"acks": sorted(state["acks"]),
                         "timed_out": []})

    def _notify_timeout(self, nid: int) -> None:
        with self.lock:
            state = self._notifies.pop(nid, None)
            if state is None:
                return
            self._reply(state["conn"], state["msg"], 0,
                        [b""] * state["nops"],
                        {"acks": sorted(state["acks"]),
                         "timed_out": sorted(
                             f"{cl}:{ck}" for cl, ck in
                             state["pending"])})

    def _reply(self, conn, msg: MOSDOp, result: int,
               out_data: List[bytes], extra: Optional[Dict] = None
               ) -> None:
        self._client_ops.pop((msg.client, msg.tid), None)
        # every client reply retires the op's tracker entry (the single
        # chokepoint: reads, write commits, and error bounces all land
        # here); finish() is idempotent
        tracked = getattr(msg, "tracked", None)
        if tracked is not None:
            # SLO error classification: infrastructure failures burn
            # budget; client-semantic errnos (ENOENT, EEXIST, ENODATA,
            # EOPNOTSUPP, ECANCELED, ETIMEDOUT-on-notify) do not — a
            # read of a nonexistent object is a correct answer.  -108
            # (ESHUTDOWN) is the misdirected-op bounce: a routing
            # redirect during map churn that the objecter transparently
            # retries against the new primary, not a service failure
            if result < 0 and result not in (-2, -17, -61, -95, -108, -125):
                tracked.slo_ok = False
            tracked.finish()
        if conn is None:
            return
        reply = MOSDOpReply(tid=msg.tid, result=result,
                            epoch=self.epoch, out_data=list(out_data),
                            extra=extra or {})
        # carry the op's cumulative hop ledger back so the client can
        # close the waterfall (reads skip store_apply; charge() skips
        # absent hops)
        if msg.hops:
            reply.hops = dict(msg.hops)
        reply.stamp_hop("commit_sent")
        conn.send_message(reply)

    # ------------------------------------------------------------------
    # recovery driving (reference start_recovery_ops)
    # ------------------------------------------------------------------
    def missing_objects(self) -> Dict[str, Eversion]:
        """Union of all shards' missing (primary view)."""
        out: Dict[str, Eversion] = {}
        for oid, (need, _) in self.missing.items.items():
            out[oid] = max(out.get(oid, (0, 0)), need)
        for s, ms in self.peer_missing.items():
            if self.acting[s] is None:
                continue
            for oid, (need, _) in ms.items.items():
                out[oid] = max(out.get(oid, (0, 0)), need)
        return out

    def num_missing(self) -> int:
        return len(self.missing_objects())

    def is_clean(self) -> bool:
        with self.lock:
            if self.state != STATE_ACTIVE:
                return False
            if self.is_primary() and self.num_missing() > 0:
                return False
            return None not in self.acting and \
                len(self.acting) >= self.pool.min_size

    # ------------------------------------------------------------------
    # snap trimming (reference SnapTrimmer / PrimaryLogPG::trim_object,
    # collapsed to an idempotent primary-side scan)
    # ------------------------------------------------------------------
    def maybe_trim_snaps(self) -> int:
        """Remove clones whose every covered snap was deleted from the
        pool (pool.removed_snaps); -> trim mutations submitted.  Runs
        from the OSD tick; idempotent, so a crash mid-trim just
        re-scans."""
        from .snaps import SS_ATTR, SnapSet, clone_oid, is_snap_oid
        # reference osd_snap_trim_sleep: pace trim rounds so trimming
        # never starves client IO (checked outside the PG lock —
        # sleeping under it would do the starving)
        pause = self.conf["osd_snap_trim_sleep"]
        if pause > 0 and time.monotonic() - getattr(
                self, "_last_snap_trim", 0.0) < pause:
            return 0
        with self.lock:
            removed = set(self.pool.removed_snaps)
            if not self.is_primary() or self.state != STATE_ACTIVE \
                    or not removed \
                    or removed == getattr(self, "_snaps_trimmed", None):
                return 0
            if self.is_primary() and self.num_missing() > 0:
                return 0                 # recover first, then trim
            self._last_snap_trim = time.monotonic()
            submitted = 0
            skipped = False
            for oid in self.backend.list_objects():
                if oid == PGMETA_OID:
                    continue
                if is_snap_oid(oid) and not oid.endswith("@snapdir"):
                    continue             # clones are handled via heads
                try:
                    ss = SnapSet.decode(self.store.getattr(
                        self.coll, GHObject(oid, self.own_shard),
                        SS_ATTR))
                except (FileNotFoundError, KeyError, ValueError):
                    continue
                before = ss.encode()
                gone = ss.trim(removed)
                if ss.encode() == before:
                    continue             # nothing of ours was removed
                head = oid.split("@", 1)[0]
                if head in self.inflight_writes or \
                        any(clone_oid(head, c) in self.inflight_writes
                            for c in gone):
                    skipped = True       # busy: retry next tick
                    continue
                for cid in gone:
                    mut = Mutation()
                    mut.delete = True
                    self._submit_internal(clone_oid(head, cid), mut)
                    submitted += 1
                is_snapdir = oid.endswith("@snapdir")
                mut = Mutation()
                if is_snapdir and ss.empty:
                    mut.delete = True    # last clone gone: drop snapdir
                else:
                    mut.snapset = ss.encode()
                self._submit_internal(oid, mut)
                submitted += 1
            if not skipped and submitted == 0:
                # memoize only a fully-clean pass: after submitting
                # work (or skipping busy objects) the next tick
                # re-scans until nothing is left to trim
                self._snaps_trimmed = removed
            return submitted

    def _submit_internal(self, oid: str, mut: Mutation,
                         on_done=None) -> None:
        """Primary-internal mutation (snap trim, cache promote/flush/
        evict): full log + replication machinery, no client to answer.
        ``on_done(res)`` runs after local commit, under the PG lock."""
        info = self.backend.get_object_info(oid)
        version = self._next_version()
        self._trim_seq = getattr(self, "_trim_seq", 0) + 1
        prior = self._pending_versions.get(
            oid, info.version if info else (0, 0))
        entry = LogEntry(DELETE if mut.delete else MODIFY, oid, version,
                         prior_version=prior,
                         reqid=(f"osd.{self.whoami}.trim",
                                self._trim_seq))
        self._pending_versions[oid] = version
        self._inflight_add(oid)

        def done(res: int, oid=oid) -> None:
            self._inflight_remove(oid)
            if oid not in self.inflight_writes:
                self._pending_versions.pop(oid, None)
            if on_done is not None:
                try:
                    on_done(res)
                except Exception:
                    import traceback
                    traceback.print_exc()
            q = self.waiting_for_obj.get(oid)
            if q:
                nmsg, nconn = q.popleft()
                if not q:
                    del self.waiting_for_obj[oid]
                self._do_op(nmsg, nconn)
            self.scrubber.kick()
        self.backend.submit_transaction(oid, mut, version, [entry],
                                        done)

    def start_recovery_ops(self, budget: int) -> int:
        """Launch up to ``budget`` object recoveries; -> ops started."""
        with self.lock:
            if not self.is_primary() or self.state != STATE_ACTIVE:
                return 0
            started = 0
            # blocked client ops first (reference recovery priorities)
            queue = list(self.waiting_for_degraded)
            queue += [oid for oid in self.missing_objects()
                      if oid not in queue]
            for oid in queue:
                if started >= budget:
                    break
                if oid in self.recovering:
                    continue
                targets = self._missing_targets(oid)
                if not targets:
                    continue
                version = self.missing_objects().get(oid)
                if version is None:
                    continue
                self.recovering[oid] = time.monotonic()
                entry_exists = not self._is_deleted_in_log(oid)
                if not entry_exists:
                    self._recover_delete(oid, targets)
                    started += 1
                    continue
                self.backend.recover_object(
                    oid, version, targets,
                    lambda res, oid=oid: self._on_recovered(oid, res))
                started += 1
            return started

    def _is_deleted_in_log(self, oid: str) -> bool:
        for e in reversed(self.log.entries):
            if e.oid == oid:
                return e.is_delete()
        return False

    def _recover_delete(self, oid: str,
                        targets: List[Tuple[int, int]]) -> None:
        """The authoritative version of ``oid`` is a delete: remove it
        wherever it lingers (no push needed)."""
        for shard, osd in targets:
            if osd == self.whoami:
                obj = GHObject(oid, self.own_shard)
                if self.store.exists(self.coll, obj):
                    txn = Transaction()
                    txn.remove(self.coll, obj)
                    self.store.queue_transactions(
                        [txn], op="recovery_trim")
        self._on_recovered(oid, 0)

    def requeue_scrub_waiters(self) -> None:
        waiters, self.waiting_for_scrub = \
            self.waiting_for_scrub, deque()
        for msg, conn in waiters:
            self._do_op(msg, conn)

    def mark_shard_missing(self, oid: str, version: Eversion,
                           shard: int, osd: int) -> None:
        """Scrub repair found a bad copy: treat it as missing so the
        recovery path rebuilds it (reference repair_object marking the
        authoritative-divergent shard missing)."""
        if osd == self.whoami:
            self.missing.add(oid, version, None)
            self._persist_pgmeta()
        else:
            ms = self.peer_missing.setdefault(shard, MissingSet())
            ms.add(oid, version, None)

    def _missing_targets(self, oid: str) -> List[Tuple[int, int]]:
        targets: List[Tuple[int, int]] = []
        if self.missing.is_missing(oid):
            targets.append((self.own_shard, self.whoami))
        for s, ms in self.peer_missing.items():
            osd = self.acting[s] if s < len(self.acting) else None
            if osd is not None and ms.is_missing(oid):
                targets.append((s, osd))
        return targets

    def requeue_stale_recovery(self, timeout: float = 2.0) -> bool:
        """Abandon recovery ops stuck past ``timeout`` (lost sub-op,
        peer raced a map) so the next recovery pass retries them."""
        with self.lock:
            now = time.monotonic()
            stale = [oid for oid, t0 in self.recovering.items()
                     if now - t0 > timeout]
            for oid in stale:
                del self.recovering[oid]
                ops = getattr(self.backend, "recovery_ops", None)
                if ops is not None:
                    ops.pop(oid, None)
            return bool(stale)

    def _on_recovered(self, oid: str, res: int) -> None:
        with self.lock:
            t0 = self.recovering.pop(oid, None)
            slo = getattr(self.service, "slo", None)
            if slo is not None and t0 is not None:
                slo.observe("recovery", time.monotonic() - t0,
                            ok=(res == 0))
            if res == 0:
                need = self.missing_objects().get(oid, (1 << 30, 0))
                if self.missing.is_missing(oid):
                    self.missing.got(oid, need)
                    self._persist_pgmeta()
                for ms in self.peer_missing.values():
                    ms.got(oid, need)
            waiting = self.waiting_for_degraded.pop(oid, None)
            if waiting:
                for m, c in waiting:
                    self._do_op(m, c)
            if self.num_missing() == 0:
                self._maybe_purge_strays()
            self.service.kick_recovery(self)

    # ------------------------------------------------------------------
    # stats / scrub
    # ------------------------------------------------------------------
    def get_stats(self) -> Dict:
        with self.lock:
            states = [self.state]
            if self.state == STATE_ACTIVE:
                if self.is_primary() and self.num_missing() > 0:
                    states.append("recovering")
                elif None in self.acting or \
                        len([o for o in self.acting
                             if o is not None]) < self.pool.size:
                    states.append("degraded")
                else:
                    states.append("clean")
            if self.scrubber.errors:
                states.append("inconsistent")
            n_objects = len([o for o in self.backend.list_objects()
                             if o != PGMETA_OID])
            return {
                "state": "+".join(states),
                "last_update": list(self.log.last_update),
                "num_objects": n_objects,
                "num_missing": (self.num_missing()
                                if self.is_primary() else 0),
                "acting": [o if o is not None else -1
                           for o in self.acting],
                "up": [o if o is not None else -1 for o in self.up],
                "num_scrub_errors": self.scrubber.errors,
                "inconsistent": {
                    oid: list(shards) for oid, shards in
                    self.scrubber.inconsistent.items()},
                "last_scrub": self.scrubber.last_scrub,
                "last_deep_scrub": self.scrubber.last_deep_scrub,
            }
