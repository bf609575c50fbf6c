"""BlueStore-class async local store: WAL group commit + deferred apply.

BlockStore (store/blockstore.py) keeps the reference's
storage MODEL — raw block space + KV metadata + per-block CRCs — but
not its execution model: every ``queue_transactions`` runs journal
append, journal fsync, the whole extent apply, a device flush and the
KV commit INLINE under one global store lock, on the PG-lock path.
This subclass keeps the storage model and replaces the transaction
discipline with the reference BlueStore's async pipeline (reference
src/os/bluestore/BlueStore.cc _txc_state_proc: PREPARE → AIO_WAIT →
IO_DONE → KV_QUEUED → KV_COMMITTING → deferred apply):

* **WAL with group commit** — callers append length+CRC framed
  records to a shared WAL segment under a short queue lock and then
  JOIN a shared fsync: the first waiter becomes the sync leader
  (optionally dwelling ``group_commit_window_s`` so followers pile
  in), syncs once, and advances the durable watermark for everyone
  (reference KernelDevice::aio_submit batching + the kv_sync_thread's
  one-fsync-per-batch discipline).  ``on_commit`` fires on WAL
  durability, NOT on apply — the OSD's commit ack leaves the store
  path after one buffered write + an amortized fsync share.
* **Deferred apply** — durable transactions queue for a background
  applier (classic: a dedicated thread; crimson: a reactor task via
  ``bind_apply_reactor``) that folds them into extents + KV in
  batches: one vectored multi-object device pass, one device flush,
  one atomic KV commit per batch (reference deferred_try_submit /
  _deferred_submit_unlock).  Reads in the commit→apply window wait on
  a per-object barrier fed by an existence overlay; the waiter
  WORK-STEALS the apply when the driver is busy or gone, so progress
  never depends on the background driver (and a crimson reactor
  reading its own pending write cannot deadlock).
* **Checksums on the device batcher** — the per-block CRC32C stamps
  of an apply batch are queued and folded through ONE batched
  GF-bitmatrix pass (ops/crclinear, the same [32, 8·BLOCK] bitmatrix
  matmul the EC kernels run), device-routed through the codec backend
  when that backend is on a CUDA card (``attach_device_batcher``),
  host loop otherwise — mirroring the deep-scrub offload gate in
  osd/ecbackend.py.  Verification on read is inherited unchanged.

Ledger contract (utils/store_ledger.py): the queueing thread stamps
``journal_append`` / ``journal_fsync``; ownership of the ledger then
transfers to the applier (``_deferred`` handshake with the
ObjectStore base), which stamps ``deferred_queue`` / ``data_write`` /
``kv_commit`` / ``flush`` and finalizes — stamps stay monotone
because the applier only takes WAL-durable, sealed entries, so
charge-sum == txn wall survives the async split.

Crash consistency: COW data blocks + the one atomic KV flip, as the
base.  A crash before the KV commit replays the WAL on mount (records
with seq <= the persisted applied watermark are skipped, re-apply is
idempotent); a torn or corrupt WAL tail record is discarded whole.

RAM mode (``path=""``): MemDB metadata + BytesIO device + no WAL
file — same code paths minus durability, so memory-backed clusters
(bench, tests) exercise the full async pipeline.
"""
from __future__ import annotations

import io
import os
import struct
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.crc import crc32c
from ..utils.finisher import Finisher
from .blockstore import BLOCK, BitmapAllocator, BlockStore, _Extents
from .kv import MemDB, LogDB, WriteBatch
from .objectstore import (_TXN_TLS, GHObject, Transaction, check_ops)

#: KV key persisting the highest WAL seq whose apply has committed —
#: mount-time replay skips records at/below it
APPLIED_KEY = "bluestore_applied_seq"

#: WAL record framing: u32 payload len | u32 crc32c(payload) | u64 seq
_WAL_HDR = struct.Struct("<IIQ")

#: xattr-overlay tombstone for a pending rmattr
_ATTR_DEL = object()

#: seconds a reactor's apply pump waits before looking again when
#: another thread holds the applier mutex
APPLY_RETRY_S = 0.002


class _Pending:
    """One WAL-durable transaction waiting for the deferred applier."""

    __slots__ = ("seq", "txns", "ops", "led", "sealed", "taken",
                 "aborted")

    def __init__(self, seq: int, txns: List[Transaction], ops: List):
        self.seq = seq
        self.txns = txns
        self.ops = ops
        self.led: Optional[Dict[str, float]] = None
        self.sealed = False        # queueing thread done stamping
        self.taken = False         # claimed by an in-flight apply batch
        self.aborted = False       # queueing thread raised post-append


class BlueStore(BlockStore):
    """Async BlueStore-class backend (osd_objectstore=bluestore)."""

    medium = "ssd"

    def __init__(self, path: str = "", compression: str = "none",
                 wal_segment_bytes: int = 16 << 20,
                 group_commit_window_s: float = 0.0,
                 apply_batch_txns: int = 16,
                 deferred_queue_depth: int = 128,
                 start_applier: bool = True):
        super().__init__(path, compression)
        self.wal_segment_bytes = int(wal_segment_bytes)
        self.group_commit_window_s = float(group_commit_window_s)
        self.apply_batch_txns = max(1, int(apply_batch_txns))
        self.deferred_queue_depth = max(1, int(deferred_queue_depth))
        self._start_applier = bool(start_applier)
        # admission/overlay state (lock order: _qcond's lock BEFORE
        # the base _lock; never the reverse)
        self._qcond = threading.Condition(threading.Lock())
        self._pending: deque = deque()
        self._ov_colls: Dict[str, Tuple[bool, int]] = {}
        self._ov_objs: Dict[Tuple[str, GHObject], Tuple[bool, int]] = {}
        self._ov_wiped: Dict[str, int] = {}
        # xattr overlay: pending setattr/rmattr values served to
        # readers WITHOUT an apply barrier — the EC write path reads
        # the hinfo + object-info xattrs before every sub-write, so a
        # barrier here would re-serialize the whole deferred pipeline
        self._ov_attrs: Dict[Tuple[str, GHObject, str],
                             Tuple[object, int]] = {}
        # object-identity changes (remove/clone-dst/rename) whose
        # attr outcome is unknowable from the ops alone: readers past
        # this seq must barrier
        self._ov_attr_dirty: Dict[Tuple[str, GHObject], int] = {}
        self._wal_seq = 0
        self._applied_seq = 0
        self._stop = False
        # group-commit state
        self._gc_cond = threading.Condition(threading.Lock())
        self._gc_syncing = False
        self._wal_durable_seq = 0
        # WAL segments: [segno, path, fh, last_seq, bytes]
        self._wal_segs: List[list] = []
        self._wal_segno = 0
        self._wal_unsynced: List = []   # fhs with appended-not-synced data
        # single-applier mutex (work-stealing: any thread may pump)
        self._apply_mutex = threading.Lock()
        self._apply_thread: Optional[threading.Thread] = None
        self._reactor = None
        # one reactor pump chain a store: set when a pump is queued on
        # the apply reactor, cleared when it runs
        self._pump_armed = False
        # vectored device-write buffer (apply-batch scope, under _lock)
        self._wbuf: Dict[int, bytes] = {}
        # deferred-checksum queue (apply-entry scope, under _lock)
        self._crcq: List[Tuple[_Extents, int, bytes]] = []
        self._csum_backend_fn: Optional[Callable] = None
        # counters (surfaced via usage() and the store_ladder bench)
        self.wal_records = 0
        self.wal_bytes = 0
        self.wal_group_syncs = 0
        self.wal_group_txns = 0
        self.apply_batches = 0
        self.apply_txns = 0
        self.apply_errors = 0
        self.vectored_flushes = 0
        self.vectored_blocks = 0
        self.vectored_runs = 0
        self.csum_batches = 0
        self.csum_blocks = 0
        self.csum_device_batches = 0
        # device checksum passes that raised and were served by the host
        # loop, and the last exception of one
        self.csum_device_errors = 0
        self.csum_last_error: Optional[BaseException] = None

    # -- lifecycle -----------------------------------------------------
    def mkfs(self) -> None:
        if self.path:
            super().mkfs()
        # RAM mode: nothing to initialize — mount starts empty

    def mount(self) -> None:
        with self._lock:
            if self._db is not None:
                return
            if self.path:
                db = LogDB(os.path.join(self.path, "meta.kv"))
                db.open()
                self._db = db
                devp = os.path.join(self.path, "block.dev")
                self._dev = open(
                    devp, "r+b" if os.path.exists(devp) else "w+b")
            else:
                self._db = MemDB()
                self._db.open()
                self._dev = io.BytesIO()
            self._alloc = BitmapAllocator(self._db.get("alloc") or b"")
            self._finisher = Finisher("bluestore")
            self._applied_seq = int(
                (self._db.get(APPLIED_KEY) or b"0").decode())
            self._wal_seq = self._applied_seq
            self._wal_durable_seq = self._applied_seq
            self._stop = False
            if self.path:
                self._wal_replay()
                self._wal_roll()
        if self._start_applier:
            t = threading.Thread(target=self._apply_loop,
                                 name="bluestore-apply", daemon=True)
            self._apply_thread = t
            t.start()

    def umount(self) -> None:
        # stop the background driver, then drain inline: the applier
        # (thread OR reactor) may already be gone at shutdown, so the
        # drain must not depend on it
        with self._qcond:
            self._stop = True
            self._qcond.notify_all()
        t = self._apply_thread
        if t is not None:
            t.join(timeout=10.0)
            self._apply_thread = None
        while self._pump_once():
            pass
        if self._finisher:
            self._finisher.wait_for_empty()
            self._finisher.stop()
            self._finisher = None
        with self._lock:
            if self._db is None:
                return
            for seg in self._wal_segs:
                try:
                    seg[2].close()
                except Exception:
                    pass
            self._wal_segs = []
            self._wal_unsynced = []
            self._db.close()
            self._db = None
            self._dev.close()
            self._dev = None
        with self._qcond:
            self._pending.clear()
            self._ov_colls.clear()
            self._ov_objs.clear()
            self._ov_wiped.clear()
            self._ov_attrs.clear()
            self._ov_attr_dirty.clear()
            self._qcond.notify_all()

    # -- WAL -----------------------------------------------------------
    def _wal_path(self, segno: int) -> str:
        return os.path.join(self.path, f"wal.{segno:08d}")

    def _wal_roll(self) -> None:
        """Open a fresh active segment (caller: mount under _lock, or
        _wal_write under the queue lock)."""
        self._wal_segno += 1
        fh = open(self._wal_path(self._wal_segno), "ab")
        self._wal_segs.append([self._wal_segno,
                               self._wal_path(self._wal_segno),
                               fh, 0, 0])

    def _wal_write(self, seq: int, record, nbytes: int) -> None:
        """Append one framed record to the active segment (caller
        holds the queue lock).  flush() pushes it to the OS page cache
        so a process crash preserves it; durability against power loss
        is the group fsync's job.  RAM mode passes record=None (no
        segment to write) with the byte count precomputed."""
        self.wal_records += 1
        self.wal_bytes += nbytes
        if record is None or not self.path:
            return
        seg = self._wal_segs[-1]
        if seg[4] >= self.wal_segment_bytes:
            self._wal_roll()
            seg = self._wal_segs[-1]
        fh = seg[2]
        fh.write(_WAL_HDR.pack(len(record), crc32c(record), seq))
        fh.write(record)
        fh.flush()
        seg[3] = seq
        seg[4] += _WAL_HDR.size + len(record)
        if fh not in self._wal_unsynced:
            self._wal_unsynced.append(fh)

    def _wal_fsync(self, seq: int) -> None:
        """Group commit: return once WAL seq ``seq`` is durable.  The
        first waiter leads — dwells the group-commit window, syncs
        every segment touched since the last sync, and advances the
        durable watermark for all followers."""
        while True:
            with self._gc_cond:
                if self._wal_durable_seq >= seq:
                    return
                if self._gc_syncing:
                    self._gc_cond.wait(1.0)
                    continue
                self._gc_syncing = True
                prev = self._wal_durable_seq
            try:
                if self.group_commit_window_s > 0:
                    time.sleep(self.group_commit_window_s)
                with self._qcond:
                    top = self._wal_seq
                    fhs, self._wal_unsynced = self._wal_unsynced, []
                for fh in fhs:
                    fh.flush()
                    os.fsync(fh.fileno())
            except BaseException:
                with self._gc_cond:
                    self._gc_syncing = False
                    self._gc_cond.notify_all()
                raise
            with self._gc_cond:
                self._gc_syncing = False
                self._wal_durable_seq = max(self._wal_durable_seq, top)
                self._gc_cond.notify_all()
            self.wal_group_syncs += 1
            self.wal_group_txns += top - prev

    def _wal_retire(self) -> None:
        """Drop fully-applied non-active segments (caller holds the
        queue lock)."""
        keep = []
        for seg in self._wal_segs:
            active = seg is self._wal_segs[-1]
            if not active and seg[3] <= self._applied_seq:
                try:
                    seg[2].close()
                    os.remove(seg[1])
                except Exception:
                    pass
            else:
                keep.append(seg)
        self._wal_segs = keep

    def _wal_replay(self) -> None:
        """Mount-time recovery: apply WAL records above the persisted
        applied watermark, in seq order, then start a fresh WAL.
        Re-apply is idempotent at the extent-map level (COW), and a
        torn/corrupt tail record discards the rest of its segment."""
        names = sorted(n for n in os.listdir(self.path)
                       if n.startswith("wal."))
        entries: List[Tuple[int, bytes]] = []
        top_segno = 0
        for name in names:
            top_segno = max(top_segno, int(name.split(".")[1]))
            with open(os.path.join(self.path, name), "rb") as fh:
                while True:
                    hdr = fh.read(_WAL_HDR.size)
                    if len(hdr) < _WAL_HDR.size:
                        break
                    length, want, seq = _WAL_HDR.unpack(hdr)
                    payload = fh.read(length)
                    if len(payload) < length or \
                            crc32c(payload) != want:
                        break              # torn tail: discard rest
                    entries.append((seq, payload))
        entries.sort()
        for seq, payload in entries:
            self._wal_seq = max(self._wal_seq, seq)
            if seq <= self._applied_seq:
                continue
            txn = Transaction.decode(payload)
            batch = WriteBatch()
            dirty = self._apply_ops(txn.ops, batch, replay=True)
            self._wbuf_flush()
            self._flush_dev(dirty)
            batch.set("alloc", self._alloc.state())
            batch.set(APPLIED_KEY, str(seq).encode())
            self._db.submit(batch, sync=True)
            self._applied_seq = seq
        self._wal_durable_seq = self._wal_seq
        for name in names:
            try:
                os.remove(os.path.join(self.path, name))
            except OSError:
                pass
        self._wal_segno = top_segno

    # -- admission overlay ---------------------------------------------
    def _coll_exists_q(self, coll: str) -> bool:
        st = self._ov_colls.get(coll)
        if st is not None:
            return st[0]
        return self._db.get(f"C/{coll}") is not None

    def _obj_exists_q(self, coll: str, obj: GHObject) -> bool:
        e = self._ov_objs.get((coll, obj))
        w = self._ov_wiped.get(coll)
        if e is not None and (w is None or e[1] >= w):
            return e[0]
        if w is not None:
            return False
        return self._db.get(self._exists_key(coll, obj)) is not None

    _CREATES = frozenset(("touch", "write", "xor_write", "zero",
                          "truncate", "setattr", "omap_setkeys",
                          "omap_setheader", "omap_rmkeys", "omap_clear",
                          "rmattr"))

    def _admit_overlay(self, ops, seq: int) -> None:
        """Record the existence outcome of admitted (not yet applied)
        ops so later admissions validate against them and reads know
        which WAL seq they must wait for (caller holds the queue
        lock).  check_ops already validated, so the requires-family
        ops only refresh the barrier seq."""
        for op in ops:
            name = op[0]
            if name in self._CREATES:
                self._ov_objs[(op[1], op[2])] = (True, seq)
                if name == "setattr":
                    self._ov_attrs[(op[1], op[2], op[3])] = \
                        (op[4], seq)
                elif name == "rmattr":
                    self._ov_attrs[(op[1], op[2], op[3])] = \
                        (_ATTR_DEL, seq)
            elif name == "remove":
                self._ov_objs[(op[1], op[2])] = (False, seq)
                self._ov_attr_dirty[(op[1], op[2])] = seq
            elif name == "clone":
                _, coll, src, dst = op
                self._ov_objs[(coll, src)] = (True, seq)
                self._ov_objs[(coll, dst)] = (True, seq)
                # dst inherits src's attrs as of this seq — a value
                # the overlay cannot synthesize
                self._ov_attr_dirty[(coll, dst)] = seq
            elif name == "mkcoll":
                self._ov_colls[op[1]] = (True, seq)
            elif name == "rmcoll":
                self._ov_colls[op[1]] = (False, seq)
                self._ov_wiped[op[1]] = seq
            elif name == "coll_move_rename":
                _, src_coll, src, dst_coll, dst = op
                self._ov_objs[(src_coll, src)] = (False, seq)
                self._ov_objs[(dst_coll, dst)] = (True, seq)
                self._ov_attr_dirty[(src_coll, src)] = seq
                self._ov_attr_dirty[(dst_coll, dst)] = seq

    def _ov_gc(self) -> None:
        """Drop overlay entries the KV now reflects (caller holds the
        queue lock; applied_seq just advanced)."""
        a = self._applied_seq
        for d in (self._ov_colls, self._ov_objs):
            for k in [k for k, v in d.items() if v[1] <= a]:
                del d[k]
        for k in [k for k, v in self._ov_wiped.items() if v <= a]:
            del self._ov_wiped[k]
        for k in [k for k, v in self._ov_attrs.items() if v[1] <= a]:
            del self._ov_attrs[k]
        for k in [k for k, v in self._ov_attr_dirty.items() if v <= a]:
            del self._ov_attr_dirty[k]

    def _pending_seq_for(self, coll: str,
                         obj: Optional[GHObject] = None) -> int:
        seq = 0
        c = self._ov_colls.get(coll)
        if c is not None:
            seq = c[1]
        w = self._ov_wiped.get(coll)
        if w is not None and w > seq:
            seq = w
        if obj is not None:
            e = self._ov_objs.get((coll, obj))
            if e is not None and e[1] > seq:
                seq = e[1]
        return seq

    # -- queue path ----------------------------------------------------
    def _do_queue_transactions(self, txns: List[Transaction],
                               on_commit: Optional[Callable[[], None]]
                               = None) -> None:
        led = getattr(_TXN_TLS, "led", None)
        merged_ops = [op for txn in txns for op in txn.ops]
        while True:
            # backpressure BEFORE validation: admissions that raced in
            # while we waited must be visible to check_ops.  A full
            # queue turns the submitter into an applier (work-steal)
            # instead of parking it — a crimson reactor blocking here
            # would stall its whole data plane.
            with self._qcond:
                if self._db is None:
                    raise RuntimeError("store not mounted")
                if len(self._pending) < self.deferred_queue_depth \
                        or self._stop:
                    break
            if not self._pump_once():
                with self._qcond:
                    if self._db is not None and not self._stop and \
                            len(self._pending) >= \
                            self.deferred_queue_depth:
                        self._qcond.wait(0.05)
        with self._qcond:
            if self._db is None:
                raise RuntimeError("store not mounted")
            check_ops(merged_ops, self._coll_exists_q,
                      self._obj_exists_q)
            self._wal_seq += 1
            seq = self._wal_seq
            if self.path:
                merged = Transaction()
                merged.ops = merged_ops
                record = merged.encode()
            else:
                # volatile store: the WAL buys nothing a process
                # crash wouldn't lose anyway, so skip the payload
                # serialization and account the data bytes directly
                record = None
            nbytes = len(record) if record is not None else sum(
                len(op[4]) for op in merged_ops
                if op[0] in ("write", "xor_write"))
            self._txn_meta("journal_bytes", nbytes)
            self._wal_write(seq, record, nbytes)
            self._stamp_txn("journal_append")
            p = _Pending(seq, txns, merged_ops)
            p.led = led
            self._pending.append(p)
            self._admit_overlay(merged_ops, seq)
        try:
            self._wal_fsync(seq)            # group commit join
            self._stamp_txn("journal_fsync")
        except BaseException:
            # WAL durability failed: the entry must not wedge the
            # queue — seal it aborted so the applier skips past it
            with self._qcond:
                p.aborted = True
                p.led = None
                p.sealed = True
                self._qcond.notify_all()
            raise
        if led is not None:
            # hand the ledger to the applier: the base finalizes
            # nothing, the apply batch stamps the remaining phases
            led["_deferred"] = True
        with self._qcond:
            p.sealed = True
            self._qcond.notify_all()
        # commit callbacks ride WAL durability, not apply (the whole
        # point: the OSD's commit ack leaves the PG-lock path here)
        fin = self._finisher
        callbacks = [fn for txn in txns for fn in txn.on_commit]
        if on_commit is not None:
            callbacks.append(on_commit)
        if fin is not None:
            for fn in callbacks:
                fin.queue(fn)
        else:
            for fn in callbacks:
                fn()
        self._kick_apply()

    # -- deferred apply ------------------------------------------------
    def bind_apply_reactor(self, reactor) -> None:
        """Crimson wiring: schedule apply batches as reactor tasks
        instead of the background thread (which parks).  Pass None to
        unbind (shutdown)."""
        self._reactor = reactor
        # a pump queued on the reactor this replaces may never run
        self._pump_armed = False
        if reactor is not None:
            self._kick_apply()

    def _kick_apply(self) -> None:
        r = self._reactor
        if r is not None:
            if self._pump_armed:
                return          # the queued pump will see this entry
            self._pump_armed = True
            try:
                r.call_soon(self._reactor_pump)
                return
            except Exception:
                self._pump_armed = False
        with self._qcond:
            self._qcond.notify_all()

    def _reactor_pump(self) -> None:
        applied = self._pump_once()
        r = self._reactor
        if not self._pump_more(r):
            self._pump_armed = False
            # a kick that found the flag still up left its entry to
            # this pump: look once more now that the flag is down
            if not self._pump_more(r):
                return
            self._pump_armed = True
        if applied:
            r.call_soon(self._reactor_pump)
        else:
            # another thread holds the applier mutex (a reader or a
            # full queue's submitter stealing the apply): look again
            # after APPLY_RETRY_S, where re-queuing at once would spin
            # the reactor and starve that thread of the interpreter lock
            r.call_later(APPLY_RETRY_S, self._reactor_pump)

    def _pump_more(self, reactor) -> bool:
        if reactor is None:
            return False
        with self._qcond:
            return self._ready_locked() and not self._stop

    def _ready_locked(self) -> bool:
        for p in self._pending:
            if p.taken:
                continue
            return p.sealed and p.seq <= self._wal_durable_seq
        return False

    def _apply_loop(self) -> None:
        while True:
            with self._qcond:
                while not self._stop and (
                        self._reactor is not None
                        or not self._ready_locked()):
                    self._qcond.wait(0.25)
                if self._stop:
                    return
            self._pump_once()

    def _take_batch(self) -> List[_Pending]:
        """Claim the next apply batch: the longest sealed, durable,
        unclaimed prefix of the queue, up to apply_batch_txns (caller
        holds _apply_mutex)."""
        batch: List[_Pending] = []
        with self._qcond:
            for p in self._pending:
                if p.taken:
                    continue
                if not p.sealed or p.seq > self._wal_durable_seq:
                    break
                p.taken = True
                batch.append(p)
                if len(batch) >= self.apply_batch_txns:
                    break
        return batch

    def _pump_once(self) -> bool:
        """Apply one batch if one is ready and no other applier is at
        it; -> True if transactions were applied.  Work-stealing entry
        point: the background driver, a reactor task, a blocked
        reader, flush() and umount() all come through here."""
        if not self._apply_mutex.acquire(blocking=False):
            return False
        try:
            batch = self._take_batch()
            if not batch:
                return False
            self._apply_batch(batch)
            return True
        finally:
            self._apply_mutex.release()

    def _apply_batch(self, batch: List[_Pending]) -> None:
        t_dq = time.time()
        live = [p for p in batch if not p.aborted]
        for p in live:
            if p.led is not None:
                p.led["deferred_queue"] = t_dq
        kvbatch = WriteBatch()
        dirty = False
        with self._lock:
            for p in live:
                prev = getattr(_TXN_TLS, "led", None)
                _TXN_TLS.led = p.led
                mark = len(kvbatch.ops)
                try:
                    dirty = self._apply_ops(p.ops, kvbatch) or dirty
                except Exception:
                    # commit was already acked at WAL durability; a
                    # failed apply (csum EIO on an RMW base) cannot
                    # unwind it.  Roll this entry's KV ops back so
                    # the rest of the batch commits clean, and count
                    # the casualty (reference BlueStore asserts here;
                    # we degrade to a surfaced counter).
                    del kvbatch.ops[mark:]
                    self.apply_errors += 1
                finally:
                    _TXN_TLS.led = prev
            self._wbuf_flush()
            self._flush_dev(dirty)
            t_dw = time.time()
            kvbatch.set("alloc", self._alloc.state())
            kvbatch.set(APPLIED_KEY, str(batch[-1].seq).encode())
            self._db.submit(kvbatch, sync=bool(self.path))
            t_kv = time.time()
        for p in live:
            for txn in p.txns:
                for fn in txn.on_applied:
                    fn()
        t_fl = time.time()
        self.apply_batches += 1
        self.apply_txns += len(live)
        for p in live:
            led = p.led
            if led is None:
                continue
            led["data_write"] = t_dw
            led["kv_commit"] = t_kv
            led["flush"] = t_fl
            self._finalize_txn(led, p.txns)
        with self._qcond:
            self._applied_seq = batch[-1].seq
            for p in batch:
                self._pending.remove(p)
            self._ov_gc()
            self._wal_retire()
            self._qcond.notify_all()

    # -- vectored device writes ----------------------------------------
    def _write_block(self, phys: int, data: bytes) -> None:
        assert len(data) == BLOCK
        self._wbuf[phys] = data

    def _read_block(self, phys: int) -> bytes:
        buf = self._wbuf.get(phys)
        if buf is not None:
            return buf
        return super()._read_block(phys)

    def _wbuf_flush(self) -> None:
        """Land the apply batch's buffered blocks as sorted contiguous
        runs: one seek + one writelines per run instead of one
        seek+write per block (caller holds _lock)."""
        if not self._wbuf:
            return
        items = sorted(self._wbuf.items())
        dev = self._dev
        i, n = 0, len(items)
        while i < n:
            j = i + 1
            while j < n and items[j][0] == items[j - 1][0] + 1:
                j += 1
            dev.seek(items[i][0] * BLOCK)
            dev.writelines(blk for _, blk in items[i:j])
            self.vectored_runs += 1
            i = j
        self.vectored_flushes += 1
        self.vectored_blocks += n
        self._wbuf.clear()

    def _flush_dev(self, dirty: bool) -> None:
        if not self.path:
            return                       # BytesIO: nothing to fsync
        super()._flush_dev(dirty)

    # -- batched checksums ---------------------------------------------
    def attach_device_batcher(self, backend_fn: Callable) -> None:
        """OSD wiring: ``backend_fn()`` -> the live codec backend (or
        None).  Resolved per batch, because the EncodeBatcher only
        learns its backend after the first device dispatch."""
        self._csum_backend_fn = backend_fn

    def _crc_block(self, ext: _Extents, lb: int, blk: bytes) -> None:
        # defer: placeholder 0 means "unknown" to every reader, so
        # intra-batch RMW/materialize reads stay correct pre-fold
        self._crcq.append((ext, lb, blk))
        ext.crcs[lb] = 0

    def _crc_fold(self) -> None:
        q = self._crcq
        if not q:
            return
        self._crcq = []
        crcs = self._crc_batch([blk for _, _, blk in q])
        for (ext, lb, _), c in zip(q, crcs):
            ext.crcs[lb] = int(c)

    def _crc_batch(self, blocks: List[bytes]) -> List[int]:
        """One batched CRC pass over an apply batch's blocks.  Device
        route only when the attached codec backend has the bitmatrix
        kernel AND runs on a CUDA card (the deep-scrub gate,
        osd/ecbackend.py); a plain-CPU host loop is strictly faster
        than the bitplane matmul, so that is the fallback.  A device
        pass that raises is served by the host loop and counted in
        ``csum_device_errors``, its exception kept in
        ``csum_last_error``."""
        self.csum_batches += 1
        self.csum_blocks += len(blocks)
        fn = self._csum_backend_fn
        if fn is not None and len(blocks) > 1:
            try:
                backend = fn()
                if backend is not None and \
                        hasattr(backend, "apply_bitmatrix_bytes") and \
                        getattr(backend, "is_cuda", False):
                    from ..ops import crclinear
                    out = crclinear.shared().crc_batch(
                        blocks, backend=backend)
                    self.csum_device_batches += 1
                    return [int(c) for c in out]
            except Exception as e:       # host loop serves
                self.csum_device_errors += 1
                self.csum_last_error = e
        return [crc32c(b) for b in blocks]

    # -- read barrier ----------------------------------------------------
    def _wait_applied(self, seq: int) -> None:
        """Block until WAL seq ``seq`` is applied, stealing the apply
        work when the background driver doesn't get there first."""
        self._wal_fsync(seq)
        while True:
            with self._qcond:
                if self._applied_seq >= seq or self._db is None:
                    return
            if self._pump_once():
                continue
            with self._qcond:
                if self._applied_seq >= seq or self._db is None:
                    return
                self._qcond.wait(0.05)

    def _barrier(self, coll: str,
                 obj: Optional[GHObject] = None) -> None:
        with self._qcond:
            seq = self._pending_seq_for(coll, obj)
            if seq <= self._applied_seq:
                return
        self._wait_applied(seq)

    def _barrier_all(self) -> None:
        with self._qcond:
            seq = max((p.seq for p in self._pending),
                      default=self._applied_seq)
            if seq <= self._applied_seq:
                return
        self._wait_applied(seq)

    def flush(self) -> None:
        """Drain: every queued transaction applied, every commit
        callback delivered (reference ObjectStore::flush)."""
        self._barrier_all()
        fin = self._finisher
        if fin is not None:
            fin.wait_for_empty()

    # -- reads (commit→apply window correctness) -----------------------
    def exists(self, coll: str, obj: GHObject) -> bool:
        # non-blocking: the admission overlay already knows the answer
        with self._qcond:
            e = self._ov_objs.get((coll, obj))
            w = self._ov_wiped.get(coll)
            if e is not None and (w is None or e[1] >= w):
                return e[0]
            if w is not None:
                return False
        return super().exists(coll, obj)

    def collection_exists(self, coll: str) -> bool:
        with self._qcond:
            st = self._ov_colls.get(coll)
            if st is not None:
                return st[0]
        return super().collection_exists(coll)

    def read(self, coll: str, obj: GHObject, offset: int = 0,
             length: Optional[int] = None) -> bytes:
        self._barrier(coll, obj)
        return super().read(coll, obj, offset, length)

    def stat(self, coll: str, obj: GHObject):
        self._barrier(coll, obj)
        return super().stat(coll, obj)

    def getattr(self, coll: str, obj: GHObject, name: str) -> bytes:
        # hot path: the EC write pipeline reads the hinfo and
        # object-info xattrs before every sub-write, and both are
        # setattr'd by the previous sub-write's transaction — so the
        # admission overlay almost always has the latest value and a
        # full apply barrier here would re-serialize the deferred
        # pipeline
        with self._qcond:
            dirty = self._ov_attr_dirty.get((coll, obj), -1)
            w = self._ov_wiped.get(coll)
            if w is not None and w > dirty:
                dirty = w
            hit = self._ov_attrs.get((coll, obj, name))
            if hit is not None and hit[1] > dirty:
                if hit[0] is _ATTR_DEL:
                    raise KeyError(name)
                return hit[0]
            exists_in_window = False
            if dirty < 0:
                e = self._ov_objs.get((coll, obj))
                exists_in_window = e is not None and e[0]
        if dirty >= 0:
            # identity changed (remove/clone/rename) with no newer
            # pending value: only the applied KV knows the answer
            self._barrier(coll, obj)
            return super().getattr(coll, obj, name)
        # overlay miss, identity stable: the KV value (a point-in-time
        # read under the base lock) is current — no barrier
        try:
            return super().getattr(coll, obj, name)
        except FileNotFoundError:
            if exists_in_window:
                # object created in the pending window, attr never set
                raise KeyError(name)
            raise

    def getattrs(self, coll: str, obj: GHObject) -> Dict[str, bytes]:
        self._barrier(coll, obj)
        return super().getattrs(coll, obj)

    def omap_get(self, coll: str, obj: GHObject) -> Dict[str, bytes]:
        self._barrier(coll, obj)
        return super().omap_get(coll, obj)

    def omap_get_header(self, coll: str, obj: GHObject) -> bytes:
        self._barrier(coll, obj)
        return super().omap_get_header(coll, obj)

    def omap_get_keys(self, coll: str, obj: GHObject,
                      start_after: str = "",
                      max_return: Optional[int] = None) -> List[str]:
        self._barrier(coll, obj)
        return super().omap_get_keys(coll, obj, start_after,
                                     max_return)

    def list_collections(self) -> List[str]:
        self._barrier_all()
        return super().list_collections()

    def collection_list(self, coll: str, start_after: str = "",
                        max_return: Optional[int] = None
                        ) -> List[GHObject]:
        self._barrier_all()
        return super().collection_list(coll, start_after, max_return)

    # -- introspection -------------------------------------------------
    def usage(self) -> Dict:
        if self.path:
            out = super().usage()
        else:
            with self._lock:
                buf = self._dev.getbuffer()
                dev_bytes = buf.nbytes
                buf.release()
                out = {"block_size": BLOCK,
                       "blocks_used": self._alloc.used(),
                       "bytes_used": self._alloc.used() * BLOCK,
                       "dev_bytes": dev_bytes,
                       "compress_logical_bytes":
                           self.compress_logical_bytes,
                       "compress_stored_bytes":
                           self.compress_stored_bytes,
                       "csum_failures": self.csum_failures}
        with self._qcond:
            out["deferred_pending"] = len(self._pending)
        out["wal"] = {
            "records": self.wal_records,
            "bytes": self.wal_bytes,
            "group_syncs": self.wal_group_syncs,
            "group_txns": self.wal_group_txns,
            "durable_seq": self._wal_durable_seq,
            "applied_seq": self._applied_seq,
        }
        out["apply"] = {
            "batches": self.apply_batches,
            "txns": self.apply_txns,
            "errors": self.apply_errors,
            "vectored_flushes": self.vectored_flushes,
            "vectored_blocks": self.vectored_blocks,
            "vectored_runs": self.vectored_runs,
        }
        out["csum"] = {
            "batches": self.csum_batches,
            "blocks": self.csum_blocks,
            "device_batches": self.csum_device_batches,
            "device_errors": self.csum_device_errors,
        }
        return out
