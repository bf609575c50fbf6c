"""Erasure-coded PG backend.

Python-native equivalent of the reference's ECBackend (reference
src/osd/ECBackend.{h,cc}, 2.6k LoC), the engine behind every EC pool:

* **writes** run the reference's pipeline
  ``waiting_state -> waiting_reads -> waiting_commit`` driven by
  ``check_ops()`` (reference ECBackend.cc:2151-2156): a mutation whose
  stripes are partially overwritten first gathers RMW reads
  (``try_state_to_reads``, :1865), then encodes and fans out per-shard
  sub-writes (``try_reads_to_commit``, :1939) — the **encode happens
  here**, and is where this framework diverges device-first: the
  whole aligned extent goes to the OSD's cross-op batcher
  (osd/batcher.py) as ONE ``[nstripes, k, chunk]`` array, where it
  coalesces with concurrent ops from other PGs into a single device
  call (kernel B1 for byte codes, B2/B3 for packet codes) instead of
  the reference's per-stripe CPU loop (ECUtil.cc:136-148);
* **reads** reconstruct from the minimum shard set
  (``objects_read_and_reconstruct`` -> ECSubRead fan-out ->
  batched decode; reference ECBackend.cc:2345,1594,2287);
* **recovery** reads k surviving shards, decodes the missing shards'
  chunks in one batch and pushes with MOSDPGPush (reference
  continue_recovery_op FSM IDLE->READING->WRITING, ECBackend.cc:
  570-736); when the primary itself lacks the object its metadata is
  first fetched from a surviving peer (the reference's pull path);
* per-shard cumulative-CRC ``HashInfo`` xattrs maintained on appends
  and consumed by deep scrub (reference ECBackend.cc:2475).

Every host route that stands in for the card is counted: degraded
reads and recovery decodes the batcher's crossover sends to its CPU
twin (``twin_routes``), decodes that failed on the device codec
(``device_errors``), and deep-scrub windows recomputed by the host loop
after the device apply raised (``scrub_host_fallbacks``, with
``scrub_last_error``).

Pools without ``ec_overwrites`` reject non-append writes, omap and
truncate exactly like the reference (allows_ecoverwrites,
osd/osd_types.h:1600; omap ENOTSUP per
doc/dev/osd_internals/erasure_coding/ecbackend.rst) — enforced by the
PG before submit.

Writes serialize through a strictly FIFO per-PG pipeline, exactly like
the reference's in-order 3-queue state machine (ECBackend.cc:2151):
sub-writes — and with them PG-log entries — always apply in submission
order, which keeps every shard's log monotonic.  Overlapping RMW ops
pipeline deeper than one: an in-flight extent overlay (the reference
ExtentCache analog, ECBackend.cc:1891-1920; see ``_overlay`` below)
lets a later op's RMW reads see earlier ops' not-yet-committed bytes,
so multiple writes to one object proceed concurrently without
read-your-own-write hazards.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..msg.messages import (MOSDECSubOpRead, MOSDECSubOpReadReply,
                            MOSDECSubOpWrite, MOSDECSubOpWriteReply,
                            MOSDPGPush, MOSDPGPushReply, PushOp)
from ..store.objectstore import GHObject, Transaction
from ..utils import copytrack
from ..utils import faults as faultlib
from . import ecutil
from .backend import OI_ATTR, Mutation, ObjectInfo, PGBackend, PGHost
from .pglog import Eversion, LogEntry


class _HostCrcWindow(Exception):
    """Scrub-window routing verdict: the batched bitmatrix apply
    would lose to the native per-chunk host CRC kernel here (no
    accelerator, no syndrome bands to fold) — take the host loop."""


class _WriteOp:
    """One in-flight client write (reference ECBackend::Op).

    Pipeline states: PENDING (queued, not started) -> RMW (started,
    gathering reads / encoding) -> ENCODED (chunks ready, awaiting
    its turn to send) -> SENT (sub-writes out) -> DONE.  Barrier ops
    (anything beyond plain data writes) start only at the pipeline
    head and block everything behind them."""

    PENDING, RMW, ENCODED, SENT, DONE = range(5)

    def __init__(self, tid: int, oid: str, mutation: Mutation,
                 at_version: Eversion, log_entries: List[LogEntry],
                 on_all_commit: Callable[[int], None]):
        self.tid = tid
        self.oid = oid
        self.mutation = mutation
        self.at_version = at_version
        self.log_entries = log_entries
        self.on_all_commit = on_all_commit
        self.to_read: Optional[Tuple[int, int]] = None   # aligned extent
        self.read_data: bytes = b""
        self.obj_info = None             # fetched once in _start_rmw
        # shard -> outstanding sub-write commits.  One count per shard
        # for ordinary ops; segs_total counts for segmented ops (one
        # sub-write per segment, replies decrement)
        self.pending_commits: Dict[int, int] = {}
        self.state = self.PENDING
        # pipelined segmented fanout (large aligned writes): encode of
        # segment N+1 overlaps the sub-write fanout of segment N.
        # Metadata (log entries, OI, hinfo finalisation) rides ONLY
        # the final segment's transaction, so a crash mid-op leaves
        # the partial data invisible (object size never advanced).
        self.segs_total = 1
        self.segs_sent = 0
        self.seg_ready: Dict[int, Dict[int, bytes]] = {}
        self.seg_bufs: List = []
        self.seg_astart = 0              # whole-op aligned bounds
        self.seg_hi = 0
        self.seg_width = 0               # logical bytes per segment
        self.seg_chunk_off0 = 0
        self.seg_is_append = False
        self.seg_hinfo = None            # running HashInfo across segs
        self.barrier = True
        self.alive = True                # False after on_change()
        self.tracked = False             # registered in extent overlay
        self.encoded: Optional[Tuple] = None  # (astart, hi, chunks)
        self.committed_size = 0          # store-visible size at start
        self.projected_base = 0          # + earlier in-flight writes
        self.seq = 0                     # submission order (overlay)
        self.poisoned = 0                # errno: earlier same-obj op
                                         # failed after we may have
                                         # absorbed its bytes
        # sub-write deadline state (osd_ec_subwrite_timeout_ms):
        # acked_segs dedups commit replies per (shard, seg) so a
        # deadline re-request whose original ack was merely slow can't
        # double-decrement pending_commits; sent_subwrites retains the
        # wire fields of every remote sub-write (only while the
        # timeout is armed) so a laggard can be re-requested verbatim
        self.acked_segs: Dict[int, Set[int]] = {}
        self.sent_subwrites: Dict[Tuple[int, int], Tuple] = {}
        self.deadline_timer = None
        # parity-delta RMW (sub-stripe overwrite): read plan while the
        # dirty columns' old chunks are in flight, then the lowered
        # txn plan (cols, new dirty-column bytes, chunk_off, Δparity)
        self.delta_pending: Optional[Tuple] = None
        self.delta_txn: Optional[Tuple] = None


class _ReadOp:
    """One in-flight reconstructing read (reference ECBackend::ReadOp).
    ``ranges`` optionally narrows a shard's read to sub-chunk byte
    runs (CLAY repair); a shard's received payload is the in-order
    concatenation of its runs."""

    def __init__(self, tid: int, oid: str, chunk_off: int,
                 chunk_len: int, want_shards: Dict[int, int],
                 cb: Callable[[Dict[int, bytes], Dict[int, int]], None],
                 tried: Optional[Set[int]] = None,
                 ranges: Optional[Dict[int, List[Tuple[int, int]]]]
                 = None, need: Optional[int] = None):
        self.tid = tid
        self.oid = oid
        self.chunk_off = chunk_off
        self.chunk_len = chunk_len
        self.want_shards = want_shards       # shard -> osd
        self.ranges = ranges or {}           # shard -> [(off, len)]
        self.received: Dict[int, bytes] = {}
        self.errors: Dict[int, int] = {}
        self.tried: Set[int] = tried or set(want_shards)
        self.cb = cb                         # (shard->bytes, shard->err)
        # fast_read (reference ECBackend.cc:1043,2173 fast_read /
        # send_all_remaining_reads): when set, the op completes as soon
        # as ``need`` shards answered successfully — the remaining
        # (slow/dead) shards' replies are dropped as stragglers
        self.need = need


class _RecoveryOp:
    """reference ECBackend::RecoveryOp FSM state."""

    def __init__(self, oid: str, version: Eversion,
                 missing_on: List[Tuple[int, int]],
                 cb: Callable[[int], None]):
        self.oid = oid
        self.version = version
        self.missing_on = missing_on         # [(shard, osd)]
        self.cb = cb
        self.pending_pushes: Set[int] = set()


class ECBackend(PGBackend):
    def __init__(self, host: PGHost, ec_impl, stripe_width: int,
                 allows_overwrites: bool = False):
        super().__init__(host)
        self.ec_impl = ec_impl
        self.k = ec_impl.get_data_chunk_count()
        self.m = ec_impl.get_coding_chunk_count()
        self.sinfo = ecutil.StripeInfo(self.k, stripe_width)
        self.allows_overwrites = allows_overwrites
        # pipelined commit fanout: writes larger than this are encoded
        # and fanned out segment-by-segment (0 disables)
        try:
            seg = host.conf["osd_ec_pipeline_segment_bytes"]
        except (AttributeError, KeyError, TypeError):
            seg = 2 << 20
        self.seg_bytes = 0
        if seg:
            # stripe-align the segment so every segment encodes whole
            # stripes
            self.seg_bytes = max(stripe_width,
                                 seg - seg % stripe_width)
        # parity-delta RMW (sub-stripe overwrites): GF(2^8) linearity
        # gives new_parity = old_parity ^ M[:, dirty]·(new ^ old), so
        # a small overwrite of committed stripes reads back ONLY the
        # dirty data columns, device-computes the Δparity once on the
        # primary (osd/batcher.py submit_delta), and ships parity
        # shards an xor_write the store applies against the committed
        # parity.  Clean data shards carry metadata only.
        # (no allows_overwrites gate here: the PG rejects partial
        # overwrites on non-overwrite pools long before submit, and
        # the flag may flip after this backend was built)
        try:
            dn = host.conf["osd_ec_delta_rmw"]
        except (AttributeError, KeyError, TypeError):
            dn = True
        self.delta_rmw = bool(dn)
        # dirty-column fraction above which the full re-encode wins
        # (most of the stripe comes back anyway, and one plain encode
        # beats read+delta at that point)
        try:
            frac = host.conf["osd_ec_delta_rmw_max_dirty"]
        except (AttributeError, KeyError, TypeError):
            frac = 0.5
        self.delta_max_dirty = float(frac)
        self.delta_rmw_ops = 0           # ops lowered to Δparity
        self.delta_rmw_fallbacks = 0     # eligible, but a dirty-shard
                                         # read failed -> full path
        self.rmw_full_ops = 0            # read-back ops on full path
        self.delta_dirty_census: Dict[int, int] = {}   # D -> op count
        # host routes that stand in for the card, each counted
        self.twin_routes = 0             # decodes sent to the CPU twin
        self.device_errors = 0           # decodes the device codec failed
        self.last_device_error: Optional[BaseException] = None
        self.scrub_windows = 0           # deep-scrub CRC windows
        self.scrub_crc_bytes = 0
        self.scrub_device_windows = 0    # windows through crclinear
        self.scrub_host_fallbacks = 0    # windows the host recomputed
        self.scrub_last_error: Optional[BaseException] = None
        # write pipeline queues (reference ECBackend.cc:2151)
        self.waiting_commit: Dict[int, _WriteOp] = {}
        self.in_flight_reads: Dict[int, _ReadOp] = {}
        self.attr_fetches: Dict[int, Tuple] = {}    # tid -> (rec,)
        self.recovery_ops: Dict[str, _RecoveryOp] = {}
        # write pipeline: encodes run CONCURRENTLY (depth > 1), but
        # sub-write fan-out happens strictly in submission order so
        # every shard's log stays monotonic (reference check_ops
        # ordering contract, ECBackend.cc:2151); the extent overlay
        # below plays the reference ExtentCache's role for RMW reads
        # of in-flight bytes
        self._pipeline: deque = deque()
        # oid -> {"ops": n, "writes": [(off, bytes)...] in submission
        # order, "size": projected logical size} for STARTED plain
        # writes (reference ExtentCache pins)
        self._pending_objs: Dict[str, Dict] = {}
        self.max_pipeline_depth = 0      # queued depth high-water
        self.max_concurrent_ops = 0      # simultaneously EXECUTING
        # total bytes requested through _start_read (observability +
        # the CLAY repair-bandwidth test)
        self.read_bytes_total = 0
        self.subchunk_repairs = 0        # CLAY repairs taken
        self.repair_read_bytes = 0       # bytes those repairs read
        self.repair_whole_bytes = 0      # what whole-chunk would read
        # sub-write deadlines (osd_ec_subwrite_timeout_ms; 0 disables):
        # the primary re-requests a laggard shard's sub-write once,
        # then reports the peer to the monitor like a failed heartbeat
        try:
            tmo = host.conf["osd_ec_subwrite_timeout_ms"]
        except (AttributeError, KeyError, TypeError):
            tmo = 0.0
        self.subwrite_timeout_s = (tmo or 0.0) / 1000.0
        self.subwrite_timeouts = 0       # deadlines that expired
        self.subwrite_retries = 0        # sub-writes re-requested
        self.subwrite_peer_reports = 0   # laggards reported to the mon
        # shard-side dedup of re-requested sub-writes, keyed
        # (from_osd, tid, seg): True once committed (a duplicate
        # re-acks — the original ack was lost), False while the first
        # apply is still in flight (its ack is coming; stay silent)
        self._recent_subwrites: Dict[Tuple[int, int, int], bool] = {}
        # pay the pool geometry's one-time costs (device kernel
        # compile + the crossover router's CPU-rate probe) NOW, in the
        # background, instead of on the first client op — the
        # reference pays GF table setup at plugin load
        # (jerasure_init.cc:37, preloaded at global_init.cc:600)
        batcher = getattr(host, "encode_batcher", None)
        if batcher is not None:
            try:
                batcher.prewarm(ec_impl, self.sinfo)
            except Exception:
                pass

    #: geometry keys whose activation prewarm already ran (the work is
    #: per-process; activation happens per PG)
    _activation_warmed: Set[tuple] = set()
    #: activation warm threads not yet joined
    _activation_threads: List[threading.Thread] = []

    @classmethod
    def join_activation_warms(cls, timeout: float = 60.0) -> None:
        """Wait for the activation warms started so far.  A warm thread
        still inside a torch call when the interpreter exits aborts the
        process ("terminate called without an active exception"), so a
        cluster joins them when it stops."""
        while cls._activation_threads:
            cls._activation_threads.pop().join(timeout)

    def prewarm_geometry(self) -> None:
        """Make the pool's (k, m, stripe) device executables and
        staging buffers hot BEFORE the first client write — invoked
        from PG activation (pg.py _activate).  Construction-time
        ``batcher.prewarm`` covers the crossover probe and cold
        compile; this adds the persistent staging rings
        (torch_engine StagingPool) for the batch shapes the coalescer
        dispatches, via the codec's prewarm_geometry.  Background
        thread, idempotent per geometry process-wide."""
        batcher = getattr(self.host, "encode_batcher", None)
        if batcher is not None:
            try:
                batcher.prewarm(self.ec_impl, self.sinfo)
            except Exception:
                pass
        warm = getattr(self.ec_impl, "prewarm_geometry", None)
        if warm is None:
            return
        key = (type(self.ec_impl).__name__, self.k, self.m,
               self.sinfo.chunk_size)
        if key in ECBackend._activation_warmed:
            return
        ECBackend._activation_warmed.add(key)
        ms = max(1, getattr(batcher, "max_stripes", 1) or 1)
        batches = tuple(sorted({ms, max(1, ms // 2)}))
        chunk = self.sinfo.chunk_size

        warm_dec = getattr(self.ec_impl, "prewarm_decode", None)

        def work():
            try:
                warm(chunk, batches=batches)
            except Exception:
                pass             # warms are best-effort
            if warm_dec is not None:
                # decode-side activation warm: the common
                # single-erasure recovery signatures (combined
                # recovery rows + staging ring + one compiled decode
                # executable), so the first rebuild window after an
                # OSD loss pays no compile/alloc tax.  The decode
                # crossover itself needs no warm — it seeds from the
                # encode EWMA the batcher.prewarm above measures
                # (EncodeBatcher._dec_min_bytes).
                try:
                    warm_dec(chunk, batches=batches)
                except Exception:
                    pass

        t = threading.Thread(target=work, name="ec-activate-prewarm",
                             daemon=True)
        ECBackend._activation_threads.append(t)
        t.start()

    # ------------------------------------------------------------------
    # write path (reference submit_transaction -> start_rmw -> check_ops)
    # ------------------------------------------------------------------
    def submit_transaction(self, oid: str, mutation: Mutation,
                           at_version: Eversion,
                           log_entries: List[LogEntry],
                           on_all_commit: Callable[[int], None]) -> None:
        op = _WriteOp(self.new_tid(), oid, mutation, at_version,
                      log_entries, on_all_commit)
        # plain data writes pipeline (depth > 1); anything that
        # touches object lifecycle or metadata beyond the write is a
        # BARRIER: it waits for the pipeline and blocks what follows
        # (the reference pins such ops through the cache too; this
        # split keeps the overlay algebra to pure byte extents)
        mut = mutation
        op.barrier = not (mut.writes and mut.truncate is None
                          and not mut.delete and not mut.create
                          and mut.clone_to is None
                          and mut.rollback_from is None
                          and not mut.aux_remove
                          and mut.snapdir_set is None)
        self._op_seq = getattr(self, "_op_seq", 0) + 1
        op.seq = self._op_seq
        self._pipeline.append(op)
        self.max_pipeline_depth = max(self.max_pipeline_depth,
                                      len(self._pipeline))
        self._admit_ops()

    def _admit_ops(self) -> None:
        """Start every op that may legally run: the consecutive run
        of non-barrier ops at the head, or a barrier exactly at the
        head (reference check_ops admission)."""
        for op in list(self._pipeline):
            if op.barrier:
                if op.state == op.PENDING \
                        and self._pipeline[0] is op:
                    op.state = op.RMW
                    self._start_rmw(op)
                break                # nothing may pass a barrier
            if op.state == op.PENDING:
                op.state = op.RMW
                self._track_pending(op)
                self._start_rmw(op)
        running = sum(1 for o in self._pipeline
                      if o.state in (o.RMW, o.ENCODED, o.SENT))
        self.max_concurrent_ops = max(self.max_concurrent_ops,
                                      running)

    # -- extent overlay (reference ExtentCache) ------------------------
    def _track_pending(self, op: _WriteOp) -> None:
        st = self._pending_objs.setdefault(
            op.oid, {"ops": 0, "writes": [], "size": 0})
        st["ops"] += 1
        op.tracked = True
        # snapshot the projection BEFORE this op's own writes land
        op.projected_base = max(st["size"], 0)
        for off, data in op.mutation.writes:
            st["writes"].append((op.seq, off, data))
            st["size"] = max(st["size"], off + len(data))

    def _untrack_pending(self, op: _WriteOp,
                         failed: bool = False) -> None:
        if not op.tracked:
            return
        op.tracked = False
        st = self._pending_objs.get(op.oid)
        if st is None:
            return
        st["ops"] -= 1
        if failed:
            # a FAILED op's bytes must never reach another op's
            # encode; any later op that may already have absorbed
            # them gets poisoned by the caller
            st["writes"] = [w for w in st["writes"]
                            if w[0] != op.seq]
        if st["ops"] <= 0:
            # no in-flight writes left: committed state has absorbed
            # every overlay byte — drop the object's cache.
            # (Successful ops' entries stay until then: a concurrent
            # reader's shard data may still predate them.)
            del self._pending_objs[op.oid]

    def _overlay(self, oid: str, buf: bytearray, astart: int,
                 before_seq: int) -> None:
        """Apply in-flight writes SUBMITTED BEFORE ``before_seq``
        intersecting [astart, astart+len(buf)), in submission order —
        the ExtentCache read: projected bytes come from memory, never
        from shards whose application state is in flux.  Later ops'
        bytes must not leak backwards in time."""
        st = self._pending_objs.get(oid)
        if st is None:
            return
        aend = astart + len(buf)
        for seq, off, data in st["writes"]:
            if seq >= before_seq:
                continue
            lo = max(off, astart)
            hi = min(off + len(data), aend)
            if lo < hi:
                buf[lo - astart:hi - astart] = \
                    data[lo - off:hi - off]

    def _overlay_covers(self, oid: str, lo: int, hi: int,
                        committed_end: int, before_seq: int) -> bool:
        """True when [lo,hi) needs no shard read: every byte is either
        beyond the committed size (zeros + overlay) or covered by an
        in-flight write."""
        if lo >= committed_end:
            return True
        st = self._pending_objs.get(oid)
        if st is None:
            return False
        spans = sorted((off, off + len(d))
                       for seq, off, d in st["writes"]
                       if seq < before_seq)
        pos = lo
        end = min(hi, committed_end)
        for s, e in spans:
            if s > pos:
                return False
            pos = max(pos, e)
            if pos >= end:
                return True
        return pos >= end

    def _fail_op(self, op: _WriteOp, err: int) -> None:
        """Fail an op mid-pipeline.  Its overlay bytes are withdrawn,
        and any LATER in-flight op on the same object that may already
        have absorbed them into its encode fails too (the client is
        told; nothing lands silently)."""
        self.waiting_commit.pop(op.tid, None)
        self._cancel_deadline(op)
        op.on_all_commit(err)
        self._untrack_pending(op, failed=True)
        for o in self._pipeline:
            if o.seq > op.seq and o.oid == op.oid \
                    and o.state != o.DONE and not o.poisoned:
                o.poisoned = err
                self._untrack_pending(o, failed=True)
        self._complete_op(op)

    def _start_rmw(self, op: _WriteOp) -> None:
        """Compute the WritePlan (reference get_write_plan,
        ECTransaction.h:40): which existing stripes must be read back
        before this mutation can be encoded.  For pipelined ops the
        logical size projects over the in-flight writes (the overlay
        below plays ExtentCache), so sizes/appends stay correct even
        though earlier ops have not committed yet."""
        info = self.get_object_info(op.oid)
        mut = op.mutation
        if mut.create and info is not None:
            op.on_all_commit(-17)        # -EEXIST: exclusive create
            self._complete_op(op)
            return
        op.obj_info = info = info or ObjectInfo()
        op.committed_size = info.size
        if op.tracked:
            # logical size as of this op's admission: committed state
            # plus every earlier in-flight write
            info.size = max(info.size, op.projected_base)
        if mut.delete or not mut.writes:
            self._reads_to_commit(op)
            return
        lo = min(off for off, _ in mut.writes)
        hi = max(off + len(d) for off, d in mut.writes)
        astart, alen = self.sinfo.offset_len_to_stripe_bounds(lo, hi - lo)
        # existing bytes inside the affected aligned range that the new
        # data does not fully cover must be read back (RMW); bytes the
        # accompanying truncate will discard don't count (writefull)
        existing_end = min(info.size, astart + alen)
        if mut.truncate is not None:
            # the truncate applies BEFORE the writes (pg.py projects
            # sizes the same way): bytes at/above it are discarded and
            # must not be read back — including bytes BELOW the write
            # start, which become zeros, not resurrected stale data
            existing_end = min(existing_end, mut.truncate)
        if existing_end <= astart or \
                self._fully_covers(mut.writes, astart, existing_end) \
                or self._overlay_covers(op.oid, astart, existing_end,
                                        op.committed_size,
                                        op.seq + 1):
            # nothing to read from shards: gaps are zeros/overlay —
            # the ExtentCache fast path (reference ECBackend.cc:
            # 1891-1920: in-flight extents served from cache)
            self._reads_to_commit(op)
            return
        if self._try_delta_rmw(op, lo, hi, astart, alen):
            return
        self.rmw_full_ops += 1
        op.to_read = (astart, existing_end - astart)
        if mut.tracked_op is not None:
            mut.tracked_op.mark_event("ec:rmw_read")
        self.objects_read(
            op.oid, astart, min(existing_end, op.committed_size)
            - astart,
            lambda res, data: self._rmw_read_done(op, res, data),
            trace=(mut.trace_id, mut.parent_span_id))

    @staticmethod
    def _fully_covers(writes: List[Tuple[int, bytes]], lo: int,
                      hi: int) -> bool:
        """True if [lo,hi) is entirely covered by the write extents."""
        if hi <= lo:
            return True
        spans = sorted((off, off + len(d)) for off, d in writes)
        pos = lo
        for s, e in spans:
            if s > pos:
                return False
            pos = max(pos, e)
            if pos >= hi:
                return True
        return pos >= hi

    # -- parity-delta RMW (sub-stripe overwrite) -----------------------
    def _try_delta_rmw(self, op: _WriteOp, lo: int, hi: int,
                       astart: int, alen: int) -> bool:
        """Sub-stripe overwrite fast path.  Eligible when the mutation
        is a plain tracked write entirely inside committed stripes, no
        earlier in-flight write overlaps the extent (those bytes are
        not on shards yet — the overlay algebra stays on the full
        path), the dirty-column fraction is small enough, and every
        dirty column's shard is up (the old bytes are read verbatim,
        never reconstructed — reconstruction is the full path's job).
        Returns True when the delta read plan was started."""
        mut = op.mutation
        if not self.delta_rmw or not op.tracked:
            return False                 # barriers keep the full path
        if hi > op.committed_size:
            return False                 # extends the object: stripes
                                         # beyond committed aren't on
                                         # shards yet
        batcher = getattr(self.host, "encode_batcher", None)
        if batcher is None or \
                not hasattr(self.ec_impl, "delta_encode_batch_async"):
            return False
        st = self._pending_objs.get(op.oid)
        if st is not None:
            for seq, off, data in st["writes"]:
                if seq < op.seq and off < astart + alen \
                        and off + len(data) > astart:
                    return False
        cols = self._dirty_columns(mut.writes, astart, alen)
        if not cols or len(cols) > self.k * self.delta_max_dirty:
            return False                 # dirty majority: re-encode
        acting = {s: o for s, o in self.host.acting_shards()
                  if o is not None}
        if any(c not in acting for c in cols):
            return False
        chunk_off = \
            self.sinfo.aligned_logical_offset_to_chunk_offset(astart)
        chunk_len = self.sinfo \
            .aligned_logical_offset_to_chunk_offset(astart + alen) \
            - chunk_off
        op.delta_pending = (astart, alen, hi, cols, chunk_off,
                            chunk_len)
        self.delta_rmw_ops += 1
        self.delta_dirty_census[len(cols)] = \
            self.delta_dirty_census.get(len(cols), 0) + 1
        if mut.tracked_op is not None:
            mut.tracked_op.mark_event("ec:rmw_delta_read")
        self._start_read(
            op.oid, chunk_off, chunk_len,
            {c: acting[c] for c in cols},
            lambda received, errors:
                self._delta_read_done(op, received, errors),
            trace=(mut.trace_id, mut.parent_span_id))
        return True

    def _dirty_columns(self, writes: List[Tuple[int, bytes]],
                       astart: int, alen: int) -> Tuple[int, ...]:
        """Data columns (chunk indices) any write byte lands in,
        across every stripe row of the aligned extent."""
        W = self.sinfo.stripe_width
        cs = self.sinfo.chunk_size
        cols: Set[int] = set()
        for off, data in writes:
            w_lo = max(off, astart)
            w_hi = min(off + len(data), astart + alen)
            if w_lo >= w_hi:
                continue
            for r in range((w_lo - astart) // W,
                           (w_hi - astart + W - 1) // W):
                s0 = astart + r * W
                l = max(w_lo, s0)
                h = min(w_hi, s0 + W)
                cols.update(range((l - s0) // cs,
                                  (h - s0 + cs - 1) // cs))
                if len(cols) >= self.k:
                    return tuple(range(self.k))
        return tuple(sorted(cols))

    def _delta_read_done(self, op: _WriteOp,
                         received: Dict[int, bytes],
                         errors: Dict[int, int]) -> None:
        """Old dirty-column chunks arrived: build the XOR delta in
        column space and hand it to the batcher's delta lane (ONE
        GF delta-matmul per coalesced batch on the device)."""
        if not op.alive:
            return
        astart, alen, hi, cols, chunk_off, chunk_len = op.delta_pending
        batcher = getattr(self.host, "encode_batcher", None)
        if batcher is None or errors or \
                any(len(received.get(c, b"")) != chunk_len
                    for c in cols):
            # a dirty shard couldn't serve its old chunk verbatim:
            # reconstruct through the ordinary full-stripe read-back
            # instead — correctness never rides the fast path
            self._delta_fallback(op)
            return
        import numpy as np
        cs = self.sinfo.chunk_size
        W = self.sinfo.stripe_width
        nrows = alen // W
        old = np.stack(
            [np.frombuffer(received[c], dtype=np.uint8)
             .reshape(nrows, cs) for c in cols], axis=1)
        new = old.copy()
        copytrack.note_copy(old.nbytes, "ecbackend.delta_stage")
        colidx = {c: i for i, c in enumerate(cols)}
        for off, data in op.mutation.writes:
            w_lo = max(off, astart)
            w_hi = min(off + len(data), astart + alen)
            if w_lo >= w_hi:
                continue
            src = np.frombuffer(data, dtype=np.uint8)
            for r in range((w_lo - astart) // W,
                           (w_hi - astart + W - 1) // W):
                s0 = astart + r * W
                for c in cols:
                    c0 = s0 + c * cs
                    l = max(w_lo, c0)
                    h = min(w_hi, c0 + cs)
                    if l < h:
                        new[r, colidx[c], l - c0:h - c0] = \
                            src[l - off:h - off]
        delta = old
        delta ^= new                     # in place: old is dead after
        new_cols = {
            c: memoryview(np.ascontiguousarray(new[:, i])).cast("B")
            for i, c in enumerate(cols)}
        op.delta_pending = (astart, hi, cols, new_cols, chunk_off)
        if op.mutation.tracked_op is not None:
            op.mutation.tracked_op.mark_event("ec:encode_queued")
        batcher.submit_delta(
            self.ec_impl, self.sinfo, delta, cols,
            lambda dp: self._delta_encode_done(op, dp),
            tracked=op.mutation.tracked_op)

    def _delta_fallback(self, op: _WriteOp) -> None:
        """Delta read failed (dirty shard down/short mid-flight): take
        the ordinary reconstructing read-back, which decodes the
        extent from any k shards."""
        astart, alen = op.delta_pending[0], op.delta_pending[1]
        op.delta_pending = None
        self.delta_rmw_fallbacks += 1
        self.rmw_full_ops += 1
        mut = op.mutation
        info = op.obj_info or ObjectInfo()
        existing_end = min(info.size, astart + alen)
        op.to_read = (astart, existing_end - astart)
        if mut.tracked_op is not None:
            mut.tracked_op.mark_event("ec:rmw_read")
        self.objects_read(
            op.oid, astart,
            min(existing_end, op.committed_size) - astart,
            lambda res, data: self._rmw_read_done(op, res, data),
            trace=(mut.trace_id, mut.parent_span_id))

    def _delta_encode_done(self, op: _WriteOp,
                           dparity: Optional[Dict[int, bytes]]) -> None:
        """Continuation from the batcher's collector thread with the
        Δparity chunk map {k+j: bytes}: re-enter under the PG lock and
        queue for the ORDERED send (same contract as _encode_done)."""
        lock = getattr(self.host, "lock", None)
        if lock is None:
            import contextlib
            lock = contextlib.nullcontext()
        with lock:
            if not op.alive:
                return
            if op.mutation.tracked_op is not None:
                op.mutation.tracked_op.mark_event("ec:encoded")
            if dparity is None:          # delta failed even inline: EIO
                self._fail_op(op, -5)
                return
            op.delta_txn = op.delta_pending + (dparity,)
            op.delta_pending = None
            op.state = op.ENCODED
            self._flush_ready()

    def _rmw_read_done(self, op: _WriteOp, res: int,
                       data: bytes) -> None:
        if not op.alive:
            return                   # interval change dropped the op
        if res < 0:
            # RMW source unreadable (shards down mid-pipeline): fail
            # the op (and dependents); clients resend after re-peer
            self._fail_op(op, res)
            return
        op.read_data = data
        self._reads_to_commit(op)

    def _reads_to_commit(self, op: _WriteOp) -> None:
        """Encode + fan out per-shard sub-writes (reference
        try_reads_to_commit, ECBackend.cc:1939-2101).

        The encode does NOT run inline here: writes with data hand
        their stripe-aligned buffer to the OSD's cross-op batcher
        (osd/batcher.py), which coalesces stripes from concurrent ops
        across PGs into one device call and calls back into
        _encode_done.  Codec or host without batching support encodes
        synchronously on this thread instead."""
        mut = op.mutation
        if mut.delete or not mut.writes:
            self._commit_fanout(op, self._generate_transactions(op))
            return
        lo = min(off for off, _ in mut.writes)
        hi = max(off + len(d) for off, d in mut.writes)
        astart, alen = self.sinfo.offset_len_to_stripe_bounds(
            lo, hi - lo)
        if len(mut.writes) == 1 and not op.read_data \
                and lo == astart and hi - astart == alen:
            # aligned full-cover write (the deployed whole-object
            # path): the client payload IS the stripe-aligned extent —
            # hand it to the encoder by reference, zero copies.  Any
            # overlay bytes are fully shadowed by this op's own data.
            payload = mut.writes[0][1]
        else:
            buf = bytearray(alen)        # zero padding to stripe bounds
            if op.read_data:
                buf[0:len(op.read_data)] = op.read_data
            if op.tracked:
                # in-flight bytes of EARLIER ops shadow whatever the
                # shards returned (they may predate those uncommitted
                # writes); own writes applied below
                self._overlay(op.oid, buf, astart, op.seq)
            for off, data in mut.writes:
                buf[off - astart:off - astart + len(data)] = data
            copytrack.note_copy(alen, "ecbackend.rmw_gather")
            payload = buf
        batcher = getattr(self.host, "encode_batcher", None)
        if batcher is not None and \
                hasattr(self.ec_impl, "encode_batch_async"):
            if mut.tracked_op is not None:
                mut.tracked_op.mark_event("ec:encode_queued")
            if self.seg_bytes and not op.barrier \
                    and alen > self.seg_bytes:
                self._start_segmented(op, astart, hi, payload,
                                      batcher)
                return
            batcher.submit(
                self.ec_impl, self.sinfo, payload,
                lambda chunks: self._encode_done(op, astart, hi,
                                                 chunks),
                tracked=mut.tracked_op)
        else:
            if mut.tracked_op is not None:
                mut.tracked_op.mark_event("ec:encode_queued")
            chunks = ecutil.encode(self.sinfo, self.ec_impl, payload)
            if mut.tracked_op is not None:
                mut.tracked_op.mark_event("ec:encoded")
            self._encoded_to_commit(op, astart, hi, chunks)

    def _encode_done(self, op: _WriteOp, astart: int, hi: int,
                     chunks: Dict[int, bytes]) -> None:
        """Continuation from the batcher's collector thread: re-enter
        the PG under its lock, unless an interval change dropped the
        op mid-encode."""
        lock = getattr(self.host, "lock", None)
        if lock is None:
            import contextlib
            lock = contextlib.nullcontext()
        with lock:
            if not op.alive:
                return               # on_change() cleared the pipeline
            if op.mutation.tracked_op is not None:
                op.mutation.tracked_op.mark_event("ec:encoded")
            if chunks is None:       # encode failed even on CPU: EIO
                self._fail_op(op, -5)
                return
            self._encoded_to_commit(op, astart, hi, chunks)

    def _encoded_to_commit(self, op: _WriteOp, astart: int, hi: int,
                           chunks: Dict[int, bytes]) -> None:
        """Encode finished: queue for the ORDERED send.  Concurrent
        encodes may finish out of order; sub-writes must not (shard
        logs are monotonic — reference check_ops ordering)."""
        op.encoded = (astart, hi, chunks)
        op.state = op.ENCODED
        self._flush_ready()

    def _flush_ready(self) -> None:
        """Send, in submission order, every encoded op not yet sent;
        stop at the first op still encoding.  Poisoned ops (an earlier
        same-object op failed under them) error out instead of
        sending.  Segmented ops send their encoded segment prefix and
        — until the final (metadata-carrying) segment is out — block
        everything behind them, keeping shard logs monotonic."""
        for op in list(self._pipeline):
            if op.state in (op.SENT, op.DONE):
                continue
            if op.state != op.ENCODED:
                break
            if op.poisoned:
                # a partially-sent segmented op stops here: its data
                # sub-writes may have landed, but without the final
                # segment's metadata they are invisible
                self.waiting_commit.pop(op.tid, None)
                self._cancel_deadline(op)
                op.on_all_commit(op.poisoned)
                op.state = op.DONE
                continue
            if op.segs_total > 1:
                self._send_ready_segments(op)
                if op.state == op.DONE:
                    continue
                if op.state != op.SENT:
                    break            # mid-op: later ops must wait
                continue
            op.state = op.SENT
            if op.delta_txn is not None:
                txns = self._generate_transactions(
                    op, delta_plan=op.delta_txn)
            elif op.encoded is not None:
                astart, hi, chunks = op.encoded
                txns = self._generate_transactions(
                    op, write_plan=(astart, hi, chunks))
            else:
                txns = self._generate_transactions(op)
            self._commit_fanout(op, txns)
        while self._pipeline and \
                self._pipeline[0].state == _WriteOp.DONE:
            self._untrack_pending(self._pipeline.popleft())

    def _complete_op(self, op: _WriteOp) -> None:
        """An op finished (committed everywhere, or failed early):
        mark DONE and retire the completed prefix of the pipeline."""
        op.state = op.DONE
        while self._pipeline and self._pipeline[0].state == op.DONE:
            done = self._pipeline.popleft()
            self._untrack_pending(done)
        self._admit_ops()
        self._flush_ready()

    def _commit_fanout(self, op: _WriteOp,
                       shard_txns: Dict[int, Transaction]) -> None:
        wire_entries = [e.to_dict() for e in op.log_entries]
        self._register_commits(op, 1)
        tracked = op.mutation.tracked_op
        if tracked is not None:
            tracked.mark_event("ec:sub_write_sent")
        self._fanout_txns(op, shard_txns, wire_entries)

    def _register_commits(self, op: _WriteOp, per_shard: int) -> None:
        """Populate pending_commits for the WHOLE acting set before
        any send: a fast commit reply must not find a half-filled map
        and declare the op done early.  ``per_shard`` is the number of
        sub-writes each shard will receive (segments)."""
        op.pending_commits = {
            shard: per_shard for shard, osd in
            self.host.acting_shards() if osd is not None}
        self.waiting_commit[op.tid] = op
        if self.subwrite_timeout_s > 0:
            self._arm_subwrite_deadline(op, attempt=1,
                                        delay=self.subwrite_timeout_s)

    def _fanout_txns(self, op: _WriteOp,
                     shard_txns: Dict[int, Transaction],
                     wire_entries: List[dict], seg: int = 0) -> None:
        """Send one sub-write per shard.  Remote shards get the
        transaction as encode_parts() fragments — the messenger ships
        them as scatter-gather iovecs, so encoded chunk views never
        round-trip through one big bytes.  The primary's own shard
        gets the Transaction OBJECT (no encode at all).  ``seg`` is
        the pipeline segment index, carried on the wire so deadline
        re-requests dedup per (from, tid, seg)."""
        local_txn: Optional[Transaction] = None
        for shard, osd in [(s, o) for s, o in
                           self.host.acting_shards() if o is not None]:
            txn = shard_txns.get(shard) or Transaction()
            if osd == self.host.whoami:
                local_txn = txn
                continue
            parts = txn.encode_parts()
            sub = MOSDECSubOpWrite(
                pgid=self.host.pgid_str, shard=shard,
                from_osd=self.host.whoami, tid=op.tid,
                epoch=self.host.epoch, txn=parts,
                log_entries=wire_entries,
                at_version=op.at_version,
                trace_id=op.mutation.trace_id,
                parent_span_id=op.mutation.parent_span_id, seg=seg)
            sub.stamp_hop("client_send")
            self.host.send_shard(osd, sub)
            if self.subwrite_timeout_s > 0:
                # retained ONLY while a deadline is armed: parts are
                # views over op.encoded's chunks, so this adds no copy
                op.sent_subwrites[(shard, seg)] = (parts, wire_entries)
        if local_txn is not None:
            # the primary's own shard goes through the same sub-write
            # handler, local call (reference ECBackend.cc:2086-2092);
            # it bypasses handle_message, so its child span is cut here
            span = self.host.trace_span(
                "ec_sub_write", op.mutation.trace_id,
                op.mutation.parent_span_id)
            if span is not None:
                span.tag("shard", self.host.own_shard).tag(
                    "pgid", self.host.pgid_str).finish()
            tid = op.tid
            cmsg = op.mutation.client_msg

            def _local_committed(t=tid, s=seg, m=cmsg):
                if m is not None:
                    # first segment's commit wins: from here the op is
                    # waiting on the ack set, not the local store
                    m.stamp_hop("store_apply")
                self._sub_write_committed(t, self.host.own_shard, s)
            self._apply_sub_write(
                self.host.own_shard, local_txn, wire_entries,
                _local_committed)

    # -- pipelined segmented fanout ------------------------------------
    def _start_segmented(self, op: _WriteOp, astart: int, hi: int,
                         payload, batcher) -> None:
        """Cut a large aligned write into stripe-aligned segments and
        pipeline encode against fanout: segment N's sub-writes go out
        while the batcher encodes segment N+1 (the next segment is
        submitted from N's encode continuation, so the collector
        thread works while this PG thread fans out).  Only the final
        segment carries log entries, OI and the finalised hinfo —
        partial data is invisible until it lands."""
        mv = memoryview(payload)
        seg = self.seg_bytes
        op.seg_bufs = [mv[i:i + seg]
                       for i in range(0, len(mv), seg)]
        op.segs_total = len(op.seg_bufs)
        op.seg_astart = astart
        op.seg_hi = hi
        op.seg_width = seg
        op.seg_chunk_off0 = \
            self.sinfo.aligned_logical_offset_to_chunk_offset(astart)
        info = op.obj_info or ObjectInfo()
        op.seg_is_append = op.mutation.append_only_at(info.size) and \
            astart >= self.sinfo.logical_to_prev_stripe_offset(
                info.size)
        self._submit_segment(op, 0, batcher)

    def _submit_segment(self, op: _WriteOp, idx: int,
                        batcher) -> None:
        batcher.submit(
            self.ec_impl, self.sinfo, op.seg_bufs[idx],
            lambda chunks, i=idx: self._seg_encode_done(op, i, chunks),
            tracked=op.mutation.tracked_op)

    def _seg_encode_done(self, op: _WriteOp, idx: int,
                         chunks: Optional[Dict[int, bytes]]) -> None:
        """Continuation from the batcher's collector thread for one
        segment: re-enter the PG under its lock, queue the segment for
        the ordered send, and start the NEXT segment's encode — that
        encode then overlaps this segment's fanout."""
        lock = getattr(self.host, "lock", None)
        if lock is None:
            import contextlib
            lock = contextlib.nullcontext()
        with lock:
            if not op.alive:
                return
            if chunks is None:       # encode failed even on CPU: EIO
                self.waiting_commit.pop(op.tid, None)
                self._fail_op(op, -5)
                return
            op.seg_ready[idx] = chunks
            if idx == 0:
                op.state = op.ENCODED
            if idx + 1 < op.segs_total:
                batcher = getattr(self.host, "encode_batcher", None)
                if batcher is not None:
                    self._submit_segment(op, idx + 1, batcher)
            if idx + 1 == op.segs_total \
                    and op.mutation.tracked_op is not None:
                op.mutation.tracked_op.mark_event("ec:encoded")
            self._flush_ready()

    def _send_ready_segments(self, op: _WriteOp) -> None:
        """Fan out, in order, every segment whose encode has finished.
        The final segment reuses _generate_transactions (full
        metadata); intermediate segments carry data + running hinfo
        only."""
        while op.segs_sent in op.seg_ready:
            idx = op.segs_sent
            chunks = op.seg_ready.pop(idx)
            if idx == 0:
                self._register_commits(op, op.segs_total)
                if op.mutation.tracked_op is not None:
                    op.mutation.tracked_op.mark_event(
                        "ec:sub_write_sent")
            seg_chunk_off = op.seg_chunk_off0 + \
                idx * (op.seg_width // self.k)
            op.seg_hinfo = self._update_hinfo(
                op.oid, chunks, seg_chunk_off, op.seg_is_append,
                hinfo=op.seg_hinfo)
            if idx == op.segs_total - 1:
                txns = self._generate_transactions(
                    op, write_plan=(op.seg_astart, op.seg_hi, chunks),
                    hinfo=op.seg_hinfo, chunk_off=seg_chunk_off)
                wire_entries = [e.to_dict() for e in op.log_entries]
            else:
                txns = self._segment_txns(op, seg_chunk_off, chunks)
                wire_entries = []
            self._fanout_txns(op, txns, wire_entries, seg=idx)
            op.segs_sent += 1
        if op.segs_sent >= op.segs_total:
            op.state = op.SENT

    def _segment_txns(self, op: _WriteOp, chunk_off: int,
                      chunks: Dict[int, bytes]
                      ) -> Dict[int, Transaction]:
        """Per-shard transactions for a NON-final segment: chunk data
        + the running hinfo, nothing else — no OI, no log entries, no
        truncate.  A crash after this lands leaves the bytes invisible
        (object size unchanged) — same consistency the reference gets
        from atomic whole-op transactions."""
        henc = op.seg_hinfo.encode()
        txns: Dict[int, Transaction] = {}
        for shard, osd in self.host.acting_shards():
            if osd is None:
                continue
            txn = Transaction()
            obj = GHObject(op.oid, shard)
            coll = self.host.coll_of(shard)
            txn.touch(coll, obj)
            txn.write(coll, obj, chunk_off, chunks[shard])
            txn.setattr(coll, obj, ecutil.HINFO_KEY, henc)
            txns[shard] = txn
        return txns

    def _generate_transactions(self, op: _WriteOp,
                               write_plan: Optional[Tuple] = None,
                               hinfo: Optional[ecutil.HashInfo] = None,
                               chunk_off: Optional[int] = None,
                               delta_plan: Optional[Tuple] = None
                               ) -> Dict[int, Transaction]:
        """Lower the logical mutation to per-shard store transactions
        (reference ECTransaction::generate_transactions ->
        encode_and_write, ECTransaction.cc:97,28).  ``write_plan`` is
        (astart, hi, chunks) with the already-encoded chunk map from
        the batcher when the mutation carries data.  For the FINAL
        segment of a pipelined op, ``hinfo`` is the caller-maintained
        running HashInfo (already folded through every segment) and
        ``chunk_off`` the final segment's shard offset, while
        write_plan keeps the whole-op bounds so sizes stay right.
        ``delta_plan`` is (astart, hi, cols, new_cols, chunk_off,
        dparity) for a parity-delta RMW: dirty data shards get their
        new column bytes as a plain write, parity shards get an
        ``xor_write`` the store XORs into the committed parity chunk
        (WAL-backed stores replay it crash-safe), clean data shards
        carry metadata only.  The wire format does not change — the
        sub-write is a normal MOSDECSubOpWrite whose transaction
        happens to hold xor_write ops."""
        mut, oid = op.mutation, op.oid
        txns: Dict[int, Transaction] = {
            shard: Transaction()
            for shard, osd in self.host.acting_shards()
            if osd is not None}

        def for_all(fn):
            for shard, txn in txns.items():
                fn(shard, txn, GHObject(oid, shard),
                   self.host.coll_of(shard))

        from .snaps import SS_ATTR
        if mut.clone_to is not None:
            # snapshot COW: clone every shard's chunk object — the
            # store's COW copies bytes; NO re-encode happens (the
            # parity of unchanged data is unchanged).  This is the EC
            # snapshot win on the card: snapshots cost zero device work.
            def _clone(s, t, o, c):
                cobj = GHObject(mut.clone_to, s)
                t.clone(c, o, cobj)
                t.rmattr(c, cobj, SS_ATTR)   # clones carry no SnapSet
                if mut.clone_attrs:
                    t.setattrs(c, cobj, mut.clone_attrs)
            for_all(_clone)
        for aux in mut.aux_remove:
            for_all(lambda s, t, o, c, a=aux:
                    t.remove(c, GHObject(a, s)))

        if mut.delete:
            for_all(lambda s, t, o, c: t.remove(c, o))
            if mut.snapdir_set is not None:
                sd_oid, ss, sd_oi = mut.snapdir_set

                def _snapdir(s, t, o, c):
                    sd = GHObject(sd_oid, s)
                    t.touch(c, sd)
                    t.setattr(c, sd, SS_ATTR, ss)
                    t.setattr(c, sd, OI_ATTR, sd_oi)
                for_all(_snapdir)
            return txns

        info = op.obj_info or ObjectInfo()
        new_size = info.size
        if mut.rollback_from is not None:
            # head becomes the clone's content, shard by shard
            def _rollback(s, t, o, c):
                t.remove(c, o)
                t.clone(c, GHObject(mut.rollback_from, s), o)
            for_all(_rollback)
            new_size = mut.rollback_size
        for_all(lambda s, t, o, c: t.touch(c, o))
        if mut.snapset is not None:
            for_all(lambda s, t, o, c:
                    t.setattr(c, o, SS_ATTR, mut.snapset))

        if mut.truncate is not None:
            # logical truncate: shards trim to the per-shard size; any
            # stale bytes inside the final partial stripe stay hidden
            # behind ObjectInfo.size (reads trim, RMW re-encodes whole
            # stripes from the logical content).  The truncate op is
            # emitted BEFORE any accompanying write — the store
            # applies ops in order, and the truncate logically
            # precedes the writes (pg.py projects sizes the same
            # way), so it must never chop bytes the write just put
            # past it.  The writes branch below folds the write end
            # into new_size.
            new_size = mut.truncate
            shard_sz = self.sinfo.object_size_to_shard_size(new_size)
            for_all(lambda s, t, o, c: t.truncate(c, o, shard_sz))
            if not mut.writes:
                # pure truncate invalidates cumulative CRCs (the
                # write path below refreshes/clears them otherwise)
                cleared = ecutil.HashInfo(self.k + self.m).encode()
                for_all(lambda s, t, o, c:
                        t.setattr(c, o, ecutil.HINFO_KEY, cleared))

        if mut.writes and delta_plan is not None:
            # ★ parity-delta RMW: the device computed only
            # M[:, dirty]·Δdata — parity shards apply it with a store
            # XOR, clean data shards move no data at all
            astart, hi, cols, new_cols, dchunk_off, dparity = \
                delta_plan
            new_size = max(new_size, hi)
            dhinfo = self._update_hinfo(oid, {}, dchunk_off, False)
            henc = dhinfo.encode()       # overwrite: CRCs unknowable
            for shard, txn in txns.items():
                obj = GHObject(oid, shard)
                coll = self.host.coll_of(shard)
                if shard in new_cols:
                    txn.write(coll, obj, dchunk_off, new_cols[shard])
                elif shard in dparity:
                    txn.xor_write(coll, obj, dchunk_off,
                                  dparity[shard])
                txn.setattr(coll, obj, ecutil.HINFO_KEY, henc)
        elif mut.writes:
            assert write_plan is not None, \
                "writes with data must arrive pre-encoded"
            # ★ the batched encode already happened: one [nstripes, k,
            # chunk] device call in the OSD batcher, shared with
            # concurrent ops from other PGs
            astart, hi, chunks = write_plan
            # when a truncate rides along it applied first: the final
            # size is the write end over the truncated base, never the
            # pre-truncate size
            new_size = max(new_size if mut.truncate is not None
                           else info.size, hi)
            if chunk_off is None:
                chunk_off = self.sinfo \
                    .aligned_logical_offset_to_chunk_offset(astart)
            if hinfo is None:
                is_append = mut.append_only_at(info.size) and \
                    astart >= \
                    self.sinfo.logical_to_prev_stripe_offset(info.size)
                hinfo = self._update_hinfo(oid, chunks, chunk_off,
                                           is_append)
            henc = hinfo.encode()
            for shard, txn in txns.items():
                obj = GHObject(oid, shard)
                coll = self.host.coll_of(shard)
                txn.write(coll, obj, chunk_off, chunks[shard])
                txn.setattr(coll, obj, ecutil.HINFO_KEY, henc)

        oi = ObjectInfo(size=new_size, version=op.at_version).encode()
        for_all(lambda s, t, o, c: t.setattr(c, o, OI_ATTR, oi))
        for name, value in mut.attrs.items():
            if value is None:
                for_all(lambda s, t, o, c, n=name:
                        t.rmattr(c, o, "u_" + n))
            else:
                for_all(lambda s, t, o, c, n=name, v=value:
                        t.setattr(c, o, "u_" + n, v))
        return txns

    def _update_hinfo(self, oid: str, chunks: Dict[int, bytes],
                      chunk_off: int, is_append: bool,
                      hinfo: Optional[ecutil.HashInfo] = None
                      ) -> ecutil.HashInfo:
        """Cumulative CRCs stay valid only for pure appends; any
        overwrite clears them (the reference drops hinfo on
        ec_overwrites pools).  Pass ``hinfo`` to fold a further
        segment into a running HashInfo without re-reading the
        store (pipelined segmented writes)."""
        if hinfo is None:
            obj = GHObject(oid, self.host.own_shard)
            try:
                hinfo = ecutil.HashInfo.decode(self.host.store.getattr(
                    self.host.coll, obj, ecutil.HINFO_KEY))
            except (FileNotFoundError, KeyError, ValueError):
                pass            # absent or corrupt: rebuilt below
        if hinfo is None or len(hinfo.crcs) != self.k + self.m:
            hinfo = ecutil.HashInfo(self.k + self.m)
        if is_append and hinfo.total_chunk_size == chunk_off:
            hinfo.append(chunk_off, chunks)
        else:
            hinfo.clear()               # overwrite: CRCs unknowable
        return hinfo

    def _apply_sub_write(self, shard: int, txn: Transaction,
                         wire_entries: List[dict],
                         on_commit: Callable[[], None]) -> None:
        """Shard-side sub-write application (reference handle_sub_write,
        ECBackend.cc:915-989): log entries + data in one transaction."""
        self.host.prepare_log_txn(txn, wire_entries)
        txn.register_on_commit(
            lambda: self.host.on_local_commit(on_commit))
        self.host.store.queue_transactions([txn], op="client_write")

    def _sub_write_committed(self, tid: int, shard: int,
                             seg: int = 0) -> None:
        op = self.waiting_commit.get(tid)
        if op is None:
            return
        acked = op.acked_segs.setdefault(shard, set())
        if seg in acked:
            return      # duplicate ack from a deadline re-request
        acked.add(seg)
        op.sent_subwrites.pop((shard, seg), None)
        left = op.pending_commits.get(shard, 0)
        if left <= 1:
            op.pending_commits.pop(shard, None)
        else:
            # segmented op: one reply per segment per shard (replies
            # ride ordered channels, so counting is sufficient)
            op.pending_commits[shard] = left - 1
        if not op.pending_commits:
            del self.waiting_commit[tid]
            self._cancel_deadline(op)
            if op.mutation.tracked_op is not None:
                op.mutation.tracked_op.mark_event(
                    "ec:all_shards_committed")
            # ordered sends over ordered channels make completions
            # arrive in submission order; clients observe per-object
            # commit order
            op.on_all_commit(0)
            self._complete_op(op)

    # -- sub-write deadlines (osd_ec_subwrite_timeout_ms) --------------
    def _arm_subwrite_deadline(self, op: _WriteOp, attempt: int,
                               delay: float) -> None:
        call_later = getattr(self.host, "call_later", None)
        if call_later is None:
            return           # host without timers (unit-test stubs)
        tid = op.tid
        op.deadline_timer = call_later(
            delay, lambda: self._subwrite_deadline(tid, attempt))

    def _cancel_deadline(self, op: _WriteOp) -> None:
        timer, op.deadline_timer = op.deadline_timer, None
        op.sent_subwrites.clear()
        if timer is not None:
            try:
                timer.cancel()
            except Exception:
                pass

    def _subwrite_deadline(self, tid: int, attempt: int) -> None:
        """The per-op sub-write deadline expired (fires on a timer
        thread / the reactor; re-enters the PG under its lock).  First
        expiry re-requests every outstanding sub-write from the
        laggard shards — a FRESH message with the retained fields, so
        the messenger's seq dedup can't swallow it when only the ACK
        was lost — and re-arms at double the timeout.  Second expiry
        reports the laggard peers to the monitor like a failed
        heartbeat; the resulting map change re-peers the PG and the
        client resends."""
        lock = getattr(self.host, "lock", None)
        if lock is None:
            import contextlib
            lock = contextlib.nullcontext()
        with lock:
            op = self.waiting_commit.get(tid)
            if op is None or not op.alive or op.deadline_timer is None:
                return
            op.deadline_timer = None
            self.subwrite_timeouts += 1
            perf = getattr(self.host, "osd_perf", None)
            if perf is not None:
                perf.inc("ec_subwrite_timeouts")
            acting = {s: o for s, o in self.host.acting_shards()}
            laggards = set(op.pending_commits)
            recorder = getattr(self.host, "flight_recorder", None)
            if recorder is not None:
                recorder.note("subwrite_timeout", tid=tid,
                              attempt=attempt,
                              pg=getattr(self.host, "pgid_str", "?"),
                              laggards=sorted(laggards))
                recorder.auto_dump("subwrite-timeout")
            if attempt == 1:
                resent = 0
                for (shard, seg), (parts, entries) in sorted(
                        op.sent_subwrites.items()):
                    if shard not in laggards or \
                            seg in op.acked_segs.get(shard, ()):
                        continue
                    osd = acting.get(shard)
                    if osd is None or osd == self.host.whoami:
                        continue
                    self.host.send_shard(osd, MOSDECSubOpWrite(
                        pgid=self.host.pgid_str, shard=shard,
                        from_osd=self.host.whoami, tid=tid,
                        epoch=self.host.epoch, txn=parts,
                        log_entries=entries,
                        at_version=op.at_version,
                        trace_id=op.mutation.trace_id,
                        parent_span_id=op.mutation.parent_span_id,
                        seg=seg))
                    resent += 1
                self.subwrite_retries += resent
                if perf is not None and resent:
                    perf.inc("ec_subwrite_retries", resent)
                self._arm_subwrite_deadline(
                    op, attempt=2, delay=2 * self.subwrite_timeout_s)
                return
            reported: Set[int] = set()
            for shard in laggards:
                osd = acting.get(shard)
                if osd is None or osd == self.host.whoami \
                        or osd in reported:
                    continue
                reported.add(osd)
                report = getattr(self.host, "report_laggard", None)
                if report is not None:
                    report(osd, 3 * self.subwrite_timeout_s)
            self.subwrite_peer_reports += len(reported)
            if perf is not None and reported:
                perf.inc("ec_subwrite_peer_reports", len(reported))

    # ------------------------------------------------------------------
    # read path (reference objects_read_and_reconstruct)
    # ------------------------------------------------------------------
    def objects_read(self, oid: str, offset: int, length: int,
                     cb: Callable[[int, bytes], None],
                     trace: Tuple[int, int] = (0, 0),
                     hop_msg=None) -> None:
        info = self.get_object_info(oid)
        if info is None:
            cb(-2, b"")                  # -ENOENT
            return
        if offset >= info.size or length == 0:
            cb(0, b"")
            return
        length = min(length, info.size - offset)
        astart, alen = self.sinfo.offset_len_to_stripe_bounds(
            offset, length)
        chunk_off = \
            self.sinfo.aligned_logical_offset_to_chunk_offset(astart)
        chunk_len = self.sinfo.aligned_logical_offset_to_chunk_offset(
            astart + alen) - chunk_off

        # fast_read pools fan the read to EVERY available shard and
        # reconstruct from the first k answers, trading bandwidth for
        # tail latency (reference ECBackend.cc:1043 fast_read,
        # osd_pool_default_ec_fast_read)
        fast = bool(getattr(getattr(self.host, "pool", None),
                            "fast_read", False))
        need = None
        if fast:
            shards = {s: o for s, o in self.host.acting_shards()
                      if o is not None}
            if len(shards) < self.k:
                shards = None
            else:
                need = self.k
        else:
            shards = self._min_read_shards(set(range(self.k)))
        if shards is None:
            cb(-5, b"")                  # -EIO: not enough shards up
            return
        min_needed = need if need is not None else len(shards)

        def reads_done(received: Dict[int, bytes],
                       errors: Dict[int, int]) -> None:
            if errors or len(received) < min_needed:
                cb(-5, b"")
                return
            degraded = any(i not in received for i in range(self.k))
            batcher = getattr(self.host, "encode_batcher", None)
            if degraded and batcher is not None and \
                    hasattr(self.ec_impl, "decode_batch"):
                # client-facing reconstruction rides the OSD's
                # cross-op decode batcher: concurrent
                # degraded reads of one erasure signature share one
                # batched device dispatch (full seven-phase ledger),
                # and the batcher owns routing, breaker, and the
                # CPU-twin fallback.  The continuation arrives on the
                # batcher's worker thread, so it re-enters under the
                # PG lock — same contract as recovery's
                # decode_done_async.
                if hop_msg is not None:
                    hop_msg.stamp_hop("decode_dispatch")

                def decode_done(dec) -> None:
                    lock = getattr(self.host, "lock", None)
                    if lock is None:
                        import contextlib
                        lock = contextlib.nullcontext()
                    with lock:
                        if dec is None:
                            cb(-5, b"")
                            return
                        try:
                            if hop_msg is not None:
                                hop_msg.stamp_hop("decode_complete")
                            import numpy as np
                            cs = self.sinfo.chunk_size
                            total = len(dec[0])
                            nst = total // cs if cs else 0
                            shards = np.stack(
                                [np.frombuffer(dec[i], dtype=np.uint8)
                                 .reshape(nst, cs)
                                 for i in range(self.k)], axis=1)
                            data = shards.reshape(
                                nst * self.sinfo.stripe_width
                            ).tobytes()  # copycheck: ok - shard interleave -> client payload
                        except Exception:
                            cb(-5, b"")
                            return
                        lo = offset - astart
                        cb(0, data[lo:lo + length])

                batcher.submit_decode(self.ec_impl, self.sinfo,
                                      received, set(range(self.k)),
                                      decode_done)
                return
            try:
                # client-facing decode window rides the op's ledger:
                # degraded reads reconstruct here, healthy reads
                # concat — either way the interval is the decode leg
                if hop_msg is not None:
                    hop_msg.stamp_hop("decode_dispatch")
                nbytes = sum(len(v) for v in received.values())
                impl = self._decode_impl(nbytes)
                t0 = time.time()
                try:
                    data = ecutil.decode_concat(self.sinfo, impl,
                                                received)
                except Exception as e:
                    self._note_decode_error(impl, e)
                    raise
                if hop_msg is not None:
                    hop_msg.stamp_hop("decode_complete")
                # a degraded read that reconstructed on the DEVICE
                # (routing kept the gpu impl, not the twin, and a data
                # shard was actually missing) is a device group like
                # any batched decode: fold a coarse two-stamp ledger
                # into the batcher's accumulator so dump_device and
                # the overlap engine see client-path reconstruction
                # alongside the batcher's own traffic
                if impl is self.ec_impl and \
                        hasattr(impl, "encode_batch_async"):
                    try:
                        k = impl.get_data_chunk_count()
                        if any(i not in received for i in range(k)):
                            obs = getattr(
                                getattr(self.host, "encode_batcher",
                                        None),
                                "_observe_device_ledger", None)
                            if obs is not None:
                                t1 = time.time()
                                obs({"stage_acquire": t0,
                                     "compute_start": t0,
                                     "compute_done": t1,
                                     "deliver": t1, "bytes": nbytes,
                                     "group": "decode"})
                    except Exception:
                        pass
            except Exception:
                cb(-5, b"")
                return
            lo = offset - astart
            cb(0, data[lo:lo + length])

        if hop_msg is not None:
            hop_msg.stamp_hop("read_queued")
        self._start_read(oid, chunk_off, chunk_len, shards, reads_done,
                         need=need, trace=trace)

    def _decode_impl(self, nbytes: int):
        """Decode through the CPU twin when the OSD batcher's learned
        crossover says a device round trip of this size loses (same
        economics as the encode side; bit-exact either way).  Every
        verdict is counted (``dec_route_*``) so the decode routing is
        as auditable as the encode side's."""
        batcher = getattr(self.host, "encode_batcher", None)
        if batcher is not None and \
                hasattr(self.ec_impl, "encode_batch_async"):
            if batcher.route_decode(nbytes):
                try:
                    twin = batcher.cpu_twin(self.ec_impl, self.sinfo)
                except Exception:
                    return self.ec_impl
                self.twin_routes += 1
                return twin
        return self.ec_impl

    def _note_decode_error(self, impl, exc: BaseException) -> None:
        """A host-side decode raised: count it when the device codec
        (not the CPU twin) was the one that failed."""
        if impl is self.ec_impl:
            self.device_errors += 1
            self.last_device_error = exc

    def _min_read_shards(self, want: Set[int],
                         exclude: Optional[Set[int]] = None,
                         oid: Optional[str] = None
                         ) -> Optional[Dict[int, int]]:
        """Choose the minimum shard set for reconstruction (reference
        get_min_avail_to_read_shards, ECBackend.cc:1594): the codec's
        minimum_to_decode picks data shards when whole, parity fills
        holes; LRC/SHEC/CLAY codecs pick their cheaper local sets.

        Post-split, a chunk position whose acting holder lacks the
        object may still be served by a stray (the parent's former
        shard holder) — with ``oid`` given, strays fill such holes
        (the reference reads from past-interval members the same
        way)."""
        avail = {shard: osd for shard, osd in self.host.acting_shards()
                 if osd is not None
                 and not (exclude and shard in exclude)}
        if oid is not None:
            for shard, osd in self.host.extra_recovery_sources(oid):
                if shard >= 0 and shard not in avail:
                    avail[shard] = osd
        try:
            need = ecutil.minimum_to_decode(self.ec_impl, want,
                                            set(avail))
        except IOError:
            return None
        return {shard: avail[shard] for shard in need}

    def _start_read(self, oid: str, chunk_off: int, chunk_len: int,
                    shards: Dict[int, int],
                    cb: Callable[[Dict[int, bytes], Dict[int, int]],
                                 None],
                    tried: Optional[Set[int]] = None,
                    ranges: Optional[Dict[int, List[Tuple[int, int]]]]
                    = None, need: Optional[int] = None,
                    trace: Tuple[int, int] = (0, 0),
                    for_recovery: bool = False) -> None:
        rop = _ReadOp(self.new_tid(), oid, chunk_off, chunk_len,
                      dict(shards), cb, tried, ranges, need)
        rop.trace = trace
        rop.for_recovery = for_recovery
        self.in_flight_reads[rop.tid] = rop
        for shard, osd in shards.items():
            extents = rop.ranges.get(shard,
                                     [(chunk_off, chunk_len)])
            self.read_bytes_total += sum(ln for _, ln in extents)
            if osd == self.host.whoami:
                parts: List[bytes] = []
                err = 0
                for off, length in extents:
                    data, err = self._local_chunk_read(
                        oid, shard, off, length)
                    if err < 0:
                        break
                    parts.append(data)
                if err != 0:
                    piece = b""
                elif len(parts) == 1:
                    piece = parts[0]     # common case: no join copy
                else:
                    piece = b"".join(parts)  # copycheck: ok - multi-extent read reassembly
                self._read_piece(rop, shard, piece, err)
            else:
                sub = MOSDECSubOpRead(
                    pgid=self.host.pgid_str, shard=shard,
                    from_osd=self.host.whoami, tid=rop.tid,
                    epoch=self.host.epoch,
                    reads=[(oid, off, length)
                           for off, length in extents],
                    for_recovery=for_recovery,
                    trace_id=trace[0], parent_span_id=trace[1])
                # sub-read round trip opens its own ledger (mirrors
                # the sub-write path); the reply closes it at this
                # primary into the read/recovery accumulator
                sub.stamp_hop("client_send")
                self.host.send_shard(osd, sub)

    def _local_chunk_read(self, oid: str, shard: int, off: int,
                          length: int) -> Tuple[bytes, int]:
        try:
            data = self.host.store.read(
                self.host.coll_of(shard), GHObject(oid, shard), off,
                length)
        except FileNotFoundError:
            return b"", -2
        except OSError:
            # store-level csum mismatch (BlockStore EIO): treat like
            # corruption — the read retries over other shards and
            # reconstruction replaces the bytes
            return b"", -5
        if len(data) < length:
            # shards are never legitimately short (every write pads to
            # stripe bounds): a short read means truncation/corruption,
            # so error out and let reconstruction use parity instead
            return b"", -5
        if off == 0:
            # whole-shard read: verify bytes against the HashInfo CRC
            # so bit-rot surfaces as EIO and the read retries over
            # other shards (reference handle_sub_read hinfo check,
            # ECBackend.cc:1002-1048)
            try:
                hinfo = ecutil.HashInfo.decode(self.host.store.getattr(
                    self.host.coll_of(shard), GHObject(oid, shard),
                    ecutil.HINFO_KEY))
            except (FileNotFoundError, KeyError, ValueError):
                hinfo = None
            if hinfo is not None and \
                    hinfo.total_chunk_size == len(data) and \
                    ecutil.chunk_crc(data) != hinfo.crcs[shard]:
                return b"", -5
        return data, 0

    def _read_piece(self, rop: _ReadOp, shard: int, data: bytes,
                    err: int) -> None:
        if rop.tid not in self.in_flight_reads:
            return
        if err < 0:
            rop.errors[shard] = err
        else:
            rop.received[shard] = data
        if rop.need is not None and len(rop.received) >= rop.need:
            # fast_read: enough shards to reconstruct — don't wait for
            # stragglers (their late replies hit the tid-gone guard)
            del self.in_flight_reads[rop.tid]
            rop.cb(rop.received, {})
            return
        if len(rop.received) + len(rop.errors) < len(rop.want_shards):
            return
        del self.in_flight_reads[rop.tid]
        if rop.errors:
            # retry over shards not yet tried (reference
            # send_all_remaining_reads on error, ECBackend.cc:2400)
            retry = self._min_read_shards(set(range(self.k)),
                                          exclude=rop.tried)
            # allow reusing successfully-read shards from this attempt
            if retry is None:
                reuse = {s: o for s, o in self.host.acting_shards()
                         if o is not None
                         and (s in rop.received
                              or s not in rop.tried)}
                try:
                    need = ecutil.minimum_to_decode(
                        self.ec_impl, set(range(self.k)), set(reuse))
                    retry = {s: reuse[s] for s in need}
                except IOError:
                    retry = None
            if retry is not None:
                self._start_read(rop.oid, rop.chunk_off, rop.chunk_len,
                                 retry, rop.cb,
                                 tried=rop.tried | set(retry),
                                 trace=getattr(rop, "trace", (0, 0)),
                                 for_recovery=getattr(
                                     rop, "for_recovery", False))
                return
        rop.cb(rop.received, rop.errors)

    # ------------------------------------------------------------------
    # recovery (reference continue_recovery_op FSM)
    # ------------------------------------------------------------------
    def recover_object(self, oid: str, version: Eversion,
                       missing_on: List[Tuple[int, int]],
                       cb: Callable[[int], None]) -> None:
        if oid in self.recovery_ops:
            cb(-16)                      # -EBUSY
            return
        rec = _RecoveryOp(oid, version, missing_on, cb)
        self.recovery_ops[oid] = rec
        info = self.get_object_info(oid)
        if info is not None:
            obj = GHObject(oid, self.host.own_shard)
            try:
                attrs = self.host.store.getattrs(self.host.coll, obj)
            except FileNotFoundError:
                attrs = {}
            self._recover_with_info(rec, info, attrs)
            return
        # primary's own shard lacks the object: fetch metadata from a
        # surviving peer first (the reference's pull path); post-split
        # strays count as surviving holders — including our own
        # physically-held source shard (mispositioned after an EC
        # split), which we can read locally
        missing_shards = {s for s, _ in missing_on}
        for s, o in self.host.extra_recovery_sources(oid):
            if o == self.host.whoami and s >= 0:
                try:
                    attrs = self.host.store.getattrs(
                        self.host.coll_of(s), GHObject(oid, s))
                except FileNotFoundError:
                    continue
                if OI_ATTR in attrs:
                    self._recover_with_info(
                        rec, ObjectInfo.decode(attrs[OI_ATTR]), attrs)
                    return
        peers = [(s, o) for s, o in self.host.acting_shards()
                 if o is not None and o != self.host.whoami
                 and s not in missing_shards]
        for s, o in self.host.extra_recovery_sources(oid):
            if s >= 0 and o != self.host.whoami and \
                    all(o != po for _, po in peers):
                peers.append((s, o))
        if not peers:
            del self.recovery_ops[oid]
            cb(-5)
            return
        shard, osd = peers[0]
        tid = self.new_tid()
        self.attr_fetches[tid] = (rec,)
        # attrs_to_read carries object names (reference ECSubRead
        # attrs_to_read is a set of hobjects)
        fetch = MOSDECSubOpRead(
            pgid=self.host.pgid_str, shard=shard,
            from_osd=self.host.whoami, tid=tid, epoch=self.host.epoch,
            reads=[], attrs_to_read=[oid], for_recovery=True)
        fetch.stamp_hop("client_send")
        self.host.send_shard(osd, fetch)

    def _attr_fetch_done(self, rec: _RecoveryOp,
                         attrs: Dict[str, bytes]) -> None:
        if rec.oid not in self.recovery_ops:
            return
        if OI_ATTR not in attrs:
            del self.recovery_ops[rec.oid]
            rec.cb(-2)
            return
        self._recover_with_info(rec, ObjectInfo.decode(attrs[OI_ATTR]),
                                attrs)

    def _recover_with_info(self, rec: _RecoveryOp, info: ObjectInfo,
                           attrs: Dict[str, bytes]) -> None:
        """READING state: gather k shards, decode missing (reference
        handle_recovery_read_complete, ECBackend.cc:414-481)."""
        shard_len = self.sinfo.object_size_to_shard_size(info.size)
        missing_shards = {s for s, _ in rec.missing_on}
        if shard_len == 0:
            self._push_recovered(
                rec, attrs, {s: b"" for s in missing_shards})
            return
        if self._try_subchunk_repair(rec, attrs, shard_len,
                                     missing_shards):
            return
        self._recover_whole(rec, attrs, shard_len, missing_shards)

    def _recover_whole(self, rec: _RecoveryOp,
                       attrs: Dict[str, bytes], shard_len: int,
                       missing_shards: Set[int]) -> None:
        """Generic recovery: stream chunk windows from the minimum
        shard set and batch-decode the missing ones.  The window is
        osd_recovery_chunk_size logical bytes (reference
        get_recovery_chunk_size, ECBackend.h:206) so one huge object
        can't hold k shards' worth of its bytes in memory at once."""
        oid = rec.oid
        shards = self._min_read_shards(set(missing_shards),
                                       exclude=missing_shards,
                                       oid=oid)
        if shards is None:
            self.recovery_ops.pop(oid, None)
            rec.cb(-5)
            return
        try:
            logical = self.host.conf["osd_recovery_chunk_size"]
        except (AttributeError, KeyError):
            logical = 8 << 20
        win = max(self.sinfo.chunk_size,
                  self.sinfo.object_size_to_shard_size(logical))
        win -= win % self.sinfo.chunk_size
        pieces: Dict[int, List[bytes]] = {s: [] for s in missing_shards}
        state = {"off": 0}

        def read_next() -> None:
            length = min(win, shard_len - state["off"])
            self._start_read(oid, state["off"], length, shards,
                             reads_done, for_recovery=True)

        def reads_done(received: Dict[int, bytes],
                       errors: Dict[int, int]) -> None:
            if rec.oid not in self.recovery_ops:
                return
            if errors or len(received) < len(shards):
                self.recovery_ops.pop(oid, None)
                rec.cb(-5)
                return
            # the decode window gets its own two-stamp ledger
            # (decode_dispatch -> decode_complete) charged into the
            # recovery waterfall when the decode lands
            state["dec_t0"] = time.time()
            # recovery decodes ride the OSD's cross-op batcher: every
            # object of a rebuild lost the SAME shard (one erasure
            # signature), so concurrent recovery ops coalesce into one
            # batched decode call (the reference
            # decodes per recovery window on the submitting thread,
            # reference ECBackend.cc:414-481)
            batcher = getattr(self.host, "encode_batcher", None)
            if batcher is not None and \
                    hasattr(self.ec_impl, "decode_batch"):
                batcher.submit_decode(
                    self.ec_impl, self.sinfo, received,
                    set(missing_shards),
                    lambda dec: decode_done_async(dec))
                return
            nbytes = sum(len(v) for v in received.values())
            impl = self._decode_impl(nbytes)
            try:
                dec = ecutil.decode(self.sinfo, impl, received,
                                    set(missing_shards))
            except Exception as e:
                self._note_decode_error(impl, e)
                dec = None
            decoded(dec)

        def decode_done_async(dec) -> None:
            """Continuation from the batcher's collector thread:
            re-enter the PG under its lock (same contract as
            _encode_done)."""
            lock = getattr(self.host, "lock", None)
            if lock is None:
                import contextlib
                lock = contextlib.nullcontext()
            with lock:
                if rec.oid not in self.recovery_ops:
                    return
                decoded(dec)

        def decoded(dec) -> None:
            t0 = state.pop("dec_t0", None)
            if t0 is not None:
                _obs = getattr(self.host, "observe_hops", None)
                if _obs is not None:
                    _obs({"decode_dispatch": t0,
                          "decode_complete": time.time()},
                         kind="recovery")
            if dec is None:
                self.recovery_ops.pop(oid, None)
                rec.cb(-5)
                return
            for s in missing_shards:
                pieces[s].append(dec[s])
            state["off"] += win
            if state["off"] >= shard_len:
                # single-window objects skip the join copy entirely;
                # multi-window recovery gathers once
                self._push_recovered(
                    rec, attrs,
                    {s: (pieces[s][0] if len(pieces[s]) == 1
                         else b"".join(pieces[s]))  # copycheck: ok - multi-window recovery gather
                     for s in missing_shards})
            else:
                read_next()

        read_next()

    def _try_subchunk_repair(self, rec: _RecoveryOp,
                             attrs: Dict[str, bytes], shard_len: int,
                             missing_shards: Set[int]) -> bool:
        """CLAY MSR single-shard repair: read only the repair
        sub-chunks (q^(t-1) of q^t planes) from each of d helpers
        instead of whole chunks from k — the repair-bandwidth saving
        that makes CLAY MSR (reference ECBackend.cc:1594
        get_min_avail_to_read_shards consulting the plugin +
        ErasureCodeClay::get_repair_subchunks, :334-392)."""
        impl = self.ec_impl
        if len(missing_shards) != 1:
            return False
        sub_no = getattr(impl, "get_sub_chunk_count", lambda: 1)()
        cs = self.sinfo.chunk_size
        if sub_no <= 1 or cs % sub_no or shard_len % cs:
            return False
        avail_map = {s: o for s, o in self.host.acting_shards()
                     if o is not None and s not in missing_shards}
        pos = ecutil.chunk_positions(impl)
        shard_of = {p: i for i, p in enumerate(pos)}
        want = {pos[s] for s in missing_shards}
        avail = {pos[s] for s in avail_map}
        try:
            if not impl.is_repair(want, avail):
                return False
            minimum = impl.minimum_to_repair(want, avail)
        except Exception:
            return False
        # the shard is a run of stripes, each chunk its own sub_no
        # sub-chunks: every stripe gives its repair sub-chunks, and
        # each stripe's chunk is repaired on its own
        sc = cs // sub_no
        nstripes = shard_len // cs
        ranges = {shard_of[c]: [(st * cs + off * sc, cnt * sc)
                                for st in range(nstripes)
                                for off, cnt in runs]
                  for c, runs in minimum.items()}
        shards = {c: avail_map[c] for c in ranges}
        block = {c: sum(ln for _, ln in r) // nstripes
                 for c, r in ranges.items()}
        lost = next(iter(missing_shards))
        oid = rec.oid

        def repair(received: Dict[int, bytes]) -> Dict[int, bytes]:
            parts: List[bytes] = []
            for st in range(nstripes):
                helpers = {pos[c]: buf[st * block[c]:(st + 1) * block[c]]
                           for c, buf in received.items()}
                parts.append(impl.decode(want, helpers, cs)[pos[lost]])
            return {lost: b"".join(parts)}  # copycheck: ok - one chunk a stripe

        def reads_done(received: Dict[int, bytes],
                       errors: Dict[int, int]) -> None:
            if rec.oid not in self.recovery_ops:
                return
            dec = None
            if not errors and len(received) == len(shards):
                try:
                    dec = repair(received)
                except Exception:
                    dec = None
            if dec is None:
                # a helper failed or repair math balked: fall back to
                # the whole-chunk path rather than failing the object
                self._recover_whole(rec, attrs, shard_len,
                                    missing_shards)
                return
            # stats record SUCCESSFUL repairs only — a fallback would
            # otherwise report savings that did not happen
            self.subchunk_repairs += 1
            self.repair_read_bytes += sum(
                ln for runs in ranges.values() for _, ln in runs)
            self.repair_whole_bytes += self.k * shard_len
            self._push_recovered(rec, attrs, dec)

        self._start_read(oid, 0, shard_len, shards, reads_done,
                         ranges=ranges, for_recovery=True)
        return True

    def _push_recovered(self, rec: _RecoveryOp, attrs: Dict[str, bytes],
                        dec: Dict[int, bytes]) -> None:
        """WRITING state: push decoded chunks + attrs to missing shards
        (reference ECBackend.cc:634+)."""
        for shard, osd in rec.missing_on:
            rec.pending_pushes.add(shard)
        for shard, osd in rec.missing_on:
            push = PushOp(oid=rec.oid, data_offset=0,
                          data=dec.get(shard, b""),
                          attrs=dict(attrs), complete=True,
                          version=rec.version)
            if osd == self.host.whoami:
                self._apply_push(shard, push,
                                 lambda s=shard: self._push_acked(
                                     rec.oid, s))
            else:
                pmsg = MOSDPGPush(
                    pgid=self.host.pgid_str, shard=shard,
                    from_osd=self.host.whoami, epoch=self.host.epoch,
                    pushes=[push])
                pmsg.stamp_hop("client_send")
                self.host.send_shard(osd, pmsg)

    def _apply_push(self, shard: int, push: PushOp,
                    on_commit: Callable[[], None]) -> None:
        """Shard-side recovery write (reference handle_recovery_push)."""
        coll = self.host.coll_of(shard)
        obj = GHObject(push.oid, shard)
        # late answers from abandoned recovery rounds must not roll a
        # shard back (strictly-newer check: equal-version pushes are
        # scrub repairs and must apply)
        info = self.get_object_info(push.oid, shard=shard)
        if info is not None and \
                tuple(info.version) > tuple(push.version):
            on_commit()
            return
        txn = Transaction()
        # remove-then-recreate: a stale local copy must not leak attrs
        # the authoritative copy no longer has
        txn.remove(coll, obj)
        txn.touch(coll, obj)
        if push.data:
            txn.write(coll, obj, push.data_offset, push.data)
        if push.attrs:
            txn.setattrs(coll, obj, push.attrs)

        def committed() -> None:
            self.host.note_object_recovered(push.oid, push.version)
            on_commit()
        txn.register_on_commit(
            lambda: self.host.on_local_commit(committed))
        self.host.store.queue_transactions([txn], op="recovery_push")

    def _push_acked(self, oid: str, shard: int) -> None:
        rec = self.recovery_ops.get(oid)
        if rec is None:
            return
        rec.pending_pushes.discard(shard)
        if not rec.pending_pushes:
            del self.recovery_ops[oid]
            rec.cb(0)

    # ------------------------------------------------------------------
    # message dispatch (both roles)
    # ------------------------------------------------------------------
    def handle_message(self, msg) -> bool:
        if isinstance(msg, MOSDECSubOpWrite):
            span = self.host.trace_span(
                "ec_sub_write", msg.trace_id,
                getattr(msg, "parent_span_id", 0))
            if span is not None:
                # child span per shard sub-write, parented under the
                # primary's osd_op span (reference ECBackend.cc:
                # 2063-2068 blkin spans)
                span.tag("shard", msg.shard).tag(
                    "pgid", msg.pgid).finish()
            seg = getattr(msg, "seg", 0)
            key = (msg.from_osd, msg.tid, seg)
            done = self._recent_subwrites.get(key)
            if done is not None:
                # deadline re-request of a sub-write we already have:
                # committed → re-ack (the original ack was lost);
                # still applying → stay silent, its ack is coming.
                # Either way NEVER re-apply (log entries must not
                # append twice).
                if done:
                    reack = MOSDECSubOpWriteReply(
                        pgid=self.host.pgid_str, shard=msg.shard,
                        from_osd=self.host.whoami, tid=msg.tid,
                        epoch=self.host.epoch, seg=seg)
                    if msg.hops:
                        reack.hops = dict(msg.hops)
                    reack.stamp_hop("commit_sent")
                    self.host.send_shard(msg.from_osd, reack)
                return True
            self._recent_subwrites[key] = False
            while len(self._recent_subwrites) > 512:
                self._recent_subwrites.pop(
                    next(iter(self._recent_subwrites)))
            txn = Transaction.decode(msg.txn)

            def _committed(m=msg, k=key, s=seg):
                self._recent_subwrites[k] = True
                m.stamp_hop("store_apply")
                reply = MOSDECSubOpWriteReply(
                    pgid=self.host.pgid_str, shard=m.shard,
                    from_osd=self.host.whoami, tid=m.tid,
                    epoch=self.host.epoch, seg=s)
                # ledger rides the round trip back to the primary
                if m.hops:
                    reply.hops = dict(m.hops)
                reply.stamp_hop("commit_sent")
                self.host.send_shard(m.from_osd, reply)
            self._apply_sub_write(msg.shard, txn, msg.log_entries,
                                  _committed)
            return True
        if isinstance(msg, MOSDECSubOpWriteReply):
            if faultlib.registry().check_drop(
                    faultlib.EC_SUBWRITE_ACK):
                return True  # ack lost: the deadline re-requests
            # sub-op waterfall closes at the primary: charge the
            # round trip into this OSD's hops view
            msg.stamp_hop("client_complete")
            _obs = getattr(self.host, "observe_hops", None)
            if _obs is not None:
                _obs(msg.hops)
            self._sub_write_committed(msg.tid, msg.shard,
                                      getattr(msg, "seg", 0))
            return True
        if isinstance(msg, MOSDECSubOpRead):
            span = self.host.trace_span(
                "ec_sub_read", getattr(msg, "trace_id", 0),
                getattr(msg, "parent_span_id", 0))
            if span is not None:
                span.tag("shard", msg.shard).tag(
                    "pgid", msg.pgid).finish()
            self._handle_sub_read(msg)
            return True
        if isinstance(msg, MOSDECSubOpReadReply):
            # sub-read waterfall closes at the primary, split by WHY
            # the read ran (client-facing reconstruction vs recovery)
            if msg.tid in self.attr_fetches:
                msg.stamp_hop("client_complete")
                _obs = getattr(self.host, "observe_hops", None)
                if _obs is not None:
                    _obs(msg.hops, kind="recovery")
                (rec,) = self.attr_fetches.pop(msg.tid)
                attrs = dict(msg.attrs[0][1]) if msg.attrs else {}
                self._attr_fetch_done(rec, attrs)
                return True
            rop = self.in_flight_reads.get(msg.tid)
            if rop is None:
                return True
            msg.stamp_hop("client_complete")
            _obs = getattr(self.host, "observe_hops", None)
            if _obs is not None:
                _obs(msg.hops,
                     kind="recovery" if getattr(rop, "for_recovery",
                                                False) else "read")
            if msg.errors:
                self._read_piece(rop, msg.shard, b"",
                                 msg.errors[0][1])
            elif msg.buffers:
                # multi-extent replies (CLAY sub-chunk repair runs)
                # concatenate in request order into one payload;
                # single-extent replies pass through copy-free
                if len(msg.buffers) == 1:
                    self._read_piece(rop, msg.shard,
                                     msg.buffers[0][2], 0)
                else:
                    self._read_piece(
                        rop, msg.shard,
                        b"".join(  # copycheck: ok - multi-buffer read-reply reassembly
                            b for _, _, b in msg.buffers), 0)
            return True
        if isinstance(msg, MOSDPGPush):
            def _push_done(p, m=msg):
                # recovery write landed: ledger rides the ack back to
                # the primary (same shape as the sub-write round trip)
                m.stamp_hop("store_apply")
                ack = MOSDPGPushReply(
                    pgid=self.host.pgid_str, shard=m.shard,
                    from_osd=self.host.whoami,
                    epoch=self.host.epoch, oids=[p.oid])
                if m.hops:
                    ack.hops = dict(m.hops)
                ack.stamp_hop("commit_sent")
                self.host.send_shard(m.from_osd, ack)
            for push in msg.pushes:
                self._apply_push(msg.shard, push,
                                 lambda p=push: _push_done(p))
            return True
        if isinstance(msg, MOSDPGPushReply):
            msg.stamp_hop("client_complete")
            _obs = getattr(self.host, "observe_hops", None)
            if _obs is not None:
                _obs(msg.hops, kind="recovery")
            for oid in msg.oids:
                self._push_acked(oid, msg.shard)
            return True
        return False

    def _handle_sub_read(self, msg: MOSDECSubOpRead) -> None:
        """Shard-side chunk read (reference handle_sub_read,
        ECBackend.cc:991)."""
        reply = MOSDECSubOpReadReply(
            pgid=self.host.pgid_str, shard=msg.shard,
            from_osd=self.host.whoami, tid=msg.tid,
            epoch=self.host.epoch)
        for oid, off, length in msg.reads:
            data, err = self._local_chunk_read(oid, msg.shard, off,
                                               length)
            if err < 0:
                reply.errors.append((oid, err))
            else:
                reply.buffers.append((oid, off, data))
        for oid in msg.attrs_to_read:
            try:
                attrs = self.host.store.getattrs(
                    self.host.coll_of(msg.shard), GHObject(oid, msg.shard))
                reply.attrs.append((oid, attrs))
            except FileNotFoundError:
                reply.errors.append((oid, -2))
        # local chunk service complete: the interval since pg_locked is
        # the shard's read work, and the ledger rides the reply home
        msg.stamp_hop("shard_read")
        if msg.hops:
            reply.hops = dict(msg.hops)
        reply.stamp_hop("commit_sent")
        self.host.send_shard(msg.from_osd, reply)

    def inflight_writes(self) -> int:
        return len(self._pipeline)

    def build_scrub_map(self, deep: bool) -> Dict[str, dict]:
        """Per-shard-object snapshot (reference ECBackend::be_deep_scrub,
        ECBackend.cc:2475-2579): under deep, recompute this shard's CRC
        from stored bytes and compare against the HashInfo xattr — no
        decode on scrub.  ``hinfo_ok`` is None when the CRC is
        unknowable (overwritten object cleared its cumulative CRCs).

        Deep CRCs batch per scrub window: CRC32C is a
        GF(2)-affine map, so a whole window of objects checksums as
        ONE bitmatrix matmul through the codec backend
        (ops/crclinear) instead of a per-chunk CPU loop.  With
        ``osd_deep_scrub_syndrome`` the same apply also emits GF
        syndrome CRC partials — XORed across shards by the primary,
        zero iff the whole code word is consistent — a distributed
        whole-stripe check the reference's per-shard CRC compare
        cannot see."""
        out: Dict[str, dict] = {}
        store = self.host.store
        shard = self.host.own_shard
        coll = self.host.coll
        pending = []                 # (entry, data, hinfo) for deep
        for obj in store.collection_list(coll):
            if obj.oid.startswith("_pgmeta"):
                continue
            try:
                st = store.stat(coll, obj)
                entry: Dict[str, object] = {"size": st.size,
                                            "shard": shard}
                info = self.get_object_info(obj.oid)
                entry["oi_version"] = list(info.version) if info else None
                if info is not None:
                    entry["expect_size"] = \
                        self.sinfo.object_size_to_shard_size(info.size)
                hinfo = None
                try:
                    hinfo = ecutil.HashInfo.decode(store.getattr(
                        coll, obj, ecutil.HINFO_KEY))
                except (FileNotFoundError, KeyError, ValueError):
                    pass
                if deep:
                    data = store.read(coll, obj)
                    pending.append((entry, data, hinfo))
            except OSError:
                # missing OR store-csum EIO: both scrub as read_error
                # and repair via recovery
                entry = {"error": "read_error", "shard": shard}
            out[obj.oid] = entry
        if pending:
            self._scrub_fill_crcs(pending)
            for entry, data, hinfo in pending:
                if hinfo is not None and \
                        hinfo.total_chunk_size == len(data):
                    entry["stored_crc"] = hinfo.crcs[shard]
                    entry["hinfo_ok"] = \
                        hinfo.crcs[shard] == entry["data_crc"]
                else:
                    entry["hinfo_ok"] = None        # CRC unknowable
        return out

    def _scrub_fill_crcs(self, pending) -> None:
        """Fill ``data_crc`` (and, when osd_deep_scrub_syndrome is
        on, ``syndrome_partials``) for every pending deep-scrub
        entry, one batched linear-CRC apply per
        ``ec_tpu_scrub_window_bytes`` window.  Any window trouble
        falls that window back to the per-chunk CPU loop — scrub
        must never fail an object on device grounds — and is counted
        in ``scrub_host_fallbacks`` with ``scrub_last_error``.  A
        window is applied with ``strict=True``, so a device fault
        surfaces here and not as crclinear's counted fallback.  On the
        card a window's bitmatrix past B1's operand limit (a data
        shard's ``[160, 4096]`` with four syndrome bands) runs in the
        row groups of ``split_plan``, one launch each."""
        def conf(key, dflt):
            try:
                return self.host.conf[key]
            except (AttributeError, KeyError, TypeError):
                return dflt
        wbytes = max(1 << 20, int(conf("ec_tpu_scrub_window_bytes",
                                       16 << 20)))
        shard = self.host.own_shard
        from ..ops import crclinear
        lin = crclinear.shared()
        backend = getattr(getattr(self.ec_impl, "core", None),
                          "backend", None)
        if backend is not None and \
                not hasattr(backend, "apply_bitmatrix_bytes"):
            backend = None
        scales = None
        if conf("osd_deep_scrub_syndrome", False):
            cm = getattr(getattr(self.ec_impl, "core", None),
                         "coding_matrix", None)
            if cm is not None and getattr(self.ec_impl, "w", 0) == 8:
                if shard < self.k:
                    scales = [int(cm[e][shard])
                              for e in range(self.m)]
                else:
                    scales = [1 if e == shard - self.k else 0
                              for e in range(self.m)]
        # the batched bitmatrix CRC only beats the native per-chunk
        # host kernel when the card executes the apply OR the GF
        # syndrome bands must fold into the same matmul; on the CPU
        # with syndrome off, the host loop is strictly faster, so
        # route there (a routing verdict, not a fallback)
        accel = bool(getattr(backend, "is_cuda", False))
        _obs = getattr(self.host, "observe_hops", None)
        import numpy as np
        i = 0
        while i < len(pending):
            t0 = time.time()
            j, acc = i, 0
            while j < len(pending) and \
                    (j == i or acc + len(pending[j][1]) <= wbytes):
                acc += len(pending[j][1])
                j += 1
            window = pending[i:j]
            chunks = [p[1] for p in window]
            lens = [len(c) for c in chunks]
            try:
                if scales is None and not (accel and
                                           backend is not None):
                    raise _HostCrcWindow
                if scales is not None:
                    # distinct nonzero syndrome scales share the data
                    # band's apply: bands = (1, *scales) in one matmul
                    nz = sorted({s for s in scales if s})
                    Lmax = max(lens) if lens else 0
                    stack = np.zeros((len(chunks), Lmax),
                                     dtype=np.uint8)
                    for idx, c in enumerate(chunks):
                        if lens[idx]:
                            stack[idx, Lmax - lens[idx]:] = \
                                np.frombuffer(c, dtype=np.uint8)
                    parts = lin._apply_window(
                        stack, (1,) + tuple(nz), backend=backend,
                        strict=True)
                    zero = np.array([lin.zero_crc(n) for n in lens],
                                    dtype=np.uint32)
                    crcs = parts[0] ^ zero
                    for idx, (entry, _d, _h) in enumerate(window):
                        entry["data_crc"] = int(crcs[idx])
                        entry["syndrome_partials"] = [
                            int(parts[1 + nz.index(s)][idx])
                            if s else 0 for s in scales]
                else:
                    crcs = lin.crc_batch(chunks, backend=backend,
                                         strict=True)
                    for idx, (entry, _d, _h) in enumerate(window):
                        entry["data_crc"] = int(crcs[idx])
                self.scrub_device_windows += 1
            except Exception as e:
                if not isinstance(e, _HostCrcWindow):
                    self.scrub_host_fallbacks += 1
                    self.scrub_last_error = e
                for entry, data, _h in window:
                    entry["data_crc"] = ecutil.chunk_crc(data)
            self.scrub_windows += 1
            self.scrub_crc_bytes += sum(lens)
            if _obs is not None:
                # one scrub_window hop per batched window: the scrub
                # waterfall attributes checksum time per window, not
                # per object
                _obs({"pg_locked": t0, "scrub_window": time.time()},
                     kind="recovery")
            i = j

    def on_change(self) -> None:
        """New interval: drop every in-flight op (reference on_change);
        clients resend against the new acting set."""
        for op in self._pipeline:
            op.alive = False         # late encode callbacks must drop
        for op in self.waiting_commit.values():
            self._cancel_deadline(op)
        self._pending_objs.clear()
        self.waiting_commit.clear()
        self.in_flight_reads.clear()
        self.attr_fetches.clear()
        self.recovery_ops.clear()
        self._pipeline.clear()
