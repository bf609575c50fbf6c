"""Store-transaction ledger: the waterfall below the store_apply wall.

The cluster hop ledger (utils/hops.py) ends at ``store_apply``: the
whole local ObjectStore transaction is one opaque interval, which is
exactly where the ROADMAP's item-2 store rewrite has to win.  This
module extends the established charge-to-ENDING-phase discipline
(hops -> device_ledger) into the transaction path: every
``queue_transactions`` call carries a **StoreLedger** — a plain dict
of absolute wall-clock phase stamps (same clock as the hop ledger and
the DeviceLedger, so store slices nest under their enclosing
``store_apply`` hop slice in the Perfetto export) — and the base-class
seam that sees the transaction complete charges each inter-stamp
interval to the phase that ENDS it:

    txn_queued -> journal_append -> journal_fsync -> alloc
        -> data_write -> compress -> kv_commit -> flush -> apply_done

    sum(charged intervals) == last_stamp - first_stamp == txn wall

Stamps are placed by ObjectStore-level seams (``_stamp_txn``), so all
three backends — BlockStore, FileStore, MemStore — and any future
BlueStore-class rewrite inherit the instrumentation for free; phases
a backend doesn't have simply never stamp and fold to zero-width
(MemStore has no journal: its whole wall charges to data_write /
flush, same rule as hops.charge / device charge_phases).

``alloc`` and ``compress`` are the two phases that cannot carry
monotone stamps of their own: block allocation and inline compression
interleave per-block inside the apply loop.  They ride as accumulated
META seconds (``alloc_s`` / ``compress_s``) and :func:`charge` carves
them out of the enclosing ``data_write`` interval, clamped so the
per-txn sum stays exact.

On top sits the per-op-type census (write/truncate/setattr/omap/clone
counts + bytes) and IO accounting (bytes_written, journal_bytes,
blocks allocated/freed, compress ratio, txn batch occupancy),
registered as the ``store`` perf subsystem so the whole block exports
as ``ceph_store_*`` prometheus families.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

#: canonical phase order along the transaction path.  Charging
#: iterates in this order and skips absent stamps — a backend without
#: a journal or KV never stamps those phases and their time folds
#: into the next present phase, keeping the per-txn sum exact.
PHASE_ORDER = (
    "txn_queued",       # txn admitted to queue_transactions (t0)
    "journal_append",   # WAL record written (page cache, not durable)
    "journal_fsync",    # WAL durable on media
    "deferred_queue",   # durable txn waiting for the deferred applier
    "alloc",            # block allocation (carved from data_write)
    "data_write",       # object data written + device flush/fsync
    "compress",         # inline compression (carved from data_write)
    "kv_commit",        # the one atomic KV flip (extent maps, WAL retire)
    "flush",            # on_applied delivered inline
    "apply_done",       # commit callbacks queued to the finisher
)

#: phases that carry no stamp of their own: their seconds accumulate
#: in these meta fields and charge() carves them out of data_write
CARVED = (("alloc_s", "alloc"), ("compress_s", "compress"))

#: non-phase fields a ledger dict may carry alongside the stamps
META_FIELDS = frozenset((
    "op", "backend", "txns", "ops", "bytes_written", "journal_bytes",
    "alloc_s", "compress_s", "blocks_allocated", "blocks_freed",
    "compress_logical", "compress_stored",
))

#: log-spaced histogram bounds (seconds): store phases live between
#: ~10 us (MemStore dict ops) and seconds (fsync stalls on a wedged
#: disk) — same span as the device ledger
PHASE_BOUNDS: List[float] = [
    10e-6, 25e-6, 50e-6, 100e-6, 250e-6, 500e-6,
    1e-3, 2.5e-3, 5e-3, 10e-3, 25e-3, 50e-3,
    100e-3, 250e-3, 500e-3, 1.0,
]

#: op-type census families: every Transaction op name maps to one
#: (the omap variants collapse; collection plumbing counts as other)
OP_FAMILIES = ("write", "truncate", "setattr", "omap", "clone",
               "touch", "remove", "other")
_OP_FAMILY = {
    "write": "write", "zero": "write", "xor_write": "write",
    "truncate": "truncate",
    "setattr": "setattr", "setattrs": "setattr", "rmattr": "setattr",
    "omap_setkeys": "omap", "omap_rmkeys": "omap",
    "omap_clear": "omap", "omap_setheader": "omap",
    "clone": "clone", "coll_move_rename": "clone",
    "touch": "touch",
    "remove": "remove",
}


def op_family(name: str) -> str:
    return _OP_FAMILY.get(name, "other")


def charge(ledger: Dict[str, float]) -> List[Tuple[str, float]]:
    """-> list of (phase_name, interval_seconds) charging each
    interval to the phase that ends it, with the carved phases
    (alloc/compress meta seconds) clamped out of data_write; per-txn
    sum is exact by construction (== last stamp - first stamp)."""
    prev = None
    intervals: Dict[str, float] = {}
    for name in PHASE_ORDER:
        t = ledger.get(name)
        if not isinstance(t, (int, float)):
            continue
        if prev is not None and t >= prev:
            intervals[name] = intervals.get(name, 0.0) + (t - prev)
        prev = t
    if not intervals:
        return []
    dw = intervals.get("data_write")
    if dw is not None:
        for meta, phase in CARVED:
            v = ledger.get(meta)
            if isinstance(v, (int, float)) and v > 0 and dw > 0:
                take = min(float(v), dw)
                dw -= take
                intervals[phase] = intervals.get(phase, 0.0) + take
        intervals["data_write"] = dw
    return [(name, intervals[name]) for name in PHASE_ORDER
            if name in intervals]


def _percentile(bounds: List[float], buckets: List[int],
                q: float) -> float:
    total = sum(buckets)
    if total == 0:
        return 0.0
    rank = q * total
    seen = 0
    for i, c in enumerate(buckets):
        seen += c
        if seen >= rank:
            return bounds[i] if i < len(bounds) else bounds[-1]
    return bounds[-1]


def _bisect(bounds: List[float], value: float) -> int:
    lo, hi = 0, len(bounds)
    while lo < hi:
        mid = (lo + hi) // 2
        if value <= bounds[mid]:
            hi = mid
        else:
            lo = mid + 1
    return lo


class StoreLedgerAccum:
    """Per-phase interval accumulator for store transactions (the
    store-side sibling of DeviceLedgerAccum).

    Keeps histogram state locally so tests and bench-side observers
    need no perf-counter plumbing; ``bind_perf`` registers the
    ``store`` perf subsystem (one histogram + time-avg per phase,
    txn/op census counters, IO accounting) so the block surfaces in
    ``perf dump`` and as ``ceph_store_*`` prometheus families.
    Binding is separate from construction because the store object
    survives OSD restarts: a re-attach rebinds the counters into the
    new daemon's collection without losing accumulated state.
    """

    RECENT_LEDGERS = 256

    def __init__(self, perf_coll=None, subsystem: str = "store"):
        self._lock = threading.Lock()
        self.txns = 0
        self.txn_seconds = 0.0
        self.batch_calls = 0          # queue_transactions invocations
        self.batch_txns = 0           # txns across those calls
        self.stalls = 0
        self.aborts = 0               # queue_transactions exits by raise
        self.phase_seconds: Dict[str, float] = {}
        self.phase_counts: Dict[str, int] = {}
        self.op_counts: Dict[str, int] = {}
        self.bytes_written = 0
        self.journal_bytes = 0
        self.blocks_allocated = 0
        self.blocks_freed = 0
        self.compress_logical = 0
        self.compress_stored = 0
        self._buckets: Dict[str, List[int]] = {}
        self._recent: deque = deque(maxlen=self.RECENT_LEDGERS)
        self.slperf = None
        if perf_coll is not None:
            self.bind_perf(perf_coll, subsystem)

    def bind_perf(self, perf_coll, subsystem: str = "store") -> None:
        dp = perf_coll.create(subsystem)
        # two daemons may share a collection (tests); register once
        if "txns" not in dp._types:
            dp.add("txns", description="store transactions applied")
            dp.add("txn_batches",
                   description="queue_transactions calls (batch "
                               "occupancy = txns / txn_batches)")
            dp.add("phase_stalls",
                   description="store phases at/over "
                               "store_phase_stall_ms")
            dp.add("txn_aborts",
                   description="queue_transactions calls that raised "
                               "(ledger discarded, nothing charged)")
            for name in PHASE_ORDER:
                dp.add_time_avg(
                    f"{name}_s",
                    description=f"time charged to store phase {name}")
                dp.add_histogram(
                    f"{name}_hist_s", PHASE_BOUNDS,
                    description=f"per-txn {name} interval histogram")
            for fam in OP_FAMILIES:
                dp.add(f"op_{fam}",
                       description=f"{fam}-family transaction ops")
            dp.add("bytes_written",
                   description="object payload bytes written")
            dp.add("journal_bytes",
                   description="WAL bytes appended")
            dp.add("blocks_allocated",
                   description="data blocks COW-allocated")
            dp.add("blocks_freed",
                   description="data blocks freed")
            dp.add_u64("compress_ratio_pct",
                       description="stored/logical compressed bytes "
                                   "as a percentage (100 = no win)")
            dp.add_u64("txn_batch_occupancy_x100",
                       description="mean txns per queue_transactions "
                                   "call x100")
        self.slperf = dp

    def observe(self, ledger: Optional[Dict[str, float]],
                op_counts: Optional[Dict[str, int]] = None
                ) -> List[Tuple[str, float]]:
        """Fold one completed transaction's ledger in; -> the charged
        (phase, seconds) list so the caller's stall check needs no
        second charge pass.  Tolerates None / partial ledgers."""
        if not ledger:
            return []
        charged = charge(ledger)
        if not charged:
            return []
        bisect = _bisect
        ntxns = int(ledger.get("txns", 1) or 1)
        bw = int(ledger.get("bytes_written", 0) or 0)
        jb = int(ledger.get("journal_bytes", 0) or 0)
        ba = int(ledger.get("blocks_allocated", 0) or 0)
        bf = int(ledger.get("blocks_freed", 0) or 0)
        cl = int(ledger.get("compress_logical", 0) or 0)
        cs = int(ledger.get("compress_stored", 0) or 0)
        with self._lock:
            self.txns += 1
            self.batch_calls += 1
            self.batch_txns += ntxns
            self.bytes_written += bw
            self.journal_bytes += jb
            self.blocks_allocated += ba
            self.blocks_freed += bf
            self.compress_logical += cl
            self.compress_stored += cs
            # underscore keys are backend-private handshake state
            # (e.g. BlueStore's _deferred ownership flag), not txn data
            self._recent.append(
                {k: v for k, v in ledger.items()
                 if not (isinstance(k, str) and k.startswith("_"))})
            phase_seconds, phase_counts = \
                self.phase_seconds, self.phase_counts
            buckets = self._buckets
            for name, dt in charged:
                self.txn_seconds += dt
                phase_seconds[name] = phase_seconds.get(name, 0.0) + dt
                phase_counts[name] = phase_counts.get(name, 0) + 1
                b = buckets.get(name)
                if b is None:
                    b = buckets[name] = [0] * (len(PHASE_BOUNDS) + 1)
                b[bisect(PHASE_BOUNDS, dt)] += 1
            if op_counts:
                for fam, n in op_counts.items():
                    self.op_counts[fam] = \
                        self.op_counts.get(fam, 0) + n
        dp = self.slperf
        if dp is not None:
            dp.inc("txns", ntxns)
            dp.inc("txn_batches")
            dp.inc_many((f"{name}_s", dt) for name, dt in charged)
            for name, dt in charged:
                dp.hinc(f"{name}_hist_s", dt)
            if op_counts:
                for fam, n in op_counts.items():
                    dp.inc(f"op_{fam}", n)
            if bw:
                dp.inc("bytes_written", bw)
            if jb:
                dp.inc("journal_bytes", jb)
            if ba:
                dp.inc("blocks_allocated", ba)
            if bf:
                dp.inc("blocks_freed", bf)
            if cl:
                dp.set("compress_ratio_pct",
                       round(100.0 * self.compress_stored
                             / max(1, self.compress_logical)))
            dp.set("txn_batch_occupancy_x100",
                   round(100.0 * self.batch_txns
                         / max(1, self.batch_calls)))
        return charged

    def note_stall(self) -> None:
        with self._lock:
            self.stalls += 1
        dp = self.slperf
        if dp is not None:
            dp.inc("phase_stalls")

    def note_abort(self) -> None:
        """A queue_transactions call raised: its ledger is discarded
        whole (dangling stamps must not bleed into the next txn), and
        the abort itself is the only thing recorded."""
        with self._lock:
            self.aborts += 1
        dp = self.slperf
        if dp is not None:
            dp.inc("txn_aborts")

    def dump(self) -> dict:
        with self._lock:
            buckets = {k: list(v) for k, v in self._buckets.items()}
            out = {
                "txns": self.txns,
                "txn_seconds": self.txn_seconds,
                "phase_seconds": dict(self.phase_seconds),
                "phase_counts": dict(self.phase_counts),
                "bounds": list(PHASE_BOUNDS),
                "buckets": buckets,
                "stalls": self.stalls,
                "aborts": self.aborts,
                "io": {
                    "op_counts": dict(self.op_counts),
                    "bytes_written": self.bytes_written,
                    "journal_bytes": self.journal_bytes,
                    "blocks_allocated": self.blocks_allocated,
                    "blocks_freed": self.blocks_freed,
                    "compress_logical": self.compress_logical,
                    "compress_stored": self.compress_stored,
                    "batch_calls": self.batch_calls,
                    "batch_txns": self.batch_txns,
                },
            }
        io = out["io"]
        io["compress_ratio"] = round(
            io["compress_stored"] / io["compress_logical"], 4) \
            if io["compress_logical"] else 0.0
        io["txn_batch_occupancy"] = round(
            io["batch_txns"] / io["batch_calls"], 4) \
            if io["batch_calls"] else 0.0
        out["p50_s"] = {k: _percentile(PHASE_BOUNDS, v, 0.50)
                        for k, v in buckets.items()}
        out["p99_s"] = {k: _percentile(PHASE_BOUNDS, v, 0.99)
                        for k, v in buckets.items()}
        return out

    def recent(self) -> List[Dict[str, float]]:
        """Raw ledgers of the most recent observed transactions
        (bounded ring), for the trace exporter's store lanes."""
        with self._lock:
            return [dict(h) for h in self._recent]


def merge_dumps(dumps: List[dict]) -> dict:
    """Merge StoreLedgerAccum.dump()s from several daemons into one
    cluster-wide view; ratios are recomputed over the pooled sums."""
    out = {"txns": 0, "txn_seconds": 0.0, "phase_seconds": {},
           "phase_counts": {}, "bounds": list(PHASE_BOUNDS),
           "buckets": {}, "stalls": 0, "aborts": 0}
    io = {"op_counts": {}, "bytes_written": 0, "journal_bytes": 0,
          "blocks_allocated": 0, "blocks_freed": 0,
          "compress_logical": 0, "compress_stored": 0,
          "batch_calls": 0, "batch_txns": 0}
    for dump in dumps:
        if not dump:
            continue
        out["txns"] += dump.get("txns", 0)
        out["txn_seconds"] += dump.get("txn_seconds", 0.0)
        out["stalls"] += dump.get("stalls", 0)
        out["aborts"] += dump.get("aborts", 0)
        for k, v in dump.get("phase_seconds", {}).items():
            out["phase_seconds"][k] = \
                out["phase_seconds"].get(k, 0.0) + v
        for k, v in dump.get("phase_counts", {}).items():
            out["phase_counts"][k] = \
                out["phase_counts"].get(k, 0) + v
        for k, b in dump.get("buckets", {}).items():
            acc = out["buckets"].setdefault(
                k, [0] * (len(PHASE_BOUNDS) + 1))
            for i, c in enumerate(b):
                acc[i] += c
        d_io = dump.get("io") or {}
        for k, v in (d_io.get("op_counts") or {}).items():
            io["op_counts"][k] = io["op_counts"].get(k, 0) + v
        for k in ("bytes_written", "journal_bytes",
                  "blocks_allocated", "blocks_freed",
                  "compress_logical", "compress_stored",
                  "batch_calls", "batch_txns"):
            io[k] += d_io.get(k, 0)
    io["compress_ratio"] = round(
        io["compress_stored"] / io["compress_logical"], 4) \
        if io["compress_logical"] else 0.0
    io["txn_batch_occupancy"] = round(
        io["batch_txns"] / io["batch_calls"], 4) \
        if io["batch_calls"] else 0.0
    out["io"] = io
    out["p50_s"] = {k: _percentile(PHASE_BOUNDS, v, 0.50)
                    for k, v in out["buckets"].items()}
    out["p99_s"] = {k: _percentile(PHASE_BOUNDS, v, 0.99)
                    for k, v in out["buckets"].items()}
    return out


def store_waterfall_block(dump: dict, wall_s: float) -> dict:
    """Shape a store-ledger dump into bench.py's attribution
    ``store_waterfall`` block: phase shares of cumulative store time
    (sum to 1.0), those shares scaled onto the measured store wall
    (the hop waterfall's scaled ``store_apply`` seconds), per-phase
    p50/p99, the named top phase, and the IO census — mirroring
    device_waterfall_block / hops.waterfall_block."""
    phase_seconds = dump.get("phase_seconds", {})
    total = sum(phase_seconds.values())
    shares = {k: (v / total if total > 0 else 0.0)
              for k, v in phase_seconds.items()}
    scaled = {k: wall_s * s for k, s in shares.items()}
    top = max(shares.items(), key=lambda kv: kv[1])[0] \
        if shares else None
    return {
        "txns": dump.get("txns", 0),
        "wall_s": wall_s,
        "phase_seconds": {k: round(v, 6)
                          for k, v in phase_seconds.items()},
        "shares": {k: round(v, 4) for k, v in shares.items()},
        "scaled_s": {k: round(v, 6) for k, v in scaled.items()},
        "p50_s": dump.get("p50_s", {}),
        "p99_s": dump.get("p99_s", {}),
        "sum_of_shares": round(sum(shares.values()), 4),
        "vs_wall": round(sum(scaled.values()) / wall_s, 4)
        if wall_s > 0 else 0.0,
        "top_phase": top,
        "stalls": dump.get("stalls", 0),
        "aborts": dump.get("aborts", 0),
        "io": dump.get("io", {}),
    }
