"""Cluster-path hop ledger: cross-daemon waterfall attribution.

Dapper-style cumulative span ledger carried ON the message (PAPERS.md:
distributed tracing): each daemon that touches an op appends absolute
timestamps for the hops it owns, and whoever sees the op complete
charges each inter-hop interval to the hop that ENDS it — the same
interval-charging rule the critical-path accumulator uses inside
one daemon, extended across the wire.  Because the ledger is
cumulative and replies carry the request's ledger back, the final
observer holds the whole client→store→client path in one dict and the
per-op invariant is exact by construction:

    sum(charged intervals) == last_stamp - first_stamp == op wall

Hops are identified by small fixed wire ids so the on-wire form is a
compact trailing field (1 + 9*n bytes); decoders tolerate its absence
entirely (old peers) and skip unknown ids (newer peers).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

#: canonical hop order along the write path.  Wire id == list index —
#: APPEND-ONLY: ids are wire format, never renumber.
HOP_ORDER = (
    "client_send",      # op constructed at the sender
    "msgr_enqueue",     # queued on the connection's out_q
    "wire_sent",        # writer thread hands the frame to the socket
    "recv",             # frame decoded on the receiving daemon
    "dispatch_queued",  # entered the OSD's dispatch layer
    "pg_queued",        # queued for its PG (shard queue / reactor)
    "pg_locked",        # PG lock acquired, op logic running
    "store_apply",      # local store transaction committed
    "commit_sent",      # reply queued back toward the sender
    "client_complete",  # sender observed the commit/completion
    "xshard_handoff",   # op landed on its PG's owning reactor shard
    # -- read/recovery-side hops; same append-only rule --
    "read_queued",      # read handed to the backend's fan-out
    "shard_read",       # shard served its local chunk read
    "decode_dispatch",  # reconstruction decode handed to the batcher
    "decode_complete",  # decoded payload back on the op path
    "scrub_window",     # one deep-scrub window walked + hashed
    # -- the async store made the old primary-side
    # store_apply stamp a lie — it fired only when the LAST peer ack
    # arrived, so distributed ack-collection time was charged to the
    # store.  store_apply now stamps at the primary's local store
    # commit; this hop closes when the full acting-set ack arrives.
    "peer_ack_wait",    # replica/shard commit acks all collected
)
HOP_ID: Dict[str, int] = {name: i for i, name in enumerate(HOP_ORDER)}

#: hops only some paths visit: the write-path waterfall tests assert
#: full hop coverage MINUS this set (xshard only under multi-reactor
#: crimson; the read/recovery/scrub hops never on a pure write)
CONDITIONAL_HOPS = frozenset((
    "xshard_handoff", "read_queued", "shard_read",
    "decode_dispatch", "decode_complete", "scrub_window",
))

#: path-position order for interval charging.  HOP_ORDER is wire
#: format and append-only, so a hop added later (xshard_handoff, wire
#: id 10) cannot be renumbered into its true position; this tuple is
#: presentation-only and places each hop where it happens on the
#: path: the cross-shard mailbox handoff sits between the op being
#: queued for its PG and the PG logic running.
#: the read-side hops slot between the PG logic running and the store/
#: reply legs: a degraded read queues its shard fan-out (read_queued),
#: shards serve chunks (shard_read), reconstruction decodes
#: (decode_dispatch -> decode_complete), then the reply leaves
#: (commit_sent).  scrub_window closes a synthetic scrub ledger.
CHARGE_ORDER = (
    "client_send", "msgr_enqueue", "wire_sent", "recv",
    "dispatch_queued", "pg_queued", "xshard_handoff", "pg_locked",
    "read_queued", "shard_read", "decode_dispatch", "decode_complete",
    "store_apply", "peer_ack_wait", "commit_sent", "client_complete",
    "scrub_window",
)

#: log-spaced histogram bounds (seconds) for per-hop intervals: the
#: interesting range spans ~50 us (lock handoff) to seconds (stalls)
HOP_BOUNDS: List[float] = [
    50e-6, 100e-6, 250e-6, 500e-6,
    1e-3, 2.5e-3, 5e-3, 10e-3, 25e-3, 50e-3,
    100e-3, 250e-3, 500e-3, 1.0, 2.5,
]


def encode_ledger(e, hops: Optional[Dict[str, float]]) -> None:
    """Append the ledger as a trailing wire field: u8 count then
    (u8 hop_id, f64 abs_timestamp) per entry.  Pre-ledger decoders
    never look this far into the payload, so the field is invisible
    to them; ``None``/empty encodes as a single zero byte."""
    if not hops:
        e.u8(0)
        return
    items = sorted((HOP_ID[k], v) for k, v in hops.items()
                   if k in HOP_ID)
    e.u8(len(items))
    for hop_id, ts in items:
        e.u8(hop_id)
        e.f64(ts)


def decode_ledger(d) -> Optional[Dict[str, float]]:
    """Decode the trailing ledger; DEFAULT, never raise: a peer that
    predates the ledger simply ends its payload here (remaining()==0),
    and a truncated/garbled trailer reads as "no ledger" rather than
    poisoning an otherwise-valid message."""
    if d.remaining() < 1:
        return None
    n = d.u8()
    if d.remaining() < 9 * n:
        return None
    out: Dict[str, float] = {}
    norder = len(HOP_ORDER)
    for _ in range(n):
        hop_id = d.u8()
        ts = d.f64()
        if hop_id < norder:             # skip ids from newer peers
            out[HOP_ORDER[hop_id]] = ts
    return out or None


def charge(hops: Dict[str, float]):
    """-> list of (hop_name, interval_seconds) charging each interval
    to the hop that ends it, iterating hops in path order and
    skipping absent ones (a hop a path never visits — e.g. pg_queued
    on a sub-write — charges nothing; its time folds into the next
    present hop, keeping the per-op sum exact)."""
    prev = None
    out = []
    for name in CHARGE_ORDER:
        t = hops.get(name)
        if t is None:
            continue
        if prev is not None and t >= prev:
            out.append((name, t - prev))
        prev = t
    return out


def _percentile(bounds: List[float], buckets: List[int],
                q: float) -> float:
    """Histogram quantile, upper-bound convention (same math as the
    prometheus module's derived p50/p99 gauges)."""
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


class HopAccum:
    """Per-hop interval accumulator (the cross-daemon sibling of
    critpath.CriticalPathAccum).

    Keeps its own histogram state so ledger-observing clients need no
    perf-counter plumbing; when given a ``perf_coll`` it additionally
    registers a perf subsystem (one histogram + time-avg per hop, plus
    an op counter) so the intervals surface in ``perf dump`` and as
    ``ceph_{subsystem}_*`` prometheus families.  ``subsystem`` names
    that registration so one daemon can run several accumulators
    (write sub-ops / client reads / recovery) side by side.
    """

    RECENT_LEDGERS = 256

    def __init__(self, perf_coll=None, subsystem: str = "hops"):
        self._lock = threading.Lock()
        self.ops = 0
        self.op_seconds = 0.0
        self.hop_seconds: Dict[str, float] = {}
        self.hop_counts: Dict[str, int] = {}
        self._buckets: Dict[str, List[int]] = {}
        # bounded ring of raw ledgers for the trace exporter: absolute
        # wall-clock stamps, so per-op slices line up across daemons
        self._recent: deque = deque(maxlen=self.RECENT_LEDGERS)
        self.hperf = None
        if perf_coll is not None:
            hp = perf_coll.create(subsystem)
            # two daemons may share a collection (tests); register once
            if "ops" not in hp._types:
                hp.add("ops", description="ledger-bearing ops observed")
                for name in HOP_ORDER:
                    hp.add_time_avg(
                        f"{name}_s",
                        description=f"time charged to hop {name}")
                    hp.add_histogram(
                        f"{name}_hist_s", HOP_BOUNDS,
                        description=f"per-op {name} interval histogram")
            self.hperf = hp

    def observe_wire(self, hops: Optional[Dict[str, float]]) -> None:
        """Fold one completed op's ledger in.  Tolerates None/partial
        ledgers (old peers, paths that skip hops)."""
        if not hops or len(hops) < 2:
            return
        charged = charge(hops)
        if not charged:
            return
        bisect = _bisect
        with self._lock:
            self.ops += 1
            self._recent.append(dict(hops))
            hop_seconds, hop_counts = self.hop_seconds, self.hop_counts
            buckets = self._buckets
            for name, dt in charged:
                self.op_seconds += dt
                hop_seconds[name] = hop_seconds.get(name, 0.0) + dt
                hop_counts[name] = hop_counts.get(name, 0) + 1
                b = buckets.get(name)
                if b is None:
                    b = buckets[name] = [0] * (len(HOP_BOUNDS) + 1)
                b[bisect(HOP_BOUNDS, dt)] += 1
        hp = self.hperf
        if hp is not None:
            hp.inc("ops")
            hp.inc_many((f"{name}_s", dt) for name, dt in charged)
            for name, dt in charged:
                hp.hinc(f"{name}_hist_s", dt)

    def dump(self) -> dict:
        with self._lock:
            buckets = {k: list(v) for k, v in self._buckets.items()}
            out = {
                "ops": self.ops,
                "op_seconds": self.op_seconds,
                "hop_seconds": dict(self.hop_seconds),
                "hop_counts": dict(self.hop_counts),
                "bounds": list(HOP_BOUNDS),
                "buckets": buckets,
            }
        out["p50_s"] = {k: _percentile(HOP_BOUNDS, v, 0.50)
                        for k, v in buckets.items()}
        out["p99_s"] = {k: _percentile(HOP_BOUNDS, v, 0.99)
                        for k, v in buckets.items()}
        return out

    def recent(self) -> List[Dict[str, float]]:
        """Raw ledgers of the most recent observed ops (bounded ring),
        for the unified trace exporter's per-op tracks."""
        with self._lock:
            return [dict(h) for h in self._recent]


def _bisect(bounds: List[float], value: float) -> int:
    lo, hi = 0, len(bounds)
    while lo < hi:
        mid = (lo + hi) // 2
        if value <= bounds[mid]:
            hi = mid
        else:
            lo = mid + 1
    return lo


def merge_dumps(dumps: List[dict]) -> dict:
    """Merge HopAccum.dump()s from several observers (the client plus
    every OSD's sub-op view) into one cluster-wide dump."""
    out = {"ops": 0, "op_seconds": 0.0, "hop_seconds": {},
           "hop_counts": {}, "bounds": list(HOP_BOUNDS), "buckets": {}}
    for dump in dumps:
        if not dump:
            continue
        out["ops"] += dump.get("ops", 0)
        out["op_seconds"] += dump.get("op_seconds", 0.0)
        for k, v in dump.get("hop_seconds", {}).items():
            out["hop_seconds"][k] = out["hop_seconds"].get(k, 0.0) + v
        for k, v in dump.get("hop_counts", {}).items():
            out["hop_counts"][k] = out["hop_counts"].get(k, 0) + v
        for k, b in dump.get("buckets", {}).items():
            acc = out["buckets"].setdefault(k, [0] * (len(HOP_BOUNDS) + 1))
            for i, c in enumerate(b):
                acc[i] += c
    out["p50_s"] = {k: _percentile(HOP_BOUNDS, v, 0.50)
                    for k, v in out["buckets"].items()}
    out["p99_s"] = {k: _percentile(HOP_BOUNDS, v, 0.99)
                    for k, v in out["buckets"].items()}
    return out


def waterfall_block(dump: dict, wall_s: float) -> dict:
    """Shape a HopAccum dump into bench.py's attribution `waterfall`
    block: hop shares of op-time, those shares scaled onto the
    measured client wall (mirroring the critpath stage invariant —
    scaled seconds sum to wall, shares sum to 1.0), per-hop p50/p99,
    and the named top bottleneck hop."""
    hop_seconds = dump.get("hop_seconds", {})
    total = sum(hop_seconds.values())
    shares = {k: (v / total if total > 0 else 0.0)
              for k, v in hop_seconds.items()}
    scaled = {k: wall_s * s for k, s in shares.items()}
    top = max(shares.items(), key=lambda kv: kv[1])[0] if shares else None
    return {
        "ops": dump.get("ops", 0),
        "wall_s": wall_s,
        "hop_seconds": {k: round(v, 6) for k, v in hop_seconds.items()},
        "shares": {k: round(v, 4) for k, v in shares.items()},
        "scaled_s": {k: round(v, 6) for k, v in scaled.items()},
        "p50_s": dump.get("p50_s", {}),
        "p99_s": dump.get("p99_s", {}),
        "sum_of_shares": round(sum(shares.values()), 4),
        "vs_wall": round(sum(scaled.values()) / wall_s, 4)
        if wall_s > 0 else 0.0,
        "top_hop": top,
    }
