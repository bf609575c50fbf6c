"""Device-phase ledger: sub-dispatch waterfall attribution.

The cluster hop ledger (utils/hops.py) stops at ``decode_dispatch`` /
the batcher boundary: everything between encode dispatch and
completion is one opaque interval, which is exactly where the codec's
17x lives.  This module extends the same charge-to-ending-phase
discipline down into the device: each encode/decode group carries a
**DeviceLedger** — a plain dict of absolute wall-clock phase stamps
(same clock as the hop ledger, so trace slices nest across the two) —
and whoever sees the group complete charges each inter-stamp interval
to the phase that ENDS it:

    stage_acquire -> h2d_start -> h2d_done -> compute_start
        -> compute_done (fence) -> d2h_done -> deliver

    sum(charged intervals) == last_stamp - first_stamp == group wall

Ledgers are keyed by device ordinal (``device`` field; the CUDA
ordinal in this package) so lanes are mesh-ready: on a multi-device
host the same dict sprouts one lane per device with no schema change.  Groups the
crossover learner routes to the CPU twin carry ``device=-1`` (the
host lane): they fold into the same phase accounting — so the bench
waterfall covers every group regardless of routing — but the overlap
engine skips them (no h2d to hide under compute).

On top sits the **overlap-efficiency engine**: with
``ec_tpu_inflight_groups=2`` the batcher pipelines group N+1's h2d
under group N's compute; ``overlap_stats`` measures the fraction of
window wall where that actually happens (``pipeline_overlap_frac``)
and runs a bubble census over the compute gaps, naming the phase that
bounds the pipeline.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

#: canonical phase order along the device path.  Charging iterates in
#: this order and skips absent stamps (a CPU-twin group never stamps
#: h2d/d2h; its time folds into the next present phase, keeping the
#: per-group sum exact) — same rule as hops.charge().
PHASE_ORDER = (
    "stage_acquire",   # host staging slot acquired (ring fence wait)
    "h2d_start",       # host buffer filled, device_put issued
    "h2d_done",        # transfer complete (fenced sample) or dispatched
    "compute_start",   # kernel dispatched to the device queue
    "compute_done",    # compute fence: block_until_ready returned
    "d2h_done",        # result bytes materialised on the host
    "deliver",         # reshaped view handed back to the batcher
)

#: non-phase fields a ledger dict may carry alongside the stamps
META_FIELDS = frozenset(("device", "bytes", "stripes", "group"))

#: log-spaced histogram bounds (seconds): device phases live between
#: ~10 us (stamp-to-stamp on a warm pipeline) and seconds (h2d stalls)
PHASE_BOUNDS: List[float] = [
    10e-6, 25e-6, 50e-6, 100e-6, 250e-6, 500e-6,
    1e-3, 2.5e-3, 5e-3, 10e-3, 25e-3, 50e-3,
    100e-3, 250e-3, 500e-3, 1.0,
]


def charge_phases(ledger: Dict[str, float]):
    """-> list of (phase_name, interval_seconds) charging each
    interval to the phase that ends it; per-group sum is exact by
    construction (== last stamp - first stamp)."""
    prev = None
    out = []
    for name in PHASE_ORDER:
        t = ledger.get(name)
        if t is None:
            continue
        if prev is not None and t >= prev:
            out.append((name, t - prev))
        prev = t
    return out


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


def _first_stamp(led: Dict[str, float]) -> Optional[float]:
    for name in PHASE_ORDER:
        t = led.get(name)
        if t is not None:
            return t
    return None


def _last_stamp(led: Dict[str, float]) -> Optional[float]:
    for name in reversed(PHASE_ORDER):
        t = led.get(name)
        if t is not None:
            return t
    return None


def overlap_stats(recent: List[Dict[str, float]]) -> dict:
    """Pipeline overlap + bubble census over a window of group
    ledgers.

    Groups are bucketed per device and ordered by first stamp; for
    each consecutive pair the overlap is the interval where the newer
    group's h2d runs under the older group's compute::

        overlap = min(cur.h2d_done, prev.compute_done)
                - max(cur.h2d_start, prev.compute_start)

    ``pipeline_overlap_frac`` is total overlap over the per-device
    window wall (first stamp of the first group to last stamp of the
    last).  The bubble census walks each compute gap
    (prev.compute_done -> cur.compute_start) and charges it to the
    phase of the newer group that covers most of the gap — the phase
    that *bounds* the pipeline; ``bounding_phase`` names the worst.

    Host-executed groups (``device`` < 0 — the CPU twin) are excluded
    wholesale: they have no h2d to hide under compute, so counting
    their wall in the window would dilute the fraction on any box
    with mixed routing.
    """
    by_dev: Dict[int, List[Dict[str, float]]] = {}
    for led in recent:
        if _first_stamp(led) is None:
            continue
        dev = int(led.get("device", 0))
        if dev < 0:
            continue
        by_dev.setdefault(dev, []).append(led)
    overlap_s = 0.0
    window_wall_s = 0.0
    compute_s = 0.0
    bubbles: Dict[str, float] = {}
    groups = 0
    pairs = 0
    for leds in by_dev.values():
        leds.sort(key=_first_stamp)
        groups += len(leds)
        lo = _first_stamp(leds[0])
        hi = max(_last_stamp(led) for led in leds)
        window_wall_s += max(0.0, hi - lo)
        for led in leds:
            cs, cd = led.get("compute_start"), led.get("compute_done")
            if cs is not None and cd is not None:
                compute_s += max(0.0, cd - cs)
        for prev, cur in zip(leds, leds[1:]):
            pairs += 1
            try:
                overlap_s += max(
                    0.0,
                    min(cur["h2d_done"], prev["compute_done"])
                    - max(cur["h2d_start"], prev["compute_start"]))
            except KeyError:
                pass  # CPU-twin / partial ledger: no h2d to overlap
            pcd = prev.get("compute_done")
            ccs = cur.get("compute_start")
            if pcd is None or ccs is None or ccs <= pcd:
                continue
            # bubble: the device sat idle pcd..ccs.  Charge it to the
            # phase of `cur` covering most of the gap (the phase the
            # pipeline was waiting on).
            best, best_cover = "compute_start", 0.0
            prev_t = None
            for name in PHASE_ORDER:
                t = cur.get(name)
                if t is None:
                    continue
                if prev_t is not None:
                    cover = min(t, ccs) - max(prev_t, pcd)
                    if cover > best_cover:
                        best_cover, best = cover, name
                prev_t = t
            bubbles[best] = bubbles.get(best, 0.0) + (ccs - pcd)
    frac = overlap_s / window_wall_s if window_wall_s > 0 else 0.0
    bounding = (max(bubbles.items(), key=lambda kv: kv[1])[0]
                if bubbles else None)
    return {
        "groups": groups,
        "pairs": pairs,
        "devices": sorted(by_dev),
        "overlap_s": round(overlap_s, 6),
        "window_wall_s": round(window_wall_s, 6),
        "compute_s": round(compute_s, 6),
        "pipeline_overlap_frac": round(frac, 4),
        "bubble_s": {k: round(v, 6) for k, v in bubbles.items()},
        "bounding_phase": bounding,
    }


class DeviceLedgerAccum:
    """Per-phase interval accumulator (the device-side sibling of
    hops.HopAccum).

    Keeps histogram state locally so bench-side observers need no
    perf-counter plumbing; given a ``perf_coll`` it registers the
    ``ec_device_ledger`` subsystem (one histogram + time-avg per
    phase, plus a group counter) so phases surface in ``perf dump``
    and prometheus.  The bounded ``_recent`` ring of raw ledgers
    feeds both the trace exporter's device lanes and the overlap
    engine.
    """

    RECENT_LEDGERS = 256

    def __init__(self, perf_coll=None, subsystem: str = "ec_device_ledger"):
        self._lock = threading.Lock()
        self.groups = 0
        self.group_seconds = 0.0
        self.phase_seconds: Dict[str, float] = {}
        self.phase_counts: Dict[str, int] = {}
        self._buckets: Dict[str, List[int]] = {}
        self._recent: deque = deque(maxlen=self.RECENT_LEDGERS)
        self.dlperf = None
        if perf_coll is not None:
            dp = perf_coll.create(subsystem)
            # two daemons may share a collection (tests); register once
            if "groups" not in dp._types:
                dp.add("groups",
                       description="ledger-bearing device groups observed")
                for name in PHASE_ORDER:
                    dp.add_time_avg(
                        f"{name}_s",
                        description=f"time charged to device phase {name}")
                    dp.add_histogram(
                        f"{name}_hist_s", PHASE_BOUNDS,
                        description=f"per-group {name} interval histogram")
            self.dlperf = dp

    def observe(self, ledger: Optional[Dict[str, float]]) -> None:
        """Fold one completed group's ledger in.  Tolerates None /
        partial ledgers (CPU-twin groups, error paths)."""
        if not ledger:
            return
        charged = charge_phases(ledger)
        if not charged:
            return
        bisect = _bisect
        with self._lock:
            self.groups += 1
            self._recent.append(dict(ledger))
            phase_seconds, phase_counts = self.phase_seconds, self.phase_counts
            buckets = self._buckets
            for name, dt in charged:
                self.group_seconds += dt
                phase_seconds[name] = phase_seconds.get(name, 0.0) + dt
                phase_counts[name] = phase_counts.get(name, 0) + 1
                b = buckets.get(name)
                if b is None:
                    b = buckets[name] = [0] * (len(PHASE_BOUNDS) + 1)
                b[bisect(PHASE_BOUNDS, dt)] += 1
        dp = self.dlperf
        if dp is not None:
            dp.inc("groups")
            dp.inc_many((f"{name}_s", dt) for name, dt in charged)
            for name, dt in charged:
                dp.hinc(f"{name}_hist_s", dt)

    def dump(self) -> dict:
        with self._lock:
            buckets = {k: list(v) for k, v in self._buckets.items()}
            recent = [dict(h) for h in self._recent]
            out = {
                "groups": self.groups,
                "group_seconds": self.group_seconds,
                "phase_seconds": dict(self.phase_seconds),
                "phase_counts": dict(self.phase_counts),
                "bounds": list(PHASE_BOUNDS),
                "buckets": buckets,
            }
        out["p50_s"] = {k: _percentile(PHASE_BOUNDS, v, 0.50)
                        for k, v in buckets.items()}
        out["p99_s"] = {k: _percentile(PHASE_BOUNDS, v, 0.99)
                        for k, v in buckets.items()}
        out["overlap"] = overlap_stats(recent)
        return out

    def recent(self) -> List[Dict[str, float]]:
        """Raw ledgers of the most recent observed groups (bounded
        ring), for the trace exporter's per-device phase lanes."""
        with self._lock:
            return [dict(h) for h in self._recent]


def merge_dumps(dumps: List[dict]) -> dict:
    """Merge DeviceLedgerAccum.dump()s from several daemons into one
    cluster-wide view; overlap blocks sum and the fraction is
    recomputed over the pooled window wall."""
    out = {"groups": 0, "group_seconds": 0.0, "phase_seconds": {},
           "phase_counts": {}, "bounds": list(PHASE_BOUNDS),
           "buckets": {}}
    ov = {"groups": 0, "pairs": 0, "overlap_s": 0.0,
          "window_wall_s": 0.0, "compute_s": 0.0, "bubble_s": {}}
    devices = set()
    for dump in dumps:
        if not dump:
            continue
        out["groups"] += dump.get("groups", 0)
        out["group_seconds"] += dump.get("group_seconds", 0.0)
        for k, v in dump.get("phase_seconds", {}).items():
            out["phase_seconds"][k] = out["phase_seconds"].get(k, 0.0) + v
        for k, v in dump.get("phase_counts", {}).items():
            out["phase_counts"][k] = out["phase_counts"].get(k, 0) + v
        for k, b in dump.get("buckets", {}).items():
            acc = out["buckets"].setdefault(
                k, [0] * (len(PHASE_BOUNDS) + 1))
            for i, c in enumerate(b):
                acc[i] += c
        o = dump.get("overlap") or {}
        for k in ("groups", "pairs"):
            ov[k] += o.get(k, 0)
        for k in ("overlap_s", "window_wall_s", "compute_s"):
            ov[k] += o.get(k, 0.0)
        for k, v in (o.get("bubble_s") or {}).items():
            ov["bubble_s"][k] = ov["bubble_s"].get(k, 0.0) + v
        devices.update(o.get("devices") or ())
    out["p50_s"] = {k: _percentile(PHASE_BOUNDS, v, 0.50)
                    for k, v in out["buckets"].items()}
    out["p99_s"] = {k: _percentile(PHASE_BOUNDS, v, 0.99)
                    for k, v in out["buckets"].items()}
    ov["devices"] = sorted(devices)
    ov["pipeline_overlap_frac"] = round(
        ov["overlap_s"] / ov["window_wall_s"]
        if ov["window_wall_s"] > 0 else 0.0, 4)
    ov["bounding_phase"] = (
        max(ov["bubble_s"].items(), key=lambda kv: kv[1])[0]
        if ov["bubble_s"] else None)
    ov["bubble_s"] = {k: round(v, 6) for k, v in ov["bubble_s"].items()}
    out["overlap"] = ov
    return out


def device_waterfall_block(dump: dict, wall_s: float,
                           mesh: Optional[dict] = None,
                           recent: Optional[List[dict]] = None) -> dict:
    """Shape a device-ledger dump into bench.py's attribution
    ``device_waterfall`` block: phase shares of batcher device time
    (sum to 1.0), those shares scaled onto the measured device wall,
    per-phase p50/p99, the named top phase, and the overlap engine's
    verdict — mirroring hops.waterfall_block.

    ``mesh`` (a backend ``mesh_info()`` dict — dp, sp, n_devices,
    device_ids) folds a ``mesh`` sub-block in, with per-device group
    counts censused from ``recent`` raw ledgers when supplied, so one
    block answers both "what shape ran" and "did every chip pull its
    weight"."""
    phase_seconds = dump.get("phase_seconds", {})
    total = sum(phase_seconds.values())
    shares = {k: (v / total if total > 0 else 0.0)
              for k, v in phase_seconds.items()}
    scaled = {k: wall_s * s for k, s in shares.items()}
    top = max(shares.items(), key=lambda kv: kv[1])[0] if shares else None
    overlap = dump.get("overlap") or {}
    mesh_block = None
    if mesh:
        counts: Dict[int, int] = {}
        for led in (recent or ()):
            dev = int(led.get("device", -1))
            if dev >= 0:
                counts[dev] = counts.get(dev, 0) + 1
        mesh_block = {
            "dp": mesh.get("dp"),
            "sp": mesh.get("sp"),
            "n_devices": mesh.get("n_devices"),
            "device_groups": {str(d): counts[d]
                              for d in sorted(counts)},
        }
    return {
        "groups": dump.get("groups", 0),
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
        "pipeline_overlap_frac":
            overlap.get("pipeline_overlap_frac", 0.0),
        "bounding_phase": overlap.get("bounding_phase"),
        "bubble_s": overlap.get("bubble_s", {}),
        "devices": overlap.get("devices", []),
        "mesh": mesh_block,
    }
