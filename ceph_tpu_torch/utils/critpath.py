"""Per-op critical-path analysis over OpTracker event timelines.

The op tracker gives every client write a stage timeline (``TrackedOp.events``:
``initiated -> queued_for_pg -> reached_pg -> started_write ->
ec:encode_queued -> ec:batch_dispatched -> ec:encoded ->
ec:sub_write_sent -> ec:all_shards_committed -> op_commit -> done``)
and a cross-daemon span tree.  What it does NOT give is the answer a
throughput regression needs: *which stage bounded each op, and where does
the cluster's write time actually go?*  The timelines sat in
``dump_historic_ops`` as raw timestamps; attribution was done by hand.

This module closes that loop:

- :func:`analyze` turns one op's event timeline into a per-stage time
  breakdown — each interval between consecutive events is charged to
  the stage the *ending* event names, so repeated events (segmented
  fanout marks ``ec:sub_write_sent`` per segment) accumulate naturally
  and the stage seconds sum exactly to the op's duration.
- :class:`CriticalPathAccum` aggregates those breakdowns across every
  retired op into a cluster-wide per-stage time budget plus a
  *bounding-stage* census (for each op, the stage that dominated it),
  keeps the slowest op's full breakdown for triage, and exports the
  totals as a ``critpath`` perf subsystem so the admin socket's
  ``perf dump`` and the mgr prometheus scrape carry them with zero
  extra plumbing.

The OSD wires an accumulator to ``OpTracker.on_retire`` so analysis
happens once per completed op (off the client latency path — retire
runs after the reply), and serves the aggregate through the
``dump_critical_path`` admin-socket command.  ``bench.py`` merges
every primary's dump into the ``critical_path`` block of the k8m4
attribution JSON that ``tools/perf_trend.py`` gates on.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional

# interval-ending event -> stage charged with that interval.  The
# vocabulary mirrors the write pipeline's mark_event sites (osd.py,
# pg.py, batcher.py, ecbackend.py); events outside it fall into
# "other" so the breakdown still sums to the op duration.
EVENT_STAGE: Dict[str, str] = {
    "queued_for_pg": "msg_recv",          # messenger recv + decode
    "reached_pg": "pg_queue_wait",        # sharded op-queue wait
    "started_write": "pg_dispatch",       # PG lock + op admission
    "ec:rmw_read": "rmw_read",            # partial-stripe read leg
    "ec:encode_queued": "prepare",        # striping + txn assembly
    "ec:batch_dispatched": "batcher_queue",  # coalescing window wait
    "ec:encoded": "encode",               # h2d + MXU + d2h (device)
                                          # or twin encode (cpu)
    "ec:sub_write_sent": "fanout_send",   # sub-write marshal + send
    "ec:all_shards_committed": "commit_wait",  # slowest-shard ack
    "op_commit": "commit",                # commit bookkeeping
    "done": "reply",                      # reply marshal + retire
}

# canonical display order (dumps stay readable; unknown stages append)
STAGE_ORDER: List[str] = [
    "msg_recv", "pg_queue_wait", "pg_dispatch", "rmw_read",
    "prepare", "batcher_queue", "encode", "fanout_send",
    "commit_wait", "commit", "reply", "blocked", "other",
]


def stage_of(event: str) -> str:
    s = EVENT_STAGE.get(event)
    if s is not None:
        return s
    if event.startswith("waiting"):
        return "blocked"              # parked on scrub/degraded/pipeline
    return "other"


def analyze(events) -> Dict:
    """One op's event timeline -> per-stage seconds.  Accepts both
    TrackedOp.events tuples and dump()-shaped dicts.

    Returns ``{"stages": {stage: seconds}, "total": seconds,
    "bounding_stage": stage}`` where ``bounding_stage`` is the stage
    that consumed the most time (the op's critical-path verdict).
    Stage seconds sum exactly to last-event minus first-event.
    """
    stages: Dict[str, float] = {}
    prev_t: Optional[float] = None
    first_t: Optional[float] = None
    last_t: Optional[float] = None
    get_stage = EVENT_STAGE.get          # bound once: hot path
    for e in events:
        if type(e) is dict:
            t, name = e["time"], e["event"]
        else:
            t, name = e[0], e[1]
        if prev_t is not None:
            dt = t - prev_t
            if dt > 0:
                s = get_stage(name)
                if s is None:
                    s = "blocked" if name.startswith("waiting") \
                        else "other"
                stages[s] = stages.get(s, 0.0) + dt
        else:
            first_t = t
        prev_t = last_t = t
    total = (last_t - first_t) if first_t is not None \
        and last_t is not None else 0.0
    bounding = max(stages, key=stages.get) if stages else None
    return {"stages": stages, "total": total,
            "bounding_stage": bounding}


class CriticalPathAccum:
    """Cluster-facing aggregate of per-op critical paths.

    ``observe()`` is called once per retired op (OpTracker.on_retire);
    the work is one ``analyze()`` pass plus a few dict updates under a
    small lock — micro-benched alongside the other always-on
    instrumentation in tests/test_perf_guard.py.
    """

    def __init__(self, perf_coll=None, slow_keep: int = 1):
        self._lock = threading.Lock()
        self.ops = 0
        self.stage_seconds: Dict[str, float] = {}
        self.bounding_ops: Dict[str, int] = {}
        self.total_seconds = 0.0
        self._slowest: Optional[Dict] = None
        self.cperf = None
        # counter names prebuilt once: observe() runs per retired op
        self._stage_keys = {s: f"stage_{s}" for s in STAGE_ORDER}
        self._bound_keys = {s: f"bound_{s}" for s in STAGE_ORDER}
        if perf_coll is not None:
            cp = perf_coll.create("critpath")
            if "ops" not in cp._types:
                cp.add("ops", description="ops analyzed for "
                       "critical path")
                for s in STAGE_ORDER:
                    cp.add_time_avg(
                        f"stage_{s}",
                        f"op-seconds charged to the {s} stage")
                    cp.add(f"bound_{s}",
                           description=f"ops bounded by {s}")
            self.cperf = cp

    # -- per-op ingest ------------------------------------------------
    def observe(self, op) -> None:
        """``op`` is a TrackedOp (has .events) or an op dump dict."""
        events = op.events if hasattr(op, "events") \
            else op.get("events", ())
        if len(events) < 2:
            return
        res = analyze(events)
        desc = getattr(op, "description", None) or (
            op.get("description") if isinstance(op, dict) else None)
        with self._lock:
            self.ops += 1
            self.total_seconds += res["total"]
            for s, v in res["stages"].items():
                self.stage_seconds[s] = \
                    self.stage_seconds.get(s, 0.0) + v
            b = res["bounding_stage"]
            if b is not None:
                self.bounding_ops[b] = self.bounding_ops.get(b, 0) + 1
            if self._slowest is None or \
                    res["total"] > self._slowest["total"]:
                self._slowest = {"total": res["total"],
                                 "description": desc,
                                 "stages": dict(res["stages"]),
                                 "bounding_stage": b}
        cp = self.cperf
        if cp is not None:
            skeys = self._stage_keys
            updates = [("ops", 1)]
            for s, v in res["stages"].items():
                k = skeys.get(s)
                if k is not None:
                    updates.append((k, v))
            bk = self._bound_keys.get(b) if b is not None else None
            if bk is not None:
                updates.append((bk, 1))
            cp.inc_many(updates)

    # -- export -------------------------------------------------------
    def dump(self) -> Dict:
        with self._lock:
            order = [s for s in STAGE_ORDER
                     if s in self.stage_seconds] + \
                    [s for s in self.stage_seconds
                     if s not in STAGE_ORDER]
            return {
                "ops": self.ops,
                "op_seconds_total": round(self.total_seconds, 6),
                "stage_seconds": {s: round(self.stage_seconds[s], 6)
                                  for s in order},
                "bounding_ops": dict(self.bounding_ops),
                "slowest_op": dict(self._slowest)
                if self._slowest else None,
            }


def merge_dumps(dumps: Iterable[Dict]) -> Dict:
    """Sum several accumulators' dumps (bench: one per primary) into
    one cluster-wide budget."""
    out = {"ops": 0, "op_seconds_total": 0.0, "stage_seconds": {},
           "bounding_ops": {}, "slowest_op": None}
    for d in dumps:
        if not d:
            continue
        out["ops"] += d.get("ops", 0)
        out["op_seconds_total"] += d.get("op_seconds_total", 0.0)
        for s, v in (d.get("stage_seconds") or {}).items():
            out["stage_seconds"][s] = \
                out["stage_seconds"].get(s, 0.0) + v
        for s, n in (d.get("bounding_ops") or {}).items():
            out["bounding_ops"][s] = \
                out["bounding_ops"].get(s, 0) + n
        so = d.get("slowest_op")
        if so and (out["slowest_op"] is None or
                   so["total"] > out["slowest_op"]["total"]):
            out["slowest_op"] = so
    out["op_seconds_total"] = round(out["op_seconds_total"], 6)
    out["stage_seconds"] = {
        s: round(v, 6) for s, v in sorted(
            out["stage_seconds"].items(),
            key=lambda kv: STAGE_ORDER.index(kv[0])
            if kv[0] in STAGE_ORDER else len(STAGE_ORDER))}
    return out
