"""Per-op-class SLO engine: rolling latency + error-budget burn.

The SLO enforcement substrate.  Every daemon that retires
work feeds one of four op classes — ``client_read`` / ``client_write``
(OpTracker retirement, osd.py chains ``observe_op`` after the
critical-path accumulator), ``recovery`` (PG._on_recovered per
recovered object, plus decode device-fault fallbacks via the
batcher's ``on_decode_fault`` hook), ``scrub`` (Scrubber._finish per
round).  Targets are declarative conf (``slo_client_write_p99_ms``
etc., utils/config.py); an op slower than its class target, or one
that errored, is "bad", and

    burn = (bad_fraction) / slo_error_budget

so burn 1.0 means the class is consuming its budget exactly as fast
as allowed, 0.0 means a clean run (what fault-free bench/chaos_soak
assert), and anything >1.0 is an SLO violation in progress.  The
"slo" perf subsystem exports per-class ops/breaches/errors counters,
a latency histogram, and a ``{cls}_burn_now`` permille gauge — the
``_now`` suffix is what mgr/modules/prometheus.py types as a gauge —
and ``dump_slo`` on the admin socket returns :meth:`dump`.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

# latency histogram bounds (milliseconds)
_MS_BOUNDS = [1, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000,
              15000, 60000]


class SLOEngine:
    CLASSES = ("client_read", "client_write", "recovery", "scrub")

    def __init__(self, conf=None, perf_coll=None,
                 targets_ms: Optional[Dict[str, float]] = None,
                 budget: Optional[float] = None):
        def _get(key: str, default: float) -> float:
            if conf is None:
                return default
            try:
                return float(conf[key])
            except Exception:
                return default
        t = {
            "client_read": _get("slo_client_read_p99_ms", 30000.0),
            "client_write": _get("slo_client_write_p99_ms", 30000.0),
            "recovery": _get("slo_recovery_p99_ms", 60000.0),
            "scrub": _get("slo_scrub_p99_ms", 120000.0),
        }
        if targets_ms:
            t.update(targets_ms)
        self.targets_s = {c: v / 1000.0 for c, v in t.items()}
        self.budget = budget if budget is not None else \
            max(1e-6, _get("slo_error_budget", 0.001))
        self._lock = threading.Lock()
        self._ops = {c: 0 for c in self.CLASSES}       # latency-observed
        self._breaches = {c: 0 for c in self.CLASSES}  # over target
        self._errors = {c: 0 for c in self.CLASSES}    # failed outright
        self._note_errors = {c: 0 for c in self.CLASSES}  # no-op errors
        self.perf = None
        if perf_coll is not None:
            sp = perf_coll.create("slo")
            if "client_read_ops" not in sp._types:
                from ..utils.perf import TYPE_U64
                for c in self.CLASSES:
                    sp.add(f"{c}_ops",
                           description=f"{c}-class ops observed")
                    sp.add(f"{c}_breaches",
                           description=f"{c}-class ops over the "
                                       "latency target")
                    sp.add(f"{c}_errors",
                           description=f"{c}-class ops that errored")
                    sp.add(f"{c}_burn_now", TYPE_U64,
                           f"{c}-class error-budget burn rate, "
                           "permille (1000 = burning the budget "
                           "exactly)")
                    sp.add_histogram(
                        f"{c}_lat_ms", list(_MS_BOUNDS),
                        f"{c}-class op latency (ms)")
            self.perf = sp

    # -- feeds ---------------------------------------------------------
    def observe(self, cls: str, seconds: float, ok: bool = True) -> None:
        """One completed op of ``cls`` that took ``seconds``.  Called
        from retirement paths — must not raise."""
        try:
            if cls not in self._ops:
                return
            target = self.targets_s.get(cls, 0.0)
            breach = ok and target > 0 and seconds > target
            with self._lock:
                self._ops[cls] += 1
                if breach:
                    self._breaches[cls] += 1
                if not ok:
                    self._errors[cls] += 1
                burn = self._burn_locked(cls)
            p = self.perf
            if p is not None:
                p.inc(f"{cls}_ops")
                if breach:
                    p.inc(f"{cls}_breaches")
                if not ok:
                    p.inc(f"{cls}_errors")
                p.hinc(f"{cls}_lat_ms", seconds * 1000.0)
                p.set(f"{cls}_burn_now", int(round(burn * 1000)))
        except Exception:
            pass

    def note_error(self, cls: str) -> None:
        """One error with no latency sample attached (e.g. a decode
        device fault that fell back to the CPU twin).  Must not
        raise."""
        try:
            if cls not in self._ops:
                return
            with self._lock:
                self._errors[cls] += 1
                self._note_errors[cls] += 1
                burn = self._burn_locked(cls)
            p = self.perf
            if p is not None:
                p.inc(f"{cls}_errors")
                p.set(f"{cls}_burn_now", int(round(burn * 1000)))
        except Exception:
            pass

    def observe_op(self, op) -> None:
        """OpTracker.on_retire hook: ops the OSD tagged with a
        ``slo_class`` at enqueue feed their class; untagged ops
        (sub-ops, commands) pass through silently.  Must not raise."""
        cls = getattr(op, "slo_class", None)
        if cls is None:
            return
        self.observe(cls, op.duration, ok=getattr(op, "slo_ok", True))

    # -- queries -------------------------------------------------------
    def _burn_locked(self, cls: str) -> float:
        total = self._ops[cls] + self._note_errors[cls]
        if total <= 0:
            return 0.0
        bad = self._breaches[cls] + self._errors[cls]
        return (bad / total) / self.budget

    def burn(self, cls: str) -> float:
        with self._lock:
            return self._burn_locked(cls)

    def dump(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            # "ops" counts latency-observed ops PLUS note_error-only
            # samples so the burn denominator survives merge_dumps
            return {c: {
                "ops": self._ops[c] + self._note_errors[c],
                "breaches": self._breaches[c],
                "errors": self._errors[c],
                "target_ms": self.targets_s[c] * 1000.0,
                "budget": self.budget,
                "burn": self._burn_locked(c),
            } for c in self.CLASSES}

    # -- cluster view --------------------------------------------------
    @staticmethod
    def merge_dumps(dumps: List[Dict]) -> Dict[str, Dict[str, float]]:
        """Fold per-daemon :meth:`dump` blocks into one cluster block
        (bench.py merges every OSD's view): counters sum, burn is
        recomputed over the merged counts."""
        out: Dict[str, Dict[str, float]] = {}
        for d in dumps:
            if not d:
                continue
            for c, row in d.items():
                o = out.setdefault(c, {"ops": 0, "breaches": 0,
                                       "errors": 0, "target_ms": 0.0,
                                       "budget": 0.0, "burn": 0.0})
                o["ops"] += row.get("ops", 0)
                o["breaches"] += row.get("breaches", 0)
                o["errors"] += row.get("errors", 0)
                o["target_ms"] = max(o["target_ms"],
                                     row.get("target_ms", 0.0))
                o["budget"] = max(o["budget"], row.get("budget", 0.0))
        for c, o in out.items():
            bad = o["breaches"] + o["errors"]
            if o["ops"] > 0 and o["budget"] > 0:
                o["burn"] = (bad / o["ops"]) / o["budget"]
            elif bad and o["budget"] > 0:
                # bad events with no countable ops: worst case
                o["burn"] = (bad / max(1, bad)) / o["budget"]
        return out
