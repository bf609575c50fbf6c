"""Cluster health checks: a ``ceph -s``-style one-look summary.

Aggregates signals every prior observability PR already exports —
device circuit breaker, SLO error-budget burn, optracker slow/blocked
ops, osdmap liveness, PG degradation — into NAMED checks with ok /
warn / error severity (reference mon/health_check.h: named checks with
severity, summary and detail).  Each daemon evaluates its local view
(``dump_health`` admin command); ``merge`` folds per-daemon views into
the cluster verdict bench.py prints in its attribution record.
"""
from __future__ import annotations

from typing import Dict, List, Optional

SEVERITIES = ("ok", "warn", "error")

#: burn >= 1.0 means the class consumes its error budget exactly as
#: fast as allowed; sustained >1 is a page (SRE workbook convention)
BURN_WARN = 1.0
BURN_ERROR = 10.0


def _worse(a: str, b: str) -> str:
    return a if SEVERITIES.index(a) >= SEVERITIES.index(b) else b


def _check(severity: str, detail: str, **fields) -> dict:
    out = {"severity": severity, "detail": detail}
    out.update(fields)
    return out


def checks_from_signals(*, breaker_open: bool = False,
                        slo: Optional[dict] = None,
                        slow_ops: int = 0, blocked_ops: int = 0,
                        down_osds: Optional[List[int]] = None,
                        degraded_pgs: int = 0,
                        total_pgs: int = 0,
                        op_queue: Optional[dict] = None,
                        store: Optional[dict] = None
                        ) -> Dict[str, dict]:
    """Evaluate one daemon's (or the merged cluster's) raw signals
    into the named-check dict.  Every check is always present —
    ``ok`` entries included — so dashboards key on a stable set."""
    checks: Dict[str, dict] = {}

    checks["EC_BREAKER_OPEN"] = _check(
        "error" if breaker_open else "ok",
        "device circuit breaker open; encode routed to CPU twin"
        if breaker_open else "device breaker closed",
        open=bool(breaker_open))

    worst_cls, worst_burn = None, 0.0
    for cls, d in (slo or {}).items():
        try:
            burn = float(d.get("burn", 0.0))
        except (AttributeError, TypeError, ValueError):
            continue
        if burn > worst_burn:
            worst_cls, worst_burn = cls, burn
    sev = "ok"
    if worst_burn >= BURN_ERROR:
        sev = "error"
    elif worst_burn >= BURN_WARN:
        sev = "warn"
    checks["SLO_BURN"] = _check(
        sev,
        f"{worst_cls} class burning error budget at "
        f"{worst_burn:.2f}x" if sev != "ok"
        else "all op classes within error budget",
        burn=round(worst_burn, 4), **({"class": worst_cls}
                                      if worst_cls else {}))

    sev = "ok"
    if blocked_ops > 0:
        sev = "error"
    elif slow_ops > 0:
        sev = "warn"
    checks["SLOW_OPS"] = _check(
        sev,
        f"{slow_ops} slow ops, {blocked_ops} blocked ops"
        if sev != "ok" else "no slow or blocked ops",
        slow=int(slow_ops), blocked=int(blocked_ops))

    down = sorted(down_osds or [])
    checks["OSD_DOWN"] = _check(
        "error" if down else "ok",
        f"osds {down} down" if down else "all osds up",
        down=down)

    checks["PG_DEGRADED"] = _check(
        "warn" if degraded_pgs else "ok",
        f"{degraded_pgs}/{total_pgs} pgs not active+clean"
        if degraded_pgs else
        f"all {total_pgs} pgs active+clean",
        degraded=int(degraded_pgs), total=int(total_pgs))

    # sustained client-class op-queue growth: the mClock scheduler is
    # admitting client work faster than the shards retire it — a transient spike is normal, 3+ consecutive growth ticks
    # while depth is nonzero is saturation
    oq = op_queue or {}
    growth = int(oq.get("client_growth_ticks", 0))
    depth = int(oq.get("client_queued", 0))
    sev = "warn" if growth >= 3 and depth > 0 else "ok"
    checks["OP_QUEUE_BACKLOG"] = _check(
        sev,
        f"client op queue growing {growth} consecutive ticks "
        f"({depth} ops queued)" if sev != "ok"
        else "op queues draining",
        queued=depth, growth_ticks=growth)

    # store-phase stalls: one journal-fsync/kv-commit/
    # data-write interval at or over store_phase_stall_ms already
    # flight-recorded a store_stall event; here the count becomes a
    # standing named check so `ceph -s` names a wedged local store
    st = store or {}
    stalls = int(st.get("stalls", 0))
    checks["STORE_SLOW"] = _check(
        "warn" if stalls else "ok",
        f"{stalls} store transaction phase(s) exceeded the stall "
        f"threshold" if stalls
        else "store transactions within the stall threshold",
        stalls=stalls, txns=int(st.get("txns", 0)))

    return checks


def summarize(checks: Dict[str, dict]) -> dict:
    """Overall status + the one-look health line."""
    worst = "ok"
    firing = []
    for name in sorted(checks):
        sev = checks[name].get("severity", "ok")
        worst = _worse(worst, sev)
        if sev != "ok":
            firing.append(f"{name}({sev})")
    status = {"ok": "HEALTH_OK", "warn": "HEALTH_WARN",
              "error": "HEALTH_ERR"}[worst]
    line = status if not firing else f"{status} {' '.join(firing)}"
    return {"status": status, "severity": worst, "line": line,
            "checks": checks}


def merge(dumps: List[Optional[dict]]) -> dict:
    """Fold per-daemon ``dump_health`` outputs into the cluster
    verdict: per-check worst severity wins, numeric fields sum or
    union, the first non-ok detail is kept (with the daemon count
    firing it)."""
    merged: Dict[str, dict] = {}
    firing_count: Dict[str, int] = {}
    for dump in dumps:
        if not dump:
            continue
        for name, c in (dump.get("checks") or {}).items():
            if not isinstance(c, dict):
                continue
            sev = c.get("severity", "ok")
            cur = merged.get(name)
            if cur is None:
                merged[name] = dict(c)
            else:
                if SEVERITIES.index(sev) > \
                        SEVERITIES.index(cur.get("severity", "ok")):
                    cur["severity"] = sev
                    cur["detail"] = c.get("detail", cur.get("detail"))
                for k, v in c.items():
                    if k in ("severity", "detail"):
                        continue
                    old = cur.get(k)
                    if isinstance(v, (int, float)) and \
                            isinstance(old, (int, float)) and \
                            not isinstance(v, bool):
                        cur[k] = old + v
                    elif isinstance(v, list) and isinstance(old, list):
                        cur[k] = sorted(set(old) | set(v))
                    elif isinstance(v, bool):
                        cur[k] = bool(old) or v
            if sev != "ok":
                firing_count[name] = firing_count.get(name, 0) + 1
    for name, n in firing_count.items():
        merged[name]["daemons_firing"] = n
    return summarize(merged)
