"""Manager daemon: telemetry aggregation + operator modules.

Python-native equivalent of the reference's ceph-mgr (reference
src/mgr/ 16.1k LoC C++ + src/pybind/mgr/ python modules):

* **perf aggregation** (reference DaemonPerfCounters / MMgrReport):
  the reference has daemons push counter deltas to the mgr; here the
  mgr PULLS — every ``mgr_tick_interval`` it sends ``MCommand("perf
  dump")`` to each up OSD (discovered from the osdmap) and keeps the
  latest snapshot per daemon.  Pull avoids needing a MgrMap for
  daemon->mgr discovery while producing the same aggregate.
* **prometheus exporter** (reference src/pybind/mgr/prometheus/):
  an HTTP endpoint serving the aggregated counters plus cluster
  health/PG-state gauges in the Prometheus text exposition format.
* **balancer-lite** (reference src/pybind/mgr/balancer/): reports
  per-OSD PG-count spread and which moves would flatten it.
* **pg_autoscaler-lite** (reference src/pybind/mgr/pg_autoscaler/):
  recommends pg_num per pool from the OSD count and replication
  factor (the reference's target ~100 PGs/OSD heuristic).

Both advisory modules only *recommend* (the reference's default
"warn" mode); applying is the operator's call via the CLI.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from ..mon.client import MonClient
from ..msg.messages import MCommand, MCommandReply
from ..msg.messenger import Connection, Dispatcher, Messenger
from ..osd.osdmap import OSDMap
from ..utils.config import Config, default_config
from ..utils.log import Dout


def pg_autoscale_recommendations(osdmap: OSDMap,
                                 target_per_osd: int = 100
                                 ) -> List[dict]:
    """Per-pool pg_num advice (reference pg_autoscaler's
    target ratio heuristic: ~target_per_osd PGs per OSD divided
    across pools, rounded to a power of two)."""
    n_osds = max(1, sum(1 for i in osdmap.osds.values()
                        if i.weight > 0))
    pools = list(osdmap.pools.values())
    if not pools:
        return []
    budget = n_osds * target_per_osd
    out = []
    for pool in pools:
        # pool.size is replica count (replicated) or k+m (EC): either
        # way the number of PG instances one logical PG creates
        share = budget // (len(pools) * max(1, pool.size))
        target = 1
        while target * 2 <= max(1, share):
            target *= 2
        out.append({
            "pool": pool.name, "pool_id": pool.pool_id,
            "pg_num": pool.pg_num, "target_pg_num": target,
            "would_adjust": target != pool.pg_num,
        })
    return out


def balancer_report(osdmap: OSDMap) -> dict:
    """PG spread per OSD + naive flattening advice (reference
    balancer module's upmap scoring)."""
    counts: Dict[int, int] = {o: 0 for o in osdmap.osds}
    for pool in osdmap.pools.values():
        for pgid in osdmap.pgs_for_pool(pool.pool_id):
            up, _, _, _ = osdmap.pg_to_up_acting_osds(pgid)
            for o in up:
                if o is not None:
                    counts[o] = counts.get(o, 0) + 1
    if not counts:
        return {"per_osd": {}, "spread": 0, "moves": []}
    mean = sum(counts.values()) / len(counts)
    overloaded = sorted((o for o in counts if counts[o] > mean + 1),
                        key=lambda o: -counts[o])
    underloaded = sorted((o for o in counts if counts[o] < mean - 1),
                         key=lambda o: counts[o])
    moves = [{"from": a, "to": b}
             for a, b in zip(overloaded, underloaded)]
    return {
        "per_osd": {str(o): c for o, c in sorted(counts.items())},
        "spread": max(counts.values()) - min(counts.values()),
        "mean": round(mean, 2),
        "moves": moves,
    }


class Manager(Dispatcher):
    """The mgr daemon (reference src/mgr/DaemonServer + Mgr)."""

    def __init__(self, mon_addr, conf: Optional[Config] = None,
                 http_port: int = 0):
        self.conf = conf or default_config()
        self.log = Dout("mgr", "mgr ")
        self.lock = threading.RLock()
        import secrets
        self.msgr = Messenger(f"mgr.{secrets.randbits(32):x}",
                              conf=self.conf)
        self.msgr.add_dispatcher(self)
        self.monc = MonClient(self.msgr, mon_addr,
                              map_cb=self._on_map)
        self.osdmap = OSDMap()
        # daemon name -> {"ts": float, "perf": {...}}
        self.daemon_perf: Dict[str, dict] = {}
        self._next_tid = 0
        self._pending: Dict[int, Tuple[str, float]] = {}  # tid -> (name, ts)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._http: Optional[ThreadingHTTPServer] = None
        self._http_port = http_port
        self.http_addr: Optional[Tuple[str, int]] = None
        # module host (reference PyModuleRegistry): modules are
        # enabled/disabled at runtime via mgr_enabled_modules, which
        # `ceph mgr module enable/disable` edits through the
        # monitor's central config so every mgr converges
        from .modules import ModuleHost
        self.modules = ModuleHost(self)
        self._health_cache: dict = {}

    # ------------------------------------------------------------------
    def start(self) -> "Manager":
        self.msgr.start()
        self.monc.subscribe_osdmap()
        self.modules.reconcile(
            self.conf["mgr_enabled_modules"].split())
        t = threading.Thread(target=self._collect_loop,
                             name="mgr-collect", daemon=True)
        t.start()
        self._threads.append(t)
        self._start_http()
        self.log.dout(1, f"mgr up, metrics at {self.http_addr}, "
                      f"modules {sorted(self.modules.active)}")
        return self

    def shutdown(self) -> None:
        self._stop.set()
        self.modules.shutdown()
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
        self.msgr.shutdown()
        for t in self._threads:
            t.join(timeout=5)

    def _on_map(self, wire: dict) -> None:
        newmap = OSDMap.from_wire_dict(wire)
        with self.lock:
            if newmap.epoch <= self.osdmap.epoch:
                return
            self.osdmap = newmap
        # central-config overrides ride the map (same contract as the
        # OSD): this is how `ceph mgr module enable/disable` reaches
        # every mgr — the edited mgr_enabled_modules lands here and
        # the next reconcile applies it
        from ..utils.config import apply_cluster_config_overrides
        self._applied_overrides = apply_cluster_config_overrides(
            self.conf, newmap.cluster_config,
            getattr(self, "_applied_overrides", {}))
        try:
            self.modules.reconcile(
                self.conf["mgr_enabled_modules"].split())
            self.modules.notify_all("osd_map")
        except Exception as e:
            self.log.dout(1, f"module reconcile on map failed: {e!r}")

    # ------------------------------------------------------------------
    # collection (reference MMgrReport flow, inverted to pull)
    # ------------------------------------------------------------------
    def ms_dispatch(self, conn: Connection, msg) -> bool:
        if isinstance(msg, MCommandReply):
            with self.lock:
                entry = self._pending.pop(msg.tid, None)
                if entry is not None and msg.retcode == 0:
                    name, req_ts = entry
                    cur = self.daemon_perf.get(name)
                    # a straggler reply for an old request must not
                    # roll counters backwards over a fresher sample
                    if cur is None or req_ts >= cur["req_ts"]:
                        self.daemon_perf[name] = {
                            "ts": time.time(), "req_ts": req_ts,
                            "perf": msg.out}
            return True
        return False

    def _collect_loop(self) -> None:
        interval = self.conf["mgr_tick_interval"]
        while not self._stop.wait(interval):
            try:
                self._collect_once()
            except Exception as e:
                self.log.dout(5, f"collect failed: {e!r}")
            try:
                # modules follow the central-config enabled set (the
                # reference's MgrMap module list) and get a perf tick
                self.modules.reconcile(
                    self.conf["mgr_enabled_modules"].split())
                ret, _, out = self.monc.command(
                    {"prefix": "health"}, 5.0)
                if ret == 0:
                    with self.lock:
                        self._health_cache = out
                self.modules.notify_all("perf")
            except Exception as e:
                self.log.dout(5, f"module tick failed: {e!r}")

    # -- MgrModule API backing (see modules/__init__.py) ----------------
    def _module_osdmap(self) -> OSDMap:
        with self.lock:
            return self.osdmap

    def _module_get(self, what: str):
        """Named state blobs for modules (reference ActivePyModules::
        get_python)."""
        with self.lock:
            if what == "perf_counters":
                return {k: v["perf"]
                        for k, v in self.daemon_perf.items()}
            if what == "osd_map":
                return self.osdmap.to_wire_dict()
            if what == "health":
                return dict(self._health_cache)
            if what == "config":
                return self.conf.dump()
        if what == "status":
            return self.status()
        raise KeyError(f"unknown state blob {what!r}")

    def _collect_once(self) -> None:
        interval = self.conf["mgr_tick_interval"]
        now = time.time()
        with self.lock:
            # expire requests unanswered for several ticks (wedged
            # OSD) — clearing every tick would starve any OSD whose
            # reply round-trip exceeds one interval
            for tid in [t for t, (_, ts) in self._pending.items()
                        if now - ts > 3 * interval]:
                del self._pending[tid]
            osds = [(o, i.addr) for o, i in self.osdmap.osds.items()
                    if i.up and i.addr]
        for osd, addr in osds:
            with self.lock:
                self._next_tid += 1
                tid = self._next_tid
                self._pending[tid] = (f"osd.{osd}", now)
            try:
                conn = self.msgr.connect_to(tuple(addr),
                                            peer_name=f"osd.{osd}")
                conn.send_message(MCommand(
                    tid=tid, cmd={"prefix": "perf dump"}))
            except Exception:
                pass
        # drop snapshots of daemons gone from the map
        with self.lock:
            live = {f"osd.{o}" for o, _ in osds}
            for name in list(self.daemon_perf):
                if name not in live:
                    del self.daemon_perf[name]

    # ------------------------------------------------------------------
    # module surface
    # ------------------------------------------------------------------
    def status(self) -> dict:
        with self.lock:
            osdmap = self.osdmap
            perf = {k: v["perf"] for k, v in self.daemon_perf.items()}
        return {
            "osdmap_epoch": osdmap.epoch,
            "daemons_reporting": sorted(perf),
            "balancer": balancer_report(osdmap),
            "pg_autoscaler": pg_autoscale_recommendations(osdmap),
        }

    # ------------------------------------------------------------------
    # prometheus exporter (reference pybind/mgr/prometheus)
    # ------------------------------------------------------------------
    def render_metrics(self) -> str:
        """Prometheus text exposition (delegates to the prometheus
        module\'s renderer; kept for library callers)."""
        from .modules.prometheus import render
        return render(self._module_osdmap(),
                      self._module_get("perf_counters"))

    def _start_http(self) -> None:
        mgr = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 (stdlib API)
                # every route comes from an enabled module (reference:
                # prometheus/restful/dashboard each bring their own
                # HTTP surface; here one frontend dispatches)
                fn = mgr.modules.http_route(self.path.rstrip("/"))
                if fn is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                try:
                    ctype, body = fn()
                except Exception:
                    self.send_response(500)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self._http = ThreadingHTTPServer(("127.0.0.1", self._http_port),
                                         Handler)
        self.http_addr = self._http.server_address
        t = threading.Thread(target=self._http.serve_forever,
                             name="mgr-http", daemon=True)
        t.start()
        self._threads.append(t)
