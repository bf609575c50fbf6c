"""dashboard mgr module: the web UI.

Reference analog: ``src/pybind/mgr/dashboard/module.py`` — the
reference ships a full Angular SPA; this module delivers the same
operational picture (health, capacity, OSD states, pool table, PG
state breakdown, daemon perf) as ONE server-rendered page with a
small inline script polling a composite JSON endpoint, because a
frontend build system has no place inside the framework.  Everything
on the page is drawn from the same :class:`MgrModule` ``get()``
surface the reference dashboard's controllers use.

Routes:
  /dashboard          the page
  /dashboard/data     composite JSON the page polls (and a stable
                      machine endpoint for tests/tools)
"""
from __future__ import annotations

import json
import time

from . import MgrModule

_PAGE = """<!DOCTYPE html>
<html><head><title>ceph_tpu dashboard</title><style>
body { font-family: sans-serif; margin: 1.5em; background: #fafafa; }
h1 { font-size: 1.3em; } h2 { font-size: 1.05em; margin-top: 1.2em; }
table { border-collapse: collapse; min-width: 24em; }
td, th { border: 1px solid #ccc; padding: 2px 8px; font-size: 0.9em;
         text-align: left; }
th { background: #eee; }
.ok { color: #1a7f37; font-weight: bold; }
.warn { color: #b08800; font-weight: bold; }
.err { color: #cf222e; font-weight: bold; }
#updated { color: #666; font-size: 0.8em; }
</style></head><body>
<h1>ceph_tpu dashboard</h1>
<div>Health: <span id="health">...</span>
  <span id="checks"></span></div>
<div id="updated"></div>
<h2>Cluster</h2><table id="cluster"></table>
<h2>Pools</h2><table id="pools"></table>
<h2>OSDs</h2><table id="osds"></table>
<h2>PG states</h2><table id="pgs"></table>
<script>
function esc(v) {
  return String(v).replace(/[&<>"']/g, function (ch) {
    return "&#" + ch.charCodeAt(0) + ";"; });
}
function row(cells, tag) {
  tag = tag || "td";
  return "<tr>" + cells.map(function (c) {
    return "<" + tag + ">" + esc(c) + "</" + tag + ">"; }).join("") +
    "</tr>";
}
function refresh() {
  fetch("/dashboard/data").then(function (r) { return r.json(); })
  .then(function (d) {
    var h = document.getElementById("health");
    h.textContent = d.health.status;
    h.className = d.health.status === "HEALTH_OK" ? "ok" :
      (d.health.status === "HEALTH_WARN" ? "warn" : "err");
    document.getElementById("checks").textContent =
      (d.health.checks || []).join("; ");
    document.getElementById("updated").textContent =
      "updated " + new Date().toLocaleTimeString() +
      " | epoch " + d.epoch;
    document.getElementById("cluster").innerHTML =
      row(["mgr", "osds up/in", "pools", "pgs"], "th") +
      row([d.mgr, d.osds_up + "/" + d.osds_in,
           d.pools.length, d.num_pgs]);
    document.getElementById("pools").innerHTML =
      row(["name", "type", "size", "pg_num", "profile"], "th") +
      d.pools.map(function (p) {
        return row([p.name, p.type, p.size, p.pg_num,
                    p.erasure_code_profile || "-"]); }).join("");
    document.getElementById("osds").innerHTML =
      row(["osd", "up", "in", "weight", "ops", "bytes"], "th") +
      d.osds.map(function (o) {
        return row(["osd." + o.osd, o.up ? "up" : "down",
                    o["in"] ? "in" : "out", o.weight,
                    o.ops, o.bytes]); }).join("");
    var pgrows = Object.keys(d.pg_states).sort().map(function (s) {
      return row([s, d.pg_states[s]]); }).join("");
    document.getElementById("pgs").innerHTML =
      row(["state", "count"], "th") + pgrows;
  });
}
refresh();
setInterval(refresh, 5000);
</script></body></html>"""


class Module(MgrModule):
    NAME = "dashboard"

    def _page(self):
        return ("text/html", _PAGE.encode())

    def _data(self):
        """The composite the page polls: one round trip per refresh
        (the reference dashboard's controllers fan out to many API
        endpoints; the data is the same)."""
        osdmap = self.get_osdmap()
        health = self.get("health")
        perf = self.get("perf_counters") or {}
        pg_states: dict = {}
        pg_total = 0
        for st in (health.get("pg_states") or {}):
            pg_states[st] = health["pg_states"][st]
        if not pg_states:
            ret, _, out = self.mon_command({"prefix": "pg dump"})
            if ret == 0:
                for stat in out.get("pg_stats", {}).values():
                    s = stat.get("state", "unknown")
                    pg_states[s] = pg_states.get(s, 0) + 1
        pg_total = sum(pg_states.values())
        osds = []
        for o, i in sorted(osdmap.osds.items()):
            pc = (perf.get(f"osd.{o}") or {})
            osds.append({
                "osd": o, "up": i.up, "in": i.weight > 0,
                "weight": round(i.weight / 0x10000, 2),
                "ops": pc.get("op", pc.get("osd_op", 0)),
                "bytes": pc.get("op_in_bytes", 0)})
        body = {
            "epoch": osdmap.epoch,
            "time": time.time(),
            "health": {"status": health.get("status", "HEALTH_OK"),
                       "checks": sorted(health.get("checks", {}))},
            # the serving mgr IS the active one (standbys don't
            # answer HTTP); no fabricated mon count — the monitor's
            # status has no quorum size to report yet
            "mgr": getattr(self._host.msgr, "name", "active"),
            "osds_up": sum(1 for i in osdmap.osds.values() if i.up),
            "osds_in": sum(1 for i in osdmap.osds.values()
                           if i.weight > 0),
            "num_pgs": pg_total,
            "pg_states": pg_states,
            "pools": [{"name": p.name, "type": p.type,
                       "size": p.size, "pg_num": p.pg_num,
                       "erasure_code_profile":
                           p.erasure_code_profile}
                      for p in sorted(osdmap.pools.values(),
                                      key=lambda p: p.pool_id)],
        }
        return ("application/json",
                json.dumps(body, default=str).encode())

    def http_routes(self):
        return {"/dashboard": self._page,
                "/dashboard/data": self._data}

    def handle_command(self, cmd):
        if cmd.get("args", [])[:1] == ["status"]:
            host, port = self._host.http_addr
            return (0, f"dashboard at http://{host}:{port}/dashboard",
                    {"url": f"http://{host}:{port}/dashboard"})
        return (-22, "usage: ceph mgr dashboard status", {})
