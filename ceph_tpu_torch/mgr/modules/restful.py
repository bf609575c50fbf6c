"""restful mgr module: minimal JSON REST API.

Reference analog: ``src/pybind/mgr/restful/`` (and the dashboard's
read paths) — cluster state over HTTP as JSON: health, OSDs, pools,
per-daemon perf, and the legacy /status composite.
"""
from __future__ import annotations

import json

from . import MgrModule


def _json(obj) -> tuple:
    return ("application/json",
            json.dumps(obj, indent=2, default=str).encode())


class Module(MgrModule):
    NAME = "restful"

    def _health(self):
        return _json(self.get("health"))

    def _osds(self):
        osdmap = self.get_osdmap()
        return _json([{"osd": o, "up": i.up,
                       "in": i.weight > 0,
                       "weight": i.weight / 0x10000,
                       "addr": list(i.addr) if i.addr else None}
                      for o, i in sorted(osdmap.osds.items())])

    def _pools(self):
        osdmap = self.get_osdmap()
        return _json([{"pool": p.pool_id, "name": p.name,
                       "type": p.type, "size": p.size,
                       "pg_num": p.pg_num,
                       "erasure_code_profile": p.erasure_code_profile,
                       "cache_mode": p.cache_mode,
                       "tier_of": p.tier_of}
                      for p in sorted(osdmap.pools.values(),
                                      key=lambda p: p.pool_id)])

    def _perf(self):
        return _json(self.get("perf_counters"))

    def _status(self):
        return _json(self.get("status"))

    def http_routes(self):
        return {"/api/health": self._health,
                "/api/osd": self._osds,
                "/api/pool": self._pools,
                "/api/perf": self._perf,
                "/status": self._status}
