"""pg_autoscaler mgr module: pg_num recommendations + active apply.

Reference analog: ``src/pybind/mgr/pg_autoscaler/module.py``:
recommends per-pool pg_num targets and, when
``mgr_pg_autoscale_mode = on``, applies growth via
`osd pool set pg_num` (live PG splits; merges stay advisory).
"""
from __future__ import annotations

from . import MgrModule
from ..manager import pg_autoscale_recommendations


class Module(MgrModule):
    NAME = "pg_autoscaler"

    def serve(self) -> None:
        interval = self.get_module_option("mgr_tick_interval", 1.0)
        while not self.should_stop.wait(interval):
            try:
                self._maybe_apply()
            except Exception as e:
                self.log.dout(5, f"autoscale failed: {e!r}")

    def _maybe_apply(self) -> None:
        if self.get_module_option("mgr_pg_autoscale_mode") != "on":
            return
        osdmap = self.get_osdmap()
        for rec in pg_autoscale_recommendations(osdmap):
            pool = osdmap.pools.get(rec["pool_id"])
            if pool is None or pool.is_erasure():
                continue
            if rec["target_pg_num"] > pool.pg_num:
                ret, msg, _ = self.mon_command(
                    {"prefix": "osd pool set", "pool": pool.name,
                     "var": "pg_num",
                     "val": str(rec["target_pg_num"])})
                self.log.dout(
                    1, f"autoscale {pool.name}: pg_num "
                    f"{pool.pg_num} -> {rec['target_pg_num']} "
                    f"(rc={ret} {msg})")

    def handle_command(self, cmd: dict):
        return (0, "", {"recommendations":
                        pg_autoscale_recommendations(
                            self.get_osdmap())})
