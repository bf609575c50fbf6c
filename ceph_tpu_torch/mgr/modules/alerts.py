"""alerts mgr module: health-transition journal.

Written purely against the MgrModule API (the module-host 'done'
criterion): no mgr internals touched.  Watches cluster health each
tick and records every status TRANSITION (OK -> WARN, WARN -> ERR,
recovery back to OK) with a timestamp and the active health checks —
the moral core of the reference's ``src/pybind/mgr/alerts/`` module
with the SMTP sink replaced by a queryable ring (`ceph mgr alerts
history`).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque

from . import MgrModule


class Module(MgrModule):
    NAME = "alerts"
    KEEP = 128

    def __init__(self, host) -> None:
        super().__init__(host)
        self._last_status = None
        self._history: Deque[dict] = deque(maxlen=self.KEEP)

    def serve(self) -> None:
        interval = self.get_module_option("mgr_tick_interval", 1.0)
        while not self.should_stop.wait(interval):
            try:
                self._check()
            except Exception as e:
                self.log.dout(5, f"alert check failed: {e!r}")

    def _check(self) -> None:
        health = self.get("health") or {}
        status = health.get("status")
        if status is None:
            return
        if status != self._last_status:
            self._history.append({
                "ts": time.time(),
                "from": self._last_status,
                "to": status,
                "checks": health.get("checks", {}),
                "pg_states": health.get("pg_states", {}),
            })
            if self._last_status is not None:
                self.log.dout(1, f"health {self._last_status} -> "
                              f"{status}")
            self._last_status = status

    def handle_command(self, cmd: dict):
        arg = (cmd.get("args") or [""])[0]
        if arg in ("history", ""):
            return (0, "", {"alerts": list(self._history),
                            "current": self._last_status})
        if arg == "clear":
            self._history.clear()
            return (0, "cleared", {})
        return (-22, "usage: ceph mgr alerts [history|clear]", {})
