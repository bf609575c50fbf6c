"""balancer mgr module: PG-distribution evenness report.

Reference analog: ``src/pybind/mgr/balancer/module.py`` in its
advisory role — score the primary-PG spread per pool and surface it
as a module command (`ceph mgr balancer status`).
"""
from __future__ import annotations

from . import MgrModule
from ..manager import balancer_report


class Module(MgrModule):
    NAME = "balancer"

    def handle_command(self, cmd: dict):
        if (cmd.get("args") or [""])[0] in ("status", ""):
            return (0, "", balancer_report(self.get_osdmap()))
        return (-22, "usage: ceph mgr balancer status", {})
