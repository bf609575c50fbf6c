"""tuner mgr module: cluster-level mClock retuning from SLO burn.

The cluster half of the closed-loop tuner (the per-OSD half lives
in utils/tuner.py + OSD._maybe_tuner_tick).  The
per-OSD controller walks *local* batcher knobs; this module owns the
*cluster* trade — how much of each OSD's op-queue capacity background
recovery may take from foreground clients — by AIMD-adjusting the
mClock recovery weight (Gulati et al., OSDI 2010) from the SLO
burn gauges (mgr/slo.py):

* client burn above ``mgr_tuner_burn_high`` → **demote** recovery
  (multiplicative decrease: weight halves, floored at the Option
  min), because clients are visibly missing their latency targets;
* recovery burn high while client burn is below
  ``mgr_tuner_burn_low`` → **promote** recovery (additive increase),
  because the rebuild is lagging and clients have headroom;
* both calm and below the baseline → **restore** gently toward the
  operator-configured weight.

Actuation follows the balancer/pg_autoscaler advisory-vs-act pattern
but ``mgr_tuner_mode`` defaults to **act**: changes go through
``config set`` on the monitor, ride the next map epoch into every
OSD's conf, and the OSD-side config observer pushes the new triples
into the live shard queues (OpScheduler.set_qos) — no restarts
anywhere.  Every decision (applied or advisory) is kept in a bounded
ring returned by ``ceph mgr tuner ...`` handle_command, so the
cluster loop is as auditable as the per-OSD one.
"""
from __future__ import annotations

import time
from collections import deque

from . import MgrModule

_WGT_OPT = "osd_mclock_scheduler_recovery_wgt"
_PROMOTE_STEP = 5.0     # additive increase (AIMD)
_RESTORE_STEP = 2.5     # gentle decay back toward the baseline
_COOLDOWN_TICKS = 3     # settle time after any action


class Module(MgrModule):
    NAME = "tuner"

    def __init__(self, host) -> None:
        super().__init__(host)
        self._steps: "deque" = deque(maxlen=64)
        self._cooldown = 0
        self._baseline_wgt = None
        self._expected_wgt = None    # last value WE set
        self._last_burns = (0.0, 0.0)

    def serve(self) -> None:
        interval = self.get_module_option("mgr_tick_interval", 1.0)
        while not self.should_stop.wait(interval):
            try:
                self._tick()
            except Exception as e:
                self.log.dout(5, f"tuner tick failed: {e!r}")

    # -- control law ---------------------------------------------------
    def _burns(self):
        """(client_burn, recovery_burn) as ratios (1.0 = consuming
        the error budget exactly), max over every daemon's SLO
        gauges (permille in the perf dumps)."""
        client = recovery = 0
        perf = self.get("perf_counters") or {}
        for dump in perf.values():
            slo = (dump or {}).get("slo") or {}
            client = max(client,
                         slo.get("client_read_burn_now", 0) or 0,
                         slo.get("client_write_burn_now", 0) or 0)
            recovery = max(recovery,
                           slo.get("recovery_burn_now", 0) or 0)
        return client / 1000.0, recovery / 1000.0

    def _tick(self) -> None:
        mode = self.get_module_option("mgr_tuner_mode", "act")
        if mode == "off":
            return
        high = float(self.get_module_option("mgr_tuner_burn_high",
                                            1.0))
        low = float(self.get_module_option("mgr_tuner_burn_low",
                                           0.25))
        client_burn, recovery_burn = self._burns()
        self._last_burns = (client_burn, recovery_burn)
        wgt = float(self.get_module_option(_WGT_OPT, 10.0))
        if self._baseline_wgt is None or (
                self._expected_wgt is not None
                and wgt != self._expected_wgt):
            # the operator's configured weight is what "restore"
            # converges back to once both classes are calm; a value
            # that differs from the last one WE set is an operator
            # override — re-baseline instead of fighting it
            self._baseline_wgt = wgt
            self._expected_wgt = None
        if self._cooldown > 0:
            self._cooldown -= 1
            return
        if client_burn > high and wgt > 1.0:
            # clients are missing their targets: halve recovery's
            # share of spare capacity (multiplicative decrease)
            self._act(mode, "demote_recovery", wgt,
                      max(1.0, wgt / 2.0), client_burn,
                      recovery_burn)
        elif recovery_burn > high and client_burn < low:
            # the rebuild is lagging and clients have headroom:
            # give recovery a bigger share (additive increase)
            self._act(mode, "promote_recovery", wgt,
                      wgt + _PROMOTE_STEP, client_burn,
                      recovery_burn)
        elif client_burn < low and recovery_burn < low \
                and wgt < self._baseline_wgt:
            # both calm after a demotion: drift back toward the
            # operator's configured weight
            self._act(mode, "restore_recovery", wgt,
                      min(self._baseline_wgt, wgt + _RESTORE_STEP),
                      client_burn, recovery_burn)

    def _act(self, mode: str, action: str, old: float, new: float,
             client_burn: float, recovery_burn: float) -> None:
        if new == old:
            return
        step = {"time": time.time(), "action": action,
                "option": _WGT_OPT, "old": old, "new": new,
                "client_burn": round(client_burn, 3),
                "recovery_burn": round(recovery_burn, 3),
                "mode": mode, "applied": False}
        if mode == "act":
            ret, msg, _ = self.mon_command(
                {"prefix": "config set", "name": _WGT_OPT,
                 "value": str(new)})
            step["applied"] = ret == 0
            if ret == 0:
                self._expected_wgt = new
            else:
                step["error"] = msg
            self.log.dout(
                1, f"tuner {action}: {_WGT_OPT} {old} -> {new} "
                f"(client_burn={client_burn:.2f} "
                f"recovery_burn={recovery_burn:.2f} rc={ret})")
        self._steps.append(step)
        self._cooldown = _COOLDOWN_TICKS

    # -- audit surface -------------------------------------------------
    def handle_command(self, cmd: dict):
        client_burn, recovery_burn = self._last_burns
        return (0, "", {
            "mode": self.get_module_option("mgr_tuner_mode", "act"),
            "burn_high": self.get_module_option(
                "mgr_tuner_burn_high", 1.0),
            "burn_low": self.get_module_option(
                "mgr_tuner_burn_low", 0.25),
            "client_burn": round(client_burn, 3),
            "recovery_burn": round(recovery_burn, 3),
            "recovery_wgt": self.get_module_option(_WGT_OPT, None),
            "baseline_wgt": self._baseline_wgt,
            "cooldown": self._cooldown,
            "steps": list(self._steps),
        })
