"""Measured machine-speed multiplier for wait budgets.

Fixed timeout constants under variable host load turn a loaded host
into a source of false failures: a fixed wait expires on a busy single
core while the work behind it is merely slow.  The reference solves this with very
generous budgets (wait_for_clean defaults to 300 s,
qa/standalone/ceph-helpers.sh:1579; qa task waits are minutes); this
framework instead measures how slow the machine currently is and
scales every cluster wait proportionally, so quiet boxes stay fast and
loaded boxes stop fabricating failures.

The probe is one warm 1 MiB k=2 m=1 jerasure encode against a ~1 ms
quiet-box reference — cheap (<50 ms even when loaded), exercised once
per process, and measuring exactly the resource (GIL + CPU) the
cluster threads starve on.
"""
from __future__ import annotations

import os
import time

_MFACTOR = None


def machine_factor() -> float:
    """This process's wait-budget multiplier in [1, 20]."""
    global _MFACTOR
    if _MFACTOR is None:
        floor = float(os.environ.get("CEPH_TPU_MACHINE_FACTOR_MIN",
                                     "1"))
        override = os.environ.get("CEPH_TPU_MACHINE_FACTOR")
        if override:
            _MFACTOR = min(20.0, max(floor, float(override)))
            return _MFACTOR
        from ..ec import registry as ecreg
        cpu = ecreg.instance().factory("jerasure", {"k": "2", "m": "1"})
        blob = os.urandom(1 << 20)
        cpu.encode({0, 1, 2}, blob)      # table/attr setup untimed
        t0 = time.perf_counter()
        cpu.encode({0, 1, 2}, blob)
        dt = time.perf_counter() - t0
        # the probe runs ONCE, usually at a quiet moment early in the
        # process; a floor (CEPH_TPU_MACHINE_FACTOR_MIN) lets long
        # suites budget for the load they themselves build up later
        _MFACTOR = min(20.0, max(1.0, floor, dt / 0.001))
    return _MFACTOR


def scaled(timeout: float) -> float:
    """A wait budget scaled by the measured machine factor."""
    return timeout * machine_factor()
