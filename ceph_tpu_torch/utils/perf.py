"""Performance counters.

Python-native equivalent of the reference's PerfCounters (reference
src/common/perf_counters.h:63 — typed counters registered per subsystem,
u64 counters, time averages with (total, count) pairs, and 2-D
histograms in common/perf_histogram.h; dumped over the admin socket by
``ceph daemon <x> perf dump``).

Counters are lock-light: plain adds under a mutex (Python ints are
arbitrary precision, no overflow concerns).  ``PerfCountersCollection``
aggregates every registered set for a daemon-wide dump.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

TYPE_U64 = "u64"          # gauge (set_)
TYPE_COUNTER = "counter"  # monotonically increasing (inc)
TYPE_TIME = "time"        # seconds accumulator
TYPE_TIME_AVG = "timeavg"  # (total seconds, sample count)
TYPE_HISTOGRAM = "histogram"


class PerfCounters:
    """One subsystem's counter set (reference PerfCounters)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._types: Dict[str, str] = {}
        self._descriptions: Dict[str, str] = {}
        self._values: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._hist_bounds: Dict[str, List[float]] = {}
        self._hist_buckets: Dict[str, List[int]] = {}

    # -- registration ------------------------------------------------------
    def add(self, name: str, type: str = TYPE_COUNTER,
            description: str = "") -> None:
        with self._lock:
            if name in self._types:
                raise KeyError(f"counter {name} already registered")
            self._types[name] = type
            self._descriptions[name] = description
            self._values[name] = 0
            self._counts[name] = 0

    def add_u64(self, name: str, description: str = "") -> None:
        self.add(name, TYPE_U64, description)

    def add_time_avg(self, name: str, description: str = "") -> None:
        self.add(name, TYPE_TIME_AVG, description)

    def add_histogram(self, name: str, bounds: List[float],
                      description: str = "") -> None:
        with self._lock:
            self._types[name] = TYPE_HISTOGRAM
            self._descriptions[name] = description
            self._hist_bounds[name] = sorted(bounds)
            self._hist_buckets[name] = [0] * (len(bounds) + 1)

    # -- updates -----------------------------------------------------------
    def inc(self, name: str, by: float = 1) -> None:
        with self._lock:
            self._values[name] += by
            self._counts[name] += 1

    def dec(self, name: str, by: float = 1) -> None:
        with self._lock:
            self._values[name] -= by

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._values[name] = value

    def tinc(self, name: str, seconds: float) -> None:
        """Time-average sample (reference logger->tinc, osd/OSD.cc:9630)."""
        with self._lock:
            self._values[name] += seconds
            self._counts[name] += 1

    def inc_many(self, samples) -> None:
        """Batch update under ONE lock acquisition: ``samples`` is an
        iterable of ``(name, by)`` pairs, each applied with inc/tinc
        semantics (value += by, count += 1).  For hot paths that
        charge several counters per op (critpath.observe charges one
        per stage) the per-call lock round-trips dominate."""
        with self._lock:
            values, counts = self._values, self._counts
            for name, by in samples:
                values[name] += by
                counts[name] += 1

    def hinc(self, name: str, value: float) -> None:
        with self._lock:
            bounds = self._hist_bounds[name]
            buckets = self._hist_buckets[name]
            lo, hi = 0, len(bounds)
            while lo < hi:
                mid = (lo + hi) // 2
                if value <= bounds[mid]:
                    hi = mid
                else:
                    lo = mid + 1
            buckets[lo] += 1

    # -- read --------------------------------------------------------------
    def get(self, name: str) -> float:
        with self._lock:
            return self._values[name]

    def avg(self, name: str) -> float:
        with self._lock:
            c = self._counts[name]
            return self._values[name] / c if c else 0.0

    def dump(self) -> Dict[str, object]:
        with self._lock:
            out: Dict[str, object] = {}
            for name, t in self._types.items():
                if t == TYPE_TIME_AVG:
                    out[name] = {"avgcount": self._counts[name],
                                 "sum": self._values[name]}
                elif t == TYPE_HISTOGRAM:
                    out[name] = {"bounds": self._hist_bounds[name],
                                 "buckets": list(self._hist_buckets[name])}
                else:
                    out[name] = self._values[name]
            return out


class TimeScope:
    """``with logger.time('op_lat'):`` convenience."""

    def __init__(self, counters: PerfCounters, name: str):
        self.counters = counters
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.counters.tinc(self.name, time.perf_counter() - self.t0)
        return False


class PerfCountersCollection:
    """All counter sets of one daemon (reference
    PerfCountersCollection, dumped via admin socket 'perf dump')."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sets: Dict[str, PerfCounters] = {}

    def create(self, name: str) -> PerfCounters:
        with self._lock:
            if name not in self._sets:
                self._sets[name] = PerfCounters(name)
            return self._sets[name]

    def add(self, counters: PerfCounters) -> None:
        with self._lock:
            self._sets[counters.name] = counters

    def remove(self, name: str) -> None:
        with self._lock:
            self._sets.pop(name, None)

    def perf_dump(self) -> Dict[str, Dict[str, object]]:
        with self._lock:
            return {name: c.dump() for name, c in sorted(self._sets.items())}
