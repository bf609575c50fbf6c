"""Lock/queue contention telemetry: TimedLock, TimedCondition.

The critical path and the hop ledger say where an op's time went;
this layer says WHY a hop was slow when the answer is "blocked on a
lock" or "parked in a queue".  A ``ContentionStats`` owns one
``contention`` perf subsystem per daemon (wait/hold histograms, an
acquire counter and queue-depth gauges per instrumented site) and the
``TimedLock`` / ``TimedCondition`` wrappers feed it.  Waits at or over
a configurable stall threshold additionally land in the
FlightRecorder, so a contention spike leaves a correlated breadcrumb
next to the routing/dispatch events already recorded there.

Wrappers integrate with lockdep.py: when no inner lock is supplied,
``TimedLock`` wraps ``lockdep.make_lock(name)`` so enabling
CEPH_TPU_LOCKDEP keeps its ordering checks underneath the timing.
Both wrappers degrade to plain passthrough (two perf_counter calls)
when built without stats, and support RLock-style recursion: hold time
is measured outer-acquire to outer-release via a thread-local depth
counter.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

from . import lockdep

#: log-spaced bounds in MICROSECONDS for wait/hold histograms: lock
#: handoffs live in the 1-100us range, stalls in the ms+ tail
US_BOUNDS: List[float] = [
    1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1e3, 2.5e3, 5e3, 10e3, 25e3, 50e3, 100e3, 500e3, 1e6,
]


class ContentionStats:
    """One daemon's contention subsystem: registration + sinks."""

    def __init__(self, perf_coll=None, recorder=None,
                 stall_threshold_s: float = 0.05):
        self.recorder = recorder
        self.stall_threshold_s = stall_threshold_s
        self.cperf = None
        if perf_coll is not None:
            cp = perf_coll.create("contention")
            if "stalls" not in cp._types:
                cp.add("stalls",
                       description="lock/cond waits over the stall "
                                   "threshold (also flight-recorded)")
            self.cperf = cp

    def register_site(self, site: str) -> None:
        """Idempotently add one instrumented site's counter family."""
        cp = self.cperf
        if cp is None or f"{site}_acquires" in cp._types:
            return
        cp.add(f"{site}_acquires",
               description=f"{site}: outer acquisitions")
        cp.add_histogram(f"{site}_wait_us", US_BOUNDS,
                         description=f"{site}: time blocked acquiring")
        cp.add_histogram(f"{site}_hold_us", US_BOUNDS,
                         description=f"{site}: outer hold time")

    def register_queue(self, site: str) -> None:
        cp = self.cperf
        if cp is None or f"{site}_depth_now" in cp._types:
            return
        cp.add_u64(f"{site}_depth_now",
                   description=f"{site}: queue depth at last enqueue")
        cp.add_u64(f"{site}_depth_hwm",
                   description=f"{site}: queue depth high-water mark")

    # -- sinks (called from lock hot paths; must stay cheap) -----------
    def on_wait(self, site: str, wait_s: float) -> None:
        cp = self.cperf
        if cp is not None:
            cp.inc(f"{site}_acquires")
            cp.hinc(f"{site}_wait_us", wait_s * 1e6)
        if wait_s >= self.stall_threshold_s:
            self._stall(site, wait_s)

    def on_hold(self, site: str, hold_s: float) -> None:
        cp = self.cperf
        if cp is not None:
            cp.hinc(f"{site}_hold_us", hold_s * 1e6)

    def note_queue_depth(self, site: str, depth: int) -> None:
        cp = self.cperf
        if cp is None:
            return
        cp.set(f"{site}_depth_now", depth)
        if depth > cp.get(f"{site}_depth_hwm"):
            cp.set(f"{site}_depth_hwm", depth)

    def _stall(self, site: str, wait_s: float) -> None:
        cp = self.cperf
        if cp is not None:
            cp.inc("stalls")
        rec = self.recorder
        if rec is not None:
            try:
                rec.note("lock_stall", site=site,
                         wait_ms=round(wait_s * 1e3, 3),
                         thread=threading.current_thread().name)
            except Exception:
                pass


class TimedLock:
    """RLock wrapper measuring wait-to-acquire and outer hold time.

    ``inner`` defaults to ``lockdep.make_lock(name)`` (plain RLock, or
    the ordering-checked DebugRLock under CEPH_TPU_LOCKDEP).  An
    existing lock may be passed to retrofit timing onto state created
    elsewhere (the OSD wraps its store's mutex this way)."""

    def __init__(self, name: str, stats: Optional[ContentionStats] = None,
                 inner=None):
        self.name = name
        self._inner = inner if inner is not None else lockdep.make_lock(name)
        self._local = threading.local()
        self._stats = None
        self.bind(stats)

    def bind(self, stats: Optional[ContentionStats]) -> None:
        """(Re)attach a stats sink — used when a daemon restarts on a
        surviving store and adopts its already-wrapped mutex."""
        if stats is not None:
            stats.register_site(self.name)
        self._stats = stats

    def acquire(self, blocking: bool = True, timeout: float = -1):
        st = self._stats
        if st is None:
            return self._inner.acquire(blocking, timeout)
        t0 = time.perf_counter()
        got = self._inner.acquire(blocking, timeout)
        if got:
            loc = self._local
            depth = getattr(loc, "depth", 0)
            if depth == 0:
                loc.t_hold = time.perf_counter()
                st.on_wait(self.name, loc.t_hold - t0)
            loc.depth = depth + 1
        return got

    def release(self) -> None:
        st = self._stats
        if st is not None:
            loc = self._local
            depth = getattr(loc, "depth", 1) - 1
            loc.depth = depth
            # t_hold may be unset if stats were bound mid-hold
            t_hold = getattr(loc, "t_hold", None)
            if depth == 0 and t_hold is not None:
                st.on_hold(self.name, time.perf_counter() - t_hold)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # Condition() compatibility (threading.Condition probes these)
    def _is_owned(self):
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        if inner.acquire(False):
            inner.release()
            return False
        return True


class TimedCondition:
    """Condition wrapper measuring time blocked in wait().

    Each wait() — including spurious wakeups and timeout slices — is
    one sample in the site's ``_wait_us`` histogram, so "consumer
    starved" vs "consumer spinning" is visible at a glance."""

    def __init__(self, name: str, stats: Optional[ContentionStats] = None,
                 lock=None):
        self.name = name
        self._cond = threading.Condition(lock)
        self._stats = stats
        if stats is not None:
            stats.register_site(name)

    def wait(self, timeout: Optional[float] = None):
        st = self._stats
        if st is None:
            return self._cond.wait(timeout)
        t0 = time.perf_counter()
        notified = self._cond.wait(timeout)
        st.on_wait(self.name, time.perf_counter() - t0)
        return notified

    def wait_for(self, predicate, timeout: Optional[float] = None):
        st = self._stats
        if st is None:
            return self._cond.wait_for(predicate, timeout)
        t0 = time.perf_counter()
        result = self._cond.wait_for(predicate, timeout)
        st.on_wait(self.name, time.perf_counter() - t0)
        return result

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()

    def acquire(self, *a, **kw):
        return self._cond.acquire(*a, **kw)

    def release(self) -> None:
        self._cond.release()

    def __enter__(self):
        self._cond.__enter__()
        return self

    def __exit__(self, *exc):
        return self._cond.__exit__(*exc)
