"""Hashed timer wheel: one thread per OSD instead of one per timer.

The EC write path arms a deadline timer per sub-write (k+m of them per
segment fanout).  Backing each with a ``threading.Timer`` spawns and
tears down a thread per fanout leg — at 12 OSDs x k8m4 that is
hundreds of short-lived threads per second, all for timers that are
cancelled on the happy path before they ever fire.

``TimerWheel`` replaces that with the classic hashed-wheel design
(Varghese & Lauck, SOSP '87; the same structure Ceph's own
``SafeTimer``/crimson timers amortize into): a fixed ring of slots, a
single daemon thread that advances one slot per tick, and O(1)
arm/cancel.  Deadline precision is one tick (default 5 ms), which is
far finer than the sub-write timeouts it serves (tens of ms and up).

Timers that fit within one wheel revolution are hashed to
``(cursor + ticks) % slots``; longer delays carry a remaining-rounds
counter and are re-examined once per revolution.  Cancellation just
flips a flag on the handle — the slot scan drops dead entries lazily,
so cancel never takes the wheel lock's slow path.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional


class TimerHandle:
    """Cancellable handle returned by :meth:`TimerWheel.call_later`.

    API-compatible with ``threading.Timer`` for the one method the OSD
    uses (``cancel()``), so call sites need no type switch.
    """

    __slots__ = ("fn", "rounds", "_dead", "deadline")

    def __init__(self, fn: Callable[[], None], rounds: int,
                 deadline: float = 0.0):
        self.fn: Optional[Callable[[], None]] = fn
        self.rounds = rounds
        self._dead = False
        self.deadline = deadline    # intended fire time (monotonic)

    def cancel(self) -> None:
        self._dead = True
        self.fn = None          # drop the closure (and anything it pins)

    @property
    def cancelled(self) -> bool:
        return self._dead


class TimerWheel:
    """Single-thread hashed timer wheel.

    ``call_later(delay, fn)`` arms a one-shot timer; ``fn`` runs on the
    wheel thread (callers needing a different execution context — e.g.
    the crimson reactor — wrap ``fn`` to marshal).  ``stop()`` halts
    the thread; pending timers are discarded, matching the semantics of
    cancelling outstanding ``threading.Timer``s at OSD shutdown.

    The thread is started lazily on the first ``call_later`` so that
    test stubs which construct an OSD but never arm a timer pay
    nothing.
    """

    def __init__(self, tick_s: float = 0.005, slots: int = 512):
        self.tick_s = float(tick_s)
        self.slots = int(slots)
        self._ring: List[List[TimerHandle]] = [[] for _ in range(self.slots)]
        self._cursor = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fired = 0          # observability: timers actually run
        # fire-lag observability: how late each timer actually ran
        # vs its requested deadline (scheduling jitter + tick
        # quantization + callback head-of-line blocking).  The OSD
        # points ``on_fire_lag`` at its ec_device fire-lag histogram;
        # max/total stay here for tests and dumps.
        self.on_fire_lag: Optional[Callable[[float], None]] = None
        self.fire_lag_max = 0.0
        self.fire_lag_total = 0.0

    # -- arming ------------------------------------------------------
    def call_later(self, delay: float, fn: Callable[[], None]) -> TimerHandle:
        ticks = max(1, int(float(delay) / self.tick_s + 0.999999))
        # offset 0 lands on the cursor's CURRENT slot, which the scan
        # only revisits after a full revolution — so an exact-multiple
        # delay (ticks == N*slots) must carry N-1 rounds, not N, or it
        # fires a whole revolution late.  (ticks - 1) // slots gives
        # exactly that; non-multiples are unchanged.
        offset = ticks % self.slots
        rounds = (ticks - 1) // self.slots
        deadline = time.monotonic() + float(delay)
        with self._lock:
            slot = (self._cursor + offset) % self.slots
            h = TimerHandle(fn, rounds, deadline)
            self._ring[slot].append(h)
            if self._thread is None and not self._stop.is_set():
                self._thread = threading.Thread(
                    target=self._run, name="timer-wheel", daemon=True)
                self._thread.start()
        return h

    # -- wheel thread ------------------------------------------------
    def _run(self) -> None:
        next_tick = time.monotonic() + self.tick_s
        while not self._stop.is_set():
            delay = next_tick - time.monotonic()
            if delay > 0:
                # Event.wait gives us prompt stop() without busy-spin.
                if self._stop.wait(delay):
                    break
            next_tick += self.tick_s
            due: List[tuple] = []
            with self._lock:
                self._cursor = (self._cursor + 1) % self.slots
                bucket = self._ring[self._cursor]
                if bucket:
                    keep: List[TimerHandle] = []
                    for h in bucket:
                        if h._dead:
                            continue
                        if h.rounds > 0:
                            h.rounds -= 1
                            keep.append(h)
                        elif h.fn is not None:
                            due.append((h.fn, h.deadline))
                    self._ring[self._cursor] = keep
            for fn, deadline in due:
                self._fired += 1
                # lag measured at the moment the callback STARTS, so
                # a slow earlier callback in the same bucket shows up
                # as head-of-line lag on the ones behind it
                lag = max(0.0, time.monotonic() - deadline)
                self.fire_lag_total += lag
                if lag > self.fire_lag_max:
                    self.fire_lag_max = lag
                cb = self.on_fire_lag
                if cb is not None:
                    try:
                        cb(lag)
                    except Exception:
                        pass
                try:
                    fn()
                except Exception:       # noqa: BLE001 - timer cbs must not kill the wheel
                    pass

    # -- lifecycle ---------------------------------------------------
    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=2.0)
        with self._lock:
            self._ring = [[] for _ in range(self.slots)]
            self._thread = None

    def pending(self) -> int:
        """Live (un-cancelled) timers currently armed — test hook."""
        with self._lock:
            return sum(1 for bucket in self._ring
                       for h in bucket if not h._dead)
