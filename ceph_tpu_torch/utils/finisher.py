"""Deferred-completion thread.

Python-native equivalent of the reference's Finisher (reference
src/common/Finisher.h): a dedicated thread that drains a queue of
completion callbacks so subsystems can fire user contexts without
holding their own locks or blocking their I/O paths.  The object
store uses one to deliver on_commit callbacks (reference
os/memstore/MemStore.cc `finisher`), the messenger and OSD reuse the
same primitive for timers and dispatch completions.
"""
from __future__ import annotations

import heapq
import threading
import time
import traceback
from typing import Callable, List, Optional, Tuple


class Finisher:
    """Single consumer thread draining queued callbacks in order."""

    def __init__(self, name: str = "finisher"):
        self.name = name
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: List[Callable[[], None]] = []
        self._stop = False
        self._empty = threading.Condition(self._lock)
        self._running = 0
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True)
        self._thread.start()

    def queue(self, fn: Callable[[], None]) -> None:
        with self._cond:
            if self._stop:
                raise RuntimeError(f"{self.name}: stopped")
            self._queue.append(fn)
            self._cond.notify()

    def wait_for_empty(self, timeout: Optional[float] = None) -> bool:
        """Block until all queued callbacks have run (reference
        Finisher::wait_for_empty)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._empty:
            while self._queue or self._running:
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._empty.wait(left)
        return True

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify()
        self._thread.join()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait()
                if not self._queue and self._stop:
                    return
                batch = self._queue
                self._queue = []
                self._running = len(batch)
            for fn in batch:
                try:
                    fn()
                except Exception:       # callbacks must not kill the thread
                    traceback.print_exc()
                finally:
                    with self._empty:
                        self._running -= 1
                        if not self._queue and not self._running:
                            self._empty.notify_all()


class SafeTimer:
    """Monotonic-clock timer thread (reference common/Timer.h SafeTimer):
    schedule callbacks after a delay; cancellable by token."""

    def __init__(self, name: str = "timer"):
        self.name = name
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._cancelled: set = set()
        self._seq = 0
        self._stop = False
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True)
        self._thread.start()

    def add_event_after(self, delay: float,
                        fn: Callable[[], None]) -> int:
        with self._cond:
            if self._stop:
                raise RuntimeError(f"{self.name}: stopped")
            self._seq += 1
            token = self._seq
            heapq.heappush(self._heap,
                           (time.monotonic() + delay, token, fn))
            self._cond.notify()
            return token

    def cancel_event(self, token: int) -> None:
        with self._cond:
            # only track tokens still pending, else an already-fired
            # token would sit in _cancelled forever
            if any(t == token for _, t, _ in self._heap):
                self._cancelled.add(token)
                self._cond.notify()

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify()
        self._thread.join()

    def _run(self) -> None:
        while True:
            with self._cond:
                if self._stop:
                    return
                now = time.monotonic()
                if not self._heap:
                    self._cond.wait()
                    continue
                when, token, fn = self._heap[0]
                if token in self._cancelled:
                    heapq.heappop(self._heap)
                    self._cancelled.discard(token)
                    continue
                if when > now:
                    self._cond.wait(when - now)
                    continue
                heapq.heappop(self._heap)
            try:
                fn()
            except Exception:
                traceback.print_exc()
