"""Per-op event timelines + historic op dump.

Python-native equivalent of the reference's OpTracker/TrackedOp
(reference src/common/TrackedOp.h:101 — ``mark_event`` timestamps the
stages of each in-flight op; a bounded history ring feeds the admin
socket's ``dump_historic_ops``; ops in flight longer than the warn
threshold surface as slow ops, reference osd/OSD.cc:2457-2488).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional


class TrackedOp:
    def __init__(self, tracker: "OpTracker", description: str):
        self._tracker = tracker
        self.description = description
        self.start = time.time()
        self.events: List[tuple] = [(self.start, "initiated")]
        self.done: Optional[float] = None

    def mark_event(self, event: str) -> None:
        self.events.append((time.time(), event))

    def finish(self) -> None:
        if self.done is None:
            self.done = time.time()
            self.mark_event("done")
            self._tracker._retire(self)

    @property
    def duration(self) -> float:
        return (self.done or time.time()) - self.start

    def dump(self) -> Dict:
        return {
            "description": self.description,
            "initiated_at": self.start,
            "age": self.duration,
            "events": [{"time": t, "event": e} for t, e in self.events],
        }


class OpTracker:
    def __init__(self, history_size: int = 20,
                 history_duration: float = 600.0,
                 slow_op_warn_threshold: float = 30.0):
        self._lock = threading.Lock()
        self._in_flight: Dict[int, TrackedOp] = {}
        self._history: Deque[TrackedOp] = deque(maxlen=history_size)
        self.history_duration = history_duration
        self.slow_op_warn_threshold = slow_op_warn_threshold
        # called with each retired op AFTER it moves to history (the
        # OSD hangs its critical-path accumulator here — analysis
        # runs post-reply, off the client latency path).  Must not
        # raise; a broken observer must not break op retirement.
        self.on_retire = None

    def create(self, description: str) -> TrackedOp:
        op = TrackedOp(self, description)
        with self._lock:
            self._in_flight[id(op)] = op
        return op

    def _retire(self, op: TrackedOp) -> None:
        with self._lock:
            self._in_flight.pop(id(op), None)
            self._history.append(op)
        cb = self.on_retire
        if cb is not None:
            try:
                cb(op)
            except Exception:
                pass

    # -- admin socket hooks (reference dump_ops_in_flight etc.) ----------
    def dump_ops_in_flight(self) -> List[Dict]:
        with self._lock:
            return [op.dump() for op in self._in_flight.values()]

    def dump_historic_ops(self) -> List[Dict]:
        with self._lock:
            # age out entries past osd_op_history_duration (reference
            # OpTracker history_duration trimming)
            if self.history_duration > 0:
                cutoff = time.time() - self.history_duration
                while self._history and \
                        (self._history[0].done or 0) < cutoff:
                    self._history.popleft()
            return [op.dump() for op in self._history]

    def slow_ops(self) -> List[Dict]:
        now = time.time()
        with self._lock:
            return [op.dump() for op in self._in_flight.values()
                    if now - op.start > self.slow_op_warn_threshold]

    def dump_historic_slow_ops(self) -> List[Dict]:
        """Completed ops that ran past the warn threshold (reference
        OpTracker::dump_historic_slow_ops)."""
        with self._lock:
            return [op.dump() for op in self._history
                    if op.duration >= self.slow_op_warn_threshold]

    def dump_blocked_ops(self) -> List[Dict]:
        """In-flight ops whose latest stage is a wait (reference
        OpTracker::dump_blocked_ops — ops parked on a scrub, a
        degraded object, or the per-object write pipeline)."""
        with self._lock:
            return [op.dump() for op in self._in_flight.values()
                    if op.events and
                    op.events[-1][1].startswith("waiting")]
