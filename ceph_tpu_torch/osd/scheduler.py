"""Op scheduler: mClock-style QoS over the OSD's sharded op queues.

Python-native equivalent of the reference's OpScheduler seam
(reference src/osd/scheduler/OpScheduler.{h,cc} +
mClockScheduler.{h,cc}): client, recovery and scrub work stop sharing
a plain FIFO — each class gets a *reservation* (tokens/sec it is
guaranteed), a *weight* (how spare capacity is split) and a *limit*
(tokens/sec it may never exceed), the dmClock triple.

The implementation is a token-bucket reduction of dmClock that keeps
its observable scheduling behavior at OSD scale:

* a class below its reservation is served FIRST (reservation phase);
* among classes past reservation but under limit, spare capacity is
  split by weight (largest deficit first — weighted round robin);
* a class at its limit waits even if the queue is otherwise idle only
  when ``hard_limits`` is set (the reference's mClock profiles
  likewise treat limits as soft for background classes by default:
  idle capacity may be used).

Classes mirror the reference's op classes (osd_op_queue mclock_scheduler,
common/options.cc osd_mclock_scheduler_client_res/wgt/lim etc.):
``client`` > ``recovery`` > ``scrub`` by default weights, with a
client reservation so recovery storms cannot starve foreground IO.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional, Tuple

# (reservation tokens/s, weight, limit tokens/s; 0 = unlimited)
DEFAULT_QOS: Dict[str, Tuple[float, float, float]] = {
    "client": (100.0, 100.0, 0.0),
    "peering": (50.0, 50.0, 0.0),
    "recovery": (0.0, 10.0, 0.0),
    "scrub": (0.0, 5.0, 0.0),
}


class _ClassQueue:
    def __init__(self, res: float, wgt: float, lim: float):
        self.q: deque = deque()
        self.res = res
        self.wgt = wgt
        self.lim = lim
        self.res_tokens = 0.0        # reservation bucket
        self.lim_tokens = 0.0        # limit bucket (when lim > 0)
        self.vdeficit = 0.0          # weighted-fair deficit counter
        self.served = 0
        self.depth_hwm = 0           # max queued depth ever observed


class OpScheduler:
    """One scheduler per op-queue shard (reference op_shardedwq +
    OpSchedulerItem).  ``enqueue(cls, item)``; ``dequeue(timeout)``
    -> (cls, item) | None; ``close()`` wakes everyone with None."""

    def __init__(self, qos: Optional[Dict] = None,
                 hard_limits: bool = False, fifo: bool = False):
        self._lock = threading.Condition()
        self._classes: Dict[str, _ClassQueue] = {}
        self._qos = dict(DEFAULT_QOS)
        if qos:
            self._qos.update(qos)
        self.hard_limits = hard_limits
        # fifo mode (reference osd_op_queue=fifo): plain arrival order,
        # no QoS — one queue, classes ignored
        self.fifo = fifo
        self._fifo_q: deque = deque()
        self._last_refill = time.monotonic()
        self._closed = False
        for name, (res, wgt, lim) in self._qos.items():
            self._classes[name] = _ClassQueue(res, wgt, lim)

    def _class(self, name: str) -> _ClassQueue:
        cq = self._classes.get(name)
        if cq is None:
            cq = self._classes[name] = _ClassQueue(0.0, 1.0, 0.0)
        return cq

    def enqueue(self, cls: str, item) -> None:
        with self._lock:
            if self._closed:
                return
            if self.fifo:
                self._fifo_q.append((cls, item))
            else:
                cq = self._class(cls)
                cq.q.append(item)
                if len(cq.q) > cq.depth_hwm:
                    cq.depth_hwm = len(cq.q)
            self._lock.notify()

    def enqueue_front(self, cls: str, item) -> None:
        """Requeue at the head (reference requeue_front for retried
        items)."""
        with self._lock:
            if self._closed:
                return
            if self.fifo:
                self._fifo_q.appendleft((cls, item))
            else:
                self._class(cls).q.appendleft(item)
            self._lock.notify()

    def _refill(self) -> None:
        now = time.monotonic()
        dt = now - self._last_refill
        if dt <= 0:
            return
        self._last_refill = now
        for cq in self._classes.values():
            if cq.res > 0:
                cq.res_tokens = min(cq.res_tokens + cq.res * dt,
                                    cq.res)      # burst <= 1s worth
            if cq.lim > 0:
                cq.lim_tokens = min(cq.lim_tokens + cq.lim * dt,
                                    cq.lim)

    def _pick(self) -> Optional[str]:
        """Scheduling decision over non-empty classes."""
        ready = [(n, cq) for n, cq in self._classes.items() if cq.q]
        if not ready:
            return None
        # phase 1: reservations — a class holding reservation tokens
        # is owed service regardless of weights
        best = None
        for n, cq in ready:
            if cq.res > 0 and cq.res_tokens >= 1.0:
                if best is None or cq.res_tokens > \
                        self._classes[best].res_tokens:
                    best = n
        if best is not None:
            return best
        # phase 2: weighted fair over classes under their limit
        candidates = []
        for n, cq in ready:
            if self.hard_limits and cq.lim > 0 and cq.lim_tokens < 1.0:
                continue             # at limit: hold back
            candidates.append((n, cq))
        if not candidates:
            return None
        total_w = sum(cq.wgt for _, cq in candidates) or 1.0
        for n, cq in candidates:
            cq.vdeficit += cq.wgt / total_w
        best, best_cq = max(candidates,
                            key=lambda nc: nc[1].vdeficit)
        return best

    def _serve(self, name: str):
        """Pop + token/deficit bookkeeping for a picked class.
        Caller holds the lock."""
        cq = self._classes[name]
        item = cq.q.popleft()
        cq.served += 1
        if cq.res > 0:
            cq.res_tokens = max(0.0, cq.res_tokens - 1.0)
        if cq.lim > 0:
            cq.lim_tokens = max(0.0, cq.lim_tokens - 1.0)
        cq.vdeficit = max(0.0, cq.vdeficit - 1.0)
        return name, item

    def dequeue(self, timeout: Optional[float] = None):
        """-> (cls, item), or None on close/timeout."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        with self._lock:
            while True:
                if self._closed:
                    return None
                if self.fifo:
                    if self._fifo_q:
                        return self._fifo_q.popleft()
                    if deadline is not None and \
                            time.monotonic() >= deadline:
                        return None
                    self._lock.wait(timeout)
                    continue
                self._refill()
                name = self._pick()
                if name is not None:
                    return self._serve(name)
                if any(cq.q for cq in self._classes.values()):
                    wait = 0.05      # token-gated work: refill tick
                else:
                    wait = None      # idle: sleep until an enqueue
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    wait = remaining if wait is None \
                        else min(wait, remaining)
                self._lock.wait(wait)

    def dequeue_nowait(self):
        """Single-poll dequeue for reactor-tick draining (crimson):
        -> (cls, item) or None, never blocks.  Token-gated work stays
        queued; the caller's next tick retries after refill."""
        with self._lock:
            if self._closed:
                return None
            if self.fifo:
                return self._fifo_q.popleft() if self._fifo_q else None
            self._refill()
            name = self._pick()
            if name is None:
                return None
            return self._serve(name)

    def set_qos(self, qos: Dict[str, Tuple[float, float, float]]
                ) -> bool:
        """Live mClock retune (the mgr tuner module's actuation seam):
        update class (res, wgt, lim) triples on the RUNNING shard
        queues without a restart or queue drain.  Queued items, token
        buckets and deficit counters are preserved — only the rates
        change, so the next ``_refill``/``_pick`` already schedules
        under the new triples.  Returns True when anything changed.
        No-op in fifo mode (QoS is ignored there anyway)."""
        changed = False
        with self._lock:
            if self.fifo:
                return False
            for name, (res, wgt, lim) in qos.items():
                self._qos[name] = (res, wgt, lim)
                cq = self._classes.get(name)
                if cq is None:
                    cq = self._classes[name] = _ClassQueue(
                        res, wgt, lim)
                    changed = True
                    continue
                if (cq.res, cq.wgt, cq.lim) != (res, wgt, lim):
                    cq.res = res
                    cq.wgt = wgt
                    cq.lim = lim
                    # clamp stale burst credit to the new rates so a
                    # demoted class cannot coast on old tokens
                    cq.res_tokens = min(cq.res_tokens, res) \
                        if res > 0 else 0.0
                    if lim > 0:
                        cq.lim_tokens = min(cq.lim_tokens, lim)
                    changed = True
            if changed:
                self._lock.notify_all()
        return changed

    def queued(self) -> int:
        """Total items queued across all classes (admission
        backpressure reads this without touching per-class detail)."""
        with self._lock:
            if self.fifo:
                return len(self._fifo_q)
            return sum(len(cq.q) for cq in self._classes.values())

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify_all()

    def stats(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {n: {"queued": len(cq.q), "served": cq.served,
                        "deficit": round(cq.vdeficit, 4),
                        "depth_hwm": cq.depth_hwm}
                    for n, cq in self._classes.items()}


def qos_from_conf(conf) -> Dict[str, Tuple[float, float, float]]:
    """Read the reference-style mclock knobs
    (osd_mclock_scheduler_<class>_{res,wgt,lim})."""
    out = {}
    for cls in ("client", "recovery", "scrub", "peering"):
        try:
            out[cls] = (
                float(conf[f"osd_mclock_scheduler_{cls}_res"]),
                float(conf[f"osd_mclock_scheduler_{cls}_wgt"]),
                float(conf[f"osd_mclock_scheduler_{cls}_lim"]))
        except KeyError:
            pass
    return out
