"""Lock-order checker (lockdep).

Python-native equivalent of the reference's lock-dependency tracker
(reference ``src/common/lockdep.cc`` + the ``lockdep`` config option):
every named debug lock records, at acquire time, the set of lock
CLASSES already held by the thread; acquiring B while holding A adds
the edge A->B to a global order graph, and a later acquire of A while
holding B — a cycle — is reported as a potential deadlock, with both
participating stacks, WITHOUT needing the deadlock to actually fire.

Zero-cost when disabled: ``make_lock`` returns a plain ``RLock``
unless ``CEPH_TPU_LOCKDEP=1`` (or ``enable()``), so the data path
never pays for the bookkeeping in production.  Like the reference,
classes key on the lock NAME, not the instance — "pg" vs "pg" cycles
across two different PGs are exactly the ABBA risks worth surfacing.
Re-acquiring a held class (recursion, or sibling instances of one
class) is not an edge.
"""
from __future__ import annotations

import os
import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple

_enabled = os.environ.get("CEPH_TPU_LOCKDEP", "") not in ("", "0")
_graph_lock = threading.Lock()
# edge (a, b): b was acquired while a was held; value = stack snippet
_edges: Dict[Tuple[str, str], str] = {}
_violations: List[str] = []
_local = threading.local()


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


def reset() -> None:
    with _graph_lock:
        _edges.clear()
        _violations.clear()


def violations() -> List[str]:
    with _graph_lock:
        return list(_violations)


def _held() -> List[str]:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def _would_cycle(frm: str, to: str) -> Optional[List[str]]:
    """DFS: is ``to`` already (transitively) ordered before ``frm``?
    Then adding frm->to closes a cycle; returns the path to->..->frm."""
    stack = [(to, [to])]
    seen: Set[str] = set()
    while stack:
        node, path = stack.pop()
        if node == frm:
            return path
        if node in seen:
            continue
        seen.add(node)
        for (a, b) in _edges:
            if a == node:
                stack.append((b, path + [b]))
    return None


class DebugRLock:
    """RLock with order tracking (reference lockdep's mutex_debug)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._note_acquire()
        return got

    def _note_acquire(self) -> None:
        held = _held()
        if self.name not in held:
            with _graph_lock:
                for h in held:
                    if h == self.name:
                        continue
                    edge = (h, self.name)
                    if edge not in _edges:
                        cycle = _would_cycle(h, self.name)
                        if cycle is not None:
                            stack = "".join(
                                traceback.format_stack(limit=8)[:-2])
                            first = _edges.get(
                                (cycle[0], cycle[1]), "?")
                            _violations.append(
                                f"lock order inversion: "
                                f"{h} -> {self.name} but already "
                                f"{' -> '.join(cycle)}\n"
                                f"first order at:\n{first}\n"
                                f"inversion at:\n{stack}")
                        _edges[edge] = "".join(
                            traceback.format_stack(limit=6)[:-2])
        held.append(self.name)

    def release(self) -> None:
        held = _held()
        # remove the most recent occurrence (recursive holds pop once)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == self.name:
                del held[i]
                break
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def make_lock(name: str):
    """A named lock: order-checked under lockdep, plain RLock
    otherwise (zero overhead when off)."""
    if _enabled:
        return DebugRLock(name)
    return threading.RLock()
