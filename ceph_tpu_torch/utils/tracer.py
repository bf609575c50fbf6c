"""Distributed tracing: spans across daemons (blkin/Zipkin style).

Python-native equivalent of the reference's tracing layer (reference
``common/zipkin_trace.h`` ZTracer over the blkin submodule; spans are
threaded through the EC write path with a child span per shard
sub-write, ``osd/ECBackend.cc:2063-2068``; LTTng tracepoints in
``src/tracing/*.tp`` are the process-local analog).

A ``Span`` carries (trace_id, span_id, parent_id); ids travel inside
data-path messages so one client op's spans line up across the
client, the primary, and every shard OSD.  Each process keeps a
bounded ring of finished spans, dumped via the daemon command
``dump_traces`` (reference: blkin emits to an external Zipkin
collector; here the collector is the admin surface).

Sampling: ``Tracer.enabled`` plus ``sample_every`` — tracing every
Nth op keeps the hot path cheap (id generation + two timestamps per
span when on; one branch when off).
"""
from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional


class Span:
    __slots__ = ("tracer", "name", "trace_id", "span_id",
                 "parent_id", "start", "end", "tags")

    def __init__(self, tracer: "Tracer", name: str, trace_id: int,
                 span_id: int, parent_id: int):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = time.time()
        self.end: Optional[float] = None
        self.tags: Dict[str, str] = {}

    def tag(self, key: str, value) -> "Span":
        self.tags[key] = str(value)
        return self

    def finish(self) -> None:
        if self.end is None:
            self.end = time.time()
            self.tracer._record(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()

    def dump(self) -> Dict:
        return {"name": self.name,
                "trace_id": f"{self.trace_id:016x}",
                "span_id": f"{self.span_id:016x}",
                "parent_id": f"{self.parent_id:016x}"
                if self.parent_id else None,
                "start": self.start,
                "duration_us": int(((self.end or time.time())
                                    - self.start) * 1e6),
                "tags": dict(self.tags)}


class Tracer:
    """Per-daemon tracer (reference ZTracer endpoint)."""

    def __init__(self, service: str, enabled: bool = False,
                 sample_every: int = 1, keep: int = 256):
        self.service = service
        self.enabled = enabled
        self.sample_every = max(1, sample_every)
        self._counter = 0
        self._lock = threading.Lock()
        self._finished: Deque[Span] = deque(maxlen=keep)
        self._rng = random.Random()

    def _new_id(self) -> int:
        return self._rng.getrandbits(63) | 1

    def maybe_start(self, name: str) -> Optional[Span]:
        """Root span, subject to sampling; None = not traced."""
        if not self.enabled:
            return None
        with self._lock:
            self._counter += 1
            if self._counter % self.sample_every:
                return None
        tid = self._new_id()
        return Span(self, name, tid, self._new_id(), 0)

    def start(self, name: str, trace_id: int,
              parent_id: int = 0) -> Optional[Span]:
        """Child/continuation span for a propagated context.  The
        root's sampling decision carries the trace downstream, but a
        daemon whose operator disabled tracing records nothing."""
        if not self.enabled or not trace_id:
            return None
        return Span(self, name, trace_id, self._new_id(), parent_id)

    def _record(self, span: Span) -> None:
        with self._lock:
            self._finished.append(span)

    def dump(self, trace_id: Optional[int] = None) -> List[Dict]:
        with self._lock:
            spans = list(self._finished)
        out = [s.dump() for s in spans
               if trace_id is None or s.trace_id == trace_id]
        for d in out:
            d["service"] = self.service
        return out


def build_trees(span_dicts: List[Dict]) -> Dict[str, Dict]:
    """Assemble dumped spans (possibly from SEVERAL daemons' tracers)
    into per-trace trees for critical-path analysis.

    Returns ``{trace_id: {"roots": [span, ...]}}`` where each span
    dict gains a ``"children"`` list.  Spans whose parent was sampled
    away on another daemon surface as additional roots rather than
    being dropped — a partial tree still attributes time.
    """
    trees: Dict[str, Dict] = {}
    by_id: Dict[tuple, Dict] = {}
    for s in span_dicts:
        s = dict(s, children=[])
        trees.setdefault(s["trace_id"], {"roots": []})
        by_id[(s["trace_id"], s["span_id"])] = s
    for key, s in by_id.items():
        parent = by_id.get((s["trace_id"], s["parent_id"])) \
            if s.get("parent_id") else None
        if parent is not None:
            parent["children"].append(s)
        else:
            trees[s["trace_id"]]["roots"].append(s)
    return trees


def slowest_child(span: Dict, name: Optional[str] = None) -> Optional[Dict]:
    """The child span (optionally filtered by name) with the largest
    duration — e.g. the slowest-shard ``ec_sub_write`` leg under a
    primary's ``osd_op`` span."""
    kids = [c for c in span.get("children", ())
            if name is None or c["name"] == name]
    if not kids:
        return None
    return max(kids, key=lambda c: c.get("duration_us", 0))
