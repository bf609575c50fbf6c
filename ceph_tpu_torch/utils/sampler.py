"""Always-on wall-clock stack sampler (flamegraph-folded output).

One process-wide daemon thread wakes at ``hz`` and snapshots every
thread's Python stack via ``sys._current_frames()`` — the classic
low-overhead wall-clock profiler shape (py-spy/austin lineage, in
process because the vstart cluster IS one process).  Samples fold into
``thread-name;outer;...;leaf -> count`` strings, the flamegraph.pl
folded format, so ``dump_profile`` output pipes straight into standard
tooling.

Daemon attribution rides on thread names: OSD worker threads are
already named ``osd{N}-...``, so a per-daemon profile is a prefix
filter over the folded keys.  Lifetime is refcounted — every daemon
that wants profiling ``retain()``s on start and ``release()``s on
shutdown; the sampling thread exists only while someone holds a
reference, which is what makes "no leaked threads after cluster
teardown" testable.

Cost model: one pass is ~O(threads x depth) dict/string work, a few
tens of microseconds; at the default ~67 Hz that is well under 1% of
one core, and the guard test pins measured per-pass cost x hz <= 3%.
"""
from __future__ import annotations

import sys
import threading
from typing import Dict, List, Optional, Tuple

_MAX_DEPTH = 48          # frames kept per stack (outermost dropped)
_MAX_STACKS = 20_000     # distinct folded stacks kept (then "(other)")

SAMPLER_THREAD_NAME = "stack-sampler"


class StackSampler:
    def __init__(self, hz: float = 67.0):
        self.hz = hz
        self._lock = threading.Lock()
        self._folded: Dict[str, int] = {}
        self._refs = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.samples = 0          # sampling passes completed

    # -- lifecycle (refcounted) ----------------------------------------
    def retain(self) -> None:
        with self._lock:
            self._refs += 1
            if self._thread is None and self.hz > 0:
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, name=SAMPLER_THREAD_NAME,
                    daemon=True)
                self._thread.start()

    def release(self) -> None:
        with self._lock:
            self._refs = max(0, self._refs - 1)
            if self._refs > 0:
                return
            t, self._thread = self._thread, None
            self._stop.set()
        if t is not None:
            t.join(timeout=2.0)

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _run(self) -> None:
        period = 1.0 / self.hz if self.hz > 0 else 0.1
        stop = self._stop
        while not stop.wait(period):
            try:
                self.sample_once()
            except Exception:
                pass              # a racing thread teardown is fine

    # -- sampling ------------------------------------------------------
    def sample_once(self) -> None:
        """One snapshot of every thread but our own."""
        names = {t.ident: t.name for t in threading.enumerate()}
        me = threading.get_ident()
        frames = sys._current_frames()
        folded: List[str] = []
        for tid, frame in frames.items():
            if tid == me:
                continue
            parts: List[str] = []
            f = frame
            while f is not None and len(parts) < _MAX_DEPTH:
                code = f.f_code
                parts.append(getattr(code, "co_qualname", code.co_name))
                f = f.f_back
            parts.reverse()
            folded.append(names.get(tid, f"tid-{tid}")
                          + ";" + ";".join(parts))
        with self._lock:
            self.samples += 1
            d = self._folded
            for key in folded:
                if key in d:
                    d[key] += 1
                elif len(d) < _MAX_STACKS:
                    d[key] = 1
                else:
                    d["(other)"] = d.get("(other)", 0) + 1

    # -- output --------------------------------------------------------
    def dump_folded(self, prefix: Optional[str] = None) -> List[str]:
        """Flamegraph-folded lines ("stack count"), hottest first,
        optionally restricted to threads whose name starts with
        ``prefix`` (= one daemon's threads)."""
        with self._lock:
            items = list(self._folded.items())
        if prefix:
            items = [(k, v) for k, v in items if k.startswith(prefix)]
        items.sort(key=lambda kv: -kv[1])
        return [f"{k} {v}" for k, v in items]

    def top_self_time(self, prefix: Optional[str] = None,
                      n: int = 5) -> List[Tuple[str, int]]:
        """Top-N leaf functions by sample count (self time)."""
        with self._lock:
            items = list(self._folded.items())
        agg: Dict[str, int] = {}
        for key, count in items:
            if prefix and not key.startswith(prefix):
                continue
            leaf = key.rsplit(";", 1)[-1]
            agg[leaf] = agg.get(leaf, 0) + count
        return sorted(agg.items(), key=lambda kv: -kv[1])[:n]

    def reset(self) -> None:
        with self._lock:
            self._folded.clear()
            self.samples = 0


_global: Optional[StackSampler] = None
_global_lock = threading.Lock()


def global_sampler(hz: Optional[float] = None) -> StackSampler:
    """The process-wide sampler.  ``hz`` (re)configures the rate when
    given; rate changes apply from the next retain-start."""
    global _global
    with _global_lock:
        if _global is None:
            _global = StackSampler(hz=hz if hz is not None else 67.0)
        elif hz is not None:
            _global.hz = hz
        return _global
