"""Per-OSD flight recorder: a fixed-size ring of recent data-path
decisions, kept cheap enough to run always-on.

A cluster regression with every encode request silently misrouted
to the CPU twin leaves its evidence only in aggregate counters, with no record of WHICH routing decisions
were made, WHY, or what the breaker/timer machinery did around them.
The recorder answers that forensically: every routing verdict,
breaker transition, staging stall, late timer fire, sub-write timeout
and encode error appends one small event to a bounded ring
(``collections.deque(maxlen=N)`` — appends are atomic under the GIL,
so the hot path takes no lock), and the ring is dumped

- on demand through the ``dump_flight_recorder`` admin-socket /
  ``ceph tell`` command, and
- automatically (rate-limited) when something goes wrong: a sub-write
  deadline fires, the device circuit breaker opens, or a client op
  dies with an encode error.

This is the black-box-recorder idiom of the reference's
``ceph daemon <osd> dump_recent_ops`` + kernel flight recorders: the
LAST few hundred events before an incident matter far more than a
complete history.
"""
from __future__ import annotations

import json
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional


class FlightRecorder:
    """Lock-light bounded event ring.

    ``note()`` is the hot-path API: one monotonic clock read, one
    tuple build, one thread-safe deque append — no lock, no string
    formatting (fields are formatted only at dump time).  ``dump()``
    snapshots the ring oldest-first.  ``auto_dump()`` prints the ring
    to stderr for incident triage, rate-limited so an error storm
    cannot turn the recorder itself into the bottleneck.
    """

    def __init__(self, capacity: int = 256, name: str = "",
                 auto_dump_interval_s: float = 5.0):
        self.name = name
        self.capacity = int(capacity)
        self._ring: "deque" = deque(maxlen=self.capacity)
        self._seq = 0
        self.auto_dump_interval_s = float(auto_dump_interval_s)
        self._last_auto_dump = 0.0
        self.auto_dumps = 0          # triggers that actually printed
        self.auto_dump_suppressed = 0
        self._dump_lock = threading.Lock()

    # -- hot path ----------------------------------------------------
    def note(self, kind: str, /, **fields) -> None:
        """Append one event.  ``kind`` is a short category
        ("route", "breaker", "staging", "timer", "subwrite",
        "encode_error", "fault", ...); fields are kept as-is."""
        self._seq += 1               # benign race: seq is advisory
        self._ring.append(
            (time.time(), time.monotonic(), self._seq, kind, fields))

    # -- dump surfaces -----------------------------------------------
    def dump(self) -> List[Dict]:
        """Snapshot oldest-first (admin socket shape)."""
        return [{**fields, "time": wall, "mono": mono, "seq": seq,
                 "kind": kind}
                for wall, mono, seq, kind, fields in list(self._ring)]

    def dump_state(self) -> Dict:
        return {"name": self.name, "capacity": self.capacity,
                "recorded": self._seq,
                "auto_dumps": self.auto_dumps,
                "auto_dump_suppressed": self.auto_dump_suppressed,
                "events": self.dump()}

    def auto_dump(self, reason: str, out=None) -> bool:
        """Dump the ring to ``out`` (stderr) tagged with ``reason``.
        Returns True when a dump was printed, False when the rate
        limiter suppressed it (the triggering EVENT is still in the
        ring either way)."""
        now = time.monotonic()
        with self._dump_lock:
            if now - self._last_auto_dump < self.auto_dump_interval_s:
                self.auto_dump_suppressed += 1
                return False
            self._last_auto_dump = now
            self.auto_dumps += 1
            events = self.dump()
        out = out if out is not None else sys.stderr
        try:
            print(f"# flight-recorder auto-dump [{self.name}] "
                  f"reason={reason} events={len(events)}",
                  file=out, flush=True)
            for ev in events[-64:]:  # incident tail: last 64 events
                print("#   " + json.dumps(ev, default=str), file=out)
            out.flush()
        except Exception:
            pass                     # a dead stderr must not raise
        return True


# A process-global recorder for call sites with no OSD plumbing (the
# class-level breaker in EncodeBatcher, library-level helpers).  OSDs
# own their per-daemon recorder; this one catches everything else.
_global: Optional[FlightRecorder] = None
_global_lock = threading.Lock()


def global_recorder() -> FlightRecorder:
    global _global
    if _global is None:
        with _global_lock:
            if _global is None:
                _global = FlightRecorder(name="process")
    return _global
