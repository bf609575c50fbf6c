"""Full-payload copy accounting for the hot write/read data path.

The zero-copy rework (zero-copy striper/messenger/ecbackend/batcher)
leaves a small number of *intentional* materialisation points — e.g.
the single gather of a strided shard column into contiguous memory, or
the join feeding a compressor.  Each such point calls
``note_copy(nbytes, site)`` so that:

  * regression tests can pin a per-write copy budget (a new copy on
    the hot path fails the suite instead of silently landing), and
  * bench.py can attribute bytes-copied per stage alongside MB/s.

Deliberately tiny: one lock, two counters, a per-site breakdown.
The overhead is nanoseconds against the multi-KiB copies it counts.
"""
from __future__ import annotations

import threading
from typing import Dict

_lock = threading.Lock()
_copies = 0
_bytes = 0
_sites: Dict[str, list] = {}


def note_copy(nbytes: int, site: str = "") -> None:
    """Record one full-payload copy of ``nbytes`` at ``site``."""
    global _copies, _bytes
    with _lock:
        _copies += 1
        _bytes += int(nbytes)
        rec = _sites.get(site)
        if rec is None:
            _sites[site] = [1, int(nbytes)]
        else:
            rec[0] += 1
            rec[1] += int(nbytes)


def reset() -> None:
    global _copies, _bytes
    with _lock:
        _copies = 0
        _bytes = 0
        _sites.clear()


def snapshot() -> dict:
    """-> {"copies", "bytes", "sites": {site: {"copies", "bytes"}}}."""
    with _lock:
        return {
            "copies": _copies,
            "bytes": _bytes,
            "sites": {k: {"copies": v[0], "bytes": v[1]}
                      for k, v in _sites.items()},
        }
