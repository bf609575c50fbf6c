"""crimson — a reactor-based OSD fast path.

Python-native analog of the reference's Seastar-based Crimson OSD
(reference src/crimson/: crimson-osd runs the data path on a
shared-nothing reactor instead of the classic OSD's lock/queue/thread
machinery).  Here one event-loop thread per OSD runs the whole client
data path — non-blocking messenger reads, frame decode, PG dispatch,
EC encode submission and commit continuations — as futures and
callbacks, with no per-op threads and no queue hops between them.

    from ceph_tpu_torch.crimson import CrimsonOSD   # osd_backend=crimson
"""
from .osd import CrimsonOSD
from .reactor import Future, Reactor

__all__ = ["CrimsonOSD", "Future", "Reactor"]
