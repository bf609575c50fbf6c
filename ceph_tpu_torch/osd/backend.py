"""PG storage-strategy seam: PGBackend + the logical mutation type.

Python-native equivalent of the reference's PGBackend (reference
src/osd/PGBackend.{h,cc}): the abstract strategy a PG uses to make an
object mutation durable across its acting set.  ``build_pg_backend``
switches on pool type exactly like the reference (PGBackend.cc:555-591):
replicated pools get ReplicatedBackend, erasure pools instantiate the
codec through the plugin registry and get ECBackend.

``Mutation`` is the framework's PGTransaction (reference
osd/PGTransaction.h): a *logical* description of one object's change —
data writes, delete, attr/omap updates — that each backend lowers to
per-shard ObjectStore transactions its own way (EC encodes chunks,
replication ships the whole thing).

The backend talks to its hosting PG through the narrow ``PGHost``
surface (the reference passes a Listener interface, PGBackend.h
``Listener``): identity, acting set, store handles, message send, and
log bookkeeping.  That seam is what lets the backends unit-test against
a fake host with no OSD daemon (SURVEY.md §4 tier 1/2).
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..msg.message import Message
from ..store.objectstore import GHObject, ObjectStore, Transaction
from .pglog import Eversion, LogEntry

# object_info xattr key (reference OI_ATTR "_")
OI_ATTR = "_"


@dataclass
class Mutation:
    """Logical single-object mutation (reference PGTransaction).

    ``writes`` are (offset, data) byte extents; ``truncate`` runs after
    writes when set; ``delete`` wipes the object; ``create`` asserts
    non-existence.  ``attrs`` maps name -> value (None removes);
    ``omap_set``/``omap_rm`` mutate the omap (replicated pools only —
    the reference returns ENOTSUP for omap on EC pools).
    """
    writes: List[Tuple[int, bytes]] = field(default_factory=list)
    truncate: Optional[int] = None
    delete: bool = False
    create: bool = False
    attrs: Dict[str, Optional[bytes]] = field(default_factory=dict)
    omap_set: Dict[str, bytes] = field(default_factory=dict)
    omap_rm: List[str] = field(default_factory=list)
    omap_clear: bool = False
    trace_id: int = 0               # blkin-style trace context (0=off)
    parent_span_id: int = 0         # primary's osd_op span (0=none)
    tracked_op: Optional[object] = None   # OpTracker TrackedOp handle
    client_msg: Optional[object] = None   # MOSDOp for hop stamping: the
    # backend stamps store_apply on it at the PRIMARY'S LOCAL store
    # commit, so the client waterfall splits local-store time from the
    # peer_ack_wait that follows (first-stamp-wins keeps it safe)
    # -- snapshot machinery (reference make_writeable, osd/snaps.py) --
    clone_to: Optional[str] = None  # COW the head to this oid FIRST
    clone_attrs: Dict[str, bytes] = field(default_factory=dict)
    rollback_from: Optional[str] = None   # replace head from this clone
    rollback_size: int = 0                # logical size after rollback
    snapset: Optional[bytes] = None       # SS_ATTR value for the target
    # (oid, SS, OI) for the snapdir companion created on delete; the
    # OI carries the snapdir's OWN logged version — snapdir create and
    # remove get log entries like any object, or peering's missing-set
    # bookkeeping diverges from the store under thrash
    snapdir_set: Optional[Tuple[str, bytes, bytes]] = None
    aux_remove: List[str] = field(default_factory=list)  # companions

    def is_data_op(self) -> bool:
        return bool(self.writes) or self.truncate is not None \
            or self.delete

    def append_only_at(self, size: int) -> bool:
        """True if every write begins at or beyond current object size
        (no RMW needed on an EC pool without overwrites)."""
        pos = size
        for off, data in self.writes:
            if off < pos:
                return False
            pos = max(pos, off + len(data))
        return True


@dataclass
class ObjectInfo:
    """Per-object metadata xattr (reference object_info_t, OI_ATTR):
    logical size + last mutating version; stored on every shard."""
    size: int = 0
    version: Eversion = (0, 0)

    def encode(self) -> bytes:
        import json
        return json.dumps({"size": self.size,
                           "version": list(self.version)}).encode()

    @classmethod
    def decode(cls, buf: bytes) -> "ObjectInfo":
        import json
        d = json.loads(buf.decode())
        return cls(size=d["size"], version=tuple(d["version"]))


class PGHost(abc.ABC):
    """What a backend needs from its PG (reference PGBackend::Listener)."""

    @property
    @abc.abstractmethod
    def whoami(self) -> int:
        """This OSD's id."""

    @property
    @abc.abstractmethod
    def pgid_str(self) -> str:
        """str(PGid) — shard-free pg name used in sub-op messages."""

    @property
    @abc.abstractmethod
    def own_shard(self) -> int:
        """This OSD's shard position in the acting set (-1 replicated)."""

    @property
    @abc.abstractmethod
    def store(self) -> ObjectStore:
        ...

    @property
    def coll(self) -> str:
        """This OSD's collection for the PG shard it holds."""
        return self.coll_of(self.own_shard)

    @abc.abstractmethod
    def coll_of(self, shard: int) -> str:
        """Collection name for a given shard position — str(SPGid);
        identical naming on every OSD, so sub-op transactions built by
        the primary apply verbatim on the target shard's store."""

    @property
    @abc.abstractmethod
    def epoch(self) -> int:
        """Current map epoch (stamped into sub-op messages)."""

    @abc.abstractmethod
    def acting_shards(self) -> List[Tuple[int, Optional[int]]]:
        """[(shard, osd_id-or-None)] for the current acting set.  For
        replicated pools shard is the index; osd None = hole."""

    @abc.abstractmethod
    def send_shard(self, osd: int, msg: Message) -> None:
        """Ship a sub-op message to a peer OSD (cluster messenger)."""

    def extra_recovery_sources(self, oid: str
                               ) -> List[Tuple[int, int]]:
        """Non-acting holders ((shard, osd) pairs) that can serve
        ``oid`` during recovery — post-split strays and migrated-away
        copies (reference MissingLoc tracks these via past intervals;
        here the PG records them from stray notifies)."""
        return []

    @abc.abstractmethod
    def prepare_log_txn(self, txn: Transaction,
                        log_entries: List[dict]) -> None:
        """Append the per-shard PG-log/info persistence ops for these
        wire-form log entries into ``txn`` (pgmeta omap writes)."""

    @abc.abstractmethod
    def on_local_commit(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` under the PG lock after a local store commit
        (completions re-enter the PG through its op queue)."""

    def ec_profile(self) -> Dict[str, str]:
        """The pool's erasure-code profile (EC pools only)."""
        raise NotImplementedError

    def note_object_recovered(self, oid: str, version) -> None:
        """A recovery push for ``oid`` committed locally: drop it from
        this shard's persistent missing set (reference
        recover_got / pg_missing_t::got).  Default no-op for fake
        hosts."""

    def trace_span(self, name: str, trace_id: int,
                   parent_id: int = 0):
        """Record a tracing span when the daemon traces (reference
        ZTracer::Trace threaded through sub-ops); None when off.
        Default no-op for fake hosts."""
        return None


class PGBackend(abc.ABC):
    """Abstract storage strategy (reference PGBackend.h)."""

    def __init__(self, host: PGHost):
        self.host = host
        self._next_tid = 0

    def new_tid(self) -> int:
        self._next_tid += 1
        return self._next_tid

    # -- primary-side API --------------------------------------------------
    @abc.abstractmethod
    def submit_transaction(self, oid: str, mutation: Mutation,
                           at_version: Eversion,
                           log_entries: List[LogEntry],
                           on_all_commit: Callable[[int], None]) -> None:
        """Make ``mutation`` durable on every acting shard; call
        ``on_all_commit(0)`` (under the PG lock) once all shards
        committed, or with -errno if the op cannot proceed (reference
        submit_transaction, ECBackend.cc:1483 /
        ReplicatedBackend::submit_transaction)."""

    @abc.abstractmethod
    def objects_read(self, oid: str, offset: int, length: int,
                     cb: Callable[[int, bytes], None],
                     trace=(0, 0), hop_msg=None) -> None:
        """Read a logical extent; EC reconstructs from shards.  cb gets
        (0, data) or (-errno, b"").  ``hop_msg`` (the client-facing
        MOSDOp, when the read serves one) collects the read-side hop
        ledger: read_queued / shard_read / decode windows (reference
        objects_read_and_reconstruct, ECBackend.cc:2345)."""

    @abc.abstractmethod
    def recover_object(self, oid: str, version: Eversion,
                       missing_on: List[Tuple[int, int]],
                       cb: Callable[[int], None]) -> None:
        """Rebuild ``oid`` on the (shard, osd) pairs missing it; cb(0)
        when all pushes are acked (reference recover_object /
        continue_recovery_op, ECBackend.cc:570-736)."""

    # -- both-sides message entry -----------------------------------------
    @abc.abstractmethod
    def handle_message(self, msg: Message) -> bool:
        """Dispatch a backend sub-op message; True if consumed
        (reference PGBackend::handle_message)."""

    @abc.abstractmethod
    def on_change(self) -> None:
        """Acting set changed (new interval): drop in-flight ops; the
        clients will resend (reference on_change)."""

    def inflight_writes(self) -> int:
        """Writes submitted but not yet fully committed — scrub waits
        for zero before snapshotting (reference scrubber write
        blocking)."""
        return 0

    def build_scrub_map(self, deep: bool) -> Dict[str, dict]:
        """Per-object consistency snapshot of this OSD's local shard
        (reference ScrubMap built in PGBackend::be_scan_list +
        be_deep_scrub): oid -> {size, oi_version, and under deep:
        data_crc/omap_crc/attrs_crc (replicated,
        ReplicatedBackend.cc:614) or shard data_crc vs the stored
        HashInfo crc (EC, ECBackend.cc:2475)}."""
        raise NotImplementedError

    # -- local object metadata helpers ------------------------------------
    def get_object_info(self, oid: str,
                        shard: Optional[int] = None
                        ) -> Optional[ObjectInfo]:
        """OI xattr of the local copy; ``shard`` overrides own_shard
        (EC shard-side paths touching another shard's collection)."""
        s = self.host.own_shard if shard is None else shard
        obj = GHObject(oid, s)
        try:
            return ObjectInfo.decode(self.host.store.getattr(
                self.host.coll_of(s), obj, OI_ATTR))
        except (FileNotFoundError, KeyError):
            return None

    def list_objects(self) -> List[str]:
        try:
            return sorted({o.oid for o in self.host.store.
                           collection_list(self.host.coll)})
        except FileNotFoundError:
            # collection purged under us (stray removal racing a map
            # advance): an empty listing, not a crash in the map pump
            return []


def build_pg_backend(host: PGHost, pool, ec_registry):
    """reference PGBackend::build_pg_backend (PGBackend.cc:555-591):
    replicated -> ReplicatedBackend; erasure -> registry factory for the
    pool's profile + ECBackend with the pool's stripe_width."""
    from ..osd.osdmap import POOL_TYPE_ERASURE
    if pool.type == POOL_TYPE_ERASURE:
        from .ecbackend import ECBackend
        profile = dict(host.ec_profile())     # host supplies profile map
        plugin = profile.pop("plugin", "jerasure")
        ec_impl = ec_registry.factory(plugin, profile)
        return ECBackend(host, ec_impl, pool.stripe_width,
                         allows_overwrites=pool.ec_overwrites)
    from .replicatedbackend import ReplicatedBackend
    return ReplicatedBackend(host)
