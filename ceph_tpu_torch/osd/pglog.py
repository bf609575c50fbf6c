"""Per-PG write-ahead log and missing-set tracking.

Python-native equivalent of the reference's PGLog (reference
src/osd/PGLog.{h,cc}) reduced to the machinery the framework's peering
and recovery actually consume:

* ``eversion`` — (epoch, version) ordered pair (reference eversion_t);
* ``LogEntry`` — one logged mutation: MODIFY / DELETE / ERROR with the
  object, its new version and the version it superseded (reference
  pg_log_entry_t);
* ``PGLog`` — bounded ordered log with ``last_update``/``tail``,
  omap persistence (the reference stores log entries in the pgmeta
  object's omap), and the two peering primitives:
  - ``entries_since(v)``: the catch-up slice a lagging shard needs;
  - ``merge_authoritative(entries, on_missing)``: apply the primary's
    authoritative log; entries beyond our head mark their objects
    missing (need recovery), entries we have beyond the authoritative
    head are divergent and roll back to missing at the authoritative
    version (the reference's rewind_divergent_log; EC shards roll back
    divergent writes — doc/dev/osd_internals/erasure_coding/
    ecbackend.rst:10-27);
* ``MissingSet`` — oid -> (need, have) (reference pg_missing_t).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

Eversion = Tuple[int, int]          # (epoch, version), ordered
EVERSION_ZERO: Eversion = (0, 0)

MODIFY = "modify"
DELETE = "delete"
ERROR = "error"                     # logged failed op (reference ERROR)


@dataclass
class LogEntry:
    """reference pg_log_entry_t (osd/osd_types.h).  ``reqid`` is the
    originating client op id (client name, client tid) — the dup-
    detection key (reference osd_reqid_t / pg_log_dup_t): a client
    resending after an interval change must not re-apply a mutation
    that already committed."""
    op: str
    oid: str
    version: Eversion
    prior_version: Eversion = EVERSION_ZERO
    reqid: Optional[Tuple[str, int]] = None

    def to_dict(self) -> dict:
        d = {"op": self.op, "oid": self.oid,
             "version": list(self.version),
             "prior_version": list(self.prior_version)}
        if self.reqid is not None:
            d["reqid"] = [self.reqid[0], self.reqid[1]]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "LogEntry":
        r = d.get("reqid")
        return cls(op=d["op"], oid=d["oid"],
                   version=tuple(d["version"]),
                   prior_version=tuple(d["prior_version"]),
                   reqid=(r[0], int(r[1])) if r else None)

    def is_delete(self) -> bool:
        return self.op == DELETE

    def is_error(self) -> bool:
        return self.op == ERROR


class MissingSet:
    """oid -> (need, have); have is None when the shard has no usable
    version at all (reference pg_missing_t item.have = 0'0)."""

    def __init__(self) -> None:
        self.items: Dict[str, Tuple[Eversion, Optional[Eversion]]] = {}

    def add(self, oid: str, need: Eversion,
            have: Optional[Eversion]) -> None:
        self.items[oid] = (need, have)

    def rm(self, oid: str) -> None:
        self.items.pop(oid, None)

    def is_missing(self, oid: str) -> bool:
        return oid in self.items

    def got(self, oid: str, version: Eversion) -> None:
        """Recovery delivered ``oid`` at ``version``."""
        need, _ = self.items.get(oid, (None, None))
        if need is not None and version >= need:
            del self.items[oid]

    def num_missing(self) -> int:
        return len(self.items)

    def __iter__(self):
        return iter(sorted(self.items))

    def to_dict(self) -> dict:
        return {oid: {"need": list(need),
                      "have": list(have) if have else None}
                for oid, (need, have) in self.items.items()}

    @classmethod
    def from_dict(cls, d: dict) -> "MissingSet":
        ms = cls()
        for oid, item in d.items():
            ms.add(oid, tuple(item["need"]),
                   tuple(item["have"]) if item["have"] else None)
        return ms


class PGLog:
    """Bounded ordered log (reference PGLog / IndexedLog)."""

    DEFAULT_MAX_ENTRIES = 3000   # reference osd_min_pg_log_entries class

    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES):
        self.entries: List[LogEntry] = []
        self.last_update: Eversion = EVERSION_ZERO
        self.tail: Eversion = EVERSION_ZERO   # versions <= tail trimmed
        self.max_entries = max_entries
        # dup detection (reference pg_log_dup_t index)
        self.reqids: Dict[Tuple[str, int], Eversion] = {}

    # -- write path -------------------------------------------------------
    def add(self, entry: LogEntry) -> None:
        assert entry.version > self.last_update, \
            f"log entry {entry.version} <= head {self.last_update}"
        self.entries.append(entry)
        self.last_update = entry.version
        if entry.reqid is not None:
            self.reqids[entry.reqid] = entry.version
        self._trim()

    def has_reqid(self, client: str, tid: int) -> Optional[Eversion]:
        """Version of an already-applied client op, or None (reference
        PGLog::get_request dup detection)."""
        return self.reqids.get((client, tid))

    def _trim(self) -> None:
        if len(self.entries) > self.max_entries:
            cut = len(self.entries) - self.max_entries
            for e in self.entries[:cut]:
                if e.reqid is not None:
                    self.reqids.pop(e.reqid, None)
            self.tail = self.entries[cut - 1].version
            self.entries = self.entries[cut:]

    def trim_to(self, n: int) -> None:
        """Trim to at most ``n`` entries — the clean-PG trim
        (reference osd_min_pg_log_entries: a clean PG keeps only the
        minimum; the max bound applies while degraded)."""
        if len(self.entries) > n:
            keep, self.max_entries = self.max_entries, n
            self._trim()
            self.max_entries = keep

    # -- peering primitives ----------------------------------------------
    def entries_since(self, v: Eversion) -> Optional[List[LogEntry]]:
        """Entries with version > v, or None if v < tail (log no longer
        reaches back that far — the shard needs backfill instead of
        log-based recovery; reference calc_recovery_type)."""
        if v < self.tail:
            return None
        return [e for e in self.entries if e.version > v]

    def merge_authoritative(
            self, auth_entries: List[LogEntry],
            auth_head: Eversion,
            mark_missing: Callable[[str, Eversion, Optional[Eversion]],
                                   None],
            mark_divergent: Callable[[str, Eversion], None]) -> None:
        """Adopt the authoritative log slice from the primary.

        ``auth_entries`` are the authoritative entries after our
        (possibly divergent) head's common ancestor; entries of ours
        newer than ``auth_head`` are divergent and reported via
        ``mark_divergent`` (the shard's copy of those objects must be
        rolled back / re-recovered).  New entries report via
        ``mark_missing(oid, need, have)``.
        """
        # divergent suffix: our entries beyond the authoritative head.
        # Per object, only the OLDEST divergent entry's prior_version is
        # a valid rollback target (later entries' priors are themselves
        # divergent), so report one rollback per oid.
        divergent = [e for e in self.entries if e.version > auth_head]
        self.entries = [e for e in self.entries
                        if e.version <= auth_head]
        for e in divergent:
            if e.reqid is not None:
                self.reqids.pop(e.reqid, None)
        if self.last_update > auth_head:
            self.last_update = auth_head
        seen_divergent = set()
        for e in divergent:
            if e.oid not in seen_divergent:
                seen_divergent.add(e.oid)
                mark_divergent(e.oid, e.prior_version)

        # 'have' is what this shard actually applied (our own log is
        # written atomically with data), NOT versions merely merged in
        # below — multiple auth entries for one oid must all report the
        # same true local version (last mark_missing wins with the
        # final 'need')
        applied = {e.oid: e.version for e in self.entries}
        for e in auth_entries:
            if e.version <= self.last_update:
                continue
            if not e.is_error():
                mark_missing(e.oid, e.version, applied.get(e.oid))
            self.entries.append(e)
            if e.reqid is not None:
                self.reqids[e.reqid] = e.version
            self.last_update = e.version
        self._trim()

    def split_out(self, moved: "set") -> "PGLog":
        """PG split (reference PGLog::split_out_child): return a child
        log holding this log's entries for ``moved`` oids and strip
        them here.  Both logs keep the SAME head/tail so every replica
        of the parent produces identical child logs, making child
        peering elections trivial, and reqid dup-detection for recent
        writes to moved objects survives the split."""
        child = PGLog(self.max_entries)
        child.last_update = self.last_update
        child.tail = self.tail
        child.entries = [e for e in self.entries if e.oid in moved]
        for e in child.entries:
            if e.reqid is not None:
                child.reqids[e.reqid] = e.version
                self.reqids.pop(e.reqid, None)
        self.entries = [e for e in self.entries if e.oid not in moved]
        return child

    def object_versions(self) -> Dict[str, Eversion]:
        """Latest in-log version per live object (deletes excluded)."""
        out: Dict[str, Eversion] = {}
        for e in self.entries:
            if e.is_error():
                continue
            if e.is_delete():
                out.pop(e.oid, None)
            else:
                out[e.oid] = e.version
        return out

    # -- persistence (reference: pgmeta object omap) ----------------------
    def to_dict(self) -> dict:
        return {"last_update": list(self.last_update),
                "tail": list(self.tail),
                "entries": [e.to_dict() for e in self.entries]}

    @classmethod
    def from_dict(cls, d: dict,
                  max_entries: int = DEFAULT_MAX_ENTRIES) -> "PGLog":
        log = cls(max_entries)
        log.last_update = tuple(d["last_update"])
        log.tail = tuple(d["tail"])
        log.entries = [LogEntry.from_dict(e) for e in d["entries"]]
        for e in log.entries:
            if e.reqid is not None:
                log.reqids[e.reqid] = e.version
        return log

    def encode(self) -> bytes:
        return json.dumps(self.to_dict()).encode()

    @classmethod
    def decode(cls, buf: bytes) -> "PGLog":
        return cls.from_dict(json.loads(buf.decode()))
