"""RADOS object snapshots: SnapSet, clone naming, read resolution.

Python-native equivalent of the reference's snapshot metadata
(reference src/osd/osd_types.h ``SnapSet`` + the clone machinery of
``PrimaryLogPG::make_writeable``, src/osd/PrimaryLogPG.cc): every
logical object ("head") carries a SnapSet xattr describing which
snapshot-era clones exist; a write whose SnapContext seq is newer than
the SnapSet's clones the head first (COW at object granularity), then
mutates.  Clones are ordinary objects named ``oid@<snapid-hex>`` —
on EC pools the clone lowers to a per-shard store clone of each chunk
object, so snapshotting never re-encodes (zero device work; the
store's COW does the rest).

Read resolution (reference PrimaryLogPG::find_object_context):

* snapid covered by a clone's ``clone_snaps`` -> read that clone;
* snapid >= SnapSet.seq -> the head is unchanged since the snap, read
  head;
* otherwise the object did not exist at that snap (the first write
  after the snap would have cloned and covered it) -> ENOENT.

When the head is deleted while clones remain, its SnapSet moves to a
"snapdir" companion object (reference pre-octopus snapdir design) and
moves back on recreate.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

# SnapSet xattr key (reference SS_ATTR "snapset")
SS_ATTR = "ss_"
# head read / no snap context (reference CEPH_NOSNAP); 0 = head here
HEAD_SNAP = 0


def clone_oid(oid: str, snapid: int) -> str:
    return f"{oid}@{snapid:x}"


def snapdir_oid(oid: str) -> str:
    return f"{oid}@snapdir"


def is_snap_oid(oid: str) -> bool:
    return "@" in oid


def head_of(oid: str) -> str:
    """head oid of a clone/snapdir oid (identity for heads)."""
    return oid.split("@", 1)[0]


class SnapContext:
    """Client-provided write context (reference SnapContext): the
    newest snap id the writer has seen plus the still-live snap ids,
    newest first."""

    def __init__(self, seq: int = 0, snaps: Optional[List[int]] = None):
        self.seq = seq
        self.snaps = list(snaps or [])

    def __bool__(self) -> bool:
        return self.seq > 0


class SnapSet:
    """Per-object snapshot metadata xattr (reference SnapSet)."""

    def __init__(self) -> None:
        self.seq = 0                     # newest snapc seq seen at write
        self.clones: List[int] = []      # clone ids, ascending
        self.clone_snaps: Dict[int, List[int]] = {}
        self.clone_size: Dict[int, int] = {}

    # -- write-side (make_writeable) ----------------------------------
    def needs_clone(self, snapc: SnapContext) -> bool:
        """A head that exists must be cloned before this write mutates
        it iff the writer has seen a snap newer than our last clone
        era (reference make_writeable's snapc.seq > snapset.seq) AND
        some LIVE snap would actually be covered — a stale context
        whose newer snaps were all removed must not cut an orphan
        clone covering nothing (it could never be trimmed)."""
        return snapc.seq > self.seq and \
            any(s > self.seq for s in snapc.snaps)

    def add_clone(self, snapc: SnapContext, head_size: int) -> int:
        """Record the COW clone for this write; returns the clone id
        (the snapc seq, like the reference's coid snap)."""
        cid = snapc.seq
        covered = sorted(s for s in snapc.snaps if s > self.seq)
        self.clones.append(cid)
        self.clones.sort()
        self.clone_snaps[cid] = covered
        self.clone_size[cid] = head_size
        self.seq = snapc.seq
        return cid

    def advance_seq(self, snapc: SnapContext) -> None:
        """Write over a non-existent/new head: no clone, but the era
        still advances so later snap reads resolve existence right."""
        self.seq = max(self.seq, snapc.seq)

    # -- read-side (find_object_context) ------------------------------
    def resolve_read(self, snapid: int) -> Tuple[str, Optional[int]]:
        """-> ("head", None) | ("clone", clone_id) | ("enoent", None).
        Strictly ``snapid > seq`` serves the head (reference
        find_object_context): an uncovered snapid <= seq means the
        object did not exist when that snap was taken (its creating
        write already carried a snapc at least that new, and a
        surviving pre-snap state would have been cloned)."""
        for cid in self.clones:
            if snapid in self.clone_snaps.get(cid, ()):
                return "clone", cid
        if snapid > self.seq:
            return "head", None
        return "enoent", None

    # -- trim ----------------------------------------------------------
    def trim(self, removed: set) -> List[int]:
        """Drop removed snap ids; returns clone ids left covering
        nothing (to be deleted by the trimmer)."""
        gone: List[int] = []
        for cid in list(self.clones):
            kept = [s for s in self.clone_snaps.get(cid, [])
                    if s not in removed]
            if kept:
                self.clone_snaps[cid] = kept
            else:
                self.clones.remove(cid)
                self.clone_snaps.pop(cid, None)
                self.clone_size.pop(cid, None)
                gone.append(cid)
        return gone

    @property
    def empty(self) -> bool:
        return not self.clones

    # -- wire ----------------------------------------------------------
    def encode(self) -> bytes:
        return json.dumps({
            "seq": self.seq, "clones": self.clones,
            "clone_snaps": {str(c): s
                            for c, s in self.clone_snaps.items()},
            "clone_size": {str(c): s
                           for c, s in self.clone_size.items()},
        }).encode()

    @classmethod
    def decode(cls, buf: bytes) -> "SnapSet":
        d = json.loads(buf.decode())
        ss = cls()
        ss.seq = d["seq"]
        ss.clones = list(d["clones"])
        ss.clone_snaps = {int(c): list(s)
                          for c, s in d["clone_snaps"].items()}
        ss.clone_size = {int(c): int(s)
                         for c, s in d["clone_size"].items()}
        return ss
