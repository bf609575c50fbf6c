"""RBD mirroring: journal-based one-way image replication.

Python-native equivalent of the reference's rbd-mirror daemon
(reference ``src/tools/rbd_mirror/Mirror.cc`` + ImageReplayer +
ImageSync): images whose header marks them mirroring-enabled PRIMARY
replicate to a peer pool/cluster by

* **bootstrap** (reference ImageSync): first contact creates the
  peer image non-primary and deep-copies the current data objects;
* **journal replay** (reference ImageReplayer): afterwards the
  primary's write journal IS the replication stream — entries past
  the secondary's sync position are re-applied in order (the journal
  events are plain (offset, data) records, idempotent to re-apply),
  and the secondary's position is pushed back to the primary
  (``rbd_mirror.<name>.peer``) where it gates journal trimming
  exactly like a reference journal client's committed position.

Failover is ``mirror_demote()`` at the old primary + ``promote()``
here (reference rbd mirror image promote/demote): non-primary images
refuse ordinary writes, so a split brain needs a forced promote on
both sides — same contract as the reference.

The daemon is site-B-resident and PULLS (like the reference's
rbd-mirror running at the secondary): it needs only read access to
the primary pool plus write access to the two mirror-position
objects.
"""
from __future__ import annotations

import base64
import json
from typing import Dict, Optional

from ..client.rados import IoCtx, RadosError
from .image import (RBD, Image, _header_oid, _journal_oid,
                    _mirror_peer_oid, _mirror_pos_oid)


class MirrorDaemon:
    """Replicates mirroring-enabled primaries from ``src`` to
    ``dst`` (two pools, possibly on two clusters)."""

    def __init__(self, src: IoCtx, dst: IoCtx):
        self.src = src
        self.dst = dst

    # -- positions -----------------------------------------------------
    def _synced_pos(self, name: str) -> int:
        try:
            return json.loads(self.dst.read(
                _mirror_pos_oid(name)).decode()).get("synced", 0)
        except (RadosError, ValueError):
            return 0

    def _record_pos(self, name: str, seq: int) -> None:
        body = json.dumps({"synced": seq}).encode()
        self.dst.write_full(_mirror_pos_oid(name), body)
        # tell the primary so it may trim its journal (reference:
        # the mirror peer's committed position)
        self.src.write_full(_mirror_peer_oid(name),
                            json.dumps({"committed": seq}).encode())

    def _journal_entries(self, name: str):
        try:
            raw = self.src.read(_journal_oid(name))
        except RadosError:
            return []
        out = []
        for line in raw.splitlines():
            if not line.strip():
                continue
            try:
                out.append(json.loads(line.decode()))
            except ValueError:
                continue
        return out

    # -- sync ----------------------------------------------------------
    def sync_image(self, name: str) -> Dict:
        """One replication pass for one image; -> stats."""
        hdr = json.loads(self.src.read(_header_oid(name)).decode())
        m = hdr.get("mirror") or {}
        if not m.get("enabled") or not m.get("primary", False):
            return {"skipped": True}
        stats = {"bootstrapped": False, "replayed": 0}
        dst_rbd = RBD(self.dst)
        if name not in dst_rbd.list():
            # note the journal top BEFORE the copy: entries at or
            # below it are covered by the full copy; later ones
            # replay on the next pass (re-applying a covered write is
            # harmless — events are absolute (offset, data))
            entries = self._journal_entries(name)
            top = max((e["seq"] for e in entries), default=0)
            dst_rbd.create(name, size=hdr["size"],
                           order=hdr["order"],
                           features=tuple(hdr.get("features", [])))
            dst_img = Image(self.dst, name)
            dst_img.header["mirror"] = {"enabled": True,
                                        "primary": False}
            dst_img._save_header()
            src_img = Image(self.src, name)
            osize = src_img.object_size
            for objno in range(src_img._n_objs()):
                data = src_img._read_object(objno)
                if data:
                    dst_img._apply_write(objno * osize, data)
            self._record_pos(name, top)
            stats["bootstrapped"] = True
            return stats
        dst_img = Image(self.dst, name)
        dm = dst_img.header.get("mirror") or {}
        if not dm.get("enabled"):
            # a same-name image that mirroring did NOT create: never
            # overwrite it (reference: the replayer requires a
            # mirror-registered peer image; anything else is an
            # operator conflict to resolve)
            return {"conflict": True}
        if dm.get("primary"):
            # both sides primary: split brain — refuse to overwrite
            # (reference flags the pair split-brained and waits for
            # an operator resync)
            return {"split_brain": True}
        stats["replayed"] = self._replay(name, dst_img, hdr)
        return stats

    def _replay(self, name: str, dst_img: Image, hdr: dict) -> int:
        """Incremental replay of the master journal into dst_img
        (shared by steady-state sync and promote's final catch-up so
        the two can never diverge); -> events applied."""
        synced = self._synced_pos(name)
        top = synced
        applied = 0
        for ev in sorted(self._journal_entries(name),
                         key=lambda e: e["seq"]):
            if ev["seq"] <= synced:
                continue
            if "resize" in ev:
                # object-level resize replay: shrink must shed the
                # secondary's truncated objects, not just the header
                # size, or a later grow re-exposes stale bytes
                dst_img._apply_resize(ev["resize"])
            else:
                dst_img._apply_write(ev["off"],
                                     base64.b64decode(ev["data"]))
            top = max(top, ev["seq"])
            applied += 1
        if dst_img.header["size"] != hdr["size"]:
            # drift safety net (resize that predates mirroring or a
            # trimmed journal): correct at the object level too
            dst_img._apply_resize(hdr["size"])
        if top != synced:
            self._record_pos(name, top)
        return applied

    def sync_once(self) -> Dict[str, Dict]:
        """One pass over every image at the primary site (the
        reference daemon's continuous replay loop, collapsed to a
        drivable step for tests/cron)."""
        out = {}
        for name in RBD(self.src).list():
            try:
                out[name] = self.sync_image(name)
            except RadosError as e:
                out[name] = {"error": str(e)}
        return out

    # -- failover ------------------------------------------------------
    def promote(self, name: str) -> None:
        """Promote the SECONDARY copy (reference rbd mirror image
        promote at the failover site): final journal catch-up, then
        flip primary.  The catch-up deliberately ignores the
        source's primary flag — the documented flow demotes the old
        primary FIRST, and its journal tail (writes the peer had not
        consumed at demotion) must drain here, not be lost."""
        try:
            hdr = json.loads(self.src.read(
                _header_oid(name)).decode())
        except RadosError:
            hdr = None               # old site gone: promote what we
                                     # have (disaster failover)
        if hdr is not None and (hdr.get("mirror") or {}).get(
                "enabled") and name in RBD(self.dst).list():
            dst_img = Image(self.dst, name)
            if (dst_img.header.get("mirror") or {}).get("enabled"):
                self._replay(name, dst_img, hdr)
        img = Image(self.dst, name)
        img.mirror_promote()

    def demote_primary(self, name: str) -> None:
        """Demote the source copy (failover step 1)."""
        Image(self.src, name).mirror_demote()
