"""RGW multisite: zone-to-zone object sync.

Python-native equivalent of the reference's multisite machinery
(reference ``src/rgw/rgw_data_sync.cc`` + rgw_sync.cc metadata sync),
reduced to its operational core: a secondary-zone agent PULLS from
the master zone —

* **metadata sync**: buckets (with their ACL/versioning/lifecycle
  configuration) appear at the secondary as they appear at the
  master (reference metadata sync replicating bucket entrypoints);
* **full sync** on first contact per bucket: every current object
  copies over (reference RGWDataSyncCR full-sync state);
* **incremental sync** afterwards: the per-bucket datalog written by
  the gateway at each mutation (gateway._datalog — the reference's
  bucket index log) names the keys that changed; the agent re-reads
  each key's CURRENT state from the master and converges the
  secondary to it (copy or delete).  Syncing current state keyed by
  name makes replay idempotent and order-tolerant, exactly the
  property the reference's sync relies on;
* consumed datalog rows are trimmed (reference datalog trim once
  every zone has them).

Like the reference, replication is asynchronous and eventually
consistent; versioned buckets converge on the CURRENT version (the
noncurrent history is site-local — the reference syncs olh state
with more machinery than this framework carries).
"""
from __future__ import annotations

import json
from typing import Dict

from ..client.rados import RadosError
from .gateway import RGWError, RGWService, _datalog_oid


def _sync_marker_oid(bucket: str) -> str:
    return f"rgw.sync.{len(bucket)}.{bucket}"


class ZoneSyncAgent:
    """Pull-replicates the master zone's buckets into this zone
    (reference RGWDataSyncProcessorThread, drivable step-wise)."""

    def __init__(self, master: RGWService, local: RGWService):
        self.master = master
        self.local = local

    # -- markers -------------------------------------------------------
    def _marker(self, bucket: str) -> str:
        try:
            return json.loads(self.local.ioctx.read(
                _sync_marker_oid(bucket)).decode()).get("marker", "")
        except (RadosError, ValueError):
            return ""

    def _set_marker(self, bucket: str, marker: str) -> None:
        self.local.ioctx.write_full(
            _sync_marker_oid(bucket),
            json.dumps({"marker": marker}).encode())

    # -- one key -------------------------------------------------------
    def _converge_key(self, bucket: str, key: str) -> str:
        """Make the local CURRENT state of ``key`` match the
        master's; -> "copied" | "deleted" | "noop"."""
        try:
            head, data = self.master.get_object(bucket, key)
        except RGWError:
            head = None
        try:
            local_head = self.local.head_object(bucket, key)
        except RGWError:
            local_head = None
        if head is None:
            if local_head is None:
                return "noop"
            try:
                self.local.delete_object(bucket, key)
            except RGWError:
                pass
            return "deleted"
        if local_head is not None and \
                local_head.get("etag") == head.get("etag"):
            return "noop"
        self.local.put_object(
            bucket, key, data,
            content_type=head.get("content_type",
                                  "binary/octet-stream"),
            meta=head.get("meta") or {},
            acl=head.get("acl", "private"),
            owner=head.get("owner", ""))
        return "copied"

    # -- one bucket ----------------------------------------------------
    def sync_bucket(self, bucket: str, bmeta: Dict) -> Dict:
        stats = {"copied": 0, "deleted": 0, "full": False}
        # metadata sync: bucket + its configuration converge first
        try:
            self.local.create_bucket(bucket,
                                     owner=bmeta.get("owner", ""),
                                     acl=bmeta.get("acl", "private"))
        except RGWError:
            pass                         # exists: converge config
        lmeta = self.local._bucket_meta(bucket)
        changed = False
        for fld in ("acl", "owner", "versioning", "lifecycle"):
            if fld in bmeta and lmeta.get(fld) != bmeta[fld]:
                lmeta[fld] = bmeta[fld]
                changed = True
        if changed:
            self.local._set_bucket_meta(bucket, lmeta)
        marker = self._marker(bucket)
        if not marker:
            # full sync: walk the master's current listing; the
            # datalog position is noted FIRST so mutations racing the
            # walk replay incrementally next pass
            stats["full"] = True
            log = self._datalog_rows(bucket)
            top = max(log, default="")
            listing = self.master.list_objects(bucket,
                                               max_keys=1 << 30)
            for obj in listing["contents"]:
                if self._converge_key(bucket, obj["key"]) == "copied":
                    stats["copied"] += 1
            self._set_marker(bucket, top or "0")
            return stats
        log = self._datalog_rows(bucket)
        done = marker
        keys = []
        seen = set()
        for row in sorted(log):
            if row <= marker:
                continue
            k = log[row]["key"]
            if k not in seen:
                seen.add(k)
                keys.append(k)
            done = max(done, row)
        for k in keys:
            verdict = self._converge_key(bucket, k)
            if verdict in ("copied", "deleted"):
                stats[verdict] += 1
        if done != marker:
            self._set_marker(bucket, done)
            # trim consumed rows at the master (reference datalog
            # trim; single-peer zonegroup, so consumed = trimmable)
            try:
                self.master.ioctx.omap_rm_keys(
                    _datalog_oid(bucket),
                    [r for r in log if r <= done])
            except RadosError:
                pass
        return stats

    def _datalog_rows(self, bucket: str) -> Dict[str, dict]:
        try:
            omap = self.master.ioctx.omap_get(_datalog_oid(bucket))
        except RadosError:
            return {}
        out = {}
        for row, raw in omap.items():
            try:
                out[row] = json.loads(raw.decode())
            except ValueError:
                continue
        return out

    # -- the zone ------------------------------------------------------
    def sync_once(self) -> Dict[str, Dict]:
        out = {}
        for bmeta in self.master.list_buckets():
            try:
                out[bmeta["name"]] = self.sync_bucket(bmeta["name"],
                                                      bmeta)
            except (RGWError, RadosError) as e:
                out[bmeta["name"]] = {"error": str(e)}
        return out
