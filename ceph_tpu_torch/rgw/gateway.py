"""Object gateway core: buckets + objects over RADOS.

Python-native equivalent of the reference's RGW data layer (reference
``src/rgw/`` 182.6k LoC reduced to the S3 essentials): buckets are
metadata objects plus an omap **bucket index** listing keys in order
(reference cls_rgw bucket-index objects; omap gives the sorted
prefix/marker listing semantics S3 needs), object data+metadata live
in per-key RADOS objects, ETag is the content MD5 like S3.

Large objects stripe via the striper when they exceed one chunk
(reference RGW stripes tail objects the same way).  Versioning
(version rows in the same bucket index, delete markers, null-version
semantics — reference rgw_op.cc:2661 versioning_enabled +
rgw_bucket_index entry instances), canned ACLs (reference
rgw_acl_s3.cc) and lifecycle expiration (reference rgw_lc.cc) live
here too; the HTTP frontend is ``server.py``.
"""
from __future__ import annotations

import hashlib
import json
import secrets
import time
from typing import Dict, List, Optional, Tuple

from ..client.rados import IoCtx, RadosError
from ..client.striper import Layout, StripedIoCtx

BUCKETS_DIR = "rgw.buckets"          # gateway-wide bucket directory
CHUNK = 4 << 20

CANNED_ACLS = ("private", "public-read", "public-read-write",
               "authenticated-read")


class RGWError(Exception):
    def __init__(self, status: int, code: str, msg: str = ""):
        super().__init__(f"{status} {code} {msg}")
        self.status = status
        self.code = code


def _index_oid(bucket: str) -> str:
    # length-prefixed bucket name: '.' is legal inside bucket names,
    # so 'rgw.index.<bucket>' alone would let (bucket, key) pairs
    # collide across buckets
    return f"rgw.index.{len(bucket)}.{bucket}"


def _data_soid(bucket: str, key: str) -> str:
    return f"rgw.data.{len(bucket)}.{bucket}.{key}"


def _datalog_oid(bucket: str) -> str:
    """Per-bucket change log feeding multisite incremental sync
    (reference cls_rgw bucket index log + rgw_data_sync.cc's datalog):
    omap rows keyed by a monotonic-enough timestamp, value = the
    mutated key and op.  Trimmed by the sync agent once every peer
    zone has consumed them."""
    return f"rgw.datalog.{len(bucket)}.{bucket}"


def _vkey(key: str, vid: str) -> str:
    """Bucket-index row for one VERSION of a key.  NUL separates key
    from version id (keys containing NUL are rejected at PUT), and
    sorts before every printable byte, so a key's version rows
    cluster directly after its current row in omap order (the
    reference's bucket-index instance entries use the same
    key+instance composite)."""
    return f"{key}\x00{vid}"


def _data_vsoid(bucket: str, key: str, vid: str) -> str:
    """Version data object; the null version lives at the base soid
    (an object written before versioning was enabled IS the null
    version, reference rgw null-instance semantics)."""
    base = _data_soid(bucket, key)
    return base if vid == "null" else f"{base}\x00{vid}"


def _new_vid() -> str:
    """Opaque version id that sorts LEXICALLY NEWEST-FIRST (S3 lists
    versions newest first; an inverted-timestamp prefix gives that
    order straight out of the sorted omap)."""
    return f"{(1 << 63) - time.time_ns():016x}{secrets.token_hex(4)}"


def _mp_index_oid(bucket: str) -> str:
    return f"rgw.mp.{len(bucket)}.{bucket}"


def _part_soid(bucket: str, upload_id: str, num: int) -> str:
    return f"rgw.part.{len(bucket)}.{bucket}.{upload_id}.{num:05d}"


class MultipartMixin:
    """Multipart operations (reference rgw_multi.cc).  Every part is
    its OWN omap row (``<upload_id>.part.<n>``): per-key mutations are
    atomic at the OSD, so concurrent part uploads — the normal
    multipart pattern — cannot lose each other (a read-modify-write
    of one JSON record would)."""

    def initiate_multipart(self, bucket: str, key: str,
                           content_type: str = "binary/octet-stream",
                           meta: Optional[Dict[str, str]] = None
                           ) -> str:
        self._check_bucket(bucket)
        if not key:
            raise RGWError(400, "InvalidArgument", "empty key")
        if "\x00" in key:
            # same reservation as put_object: a NUL key would complete
            # into an index row the versioning machinery parses as a
            # version row
            raise RGWError(400, "InvalidArgument",
                           "NUL in key reserved for version rows")
        import secrets as _secrets
        upload_id = _secrets.token_hex(16)
        rec = {"key": key, "content_type": content_type,
               "meta": meta or {}, "started": time.time()}
        self.ioctx.omap_set(_mp_index_oid(bucket),
                            {upload_id: json.dumps(rec).encode()})
        return upload_id

    def _mp_get(self, bucket: str, upload_id: str,
                key: Optional[str] = None) -> dict:
        try:
            raw = self.ioctx.omap_get_by_key(_mp_index_oid(bucket),
                                             upload_id)
        except RadosError:
            raw = None
        if raw is None:
            raise RGWError(404, "NoSuchUpload", upload_id)
        rec = json.loads(raw.decode())
        if key is not None and rec["key"] != key:
            # completing/uploading under a different key must not
            # silently write the object there (S3: NoSuchUpload)
            raise RGWError(404, "NoSuchUpload",
                           f"{upload_id} is for {rec['key']!r}")
        return rec

    def _mp_parts(self, bucket: str, upload_id: str
                  ) -> Dict[int, dict]:
        try:
            omap = self.ioctx.omap_get(_mp_index_oid(bucket))
        except RadosError:
            return {}
        prefix = f"{upload_id}.part."
        return {int(k[len(prefix):]): json.loads(v.decode())
                for k, v in omap.items() if k.startswith(prefix)}

    def upload_part(self, bucket: str, key: str, upload_id: str,
                    part_num: int, data: bytes) -> str:
        if not 1 <= part_num <= self._part_limit:
            raise RGWError(400, "InvalidPartNumber", str(part_num))
        self._mp_get(bucket, upload_id, key)
        etag = hashlib.md5(data).hexdigest()
        soid = _part_soid(bucket, upload_id, part_num)
        self.striper.write(soid, data)
        self.striper.truncate(soid, len(data))
        self.ioctx.omap_set(_mp_index_oid(bucket), {
            f"{upload_id}.part.{part_num}": json.dumps(
                {"etag": etag, "size": len(data),
                 "mtime": time.time()}).encode()})
        return etag

    def list_parts(self, bucket: str, upload_id: str) -> List[dict]:
        self._mp_get(bucket, upload_id)
        return [{"part": n, **p} for n, p in
                sorted(self._mp_parts(bucket, upload_id).items())]

    def list_multipart_uploads(self, bucket: str) -> List[dict]:
        self._check_bucket(bucket)
        try:
            omap = self.ioctx.omap_get(_mp_index_oid(bucket))
        except RadosError:
            return []
        out = []
        for uid, raw in sorted(omap.items()):
            if ".part." in uid:
                continue
            rec = json.loads(raw.decode())
            out.append({"upload_id": uid, "key": rec["key"],
                        "started": rec["started"]})
        return out

    def complete_multipart(self, bucket: str, key: str,
                           upload_id: str,
                           parts: List[Tuple[int, str]]) -> str:
        """Assemble the final object from the client's ordered part
        list (reference RGWCompleteMultipart: validates every part's
        ETag, concatenates, S3 multipart ETag = md5(part-md5s)-N)."""
        rec = self._mp_get(bucket, upload_id, key)
        have_parts = self._mp_parts(bucket, upload_id)
        if not parts:
            raise RGWError(400, "MalformedXML", "no parts")
        last = 0
        md5s = b""
        total = 0
        for num, etag in parts:
            if num <= last:
                raise RGWError(400, "InvalidPartOrder", str(num))
            last = num
            have = have_parts.get(num)
            if have is None or have["etag"] != etag.strip('"'):
                raise RGWError(400, "InvalidPart", str(num))
            md5s += bytes.fromhex(have["etag"])
            total += have["size"]
        final_etag = (hashlib.md5(md5s).hexdigest()
                      + f"-{len(parts)}")
        bmeta = self._bucket_meta(bucket)
        versioning = bmeta.get("versioning", "off")
        idx = _index_oid(bucket)
        vid = _new_vid() if versioning == "enabled" else "null"
        rows: Dict[str, bytes] = {}
        if versioning == "enabled":
            self._materialize_null_version(idx, bucket, key, rows)
        soid = _data_vsoid(bucket, key, vid)
        off = 0
        for num, _ in parts:
            data = self.striper.read(_part_soid(bucket, upload_id,
                                                num))
            self.striper.write(soid, data, off)
            off += len(data)
        self.striper.truncate(soid, total)
        entry = {"size": total, "etag": final_etag,
                 "mtime": time.time(),
                 "content_type": rec["content_type"],
                 "meta": rec["meta"], "version_id": vid,
                 "acl": "private",
                 "owner": bmeta.get("owner", "")}
        enc = json.dumps(entry).encode()
        rows[key] = enc
        if versioning != "off":
            rows[_vkey(key, vid)] = enc
        self.ioctx.omap_set(idx, rows)
        self._datalog(bucket, key, "put")
        self._mp_cleanup(bucket, upload_id, rec)
        return final_etag

    def abort_multipart(self, bucket: str, upload_id: str) -> None:
        rec = self._mp_get(bucket, upload_id)
        self._mp_cleanup(bucket, upload_id, rec)

    def _mp_cleanup(self, bucket: str, upload_id: str,
                    rec: dict) -> None:
        parts = self._mp_parts(bucket, upload_id)
        for n in parts:
            try:
                self.striper.remove(_part_soid(bucket, upload_id, n))
            except RadosError:
                pass
        self.ioctx.omap_rm_keys(
            _mp_index_oid(bucket),
            [upload_id] + [f"{upload_id}.part.{n}" for n in parts])


class RGWService(MultipartMixin):
    """Bucket/object operations (reference RGWRados)."""

    def __init__(self, ioctx: IoCtx):
        self.ioctx = ioctx
        from ..utils.config import default_config
        conf = getattr(ioctx.rados, "conf", None) or default_config()
        self._list_max = conf["rgw_list_max_keys"]
        self._part_limit = conf["rgw_multipart_part_limit"]
        self._max_put = conf["rgw_max_put_size"]
        self.striper = StripedIoCtx(
            ioctx, Layout(stripe_unit=CHUNK, stripe_count=1,
                          object_size=CHUNK))

    # -- buckets (reference RGWRados::create_bucket) -------------------
    # The directory is an omap on one object: per-key mutations are
    # atomic at the OSD, so concurrent bucket create/delete cannot
    # lose each other's updates (a read-modify-write JSON blob could).
    def list_buckets(self) -> List[dict]:
        try:
            omap = self.ioctx.omap_get(BUCKETS_DIR)
        except RadosError:
            return []
        return [json.loads(v.decode())
                for _, v in sorted(omap.items())]

    def create_bucket(self, bucket: str, owner: str = "",
                      acl: str = "private") -> None:
        if not bucket or "/" in bucket or "." == bucket[0]:
            raise RGWError(400, "InvalidBucketName", bucket)
        if acl not in CANNED_ACLS:
            raise RGWError(400, "InvalidArgument", acl)
        try:
            if bucket in self.ioctx.omap_get(BUCKETS_DIR):
                raise RGWError(409, "BucketAlreadyExists", bucket)
        except RadosError:
            pass
        meta = {"name": bucket, "created": time.time(),
                "owner": owner, "acl": acl, "versioning": "off",
                "lifecycle": []}
        self.ioctx.omap_set(BUCKETS_DIR,
                            {bucket: json.dumps(meta).encode()})
        self.ioctx.create(_index_oid(bucket))

    def _bucket_meta(self, bucket: str) -> dict:
        try:
            raw = self.ioctx.omap_get_by_key(BUCKETS_DIR, bucket)
        except RadosError:
            raw = None
        if raw is None:
            raise RGWError(404, "NoSuchBucket", bucket)
        return json.loads(raw.decode())

    def _set_bucket_meta(self, bucket: str, meta: dict) -> None:
        self.ioctx.omap_set(BUCKETS_DIR,
                            {bucket: json.dumps(meta).encode()})

    def _check_bucket(self, bucket: str) -> None:
        self._bucket_meta(bucket)

    # -- versioning config (reference RGWSetBucketVersioning,
    # rgw_op.cc:2661) ---------------------------------------------------
    def put_bucket_versioning(self, bucket: str, state: str) -> None:
        if state not in ("Enabled", "Suspended"):
            raise RGWError(400, "IllegalVersioningConfiguration",
                           state)
        meta = self._bucket_meta(bucket)
        meta["versioning"] = ("enabled" if state == "Enabled"
                              else "suspended")
        self._set_bucket_meta(bucket, meta)

    def get_bucket_versioning(self, bucket: str) -> str:
        v = self._bucket_meta(bucket).get("versioning", "off")
        return {"enabled": "Enabled", "suspended": "Suspended",
                "off": ""}[v]

    # -- ACLs (canned; reference rgw_acl_s3.cc RGWAccessControlPolicy
    # _S3 + rgw_op.cc verify_bucket/object_permission) ------------------
    def get_bucket_acl(self, bucket: str) -> dict:
        meta = self._bucket_meta(bucket)
        return {"owner": meta.get("owner", ""),
                "acl": meta.get("acl", "private")}

    def put_bucket_acl(self, bucket: str, acl: str) -> None:
        if acl not in CANNED_ACLS:
            raise RGWError(400, "InvalidArgument", acl)
        meta = self._bucket_meta(bucket)
        meta["acl"] = acl
        self._set_bucket_meta(bucket, meta)

    def get_object_acl(self, bucket: str, key: str) -> dict:
        head = self.head_object(bucket, key)
        return {"owner": head.get("owner", ""),
                "acl": head.get("acl", "private")}

    def put_object_acl(self, bucket: str, key: str, acl: str) -> None:
        if acl not in CANNED_ACLS:
            raise RGWError(400, "InvalidArgument", acl)
        self._check_bucket(bucket)
        idx = _index_oid(bucket)
        raw = self.ioctx.omap_get_by_key(idx, key)
        if raw is None:
            raise RGWError(404, "NoSuchKey", key)
        entry = json.loads(raw.decode())
        entry["acl"] = acl
        rows = {key: json.dumps(entry).encode()}
        vid = entry.get("version_id")
        # keep the current version ROW in sync too — including a
        # materialized "null" version (suspended-era write): _entry
        # serves versionId=null from that row, so a stale copy would
        # enforce the old ACL for versioned reads of the same object
        if vid and self.ioctx.omap_get_by_key(
                idx, _vkey(key, vid)) is not None:
            rows[_vkey(key, vid)] = rows[key]
        self.ioctx.omap_set(idx, rows)

    def check_access(self, identity: Optional[str], op: str,
                     bucket: str, key: str = "",
                     head: Optional[dict] = None) -> None:
        """Enforce the canned ACL for ``identity`` (None = anonymous;
        an empty-owner bucket predates auth and stays open, matching
        the reference's anonymous dev mode).  op is 'read', 'write'
        or 'acl' (ACL reads/writes are owner-only, reference
        verify_bucket_owner_or_policy).  ``head``: a pre-fetched
        object head — the GET/HEAD hot path fetches the entry once
        and threads it through here and get_object instead of paying
        three bucket-meta + two index-row reads per request."""
        meta = self._bucket_meta(bucket)
        owner = meta.get("owner", "")
        acl = meta.get("acl", "private")
        if key and op == "read":
            # object ACLs govern READS only; writes/deletes are
            # bucket-WRITE-ACL territory (S3: DeleteObject/PutObject
            # permission comes from the bucket, GetObject from the
            # object)
            if head is None:
                try:
                    head = self.head_object(bucket, key)
                except RGWError:
                    pass             # no object yet: bucket ACL rules
            if head is not None:
                owner = head.get("owner", owner)
                acl = head.get("acl", acl)
        if not owner or identity == owner:
            return
        if op == "read" and acl in ("public-read",
                                    "public-read-write"):
            return
        if op == "read" and acl == "authenticated-read" \
                and identity is not None:
            return
        if op == "write" and acl == "public-read-write":
            return
        raise RGWError(403, "AccessDenied", f"{op} {bucket}/{key}")

    def delete_bucket(self, bucket: str) -> None:
        self._check_bucket(bucket)
        if self.ioctx.omap_get(_index_oid(bucket)):
            raise RGWError(409, "BucketNotEmpty", bucket)
        if self.list_multipart_uploads(bucket):
            # S3: in-progress uploads must be aborted first; deleting
            # around them would orphan part objects and resurrect the
            # uploads if the name is recreated
            raise RGWError(409, "BucketNotEmpty",
                           f"{bucket}: multipart uploads in progress")
        for oid in (_index_oid(bucket), _mp_index_oid(bucket)):
            try:
                self.ioctx.remove(oid)
            except RadosError:
                pass
        self.ioctx.omap_rm_keys(BUCKETS_DIR, [bucket])

    # -- objects (reference RGWRados::Object::Write/Read) --------------
    def put_object(self, bucket: str, key: str, data: bytes,
                   content_type: str = "binary/octet-stream",
                   meta: Optional[Dict[str, str]] = None,
                   acl: str = "private", owner: str = "") -> dict:
        bmeta = self._bucket_meta(bucket)
        if not key:
            raise RGWError(400, "InvalidArgument", "empty key")
        if "\x00" in key:
            raise RGWError(400, "InvalidArgument",
                           "NUL in key reserved for version rows")
        if len(data) > self._max_put:
            raise RGWError(400, "EntityTooLarge", key)
        if acl not in CANNED_ACLS:
            raise RGWError(400, "InvalidArgument", acl)
        versioning = bmeta.get("versioning", "off")
        idx = _index_oid(bucket)
        vid = _new_vid() if versioning == "enabled" else "null"
        etag = hashlib.md5(data).hexdigest()
        rows: Dict[str, bytes] = {}
        if versioning == "enabled":
            self._materialize_null_version(idx, bucket, key, rows)
        soid = _data_vsoid(bucket, key, vid)
        self.striper.write(soid, data)
        # shrink past the new end: overwriting a larger object must
        # not serve the previous object's tail
        self.striper.truncate(soid, len(data))
        # index entry AFTER data (reference prepare/complete index
        # transaction: a failed put must not list)
        entry = {"size": len(data), "etag": etag,
                 "mtime": time.time(), "content_type": content_type,
                 "meta": meta or {}, "version_id": vid,
                 "acl": acl, "owner": owner or bmeta.get("owner", "")}
        enc = json.dumps(entry).encode()
        rows[key] = enc
        if versioning != "off":
            # suspended PUTs REPLACE the null version row (S3: a
            # suspended bucket writes null versions); enabled PUTs add
            # a fresh version row
            rows[_vkey(key, vid)] = enc
        self.ioctx.omap_set(idx, rows)
        self._datalog(bucket, key, "put")
        return entry

    def _datalog(self, bucket: str, key: str, op: str) -> None:
        """Append one change record (reference bucket index log).
        The timestamp key keeps entries ordered; a random suffix
        keeps concurrent writers from colliding — sync copies the
        CURRENT state of each named key, so ordering within the same
        instant is immaterial."""
        import secrets as _secrets
        row = f"{time.time_ns():020d}.{_secrets.token_hex(4)}"
        try:
            self.ioctx.omap_set(_datalog_oid(bucket), {
                row: json.dumps({"key": key, "op": op}).encode()})
        except RadosError:
            pass                     # log loss degrades to full sync

    def _materialize_null_version(self, idx: str, bucket: str,
                                  key: str, rows: dict) -> None:
        """An object written before versioning was enabled is the
        'null' version: give it its version row the first time a
        versioned write lands on its key, so it survives as a
        noncurrent version instead of being silently overwritten
        (reference rgw null-instance handling)."""
        try:
            cur = self.ioctx.omap_get_by_key(idx, key)
        except RadosError:
            cur = None
        if cur is None:
            return
        entry = json.loads(cur.decode())
        if entry.get("version_id", "null") == "null":
            entry["version_id"] = "null"
            rows[_vkey(key, "null")] = json.dumps(entry).encode()

    def _entry(self, bucket: str, key: str,
               version_id: Optional[str] = None) -> dict:
        self._check_bucket(bucket)
        idx = _index_oid(bucket)
        row = key if version_id is None else _vkey(key, version_id)
        try:
            raw = self.ioctx.omap_get_by_key(idx, row)
        except RadosError:
            raw = None
        if raw is None and version_id == "null":
            # null version of a never-materialized key = current row
            # (if itself null)
            try:
                raw = self.ioctx.omap_get_by_key(idx, key)
            except RadosError:
                raw = None
            if raw is not None:
                e = json.loads(raw.decode())
                if e.get("version_id", "null") != "null":
                    raw = None
        if raw is None:
            raise RGWError(404, "NoSuchKey" if version_id is None
                           else "NoSuchVersion", key)
        return json.loads(raw.decode())

    def head_object(self, bucket: str, key: str,
                    version_id: Optional[str] = None) -> dict:
        entry = self._entry(bucket, key, version_id)
        if version_id is None and entry.get("delete_marker"):
            raise RGWError(404, "NoSuchKey", key)
        return entry

    def get_object(self, bucket: str, key: str,
                   rng: Optional[Tuple[int, int]] = None,
                   version_id: Optional[str] = None,
                   head: Optional[dict] = None
                   ) -> Tuple[dict, bytes]:
        if head is None:
            head = self.head_object(bucket, key, version_id)
        if head.get("delete_marker"):
            raise RGWError(405, "MethodNotAllowed",
                           f"{key} version {version_id} is a delete "
                           f"marker")
        soid = _data_vsoid(bucket, key,
                           head.get("version_id", "null"))
        if head["size"] == 0:
            return head, b""
        if rng is None:
            return head, self.striper.read(soid)
        start, end = rng
        end = min(end, head["size"] - 1)
        if start > end:
            raise RGWError(416, "InvalidRange", key)
        return head, self.striper.read(soid, end - start + 1, start)

    def delete_object(self, bucket: str, key: str,
                      version_id: Optional[str] = None
                      ) -> Optional[dict]:
        """S3 DELETE semantics.  Unversioned bucket: remove key.
        Versioning enabled, no version_id: write a DELETE MARKER
        (reference rgw_op.cc RGWDeleteObj versioned path).  With
        version_id: permanently remove that version; the newest
        remaining version becomes current."""
        bmeta = self._bucket_meta(bucket)
        idx = _index_oid(bucket)
        versioning = bmeta.get("versioning", "off")
        if version_id is not None:
            return self._delete_version(bucket, idx, key, version_id)
        if versioning == "off":
            if self.ioctx.omap_get_by_key(idx, key) is None:
                raise RGWError(404, "NoSuchKey", key)
            try:
                self.striper.remove(_data_soid(bucket, key))
            except RadosError:
                pass
            self.ioctx.omap_rm_keys(idx, [key])
            self._datalog(bucket, key, "del")
            return None
        # versioned (enabled or suspended): delete marker.  Suspended
        # buckets write it as the null version, removing any existing
        # null version's data (S3 suspended-delete semantics).
        rows: Dict[str, bytes] = {}
        vid = _new_vid() if versioning == "enabled" else "null"
        if versioning == "enabled":
            self._materialize_null_version(idx, bucket, key, rows)
        else:
            try:
                self.striper.remove(_data_soid(bucket, key))
            except RadosError:
                pass
        marker = {"delete_marker": True, "version_id": vid,
                  "mtime": time.time(), "size": 0, "etag": "",
                  "content_type": "", "meta": {},
                  "owner": bmeta.get("owner", ""), "acl": "private"}
        enc = json.dumps(marker).encode()
        rows[key] = enc
        rows[_vkey(key, vid)] = enc
        self.ioctx.omap_set(idx, rows)
        self._datalog(bucket, key, "del")
        return marker

    def _delete_version(self, bucket: str, idx: str, key: str,
                        vid: str) -> Optional[dict]:
        entry = self._entry(bucket, key, vid)
        if not entry.get("delete_marker"):
            try:
                self.striper.remove(_data_vsoid(bucket, key, vid))
            except RadosError:
                pass
        rm = [_vkey(key, vid)]
        # was this version current?  promote the newest survivor
        try:
            cur_raw = self.ioctx.omap_get_by_key(idx, key)
        except RadosError:
            cur_raw = None
        cur = json.loads(cur_raw.decode()) if cur_raw else None
        if cur is not None and cur.get("version_id",
                                       "null") == vid:
            survivors = self._version_rows(idx, key)
            survivors.pop(vid, None)
            if survivors:
                # promote by WRITE TIME, not lexical vid: the literal
                # "null" (suspended-era writes) sorts after every hex
                # vid, so a lexical pick would serve an old enabled-era
                # version over a newer null one
                newest = max(survivors.values(),
                             key=lambda e: e.get("mtime", 0.0))
                self.ioctx.omap_set(
                    idx, {key: json.dumps(newest).encode()})
            else:
                rm.append(key)
        self.ioctx.omap_rm_keys(idx, rm)
        # version deletes can change the key's CURRENT state
        # (survivor promotion / key removal): the peer zone must
        # re-converge it
        self._datalog(bucket, key, "del")
        return entry

    def _version_rows(self, idx: str, key: str,
                      omap: Optional[dict] = None) -> Dict[str, dict]:
        """vid -> entry for every version row of one key.  Pass a
        pre-fetched ``omap`` when iterating many keys — re-fetching
        the whole bucket index per key makes sweeps O(keys x
        bucket-size)."""
        if omap is None:
            try:
                omap = self.ioctx.omap_get(idx)
            except RadosError:
                return {}
        pre = key + "\x00"
        return {k[len(pre):]: json.loads(v.decode())
                for k, v in omap.items() if k.startswith(pre)}

    def list_object_versions(self, bucket: str, prefix: str = "",
                             key_marker: str = "",
                             max_keys: Optional[int] = None) -> dict:
        """S3 ListObjectVersions: every version row newest-first per
        key; keys never versioned surface their current row as the
        null version (reference RGWListBucketVersions)."""
        if max_keys is None:
            max_keys = self._list_max
        self._check_bucket(bucket)
        omap = self.ioctx.omap_get(_index_oid(bucket))
        versions: List[dict] = []
        truncated = False

        def emit(group: List[dict]) -> bool:
            """Append one key's versions newest-first; -> True when
            the page filled.  Ordering is by recorded mtime with the
            latest pinned on top: the omap's inverted-timestamp vids
            already sort newest-first, but a materialized "null"
            version (written in a suspended era) sorts
            lexicographically LAST however old or new it is — S3
            clients take the first entry as the newest.  Truncation
            is WHOLE-KEY: continuation is by key-marker, so a key cut
            mid-group could never finish listing — the partial key
            moves entirely to the next page (unless it alone exceeds
            the page, which then serves it oversized rather than
            loop forever)."""
            nonlocal truncated
            if len(versions) + len(group) > max_keys and versions:
                truncated = True
                return True
            group.sort(key=lambda e: (not e.get("is_latest"),
                                      -e.get("mtime", 0)))
            versions.extend(group)
            return len(versions) >= max_keys

        # rows of one key are contiguous in the sorted omap (keys
        # cannot contain NUL), so groups stream and the scan stops at
        # the page boundary instead of json-decoding the whole bucket
        # (same paging principle as list_objects)
        group: List[dict] = []
        group_key = None
        for row in sorted(omap):
            base = row.split("\x00", 1)[0]
            if not base.startswith(prefix) or base <= key_marker:
                continue
            if base != group_key:
                if group and emit(group):
                    # emit said stop AND a further key's row is in
                    # hand — whether the group was deferred or the
                    # page filled exactly, more data exists
                    truncated = True
                    break
                group, group_key = [], base
            if "\x00" not in row:
                ent = json.loads(omap[row].decode())
                if _vkey(base, ent.get("version_id",
                                       "null")) in omap:
                    continue         # materialized: row covers it
                ent.setdefault("version_id", "null")
                ent["is_latest"] = True
            else:
                ent = json.loads(omap[row].decode())
                cur = omap.get(base)
                cur_vid = (json.loads(cur.decode())
                           .get("version_id", "null")
                           if cur else None)
                ent["is_latest"] = ent.get("version_id") == cur_vid
            ent["key"] = base
            group.append(ent)
        if group and not truncated:
            emit(group)
        return {"bucket": bucket, "prefix": prefix,
                "versions": versions, "is_truncated": truncated}

    # -- lifecycle (reference rgw_lc.cc RGWLC::process + bucket_lc_
    # process; rules stored on the bucket like RGWLifecycleConfiguration
    # in bucket attrs) --------------------------------------------------
    def put_bucket_lifecycle(self, bucket: str,
                             rules: List[dict]) -> None:
        """rules: [{id, prefix, status, days, noncurrent_days,
        expired_delete_marker}] — the S3 subset the reference's LC
        worker applies most: current-object expiration, noncurrent
        version expiration, orphaned delete-marker cleanup."""
        clean = []
        for r in rules:
            if r.get("status", "Enabled") not in ("Enabled",
                                                  "Disabled"):
                raise RGWError(400, "MalformedXML",
                               str(r.get("status")))
            days = r.get("days")
            nc = r.get("noncurrent_days")
            if days is None and nc is None and \
                    not r.get("expired_delete_marker"):
                raise RGWError(400, "MalformedXML",
                               "rule without any action")
            for v in (days, nc):
                if v is not None and (not isinstance(v, int)
                                      or v < 1):
                    raise RGWError(400, "InvalidArgument", str(v))
            clean.append({"id": r.get("id", f"rule-{len(clean)}"),
                          "prefix": r.get("prefix", ""),
                          "status": r.get("status", "Enabled"),
                          "days": days, "noncurrent_days": nc,
                          "expired_delete_marker":
                              bool(r.get("expired_delete_marker"))})
        meta = self._bucket_meta(bucket)
        meta["lifecycle"] = clean
        self._set_bucket_meta(bucket, meta)

    def get_bucket_lifecycle(self, bucket: str) -> List[dict]:
        return self._bucket_meta(bucket).get("lifecycle", [])

    def delete_bucket_lifecycle(self, bucket: str) -> None:
        meta = self._bucket_meta(bucket)
        meta["lifecycle"] = []
        self._set_bucket_meta(bucket, meta)

    def lc_process(self, now: Optional[float] = None) -> dict:
        """One lifecycle pass over every bucket (reference
        RGWLC::process worker): expire current objects past
        ``days`` (versioned buckets get a delete marker, unversioned
        delete outright — S3 expiration semantics), permanently
        remove noncurrent versions past ``noncurrent_days``, and
        drop delete markers with no remaining versions when
        ``expired_delete_marker`` asks.  Returns action counts."""
        now = time.time() if now is None else now
        stats = {"expired": 0, "noncurrent_removed": 0,
                 "markers_removed": 0}
        for bmeta in self.list_buckets():
            bucket = bmeta["name"]
            rules = [r for r in bmeta.get("lifecycle", [])
                     if r.get("status") == "Enabled"]
            if not rules:
                continue
            versioned = bmeta.get("versioning", "off") != "off"
            idx = _index_oid(bucket)
            try:
                omap = self.ioctx.omap_get(idx)
            except RadosError:
                continue
            # rows already acted on this pass: the omap snapshot is
            # taken once per bucket, so without this an overlapping
            # later rule re-sees the stale pre-action entry and
            # double-expires (one junk delete marker per extra rule)
            acted: set = set()
            for rule in rules:
                pre = rule.get("prefix", "")
                days = rule.get("days")
                nc_days = rule.get("noncurrent_days")
                for row in sorted(omap):
                    base = row.split("\x00", 1)[0]
                    if not base.startswith(pre) or row in acted:
                        continue
                    ent = json.loads(omap[row].decode())
                    if "\x00" not in row:
                        cur_expired = (
                            days is not None
                            and not ent.get("delete_marker")
                            and ent["mtime"] + days * 86400 <= now)
                        if cur_expired:
                            try:
                                self.delete_object(bucket, base)
                                stats["expired"] += 1
                                acted.add(row)
                            except RGWError:
                                pass
                        continue
                    # version row: noncurrent expiration
                    vid = row.split("\x00", 1)[1]
                    cur_raw = omap.get(base)
                    cur_vid = (json.loads(cur_raw.decode())
                               .get("version_id", "null")
                               if cur_raw else None)
                    if vid == cur_vid:
                        continue     # current: only `days` applies
                    if nc_days is not None and \
                            ent["mtime"] + nc_days * 86400 <= now:
                        try:
                            self._delete_version(bucket, idx, base,
                                                 vid)
                            stats["noncurrent_removed"] += 1
                            acted.add(row)
                        except RGWError:
                            pass
                if rule.get("expired_delete_marker") and versioned:
                    # a delete marker whose key has no other versions
                    # serves nothing: S3's ExpiredObjectDeleteMarker
                    fresh = self.ioctx.omap_get(idx)
                    for row in sorted(fresh):
                        if "\x00" in row:
                            continue
                        if not row.startswith(pre):
                            continue
                        ent = json.loads(fresh[row].decode())
                        if not ent.get("delete_marker"):
                            continue
                        others = [v for v in
                                  self._version_rows(idx, row,
                                                     omap=fresh)
                                  if v != ent.get("version_id")]
                        if not others:
                            self.ioctx.omap_rm_keys(
                                idx, [row, _vkey(
                                    row, ent["version_id"])])
                            self._datalog(bucket, row, "del")
                            stats["markers_removed"] += 1
        return stats

    def list_objects(self, bucket: str, prefix: str = "",
                     marker: str = "", max_keys: Optional[int] = None,
                     delimiter: str = "") -> dict:
        """S3 ListObjects semantics: sorted keys, prefix filter,
        marker resume, delimiter common-prefix rollup (reference
        cls_rgw bucket listing + RGWListBucket).  Version rows and
        delete-marker currents never list (S3 shows only latest
        non-deleted objects here)."""
        if max_keys is None:
            max_keys = self._list_max    # reference rgw_max_listing_results
        self._check_bucket(bucket)
        omap = self.ioctx.omap_get(_index_oid(bucket))
        # string-only prefilter; entries json-decode lazily inside the
        # paged loop so a huge bucket doesn't parse every row per page
        keys = sorted(k for k in omap
                      if k.startswith(prefix) and k > marker
                      and "\x00" not in k)
        contents: List[dict] = []
        common: List[str] = []
        truncated = False
        for k in keys:
            if len(contents) + len(common) >= max_keys:
                truncated = True
                break
            if delimiter:
                rest = k[len(prefix):]
                if delimiter in rest:
                    cp = prefix + rest.split(delimiter, 1)[0] \
                        + delimiter
                    if cp not in common:
                        common.append(cp)
                    continue
            entry = json.loads(omap[k].decode())
            if entry.get("delete_marker"):
                continue             # S3 hides marker currents
            contents.append({"key": k, "size": entry["size"],
                             "etag": entry["etag"],
                             "mtime": entry["mtime"]})
        return {"bucket": bucket, "prefix": prefix, "marker": marker,
                "contents": contents, "common_prefixes": common,
                "is_truncated": truncated}
