"""RGW HTTP frontend: S3 path-style REST over the gateway core.

Python-native equivalent of the reference's beast/civetweb frontend +
REST dispatch (reference ``src/rgw/rgw_rest_s3.cc``): path-style
routes (``/bucket``, ``/bucket/key``), ListAllMyBuckets /
ListObjects XML, ETag/Content-Type headers, Range reads, multipart
upload (initiate/part/complete/abort/list — reference rgw_multi.cc),
S3-style XML error bodies, and optional AWS SigV4 authentication
(``auth_enabled``; anonymous mode remains for dev parity with the
reference's anonymous access).  Single-site.
"""
from __future__ import annotations

import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from xml.sax.saxutils import escape

from .gateway import RGWError, RGWService


def _iso(ts: float) -> str:
    import datetime
    return datetime.datetime.fromtimestamp(
        ts, datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.000Z")


def _parse_lc_xml(body: bytes) -> list:
    """Minimal LifecycleConfiguration parser (the S3 subset
    put_bucket_lifecycle accepts; reference RGWLifecycleConfiguration
    ::decode_xml)."""
    import re as _re
    text = body.decode("utf-8", "replace")
    rules = []
    for rm in _re.finditer(r"<Rule>(.*?)</Rule>", text, _re.S):
        blk = rm.group(1)

        def tag(name, default=None):
            m = _re.search(rf"<{name}>\s*([^<]*?)\s*</{name}>", blk)
            return m.group(1) if m else default

        rule = {"id": tag("ID", f"rule-{len(rules)}"),
                "prefix": tag("Prefix", ""),
                "status": tag("Status", "Enabled")}
        days = tag("Days")
        if days is not None:
            try:
                rule["days"] = int(days)
            except ValueError:
                raise RGWError(400, "InvalidArgument", days)
        nc = tag("NoncurrentDays")
        if nc is not None:
            try:
                rule["noncurrent_days"] = int(nc)
            except ValueError:
                raise RGWError(400, "InvalidArgument", nc)
        if tag("ExpiredObjectDeleteMarker", "").lower() == "true":
            rule["expired_delete_marker"] = True
        rules.append(rule)
    if not rules:
        raise RGWError(400, "MalformedXML", "no rules")
    return rules


class RGWServer:
    """HTTP server hosting one RGWService (reference RGWFrontend)."""

    def __init__(self, ioctx, addr: Tuple[str, int] = ("127.0.0.1", 0),
                 auth_enabled: bool = False):
        from .auth import SigV4Verifier, UserStore
        from .swift import SwiftAdapter
        self.service = RGWService(ioctx)
        self.users = UserStore(ioctx)
        self.verifier = SigV4Verifier(self.users)
        self.auth_enabled = auth_enabled
        # the Swift dialect shares the gateway core (reference: one
        # radosgw, two REST APIs over the same buckets)
        self.swift = SwiftAdapter(self.service, self.users)
        svc = self.service
        gw = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            # ---------------------------------------------------- util
            def _split(self) -> Tuple[str, str, dict]:
                parsed = urllib.parse.urlparse(self.path)
                parts = parsed.path.lstrip("/").split("/", 1)
                bucket = urllib.parse.unquote(parts[0])
                key = urllib.parse.unquote(parts[1]) \
                    if len(parts) > 1 else ""
                q = {k: v[0] for k, v in urllib.parse.parse_qs(
                    parsed.query, keep_blank_values=True).items()}
                return bucket, key, q

            def _send(self, status: int, body: bytes = b"",
                      ctype: str = "application/xml",
                      headers: Optional[dict] = None) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _error(self, e: RGWError) -> None:
                body = (f"<?xml version='1.0'?><Error><Code>{e.code}"
                        f"</Code><Message>{escape(str(e))}</Message>"
                        f"</Error>").encode()
                self._send(e.status, body)

            def _body(self) -> bytes:
                n = int(self.headers.get("Content-Length", 0))
                return self.rfile.read(n) if n else b""

            def _auth(self, body: bytes) -> Optional[str]:
                """SigV4 check when enabled (reference rgw::auth);
                -> the authenticated uid, or None for anonymous
                (requests without Authorization are ANONYMOUS, not
                rejected — the canned ACLs decide what anonymous may
                touch, reference rgw handles anonymous the same
                way)."""
                if not gw.auth_enabled:
                    return None
                if "Authorization" not in self.headers:
                    return None
                parsed = urllib.parse.urlparse(self.path)
                user = gw.verifier.verify(
                    self.command, parsed.path, parsed.query,
                    dict(self.headers.items()), body)
                return user["uid"]

            # --------------------------------------------------- verbs
            def do_GET(self):          # noqa: N802
                if gw.swift.maybe_handle(self, "GET"):
                    return
                bucket, key, q = self._split()
                try:
                    ident = self._auth(b"")
                    if not bucket:
                        # S3 ListBuckets requires authentication and
                        # shows only the caller's buckets (anonymous
                        # enumeration of every bucket name would leak)
                        if gw.auth_enabled and ident is None:
                            raise RGWError(403, "AccessDenied",
                                           "anonymous ListBuckets")
                        self._list_buckets(ident)
                        return
                    if "acl" in q:
                        svc.check_access(ident, "acl", bucket, key)
                        self._get_acl(bucket, key)
                        return
                    if not key and ("versioning" in q
                                    or "lifecycle" in q):
                        # bucket CONFIG reads are owner-only (S3
                        # gates GetBucketVersioning/GetLifecycle on
                        # bucket-owner permissions, not READ ACL)
                        svc.check_access(ident, "acl", bucket)
                    else:
                        head = None
                        if key and "uploadId" not in q:
                            # fetch the entry ONCE for the object-GET
                            # hot path; check_access and get_object
                            # both reuse it
                            try:
                                head = svc.head_object(
                                    bucket, key, q.get("versionId"))
                            except RGWError:
                                head = None
                        svc.check_access(ident, "read", bucket, key,
                                         head=head)
                    if not key and "versioning" in q:
                        state = svc.get_bucket_versioning(bucket)
                        inner = (f"<Status>{state}</Status>"
                                 if state else "")
                        self._send(200, (
                            f"<?xml version='1.0'?>"
                            f"<VersioningConfiguration>{inner}"
                            f"</VersioningConfiguration>").encode())
                    elif not key and "lifecycle" in q:
                        self._get_lifecycle(bucket)
                    elif not key and "versions" in q:
                        self._list_versions(bucket, q)
                    elif not key and "uploads" in q:
                        self._list_uploads(bucket)
                    elif not key:
                        self._list_objects(bucket, q)
                    elif "uploadId" in q:
                        self._list_parts(bucket, q["uploadId"])
                    else:
                        self._get_object(bucket, key,
                                         q.get("versionId"),
                                         head=head)
                except RGWError as e:
                    self._error(e)

            def _get_acl(self, bucket, key):
                acl = (svc.get_object_acl(bucket, key) if key
                       else svc.get_bucket_acl(bucket))
                xml = (f"<?xml version='1.0'?>"
                       f"<AccessControlPolicy><Owner><ID>"
                       f"{escape(acl['owner'])}</ID></Owner>"
                       f"<Canned>{acl['acl']}</Canned>"
                       f"</AccessControlPolicy>")
                self._send(200, xml.encode())

            def _get_lifecycle(self, bucket):
                rules = svc.get_bucket_lifecycle(bucket)
                if not rules:
                    raise RGWError(404,
                                   "NoSuchLifecycleConfiguration",
                                   bucket)
                rows = ""
                for r in rules:
                    exp = ""
                    if r.get("days"):
                        exp += (f"<Expiration><Days>{r['days']}"
                                f"</Days></Expiration>")
                    if r.get("expired_delete_marker"):
                        exp += ("<Expiration>"
                                "<ExpiredObjectDeleteMarker>true"
                                "</ExpiredObjectDeleteMarker>"
                                "</Expiration>")
                    if r.get("noncurrent_days"):
                        exp += (f"<NoncurrentVersionExpiration>"
                                f"<NoncurrentDays>"
                                f"{r['noncurrent_days']}"
                                f"</NoncurrentDays>"
                                f"</NoncurrentVersionExpiration>")
                    rows += (f"<Rule><ID>{escape(r['id'])}</ID>"
                             f"<Prefix>{escape(r['prefix'])}"
                             f"</Prefix><Status>{r['status']}"
                             f"</Status>{exp}</Rule>")
                self._send(200, (
                    f"<?xml version='1.0'?>"
                    f"<LifecycleConfiguration>{rows}"
                    f"</LifecycleConfiguration>").encode())

            def _list_versions(self, bucket, q):
                try:
                    max_keys = int(q.get("max-keys", "0")) or None
                except ValueError:
                    raise RGWError(400, "InvalidArgument",
                                   q.get("max-keys", ""))
                res = svc.list_object_versions(
                    bucket, prefix=q.get("prefix", ""),
                    key_marker=q.get("key-marker", ""),
                    max_keys=max_keys)
                rows = ""
                for v in res["versions"]:
                    tag = ("DeleteMarker" if v.get("delete_marker")
                           else "Version")
                    extra = ("" if v.get("delete_marker") else
                             f"<ETag>\"{v['etag']}\"</ETag>"
                             f"<Size>{v['size']}</Size>")
                    rows += (
                        f"<{tag}><Key>{escape(v['key'])}</Key>"
                        f"<VersionId>{v['version_id']}</VersionId>"
                        f"<IsLatest>"
                        f"{str(v['is_latest']).lower()}</IsLatest>"
                        f"<LastModified>{_iso(v['mtime'])}"
                        f"</LastModified>{extra}</{tag}>")
                # paging contract (S3 ListObjectVersions): truncation
                # is explicit, and NextKeyMarker is the last key the
                # page covered so the client can continue
                trunc = res.get("is_truncated", False)
                marker = ""
                if trunc and res["versions"]:
                    marker = (f"<NextKeyMarker>"
                              f"{escape(res['versions'][-1]['key'])}"
                              f"</NextKeyMarker>")
                self._send(200, (
                    f"<?xml version='1.0'?><ListVersionsResult>"
                    f"<Name>{escape(bucket)}</Name>"
                    f"<IsTruncated>{str(trunc).lower()}"
                    f"</IsTruncated>{marker}{rows}"
                    f"</ListVersionsResult>").encode())

            def do_POST(self):         # noqa: N802
                if gw.swift.maybe_handle(self, "POST"):
                    return
                bucket, key, q = self._split()
                body = self._body()
                try:
                    ident = self._auth(body)
                    svc.check_access(ident, "write", bucket, key)
                    if key and "uploads" in q:
                        uid = svc.initiate_multipart(
                            bucket, key,
                            content_type=self.headers.get(
                                "Content-Type",
                                "binary/octet-stream"))
                        xml = (f"<?xml version='1.0'?>"
                               f"<InitiateMultipartUploadResult>"
                               f"<Bucket>{escape(bucket)}</Bucket>"
                               f"<Key>{escape(key)}</Key>"
                               f"<UploadId>{uid}</UploadId>"
                               f"</InitiateMultipartUploadResult>")
                        self._send(200, xml.encode())
                    elif key and "uploadId" in q:
                        self._complete_upload(bucket, key,
                                              q["uploadId"], body)
                    else:
                        raise RGWError(400, "InvalidRequest",
                                       self.path)
                except RGWError as e:
                    self._error(e)

            def _complete_upload(self, bucket, key, upload_id,
                                 body: bytes):
                # CompleteMultipartUpload XML: ordered Part/
                # PartNumber/ETag rows (reference RGWCompleteMultipart)
                import re as _re
                parts = []
                try:
                    text = body.decode()
                except UnicodeDecodeError:
                    raise RGWError(400, "MalformedXML", "not utf-8")
                for m in _re.finditer(
                        r"<Part>.*?<PartNumber>(\d+)</PartNumber>"
                        r".*?<ETag>\"?([a-f0-9-]+)\"?</ETag>.*?"
                        r"</Part>", text, _re.S):
                    parts.append((int(m.group(1)), m.group(2)))
                etag = svc.complete_multipart(bucket, key, upload_id,
                                              parts)
                xml = (f"<?xml version='1.0'?>"
                       f"<CompleteMultipartUploadResult>"
                       f"<Bucket>{escape(bucket)}</Bucket>"
                       f"<Key>{escape(key)}</Key>"
                       f"<ETag>\"{etag}\"</ETag>"
                       f"</CompleteMultipartUploadResult>")
                self._send(200, xml.encode())

            def _list_uploads(self, bucket):
                rows = "".join(
                    f"<Upload><Key>{escape(u['key'])}</Key>"
                    f"<UploadId>{u['upload_id']}</UploadId>"
                    f"<Initiated>{_iso(u['started'])}</Initiated>"
                    f"</Upload>"
                    for u in svc.list_multipart_uploads(bucket))
                xml = (f"<?xml version='1.0'?>"
                       f"<ListMultipartUploadsResult>"
                       f"<Bucket>{escape(bucket)}</Bucket>{rows}"
                       f"</ListMultipartUploadsResult>")
                self._send(200, xml.encode())

            def _list_parts(self, bucket, upload_id):
                rows = "".join(
                    f"<Part><PartNumber>{p['part']}</PartNumber>"
                    f"<ETag>\"{p['etag']}\"</ETag>"
                    f"<Size>{p['size']}</Size></Part>"
                    for p in svc.list_parts(bucket, upload_id))
                xml = (f"<?xml version='1.0'?><ListPartsResult>"
                       f"{rows}</ListPartsResult>")
                self._send(200, xml.encode())

            def do_HEAD(self):         # noqa: N802
                if gw.swift.maybe_handle(self, "HEAD"):
                    return
                bucket, key, q = self._split()
                try:
                    ident = self._auth(b"")
                    try:
                        head = svc.head_object(bucket, key,
                                               q.get("versionId"))
                    except RGWError:
                        # access verdict outranks existence: an
                        # unauthorized HEAD of a missing key must
                        # stay 403, not leak 404
                        svc.check_access(ident, "read", bucket, key)
                        raise
                    svc.check_access(ident, "read", bucket, key,
                                     head=head)
                    self.send_response(200)
                    self.send_header("Content-Length",
                                     str(head["size"]))
                    self.send_header("ETag", f'"{head["etag"]}"')
                    self.send_header("Content-Type",
                                     head["content_type"])
                    vid = head.get("version_id", "null")
                    if vid != "null":
                        self.send_header("x-amz-version-id", vid)
                    self.end_headers()
                except RGWError as e:
                    self.send_response(e.status)
                    self.send_header("Content-Length", "0")
                    self.end_headers()

            def do_PUT(self):          # noqa: N802
                if gw.swift.maybe_handle(self, "PUT"):
                    return
                bucket, key, q = self._split()
                # always drain the body first: leaving it unread
                # desyncs the keep-alive connection (the next request
                # line would parse from leftover body bytes)
                body = self._body()
                try:
                    ident = self._auth(body)
                    if "acl" in q:
                        svc.check_access(ident, "acl", bucket, key)
                        canned = self.headers.get("x-amz-acl",
                                                  "private")
                        if key:
                            svc.put_object_acl(bucket, key, canned)
                        else:
                            svc.put_bucket_acl(bucket, canned)
                        self._send(200)
                        return
                    if not key and "versioning" in q:
                        svc.check_access(ident, "acl", bucket)
                        import re as _re
                        m = _re.search(r"<Status>\s*(\w+)\s*"
                                       r"</Status>", body.decode(
                                           "utf-8", "replace"))
                        if not m:
                            raise RGWError(
                                400, "IllegalVersioning"
                                     "Configuration", "no Status")
                        svc.put_bucket_versioning(bucket,
                                                  m.group(1))
                        self._send(200)
                        return
                    if not key and "lifecycle" in q:
                        svc.check_access(ident, "acl", bucket)
                        svc.put_bucket_lifecycle(
                            bucket, _parse_lc_xml(body))
                        self._send(200)
                        return
                    if key and "uploadId" in q and "partNumber" in q:
                        svc.check_access(ident, "write", bucket, key)
                        try:
                            pnum = int(q["partNumber"])
                        except ValueError:
                            raise RGWError(400, "InvalidArgument",
                                           q["partNumber"])
                        etag = svc.upload_part(
                            bucket, key, q["uploadId"], pnum, body)
                        self._send(200,
                                   headers={"ETag": f'"{etag}"'})
                    elif not key:
                        if gw.auth_enabled and ident is None:
                            # anonymous callers never create buckets
                            # (S3; anonymous access is ACL-gated reads
                            # /writes on EXISTING buckets only)
                            raise RGWError(403, "AccessDenied",
                                           "anonymous create")
                        svc.create_bucket(
                            bucket, owner=ident or "",
                            acl=self.headers.get("x-amz-acl",
                                                 "private"))
                        self._send(200)
                    else:
                        svc.check_access(ident, "write", bucket,
                                         key)
                        entry = svc.put_object(
                            bucket, key, body,
                            content_type=self.headers.get(
                                "Content-Type",
                                "binary/octet-stream"),
                            acl=self.headers.get("x-amz-acl",
                                                 "private"),
                            owner=ident or "")
                        headers = {"ETag": f'"{entry["etag"]}"'}
                        if entry["version_id"] != "null":
                            headers["x-amz-version-id"] = \
                                entry["version_id"]
                        self._send(200, headers=headers)
                except RGWError as e:
                    self._error(e)

            def do_DELETE(self):       # noqa: N802
                if gw.swift.maybe_handle(self, "DELETE"):
                    return
                bucket, key, q = self._split()
                try:
                    ident = self._auth(b"")
                    if not key and "lifecycle" in q:
                        svc.check_access(ident, "acl", bucket)
                        svc.delete_bucket_lifecycle(bucket)
                        self._send(204)
                        return
                    if not key:
                        # DeleteBucket is owner-only: bucket WRITE
                        # ACL grants object creation, never bucket
                        # destruction (S3 semantics)
                        svc.check_access(ident, "acl", bucket)
                        svc.delete_bucket(bucket)
                        self._send(204)
                        return
                    svc.check_access(ident, "write", bucket, key)
                    if "uploadId" in q:
                        svc.abort_multipart(bucket, q["uploadId"])
                        self._send(204)
                    else:
                        res = svc.delete_object(
                            bucket, key, q.get("versionId"))
                        headers = {}
                        if res is not None:
                            vid = res.get("version_id", "null")
                            if vid != "null":
                                headers["x-amz-version-id"] = vid
                            if res.get("delete_marker"):
                                headers["x-amz-delete-marker"] = \
                                    "true"
                        self._send(204, headers=headers)
                except RGWError as e:
                    self._error(e)

            # ------------------------------------------------ handlers
            def _list_buckets(self, ident=None):
                rows = "".join(
                    f"<Bucket><Name>{escape(b['name'])}</Name>"
                    f"<CreationDate>{_iso(b['created'])}"
                    f"</CreationDate></Bucket>"
                    for b in svc.list_buckets()
                    if b.get("owner", "") in ("", ident))
                body = (f"<?xml version='1.0'?>"
                        f"<ListAllMyBucketsResult><Buckets>{rows}"
                        f"</Buckets></ListAllMyBucketsResult>").encode()
                self._send(200, body)

            def _list_objects(self, bucket: str, q: dict):
                try:
                    max_keys = int(q.get("max-keys", 1000))
                except ValueError:
                    raise RGWError(400, "InvalidArgument", "max-keys")
                res = svc.list_objects(
                    bucket, prefix=q.get("prefix", ""),
                    marker=q.get("marker", ""),
                    max_keys=max_keys,
                    delimiter=q.get("delimiter", ""))
                rows = "".join(
                    f"<Contents><Key>{escape(c['key'])}</Key>"
                    f"<Size>{c['size']}</Size>"
                    f"<ETag>\"{c['etag']}\"</ETag>"
                    f"<LastModified>{_iso(c['mtime'])}</LastModified>"
                    f"</Contents>" for c in res["contents"])
                cps = "".join(
                    f"<CommonPrefixes><Prefix>{escape(p)}</Prefix>"
                    f"</CommonPrefixes>"
                    for p in res["common_prefixes"])
                body = (f"<?xml version='1.0'?><ListBucketResult>"
                        f"<Name>{escape(bucket)}</Name>"
                        f"<Prefix>{escape(res['prefix'])}</Prefix>"
                        f"<IsTruncated>"
                        f"{str(res['is_truncated']).lower()}"
                        f"</IsTruncated>{rows}{cps}"
                        f"</ListBucketResult>").encode()
                self._send(200, body)

            def _get_object(self, bucket: str, key: str,
                            version_id: Optional[str] = None,
                            head: Optional[dict] = None):
                rng = None
                hdr = self.headers.get("Range", "")
                if hdr.startswith("bytes="):
                    lo, _, hi = hdr[6:].partition("-")
                    try:
                        if lo == "" and hi:
                            # suffix range: last N bytes
                            size = (head or svc.head_object(
                                bucket, key, version_id))["size"]
                            n = int(hi)
                            rng = (max(0, size - n), size - 1)
                        else:
                            rng = (int(lo),
                                   int(hi) if hi else (1 << 62))
                    except ValueError:
                        raise RGWError(416, "InvalidRange", hdr)
                head, data = svc.get_object(bucket, key, rng,
                                            version_id, head=head)
                headers = {"ETag": f'"{head["etag"]}"'}
                if head.get("version_id", "null") != "null":
                    headers["x-amz-version-id"] = \
                        head["version_id"]
                if rng:
                    # RFC 7233: 206 must carry Content-Range
                    start = rng[0]
                    headers["Content-Range"] = (
                        f"bytes {start}-{start + len(data) - 1}"
                        f"/{head['size']}")
                self._send(206 if rng else 200, data,
                           ctype=head["content_type"],
                           headers=headers)

            def log_message(self, *a):
                pass

        self._httpd = ThreadingHTTPServer(addr, Handler)
        self.addr = self._httpd.server_address
        self._thread: Optional[threading.Thread] = None
        self._lc_stop = threading.Event()
        self._lc_thread: Optional[threading.Thread] = None

    def _lc_worker(self, interval: float) -> None:
        """Lifecycle agent (reference RGWLC::LCWorker::entry): one
        expiration pass per interval until shutdown."""
        while not self._lc_stop.wait(interval):
            try:
                self.service.lc_process()
            except Exception:
                pass                 # next pass retries

    def start(self) -> "RGWServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="rgw-http",
            daemon=True)
        self._thread.start()
        from ..utils.config import default_config
        conf = getattr(self.service.ioctx.rados, "conf", None) \
            or default_config()
        interval = conf["rgw_lc_interval"]
        if interval > 0:
            self._lc_thread = threading.Thread(
                target=self._lc_worker, args=(interval,),
                name="rgw-lc", daemon=True)
            self._lc_thread.start()
        return self

    def shutdown(self) -> None:
        self._lc_stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        if self._lc_thread:
            self._lc_thread.join(timeout=5)
