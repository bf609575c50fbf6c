"""Swift-compatible REST API over the same gateway core.

Python-native equivalent of the reference's Swift frontend (reference
``src/rgw/rgw_rest_swift.cc`` + ``rgw_swift_auth.cc`` TempAuth):
the SAME buckets/objects the S3 API serves, spoken Swift —

  GET  /auth/v1.0                   TempAuth: X-Auth-User/X-Auth-Key
                                    -> X-Storage-Url + X-Auth-Token
  GET  /v1/AUTH_<acct>              list containers (plain or json)
  PUT  /v1/AUTH_<acct>/<cont>       create container
  GET  /v1/AUTH_<acct>/<cont>      list objects (prefix/marker/limit)
  HEAD /v1/AUTH_<acct>/<cont>      object count + bytes headers
  DELETE /v1/AUTH_<acct>/<cont>    remove empty container
  PUT/GET/HEAD/DELETE .../<obj>    object IO, X-Object-Meta-* carried

Tokens are process-local with a TTL (the reference's TempAuth keeps
them in cache too); accounts are the same UserStore uids the S3
SigV4 path authenticates, so one user can speak both dialects at the
same data — the defining property of the reference radosgw.
"""
from __future__ import annotations

import json
import secrets
import time
from typing import Dict, Optional, Tuple

from .gateway import RGWError

TOKEN_TTL = 3600.0


class SwiftAdapter:
    """Routes Swift-dialect requests; everything else falls through
    to the S3 handler (reference RGWREST::preprocess choosing the
    API by path prefix)."""

    def __init__(self, service, users):
        self.svc = service
        self.users = users
        self._tokens: Dict[str, Tuple[str, float]] = {}

    # -- TempAuth ------------------------------------------------------
    def _issue_token(self, uid: str) -> str:
        tok = "AUTH_tk" + secrets.token_hex(16)
        self._tokens[tok] = (uid, time.monotonic() + TOKEN_TTL)
        return tok

    def _account_of(self, token: Optional[str]) -> Optional[str]:
        if not token:
            return None
        ent = self._tokens.get(token)
        if ent is None or ent[1] < time.monotonic():
            self._tokens.pop(token, None)
            return None
        return ent[0]

    # -- entry ---------------------------------------------------------
    def maybe_handle(self, h, method: str) -> bool:
        """-> True when the request was a Swift route (handled,
        including errors); False = not Swift, S3 handler proceeds."""
        import urllib.parse
        parsed = urllib.parse.urlparse(h.path)
        path = urllib.parse.unquote(parsed.path)
        if path == "/auth/v1.0":
            self._tempauth(h, method)
            return True
        if not path.startswith("/v1/AUTH_"):
            return False
        q = {k: v[0] for k, v in urllib.parse.parse_qs(
            parsed.query, keep_blank_values=True).items()}
        # drain the request body FIRST (keep-alive invariant, same as
        # the S3 handlers): an error reply with unread body bytes
        # would desync the connection for the next request
        length = int(h.headers.get("Content-Length", 0) or 0)
        body = h.rfile.read(length) if length else b""
        try:
            self._dispatch(h, method, path, q, body)
        except RGWError as e:
            out = json.dumps({"error": e.code,
                              "message": str(e)}).encode()
            h._send(e.status, out, ctype="application/json")
        return True

    def _tempauth(self, h, method: str) -> None:
        if method != "GET":
            h._send(405, b"")
            return
        uid = h.headers.get("X-Auth-User", "")
        key = h.headers.get("X-Auth-Key", "")
        user = self.users.get_user(uid)
        # TempAuth validates against the user's SECRET key (reference
        # RGW_SWIFT_Auth_Get::execute comparing swift keys; the
        # framework folds swift keys onto the S3 secret)
        if user is None or key != user.get("secret_key"):
            h._send(401, b"")
            return
        tok = self._issue_token(uid)
        host, port = h.server.server_address
        h._send(204, b"", headers={
            "X-Storage-Url": f"http://{host}:{port}/v1/AUTH_{uid}",
            "X-Auth-Token": tok})

    # -- dispatch ------------------------------------------------------
    def _dispatch(self, h, method: str, path: str, q: dict,
                  body: bytes) -> None:
        acct = self._account_of(h.headers.get("X-Auth-Token"))
        parts = path[len("/v1/AUTH_"):].split("/", 2)
        owner = parts[0]
        if acct is None or acct != owner:
            raise RGWError(401, "AccessDenied", "bad or stale token")
        cont = parts[1] if len(parts) > 1 and parts[1] else ""
        obj = parts[2] if len(parts) > 2 else ""
        if not cont:
            if method in ("GET", "HEAD"):
                return self._account(h, acct, method, q)
            raise RGWError(405, "MethodNotAllowed", method)
        if not obj:
            return self._container(h, acct, cont, method, q)
        return self._object(h, acct, cont, obj, method, body)

    # -- account -------------------------------------------------------
    def _account(self, h, acct: str, method: str, q: dict) -> None:
        conts = [b for b in self.svc.list_buckets()
                 if b.get("owner", "") == acct]
        if method == "HEAD":
            h._send(204, b"", headers={
                "X-Account-Container-Count": str(len(conts))})
            return
        if q.get("format") == "json":
            body = json.dumps([{"name": b["name"]} for b in conts]
                              ).encode()
            h._send(200, body, ctype="application/json")
        else:
            text = "".join(f"{b['name']}\n" for b in conts)
            h._send(200 if text else 204, text.encode(),
                    ctype="text/plain")

    # -- containers ----------------------------------------------------
    def _container(self, h, acct: str, cont: str, method: str,
                   q: dict) -> None:
        if method == "PUT":
            try:
                self.svc.create_bucket(cont, owner=acct)
                h._send(201, b"")
            except RGWError as e:
                if e.code == "BucketAlreadyExists":
                    # idempotent 202 is for re-PUTting YOUR OWN
                    # container; a name collision with another
                    # account's bucket must surface, not masquerade
                    # as success
                    owner = self.svc.get_bucket_acl(cont)["owner"]
                    if owner and owner != acct:
                        raise RGWError(403, "AccessDenied", cont)
                    h._send(202, b"")    # Swift PUT is idempotent
                else:
                    raise
            return
        if method == "DELETE":
            # owner-only, matching S3 DeleteBucket: bucket WRITE ACL
            # grants object creation, never bucket destruction
            self.svc.check_access(acct, "acl", cont)
            self.svc.delete_bucket(cont)
            h._send(204, b"")
            return
        self.svc.check_access(acct, "read", cont)
        limit = int(q["limit"]) if q.get("limit") else None
        # follow continuation markers: a container larger than one
        # S3 listing page must not silently under-count or truncate
        # (Swift has no IsTruncated to warn the client)
        objs = []
        marker = q.get("marker", "")
        while True:
            listing = self.svc.list_objects(
                cont, prefix=q.get("prefix", ""), marker=marker,
                max_keys=limit - len(objs) if limit else None)
            objs.extend(listing["contents"])
            if not listing.get("is_truncated") or \
                    (limit and len(objs) >= limit):
                break
            marker = listing["contents"][-1]["key"] \
                if listing["contents"] else ""
            if not marker:
                break
        if method == "HEAD":
            h._send(204, b"", headers={
                "X-Container-Object-Count": str(len(objs)),
                "X-Container-Bytes-Used":
                    str(sum(o["size"] for o in objs))})
            return
        if q.get("format") == "json":
            body = json.dumps([
                {"name": o["key"], "bytes": o["size"],
                 "hash": o["etag"],
                 "last_modified": o["mtime"]}
                for o in objs]).encode()
            h._send(200, body, ctype="application/json")
        else:
            text = "".join(f"{o['key']}\n" for o in objs)
            h._send(200 if text else 204, text.encode(),
                    ctype="text/plain")

    # -- objects -------------------------------------------------------
    def _object(self, h, acct: str, cont: str, obj: str,
                method: str, body: bytes) -> None:
        if method == "PUT":
            self.svc.check_access(acct, "write", cont, obj)
            data = body
            meta = {k[len("X-Object-Meta-"):]: v
                    for k, v in h.headers.items()
                    if k.startswith("X-Object-Meta-")}
            out = self.svc.put_object(
                cont, obj, data,
                content_type=h.headers.get(
                    "Content-Type", "application/octet-stream"),
                meta=meta, owner=acct)
            h._send(201, b"", headers={"ETag": out["etag"]})
            return
        if method == "DELETE":
            self.svc.check_access(acct, "write", cont, obj)
            self.svc.delete_object(cont, obj)
            h._send(204, b"")
            return
        self.svc.check_access(acct, "read", cont, obj)
        head, data = self.svc.get_object(cont, obj)
        headers = {"ETag": head["etag"]}
        for k, v in (head.get("meta") or {}).items():
            headers[f"X-Object-Meta-{k}"] = v
        if method == "HEAD":
            headers["Content-Length"] = str(head["size"])
            headers["Content-Type"] = head["content_type"]
            h.send_response(200)
            for k, v in headers.items():
                h.send_header(k, v)
            h.end_headers()
            return
        h._send(200, data, ctype=head["content_type"],
                headers=headers)
