"""S3 authentication: user store + AWS Signature V4 verification.

Python-native equivalent of the reference's RGW auth layer (reference
``src/rgw/rgw_auth_s3.{h,cc}`` AWSv4ComplMulti/rgw_create_s3_v4_*
+ the user store RGWUserCtl / radosgw-admin ``user create``):

* users live in a RADOS omap (`rgw.users`): uid -> access/secret keys
  and display name, keyed ALSO by access key for O(1) auth lookup;
* requests carry ``Authorization: AWS4-HMAC-SHA256 Credential=...``;
  the gateway rebuilds the canonical request per the public SigV4
  spec, derives the signing key from the stored secret, and compares
  digests constant-time.  ``UNSIGNED-PAYLOAD`` and signed payload
  hashes are both accepted (the reference likewise).
"""
from __future__ import annotations

import calendar
import hashlib
import hmac
import json
import secrets
import time
import urllib.parse
from typing import Dict, Optional, Tuple

from ..client.rados import RadosError
from .gateway import RGWError

USERS_OID = "rgw.users"
AKEY_PREFIX = "ak."                  # access-key -> uid mapping rows
SKEW = 15 * 60                       # clock skew window (reference 15m)


class UserStore:
    """radosgw-admin-style user admin (reference RGWUserCtl)."""

    def __init__(self, ioctx):
        self.ioctx = ioctx

    def create_user(self, uid: str, display_name: str = "") -> dict:
        if self.get_user(uid) is not None:
            raise RGWError(409, "UserAlreadyExists", uid)
        access = "AK" + secrets.token_hex(9).upper()
        secret = secrets.token_urlsafe(30)
        user = {"uid": uid, "display_name": display_name or uid,
                "access_key": access, "secret_key": secret,
                "created": time.time()}
        self.ioctx.omap_set(USERS_OID, {
            uid: json.dumps(user).encode(),
            AKEY_PREFIX + access: uid.encode()})
        return user

    def get_user(self, uid: str) -> Optional[dict]:
        try:
            raw = self.ioctx.omap_get_by_key(USERS_OID, uid)
        except RadosError:
            return None
        return json.loads(raw.decode()) if raw else None

    def user_by_access_key(self, access: str) -> Optional[dict]:
        try:
            uid = self.ioctx.omap_get_by_key(USERS_OID,
                                             AKEY_PREFIX + access)
        except RadosError:
            return None
        return self.get_user(uid.decode()) if uid else None

    def remove_user(self, uid: str) -> None:
        user = self.get_user(uid)
        if user is None:
            raise RGWError(404, "NoSuchUser", uid)
        self.ioctx.omap_rm_keys(USERS_OID, [
            uid, AKEY_PREFIX + user["access_key"]])

    def list_users(self):
        try:
            omap = self.ioctx.omap_get(USERS_OID)
        except RadosError:
            return []
        return sorted(k for k in omap
                      if not k.startswith(AKEY_PREFIX))


# ---------------------------------------------------------------------------
# SigV4 (public AWS spec; reference rgw_auth_s3.cc)
# ---------------------------------------------------------------------------

def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def signing_key(secret: str, date: str, region: str,
                service: str = "s3") -> bytes:
    k = _hmac(("AWS4" + secret).encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def _canonical_query(query: str) -> str:
    pairs = []
    for part in query.split("&") if query else []:
        if not part:
            continue
        k, _, v = part.partition("=")
        pairs.append((urllib.parse.quote(urllib.parse.unquote(k),
                                         safe="-_.~"),
                      urllib.parse.quote(urllib.parse.unquote(v),
                                         safe="-_.~")))
    return "&".join(f"{k}={v}" for k, v in sorted(pairs))


def sign_request(method: str, path: str, query: str,
                 headers: Dict[str, str], payload_hash: str,
                 access: str, secret: str, region: str = "us-east-1",
                 amz_date: Optional[str] = None) -> Dict[str, str]:
    """Client-side signer (tests + any SDK-less tooling): returns the
    headers to add (Authorization, x-amz-date, x-amz-content-sha256)."""
    amz_date = amz_date or time.strftime("%Y%m%dT%H%M%SZ",
                                         time.gmtime())
    date = amz_date[:8]
    hdrs = {k.lower(): v.strip() for k, v in headers.items()}
    hdrs["x-amz-date"] = amz_date
    hdrs["x-amz-content-sha256"] = payload_hash
    signed = ";".join(sorted(hdrs))
    # ``path`` must be the exact (already percent-encoded) path that
    # will go on the request line
    canonical = "\n".join([
        method,
        path,
        _canonical_query(query),
        "".join(f"{k}:{hdrs[k]}\n" for k in sorted(hdrs)),
        signed,
        payload_hash])
    scope = f"{date}/{region}/s3/aws4_request"
    sts = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical.encode()).hexdigest()])
    sig = hmac.new(signing_key(secret, date, region), sts.encode(),
                   hashlib.sha256).hexdigest()
    return {
        "x-amz-date": amz_date,
        "x-amz-content-sha256": payload_hash,
        "Authorization": (
            f"AWS4-HMAC-SHA256 Credential={access}/{scope}, "
            f"SignedHeaders={signed}, Signature={sig}"),
    }


class SigV4Verifier:
    """Server-side verification (reference rgw::auth::s3)."""

    def __init__(self, users: UserStore):
        self.users = users

    def verify(self, method: str, path: str, query: str,
               headers: Dict[str, str], body: bytes) -> dict:
        """-> the authenticated user dict; raises RGWError."""
        headers = {k.lower(): str(v).strip()
                   for k, v in headers.items()}
        auth = headers.get("authorization", "")
        if not auth.startswith("AWS4-HMAC-SHA256 "):
            raise RGWError(403, "AccessDenied",
                           "missing SigV4 authorization")
        fields: Dict[str, str] = {}
        for part in auth[len("AWS4-HMAC-SHA256 "):].split(","):
            k, _, v = part.strip().partition("=")
            fields[k] = v
        try:
            access, date, region, service, term = \
                fields["Credential"].split("/")
            signed_headers = fields["SignedHeaders"].split(";")
            given_sig = fields["Signature"]
        except (KeyError, ValueError):
            raise RGWError(400, "AuthorizationHeaderMalformed", auth)
        user = self.users.user_by_access_key(access)
        if user is None:
            raise RGWError(403, "InvalidAccessKeyId", access)

        amz_date = headers.get("x-amz-date", "")
        if not amz_date:
            raise RGWError(403, "AccessDenied", "missing x-amz-date")
        try:
            req_time = calendar.timegm(time.strptime(
                amz_date, "%Y%m%dT%H%M%SZ"))
        except ValueError:
            raise RGWError(403, "AccessDenied", "bad x-amz-date")
        if abs(time.time() - req_time) > SKEW:
            raise RGWError(403, "RequestTimeTooSkewed", amz_date)

        payload_hash = headers.get("x-amz-content-sha256",
                                   "UNSIGNED-PAYLOAD")
        if payload_hash not in ("UNSIGNED-PAYLOAD",):
            actual = hashlib.sha256(body).hexdigest()
            if payload_hash != actual:
                raise RGWError(400, "XAmzContentSHA256Mismatch",
                               payload_hash)

        # canonical URI = the path exactly as sent on the request
        # line (clients sign the single-encoded form; re-quoting here
        # would double-encode %xx and reject keys with spaces)
        canonical = "\n".join([
            method,
            path,
            _canonical_query(query),
            "".join(f"{k}:{headers.get(k, '')}\n"
                    for k in sorted(signed_headers)),
            ";".join(sorted(signed_headers)),
            payload_hash])
        scope = f"{date}/{region}/{service}/{term}"
        sts = "\n".join([
            "AWS4-HMAC-SHA256", amz_date, scope,
            hashlib.sha256(canonical.encode()).hexdigest()])
        want = hmac.new(
            signing_key(user["secret_key"], date, region, service),
            sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, given_sig):
            raise RGWError(403, "SignatureDoesNotMatch", access)
        return user
