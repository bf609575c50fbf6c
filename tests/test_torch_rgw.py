"""The RADOS gateway in the port (ceph_tpu_torch.rgw): S3 buckets and
objects, listings, multipart uploads, versioning, lifecycle, ACLs, the
HTTP frontend with SigV4, the Swift adapter and multisite zone sync,
on a replicated pool of the port's cluster at the config default
(crimson OSDs).

Port twins of the 25 gateway tests of tests/test_cls_rgw.py (reference
analog: src/test/rgw/); its 9 object-class tests have their twins in
tests/test_torch_objclass.py.  Then the slice held against the JAX
package: one seeded script of bucket and object operations, versioning
and a multipart upload included, on a 3-OSD cluster of each package,
with every result equal: listings with timestamps and random version
ids left out but their order kept, etags, and GET and ranged-GET
bytes."""
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from ceph_tpu_torch.cluster import Cluster
from ceph_tpu_torch.rgw import RGWError, RGWService
from ceph_tpu_torch.rgw.server import RGWServer


@pytest.fixture(scope="module")
def cl():
    with Cluster(n_osds=3) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        c.create_pool("clsp", "replicated", size=2)
        yield c


# ------------------------------------------------------------- rgw
@pytest.fixture(scope="module")
def rgw(cl):
    c = cl.rados()
    c2 = c.open_ioctx("clsp")
    return RGWService(c2)


def test_rgw_bucket_lifecycle(rgw):
    rgw.create_bucket("photos")
    assert "photos" in [b["name"] for b in rgw.list_buckets()]
    with pytest.raises(RGWError):
        rgw.create_bucket("photos")
    rgw.delete_bucket("photos")
    assert "photos" not in [b["name"] for b in rgw.list_buckets()]
    with pytest.raises(RGWError):
        rgw.delete_bucket("never-was")


def test_rgw_object_crud_and_listing(rgw):
    rgw.create_bucket("docs")
    import hashlib
    data = os.urandom(100_000)
    etag = rgw.put_object("docs", "a/1.bin", data)["etag"]
    assert etag == hashlib.md5(data).hexdigest()
    rgw.put_object("docs", "a/2.bin", b"two")
    rgw.put_object("docs", "b/3.bin", b"three")

    head, got = rgw.get_object("docs", "a/1.bin")
    assert got == data and head["etag"] == etag
    _, part = rgw.get_object("docs", "a/1.bin", rng=(10, 29))
    assert part == data[10:30]

    res = rgw.list_objects("docs")
    assert [c["key"] for c in res["contents"]] == \
        ["a/1.bin", "a/2.bin", "b/3.bin"]
    res = rgw.list_objects("docs", prefix="a/")
    assert len(res["contents"]) == 2
    res = rgw.list_objects("docs", delimiter="/")
    assert res["common_prefixes"] == ["a/", "b/"]
    res = rgw.list_objects("docs", marker="a/2.bin")
    assert [c["key"] for c in res["contents"]] == ["b/3.bin"]
    res = rgw.list_objects("docs", max_keys=2)
    assert res["is_truncated"]

    rgw.delete_object("docs", "a/1.bin")
    with pytest.raises(RGWError):
        rgw.get_object("docs", "a/1.bin")
    # bucket not empty
    with pytest.raises(RGWError):
        rgw.delete_bucket("docs")


def test_rgw_overwrite_shrinks(rgw):
    """Replacing a large object with a small one must not serve the
    old tail."""
    rgw.create_bucket("shrink")
    rgw.put_object("shrink", "k", os.urandom(60_000))
    rgw.put_object("shrink", "k", b"tiny")
    head, got = rgw.get_object("shrink", "k")
    assert got == b"tiny" and head["size"] == 4


def test_rgw_dotted_buckets_do_not_collide(rgw):
    rgw.create_bucket("x")
    rgw.create_bucket("x.y")
    rgw.put_object("x", "y.z", b"AAA")
    rgw.put_object("x.y", "z", b"BBB")
    assert rgw.get_object("x", "y.z")[1] == b"AAA"
    assert rgw.get_object("x.y", "z")[1] == b"BBB"


def test_rgw_http_frontend(cl):
    io = cl.rados().open_ioctx("clsp")
    srv = RGWServer(io).start()
    try:
        host, port = srv.addr
        base = f"http://{host}:{port}"

        def req(method, path, data=None, headers=None):
            r = urllib.request.Request(base + path, data=data,
                                       method=method,
                                       headers=headers or {})
            return urllib.request.urlopen(r, timeout=10)

        # bucket + object put
        assert req("PUT", "/web").status == 200
        body = os.urandom(50_000)
        resp = req("PUT", "/web/site/index.html", data=body,
                   headers={"Content-Type": "text/html"})
        etag = resp.headers["ETag"].strip('"')
        # get + headers
        resp = req("GET", "/web/site/index.html")
        assert resp.read() == body
        assert resp.headers["ETag"].strip('"') == etag
        assert resp.headers["Content-Type"] == "text/html"
        # range
        resp = req("GET", "/web/site/index.html",
                   headers={"Range": "bytes=100-199"})
        assert resp.status == 206 and resp.read() == body[100:200]
        # listing XML
        xml = req("GET", "/web?prefix=site/").read().decode()
        assert "<Key>site/index.html</Key>" in xml
        xml = req("GET", "/").read().decode()
        assert "<Name>web</Name>" in xml
        # delete then 404
        assert req("DELETE", "/web/site/index.html").status == 204
        with pytest.raises(urllib.error.HTTPError) as ei:
            req("GET", "/web/site/index.html")
        assert ei.value.code == 404
        assert "NoSuchKey" in ei.value.read().decode()
        assert req("DELETE", "/web").status == 204
    finally:
        srv.shutdown()


# ----------------------------------------------------- multipart + auth

def test_rgw_multipart_upload(cl):
    """Initiate -> parts -> list -> complete over HTTP (reference
    rgw_multi.cc): final bytes = concatenation, ETag = md5(md5s)-N."""
    import hashlib
    io = cl.rados().open_ioctx("clsp")
    srv = RGWServer(io).start()
    try:
        host, port = srv.addr
        base = f"http://{host}:{port}"

        def req(method, path, data=None, headers=None):
            r = urllib.request.Request(base + path, data=data,
                                       method=method,
                                       headers=headers or {})
            return urllib.request.urlopen(r, timeout=10)

        req("PUT", "/mp")
        xml = req("POST", "/mp/big.bin?uploads", data=b"").read()
        upload_id = xml.decode().split("<UploadId>")[1].split(
            "<")[0]
        parts = [os.urandom(70_000), os.urandom(50_000),
                 os.urandom(30_000)]
        etags = []
        for i, p in enumerate(parts, 1):
            r = req("PUT",
                    f"/mp/big.bin?uploadId={upload_id}"
                    f"&partNumber={i}", data=p)
            etags.append(r.headers["ETag"].strip('"'))
        lp = req("GET",
                 f"/mp/big.bin?uploadId={upload_id}").read().decode()
        assert all(f"<PartNumber>{i}</PartNumber>" in lp
                   for i in (1, 2, 3))
        cx = "".join(
            f"<Part><PartNumber>{i}</PartNumber>"
            f"<ETag>{e}</ETag></Part>"
            for i, e in enumerate(etags, 1))
        r = req("POST", f"/mp/big.bin?uploadId={upload_id}",
                data=(f"<CompleteMultipartUpload>{cx}"
                      f"</CompleteMultipartUpload>").encode())
        want_etag = hashlib.md5(
            b"".join(bytes.fromhex(e) for e in etags)).hexdigest() \
            + "-3"
        assert want_etag in r.read().decode()
        got = req("GET", "/mp/big.bin").read()
        assert got == b"".join(parts)
        # upload record cleaned up
        ul = req("GET", "/mp?uploads").read().decode()
        assert upload_id not in ul

        # abort removes everything
        xml = req("POST", "/mp/gone.bin?uploads", data=b"").read()
        uid2 = xml.decode().split("<UploadId>")[1].split("<")[0]
        req("PUT", f"/mp/gone.bin?uploadId={uid2}&partNumber=1",
            data=b"x" * 1000)
        req("DELETE", f"/mp/gone.bin?uploadId={uid2}")
        with pytest.raises(urllib.error.HTTPError):
            req("GET", "/mp/gone.bin")
    finally:
        srv.shutdown()


def test_rgw_sigv4_auth(cl):
    """SigV4 end-to-end: signed requests pass, unsigned/forged fail
    (reference rgw_auth_s3.cc verification)."""
    import http.client

    from ceph_tpu_torch.rgw.auth import UserStore, sign_request
    io = cl.rados().open_ioctx("clsp")
    users = UserStore(io)
    user = users.create_user("alice", "Alice")
    srv = RGWServer(io, auth_enabled=True).start()
    try:
        host, port = srv.addr

        def signed(method, path_q, body=b"", secret=None,
                   access=None):
            path, _, query = path_q.partition("?")
            import hashlib as _h
            payload_hash = _h.sha256(body).hexdigest()
            hdrs = sign_request(
                method, path, query, {}, payload_hash,
                access or user["access_key"],
                secret or user["secret_key"])
            conn = http.client.HTTPConnection(host, port, timeout=10)
            conn.request(method, path_q, body=body, headers=hdrs)
            resp = conn.getresponse()
            data = resp.read()
            conn.close()
            return resp.status, data

        # unsigned: denied
        conn = http.client.HTTPConnection(host, port, timeout=10)
        conn.request("PUT", "/secure")
        assert conn.getresponse().status == 403
        conn.close()
        # signed: bucket + object round trip
        assert signed("PUT", "/secure")[0] == 200
        body = os.urandom(10_000)
        assert signed("PUT", "/secure/obj", body)[0] == 200
        status, got = signed("GET", "/secure/obj")
        assert status == 200 and got == body
        # wrong secret: SignatureDoesNotMatch
        status, err = signed("GET", "/secure/obj",
                             secret="not-the-secret")
        assert status == 403 and b"SignatureDoesNotMatch" in err
        # unknown access key
        status, err = signed("GET", "/secure/obj",
                             access="AKDOESNOTEXIST000")
        assert status == 403 and b"InvalidAccessKeyId" in err
    finally:
        srv.shutdown()


def test_rgw_sigv4_encoded_key_path(cl):
    """Keys needing percent-encoding sign over the exact on-wire
    path — no double-encoding server-side."""
    import hashlib
    import http.client

    from ceph_tpu_torch.rgw.auth import UserStore, sign_request
    io = cl.rados().open_ioctx("clsp")
    users = UserStore(io)
    user = users.get_user("alice") or users.create_user("alice")
    srv = RGWServer(io, auth_enabled=True).start()
    try:
        host, port = srv.addr

        def signed(method, path, body=b""):
            ph = hashlib.sha256(body).hexdigest()
            hdrs = sign_request(method, path, "", {}, ph,
                                user["access_key"],
                                user["secret_key"])
            conn = http.client.HTTPConnection(host, port, timeout=10)
            conn.request(method, path, body=body, headers=hdrs)
            resp = conn.getresponse()
            data = resp.read()
            conn.close()
            return resp.status, data

        assert signed("PUT", "/enc")[0] == 200
        body = b"spaced out"
        assert signed("PUT", "/enc/my%20file.txt", body)[0] == 200
        status, got = signed("GET", "/enc/my%20file.txt")
        assert status == 200 and got == body
    finally:
        srv.shutdown()


def test_rgw_concurrent_part_uploads(rgw):
    """Parallel part PUTs must not lose each other (per-part omap
    rows, not a read-modify-write record)."""
    import threading
    rgw.create_bucket("cmp")
    uid = rgw.initiate_multipart("cmp", "par.bin")
    datas = {i: os.urandom(10_000 + i) for i in range(1, 5)}
    errs = []

    def put(i):
        try:
            rgw.upload_part("cmp", "par.bin", uid, i, datas[i])
        except Exception as e:
            errs.append(e)
    ts = [threading.Thread(target=put, args=(i,)) for i in datas]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs
    parts = rgw.list_parts("cmp", uid)
    assert [p["part"] for p in parts] == [1, 2, 3, 4]
    etag = rgw.complete_multipart(
        "cmp", "par.bin", uid,
        [(p["part"], p["etag"]) for p in parts])
    assert etag.endswith("-4")
    head, data = rgw.get_object("cmp", "par.bin")
    assert data == b"".join(datas[i] for i in (1, 2, 3, 4))


# ---------------------------------------------------------------------------
# versioning (reference rgw_op.cc:2661 versioning_enabled)
# ---------------------------------------------------------------------------

def test_rgw_versioning_put_get_roundtrip(rgw):
    rgw.create_bucket("vb")
    # pre-versioning object becomes the null version
    rgw.put_object("vb", "k", b"v0-null")
    assert rgw.get_bucket_versioning("vb") == ""
    rgw.put_bucket_versioning("vb", "Enabled")
    assert rgw.get_bucket_versioning("vb") == "Enabled"
    e1 = rgw.put_object("vb", "k", b"v1")
    e2 = rgw.put_object("vb", "k", b"v2")
    assert e1["version_id"] != e2["version_id"] != "null"
    # current = newest
    assert rgw.get_object("vb", "k")[1] == b"v2"
    # every version retrievable by id, including the materialized null
    assert rgw.get_object("vb", "k",
                          version_id=e1["version_id"])[1] == b"v1"
    assert rgw.get_object("vb", "k", version_id="null")[1] == b"v0-null"
    lv = rgw.list_object_versions("vb")
    vids = [v["version_id"] for v in lv["versions"]]
    assert vids == [e2["version_id"], e1["version_id"], "null"]
    assert [v["is_latest"] for v in lv["versions"]] == \
        [True, False, False]


def test_rgw_versioning_delete_marker_and_restore(rgw):
    rgw.create_bucket("vdel")
    rgw.put_bucket_versioning("vdel", "Enabled")
    e1 = rgw.put_object("vdel", "doc", b"one")
    marker = rgw.delete_object("vdel", "doc")
    assert marker["delete_marker"]
    # simple GET 404s; the version remains readable
    with pytest.raises(RGWError):
        rgw.get_object("vdel", "doc")
    assert rgw.get_object("vdel", "doc",
                          version_id=e1["version_id"])[1] == b"one"
    # object hidden from ListObjects, visible in ListVersions
    assert rgw.list_objects("vdel")["contents"] == []
    kinds = [(v.get("delete_marker", False), v["is_latest"])
             for v in rgw.list_object_versions("vdel")["versions"]]
    assert kinds == [(True, True), (False, False)]
    # deleting the marker version restores the object
    rgw.delete_object("vdel", "doc",
                      version_id=marker["version_id"])
    assert rgw.get_object("vdel", "doc")[1] == b"one"


def test_rgw_versioning_delete_specific_version(rgw):
    rgw.create_bucket("vrm")
    rgw.put_bucket_versioning("vrm", "Enabled")
    e1 = rgw.put_object("vrm", "k", b"a")
    e2 = rgw.put_object("vrm", "k", b"b")
    # deleting the CURRENT version promotes the older one
    rgw.delete_object("vrm", "k", version_id=e2["version_id"])
    assert rgw.get_object("vrm", "k")[1] == b"a"
    with pytest.raises(RGWError):
        rgw.get_object("vrm", "k", version_id=e2["version_id"])
    # deleting the last version removes the key entirely
    rgw.delete_object("vrm", "k", version_id=e1["version_id"])
    with pytest.raises(RGWError):
        rgw.head_object("vrm", "k")
    assert rgw.list_object_versions("vrm")["versions"] == []


def test_rgw_versioning_suspended_null_semantics(rgw):
    rgw.create_bucket("vsus")
    rgw.put_bucket_versioning("vsus", "Enabled")
    e1 = rgw.put_object("vsus", "k", b"kept")
    rgw.put_bucket_versioning("vsus", "Suspended")
    assert rgw.get_bucket_versioning("vsus") == "Suspended"
    # suspended PUTs write/replace the null version; enabled-era
    # versions survive
    rgw.put_object("vsus", "k", b"null-1")
    rgw.put_object("vsus", "k", b"null-2")
    assert rgw.get_object("vsus", "k")[1] == b"null-2"
    assert rgw.get_object("vsus", "k",
                          version_id=e1["version_id"])[1] == b"kept"
    vids = [v["version_id"]
            for v in rgw.list_object_versions("vsus")["versions"]]
    assert vids.count("null") == 1 and e1["version_id"] in vids


def test_rgw_versioned_multipart_and_bucket_delete_guard(rgw):
    rgw.create_bucket("vmp")
    rgw.put_bucket_versioning("vmp", "Enabled")
    uid = rgw.initiate_multipart("vmp", "big")
    p1 = rgw.upload_part("vmp", "big", uid, 1, b"A" * 50_000)
    rgw.complete_multipart("vmp", "big", uid, [(1, p1)])
    head = rgw.head_object("vmp", "big")
    assert head["version_id"] != "null"
    assert rgw.get_object("vmp", "big")[1] == b"A" * 50_000
    # a bucket holding only versions/markers refuses deletion
    rgw.delete_object("vmp", "big")
    with pytest.raises(RGWError):
        rgw.delete_bucket("vmp")


# ---------------------------------------------------------------------------
# lifecycle (reference rgw_lc.cc)
# ---------------------------------------------------------------------------

def test_rgw_lifecycle_expiration_sweep(rgw):
    import time as _t
    rgw.create_bucket("lc")
    rgw.put_object("lc", "logs/old", b"x")
    rgw.put_object("lc", "logs/new", b"y")
    rgw.put_object("lc", "data/keep", b"z")
    rgw.put_bucket_lifecycle("lc", [
        {"id": "expire-logs", "prefix": "logs/", "days": 7}])
    assert rgw.get_bucket_lifecycle("lc")[0]["days"] == 7
    # age only logs/old past the rule
    import json as _json
    from ceph_tpu_torch.rgw.gateway import _index_oid
    raw = rgw.ioctx.omap_get_by_key(_index_oid("lc"), "logs/old")
    ent = _json.loads(raw.decode())
    ent["mtime"] -= 8 * 86400
    rgw.ioctx.omap_set(_index_oid("lc"),
                       {"logs/old": _json.dumps(ent).encode()})
    stats = rgw.lc_process()
    assert stats["expired"] == 1
    with pytest.raises(RGWError):
        rgw.head_object("lc", "logs/old")
    assert rgw.head_object("lc", "logs/new")["size"] == 1
    assert rgw.head_object("lc", "data/keep")["size"] == 1


def test_rgw_lifecycle_noncurrent_and_marker_cleanup(rgw):
    rgw.create_bucket("lcv")
    rgw.put_bucket_versioning("lcv", "Enabled")
    e1 = rgw.put_object("lcv", "k", b"old")
    e2 = rgw.put_object("lcv", "k", b"new")
    rgw.put_bucket_lifecycle("lcv", [
        {"id": "nc", "prefix": "", "noncurrent_days": 3,
         "expired_delete_marker": True}])
    future = __import__("time").time() + 4 * 86400
    stats = rgw.lc_process(now=future)
    assert stats["noncurrent_removed"] >= 1
    # noncurrent version gone, current untouched
    with pytest.raises(RGWError):
        rgw.get_object("lcv", "k", version_id=e1["version_id"])
    assert rgw.get_object("lcv", "k")[1] == b"new"
    # expire the object -> delete marker; second sweep removes the
    # orphaned marker once the data version ages out too
    rgw.delete_object("lcv", "k")
    far = future + 10 * 86400
    # one sweep ages out the data version (e2, now noncurrent) AND
    # re-checks markers afterwards: the orphaned marker goes too
    stats = rgw.lc_process(now=far)
    assert stats["noncurrent_removed"] >= 1
    assert stats["markers_removed"] == 1
    assert rgw.list_object_versions("lcv")["versions"] == []
    assert e2  # silence unused warning


def test_rgw_lifecycle_validation(rgw):
    rgw.create_bucket("lbad")
    with pytest.raises(RGWError):
        rgw.put_bucket_lifecycle("lbad", [{"id": "no-action"}])
    with pytest.raises(RGWError):
        rgw.put_bucket_lifecycle("lbad", [{"days": 0}])
    rgw.put_bucket_lifecycle("lbad", [{"days": 1}])
    rgw.delete_bucket_lifecycle("lbad")
    assert rgw.get_bucket_lifecycle("lbad") == []


# ---------------------------------------------------------------------------
# ACLs (reference rgw_acl_s3.cc; canned set)
# ---------------------------------------------------------------------------

def test_rgw_acl_enforcement(rgw):
    rgw.create_bucket("priv", owner="alice")
    rgw.put_object("priv", "o", b"secret", owner="alice")
    # owner: allowed; stranger/anonymous: denied
    rgw.check_access("alice", "read", "priv", "o")
    for ident in ("bob", None):
        with pytest.raises(RGWError):
            rgw.check_access(ident, "read", "priv", "o")
    # public-read opens reads, not writes
    rgw.put_bucket_acl("priv", "public-read")
    rgw.check_access(None, "read", "priv")
    with pytest.raises(RGWError):
        rgw.check_access("bob", "write", "priv")
    # authenticated-read: any identity, not anonymous
    rgw.put_bucket_acl("priv", "authenticated-read")
    rgw.check_access("bob", "read", "priv")
    with pytest.raises(RGWError):
        rgw.check_access(None, "read", "priv")
    # object ACL overrides bucket ACL
    rgw.put_object_acl("priv", "o", "public-read")
    rgw.check_access(None, "read", "priv", "o")
    # ACL ops stay owner-only
    with pytest.raises(RGWError):
        rgw.check_access("bob", "acl", "priv")


def test_rgw_s3_versioning_acl_http_end_to_end(cl):
    """The S3 surface: versioning + ACL deny over HTTP with
    SigV4 identities."""
    import http.client

    from ceph_tpu_torch.rgw.auth import UserStore, sign_request
    from ceph_tpu_torch.rgw.server import RGWServer
    io = cl.rados().open_ioctx("clsp")
    users = UserStore(io)
    alice = users.create_user("owner-a", "A")
    bob = users.create_user("reader-b", "B")
    srv = RGWServer(io, auth_enabled=True).start()
    try:
        host, port = srv.addr

        def req(method, path_q, body=b"", user=None, headers=None):
            path, _, query = path_q.partition("?")
            import hashlib as _h
            hdrs = dict(headers or {})
            if user is not None:
                hdrs = {**hdrs, **sign_request(
                    method, path, query, hdrs,
                    _h.sha256(body).hexdigest(),
                    user["access_key"], user["secret_key"])}
            conn = http.client.HTTPConnection(host, port,
                                              timeout=10)
            conn.request(method, path_q, body=body, headers=hdrs)
            resp = conn.getresponse()
            data = resp.read()
            hdrs_out = dict(resp.getheaders())
            conn.close()
            return resp.status, data, hdrs_out

        assert req("PUT", "/vault", user=alice)[0] == 200
        assert req(
            "PUT", "/vault?versioning", user=alice,
            body=b"<VersioningConfiguration><Status>Enabled"
                 b"</Status></VersioningConfiguration>")[0] == 200
        st, _, h1 = req("PUT", "/vault/doc", b"one", user=alice)
        assert st == 200 and "x-amz-version-id" in h1
        st, _, h2 = req("PUT", "/vault/doc", b"two", user=alice)
        v1, v2 = h1["x-amz-version-id"], h2["x-amz-version-id"]
        # list versions
        st, body, _ = req("GET", "/vault?versions", user=alice)
        assert st == 200 and body.count(b"<Version>") == 2
        # read an old version by id
        st, data, _ = req("GET", f"/vault/doc?versionId={v1}",
                          user=alice)
        assert st == 200 and data == b"one"
        # bob (authenticated, not owner): denied on private bucket
        assert req("GET", "/vault/doc", user=bob)[0] == 403
        # anonymous: denied
        assert req("GET", "/vault/doc")[0] == 403
        # owner opens the BUCKET: listing opens, but the object's own
        # ACL still governs object reads (S3: bucket public-read
        # grants List, not Get on private objects)
        assert req("PUT", "/vault?acl", user=alice,
                   headers={"x-amz-acl": "public-read"})[0] == 200
        assert req("GET", "/vault", user=bob)[0] == 200
        assert req("GET", "/vault/doc", user=bob)[0] == 403
        # owner opens the OBJECT: bob + anonymous can read it
        assert req("PUT", "/vault/doc?acl", user=alice,
                   headers={"x-amz-acl": "public-read"})[0] == 200
        assert req("GET", "/vault/doc", user=bob)[0] == 200
        assert req("GET", "/vault/doc")[0] == 200
        # but writes stay denied
        assert req("PUT", "/vault/doc", b"x", user=bob)[0] == 403
        # delete -> marker header; versioned GET 404s, old id works
        st, _, hd = req("DELETE", "/vault/doc", user=alice)
        assert st == 204 and hd.get("x-amz-delete-marker") == "true"
        assert req("GET", "/vault/doc", user=alice)[0] == 404
        assert req("GET", f"/vault/doc?versionId={v2}",
                   user=alice)[0] == 200
        # lifecycle config over HTTP
        lc = (b"<LifecycleConfiguration><Rule><ID>r</ID>"
              b"<Prefix></Prefix><Status>Enabled</Status>"
              b"<Expiration><Days>5</Days></Expiration></Rule>"
              b"</LifecycleConfiguration>")
        assert req("PUT", "/vault?lifecycle", body=lc,
                   user=alice)[0] == 200
        st, body, _ = req("GET", "/vault?lifecycle", user=alice)
        assert st == 200 and b"<Days>5</Days>" in body
        assert req("DELETE", "/vault?lifecycle",
                   user=alice)[0] == 204
        assert req("GET", "/vault?lifecycle",
                   user=alice)[0] == 404
    finally:
        srv.shutdown()


def test_rgw_delete_version_promotes_by_mtime_not_vid(rgw):
    """Promotion after deleting the current version must pick the
    NEWEST surviving write — the literal 'null' vid (suspended-era
    writes) sorts after hex vids, so a lexical pick would resurrect
    older content."""
    rgw.create_bucket("vmix")
    rgw.put_bucket_versioning("vmix", "Enabled")
    rgw.put_object("vmix", "k", b"A-oldest")
    rgw.put_bucket_versioning("vmix", "Suspended")
    rgw.put_object("vmix", "k", b"B-null-newer")
    rgw.put_bucket_versioning("vmix", "Enabled")
    e3 = rgw.put_object("vmix", "k", b"C-current")
    rgw.delete_object("vmix", "k", version_id=e3["version_id"])
    assert rgw.get_object("vmix", "k")[1] == b"B-null-newer"


def test_rgw_bucket_delete_and_config_are_owner_only(cl):
    """Bucket WRITE ACL grants object writes, never DeleteBucket;
    versioning/lifecycle config reads are owner-only too."""
    import http.client

    from ceph_tpu_torch.rgw.auth import UserStore, sign_request
    from ceph_tpu_torch.rgw.server import RGWServer
    io = cl.rados().open_ioctx("clsp")
    users = UserStore(io)
    owner = users.create_user("own-c", "C")
    srv = RGWServer(io, auth_enabled=True).start()
    try:
        host, port = srv.addr

        def req(method, path_q, body=b"", user=None, headers=None):
            import hashlib as _h
            path, _, query = path_q.partition("?")
            hdrs = dict(headers or {})
            if user is not None:
                hdrs.update(sign_request(
                    method, path, query, dict(headers or {}),
                    _h.sha256(body).hexdigest(),
                    user["access_key"], user["secret_key"]))
            conn = http.client.HTTPConnection(host, port, timeout=10)
            conn.request(method, path_q, body=body, headers=hdrs)
            r = conn.getresponse()
            d = r.read()
            conn.close()
            return r.status, d

        assert req("PUT", "/open", user=owner,
                   headers={"x-amz-acl":
                            "public-read-write"})[0] == 200
        # anonymous CAN write an object (public-read-write)...
        assert req("PUT", "/open/anon-obj", b"hi")[0] == 200
        assert req("DELETE", "/open/anon-obj")[0] == 204
        # ...but can NOT delete the bucket or read its config
        assert req("DELETE", "/open")[0] == 403
        assert req("GET", "/open?versioning")[0] == 403
        assert req("GET", "/open?lifecycle")[0] == 403
        # the owner can
        assert req("GET", "/open?versioning", user=owner)[0] == 200
        assert req("DELETE", "/open", user=owner)[0] == 204
    finally:
        srv.shutdown()


def test_swift_api_end_to_end(cl):
    """The Swift dialect over the same gateway (reference
    rgw_rest_swift.cc + TempAuth): auth handshake,
    container/object CRUD, listings (plain + json), metadata
    headers — against the SAME buckets the S3 API serves."""
    import json as _json
    import urllib.request
    from urllib.error import HTTPError

    from ceph_tpu_torch.rgw.server import RGWServer
    io = cl.rados().open_ioctx("clsp")
    srv = RGWServer(io, auth_enabled=True)
    srv.start()
    try:
        user = srv.users.create_user("swifty", "Swift User")
        host, port = srv.addr
        base = f"http://{host}:{port}"

        def req(method, path, body=None, headers=None):
            r = urllib.request.Request(
                base + path, data=body, method=method,
                headers=headers or {})
            try:
                resp = urllib.request.urlopen(r, timeout=5)
                return resp.status, dict(resp.headers), resp.read()
            except HTTPError as e:
                return e.code, dict(e.headers), e.read()

        # TempAuth: bad key refused, good key issues a token
        st, _, _ = req("GET", "/auth/v1.0",
                       headers={"X-Auth-User": "swifty",
                                "X-Auth-Key": "wrong"})
        assert st == 401
        st, hdrs, _ = req("GET", "/auth/v1.0",
                          headers={"X-Auth-User": "swifty",
                                   "X-Auth-Key":
                                       user["secret_key"]})
        assert st == 204 and hdrs["X-Auth-Token"]
        tok = {"X-Auth-Token": hdrs["X-Auth-Token"]}
        sturl = hdrs["X-Storage-Url"]
        acct_path = sturl[len(base):]

        # container lifecycle + object IO with metadata
        st, _, _ = req("PUT", f"{acct_path}/swc", headers=tok)
        assert st == 201
        st, _, _ = req("PUT", f"{acct_path}/swc", headers=tok)
        assert st == 202                      # idempotent re-PUT
        payload = os.urandom(9000)
        st, hdrs, _ = req(
            "PUT", f"{acct_path}/swc/hello.bin", body=payload,
            headers=dict(tok, **{"Content-Type": "application/x-t",
                                 "X-Object-Meta-Color": "teal"}))
        assert st == 201 and hdrs["ETag"]
        st, hdrs, body = req("GET", f"{acct_path}/swc/hello.bin",
                             headers=tok)
        assert st == 200 and body == payload
        assert hdrs["X-Object-Meta-Color"] == "teal"
        assert hdrs["Content-Type"] == "application/x-t"
        st, hdrs, _ = req("HEAD", f"{acct_path}/swc/hello.bin",
                          headers=tok)
        assert st == 200 and int(hdrs["Content-Length"]) == 9000

        # listings: account + container, plain and json
        st, _, body = req("GET", acct_path, headers=tok)
        assert st == 200 and b"swc" in body
        st, _, body = req("GET", f"{acct_path}/swc?format=json",
                          headers=tok)
        rows = _json.loads(body)
        assert rows[0]["name"] == "hello.bin"
        assert rows[0]["bytes"] == 9000
        st, hdrs, _ = req("HEAD", f"{acct_path}/swc", headers=tok)
        assert hdrs["X-Container-Object-Count"] == "1"
        assert hdrs["X-Container-Bytes-Used"] == "9000"

        # the S3 dialect sees the same object (one gateway, two APIs)
        assert srv.service.get_object("swc", "hello.bin")[1] \
            == payload

        # token required; deletes; empty-container delete succeeds
        st, _, _ = req("GET", acct_path)
        assert st == 401
        st, _, _ = req("DELETE", f"{acct_path}/swc", headers=tok)
        assert st == 409                      # not empty
        st, _, _ = req("DELETE", f"{acct_path}/swc/hello.bin",
                       headers=tok)
        assert st == 204
        st, _, _ = req("DELETE", f"{acct_path}/swc", headers=tok)
        assert st == 204
    finally:
        srv.shutdown()


def _swift_two_users(srv, base, req):
    """TempAuth both test users; return {name: (token_hdrs, path)}."""
    out = {}
    for name in ("alice", "bob"):
        # users persist in the shared pool across tests
        user = srv.users.get_user(name) \
            or srv.users.create_user(name, name.title())
        st, hdrs, _ = req("GET", "/auth/v1.0",
                          headers={"X-Auth-User": name,
                                   "X-Auth-Key": user["secret_key"]})
        assert st == 204
        out[name] = ({"X-Auth-Token": hdrs["X-Auth-Token"]},
                     hdrs["X-Storage-Url"][len(base):])
    return out


def test_swift_container_delete_is_owner_only(cl):
    """Regression: container DELETE must be
    owner-only, matching S3 DeleteBucket — bucket WRITE ACL grants
    object creation, never bucket destruction.  Bucket names are a
    global namespace shared with the S3 dialect, so bob can name
    alice's container under his own account path; the request must
    die on the ACL check, not on path routing."""
    import urllib.request
    from urllib.error import HTTPError

    from ceph_tpu_torch.rgw.server import RGWServer
    io = cl.rados().open_ioctx("clsp")
    srv = RGWServer(io, auth_enabled=True)
    srv.start()
    try:
        host, port = srv.addr
        base = f"http://{host}:{port}"

        def req(method, path, body=None, headers=None):
            r = urllib.request.Request(
                base + path, data=body, method=method,
                headers=headers or {})
            try:
                resp = urllib.request.urlopen(r, timeout=5)
                return resp.status, dict(resp.headers), resp.read()
            except HTTPError as e:
                return e.code, dict(e.headers), e.read()

        users = _swift_two_users(srv, base, req)
        atok, apath = users["alice"]
        btok, bpath = users["bob"]
        assert req("PUT", f"{apath}/adel", headers=atok)[0] == 201
        # even public-read-write never grants bucket destruction
        srv.service.put_bucket_acl("adel", "public-read-write")
        st, _, _ = req("DELETE", f"{bpath}/adel", headers=btok)
        assert st == 403
        assert srv.service.get_bucket_acl("adel")["owner"] == "alice"
        # the owner still can
        st, _, _ = req("DELETE", f"{apath}/adel", headers=atok)
        assert st == 204
    finally:
        srv.shutdown()


def test_swift_container_put_foreign_bucket_403(cl):
    """Regression: PUT on a container name owned
    by another account must return 403, not the idempotent 202 —
    Swift's re-PUT convenience is for your OWN container; a global-
    namespace collision with someone else's bucket must surface."""
    import urllib.request
    from urllib.error import HTTPError

    from ceph_tpu_torch.rgw.server import RGWServer
    io = cl.rados().open_ioctx("clsp")
    srv = RGWServer(io, auth_enabled=True)
    srv.start()
    try:
        host, port = srv.addr
        base = f"http://{host}:{port}"

        def req(method, path, body=None, headers=None):
            r = urllib.request.Request(
                base + path, data=body, method=method,
                headers=headers or {})
            try:
                resp = urllib.request.urlopen(r, timeout=5)
                return resp.status, dict(resp.headers), resp.read()
            except HTTPError as e:
                return e.code, dict(e.headers), e.read()

        users = _swift_two_users(srv, base, req)
        atok, apath = users["alice"]
        btok, bpath = users["bob"]
        assert req("PUT", f"{apath}/aput", headers=atok)[0] == 201
        # owner re-PUT stays idempotent...
        assert req("PUT", f"{apath}/aput", headers=atok)[0] == 202
        # ...but a stranger colliding with the name gets refused and
        # ownership is untouched
        st, _, _ = req("PUT", f"{bpath}/aput", headers=btok)
        assert st == 403
        assert srv.service.get_bucket_acl("aput")["owner"] == "alice"
        # cleanup keeps the shared clsp pool tidy for later tests
        assert req("DELETE", f"{apath}/aput", headers=atok)[0] == 204
    finally:
        srv.shutdown()


def test_multisite_zone_sync(cl):
    """Zone-to-zone sync (reference rgw_data_sync.cc): full sync on first contact, datalog-driven
    incremental afterwards (puts, overwrites, deletes), bucket
    config convergence, and datalog trim."""
    from ceph_tpu_torch.rgw.gateway import _datalog_oid
    from ceph_tpu_torch.rgw.multisite import ZoneSyncAgent
    cl.create_pool("zoneb", "replicated", size=2)
    master = RGWService(cl.rados().open_ioctx("clsp"))
    local = RGWService(cl.rados().open_ioctx("zoneb"))
    master.create_bucket("msb", owner="alice", acl="public-read")
    d1 = os.urandom(50_000)
    master.put_object("msb", "a/one.bin", d1, meta={"k": "v"})
    master.put_object("msb", "two.txt", b"hello zone",
                      content_type="text/plain")

    agent = ZoneSyncAgent(master, local)
    out = agent.sync_once()
    assert out["msb"]["full"] and out["msb"]["copied"] == 2
    head, data = local.get_object("msb", "a/one.bin")
    assert data == d1 and head["meta"] == {"k": "v"}
    assert local._bucket_meta("msb")["acl"] == "public-read"

    # incremental: overwrite + new object + delete
    d2 = os.urandom(20_000)
    master.put_object("msb", "a/one.bin", d2)
    master.put_object("msb", "three.bin", b"3")
    master.delete_object("msb", "two.txt")
    out = agent.sync_once()
    assert not out["msb"]["full"]
    assert out["msb"]["copied"] == 2 and out["msb"]["deleted"] == 1
    assert local.get_object("msb", "a/one.bin")[1] == d2
    assert local.get_object("msb", "three.bin")[1] == b"3"
    with pytest.raises(RGWError):
        local.head_object("msb", "two.txt")
    # consumed datalog rows trimmed at the master
    assert master.ioctx.omap_get(_datalog_oid("msb")) == {}
    # idempotent re-run: nothing to do
    out = agent.sync_once()
    assert out["msb"] == {"copied": 0, "deleted": 0, "full": False}


# ------------------------------------------ the slice against the JAX package
RGW_SEED = 20261020
# fields whose values are clocks or random ids: left out of the
# comparison, the entries' order kept
_VOLATILE = ("mtime", "created", "started", "upload_id")


def _stable(v):
    """``v`` with timestamps dropped and every version id but "null"
    replaced by its rank among the ids seen so far."""
    seen = {}

    def walk(x):
        if isinstance(x, dict):
            out = {}
            for k, y in x.items():
                if k in _VOLATILE:
                    continue
                if k == "version_id" and y not in (None, "null"):
                    y = "v%d" % seen.setdefault(y, len(seen))
                out[k] = walk(y)
            return out
        if isinstance(x, (list, tuple)):
            return [walk(y) for y in x]
        return x
    return walk(v)


def _rgw_script(svc, error):
    """Seeded bucket and object operations through ``svc`` (``error`` is
    its package's RGWError); -> every result in order."""
    rng = np.random.default_rng(RGW_SEED)

    def blob(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    out = []
    for b in ("alpha", "beta"):
        svc.create_bucket(b)
    keys = [f"{p}/{i:02d}.bin" for p in ("a", "b", "c/d") for i in range(4)]
    for k in keys:
        out.append(("put", k, svc.put_object(
            "alpha", k, blob(int(rng.integers(0, 300_000))))))
    for k in keys[::3]:                  # overwrites, one past the end
        out.append(("put", k, svc.put_object(
            "alpha", k, blob(int(rng.integers(1, 80_000))))))
    out.append(("delete", svc.delete_object("alpha", keys[5])))
    for k in keys:
        try:
            head, body = svc.get_object("alpha", k)
            out.append(("get", k, head, body))
            lo = int(rng.integers(0, max(1, len(body))))
            hi = min(len(body) - 1, lo + int(rng.integers(0, 50_000)))
            if body:
                out.append(("range", k, svc.get_object(
                    "alpha", k, rng=(lo, hi))[1]))
        except error as e:
            out.append(("get", k, e.status, e.code))
    out.append(("list", svc.list_objects("alpha")))
    out.append(("list", svc.list_objects("alpha", prefix="c/",
                                         delimiter="/")))
    out.append(("list", svc.list_objects("alpha", delimiter="/")))
    out.append(("list", svc.list_objects("alpha", marker=keys[4],
                                         max_keys=3)))
    # versioning: a null version, three enabled versions, a delete
    # marker, one version removed by id
    svc.put_object("beta", "doc", blob(1000))
    svc.put_bucket_versioning("beta", "Enabled")
    vids = [svc.put_object("beta", "doc", blob(int(rng.integers(
        1, 100_000)))) for _ in range(3)]
    out.append(("versions", vids))
    out.append(("marker", svc.delete_object("beta", "doc")))
    out.append(("listv", svc.list_object_versions("beta")))
    svc.delete_object("beta", "doc", version_id=vids[1]["version_id"])
    for v in (vids[0], vids[2]):
        out.append(("getv", svc.get_object(
            "beta", "doc", version_id=v["version_id"])))
    out.append(("getv", svc.get_object("beta", "doc",
                                       version_id="null")))
    out.append(("listv", svc.list_object_versions("beta")))
    # a multipart upload of three parts into the versioned bucket
    uid = svc.initiate_multipart("beta", "big")
    parts = [(n, svc.upload_part("beta", "big", uid, n,
                                 blob(int(rng.integers(50_000, 200_000)))))
             for n in (1, 2, 3)]
    out.append(("parts", svc.list_parts("beta", uid)))
    out.append(("complete", svc.complete_multipart("beta", "big", uid,
                                                   parts)))
    head, body = svc.get_object("beta", "big")
    out.append(("get", "big", head, body))
    out.append(("range", "big", svc.get_object("beta", "big",
                                               rng=(60_000, 160_000))[1]))
    out.append(("list", svc.list_objects("beta")))
    out.append(("buckets", [b["name"] for b in svc.list_buckets()]))
    return out


def _run_rgw_script(cluster_mod, rgw_mod):
    with cluster_mod.Cluster(n_osds=3) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 30)
        c.create_pool("rgweq", "replicated", size=2)
        return _rgw_script(rgw_mod.RGWService(
            c.rados().open_ioctx("rgweq")), rgw_mod.RGWError)


def test_rgw_script_equals_jax_package():
    import hashlib

    from ceph_tpu import cluster as ref_cluster
    from ceph_tpu import rgw as ref_rgw
    from ceph_tpu_torch import cluster as port_cluster
    from ceph_tpu_torch import rgw as port_rgw
    port = _run_rgw_script(port_cluster, port_rgw)
    keys_deleted = "b/01.bin"
    ref = _run_rgw_script(ref_cluster, ref_rgw)
    assert len(port) == len(ref)
    for i, (p, r) in enumerate(zip(port, ref)):
        assert _stable(p) == _stable(r), (i, p[0])
    # the etags are S3's: md5 of a PUT's bytes, and md5 of the part
    # md5s with the part count for the multipart object
    by_op = {}
    for item in port:
        by_op.setdefault(item[0], []).append(item)
    assert ("get", keys_deleted, 404, "NoSuchKey") in by_op["get"]
    for _, k, head, body in by_op["get"]:
        if head == 404:
            continue
        if k == "big":
            parts = [p for _, ps in by_op["parts"] for p in ps]
            md5s = b"".join(bytes.fromhex(p["etag"]) for p in parts)
            assert head["etag"] == \
                hashlib.md5(md5s).hexdigest() + "-3"
            assert len(body) == sum(p["size"] for p in parts)
        elif isinstance(head, dict):
            assert head["etag"] == hashlib.md5(body).hexdigest()
    assert len(by_op["range"]) >= 10
