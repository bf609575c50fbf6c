"""Object classes in the port's OSD (ceph_tpu_torch.objclass): class calls
run inside the primary, atomically with the op, on a replicated pool of
the port's cluster at the config default (crimson OSDs), as in the
reference's tests.

Port twins of the class tests of tests/test_cls_rgw.py (lock
exclusivity and sharing, version checks, unknown classes and EC pools
refused with -ENOTSUP, class effects surviving the primary's death,
read-only calls creating nothing, several calls in one op seeing each
other's staged state, omap lookups); the RGW tests of that file wait for
the gateway's port.  Then the slice held against the JAX package: one
fixed script of lock, version and fence calls through a 3-OSD cluster
of each package, with every call's (return code, output) and each
object's final data, xattrs and omap equal."""
import json

import pytest

from ceph_tpu_torch.client.rados import RadosError
from ceph_tpu_torch.cluster import Cluster


@pytest.fixture(scope="module")
def cl():
    with Cluster(n_osds=3) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        c.create_pool("clsp", "replicated", size=2)
        yield c


@pytest.fixture(scope="module")
def io(cl):
    return cl.rados().open_ioctx("clsp")


# ------------------------------------------------ tests/test_cls_rgw.py
def test_cls_lock_exclusive(io):
    req = {"name": "l1", "type": "exclusive", "owner": "alice",
           "cookie": "c1"}
    io.exec_cls("lk1", "lock", "lock", json.dumps(req).encode())
    # same locker: re-lock ok
    io.exec_cls("lk1", "lock", "lock", json.dumps(req).encode())
    # other owner: EBUSY
    other = dict(req, owner="bob", cookie="c2")
    with pytest.raises(RadosError) as ei:
        io.exec_cls("lk1", "lock", "lock", json.dumps(other).encode())
    assert ei.value.errno == 16
    info = json.loads(io.exec_cls(
        "lk1", "lock", "get_info",
        json.dumps({"name": "l1"}).encode()))
    assert list(info["lockers"]) == ["alice c1"]
    # unlock then bob can take it
    io.exec_cls("lk1", "lock", "unlock",
                json.dumps({"name": "l1", "owner": "alice",
                            "cookie": "c1"}).encode())
    io.exec_cls("lk1", "lock", "lock", json.dumps(other).encode())
    # break bob's lock (operator recovery)
    io.exec_cls("lk1", "lock", "break_lock",
                json.dumps({"name": "l1", "locker_owner": "bob",
                            "locker_cookie": "c2"}).encode())
    info = json.loads(io.exec_cls(
        "lk1", "lock", "get_info",
        json.dumps({"name": "l1"}).encode()))
    assert info["lockers"] == {}


def test_cls_lock_shared(io):
    a = {"name": "s", "type": "shared", "owner": "a", "tag": "t"}
    b = {"name": "s", "type": "shared", "owner": "b", "tag": "t"}
    io.exec_cls("lk2", "lock", "lock", json.dumps(a).encode())
    io.exec_cls("lk2", "lock", "lock", json.dumps(b).encode())
    info = json.loads(io.exec_cls(
        "lk2", "lock", "get_info", json.dumps({"name": "s"}).encode()))
    assert len(info["lockers"]) == 2
    # exclusive attempt on shared-held lock: EBUSY
    x = {"name": "s", "type": "exclusive", "owner": "c"}
    with pytest.raises(RadosError):
        io.exec_cls("lk2", "lock", "lock", json.dumps(x).encode())


def test_cls_version(io):
    io.exec_cls("v1", "version", "set",
                json.dumps({"ver": 5}).encode())
    out = json.loads(io.exec_cls("v1", "version", "read", b""))
    assert out["ver"] == 5
    out = json.loads(io.exec_cls("v1", "version", "inc", b""))
    assert out["ver"] == 6
    io.exec_cls("v1", "version", "check",
                json.dumps({"ver": 6}).encode())
    with pytest.raises(RadosError) as ei:
        io.exec_cls("v1", "version", "check",
                    json.dumps({"ver": 99}).encode())
    assert ei.value.errno == 125


def test_cls_unknown_and_ec_rejected(cl, io):
    with pytest.raises(RadosError) as ei:
        io.exec_cls("x", "nope", "nothing", b"")
    assert ei.value.errno == 95
    cl.create_ec_profile("clsec", plugin="gpu", k="2", m="1",
                         device="cpu")
    cl.create_pool("clsecp", "erasure", erasure_code_profile="clsec")
    ecio = cl.rados().open_ioctx("clsecp")
    with pytest.raises(RadosError) as ei:
        ecio.exec_cls("o", "version", "read", b"")
    assert ei.value.errno == 95          # ENOTSUP on EC pools


def test_cls_effects_are_replicated_writes(cl, io):
    """Class effects commit through the normal write path: they must
    survive the primary's death like any write."""
    io.exec_cls("dur", "version", "set",
                json.dumps({"ver": 42}).encode())
    with cl.rados().objecter.lock:
        osdmap = cl.rados().objecter.osdmap
    pgid = osdmap.object_locator_to_pg("dur", io.pool_id)
    _, primary, _, _ = osdmap.pg_to_up_acting_osds(pgid)
    cl.kill_osd(primary)
    cl.wait_for_osd_down(primary)
    out = json.loads(io.exec_cls("dur", "version", "read", b""))
    assert out["ver"] == 42
    cl.revive_osd(primary)
    cl.wait_for_osd_up(primary)


def test_readonly_cls_call_does_not_create_object(io):
    """A read-only probe (CLS_METHOD_RD) must not materialize the
    object or write a PG-log entry."""
    out = json.loads(io.exec_cls("ghost2", "version", "read", b""))
    assert out["ver"] == 0
    with pytest.raises(RadosError):
        io.stat("ghost2")
    # and a subsequent create must not hit EEXIST from a phantom
    io.create("ghost2")


def test_shared_locker_cannot_convert_to_exclusive(io):
    a = {"name": "cv", "type": "shared", "owner": "a", "tag": "t"}
    b = {"name": "cv", "type": "shared", "owner": "b", "tag": "t"}
    io.exec_cls("lk3", "lock", "lock", json.dumps(a).encode())
    io.exec_cls("lk3", "lock", "lock", json.dumps(b).encode())
    with pytest.raises(RadosError) as ei:
        io.exec_cls("lk3", "lock", "lock", json.dumps(
            dict(a, type="exclusive")).encode())
    assert ei.value.errno == 16


def test_sequential_cls_calls_see_staged_state(io):
    """Two lock calls in ONE client op: the second must observe the
    first's staged xattr (reference executes ops sequentially against
    the in-progress transaction)."""
    from ceph_tpu_torch.msg.messages import OSDOp
    a = json.dumps({"name": "q", "type": "exclusive",
                    "owner": "a", "cookie": "1"}).encode()
    b = json.dumps({"name": "q", "type": "exclusive",
                    "owner": "b", "cookie": "2"}).encode()
    with pytest.raises(RadosError) as ei:
        io._obj_op("seq1", [OSDOp("call", name="lock.lock", data=a),
                            OSDOp("call", name="lock.lock", data=b)])
    assert ei.value.errno == 16          # second call sees first lock


def test_omap_get_by_key(io):
    io.omap_set("kv", {"alpha": b"1", "beta": b"2"})
    assert io.omap_get_by_key("kv", "alpha") == b"1"
    assert io.omap_get_by_key("kv", "gamma") is None


# ------------------------------------------- held against the JAX package
def _j(**kv) -> bytes:
    return json.dumps(kv).encode()


# (object, class, method, input): every outcome of the three classes,
# refusals included
SCRIPT = [
    ("o1", "lock", "lock", _j(name="l", type="exclusive", owner="a",
                              cookie="1", description="first")),
    ("o1", "lock", "lock", _j(name="l", type="exclusive", owner="b",
                              cookie="2")),
    ("o1", "lock", "get_info", _j(name="l")),
    ("o1", "lock", "unlock", _j(name="l", owner="a", cookie="1")),
    ("o1", "lock", "unlock", _j(name="l", owner="a", cookie="1")),
    ("o1", "lock", "lock", _j(name="s", type="shared", owner="a",
                              tag="t")),
    ("o1", "lock", "lock", _j(name="s", type="shared", owner="b",
                              tag="t")),
    ("o1", "lock", "lock", _j(name="s", type="shared", owner="c",
                              tag="u")),
    ("o1", "lock", "lock", _j(name="s", type="exclusive", owner="a",
                              tag="t")),
    ("o1", "lock", "break_lock", _j(name="s", locker_owner="b")),
    ("o1", "lock", "break_lock", _j(name="s", locker_owner="z")),
    ("o1", "lock", "get_info", _j(name="s")),
    ("o1", "lock", "lock", _j(name="x", type="upgrade", owner="a")),
    ("o1", "lock", "lock", b"not json"),
    ("o2", "version", "read", b""),
    ("o2", "version", "set", _j(ver=5, tag="t5")),
    ("o2", "version", "inc", b""),
    ("o2", "version", "check", _j(ver=6)),
    ("o2", "version", "check", _j(ver=9)),
    ("o2", "version", "set", b"{}"),
    ("o2", "version", "read", b""),
    ("o3", "fence", "set", _j(epoch=3)),
    ("o3", "fence", "guarded_append", _j(epoch=3, data="abc")),
    ("o3", "fence", "guarded_append", _j(epoch=4, data="def")),
    ("o3", "fence", "guarded_append", _j(epoch=3, data="zzz")),
    ("o3", "fence", "guarded_write_full", _j(epoch=4, data="full")),
    ("o3", "fence", "guarded_append", _j(epoch=4, data="+tail")),
    ("o3", "fence", "guarded_truncate", _j(epoch=5, size=3)),
    ("o3", "fence", "guarded_truncate", _j(epoch=4, size=0)),
    ("o3", "fence", "set", _j(epoch=2)),
    ("o3", "fence", "guarded_append", _j(data="no epoch")),
    ("o4", "nope", "nothing", b""),
    ("o4", "lock", "no_such_method", b""),
    ("o4", "version", "read", b""),
]


def _run_script(cluster_mod):
    """SCRIPT through a 3-OSD cluster of ``cluster_mod``'s package, plus
    an omap write beside the class state: each call's (ret, out), then
    each object's data, xattrs and omap (or the errno of its stat)."""
    with cluster_mod.Cluster(n_osds=3) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        c.create_pool("cq", "replicated", size=3)
        io = c.rados().open_ioctx("cq")
        results = []
        for oid, cls, method, indata in SCRIPT:
            try:
                results.append((0, bytes(io.exec_cls(oid, cls, method,
                                                     indata))))
            except Exception as e:
                results.append((-e.errno, b""))
        io.omap_set("o2", {"k1": b"v1", "k2": b"v2"})
        objects = {}
        for oid in ("o1", "o2", "o3", "o4"):
            try:
                objects[oid] = (bytes(io.read(oid)), io.getxattrs(oid),
                                io.omap_get(oid))
            except Exception as e:
                objects[oid] = -e.errno
    return results, objects


def test_class_calls_equal_jax_package():
    from ceph_tpu import cluster as ref_cluster
    from ceph_tpu_torch import cluster as port_cluster
    port_results, port_objects = _run_script(port_cluster)
    ref_results, ref_objects = _run_script(ref_cluster)
    for i, (p, r) in enumerate(zip(port_results, ref_results)):
        assert p == r, (i, SCRIPT[i], p, r)
    assert len(port_results) == len(ref_results) == len(SCRIPT)
    assert port_objects == ref_objects
    # the script reached every outcome it was written for
    codes = {ret for ret, _ in port_results}
    assert {0, -1, -2, -16, -22, -95, -125} <= codes, codes
    assert port_objects["o3"][0] == b"ful"
    assert port_objects["o4"] == -2
