"""The striper in the port (ceph_tpu_torch.client.striper): client-side
RAID-0 of a logical entity over many objects, with its size and layout
as xattrs on the first object.

Port twins of all 9 tests of tests/test_striper.py (the layout algebra
against a byte-by-byte oracle, then write, read, overwrite, sparse
write, truncate and remove on a replicated pool of the port's cluster
at the config default, crimson).  Then the slice held against the JAX
package: ``file_to_extents`` equal to the reference's for drawn layouts,
offsets and lengths; and one striped entity with overwrites through a
k=4 m=2 pool (``allow_ec_overwrites``) of a 6-OSD cluster of each
package, the `gpu` plugin on the CPU against the reference's `tpu`,
with every object's bytes and xattrs and every shard's bytes and hinfo
equal, as tests/test_torch_cluster.py holds the cluster."""
import os
import random

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from ceph_tpu_torch.client.rados import RadosError
from ceph_tpu_torch.client.striper import (Layout, StripedIoCtx,
                                           file_to_extents, object_name)
from ceph_tpu_torch.cluster import Cluster

from test_torch_cluster import _seq_snapshot


# ---------------------------------------------------------------- math
def simulate(layout, offset, length):
    """Oracle: place every byte individually."""
    su, sc, spo = (layout.stripe_unit, layout.stripe_count,
                   layout.stripes_per_object)
    placed = {}
    for pos in range(offset, offset + length):
        blockno = pos // su
        stripeno = blockno // sc
        objectno = (stripeno // spo) * sc + blockno % sc
        x = (stripeno % spo) * su + pos % su
        placed[pos] = (objectno, x)
    return placed


@pytest.mark.parametrize("layout", [
    Layout(stripe_unit=4, stripe_count=1, object_size=16),
    Layout(stripe_unit=4, stripe_count=3, object_size=8),
    Layout(stripe_unit=16, stripe_count=2, object_size=64),
])
@pytest.mark.parametrize("offset,length", [
    (0, 1), (0, 100), (3, 29), (17, 64), (64, 1), (5, 0)])
def test_file_to_extents_matches_byte_oracle(layout, offset, length):
    exts = file_to_extents("s", layout, offset, length)
    oracle = simulate(layout, offset, length)
    got = {}
    for ext in exts:
        x = ext.offset
        for lo, ln in ext.buffer_extents:
            for i in range(ln):
                got[lo + i] = (ext.objectno, x)
                x += 1
    assert got == oracle
    # every extent's buffer lengths sum to its length
    for ext in exts:
        assert sum(ln for _, ln in ext.buffer_extents) == ext.length


def test_extents_coalesce_within_object():
    # su=4 sc=1: consecutive su blocks land back-to-back in one object
    layout = Layout(stripe_unit=4, stripe_count=1, object_size=16)
    exts = file_to_extents("s", layout, 0, 16)
    assert len(exts) == 1
    assert exts[0].offset == 0 and exts[0].length == 16


def test_layout_validation():
    with pytest.raises(ValueError):
        Layout(stripe_unit=5, stripe_count=1,
               object_size=16).validate()
    with pytest.raises(ValueError):
        Layout(stripe_unit=0).validate()


def test_object_naming_matches_libradosstriper():
    assert object_name("vol", 0) == "vol.0000000000000000"
    assert object_name("vol", 255) == "vol.00000000000000ff"


# ------------------------------------------------------------- cluster
@pytest.fixture(scope="module")
def cl():
    with Cluster(n_osds=3) as c:
        for i in range(3):
            c.wait_for_osd_up(i, 20)
        c.create_pool("strp", "replicated", size=2)
        yield c


@pytest.fixture(scope="module")
def sio(cl):
    io = cl.rados().open_ioctx("strp")
    return StripedIoCtx(io, Layout(stripe_unit=8 << 10,
                                   stripe_count=3,
                                   object_size=32 << 10))


def test_striped_write_read_roundtrip(sio):
    data = os.urandom(200_000)        # spans several object sets
    sio.write("vol1", data)
    assert sio.read("vol1") == data
    size, layout = sio.stat("vol1")
    assert size == len(data)
    assert layout.stripe_count == 3
    # the data really is spread over multiple objects
    objs = [o for o in sio.ioctx.list_objects() if o.startswith("vol1.")]
    assert len(objs) > 3


def test_striped_partial_reads_and_overwrites(sio):
    base = bytearray(os.urandom(100_000))
    sio.write("vol2", bytes(base))
    rng = random.Random(3)
    for _ in range(10):
        off = rng.randrange(0, 90_000)
        ln = rng.randrange(1, 9_000)
        assert sio.read("vol2", ln, off) == bytes(base[off:off + ln])
    patch = os.urandom(20_000)
    sio.write("vol2", patch, 37_123)
    base[37_123:37_123 + len(patch)] = patch
    assert sio.read("vol2") == bytes(base)


def test_striped_sparse_write_reads_zeros(sio):
    sio.write("vol3", b"tail", 150_000)
    data = sio.read("vol3")
    assert len(data) == 150_004
    assert data[:150_000] == b"\0" * 150_000
    assert data[150_000:] == b"tail"


def test_striped_truncate(sio):
    data = os.urandom(120_000)
    sio.write("vol4", data)
    sio.truncate("vol4", 50_000)
    assert sio.read("vol4") == data[:50_000]
    size, _ = sio.stat("vol4")
    assert size == 50_000
    # grow again: hole past the old end
    sio.truncate("vol4", 60_000)
    got = sio.read("vol4")
    assert got[:50_000] == data[:50_000]
    assert got[50_000:] == b"\0" * 10_000


def test_striped_remove(sio):
    sio.write("vol5", os.urandom(100_000))
    sio.remove("vol5")
    with pytest.raises(RadosError):
        sio.stat("vol5")
    leftovers = [o for o in sio.ioctx.list_objects()
                 if o.startswith("vol5.")]
    assert leftovers == []


# ------------------------------------------- held against the JAX package
def _extents(mod, layout_args, offset, length):
    layout = mod.Layout(**layout_args)
    return [(e.oid, e.objectno, e.offset, e.length, e.buffer_extents)
            for e in mod.file_to_extents("ent", layout, offset, length)]


@settings(max_examples=300, deadline=None)
@given(su=st.integers(1, 64), sc=st.integers(1, 6), spo=st.integers(1, 8),
       offset=st.integers(0, 4000), length=st.integers(0, 4000))
def test_file_to_extents_equal_jax_package(su, sc, spo, offset, length):
    from ceph_tpu.client import striper as ref
    from ceph_tpu_torch.client import striper as port
    args = {"stripe_unit": su, "stripe_count": sc,
            "object_size": su * spo}
    assert _extents(port, args, offset, length) == \
        _extents(ref, args, offset, length)


ENTITY_SEED = 20261017
ENTITY_BYTES = 3 << 20               # 3 MiB over the default Layout():
                                     # objects 0-3 of 768 KiB each
# (offset, length) of the overwrites: a committed stripe's two columns,
# a run across an object boundary, and a write past the end
PATCHES = [(70_000, 5_000), (65_536 * 3 - 100, 9_000),
           (ENTITY_BYTES + 1000, 4_000)]


def _entity():
    rng = np.random.default_rng(ENTITY_SEED)
    data = rng.integers(0, 256, ENTITY_BYTES, dtype=np.uint8).tobytes()
    patches = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
               for _, n in PATCHES]
    return data, patches


def _run_striped(cluster_mod, striper_mod, profile):
    """The entity written through ``striper_mod`` with the default
    Layout() over a k=4 m=2 pool of a 6-OSD cluster of
    ``cluster_mod``'s package, then overwritten; a snapshot of the
    objects' placements, shards and reads after each step, with the
    first object's xattrs and the striped read-back."""
    conf = cluster_mod.test_config(osd_pool_default_pg_num=4)
    data, patches = _entity()
    out = []
    # OSDs boot one at a time, so both packages place alike (see
    # tests/test_torch_cluster.py)
    with cluster_mod.Cluster(n_osds=0, conf=conf) as c:
        for i in range(6):
            c.start_osd(i)
            c.wait_for_osd_up(i, 30)
        c.create_ec_profile("sq", **profile)
        c.create_pool("sqp", "erasure", erasure_code_profile="sq",
                      pg_num=4)
        ret, rs, _ = c.mon_command({"prefix": "osd pool set",
                                    "pool": "sqp",
                                    "var": "allow_ec_overwrites",
                                    "val": "true"})
        assert ret == 0, rs
        r = c.rados(timeout=30)
        r.op_timeout = 60.0
        r.wait_for_epoch(c.mon.osdmap.epoch, 10)
        io = r.open_ioctx("sqp")
        sio = striper_mod.StripedIoCtx(io, striper_mod.Layout())
        sio.write("ent", data)
        steps = [()] + [(p,) for p in range(len(PATCHES))]
        for step in steps:
            for p in step:
                sio.write("ent", patches[p], PATCHES[p][0])
            c.wait_for_clean(30)
            names = set(o for o in io.list_objects()
                        if o.startswith("ent."))
            acting, shards, reads = _seq_snapshot(c, io, names)
            out.append((acting, shards, reads,
                        io.getxattrs(striper_mod.object_name("ent", 0)),
                        sio.read("ent")))
    return out


def test_striped_entity_on_ec_pool_equal_jax_package():
    from ceph_tpu import cluster as ref_cluster
    from ceph_tpu.client import striper as ref_striper
    from ceph_tpu_torch import cluster as port_cluster
    from ceph_tpu_torch.client import striper as port_striper
    port = _run_striped(port_cluster, port_striper,
                        {"plugin": "gpu", "k": "4", "m": "2",
                         "device": "cpu"})
    ref = _run_striped(ref_cluster, ref_striper,
                       {"plugin": "tpu", "k": "4", "m": "2"})
    data, patches = _entity()
    want = bytearray(data)
    for step, (p, r) in enumerate(zip(port, ref)):
        if step:
            off, n = PATCHES[step - 1]
            if off + n > len(want):
                want.extend(bytes(off + n - len(want)))
            want[off:off + n] = patches[step - 1]
        p_acting, p_shards, p_reads, p_attrs, p_read = p
        r_acting, r_shards, r_reads, r_attrs, r_read = r
        assert p_acting == r_acting, step
        assert sorted(p_shards) == sorted(r_shards), step
        for key in r_shards:
            assert p_shards[key] == r_shards[key], (step, key)
        assert p_reads == r_reads, step
        assert p_attrs == r_attrs, step
        assert p_read == r_read == bytes(want), step
        # the entity spans its objects: 4 after the writes, and each
        # object's every shard is held on 6 OSDs
        per_obj = {}
        for (osd_id, _, oid, shard) in p_shards:
            per_obj.setdefault(oid, set()).add(shard)
        assert len(per_obj) >= 4
        assert all(v == set(range(6)) for v in per_obj.values()), per_obj
    assert len(port) == len(ref) == len(PATCHES) + 1
