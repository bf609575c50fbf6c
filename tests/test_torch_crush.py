"""The port's placement layer (ceph_tpu_torch.crush, osd/osdmap.py)
against the JAX package's.

Twins of tests/test_crush.py and tests/test_osdmap.py on the port, then
the same placements from both packages: the hashes, do_rule and
pg_to_up_acting_osds of a 13-OSD map at 256 PGs of a k=8 m=4 `indep`
pool and of a size-3 replicated pool, before and after one OSD is marked
out, and each package's wire form of an OSDMap loaded by the other.
"""
import collections

import numpy as np
import pytest

from ceph_tpu.crush import mapper as ref_mapper
from ceph_tpu.crush import wrapper as ref_wrapper
from ceph_tpu.osd import osdmap as ref_osdmap
from ceph_tpu_torch.crush.mapper import (CRUSH_ITEM_NONE, Bucket,
                                         crush_hash32_2, crush_hash32_3)
from ceph_tpu_torch.crush import wrapper as port_wrapper
from ceph_tpu_torch.crush.wrapper import CrushWrapper, build_flat_map
from ceph_tpu_torch.osd import osdmap as port_osdmap
from ceph_tpu_torch.osd.osdmap import (Incremental, OSDMap, PGid, PGPool,
                                       ceph_stable_mod,
                                       ceph_str_hash_rjenkins, pg_num_mask)

IN = 0x10000  # full weight


def weights(n, out=()):
    return [0 if i in out else IN for i in range(n)]


# ----------------------------------------- twins of tests/test_crush.py
class TestHash:
    def test_deterministic(self):
        assert crush_hash32_2(1, 2) == crush_hash32_2(1, 2)
        assert crush_hash32_3(1, 2, 3) == crush_hash32_3(1, 2, 3)

    def test_spread(self):
        vals = {crush_hash32_2(x, 7) for x in range(1000)}
        assert len(vals) > 990


class TestFirstn:
    def test_deterministic_and_distinct(self):
        crush = build_flat_map(10, osds_per_host=2)
        rid = crush.add_simple_rule("r", "default", "host", mode="firstn")
        for x in range(50):
            out = crush.do_rule(rid, x, 3, weights(10))
            assert out == crush.do_rule(rid, x, 3, weights(10))
            assert len(out) == 3
            assert len(set(out)) == 3
            assert len({o // 2 for o in out}) == 3

    def test_out_osd_replaced(self):
        crush = build_flat_map(10, osds_per_host=2)
        rid = crush.add_simple_rule("r", "default", "host", mode="firstn")
        for x in range(30):
            base = crush.do_rule(rid, x, 3, weights(10))
            victim = base[0]
            out = crush.do_rule(rid, x, 3, weights(10, out={victim}))
            assert victim not in out
            assert len(set(out)) == 3
            assert out[:2] != [CRUSH_ITEM_NONE, CRUSH_ITEM_NONE]

    def test_distribution_tracks_weight(self):
        crush = build_flat_map(4, osds_per_host=1)
        crush.adjust_item_weight(0, 2.0)
        rid = crush.add_simple_rule("r", "default", "osd", mode="firstn")
        counts = collections.Counter()
        for x in range(4000):
            counts[crush.do_rule(rid, x, 1, weights(4))[0]] += 1
        others = sum(counts[i] for i in (1, 2, 3)) / 3
        assert counts[0] > 1.5 * others


class TestIndep:
    def test_holes_and_stability(self):
        crush = build_flat_map(12, osds_per_host=2)
        rid = crush.add_simple_rule("ec", "default", "host", mode="indep",
                                    pool_type="erasure")
        moved_total = 0
        for x in range(30):
            base = crush.do_rule(rid, x, 4, weights(12))
            assert len(base) == 4
            assert CRUSH_ITEM_NONE not in base
            victim = base[2]
            out = crush.do_rule(rid, x, 4, weights(12, out={victim}))
            assert out[0] == base[0] and out[1] == base[1] \
                and out[3] == base[3], "untouched positions must be stable"
            assert out[2] != victim
            moved_total += sum(1 for a, b in zip(base, out) if a != b)
        assert moved_total <= 30

    def test_unsatisfiable_leaves_hole(self):
        crush = build_flat_map(3, osds_per_host=1)
        rid = crush.add_simple_rule("ec", "default", "host", mode="indep")
        out = crush.do_rule(rid, 1234, 4, weights(3))
        assert len(out) == 4
        assert out.count(CRUSH_ITEM_NONE) == 1
        assert len({o for o in out if o != CRUSH_ITEM_NONE}) == 3


class TestDeviceClasses:
    def test_class_filtering(self):
        crush = CrushWrapper()
        crush.add_bucket("default", "root")
        crush.add_bucket("h0", "host")
        crush.insert_item(crush.name_ids["h0"], 0, "h0", "default")
        for osd in range(6):
            cls = "ssd" if osd % 2 == 0 else "hdd"
            crush.insert_item(osd, 1.0, f"osd.{osd}", "h0",
                              device_class=cls)
        rid = crush.add_simple_rule("ssd_rule", "default", "osd",
                                    device_class="ssd", mode="firstn")
        for x in range(40):
            out = crush.do_rule(rid, x, 2, weights(6))
            assert all(o % 2 == 0 for o in out), f"non-ssd osd in {out}"

    def test_shadow_invalidated_on_change(self):
        crush = CrushWrapper()
        crush.add_bucket("default", "root")
        crush.add_bucket("h0", "host")
        crush.insert_item(crush.name_ids["h0"], 0, "h0", "default")
        crush.insert_item(0, 1.0, "osd.0", "h0", device_class="ssd")
        rid = crush.add_simple_rule("r", "default", "osd",
                                    device_class="ssd", mode="firstn")
        assert crush.do_rule(rid, 1, 1, weights(1)) == [0]
        crush.insert_item(1, 1.0, "osd.1", "h0", device_class="ssd")
        seen = {crush.do_rule(rid, x, 1, weights(2))[0] for x in range(50)}
        assert seen == {0, 1}


class TestWrapper:
    def test_rule_bookkeeping(self):
        crush = build_flat_map(4)
        rid = crush.add_simple_rule("r", "default", "host")
        crush.set_rule_mask_max_size(rid, 6)
        assert crush.rule_id("r") == rid
        assert crush.map.rules[rid].max_size == 6
        with pytest.raises(KeyError):
            crush.add_simple_rule("r", "default", "host")

    def test_dump(self):
        crush = build_flat_map(2)
        crush.add_simple_rule("r", "default", "host")
        d = crush.dump()
        assert len(d["devices"]) == 2
        assert any(b["name"] == "default" for b in d["buckets"])
        assert d["rules"][0]["name"] == "r"

    def test_ec_create_rule_integration(self):
        """The port's ErasureCode.create_rule plugs into the port's
        wrapper (reference ErasureCode.cc:64-83)."""
        from ceph_tpu_torch.ec import registry as ecreg
        crush = build_flat_map(12, osds_per_host=2)
        codec = ecreg.instance().factory("jerasure", {"k": "4", "m": "2"})
        rid = codec.create_rule("ecpool_rule", crush)
        assert crush.rule_max_size[rid] == 6
        out = crush.do_rule(rid, 42, 6, weights(12))
        assert len(out) == 6
        assert CRUSH_ITEM_NONE not in out


class TestUniformBucket:
    def _bucket(self, n=8):
        b = Bucket(-1, 1, alg="uniform")
        for i in range(n):
            b.add_item(i, IN)
        return b

    def test_even_spread(self):
        b = self._bucket(8)
        counts = collections.Counter(b.choose(x, 0) for x in range(16000))
        mean = 16000 / 8
        for item, c in counts.items():
            assert abs(c - mean) / mean < 0.15, \
                f"item {item}: {c} vs mean {mean:.0f}"
        assert len(counts) == 8, "some item never chosen"

    def test_positions_decorrelated(self):
        b = self._bucket(8)
        same = sum(1 for x in range(8000)
                   if b.choose(x, 0) == b.choose(x, 1))
        assert same / 8000 < 0.2, f"r-correlated picks: {same}/8000"

    def test_stability_under_input(self):
        b = self._bucket(8)
        assert [b.choose(x, 0) for x in range(100)] == \
            [b.choose(x, 0) for x in range(100)]


# ---------------------------------------- twins of tests/test_osdmap.py
def make_map(n_osds=6, pg_num=32, ec=False, k=4, m=2):
    osdmap = OSDMap()
    crush = build_flat_map(n_osds, osds_per_host=2)
    inc = Incremental(1)
    inc.new_crush = crush
    inc.new_max_osd = n_osds
    for o in range(n_osds):
        inc.new_up[o] = ("127.0.0.1", 7000 + o)
    if ec:
        rid = crush.add_simple_rule("ecrule", "default", "osd",
                                    mode="indep", pool_type="erasure")
        pool = PGPool(name="ecpool", pool_id=1, type="erasure",
                      size=k + m, min_size=k, pg_num=pg_num,
                      crush_rule=rid, erasure_code_profile="default",
                      stripe_width=4096 * k)
    else:
        rid = crush.add_simple_rule("reprule", "default", "host",
                                    mode="firstn")
        pool = PGPool(name="rbd", pool_id=1, size=3, min_size=2,
                      pg_num=pg_num, crush_rule=rid)
    inc.new_pools[1] = pool
    osdmap.apply_incremental(inc)
    return osdmap


class TestHashing:
    def test_stable_mod_splitting(self):
        for x in range(1000):
            before = ceph_stable_mod(x, 8, 15)
            after = ceph_stable_mod(x, 16, 15)
            assert after in (before, before + 8)

    def test_str_hash_deterministic(self):
        assert ceph_str_hash_rjenkins(b"foo") == \
            ceph_str_hash_rjenkins(b"foo")
        assert ceph_str_hash_rjenkins(b"foo") != \
            ceph_str_hash_rjenkins(b"bar")

    def test_pg_num_mask(self):
        assert pg_num_mask(8) == 7
        assert pg_num_mask(12) == 15
        assert pg_num_mask(1) == 0


class TestMapping:
    def test_object_to_pg_stable(self):
        osdmap = make_map()
        pg = osdmap.object_locator_to_pg("myobject", 1)
        assert pg == osdmap.object_locator_to_pg("myobject", 1)
        assert 0 <= pg.seed < 32

    def test_pg_spread(self):
        osdmap = make_map()
        seeds = {osdmap.object_locator_to_pg(f"obj{i}", 1).seed
                 for i in range(500)}
        assert len(seeds) > 25

    def test_replicated_up_acting(self):
        osdmap = make_map()
        for s in range(32):
            up, prim, acting, _ = osdmap.pg_to_up_acting_osds(PGid(1, s))
            assert len(up) == 3
            assert prim == up[0]
            assert len({o // 2 for o in up}) == 3

    def test_down_osd_filtered_replicated(self):
        osdmap = make_map()
        pg = PGid(1, 5)
        up_before, _, _, _ = osdmap.pg_to_up_acting_osds(pg)
        victim = up_before[0]
        inc = Incremental(2)
        inc.new_down.append(victim)
        osdmap.apply_incremental(inc)
        up_after, prim, _, _ = osdmap.pg_to_up_acting_osds(pg)
        assert victim not in up_after
        assert prim is not None

    def test_ec_holes_preserved(self):
        osdmap = make_map(ec=True)
        pg = PGid(1, 3)
        up_before, _, _, _ = osdmap.pg_to_up_acting_osds(pg)
        assert len(up_before) == 6
        victim = up_before[2]
        inc = Incremental(2)
        inc.new_down.append(victim)
        osdmap.apply_incremental(inc)
        up_after, _, _, _ = osdmap.pg_to_up_acting_osds(pg)
        assert len(up_after) == 6, "EC up set keeps positional holes"
        assert up_after[2] is None or up_after[2] != victim
        for i in (0, 1, 3, 4, 5):
            assert up_after[i] == up_before[i]

    def test_ec_out_remaps_position(self):
        osdmap = make_map(ec=True)
        pg = PGid(1, 3)
        up_before, _, _, _ = osdmap.pg_to_up_acting_osds(pg)
        victim = up_before[2]
        inc = Incremental(2)
        inc.new_down.append(victim)
        inc.new_weight[victim] = 0
        osdmap.apply_incremental(inc)
        up_after, _, _, _ = osdmap.pg_to_up_acting_osds(pg)
        assert up_after[2] != victim
        for i in (0, 1, 3, 4, 5):
            assert up_after[i] == up_before[i]


class TestIncremental:
    def test_epoch_ordering(self):
        osdmap = make_map()
        with pytest.raises(AssertionError):
            osdmap.apply_incremental(Incremental(5))

    def test_pool_lifecycle(self):
        osdmap = make_map()
        inc = Incremental(2)
        inc.new_pools[2] = PGPool(name="second", pool_id=2, pg_num=8)
        osdmap.apply_incremental(inc)
        assert osdmap.get_pool("second").pool_id == 2
        inc = Incremental(3)
        inc.old_pools.append(2)
        osdmap.apply_incremental(inc)
        assert osdmap.get_pool("second") is None

    def test_dump(self):
        osdmap = make_map()
        d = osdmap.dump()
        assert d["epoch"] == 1
        assert len(d["osds"]) == 6
        assert d["pools"][0]["name"] == "rbd"


# ------------------------------------ the same placements from both
N_OSDS = 13
PG_NUM = 256


def cluster_map(osdmap_mod, wrapper_mod):
    """The 13-OSD map of the k=8 m=4 cluster in either package: one
    host a OSD, an `indep` erasure rule with a host failure domain (as
    the monitor builds it) for pool 1, k=8 m=4 with a 4 KiB stripe
    unit, and a size-3 `firstn` replicated pool 2."""
    m = osdmap_mod.OSDMap()
    crush = wrapper_mod.build_flat_map(N_OSDS)
    inc = osdmap_mod.Incremental(1)
    inc.new_crush = crush
    inc.new_max_osd = N_OSDS
    for o in range(N_OSDS):
        inc.new_up[o] = ("127.0.0.1", 7000 + o)
    ec_rule = crush.add_simple_rule("ecrule_k8m4", "default", "host",
                                    mode="indep", pool_type="erasure")
    rep_rule = crush.add_simple_rule("replicated_rule", "default", "host",
                                     mode="firstn")
    inc.new_pools[1] = osdmap_mod.PGPool(
        name="ecpool", pool_id=1, type="erasure", size=12, min_size=9,
        pg_num=PG_NUM, crush_rule=ec_rule, erasure_code_profile="k8m4",
        stripe_width=8 * 4096)
    inc.new_pools[2] = osdmap_mod.PGPool(
        name="rbd", pool_id=2, size=3, min_size=2, pg_num=PG_NUM,
        crush_rule=rep_rule)
    inc.new_profiles["k8m4"] = {"plugin": "gpu", "k": "8", "m": "4",
                                "technique": "reed_sol_van"}
    m.apply_incremental(inc)
    return m


def mark_out(osdmap_mod, m, osd):
    inc = osdmap_mod.Incremental(m.epoch + 1)
    inc.new_down.append(osd)
    inc.new_weight[osd] = 0
    m.apply_incremental(inc)


def placements(osdmap_mod, m):
    return {(pool, seed): m.pg_to_up_acting_osds(osdmap_mod.PGid(pool,
                                                                  seed))
            for pool in (1, 2) for seed in range(PG_NUM)}


def test_hashes_equal_the_reference():
    rng = np.random.default_rng(7)
    xs = rng.integers(0, 1 << 32, size=(2000, 3), dtype=np.uint64)
    for a, b, c in xs.tolist():
        assert crush_hash32_2(a, b) == ref_mapper.crush_hash32_2(a, b)
        assert crush_hash32_3(a, b, c) == \
            ref_mapper.crush_hash32_3(a, b, c)
    for n in range(0, 40):
        name = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        assert ceph_str_hash_rjenkins(name) == \
            ref_osdmap.ceph_str_hash_rjenkins(name)


@pytest.fixture(scope="module")
def both_maps():
    """The cluster map in each package, and its placements before and
    after OSD 7 is marked out (computed once for the module)."""
    port = cluster_map(port_osdmap, port_wrapper)
    ref = cluster_map(ref_osdmap, ref_wrapper)
    out = {"port": port, "ref": ref,
           "before": (placements(port_osdmap, port),
                      placements(ref_osdmap, ref))}
    mark_out(port_osdmap, port, 7)
    mark_out(ref_osdmap, ref, 7)
    out["after"] = (placements(port_osdmap, port),
                    placements(ref_osdmap, ref))
    return out


@pytest.mark.parametrize("mode,size", [("indep", 12), ("firstn", 3)])
def test_do_rule_equals_the_reference(mode, size):
    maps = []
    for wrap in (ref_wrapper, port_wrapper):
        crush = wrap.build_flat_map(N_OSDS)
        kw = {"pool_type": "erasure"} if mode == "indep" else {}
        maps.append((crush, crush.add_simple_rule(
            "r", "default", "host", mode=mode, **kw)))
    w = weights(N_OSDS)
    for x in range(PG_NUM):
        ref, port = (c.do_rule(rid, x, size, w) for c, rid in maps)
        assert port == ref, x
        assert len(set(port)) == size      # distinct OSDs at every x


@pytest.mark.parametrize("state", ["before", "after"])
def test_pg_to_up_acting_equals_the_reference(both_maps, state):
    port, ref = both_maps[state]
    assert port == ref
    for seed in range(PG_NUM):
        up = port[(1, seed)][0]
        assert len(up) == 12
        if state == "before":
            assert len(set(up)) == 12
        else:
            assert 7 not in up


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_osdmap_wire_dict_loads_in_the_other_package(both_maps,
                                                     direction):
    port, ref = both_maps["port"], both_maps["ref"]
    assert port.to_wire_dict() == ref.to_wire_dict()
    if direction == "port_to_ref":
        src, src_mod, dst_mod = port, port_osdmap, ref_osdmap
    else:
        src, src_mod, dst_mod = ref, ref_osdmap, port_osdmap
    loaded = dst_mod.OSDMap.from_wire_dict(src.to_wire_dict())
    assert loaded.epoch == src.epoch
    assert loaded.erasure_code_profiles == src.erasure_code_profiles
    assert loaded.to_wire_dict() == src.to_wire_dict()
    for pool in (1, 2):
        for seed in range(0, PG_NUM, 8):
            assert loaded.pg_to_up_acting_osds(dst_mod.PGid(pool, seed)) \
                == src.pg_to_up_acting_osds(src_mod.PGid(pool, seed))
