"""``osdmaptool`` — offline OSDMap inspection and placement testing.

Reference analog: ``src/tools/osdmaptool.cc``: ``--print`` dumps a map,
``--createsimple N`` synthesises a map with N OSDs, ``--test-map-pgs``
maps every PG of a pool and reports the distribution,
``--test-map-object`` maps one object name.  Maps are stored as the
framework's JSON wire dict (``osd/osdmap.py to_wire_dict``).

    osdmaptool --createsimple 8 -o map.json --with-default-pool
    osdmaptool --print map.json
    osdmaptool --test-map-pgs --pool 1 map.json
    osdmaptool --test-map-object foo --pool 1 map.json
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from typing import List

from ..crush.wrapper import build_flat_map
from ..osd.osdmap import OSDMap, Incremental, PGPool


def createsimple(n: int, with_pool: bool) -> OSDMap:
    m = OSDMap()
    inc = Incremental(1)
    inc.new_crush = build_flat_map(n, osds_per_host=1)
    rule = inc.new_crush.add_simple_rule("replicated_rule", "default",
                                         "host", mode="firstn")
    for osd in range(n):
        inc.new_up[osd] = ("127.0.0.1", 0)
        inc.new_weight[osd] = 0x10000
    m.apply_incremental(inc)
    if with_pool:
        inc2 = Incremental(2)
        pool = PGPool(name="rbd", pool_id=1,
                      size=min(3, n), min_size=max(1, min(2, n - 1)),
                      pg_num=64, crush_rule=rule)
        inc2.new_pools[1] = pool
        m.apply_incremental(inc2)
    return m


def main(argv: List[str] = None) -> int:
    p = argparse.ArgumentParser(prog="osdmaptool",
                                description=__doc__.splitlines()[0])
    p.add_argument("mapfn", nargs="?")
    p.add_argument("--print", dest="print_", action="store_true")
    p.add_argument("--createsimple", type=int)
    p.add_argument("--with-default-pool", action="store_true")
    p.add_argument("-o", "--outfn")
    p.add_argument("--pool", type=int)
    p.add_argument("--test-map-pgs", action="store_true")
    p.add_argument("--test-map-object")
    ns = p.parse_args(argv)

    if ns.createsimple:
        m = createsimple(ns.createsimple, ns.with_default_pool)
        out = json.dumps(m.to_wire_dict(), indent=2, sort_keys=True,
                         default=str)
        if ns.outfn:
            with open(ns.outfn, "w") as f:
                f.write(out + "\n")
            print(f"osdmaptool: writing epoch {m.epoch} to {ns.outfn}")
        else:
            print(out)
        return 0

    if not ns.mapfn:
        p.error("no map file")
    with open(ns.mapfn) as f:
        m = OSDMap.from_wire_dict(json.load(f))

    if ns.print_:
        json.dump(m.dump(), sys.stdout, indent=2, sort_keys=True,
                  default=str)
        print()
        return 0

    pools = ([m.pools[ns.pool]] if ns.pool is not None
             else list(m.pools.values()))
    if ns.test_map_pgs:
        per_osd = Counter()
        total_pgs = 0
        for pool in pools:
            for pgid in m.pgs_for_pool(pool.pool_id):
                up, _primary, _acting, _ap = m.pg_to_up_acting_osds(pgid)
                total_pgs += 1
                per_osd.update(o for o in up if o is not None)
        print(f"pool {[p0.pool_id for p0 in pools]} pg_num "
              f"{[p0.pg_num for p0 in pools]}")
        counts = [per_osd.get(i, 0) for i in sorted(m.osds)]
        if counts:
            avg = sum(counts) / len(counts)
            print(f"#osd\tcount\n" + "\n".join(
                f"osd.{i}\t{per_osd.get(i, 0)}" for i in sorted(m.osds)))
            print(f"avg {avg:.2f} min {min(counts)} max {max(counts)} "
                  f"total pgs {total_pgs}")
        return 0

    if ns.test_map_object is not None:
        for pool in pools:
            pgid = m.object_locator_to_pg(ns.test_map_object, pool.pool_id)
            up, primary, _acting, _ap = m.pg_to_up_acting_osds(pgid)
            print(f" object '{ns.test_map_object}' -> {pgid} -> up {up} "
                  f"primary {primary}")
        return 0

    p.error("nothing to do")


if __name__ == "__main__":
    sys.exit(main())
