"""``crushtool`` — build, inspect and test CRUSH maps offline.

Reference analog: ``src/tools/crushtool.cc``: ``--build`` synthesises a
hierarchy, ``-d`` decompiles a map, ``-c`` compiles one, ``--test``
runs ``crush_do_rule`` over a range of inputs and reports mappings /
utilization.  Maps are stored as the framework's JSON wire dict
(``crush/wrapper.py to_wire_dict``) instead of the reference's binary
encoding.

    crushtool --build --num-osds 12 -o map.json \
        node straw2 4 rack straw2 0
    crushtool -d map.json
    crushtool --test -i map.json --rule 0 --num-rep 3 \
        --min-x 0 --max-x 1023 --show-mappings
    crushtool --test -i map.json --rule 0 --num-rep 3 --show-utilization
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from typing import List

from ..crush.wrapper import CrushWrapper


def build_hierarchy(num_osds: int, layers: List[List[str]]) -> CrushWrapper:
    """--build: bottom-up layers of (type_name, algorithm, fan_out);
    fan_out 0 = one bucket holding everything (reference
    crushtool.cc --build / CrushCompiler)."""
    crush = CrushWrapper()

    def ensure_type(tname: str) -> None:
        if tname not in crush.types.values():
            crush.types[max(crush.types) + 1] = tname

    items = [(i, f"osd.{i}") for i in range(num_osds)]
    level_items = items
    for depth, (tname, alg, size) in enumerate(layers):
        ensure_type(tname)
        size = int(size)
        buckets = []
        if size <= 0:
            groups = [level_items]
        else:
            groups = [level_items[i:i + size]
                      for i in range(0, len(level_items), size)]
        for bi, group in enumerate(groups):
            bname = f"{tname}{bi}" if size > 0 else tname
            crush.add_bucket(bname, tname, alg=alg)
            for iid, iname in group:
                if depth == 0:
                    crush.insert_item(iid, 1.0, iname, bname)
                else:
                    crush.move_bucket(iname, bname)
            buckets.append((crush.get_bucket(bname).id, bname))
        level_items = buckets
    root_name = level_items[0][1] if len(level_items) == 1 else "root"
    if len(level_items) > 1:
        crush.add_bucket("root", "root")
        for _, bname in level_items:
            crush.move_bucket(bname, "root")
    crush.add_simple_rule("replicated_rule", root_name, "osd",
                          mode="firstn")
    return crush


def cmd_test(crush: CrushWrapper, ns) -> int:
    rule = ns.rule
    reps = ns.num_rep
    n_dev = max((i for i in crush.name_ids.values() if i >= 0),
                default=-1) + 1
    weights = [0x10000] * n_dev
    total = Counter()
    bad = 0
    for x in range(ns.min_x, ns.max_x + 1):
        out = crush.do_rule(rule, x, reps, weights)
        if ns.show_mappings:
            print(f"CRUSH rule {rule} x {x} {out}")
        if len([o for o in out if o is not None]) < reps:
            bad += 1
        total.update(o for o in out if o is not None)
    n_inputs = ns.max_x - ns.min_x + 1
    if ns.show_utilization:
        expect = n_inputs * reps / max(1, len(total))
        for dev in sorted(total):
            print(f"  device {dev}:\tstored : {total[dev]}\t"
                  f"expected : {expect:.2f}")
    if ns.show_bad_mappings or bad:
        print(f"bad mappings: {bad}/{n_inputs}")
    return 0 if bad == 0 else 1


def main(argv: List[str] = None) -> int:
    p = argparse.ArgumentParser(prog="crushtool",
                                description=__doc__.splitlines()[0])
    p.add_argument("--build", action="store_true")
    p.add_argument("--num-osds", type=int, default=0)
    p.add_argument("-o", "--outfn")
    p.add_argument("-i", "--infn")
    p.add_argument("-d", "--decompile")
    p.add_argument("-c", "--compile", dest="compilefn")
    p.add_argument("--test", action="store_true")
    p.add_argument("--rule", type=int, default=0)
    p.add_argument("--num-rep", type=int, default=3)
    p.add_argument("--min-x", type=int, default=0)
    p.add_argument("--max-x", type=int, default=1023)
    p.add_argument("--show-mappings", action="store_true")
    p.add_argument("--show-utilization", action="store_true")
    p.add_argument("--show-bad-mappings", action="store_true")
    p.add_argument("layers", nargs="*",
                   help="--build: repeated <type> <algorithm> <size>")
    ns = p.parse_args(argv)

    if ns.build:
        if ns.num_osds <= 0 or len(ns.layers) % 3:
            raise SystemExit("--build needs --num-osds and "
                             "<type> <alg> <size> triples")
        layers = [ns.layers[i:i + 3] for i in range(0, len(ns.layers), 3)]
        crush = build_hierarchy(ns.num_osds, layers)
        out = json.dumps(crush.to_wire_dict(), indent=2, sort_keys=True)
        if ns.outfn:
            with open(ns.outfn, "w") as f:
                f.write(out + "\n")
        else:
            print(out)
        return 0

    if ns.decompile:
        with open(ns.decompile) as f:
            crush = CrushWrapper.from_wire_dict(json.load(f))
        json.dump(crush.dump(), sys.stdout, indent=2, sort_keys=True)
        print()
        return 0

    if ns.compilefn:
        with open(ns.compilefn) as f:
            crush = CrushWrapper.from_wire_dict(json.load(f))
        out = json.dumps(crush.to_wire_dict(), sort_keys=True)
        if ns.outfn:
            with open(ns.outfn, "w") as f:
                f.write(out + "\n")
        print(f"compiled ok: {len(crush.bucket_names)} buckets, "
              f"{len(crush.map.rules)} rules")
        return 0

    if ns.test:
        if not ns.infn:
            raise SystemExit("--test needs -i <map.json>")
        with open(ns.infn) as f:
            crush = CrushWrapper.from_wire_dict(json.load(f))
        return cmd_test(crush, ns)

    p.error("one of --build/-d/-c/--test required")


if __name__ == "__main__":
    sys.exit(main())
