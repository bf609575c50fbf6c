"""``rbd`` — block image CLI.

Reference analog: ``src/tools/rbd/`` (create/ls/info/rm/resize,
snap create/ls/rollback/rm, clone/flatten/children, import/export).

    rbd -m HOST:PORT -p pool create img1 --size 10M [--order 16]
    rbd -p pool ls
    rbd -p pool info img1
    rbd -p pool snap create img1@s1
    rbd -p pool clone img1@s1 img2
    rbd -p pool export img1 out.bin
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List

from .common import connect, print_out
from ..client.rados import RadosError
from ..rbd.image import RBD, Image


def parse_size(spec: str) -> int:
    mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}
    s = spec.strip().lower()
    if s and s[-1] in mult:
        return int(float(s[:-1]) * mult[s[-1]])
    return int(s)


def split_at_snap(spec: str):
    if "@" in spec:
        name, snap = spec.split("@", 1)
        return name, snap
    return spec, None


def main(argv: List[str] = None) -> int:
    p = argparse.ArgumentParser(prog="rbd",
                                description=__doc__.splitlines()[0])
    p.add_argument("-m", "--mon")
    p.add_argument("-p", "--pool", required=True)
    p.add_argument("--format", choices=("plain", "json"),
                   default="plain")
    sub = p.add_subparsers(dest="op", required=True)

    s = sub.add_parser("create"); s.add_argument("image")
    s.add_argument("--size", required=True)
    s.add_argument("--order", type=int, default=22)
    sub.add_parser("ls")
    s = sub.add_parser("info"); s.add_argument("image")
    s = sub.add_parser("rm"); s.add_argument("image")
    s = sub.add_parser("resize"); s.add_argument("image")
    s.add_argument("--size", required=True)
    s = sub.add_parser("snap")
    s.add_argument("verb", choices=("create", "ls", "rm", "rollback"))
    s.add_argument("spec", help="image[@snap]")
    s = sub.add_parser("clone")
    s.add_argument("parent_spec", help="image@snap")
    s.add_argument("child")
    s = sub.add_parser("flatten"); s.add_argument("image")
    s = sub.add_parser("children"); s.add_argument("spec",
                                                  help="image@snap")
    s = sub.add_parser("export"); s.add_argument("spec",
                                                 help="image[@snap]")
    s.add_argument("outfile")
    s = sub.add_parser("import"); s.add_argument("infile")
    s.add_argument("image")
    s.add_argument("--order", type=int, default=22)

    ns = p.parse_args(argv)
    as_json = ns.format == "json"
    with connect(ns.mon) as cluster:
        io = cluster.open_ioctx(ns.pool)
        rbd = RBD(io)
        try:
            if ns.op == "create":
                rbd.create(ns.image, parse_size(ns.size),
                           order=ns.order)
            elif ns.op == "ls":
                for name in rbd.list():
                    print(name)
            elif ns.op == "info":
                img = Image(io, ns.image)
                print_out("", img.stat(), True)
            elif ns.op == "rm":
                rbd.remove(ns.image)
            elif ns.op == "resize":
                Image(io, ns.image).resize(parse_size(ns.size))
            elif ns.op == "snap":
                name, snap = split_at_snap(ns.spec)
                img = Image(io, name)
                if ns.verb == "ls":
                    print_out("", {"snaps": img.snap_list()}, True)
                elif snap is None:
                    raise SystemExit("need image@snap")
                elif ns.verb == "create":
                    img.snap_create(snap)
                elif ns.verb == "rm":
                    img.snap_rm(snap)
                else:
                    img.snap_rollback(snap)
            elif ns.op == "clone":
                pname, psnap = split_at_snap(ns.parent_spec)
                if psnap is None:
                    raise SystemExit("clone needs parent image@snap")
                rbd.clone(pname, psnap, ns.child)
            elif ns.op == "flatten":
                Image(io, ns.image).flatten()
            elif ns.op == "children":
                pname, psnap = split_at_snap(ns.spec)
                for c in rbd.children(pname, psnap):
                    print(c)
            elif ns.op == "export":
                name, snap = split_at_snap(ns.spec)
                img = Image(io, name, snap_name=snap)
                with open(ns.outfile, "wb") as f:
                    step = 4 << 20
                    for off in range(0, img.size(), step):
                        f.write(img.read(off, min(step,
                                                  img.size() - off)))
            elif ns.op == "import":
                with open(ns.infile, "rb") as f:
                    data = f.read()
                rbd.create(ns.image, len(data), order=ns.order)
                img = Image(io, ns.image)
                step = 4 << 20
                for off in range(0, len(data), step):
                    img.write(off, data[off:off + step])
        except RadosError as e:
            print(f"rbd: {e}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
