"""``cephfs`` — file-layer CLI (mount-less).

Reference analog: ``cephfs-shell`` (``src/tools/cephfs/``) — drive
the file hierarchy without a kernel mount:

    cephfs -m HOST:PORT --meta-pool fsmeta [--data-pool fsdata] ls /
    cephfs ... mkdir /a/b
    cephfs ... put local.bin /a/b/file.bin
    cephfs ... get /a/b/file.bin out.bin
    cephfs ... mv /a/b/file.bin /a/renamed.bin
    cephfs ... rm /a/renamed.bin ; cephfs ... rmdir /a/b
    cephfs ... stat /a ; cephfs ... tree /
"""
from __future__ import annotations

import argparse
import sys
from typing import List

from .common import connect
from ..fs import FileSystem, FSError


def main(argv: List[str] = None) -> int:
    p = argparse.ArgumentParser(prog="cephfs",
                                description=__doc__.splitlines()[0])
    p.add_argument("-m", "--mon")
    p.add_argument("--meta-pool", required=True)
    p.add_argument("--data-pool", help="defaults to the meta pool")
    sub = p.add_subparsers(dest="op", required=True)
    s = sub.add_parser("ls"); s.add_argument("path", nargs="?",
                                             default="/")
    s = sub.add_parser("mkdir"); s.add_argument("path")
    s = sub.add_parser("put"); s.add_argument("infile")
    s.add_argument("path")
    s = sub.add_parser("get"); s.add_argument("path")
    s.add_argument("outfile")
    s = sub.add_parser("rm"); s.add_argument("path")
    s = sub.add_parser("rmdir"); s.add_argument("path")
    s = sub.add_parser("mv"); s.add_argument("old")
    s.add_argument("new")
    s = sub.add_parser("stat"); s.add_argument("path")
    s = sub.add_parser("tree"); s.add_argument("path", nargs="?",
                                               default="/")
    ns = p.parse_args(argv)

    with connect(ns.mon) as cluster:
        meta = cluster.open_ioctx(ns.meta_pool)
        data = cluster.open_ioctx(ns.data_pool) if ns.data_pool \
            else None
        fs = FileSystem(meta, data)
        try:
            if ns.op == "ls":
                for e in fs.listdir(ns.path):
                    kind = "d" if e["type"] == "dir" else "-"
                    print(f"{kind} {e['name']}")
            elif ns.op == "mkdir":
                fs.mkdir(ns.path)
            elif ns.op == "put":
                with open(ns.infile, "rb") as f:
                    data = f.read()
                fs.write_file(ns.path, data)
                # put is whole-file replacement; write_file alone is
                # pwrite (a smaller upload would keep the old tail)
                fs.truncate(ns.path, len(data))
            elif ns.op == "get":
                with open(ns.outfile, "wb") as f:
                    f.write(fs.read_file(ns.path))
            elif ns.op == "rm":
                fs.unlink(ns.path)
            elif ns.op == "rmdir":
                fs.rmdir(ns.path)
            elif ns.op == "mv":
                fs.rename(ns.old, ns.new)
            elif ns.op == "stat":
                st = fs.stat(ns.path)
                print(f"{ns.path}: {st['type']} ino={st['ino']} "
                      f"size={st['size']} mode={oct(st['st_mode'])}")
            elif ns.op == "tree":
                for path, dirs, files in fs.walk(ns.path):
                    print(path)
                    for d in sorted(dirs):
                        print(f"  {d}/")
                    for f0 in sorted(files):
                        print(f"  {f0}")
        except FSError as e:
            print(f"cephfs: {e}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
