"""``ceph-objectstore-tool`` — offline examination of an OSD data dir.

Reference analog: ``src/tools/ceph_objectstore_tool.cc``: mount a
stopped OSD's store and list/inspect/export/remove objects without the
daemon.  Works on the framework's FileStore directories (one per OSD
under the cluster ``data_dir``).

    ceph-objectstore-tool --data-path DIR --op list
    ceph-objectstore-tool --data-path DIR --op meta-list
    ceph-objectstore-tool --data-path DIR <coll> <obj> dump
    ceph-objectstore-tool --data-path DIR <coll> <obj> get-bytes out.bin
    ceph-objectstore-tool --data-path DIR <coll> <obj> remove
"""
from __future__ import annotations

import argparse
import base64
import json
import os
import re
import sys
from typing import List

from ..store.filestore import FileStore
from ..store.objectstore import GHObject, Transaction


def main(argv: List[str] = None) -> int:
    p = argparse.ArgumentParser(prog="ceph-objectstore-tool",
                                description=__doc__.splitlines()[0])
    p.add_argument("--data-path", required=True)
    p.add_argument("--type", choices=("auto", "file", "block"),
                   default="auto",
                   help="store backend (auto: detect block.dev)")
    p.add_argument("--op", choices=("list", "meta-list", "fsck"))
    p.add_argument("rest", nargs="*",
                   help="<coll> <obj> dump|get-bytes|set-bytes|remove|"
                   "list-attrs|get-attr|list-omap [args]")
    ns = p.parse_args(argv)

    kind = ns.type
    if kind == "auto":
        kind = "block" if os.path.exists(
            os.path.join(ns.data_path, "block.dev")) else "file"
    if kind == "block":
        from ..store.blockstore import BlockStore
        store = BlockStore(ns.data_path)
    else:
        store = FileStore(ns.data_path)
    store.mount()
    try:
        if ns.op == "list":
            for coll in store.list_collections():
                for obj in store.collection_list(coll):
                    print(json.dumps([coll, str(obj)]))
            return 0
        if ns.op == "meta-list":
            for coll in store.list_collections():
                print(coll)
            return 0
        if ns.op == "fsck":
            n = 0
            for coll in store.list_collections():
                for obj in store.collection_list(coll):
                    store.stat(coll, obj)
                    store.read(coll, obj)
                    store.getattrs(coll, obj)
                    n += 1
            print(f"fsck ok: {n} objects")
            return 0

        if len(ns.rest) < 3:
            p.error("need <coll> <obj> <command>")
        coll, objname, cmd, *args = ns.rest
        # accept the "(sN)" shard suffix that --op list prints for EC
        # shard objects (GHObject.__str__)
        m = re.fullmatch(r"(.*)\(s(\d+)\)", objname)
        obj = GHObject(m.group(1), int(m.group(2))) if m \
            else GHObject(objname)
        if cmd == "dump":
            st = store.stat(coll, obj)
            attrs = store.getattrs(coll, obj)
            omap = store.omap_get(coll, obj)
            json.dump({
                "object": objname, "collection": coll, "size": st.size,
                "attrs": {k: base64.b64encode(v).decode()
                          for k, v in attrs.items()},
                "omap": {k: base64.b64encode(v).decode()
                         for k, v in omap.items()},
            }, sys.stdout, indent=2, sort_keys=True)
            print()
        elif cmd == "get-bytes":
            data = store.read(coll, obj)
            if args:
                with open(args[0], "wb") as f:
                    f.write(data)
            else:
                sys.stdout.buffer.write(data)
        elif cmd == "set-bytes":
            with open(args[0], "rb") as f:
                data = f.read()
            t = Transaction()
            t.truncate(coll, obj, 0)
            t.write(coll, obj, 0, data)
            store.apply_transaction(t)
        elif cmd == "remove":
            t = Transaction()
            t.remove(coll, obj)
            store.apply_transaction(t)
            print(f"remove {coll}/{objname}")
        elif cmd == "list-attrs":
            for k in sorted(store.getattrs(coll, obj)):
                print(k)
        elif cmd == "get-attr":
            sys.stdout.buffer.write(store.getattr(coll, obj, args[0]))
        elif cmd == "list-omap":
            for k in store.omap_get_keys(coll, obj):
                print(k)
        else:
            p.error(f"unknown object command {cmd!r}")
        return 0
    finally:
        store.umount()


if __name__ == "__main__":
    sys.exit(main())
