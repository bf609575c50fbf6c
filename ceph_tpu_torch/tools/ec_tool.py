"""``ceph-erasure-code-tool`` — offline encode/decode of files.

Reference analog: ``src/tools/erasure-code/ceph-erasure-code-tool.cc``
(:30-50): subcommands ``test-plugin-exists <plugin>``,
``calc-chunk-size <profile> <object_size>``,
``encode <profile> <stripe_unit> <chunks(csv)> <file>`` (writes
``<file>.<chunk>`` pieces), and
``decode <profile> <stripe_unit> <chunks(csv)> <file>`` (reads the
pieces back, reconstructs, writes ``<file>.decoded``).

Profiles are comma-separated ``k=v`` lists, e.g.
``plugin=gpu,k=8,m=4,technique=reed_sol_van`` (add
``device=cpu`` to run the ``gpu`` plugin on the CPU).
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List

from ..ec import registry as ecreg


def parse_profile(spec: str) -> Dict[str, str]:
    prof: Dict[str, str] = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise SystemExit(f"profile entry {item!r} is not k=v")
        key, val = item.split("=", 1)
        prof[key] = val
    return prof


def make_codec(spec: str):
    prof = parse_profile(spec)
    plugin = prof.pop("plugin", "jerasure")
    return ecreg.instance().factory(plugin, prof)


def _parse_chunks(spec: str) -> List[int]:
    return [int(x) for x in spec.split(",") if x != ""]


def main(argv: List[str] = None) -> int:
    p = argparse.ArgumentParser(prog="ceph-erasure-code-tool",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="op", required=True)
    s = sub.add_parser("test-plugin-exists"); s.add_argument("plugin")
    s = sub.add_parser("calc-chunk-size")
    s.add_argument("profile"); s.add_argument("object_size", type=int)
    for name in ("encode", "decode"):
        s = sub.add_parser(name)
        s.add_argument("profile")
        s.add_argument("stripe_unit", type=int,
                       help="accepted for CLI parity; chunk size is "
                       "derived from the object size")
        s.add_argument("chunks", help="csv chunk ids (encode: which to "
                       "write; decode: which are available)")
        s.add_argument("file")
    ns = p.parse_args(argv)

    if ns.op == "test-plugin-exists":
        try:
            ecreg.instance().load(ns.plugin)
        except Exception as e:
            print(f"plugin {ns.plugin} not found: {e}", file=sys.stderr)
            return 1
        print(f"plugin {ns.plugin} found")
        return 0

    if ns.op == "calc-chunk-size":
        ec = make_codec(ns.profile)
        print(ec.get_chunk_size(ns.object_size))
        return 0

    ec = make_codec(ns.profile)
    k = ec.get_data_chunk_count()
    m = ec.get_coding_chunk_count()
    want = set(_parse_chunks(ns.chunks)) if ns.chunks != "all" else \
        set(range(k + m))

    if ns.op == "encode":
        with open(ns.file, "rb") as f:
            data = f.read()
        chunks = ec.encode(want, data)
        for i, buf in sorted(chunks.items()):
            with open(f"{ns.file}.{i}", "wb") as f:
                f.write(buf)
        print(f"wrote {len(chunks)} chunks of "
              f"{ec.get_chunk_size(len(data))} bytes")
        return 0

    # decode: read available pieces, reconstruct the data chunks, concat
    avail: Dict[int, bytes] = {}
    for i in sorted(want):
        try:
            with open(f"{ns.file}.{i}", "rb") as f:
                avail[i] = f.read()
        except FileNotFoundError:
            pass
    if not avail:
        print(f"no {ns.file}.<chunk> pieces found", file=sys.stderr)
        return 1
    out = ec.decode_concat(avail)
    with open(f"{ns.file}.decoded", "wb") as f:
        f.write(out)
    print(f"decoded {len(out)} bytes from chunks {sorted(avail)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
