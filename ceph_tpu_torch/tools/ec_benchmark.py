"""``ceph_erasure_code_benchmark`` — codec micro-benchmark.

Reference analog: ``src/test/erasure-code/ceph_erasure_code_benchmark.cc``
(:156-316).  Same CLI surface and the same two-column output
``<seconds>\t<KiB>`` so the reference's ``qa/workunits/erasure-code/
bench.sh`` GB/s arithmetic (``KiB / 2^20 / seconds``) works unchanged:

    -p/--plugin NAME        codec plugin (jerasure, isa, gpu, lrc, ...)
    -P/--parameter k=v      profile parameter, repeatable
    -S/--size BYTES         total bytes per iteration (default 1 MiB)
    -i/--iterations N       iterations (default 1)
    -w/--workload encode|decode
    -e/--erasures N         erasure count for decode (default 1)
    --erasures-generation random|exhaustive
    --erased i              explicit erased chunk, repeatable
    -v/--verbose

Workloads mirror the reference: ``encode`` times repeated
``encode(all, buffer)``; ``decode`` pre-encodes once, then times
``decode`` over chunk subsets with N chunks erased (random draws per
iteration, or every C(k+m, N) pattern when exhaustive).

The ``gpu`` plugin runs on CUDA unless a parameter says ``device=cpu``.
Its ``encode`` and ``decode`` return host bytes, so each timed call has
finished on the card when the clock stops.
"""
from __future__ import annotations

import argparse
import itertools
import random
import sys
import time
from typing import List

from .ec_tool import parse_profile
from ..ec import registry as ecreg


def make_codec(ns):
    """The codec of ``-p`` and every ``-P``; raises what the plugin's
    factory raises (``ErasureCodeValidationError`` for a refused
    profile)."""
    prof = {}
    for item in ns.parameter:
        prof.update(parse_profile(item))
    return ecreg.instance().factory(ns.plugin, prof)


def run(ns, ec) -> str:
    """One benchmark line for ``ns`` through the codec ``ec``."""
    k = ec.get_data_chunk_count()
    m = ec.get_coding_chunk_count()
    want = set(range(k + m))
    data = random.Random(42).randbytes(ns.size)

    if ns.workload == "encode":
        total_kib = 0
        t0 = time.perf_counter()
        for _ in range(ns.iterations):
            ec.encode(want, data)
            total_kib += len(data) // 1024
        dt = time.perf_counter() - t0
        return f"{dt:.6f}\t{total_kib}"

    # decode workload
    chunks = ec.encode(want, data)
    chunk_ids = sorted(chunks)
    if ns.erased:
        patterns = [tuple(ns.erased)]
    elif ns.erasures_generation == "exhaustive":
        patterns = list(itertools.combinations(chunk_ids, ns.erasures))
        if not patterns:
            raise SystemExit(f"--erasures {ns.erasures} exceeds "
                             f"chunk count {len(chunk_ids)}")
    else:
        rng = random.Random(7)
        patterns = [tuple(rng.sample(chunk_ids, ns.erasures))
                    for _ in range(ns.iterations)]
    want_read = set(range(k))
    total_kib = 0
    t0 = time.perf_counter()
    for it in range(ns.iterations):
        pattern = patterns[it % len(patterns)]
        avail = {i: c for i, c in chunks.items() if i not in pattern}
        need = ec.minimum_to_decode(want_read, set(avail))
        ec.decode(want_read, {i: avail[i] for i in need})
        total_kib += len(data) // 1024
    dt = time.perf_counter() - t0
    if ns.verbose:
        print(f"# patterns={len(patterns)} first={patterns[0]}",
              file=sys.stderr)
    return f"{dt:.6f}\t{total_kib}"


def main(argv: List[str] = None) -> int:
    p = argparse.ArgumentParser(prog="ceph_erasure_code_benchmark",
                                description=__doc__.splitlines()[0])
    p.add_argument("-p", "--plugin", default="jerasure")
    p.add_argument("-P", "--parameter", action="append", default=[])
    p.add_argument("-S", "--size", type=int, default=1 << 20)
    p.add_argument("-i", "--iterations", type=int, default=1)
    p.add_argument("-w", "--workload", choices=("encode", "decode"),
                   default="encode")
    p.add_argument("-e", "--erasures", type=int, default=1)
    p.add_argument("--erasures-generation", default="random",
                   choices=("random", "exhaustive"))
    p.add_argument("--erased", type=int, action="append", default=[])
    p.add_argument("-v", "--verbose", action="store_true")
    ns = p.parse_args(argv)
    print(run(ns, make_codec(ns)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
