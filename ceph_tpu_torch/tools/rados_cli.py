"""``rados`` — object-level CLI + ``bench``.

Reference analog: ``src/tools/rados/rados.cc`` (put/get/ls/rm/stat/
xattr/append/truncate subcommands, plus ``bench`` at ``:3161`` driven by
``ObjBencher``, ``src/common/obj_bencher.h:64``).  Bench semantics match
the reference: objects named ``benchmark_data_<id>_object<N>``, a fixed
window of in-flight aio ops (``-t``), per-second progress lines, and a
summary with bandwidth / IOPS / latency; ``write --no-cleanup`` leaves
data + a metadata object behind for later ``seq``/``rand`` read passes.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import List, Optional

from .common import connect, parse_mon_addr  # noqa: F401 (re-export)

BENCH_META = "benchmark_last_metadata"


def _bench_prefix(run_name: Optional[str]) -> str:
    return run_name or f"benchmark_data_{os.getpid()}"


def bench(ioctx, seconds: int, mode: str, block_size: int = 4 << 20,
          concurrent: int = 16, run_name: Optional[str] = None,
          no_cleanup: bool = False, quiet: bool = False,
          out=None) -> dict:
    """ObjBencher loop (reference obj_bencher.cc write_bench/seq_read_bench):
    keep ``concurrent`` aio ops in flight, one object per op."""
    out = out or sys.stdout
    prefix = _bench_prefix(run_name)
    payload = os.urandom(block_size) if mode == "write" else b""
    if mode in ("seq", "rand"):
        try:
            meta = json.loads(ioctx.read(BENCH_META).decode())
        except Exception:
            raise SystemExit(
                "no benchmark metadata object: run "
                "'rados bench <sec> write --no-cleanup' first")
        prefix = meta["prefix"]
        block_size = meta["block_size"]
        max_obj = meta["objects"]
        if max_obj == 0:
            raise SystemExit("previous write pass produced no objects")

    inflight = {}          # completion -> (index, start_time)
    lats: List[float] = []
    done = 0
    issued = 0
    errors = 0
    t0 = time.monotonic()
    deadline = t0 + seconds
    last_report = t0
    done_at_report = 0
    rng = None
    if mode == "rand":
        import random
        rng = random.Random(12345)

    def issue():
        nonlocal issued
        if mode == "write":
            idx = issued
            c = ioctx.aio_write_full(f"{prefix}_object{idx}", payload)
        elif mode == "seq":
            idx = issued % max_obj
            c = ioctx.aio_read(f"{prefix}_object{idx}", block_size)
        else:
            idx = rng.randrange(max_obj)
            c = ioctx.aio_read(f"{prefix}_object{idx}", block_size)
        inflight[c] = (idx, time.monotonic())
        issued += 1

    def reap(block: bool) -> None:
        nonlocal done, errors
        while inflight:
            ready = [c for c in inflight if c.is_complete()]
            if not ready and not block:
                return
            if not ready:
                time.sleep(0.001)
                continue
            for c in ready:
                _, t_start = inflight.pop(c)
                lats.append(time.monotonic() - t_start)
                if c.wait(0) < 0:
                    errors += 1
                else:
                    done += 1
            if not block:
                return

    # seq mode stops after one full pass over the dataset
    def more_to_issue() -> bool:
        if time.monotonic() >= deadline:
            return False
        if mode == "seq" and issued >= max_obj:
            return False
        return True

    while more_to_issue() or inflight:
        while len(inflight) < concurrent and more_to_issue():
            issue()
        reap(block=False)
        now = time.monotonic()
        if not quiet and now - last_report >= 1.0:
            cur_bw = ((done - done_at_report) * block_size /
                      (now - last_report)) / (1 << 20)
            print(f"  sec {int(now - t0):3d}: {done} ops done, "
                  f"{len(inflight)} in flight, cur MB/s {cur_bw:.1f}",
                  file=out)
            last_report, done_at_report = now, done
        if not inflight and not more_to_issue():
            break
        time.sleep(0.0005)
    reap(block=True)
    elapsed = time.monotonic() - t0

    if mode == "write" and no_cleanup:
        ioctx.write_full(BENCH_META, json.dumps(
            {"prefix": prefix, "block_size": block_size,
             "objects": done}).encode())
    elif mode == "write":
        for i in range(issued):
            try:
                ioctx.remove(f"{prefix}_object{i}")
            except Exception:
                pass

    summary = {
        "mode": mode,
        "total_time_run": round(elapsed, 3),
        "total_ops": done,
        "errors": errors,
        "op_size": block_size,
        "bandwidth_mb_sec": round(done * block_size / elapsed / (1 << 20), 3)
        if elapsed else 0.0,
        "average_iops": round(done / elapsed, 2) if elapsed else 0.0,
        "average_latency_s": round(statistics.fmean(lats), 6) if lats else 0,
        "max_latency_s": round(max(lats), 6) if lats else 0,
        "min_latency_s": round(min(lats), 6) if lats else 0,
        "stddev_latency_s": round(statistics.pstdev(lats), 6)
        if len(lats) > 1 else 0.0,
    }
    if not quiet:
        label = {"write": "Write", "seq": "Sequential read",
                 "rand": "Random read"}[mode]
        print(f"Total time run:       {summary['total_time_run']}\n"
              f"Total {label.lower()} ops: {done}\n"
              f"{label} size:         {block_size}\n"
              f"Bandwidth (MB/sec):   {summary['bandwidth_mb_sec']}\n"
              f"Average IOPS:         {summary['average_iops']}\n"
              f"Average Latency(s):   {summary['average_latency_s']}\n"
              f"Max latency(s):       {summary['max_latency_s']}\n"
              f"Min latency(s):       {summary['min_latency_s']}", file=out)
    return summary


def main(argv: List[str] = None) -> int:
    p = argparse.ArgumentParser(prog="rados",
                                description=__doc__.splitlines()[0])
    p.add_argument("-m", "--mon")
    p.add_argument("-p", "--pool", required=True)
    p.add_argument("--timeout", type=float, default=30.0)
    sub = p.add_subparsers(dest="op", required=True)

    s = sub.add_parser("put"); s.add_argument("obj"); s.add_argument("infile")
    s = sub.add_parser("get"); s.add_argument("obj"); s.add_argument("outfile")
    s = sub.add_parser("rm"); s.add_argument("obj")
    sub.add_parser("ls")
    s = sub.add_parser("stat"); s.add_argument("obj")
    s = sub.add_parser("truncate"); s.add_argument("obj")
    s.add_argument("size", type=int)
    s = sub.add_parser("append"); s.add_argument("obj")
    s.add_argument("infile")
    s = sub.add_parser("setxattr"); s.add_argument("obj")
    s.add_argument("name"); s.add_argument("value")
    s = sub.add_parser("getxattr"); s.add_argument("obj")
    s.add_argument("name")
    s = sub.add_parser("listxattr"); s.add_argument("obj")
    sub.add_parser("cache-flush-evict-all")
    s = sub.add_parser("bench")
    s.add_argument("seconds", type=int)
    s.add_argument("mode", choices=("write", "seq", "rand"))
    s.add_argument("-b", "--block-size", type=int, default=4 << 20)
    s.add_argument("-t", "--concurrent-ios", type=int, default=16)
    s.add_argument("--run-name")
    s.add_argument("--no-cleanup", action="store_true")
    s.add_argument("--format", choices=("plain", "json"), default="plain")

    ns = p.parse_args(argv)
    with connect(ns.mon) as cluster:
        ioctx = cluster.open_ioctx(ns.pool)
        if ns.op == "put":
            with open(ns.infile, "rb") as f:
                ioctx.write_full(ns.obj, f.read())
        elif ns.op == "get":
            data = ioctx.read(ns.obj)
            with open(ns.outfile, "wb") as f:
                f.write(data)
        elif ns.op == "rm":
            ioctx.remove(ns.obj)
        elif ns.op == "ls":
            for name in ioctx.list_objects():
                print(name)
        elif ns.op == "stat":
            size, version = ioctx.stat(ns.obj)
            print(f"{ns.pool}/{ns.obj} size {size} version {version}")
        elif ns.op == "truncate":
            ioctx.truncate(ns.obj, ns.size)
        elif ns.op == "append":
            with open(ns.infile, "rb") as f:
                ioctx.append(ns.obj, f.read())
        elif ns.op == "setxattr":
            ioctx.setxattr(ns.obj, ns.name, ns.value.encode())
        elif ns.op == "getxattr":
            sys.stdout.write(ioctx.getxattr(ns.obj, ns.name).decode())
            print()
        elif ns.op == "listxattr":
            for k in sorted(ioctx.getxattrs(ns.obj)):
                print(k)
        elif ns.op == "cache-flush-evict-all":
            # reference `rados -p <cachepool> cache-flush-evict-all`:
            # drain the tier — flush every dirty object, then evict
            from ..client.rados import RadosError
            for name in ioctx.list_objects():
                try:
                    ioctx.cache_flush(name)
                except RadosError:
                    pass
                try:
                    ioctx.cache_evict(name)
                except RadosError:
                    pass
        elif ns.op == "bench":
            summary = bench(ioctx, ns.seconds, ns.mode,
                            block_size=ns.block_size,
                            concurrent=ns.concurrent_ios,
                            run_name=ns.run_name,
                            no_cleanup=ns.no_cleanup,
                            quiet=ns.format == "json")
            if ns.format == "json":
                json.dump(summary, sys.stdout)
                print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
