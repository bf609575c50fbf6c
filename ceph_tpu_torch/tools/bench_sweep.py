"""EC benchmark sweep across plugins / k/m pairs / techniques.

Reference analog: ``qa/workunits/erasure-code/bench.sh`` (:53-59,
148-170) — loops ``ceph_erasure_code_benchmark`` over isa+jerasure ×
vandermonde+cauchy × a k/m grid and emits data the ``bench.html``
flot viewer plots.  This emits one JSON row per combination (GB/s
derived exactly as bench.sh does: KiB / 2^20 / seconds) and an
optional self-contained HTML bar chart.

    python -m ceph_tpu_torch.tools.bench_sweep --size 1048576 -i 3
    python -m ceph_tpu_torch.tools.bench_sweep --plugins gpu,jerasure \\
        --html sweep.html

``--device`` (default ``cuda``) goes into the profiles of the ``gpu``
plugin alone, and only when it is not ``cuda``: ``--device cpu`` runs
them on the CPU.  A profile that the plugin's factory refuses is
skipped with a ``# skip`` line; any other error propagates and the
sweep exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import sys
from html import escape
from typing import List

from . import ec_benchmark
from ..ec.interface import ErasureCodeValidationError

DEFAULT_KM = ["2/1", "3/2", "4/2", "6/3", "8/4", "10/4"]


def run_one(plugin: str, k: int, m: int, technique: str, size: int,
            iters: int, workload: str, device: str = "cuda") -> dict:
    """One row, or None (with a ``# skip`` line) when the plugin's
    factory refuses the profile; whatever else raises propagates."""
    params = [f"k={k}", f"m={m}"]
    if technique and plugin == "jerasure":
        params.append(f"technique={technique}")
    if plugin == "gpu" and device != "cuda":
        params.append(f"device={device}")
    ns = argparse.Namespace(
        plugin=plugin, parameter=[",".join(params)], size=size,
        iterations=iters, workload=workload, erasures=1,
        erasures_generation="random", erased=[], verbose=False)
    try:
        ec = ec_benchmark.make_codec(ns)
    except ErasureCodeValidationError as e:
        print(f"# skip {plugin} {technique} {k}/{m} {workload}: {e}",
              file=sys.stderr)
        return None
    line = ec_benchmark.run(ns, ec)
    secs, kib = line.split("\t")
    gbps = (int(kib) / (1 << 20)) / float(secs) if float(secs) else 0.0
    return {"plugin": plugin, "k": k, "m": m,
            "technique": technique or "default",
            "workload": workload, "seconds": round(float(secs), 6),
            "kib": int(kib), "gbps": round(gbps, 4)}


def render_html(rows: List[dict]) -> str:
    """Self-contained bar chart (stand-in for the reference's flot
    bench.html viewer)."""
    peak = max((r["gbps"] for r in rows), default=1.0) or 1.0
    bars = []
    for r in rows:
        label = (f"{r['plugin']}/{r['technique']} k={r['k']} "
                 f"m={r['m']} {r['workload']}")
        width = max(1, int(520 * r["gbps"] / peak))
        bars.append(
            f"<div class='row'><span class='lbl'>{escape(label)}"
            f"</span><span class='bar' style='width:{width}px'>"
            f"</span><span class='val'>{r['gbps']:.3f} GB/s"
            f"</span></div>")
    return ("<!doctype html><meta charset='utf-8'>"
            "<title>EC bench sweep</title><style>"
            "body{font:13px monospace;margin:2em}"
            ".row{display:flex;align-items:center;margin:2px 0}"
            ".lbl{width:340px}.bar{background:#4a7;height:12px;"
            "display:inline-block;margin-right:6px}</style>"
            "<h2>Erasure-code encode/decode sweep</h2>"
            + "".join(bars))


def main(argv: List[str] = None) -> int:
    p = argparse.ArgumentParser(prog="bench-sweep",
                                description=__doc__.splitlines()[0])
    p.add_argument("--plugins", default="jerasure,isa,gpu")
    p.add_argument("--km", default=",".join(DEFAULT_KM),
                   help="comma list of k/m pairs")
    p.add_argument("--techniques", default="reed_sol_van,cauchy_good",
                   help="jerasure techniques to sweep")
    p.add_argument("--size", type=int, default=1 << 20)
    p.add_argument("-i", "--iterations", type=int, default=3)
    p.add_argument("--workloads", default="encode,decode")
    p.add_argument("--device", default="cuda",
                   help="device of the gpu plugin's profiles (cpu: "
                        "run them on the CPU)")
    p.add_argument("--html", help="also write a bar-chart viewer here")
    ns = p.parse_args(argv)

    rows: List[dict] = []
    for plugin in ns.plugins.split(","):
        techniques = ns.techniques.split(",") if plugin == "jerasure" \
            else [""]
        for tech in techniques:
            for km in ns.km.split(","):
                k, m = (int(x) for x in km.split("/"))
                for workload in ns.workloads.split(","):
                    row = run_one(plugin, k, m, tech, ns.size,
                                  ns.iterations, workload, ns.device)
                    if row is None:
                        continue
                    rows.append(row)
                    print(json.dumps(row))
    if ns.html:
        with open(ns.html, "w") as f:
            f.write(render_html(rows))
        print(f"# wrote {ns.html}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
