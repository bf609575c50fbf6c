"""Erasure-code bit-exactness corpus: create + verify.

Reference analog: the ``ceph-erasure-code-corpus`` submodule +
``qa/workunits/erasure-code/encode-decode-non-regression.sh`` (:19-40)
and ``src/test/erasure-code/ceph_erasure_code_non_regression.cc``:
chunks encoded by released versions are stored; every build re-encodes
the same payload and compares byte-for-byte, then decodes every 1- and
2-erasure pattern and compares the recovered chunks — codec output may
never silently change across versions, or mixed-version clusters would
corrupt each other's objects.

    python -m ceph_tpu_torch.tools.ec_non_regression --base corpus --create
    python -m ceph_tpu_torch.tools.ec_non_regression --base corpus --check

The ``gpu`` entry computes the reed_sol_van code of the JAX package's
``tpu`` plugin, whose vectors the corpus holds under ``tpu_k=8_m=4``:
its directory keeps that name (``CORPUS_NAMES``), for ``create`` and
``check`` alike.  ``--device`` (default ``cuda``) goes into the ``gpu``
profile alone, and only when it is not ``cuda``; it never enters a
directory's name.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
from typing import Dict, List, Tuple

from ..ec import registry as ecreg

# the corpus matrix (reference corpus stores per-version directories
# of plugin/parameter combinations)
CONFIGS: List[Tuple[str, Dict[str, str]]] = [
    ("jerasure", {"k": "2", "m": "1",
                  "technique": "reed_sol_van"}),
    ("jerasure", {"k": "8", "m": "4",
                  "technique": "reed_sol_van"}),
    ("jerasure", {"k": "4", "m": "2",
                  "technique": "cauchy_good"}),
    ("jerasure", {"k": "5", "m": "3",
                  "technique": "liberation"}),
    ("isa", {"k": "4", "m": "2"}),
    ("gpu", {"k": "8", "m": "4"}),
    ("shec", {"k": "4", "m": "3", "c": "2"}),
    ("clay", {"k": "4", "m": "2"}),
    ("lrc", {"mapping": "__DD__DD",
             "layers": json.dumps([["_cDD_cDD", ""],
                                   ["cDDD____", ""],
                                   ["____cDDD", ""]])}),
]

PAYLOAD_SIZE = 31 * 1024 + 17          # deliberately unaligned


def payload() -> bytes:
    """Deterministic unaligned payload (reference uses a fixed random
    file committed to the corpus)."""
    out = bytearray()
    x = 0x12345678
    while len(out) < PAYLOAD_SIZE:
        x = (1103515245 * x + 12345) & 0x7FFFFFFF
        out.append(x & 0xFF)
    return bytes(out[:PAYLOAD_SIZE])


# the plugin name a config's directory is tagged with, where it differs
# from the plugin that computes it: the corpus holds the k=8 m=4
# reed_sol_van vectors under the name of the plugin that first wrote them
CORPUS_NAMES = {"gpu": "tpu"}


def config_dir(base: str, plugin: str, profile: Dict[str, str]) -> str:
    tag = CORPUS_NAMES.get(plugin, plugin) + "".join(
        f"_{k}={profile[k]}" for k in sorted(profile)
        if k not in ("mapping", "layers"))
    if "layers" in profile:
        tag += "_layered"
    return os.path.join(base, tag)


def _codec(plugin: str, profile: Dict[str, str], device: str = "cuda"):
    profile = dict(profile)
    if plugin == "gpu" and device != "cuda":
        profile["device"] = device
    return ecreg.instance().factory(plugin, profile)


def create(base: str, device: str = "cuda") -> int:
    data = payload()
    for plugin, profile in CONFIGS:
        ec = _codec(plugin, profile, device)
        n = ec.get_chunk_count()
        chunks = ec.encode(set(range(n)), data)
        d = config_dir(base, plugin, profile)
        os.makedirs(d, exist_ok=True)
        for i, buf in chunks.items():
            with open(os.path.join(d, f"chunk.{i}"), "wb") as f:
                f.write(buf)
        with open(os.path.join(d, "manifest.json"), "w") as f:
            json.dump({"plugin": plugin, "profile": profile,
                       "payload_size": PAYLOAD_SIZE,
                       "chunk_count": n}, f, indent=2, sort_keys=True)
        print(f"created {d}: {n} chunks of "
              f"{len(next(iter(chunks.values())))} bytes")
    return 0


def check(base: str, verbose: bool = False, device: str = "cuda") -> int:
    data = payload()
    failures = 0
    for plugin, profile in CONFIGS:
        d = config_dir(base, plugin, profile)
        manifest_path = os.path.join(d, "manifest.json")
        if not os.path.exists(manifest_path):
            print(f"MISSING corpus dir {d}", file=sys.stderr)
            failures += 1
            continue
        ec = _codec(plugin, profile, device)
        n = ec.get_chunk_count()
        stored = {}
        for i in range(n):
            with open(os.path.join(d, f"chunk.{i}"), "rb") as f:
                stored[i] = f.read()
        # 1) encode must reproduce the stored chunks bit-exactly
        fresh = ec.encode(set(range(n)), data)
        for i in range(n):
            if bytes(fresh[i]) != stored[i]:
                print(f"FAIL {d}: encode chunk {i} diverged",
                      file=sys.stderr)
                failures += 1
        # 2) decode of every 1- and 2-erasure pattern must recover the
        # stored bytes (reference erasure sweep)
        want = set(range(n))
        patterns = list(itertools.combinations(range(n), 1))
        if n - ec.get_data_chunk_count() >= 2:
            patterns += list(itertools.combinations(range(n), 2))
        for pattern in patterns:
            avail = {i: stored[i] for i in range(n)
                     if i not in pattern}
            try:
                need = ec.minimum_to_decode(set(pattern), set(avail))
            except IOError:
                # non-MDS codes (LRC locality configs, SHEC) declare
                # some erasure patterns unrecoverable — the reference
                # sweep likewise skips what minimum_to_decode rejects
                continue
            try:
                dec = ec.decode(set(pattern),
                                {i: avail[i] for i in need})
            except Exception as e:
                print(f"FAIL {d}: decode {pattern} raised {e!r}",
                      file=sys.stderr)
                failures += 1
                continue
            for i in pattern:
                if bytes(dec[i]) != stored[i]:
                    print(f"FAIL {d}: decode {pattern} chunk {i} "
                          f"diverged", file=sys.stderr)
                    failures += 1
        if verbose:
            print(f"ok {d} ({len(patterns)} erasure patterns)")
    if failures:
        print(f"{failures} non-regression failures", file=sys.stderr)
        return 1
    print(f"corpus ok: {len(CONFIGS)} configs bit-exact")
    return 0


def main(argv: List[str] = None) -> int:
    p = argparse.ArgumentParser(
        prog="ec-non-regression", description=__doc__.splitlines()[0])
    p.add_argument("--base", default="corpus")
    p.add_argument("--create", action="store_true")
    p.add_argument("--check", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="device of the gpu plugin's profile (cpu: run it "
                        "on the CPU)")
    ns = p.parse_args(argv)
    if ns.create:
        return create(ns.base, ns.device)
    return check(ns.base, ns.verbose, ns.device)


if __name__ == "__main__":
    sys.exit(main())
