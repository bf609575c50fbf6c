#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ceph_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:
  1. build every kernel of the codec paths from ceph_tpu_torch/csrc with
     nvcc (one process per source, started together): B1
     (gf8_bitplane.cu), B2 (packet_bitplane.cu) and B3 (packet_xor.cu);
  2. hold each kernel against its plain PyTorch version on the card,
     byte for byte, at encode and decode shapes;
  3. drive the byte-code path through the `gpu` plugin of the registry,
     at the headline k=8 m=4 reed_sol_van geometry (512 stripes x 128 KiB
     chunks = 512 MiB a dispatch): two encode dispatches in flight, a
     4-erasure decode, a 2-column parity delta and an ecutil object
     round trip of 64 MiB with HashInfo CRCs, each byte-exact;
  4. drive the packet-code path the same way, at the reference bench's
     cauchy_good k=10 m=4 decode geometry (128 stripes of 4 MiB, chunks
     of 409,600 bytes = 500 MiB of data a dispatch, packetsize 2048):
     two encode dispatches in flight, a device-resident decode of data
     erasures (0, 1, 2), a decode of (0, 5, 10, 13) and an ecutil round
     trip of a 64 MiB object; then packetsize 1000 (chunks of 416,000
     bytes): encode and decode; then the committed jerasure cauchy_good
     and liberation corpus vectors;
  5. fail unless every phase launched the kernel of its path: B1 on the
     byte-code phases, B2 on the packetsize-2048 phases and the corpus,
     B3 on the packetsize-1000 phases;
  6. time each kernel (median of CUDA-event-timed launches) beside its
     bound and its plain version at the shapes of its path.
Before the last line it prints the card's name and power limit and a
`kernels` JSON line; the last line is the JSON result.  With no CUDA
device, or outside the repo, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# headline geometry (the JAX package's bench.py headline workload)
K, M = 8, 4
CHUNK = 128 * 1024
STRIPES = 512
ERASED = (1, 5, 9, 11)
DIRTY = (2, 6)
OBJECT_BYTES = 64 << 20
SEED = 20261016
DEV = "cuda"               # every tensor and codec of the run lives here

# packet-code geometry: BASELINE config 3 (cauchy_good k=10 m=4, 4 MiB
# stripes), as the JAX package's bench.py decode_setup shapes it
PK, PM = 10, 4
PSTRIPES = 128
PCHUNK = 409600            # 25 super-words of 8 packets of 2048 bytes
PCHUNK_RAGGED = 416000     # 52 super-words of 8 packets of 1000 bytes
DEV_ERASED = (0, 1, 2)
PERASED = (0, 5, 10, 13)
PLAIN_SLICE = 16           # stripes per call of the plain B2 when timed
# (technique, k, m, w, packetsize) of the kernel-against-plain checks
PACKET_CASES = [("cauchy_good", 10, 4, 8, 2048),
                ("cauchy_good", 4, 2, 8, 2048),
                ("liberation", 5, 3, 7, 2048),
                ("cauchy_good", 10, 4, 8, 1000),
                ("cauchy_good", 4, 2, 8, 36)]
CORPUS = ["jerasure_k=4_m=2_technique=cauchy_good",
          "jerasure_k=5_m=3_technique=liberation"]

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense int8 ops/s
HBM_BPS = 3.35e12
INT8_OPS = 1.979e15


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def cuda_time_ms(fn, reps: int):
    """Median and all per-run times of ``fn()`` in ms, by CUDA events."""
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return median(times), times


def corpus_payload(size: int) -> bytes:
    """The corpus payload: the same linear congruential bytes the corpus
    vectors were written from."""
    out = bytearray()
    x = 0x12345678
    while len(out) < size:
        x = (1103515245 * x + 12345) & 0x7FFFFFFF
        out.append(x & 0xFF)
    return bytes(out)


def build_all(kernels) -> float:
    """Build every kernel's source with its own nvcc process, all at
    once; returns the wall seconds."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(kernels)) as ex:
        for path in ex.map(lambda mod: mod.build(verbose=True), kernels):
            print(f"built {os.path.relpath(path, HERE)}")
    return time.monotonic() - t0


def check_b1(torch, gf8_kernel, carry, matrix, engine) -> None:
    """B1 against gf8_apply_plain on the card, encode and decode rows."""
    rng = torch.Generator(device=DEV).manual_seed(SEED)
    for k, m in ((8, 4), (4, 2), (2, 1)):
        M_ = matrix.reed_sol_vandermonde_coding_matrix(k, m, 8)
        core = engine.CodecCore(k, m, 8, coding_matrix=M_)
        erased = tuple(range(m - 1)) + (k + m - 1,)
        chosen = tuple(i for i in range(k + m) if i not in erased)[:k]
        rows_gf, rows_bits = core._recovery_rows(chosen, erased)
        ops = {"encode": carry.carry_codec(M_, core.bitmatrix, k, m, 8,
                                           DEV),
               "decode": carry.carry_rows(rows_gf, rows_bits, DEV)}
        for L in (192, 320, 4096, 131072):
            data = torch.randint(0, 256, (3, k, L), dtype=torch.uint8,
                                 device=DEV, generator=rng)
            for name, op in ops.items():
                got = gf8_kernel.gf8_apply(op, data)
                want = gf8_kernel.gf8_apply_plain(op.bitmatrix, data)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"B1 {name} k={k} m={m} L={L}: kernel != plain")
        print(f"B1 == plain at k={k} m={m}, L in 192/320/4096/131072")


class Launches:
    """The kernels' launch counters: zeroed just before a phase, read
    just after it."""

    def __init__(self, mods: dict):
        self.mods = mods

    def reset(self) -> None:
        for mod in self.mods.values():
            mod.launches = 0

    def read(self) -> dict:
        return {name: mod.launches for name, mod in self.mods.items()}


def check_packet(torch, k_mods, carry, registry, engine) -> None:
    """B2 and B3 against their plain versions on the card, byte for byte,
    at encode bitmatrices and decode rows of PACKET_CASES."""
    b2, b3 = k_mods["B2"], k_mods["B3"]
    rng = torch.Generator(device=DEV).manual_seed(SEED + 2)
    for technique, k, m, w, ps in PACKET_CASES:
        codec = registry.instance().factory("gpu", {
            "technique": technique, "k": str(k), "m": str(m), "w": str(w),
            "packetsize": str(ps), "device": DEV})
        core = codec.core
        _, rows = core._decode_rows(tuple(range(m, k + m)),
                                    tuple(range(m)))
        data = torch.randint(0, 256, (3, k, 3 * w * ps), dtype=torch.uint8,
                             device=DEV, generator=rng)
        for name, B in (("encode", core.bitmatrix), ("decode", rows)):
            want = b2.packet_apply_plain(B, data, w, ps)
            sched = engine.build_xor_schedule(B)
            got2 = b2.packet_apply(carry.packet_operand(B, w, DEV), data,
                                   ps)
            got3 = b3.packet_xor(carry.schedule_operand(sched, k, w, DEV),
                                 data, ps)
            plain3 = b3.packet_xor_plain(sched, data, w, ps)
            torch.cuda.synchronize()
            for what, got, ref in (("B2", got2, want), ("B3", got3, plain3),
                                   ("B3 plain", plain3, want)):
                if not torch.equal(got, ref):
                    raise AssertionError(
                        f"{what} {technique} k={k} m={m} w={w} ps={ps} "
                        f"{name}: kernel != plain")
        print(f"B2 == plain, B3 == plain at {technique} k={k} m={m} w={w} "
              f"packetsize={ps}, encode and decode rows")


def main_path(torch, np, registry, ecutil, engine, counts) -> dict:
    """Drive the headline path through the registry; returns per-phase
    launch counts and host timings."""
    codec = registry.instance().factory(
        "gpu", {"k": str(K), "m": str(M), "technique": "reed_sol_van",
                "device": DEV})
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)

    def rand(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8,
                             device=DEV, generator=gen).cpu().numpy()

    d1, d2 = rand(STRIPES, K, CHUNK), rand(STRIPES, K, CHUNK)
    delta = rand(STRIPES, len(DIRTY), CHUNK)
    obj = rand(OBJECT_BYTES).tobytes()
    torch.cuda.synchronize()
    launches, info = {}, {}

    # encode: two 512 MiB dispatches in flight
    counts.reset()
    t0 = time.monotonic()
    h1 = codec.encode_batch_async(d1)
    h2 = codec.encode_batch_async(d2)
    p1, p2 = h1.wait(), h2.wait()
    info["encode_s"] = time.monotonic() - t0
    launches["encode"] = counts.read()
    ref = engine.NumpyBackend()
    for d, p in ((d1, p1), (d2, p2)):
        if not np.array_equal(p[:4], ref.apply_matrix(
                codec.core.coding_matrix, d[:4], 8)):
            raise AssertionError("encode prefix != NumpyBackend")
    print(f"encode: 2 x {STRIPES} stripes, {2 * d1.nbytes / 2**30:.3f} "
          f"GiB in {info['encode_s']:.4f} s host to host")

    # decode: 4 erasures, combined recovery rows
    present = {i: (d1[:, i] if i < K else p1[:, i - K])
               for i in range(K + M) if i not in ERASED}
    counts.reset()
    t0 = time.monotonic()
    rec = codec.decode_batch_async(present, CHUNK).wait()
    info["decode_s"] = time.monotonic() - t0
    launches["decode"] = counts.read()
    for e in ERASED:
        want = d1[:, e] if e < K else p1[:, e - K]
        if not np.array_equal(rec[e], want):
            raise AssertionError(f"decode chunk {e} != original")
    print(f"decode: erasures {ERASED} in {info['decode_s']:.4f} s")

    # parity delta for 2 dirty columns vs a full re-encode
    counts.reset()
    t0 = time.monotonic()
    dpar = codec.delta_encode_batch_async(delta, DIRTY).wait()
    info["delta_s"] = time.monotonic() - t0
    launches["delta"] = counts.read()
    d1[:, list(DIRTY)] ^= delta
    full = codec.encode_batch_async(d1).wait()
    if not np.array_equal(p1 ^ dpar, full):
        raise AssertionError("old parity ^ delta parity != re-encode")
    print(f"delta: dirty columns {DIRTY} in {info['delta_s']:.4f} s")

    # ecutil object round trip with HashInfo CRCs
    counts.reset()
    t0 = time.monotonic()
    info["ecutil_s"] = ecutil_round_trip(ecutil, codec, K, M, CHUNK, obj,
                                         ERASED)
    launches["ecutil"] = counts.read()
    print(f"ecutil: {OBJECT_BYTES >> 20} MiB object, 4 shards rebuilt, "
          f"CRCs equal, {info['ecutil_s']:.4f} s")
    info["d1"] = d1
    return {"launches": launches, "info": info}


def ecutil_round_trip(ecutil, codec, k, m, chunk, obj, erased) -> float:
    """Encode ``obj`` (zero-padded to whole stripes) into shards, drop
    ``erased``, rebuild the object and every shard; the HashInfo CRCs of
    the rebuilt shards must equal the originals'.  Returns seconds."""
    sinfo = ecutil.StripeInfo(k, k * chunk)
    padded = obj + bytes(-len(obj) % sinfo.stripe_width)
    t0 = time.monotonic()
    shards = ecutil.encode(sinfo, codec, padded)
    have = {i: b for i, b in shards.items() if i not in erased}
    back = ecutil.decode_concat(sinfo, codec, have)
    rebuilt = ecutil.decode(sinfo, codec, have, set(range(k + m)))
    secs = time.monotonic() - t0
    if back[:len(obj)] != obj:
        raise AssertionError("ecutil decode_concat != object")
    h_a, h_b = ecutil.HashInfo(k + m), ecutil.HashInfo(k + m)
    h_a.append(0, shards)
    h_b.append(0, rebuilt)
    if h_a.crcs != h_b.crcs or h_a.total_chunk_size != h_b.total_chunk_size:
        raise AssertionError("HashInfo CRCs differ after rebuild")
    return secs


LEDGER_PHASES = ("stage_acquire", "h2d_start", "h2d_done", "compute_start",
                 "compute_done", "d2h_done", "deliver")


def print_ledgers(handles) -> None:
    """Each dispatch's device-phase stamps (host clock), in ms from the
    first dispatch's staging: when each phase of each ended."""
    t0 = handles[0].ledger["stage_acquire"]
    for i, h in enumerate(handles):
        print(f"  dispatch {i} ledger, ms: " + ", ".join(
            f"{p} {(h.ledger[p] - t0) * 1e3:.3f}" for p in LEDGER_PHASES))


def packet_oracle(engine, B, data, w, ps):
    """NumpyBackend's packet-layout apply of bitmatrix B to bytes."""
    pk = engine.bytes_to_packets(data, w, ps)
    out = engine.NumpyBackend().apply_bitmatrix_packets(B, pk)
    return engine.packets_to_bytes(out, w, ps)


def packet_path(torch, np, registry, ecutil, engine, counts) -> dict:
    """Drive the packet-code path (cauchy_good k=10 m=4) through the
    registry at packetsize 2048 and 1000, and the packet corpus vectors;
    returns per-phase launch counts, host timings and the inputs the
    timings reuse."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 3)

    def rand(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8,
                             device=DEV, generator=gen).cpu().numpy()

    launches, info = {}, {}
    codec = registry.instance().factory(
        "gpu", {"k": str(PK), "m": str(PM), "technique": "cauchy_good",
                "device": DEV})
    core = codec.core
    if core.packetsize != 2048:
        raise AssertionError(f"default packetsize {core.packetsize}")
    d1, d2 = rand(PSTRIPES, PK, PCHUNK), rand(PSTRIPES, PK, PCHUNK)
    obj = rand(OBJECT_BYTES).tobytes()

    # encode: two 500 MiB dispatches in flight
    counts.reset()
    t0 = time.monotonic()
    h1 = codec.encode_batch_async(d1)
    h2 = codec.encode_batch_async(d2)
    p1, p2 = h1.wait(), h2.wait()
    info["pkt_encode_s"] = time.monotonic() - t0
    launches["pkt_encode"] = counts.read()
    for d, p in ((d1, p1), (d2, p2)):
        if not np.array_equal(p[:2], packet_oracle(
                engine, core.bitmatrix, d[:2], core.w, core.packetsize)):
            raise AssertionError("packet encode prefix != NumpyBackend")
    print(f"packet encode: 2 x {PSTRIPES} stripes of {PK} x {PCHUNK} B, "
          f"{2 * d1.nbytes / 2**30:.3f} GiB in {info['pkt_encode_s']:.4f} "
          f"s host to host")
    print_ledgers((h1, h2))
    chunks = {i: (d1[:, i] if i < PK else p1[:, i - PK])
              for i in range(PK + PM)}

    # device-resident decode of data erasures, as the reference bench
    chosen = [i for i in range(PK + PM) if i not in DEV_ERASED][:PK]
    dev, batch, L = codec.stage_batch(
        np.stack([chunks[i] for i in chosen], axis=1))
    counts.reset()
    t0 = time.monotonic()
    out = codec.decode_batch_device(dev, chosen, DEV_ERASED)
    torch.cuda.synchronize()
    info["pkt_decode_device_s"] = time.monotonic() - t0
    launches["pkt_decode_device"] = counts.read()
    if not np.array_equal(out[:batch, :, :L].cpu().numpy(),
                          d1[:, list(DEV_ERASED)]):
        raise AssertionError("packet device decode != original")
    del dev, out
    print(f"packet decode_batch_device: erasures {DEV_ERASED} in "
          f"{info['pkt_decode_device_s']:.4f} s")

    # decode: data and parity erasures, decode rows then parity re-encode
    present = {i: c for i, c in chunks.items() if i not in PERASED}
    counts.reset()
    t0 = time.monotonic()
    rec = codec.decode_batch(present, PCHUNK)
    info["pkt_decode_s"] = time.monotonic() - t0
    launches["pkt_decode"] = counts.read()
    if launches["pkt_decode"]["B2"] != 2:
        raise AssertionError("packet decode of data and parity erasures "
                             "should launch B2 twice")
    for e in PERASED:
        if not np.array_equal(rec[e], chunks[e]):
            raise AssertionError(f"packet decode chunk {e} != original")
    print(f"packet decode_batch: erasures {PERASED} in "
          f"{info['pkt_decode_s']:.4f} s")

    # ecutil object round trip
    counts.reset()
    info["pkt_ecutil_s"] = ecutil_round_trip(ecutil, codec, PK, PM, PCHUNK,
                                             obj, PERASED)
    launches["pkt_ecutil"] = counts.read()
    print(f"packet ecutil: {OBJECT_BYTES >> 20} MiB object, 4 shards "
          f"rebuilt, CRCs equal, {info['pkt_ecutil_s']:.4f} s")

    # the same geometry at packetsize 1000: XOR-schedule kernel B3
    ragged = registry.instance().factory(
        "gpu", {"k": str(PK), "m": str(PM), "technique": "cauchy_good",
                "packetsize": "1000", "device": DEV})
    rcore = ragged.core
    d3 = rand(PSTRIPES, PK, PCHUNK_RAGGED)
    counts.reset()
    t0 = time.monotonic()
    p3 = ragged.encode_batch_async(d3).wait()
    info["ragged_encode_s"] = time.monotonic() - t0
    launches["ragged_encode"] = counts.read()
    if not np.array_equal(p3[:2], packet_oracle(
            engine, rcore.bitmatrix, d3[:2], rcore.w, rcore.packetsize)):
        raise AssertionError("packetsize-1000 encode prefix != NumpyBackend")
    rchunks = {i: (d3[:, i] if i < PK else p3[:, i - PK])
               for i in range(PK + PM)}
    counts.reset()
    t0 = time.monotonic()
    rrec = ragged.decode_batch({i: c for i, c in rchunks.items()
                                if i not in PERASED}, PCHUNK_RAGGED)
    info["ragged_decode_s"] = time.monotonic() - t0
    launches["ragged_decode"] = counts.read()
    for e in PERASED:
        if not np.array_equal(rrec[e], rchunks[e]):
            raise AssertionError(f"packetsize-1000 decode chunk {e} != "
                                 f"original")
    print(f"packetsize 1000: encode {info['ragged_encode_s']:.4f} s, "
          f"decode of {PERASED} {info['ragged_decode_s']:.4f} s")

    # the committed jerasure corpus vectors through `gpu` on CUDA
    counts.reset()
    for name in CORPUS:
        check_corpus(registry, name)
    launches["corpus"] = counts.read()
    print(f"corpus: {', '.join(CORPUS)}: encode equal, every 1- and "
          f"2-erasure decode equal")
    info.update(d1=d1, d3=d3, bitmatrix=core.bitmatrix,
                ragged_bitmatrix=rcore.bitmatrix)
    return {"launches": launches, "info": info}


def check_corpus(registry, name: str) -> None:
    import itertools
    d = os.path.join(HERE, "corpus", name)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    codec = registry.instance().factory(
        "gpu", dict(manifest["profile"], device=DEV))
    n = manifest["chunk_count"]
    stored = {}
    for i in range(n):
        with open(os.path.join(d, f"chunk.{i}"), "rb") as f:
            stored[i] = f.read()
    fresh = codec.encode(set(range(n)),
                         corpus_payload(manifest["payload_size"]))
    if any(fresh[i] != stored[i] for i in range(n)):
        raise AssertionError(f"corpus {name}: encode != stored chunks")
    for r in (1, 2):
        for erased in itertools.combinations(range(n), r):
            avail = {i: stored[i] for i in range(n) if i not in erased}
            dec = codec.decode(set(erased), avail)
            if any(dec[e] != stored[e] for e in erased):
                raise AssertionError(f"corpus {name}: decode of {erased}")


def measure(torch, run, plain, out, nbytes: int, ops: int,
            ops_rate: float) -> dict:
    """``run()`` (a kernel writing ``out``) and ``plain()`` (its plain
    version on the same inputs): medians by CUDA events, the largest
    difference of their outputs, and the bound from bytes and ops."""
    for _ in range(3):
        run()
    ms, runs = cuda_time_ms(run, 20)
    want = plain()
    plain_ms, _ = cuda_time_ms(plain, 3)
    err = int((want.to(torch.int16) - out.to(torch.int16)).abs().max())
    del want
    torch.cuda.empty_cache()
    bytes_ms, ops_ms = nbytes / HBM_BPS * 1e3, ops / ops_rate * 1e3
    return {"ms": ms, "runs_ms": runs, "plain_ms": plain_ms,
            "max_abs_err": err, "bytes": nbytes, "ops": ops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def measure_b1(torch, gf8_kernel, carry, matrix, d_host) -> dict:
    """B1 and its plain version at the headline shape, same inputs."""
    M_ = matrix.reed_sol_vandermonde_coding_matrix(K, M, 8)
    op = carry.carry_codec(M_, matrix.matrix_to_bitmatrix(M_, 8), K, M, 8,
                           DEV)
    data = torch.from_numpy(d_host).to(DEV)
    out = torch.empty((STRIPES, M, CHUNK), dtype=torch.uint8, device=DEV)
    # as a mod-2 int8 product: 2 ops per bitmatrix entry per byte column
    return measure(
        torch, lambda: gf8_kernel.gf8_apply(op, data, out),
        lambda: gf8_kernel.gf8_apply_plain(op.bitmatrix, data), out,
        data.numel() + out.numel(), 2 * (8 * M) * (8 * K) * STRIPES * CHUNK,
        INT8_OPS)


def measure_b2(torch, b2, carry, B, d_host) -> dict:
    """B2 and its plain version at [128, 10, 409600] -> [128, 4,
    409600].  The plain version runs in slices of PLAIN_SLICE stripes
    (its float32 bit tensor is about 17 GB for the whole batch); its
    time is that of all the slices."""
    w, ps = 8, 2048
    op = carry.packet_operand(B, w, DEV)
    data = torch.from_numpy(d_host).to(DEV)
    out = torch.empty((PSTRIPES, PM, PCHUNK), dtype=torch.uint8,
                      device=DEV)

    def plain():
        return torch.cat([b2.packet_apply_plain(
            op.bitmatrix, data[i:i + PLAIN_SLICE], w, ps)
            for i in range(0, PSTRIPES, PLAIN_SLICE)])
    # as a mod-2 int8 product ([R, k*w] @ [k*w, 8*ps] per super-word)
    return measure(
        torch, lambda: b2.packet_apply(op, data, ps, out), plain, out,
        data.numel() + out.numel(),
        2 * op.rows * PK * w * PSTRIPES * PCHUNK, INT8_OPS)


def measure_b3(torch, b3, carry, engine, B, d_host) -> dict:
    """B3 and its plain version at [128, 10, 416000] -> [128, 4,
    416000], packetsize 1000."""
    w, ps = 8, 1000
    sched = engine.build_xor_schedule(B)
    op = carry.schedule_operand(sched, PK, w, DEV)
    data = torch.from_numpy(d_host).to(DEV)
    out = torch.empty((PSTRIPES, PM, PCHUNK_RAGGED), dtype=torch.uint8,
                      device=DEV)
    # the schedule's packet XORs, one operation per byte, at the int8 rate
    xors = sum(len(cols) for _, cols in sched)
    return measure(
        torch, lambda: b3.packet_xor(op, data, ps, out),
        lambda: b3.packet_xor_plain(sched, data, w, ps), out,
        data.numel() + out.numel(), xors * ps * PSTRIPES * (
            PCHUNK_RAGGED // (w * ps)), INT8_OPS)


# phase -> the kernel its path must launch
PHASE_KERNEL = {"encode": "B1", "decode": "B1", "delta": "B1",
                "ecutil": "B1", "pkt_encode": "B2",
                "pkt_decode_device": "B2", "pkt_decode": "B2",
                "pkt_ecutil": "B2", "ragged_encode": "B3",
                "ragged_decode": "B3", "corpus": "B2"}
KERNELS = {
    "B1": ("gf8_bitplane_apply (B1)", "ceph_tpu_torch/csrc/gf8_bitplane.cu",
           "ceph_tpu/ops/jax_engine.py:382",
           f"[{STRIPES}, {K}, {CHUNK}] -> [{STRIPES}, {M}, {CHUNK}]"),
    "B2": ("packet_bitplane_apply (B2)",
           "ceph_tpu_torch/csrc/packet_bitplane.cu",
           "ceph_tpu/ops/jax_engine.py:289",
           f"[{PSTRIPES}, {PK}, {PCHUNK}] -> [{PSTRIPES}, {PM}, {PCHUNK}], "
           f"packetsize 2048"),
    "B3": ("packet_xor_apply (B3)", "ceph_tpu_torch/csrc/packet_xor.cu",
           "ceph_tpu/ops/jax_engine.py:234",
           f"[{PSTRIPES}, {PK}, {PCHUNK_RAGGED}] -> [{PSTRIPES}, {PM}, "
           f"{PCHUNK_RAGGED}], packetsize 1000"),
}


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "ceph_tpu_torch")):
        return fail("run from a checkout of the repo: ceph_tpu_torch/ "
                    "is missing beside this script")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        return fail("CUDA is not available")
    sys.path.insert(0, HERE)
    from ceph_tpu_torch.ec import registry
    from ceph_tpu_torch.ops import (carry, engine, gf8_kernel, matrix,
                                   packet_kernel, packet_xor_kernel,
                                   torch_engine)
    from ceph_tpu_torch.osd import ecutil
    mods = {"B1": gf8_kernel, "B2": packet_kernel, "B3": packet_xor_kernel}
    counts = Launches(mods)

    try:
        secs = build_all(list(mods.values()))
        print(f"build: {secs:.3f} s")
        check_b1(torch, gf8_kernel, carry, matrix, engine)
        check_packet(torch, mods, carry, registry, torch_engine)
        run = main_path(torch, np, registry, ecutil, engine, counts)
        pkt = packet_path(torch, np, registry, ecutil, engine, counts)
        launches = {**run["launches"], **pkt["launches"]}
        for phase, n in launches.items():
            if n[PHASE_KERNEL[phase]] < 1:
                raise AssertionError(
                    f"{PHASE_KERNEL[phase]} not launched in phase {phase}")
        print(f"launches by phase: {json.dumps(launches)}")
        info = pkt["info"]
        meas = {
            "B1": measure_b1(torch, gf8_kernel, carry, matrix,
                             run["info"]["d1"]),
            "B2": measure_b2(torch, packet_kernel, carry, info["bitmatrix"],
                             info["d1"]),
            "B3": measure_b3(torch, packet_xor_kernel, carry, torch_engine,
                             info["ragged_bitmatrix"], info["d3"])}
        for name, me in meas.items():
            if me["max_abs_err"] != 0:
                raise AssertionError(f"{name} != plain at its timed shape")
    except Exception as e:  # every phase failure ends the run non-zero
        import traceback
        traceback.print_exc()
        return fail(f"{type(e).__name__}: {e}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"nvidia-smi: {smi.stdout.strip() or smi.stderr.strip()}")
    line = []
    for key, me in meas.items():
        name, source, replaces, shape = KERNELS[key]
        print(f"{key} at {shape}: median {me['ms']:.4f} ms of "
              f"{len(me['runs_ms'])} runs ({me['bytes'] / me['ms'] / 1e6:.1f}"
              f" GB/s moved), bound {me['bound_ms']:.4f} ms "
              f"({me['bound_by']}), plain {me['plain_ms']:.4f} ms, library "
              f"call: none")
        line.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(n[key] for n in launches.values()),
            "max_abs_err": me["max_abs_err"], "ms": me["ms"],
            "plain_ms": me["plain_ms"], "bound_ms": me["bound_ms"],
            "bound_by": me["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
