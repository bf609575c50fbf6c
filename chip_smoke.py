#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ceph_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:
  1. build every kernel of the codec paths from ceph_tpu_torch/csrc with
     nvcc (one process per source, started together): B1
     (gf8_bitplane.cu), B2 (packet_bitplane.cu) and B3 (packet_xor.cu);
  2. hold each kernel against its plain PyTorch version on the card,
     byte for byte, at encode and decode shapes (B1 also at chunk
     lengths that take 8- and 4-byte loads, on a misaligned view and at
     the widest operand it admits, one chunk more being refused);
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
  5. drive one OSD's EncodeBatcher (ceph_tpu_torch/osd/batcher.py),
     built from default_config() with ec_tpu_batch_stripes=512,
     ec_tpu_queue_window_us=2000, ec_tpu_fallback_cpu=False and
     osd_ec_prewarm=True, from 8 submitting threads: prewarm, then two
     passes of 128 writes of 4 MiB (k=8 m=4, 128 KiB chunks) and a
     burst of 256 (two groups in flight), 128 degraded reads of those
     objects with shards (1, 5, 9, 11) lost, 128 overwrites of data
     columns (2, 6) over 4 stripes, and 64 one-stripe cauchy_good
     k=10 m=4 writes; every result byte-equal to
     the batcher's CPU twin (jerasure on the native GF kernels), fewer
     calls than requests in each lane, no group served by the twin, no
     device error and the breaker never open; one line per lane with
     its calls, host-to-host rate, launches and overlap share;
  6. drive the store (ceph_tpu_torch/store/bluestore.py): one RAM
     BlueStore with its defaults, wired to the batcher of phase 5 as an
     OSD wires it (attach_device_batcher), takes 128 writes of 4 MiB from
     8 threads; each write's checksum batch (1024 blocks of 4 KiB) is one
     crclinear window on B1; every object reads back byte-equal, every
     block's CRC equals the host crc32c, every batch of more than one
     block ran on the card, and no fallback is counted; the same writes
     into a BlueStore with no backend (the host loop) for comparison;
  7. a deep-scrub-shaped window (as the JAX package's
     osd/ecbackend.py builds it): 128 k=8 m=4 stripes of 128 KiB chunks
     encoded through the `gpu` plugin, each shard's 16 MiB window with
     its syndrome bands through crclinear on B1 (bitmatrices of up to
     [160, 4096], applied in row groups), equal to the CPU route; the
     syndrome partials cancel across the 12 shards and do not after one
     flipped byte;
  8. fail unless every phase launched the kernel of its path: B1 on the
     byte-code phases, the batcher's encode, decode and delta lanes, the
     store and the scrub window, B2 on the packetsize-2048 phases, the
     corpus and the batcher's packet lane, B3 on the packetsize-1000
     phases;
  9. time each kernel (median of CUDA-event-timed launches) beside its
     bound and its plain version at the shapes of its path, and B2 and B3
     each at the other's shape too, B1 also at the store's and the scrub
     window's shapes; print each one's share of its bound, the
     registers, local and shared memory each kernel's block uses, and
     the static SASS opcode counts of B1's main-path kernel.
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
# B1 check lengths: ragged, 16-byte loads, 8- and 4-byte loads
B1_LENGTHS = (192, 320, 4096, 4100, 4104, 131072)

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

# batcher phase: one OSD's EncodeBatcher from default_config(), PG
# workers as submitting threads; 4 MiB objects (the RBD/RGW default)
BATCH_STRIPES = 512        # ec_tpu_batch_stripes: stripes a dispatch
BATCH_WINDOW_US = 2000     # ec_tpu_queue_window_us
OBJ_STRIPES = 4            # 4 MiB objects of 1 MiB k=8 stripes
BATCH_OPS = 128            # requests a lane pass: 512 MiB of objects
BATCH_THREADS = 8
PKT_OPS = 64               # one-stripe cauchy_good writes of 4 MiB

# store phase: a RAM BlueStore with its defaults; 4 MiB objects
STORE_OBJS = 128           # 512 MiB of 4 KiB blocks
STORE_COLL = "1.0s0"
# scrub window: ec_tpu_scrub_window_bytes (16 MiB) of 128 KiB chunks
SCRUB_STRIPES = 128

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


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
    except OSError as e:
        return f"not read: {e}"
    return smi.stdout.strip() or smi.stderr.strip()


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
    """B1 against gf8_apply_plain on the card: encode and decode rows at
    chunk lengths that take 16-, 8- and 4-byte loads (4096, 4104, 4100)
    and a ragged tail, a misaligned view, and the widest operand the
    wrapper admits, with one chunk more refused before any launch."""
    rng = torch.Generator(device=DEV).manual_seed(SEED)

    def same(name, op, data, out=None):
        got = gf8_kernel.gf8_apply(op, data, out)
        want = gf8_kernel.gf8_apply_plain(op.bitmatrix, data)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"B1 {name}: kernel != plain")

    for k, m in ((8, 4), (4, 2), (2, 1)):
        M_ = matrix.reed_sol_vandermonde_coding_matrix(k, m, 8)
        core = engine.CodecCore(k, m, 8, coding_matrix=M_)
        erased = tuple(range(m - 1)) + (k + m - 1,)
        chosen = tuple(i for i in range(k + m) if i not in erased)[:k]
        rows_gf, rows_bits = core._recovery_rows(chosen, erased)
        ops = {"encode": carry.carry_codec(M_, core.bitmatrix, k, m, 8,
                                           DEV),
               "decode": carry.carry_rows(rows_gf, rows_bits, DEV)}
        for L in B1_LENGTHS:
            data = torch.randint(0, 256, (3, k, L), dtype=torch.uint8,
                                 device=DEV, generator=rng)
            for name, op in ops.items():
                same(f"{name} k={k} m={m} L={L}", op, data)
        print(f"B1 == plain at k={k} m={m}, L in "
              f"{'/'.join(map(str, B1_LENGTHS))}")
    # a view 1 byte into its buffer: byte loads and stores
    flat = torch.randint(0, 256, (1 + 3 * K * 4096,), dtype=torch.uint8,
                         device=DEV, generator=rng)
    out = torch.empty(1 + 3 * M * 4096, dtype=torch.uint8, device=DEV)
    same("misaligned", ops_of(carry, matrix, K, M),
         flat[1:].view(3, K, 4096), out[1:].view(3, M, 4096))
    # the widest operand: m_out * k * 24 bytes of tables in 48 KiB
    k = gf8_kernel.MAX_TABLE_BYTES // (gf8_kernel.TABLE_BYTES * M)
    gen = torch.Generator().manual_seed(SEED)
    B = torch.randint(0, 2, (8 * M, 8 * k), dtype=torch.uint8, generator=gen)
    same(f"m_out={M} k={k}", carry.bitmatrix_operand(B.numpy(), k, DEV),
         torch.randint(0, 256, (2, k, 100), dtype=torch.uint8, device=DEV,
                       generator=rng))
    before = gf8_kernel.launches
    try:
        gf8_kernel.gf8_apply(
            carry.bitmatrix_operand(torch.zeros(8 * M, 8 * (k + 1),
                                                dtype=torch.uint8).numpy(),
                                    k + 1, DEV),
            torch.zeros((1, k + 1, 16), dtype=torch.uint8, device=DEV))
    except ValueError:
        pass
    else:
        raise AssertionError(f"B1 took m_out={M} k={k + 1}")
    if gf8_kernel.launches != before:
        raise AssertionError("B1 launched an operand it refuses")
    print(f"B1 == plain on a misaligned view and at m_out={M} k={k}; "
          f"k={k + 1} refused before launching")


def ops_of(carry, matrix, k, m):
    """The reed_sol_van encode operand of (k, m) on the card."""
    M_ = matrix.reed_sol_vandermonde_coding_matrix(k, m, 8)
    return carry.carry_codec(M_, matrix.matrix_to_bitmatrix(M_, 8), k, m, 8,
                             DEV)


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
    op = ops_of(carry, matrix, K, M)
    data = torch.from_numpy(d_host).to(DEV)
    out = torch.empty((STRIPES, M, CHUNK), dtype=torch.uint8, device=DEV)
    # as a mod-2 int8 product: 2 ops per bitmatrix entry per byte column
    me = measure(
        torch, lambda: gf8_kernel.gf8_apply(op, data, out),
        lambda: gf8_kernel.gf8_apply_plain(op.bitmatrix, data), out,
        data.numel() + out.numel(), 2 * (8 * M) * (8 * K) * STRIPES * CHUNK,
        INT8_OPS)
    me["smem"] = op.tables.numel() * op.tables.element_size()
    return me


def measure_b2(torch, b2, carry, B, d_host, ps: int) -> dict:
    """B2 and its plain version on d_host [128, 10, L] at packet size ps.
    The plain version runs in slices of PLAIN_SLICE stripes (its float32
    bit tensor is about 17 GB for the whole batch); its time is that of
    all the slices."""
    w = 8
    op = carry.packet_operand(B, w, DEV)
    data = torch.from_numpy(d_host).to(DEV)
    L = data.shape[2]
    out = torch.empty((PSTRIPES, PM, L), dtype=torch.uint8, device=DEV)

    def plain():
        return torch.cat([b2.packet_apply_plain(
            op.bitmatrix, data[i:i + PLAIN_SLICE], w, ps)
            for i in range(0, PSTRIPES, PLAIN_SLICE)])
    # as a mod-2 int8 product ([R, k*w] @ [k*w, 8*ps] per super-word)
    me = measure(
        torch, lambda: b2.packet_apply(op, data, ps, out), plain, out,
        data.numel() + out.numel(), 2 * op.rows * PK * w * PSTRIPES * L,
        INT8_OPS)
    me["tile"], me["smem"] = b2.launch_plan(op, ps)
    return me


def measure_b3(torch, b3, carry, engine, B, d_host, ps: int) -> dict:
    """B3 and its plain version on d_host [128, 10, L] at packet size
    ps."""
    w = 8
    sched = engine.build_xor_schedule(B)
    op = carry.schedule_operand(sched, PK, w, DEV)
    data = torch.from_numpy(d_host).to(DEV)
    L = data.shape[2]
    out = torch.empty((PSTRIPES, PM, L), dtype=torch.uint8, device=DEV)
    # the schedule's packet XORs, one operation per byte, at the int8 rate
    xors = sum(len(cols) for _, cols in sched)
    me = measure(
        torch, lambda: b3.packet_xor(op, data, ps, out),
        lambda: b3.packet_xor_plain(sched, data, w, ps), out,
        data.numel() + out.numel(), xors * ps * PSTRIPES * (L // (w * ps)),
        INT8_OPS)
    me["tile"], me["smem"] = b3.launch_plan(op, ps)
    return me


def measure_crc(torch, np, gf8_kernel, carry, torch_engine, store_obj,
                scrub) -> dict:
    """B1 at crclinear's shapes, each against its plain version: the
    store's checksum window (one 4 MiB write: [1024, 512, 8] -> [1024,
    4, 8]) and one row group of the scrub window ([128, 512, 256] ->
    [128, 4, 256]); the whole scrub window's split apply (one launch a
    row group, each re-reading the input) against the bound of reading
    it once; and one store window host to host through the backend,
    staged at its own length against staged padded to LENGTH_QUANTUM
    and a power-of-two batch, as before."""
    from ceph_tpu_torch.ops import crclinear
    lin = crclinear.shared()
    out = {}
    x_store = lin.stack_blocks(store_obj.reshape(-1, 4096))
    x_scrub = lin.stack_blocks(scrub["shard"])
    for name, x, band in (("store", x_store, 1),
                          ("scrub_group", x_scrub, scrub["bands"][-1])):
        op = carry.bitmatrix_operand(lin.block_bitmatrix((band,)),
                                     lin.block, DEV)
        data = torch.from_numpy(x).to(DEV)
        res = torch.empty((data.shape[0], op.m_out, data.shape[2]),
                          dtype=torch.uint8, device=DEV)
        out[name] = measure(
            torch, lambda: gf8_kernel.gf8_apply(op, data, res),
            lambda: gf8_kernel.gf8_apply_plain(op.bitmatrix, data), res,
            data.numel() + res.numel(),
            2 * (8 * op.m_out) * (8 * op.k) * data.shape[0] * data.shape[2],
            INT8_OPS)
        out[name]["shape"] = (tuple(data.shape), tuple(res.shape))
    M_ = lin.block_bitmatrix(scrub["bands"])
    split = carry.bitmatrix_split(M_, lin.block, DEV)
    data = torch.from_numpy(x_scrub).to(DEV)
    res = torch.empty((data.shape[0], split.m_out, data.shape[2]),
                      dtype=torch.uint8, device=DEV)
    out["scrub_window"] = measure(
        torch, lambda: torch_engine.gf8_apply_split(split, data, res),
        lambda: gf8_kernel.gf8_apply_plain(M_, data), res,
        data.numel() + res.numel(),
        2 * M_.shape[0] * M_.shape[1] * data.shape[0] * data.shape[2],
        INT8_OPS)
    out["scrub_window"].update(shape=(tuple(data.shape), tuple(res.shape)),
                               groups=len(split.blocks))
    # one store window host to host: staged unpadded, and padded
    be = scrub["backend"]
    M1 = lin.block_bitmatrix((1,))
    fn = be._bitmatrix_fn(M1, 8)
    batch, k, L = x_store.shape
    want = be.apply_bitmatrix_bytes(M1, x_store, 8)
    staged = {}
    for name, run, nbytes in (
            ("own", lambda: be.apply_bitmatrix_bytes(M1, x_store, 8),
             x_store.nbytes),
            ("padded", lambda: be._run_sync(fn, x_store,
                                            torch_engine.LENGTH_QUANTUM),
             torch_engine._bucket_batch(batch) * k * torch_engine._round_up(
                 L, torch_engine.LENGTH_QUANTUM))):
        if not np.array_equal(run(), want):
            raise AssertionError(f"store window staged {name} differs")
        times = []
        for _ in range(5):
            t0 = time.monotonic()
            run()
            times.append(time.monotonic() - t0)
        staged[name] = {"bytes": nbytes, "ms": median(times) * 1e3}
    out["staged"] = staged
    return out


def fan_out(fn, n: int, threads: int) -> None:
    """Call fn(i) for i in range(n) from ``threads`` threads at once, as
    PG workers submit to one OSD's batcher."""
    import threading
    ts = [threading.Thread(target=lambda j=j: [fn(i) for i in
                                               range(j, n, threads)])
          for j in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()


def run_lane(b, submit, n: int, counts, lane: str) -> dict:
    """Submit n requests from BATCH_THREADS threads, wait for every
    callback; returns the results, wall seconds, launches, the lane's
    batched calls and the ledgers of its groups."""
    import threading
    out = [None] * n
    ends = [0.0] * n
    left = threading.Semaphore(0)

    def cb(i):
        def done(res):
            out[i], ends[i] = res, time.time()
            left.release()
        return done
    attr = {"encode": "calls", "decode": "dec_calls",
            "delta": "delta_calls", "packet": "calls"}[lane]
    calls0 = getattr(b, attr)
    seen = len(b.ledger_accum.recent())
    counts.reset()
    t0, t0_wall = time.monotonic(), time.time()
    fan_out(lambda i: submit(i, cb(i)), n, BATCH_THREADS)
    submitted = time.time() - t0_wall
    for _ in range(n):
        if not left.acquire(timeout=300):
            raise AssertionError(f"batcher {lane} lane: a request never "
                                 f"completed")
    wall = time.monotonic() - t0
    launches = counts.read()
    if any(r is None for r in out):
        raise AssertionError(f"batcher {lane} lane: a request failed")
    return {"out": out, "wall": wall, "launches": launches,
            "calls": getattr(b, attr) - calls0,
            "ledgers": b.ledger_accum.recent()[seen:],
            "t0_wall": t0_wall, "submitted": submitted,
            "last_cb": max(ends) - t0_wall}


def report_lane(lane: str, r: dict, n: int, nbytes: int, kernel: str,
                b, ledger) -> None:
    """One line per lane pass: requests, calls, host-to-host rate,
    launches, the overlap figures and where group wall time went."""
    leds = r["ledgers"]
    ov = ledger.overlap_stats(leds)
    phases = {}
    for led in leds:
        for name, dt in ledger.charge_phases(led):
            phases[name] = phases.get(name, 0.0) + dt
    # one host clock: submits, then the window and batch forming until
    # the first group stages, the staged groups (ledger), then the
    # per-shard gathers and callbacks after the last group delivers
    first = min(led["stage_acquire"] for led in leds) - r["t0_wall"]
    last = max(led["deliver"] for led in leds) - r["t0_wall"]
    print(f"batcher {lane}: {n} requests in {r['calls']} calls "
          f"(group_stripes_hwm {b.group_stripes_hwm}), {nbytes / 2**30:.3f}"
          f" GiB in {r['wall']:.4f} s host to host = "
          f"{nbytes / 2**30 / r['wall']:.3f} GiB/s, {kernel} launches "
          f"{r['launches'][kernel]}; ms from the first submit: submits "
          f"done {r['submitted'] * 1e3:.1f}, first group staging "
          f"{first * 1e3:.1f}, last group delivered {last * 1e3:.1f}, "
          f"last callback {r['last_cb'] * 1e3:.1f}; overlap: "
          f"{ov['groups']} groups, {ov['pairs']} pairs, "
          f"pipeline_overlap_frac {ov['pipeline_overlap_frac']}; group "
          f"phase ms: "
          + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in phases.items()))


def batcher_path(torch, np, registry, ecutil, counts) -> dict:
    """Drive one OSD's EncodeBatcher, built from default_config() as an
    OSD builds it, with its encode, decode, delta and packet lanes at
    full width from BATCH_THREADS submitting threads; every result is
    held to the batcher's own CPU twin (jerasure, native GF kernels)
    byte for byte.  Returns the launches and the batcher, still running:
    the store phase checksums through its backend."""
    from ceph_tpu_torch.osd.batcher import EncodeBatcher
    from ceph_tpu_torch.utils import device_ledger as ledger
    from ceph_tpu_torch.utils.config import default_config
    from ceph_tpu_torch.utils.flight_recorder import FlightRecorder
    from ceph_tpu_torch.utils.perf import PerfCountersCollection

    print(f"batcher phase on {card()} (nvidia-smi name, power limit)")
    conf = default_config()
    for name, value in (("ec_tpu_batch_stripes", BATCH_STRIPES),
                        ("ec_tpu_queue_window_us", BATCH_WINDOW_US),
                        ("ec_tpu_fallback_cpu", False),
                        ("osd_ec_prewarm", True)):
        conf.set(name, value)
    EncodeBatcher.reset_learning()
    coll = PerfCountersCollection()
    b = EncodeBatcher(conf, perf_coll=coll,
                      recorder=FlightRecorder(capacity=256, name="osd.0"))
    launches = {}
    try:
        codec = registry.instance().factory(
            "gpu", {"k": str(K), "m": str(M), "technique": "reed_sol_van",
                    "device": DEV})
        sinfo = ecutil.StripeInfo(K, K * CHUNK)
        t0 = time.monotonic()
        warm = b.prewarm(codec, sinfo)
        if warm is None:
            raise AssertionError("prewarm started nothing")
        warm.join()
        nwarm = len({BATCH_STRIPES, BATCH_STRIPES // 2})
        if b.prewarm_error is not None or b.compile_count != nwarm:
            raise AssertionError(
                f"prewarm: {b.compile_count} of {nwarm} warm dispatches, "
                f"error {b.prewarm_error!r}")
        if EncodeBatcher._h2d_bps <= 0:
            raise AssertionError("prewarm did not seed the h2d EWMA")
        twin = b.cpu_twin(codec, sinfo)
        print(f"batcher prewarm: {b.compile_count} warm dispatches, "
              f"{time.monotonic() - t0:.4f} s, h2d seed "
              f"{EncodeBatcher._h2d_bps / 1e9:.3f} GB/s; CPU twin on "
              f"{type(twin.base.core.backend).__name__}")
        gen = torch.Generator(device=DEV).manual_seed(SEED + 4)

        def rand(*shape):
            return torch.randint(0, 256, shape, dtype=torch.uint8,
                                 device=DEV, generator=gen).cpu().numpy()

        nst = BATCH_OPS * OBJ_STRIPES
        objs = rand(BATCH_OPS, OBJ_STRIPES * K * CHUNK)
        stripes = objs.reshape(nst, K, CHUNK)
        parity = twin.encode_batch(stripes)

        def rows(i):
            return slice(i * OBJ_STRIPES, (i + 1) * OBJ_STRIPES)

        def check(lane, i, got, want):
            for s, arr in want.items():
                if not np.array_equal(np.frombuffer(got[s], np.uint8),
                                      arr.reshape(-1)):
                    raise AssertionError(f"batcher {lane} lane: op {i} "
                                         f"shard {s} != CPU twin")

        def want_chunks(i):
            p = parity[rows(i)]
            return {s: (np.ascontiguousarray(stripes[rows(i), s])
                        if s < K else p[:, s - K]) for s in range(K + M)}

        # encode: two passes of 128 writes of 4 MiB
        for npass in (1, 2):
            r = run_lane(b, lambda i, cb: b.submit(codec, sinfo, objs[i],
                                                   cb),
                         BATCH_OPS, counts, "encode")
            for i, got in enumerate(r["out"]):
                check("encode", i, got, want_chunks(i))
            launches[f"batcher_encode_{npass}"] = r["launches"]
            report_lane(f"encode pass {npass}", r, BATCH_OPS, objs.nbytes,
                        "B1", b, ledger)
            if r["calls"] >= BATCH_OPS:
                raise AssertionError("batcher encode lane did not coalesce")
        encoded = r["out"]
        # a burst of twice as many writes: groups of up to 512 stripes
        # with two in flight (ec_tpu_inflight_groups), the case the
        # overlap figures describe
        r = run_lane(b, lambda i, cb: b.submit(
            codec, sinfo, objs[i % BATCH_OPS], cb),
            2 * BATCH_OPS, counts, "encode")
        for i, got in enumerate(r["out"]):
            check("encode", i, got, want_chunks(i % BATCH_OPS))
        launches["batcher_encode_burst"] = r["launches"]
        report_lane("encode burst", r, 2 * BATCH_OPS, 2 * objs.nbytes,
                    "B1", b, ledger)

        # decode: 128 degraded reads, shards ERASED lost
        r = run_lane(b, lambda i, cb: b.submit_decode(
            codec, sinfo, {s: c for s, c in encoded[i].items()
                           if s not in ERASED}, set(ERASED), cb),
            BATCH_OPS, counts, "decode")
        for i, got in enumerate(r["out"]):
            want = want_chunks(i)
            check("decode", i, got, {e: want[e] for e in ERASED})
        launches["batcher_decode"] = r["launches"]
        report_lane("decode", r, BATCH_OPS,
                    nst * CHUNK * (K + M - len(ERASED)), "B1", b, ledger)
        if r["calls"] >= BATCH_OPS:
            raise AssertionError("batcher decode lane did not coalesce")

        # delta: 128 overwrites of columns DIRTY over 4 stripes each
        deltas = rand(nst, len(DIRTY), CHUNK)
        dpar = twin.core.delta_parity(deltas, DIRTY)
        r = run_lane(b, lambda i, cb: b.submit_delta(
            codec, sinfo, deltas[rows(i)], DIRTY, cb),
            BATCH_OPS, counts, "delta")
        for i, got in enumerate(r["out"]):
            check("delta", i, got, {K + j: dpar[rows(i), j]
                                    for j in range(M)})
        launches["batcher_delta"] = r["launches"]
        report_lane("delta", r, BATCH_OPS, deltas.nbytes, "B1", b, ledger)
        if r["calls"] >= BATCH_OPS:
            raise AssertionError("batcher delta lane did not coalesce")

        # packet codes: cauchy_good k=10 m=4, 4 MiB one-stripe writes
        pcodec = registry.instance().factory(
            "gpu", {"k": str(PK), "m": str(PM), "technique": "cauchy_good",
                    "device": DEV})
        psinfo = ecutil.StripeInfo(PK, PK * PCHUNK)
        pobjs = rand(PKT_OPS, PK * PCHUNK)
        ppar = b.cpu_twin(pcodec, psinfo).encode_batch(
            pobjs.reshape(PKT_OPS, PK, PCHUNK))
        r = run_lane(b, lambda i, cb: b.submit(pcodec, psinfo, pobjs[i],
                                               cb),
                     PKT_OPS, counts, "packet")
        for i, got in enumerate(r["out"]):
            stripe = pobjs[i].reshape(PK, PCHUNK)
            check("packet", i, got, {s: (stripe[s] if s < PK else
                                         ppar[i, s - PK])
                                     for s in range(PK + PM)})
        launches["batcher_packet"] = r["launches"]
        report_lane("packet (cauchy_good k=10 m=4, packetsize 2048)", r,
                    PKT_OPS, pobjs.nbytes, "B2", b, ledger)
        if r["calls"] >= PKT_OPS:
            raise AssertionError("batcher packet lane did not coalesce")

        if b.group_stripes_hwm <= OBJ_STRIPES:
            raise AssertionError(f"group_stripes_hwm {b.group_stripes_hwm}")
        faults = {"cpu_reqs": b.cpu_reqs, "dec_cpu_reqs": b.dec_cpu_reqs,
                  "delta_cpu_reqs": b.delta_cpu_reqs,
                  "device_errors": b.device_errors,
                  "breaker_opens": EncodeBatcher._breaker_opens}
        if any(faults.values()):
            raise AssertionError(f"batcher twin routes or device faults: "
                                 f"{faults}")
        routes = {k: v for k, v in coll.perf_dump()["ec_device"].items()
                  if "route_" in k and v}
        print(f"batcher: {faults}, route verdicts {routes}, "
              f"h2d EWMA {EncodeBatcher._h2d_bps / 1e9:.3f} GB/s")
    except BaseException:
        b.stop()
        raise
    return launches, b


def write_objects(store, objs, names) -> float:
    """Write each object as one transaction from BATCH_THREADS threads,
    as PG workers queue to one OSD's store, then flush; returns the
    wall seconds from the first write to the end of the flush."""
    from ceph_tpu_torch.store import GHObject, Transaction
    t0 = time.monotonic()
    fan_out(lambda i: store.queue_transactions([Transaction().write(
        STORE_COLL, GHObject(names[i], 0), 0, objs[i])]), len(objs),
        BATCH_THREADS)
    store.flush()
    return time.monotonic() - t0


def store_path(torch, np, backend_fn, counts) -> dict:
    """Drive a RAM BlueStore with its defaults, its checksums wired to
    the batcher's backend as an OSD wires them: STORE_OBJS writes of
    4 MiB from BATCH_THREADS threads.  Every object reads back
    byte-equal (each block's CRC verified on read), every block's CRC
    equals the host crc32c, every checksum batch of more than one block
    ran on the card, and no fallback is counted.  Then the same writes
    into a BlueStore with no backend attached: the host loop."""
    from ceph_tpu_torch.ops import crclinear
    from ceph_tpu_torch.store import BlueStore, GHObject, Transaction
    from ceph_tpu_torch.store.blockstore import BLOCK, _Extents
    from ceph_tpu_torch.utils.crc import crc32c

    print(f"store phase on {card()} (nvidia-smi name, power limit)")
    if not getattr(backend_fn(), "is_cuda", False):
        raise AssertionError(f"store: the batcher's backend "
                             f"{backend_fn()!r} is not on the card")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    objs = torch.randint(0, 256, (STORE_OBJS, 4 << 20), dtype=torch.uint8,
                         device=DEV, generator=gen).cpu().numpy()
    blobs = [o.tobytes() for o in objs]
    names = [f"rbd_data.{i:016x}" for i in range(STORE_OBJS)]
    nbytes = objs.nbytes
    lin = crclinear.shared()
    out = {}
    for route in ("device", "host"):
        store = BlueStore()
        store.mkfs()
        store.mount()
        try:
            store.queue_transactions([Transaction().create_collection(
                STORE_COLL)])
            if route == "device":
                store.attach_device_batcher(backend_fn)
            sizes = []
            fold = store._crc_batch

            def crc_batch(blocks, _fold=fold, _sizes=sizes):
                _sizes.append(len(blocks))
                return _fold(blocks)
            store._crc_batch = crc_batch
            fallbacks = lin.host_fallbacks
            counts.reset()
            wall = write_objects(store, blobs, names)
            launches = counts.read()
            csum = store.usage()["csum"]
            multi = sum(1 for n in sizes if n > 1)
            for i in range(STORE_OBJS):
                if store.read(STORE_COLL, GHObject(names[i], 0)) != blobs[i]:
                    raise AssertionError(f"store {route}: object {i} "
                                         f"reads back wrong")
            nblk = 0
            index = {name: i for i, name in enumerate(names)}
            for key, raw in store._db.iterate(f"X/{STORE_COLL}/"):
                i = index[_unkey(key)[0]]
                crcs = _Extents.load(raw).crcs
                for lb, c in enumerate(crcs):
                    if c != crc32c(blobs[i][lb * BLOCK:(lb + 1) * BLOCK]):
                        raise AssertionError(f"store {route}: object {i} "
                                             f"block {lb} CRC != crc32c")
                nblk += len(crcs)
            if nblk != nbytes // BLOCK or csum["blocks"] != nblk:
                raise AssertionError(f"store {route}: {nblk} blocks "
                                     f"checked, {csum['blocks']} summed")
            if route == "device":
                if (csum["device_batches"] != multi or multi < 1
                        or launches["B1"] != multi):
                    raise AssertionError(
                        f"store: {csum['device_batches']} device batches "
                        f"and {launches['B1']} B1 launches for {multi} "
                        f"batches of more than one block")
                if csum["device_errors"] or lin.host_fallbacks != fallbacks:
                    raise AssertionError(
                        f"store: {csum['device_errors']} device errors "
                        f"({store.csum_last_error!r}), "
                        f"{lin.host_fallbacks - fallbacks} crclinear host "
                        f"fallbacks ({lin.last_error!r})")
                out["launches"] = launches
            elif launches["B1"] or csum["device_batches"]:
                raise AssertionError("store with no backend used the card")
            phases = store.dump_store()["phase_seconds"]
            top = sorted(phases.items(), key=lambda kv: -kv[1])[:4]
            out[route] = {"wall": wall, "batches": csum["batches"],
                          "sizes": sizes}
            print(f"store ({route} checksums): {STORE_OBJS} writes of 4 MiB "
                  f"from {BATCH_THREADS} threads, {nblk} blocks in "
                  f"{csum['batches']} checksum batches ({multi} of more "
                  f"than one block, {max(sizes)} blocks the largest), "
                  f"{csum['device_batches']} on the card, B1 launches "
                  f"{launches['B1']}, {wall:.4f} s host to host = "
                  f"{nbytes / 2**30 / wall:.3f} GiB/s; store ledger top "
                  f"phases, s summed over txns: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in top))
        finally:
            store.umount()
    out["object"] = objs[0]
    return out


def _unkey(key: str) -> tuple:
    """(oid, shard) of an extent-map key X/<coll>/<hex oid>_<shard>."""
    hexoid, shard = key.rsplit("/", 1)[1].rsplit("_", 1)
    return bytes.fromhex(hexoid).decode(), int(shard)


def scrub_bands(cm, s: int) -> tuple:
    """Shard s's syndrome scales (one per parity row) and the bands of
    its deep-scrub window, (1,) + its distinct nonzero scales, as the
    JAX package's osd/ecbackend.py builds them."""
    if s < K:
        scales = [int(cm[e][s]) for e in range(M)]
    else:
        scales = [1 if e == s - K else 0 for e in range(M)]
    nz = sorted({x for x in scales if x})
    return scales, nz, (1,) + tuple(nz)


def scrub_path(torch, np, registry, engine_mod, counts) -> dict:
    """A deep-scrub-shaped window on the card: SCRUB_STRIPES k=8 m=4
    stripes encoded through the `gpu` plugin, each shard's window of
    SCRUB_STRIPES chunks through crclinear with its syndrome bands on
    the plugin's backend (B1 in row groups), equal to the plain CPU
    route; data CRCs equal crc32c, the syndrome partials XOR to zero
    across the shards, and not after one flipped byte."""
    from ceph_tpu_torch.ops import crclinear
    from ceph_tpu_torch.ops.torch_engine import TorchBackend
    from ceph_tpu_torch.utils.crc import crc32c

    codec = registry.instance().factory(
        "gpu", {"k": str(K), "m": str(M), "technique": "reed_sol_van",
                "device": DEV})
    backend, cpu = codec.core.backend, TorchBackend("cpu")
    cm = codec.core.coding_matrix
    gen = torch.Generator(device=DEV).manual_seed(SEED + 6)
    data = torch.randint(0, 256, (SCRUB_STRIPES, K, CHUNK),
                         dtype=torch.uint8, device=DEV,
                         generator=gen).cpu().numpy()
    parity = codec.encode_batch_async(data).wait()
    shards = [np.ascontiguousarray(data[:, s]) for s in range(K)]
    shards += [np.ascontiguousarray(parity[:, e]) for e in range(M)]
    lin = crclinear.shared()
    fallbacks = lin.host_fallbacks
    zero = np.uint32(lin.zero_crc(CHUNK))

    def partials(parts, scales, nz):
        return [parts[1 + nz.index(sc)] if sc else
                np.zeros(SCRUB_STRIPES, np.uint32) for sc in scales]

    counts.reset()
    t0 = time.monotonic()
    got = [lin._apply_window(shards[s], scrub_bands(cm, s)[2], backend)
           for s in range(K + M)]
    secs = time.monotonic() - t0
    launches = counts.read()
    want_launches = sum(len(scrub_bands(cm, s)[2]) for s in range(K + M))
    if launches["B1"] != want_launches or lin.host_fallbacks != fallbacks:
        raise AssertionError(
            f"scrub: {launches['B1']} B1 launches for {want_launches} row "
            f"groups, {lin.host_fallbacks - fallbacks} host fallbacks "
            f"({lin.last_error!r})")
    syn = np.zeros((M, SCRUB_STRIPES), dtype=np.uint32)
    for s in range(K + M):
        scales, nz, bands = scrub_bands(cm, s)
        plain = lin._apply_window(shards[s], bands, cpu)
        if not np.array_equal(got[s], plain):
            raise AssertionError(f"scrub: shard {s} partials != CPU route")
        if [int(c) for c in got[s][0] ^ zero] != [
                crc32c(c) for c in shards[s]]:
            raise AssertionError(f"scrub: shard {s} data CRCs != crc32c")
        syn ^= np.stack(partials(got[s], scales, nz))
    if syn.any():
        raise AssertionError("scrub: syndrome partials do not cancel on "
                             "a clean codeword")
    s_bad, stripe_bad = 3, 5
    bad = shards[s_bad].copy()
    bad[stripe_bad, 1000] ^= 0x5A
    scales, nz, bands = scrub_bands(cm, s_bad)
    syn ^= np.stack(partials(got[s_bad], scales, nz))
    syn ^= np.stack(partials(lin._apply_window(bad, bands, backend),
                             scales, nz))
    hit = sorted(set(np.nonzero(syn)[1].tolist()))
    if hit != [stripe_bad] or lin.host_fallbacks != fallbacks:
        raise AssertionError(f"scrub: a flipped byte in stripe "
                             f"{stripe_bad} shows in stripes {hit}")
    sizes = [tuple(lin.block_bitmatrix(scrub_bands(cm, s)[2]).shape)
             for s in range(K + M)]
    print(f"scrub window: {K + M} shards of {SCRUB_STRIPES} x {CHUNK} B "
          f"({SCRUB_STRIPES * CHUNK >> 20} MiB a shard), bitmatrices "
          f"{sorted(set(sizes), reverse=True)}, B1 launches "
          f"{launches['B1']} (one a row group) in {secs:.4f} s host to "
          f"host; every shard equal to the CPU route, data CRCs equal "
          f"crc32c, syndromes cancel, a flipped byte in shard {s_bad} "
          f"stripe {stripe_bad} shows in stripe {hit}")
    big = max(range(K + M), key=lambda s: len(scrub_bands(cm, s)[2]))
    return {"launches": launches, "shard": shards[big],
            "bands": scrub_bands(cm, big)[2], "backend": backend}


# phase -> the kernel its path must launch
PHASE_KERNEL = {"encode": "B1", "decode": "B1", "delta": "B1",
                "ecutil": "B1", "pkt_encode": "B2",
                "pkt_decode_device": "B2", "pkt_decode": "B2",
                "pkt_ecutil": "B2", "ragged_encode": "B3",
                "ragged_decode": "B3", "corpus": "B2",
                "batcher_encode_1": "B1", "batcher_encode_2": "B1",
                "batcher_encode_burst": "B1",
                "batcher_decode": "B1", "batcher_delta": "B1",
                "batcher_packet": "B2", "store": "B1", "scrub": "B1"}
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
        bat, batcher = batcher_path(torch, np, registry, ecutil, counts)
        try:
            store = store_path(torch, np, lambda: batcher._last_backend,
                               counts)
        finally:
            batcher.stop()
        scrub = scrub_path(torch, np, registry, engine, counts)
        launches = {**run["launches"], **pkt["launches"], **bat,
                    "store": store["launches"], "scrub": scrub["launches"]}
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
                             info["d1"], 2048),
            "B3": measure_b3(torch, packet_xor_kernel, carry, torch_engine,
                             info["ragged_bitmatrix"], info["d3"], 1000)}
        # each packet kernel at the other's shape too (both take any
        # packet size): evidence for the packetsize % 128 routing rule
        cross = {
            "B2": measure_b2(torch, packet_kernel, carry,
                             info["ragged_bitmatrix"], info["d3"], 1000),
            "B3": measure_b3(torch, packet_xor_kernel, carry, torch_engine,
                             info["bitmatrix"], info["d1"], 2048)}
        crc = measure_crc(torch, np, gf8_kernel, carry, torch_engine,
                          store["object"], scrub)
        for name, me in [*meas.items(), *cross.items(),
                         *((f"B1 {k}", v) for k, v in crc.items()
                           if k != "staged")]:
            if me["max_abs_err"] != 0:
                raise AssertionError(f"{name} != plain at its timed shape")
        regs = {"B1": gf8_kernel.regs(), "B2": packet_kernel.regs(),
                "B3": packet_xor_kernel.regs()}
        sass = gf8_kernel.sass_opcodes()
    except Exception as e:  # every phase failure ends the run non-zero
        import traceback
        traceback.print_exc()
        return fail(f"{type(e).__name__}: {e}")

    print(f"nvidia-smi: {card()}")
    line = []
    for key, me in meas.items():
        name, source, replaces, shape = KERNELS[key]
        print(f"{key} at {shape}: median {me['ms']:.4f} ms of "
              f"{len(me['runs_ms'])} runs ({me['bytes'] / me['ms'] / 1e6:.1f}"
              f" GB/s moved), bound {me['bound_ms']:.4f} ms "
              f"({me['bound_by']}, {me['bound_ms'] / me['ms']:.1%} of it "
              f"reached), plain {me['plain_ms']:.4f} ms, library call: none")
        line.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(n[key] for n in launches.values()),
            "max_abs_err": me["max_abs_err"], "ms": me["ms"],
            "plain_ms": me["plain_ms"], "bound_ms": me["bound_ms"],
            "bound_by": me["bound_by"], "library_ms": None})
    for key, me in cross.items():
        ps = 1000 if key == "B2" else 2048
        print(f"{key} at packetsize {ps} (the other kernel's shape): median "
              f"{me['ms']:.4f} ms, bound {me['bound_ms']:.4f} ms "
              f"({me['bound_ms'] / me['ms']:.1%} of it reached), plain "
              f"{me['plain_ms']:.4f} ms")
    for name in ("store", "scrub_group", "scrub_window"):
        me = crc[name]
        (din, dout), groups = me["shape"], me.get("groups", 1)
        print(f"B1 at crclinear's {name} shape {list(din)} -> {list(dout)}"
              f" ({groups} launch{'es' if groups > 1 else ''}): median "
              f"{me['ms']:.4f} ms of {len(me['runs_ms'])} runs, bound "
              f"{me['bound_ms']:.6f} ms ({me['bound_by']}, "
              f"{me['bound_ms'] / me['ms']:.1%} of it reached), plain "
              f"{me['plain_ms']:.4f} ms")
    st = crc["staged"]
    print(f"store checksum window host to host through the backend: staged "
          f"at its own length {st['own']['bytes']} bytes, "
          f"{st['own']['ms']:.4f} ms; padded as before "
          f"{st['padded']['bytes']} bytes, {st['padded']['ms']:.4f} ms "
          f"(median of 5)")
    for key in ("B1", "B2", "B3"):
        (nregs, local), me = regs[key], meas[key]
        tile = f" (tile {me['tile']} bytes)" if "tile" in me else ""
        print(f"{key} block: {nregs} registers and {local} bytes of local "
              f"memory a thread, {me['smem']} bytes of shared memory"
              f"{tile} at its timed shape")
    if sass is None:
        print("B1 SASS opcodes: not counted (no cuobjdump)")
    else:
        ops = ("PRMT", "LOP3", "SHF", "IADD3", "IMAD", "LDS", "LDG", "STG")
        for part, what in (("loop", "hottest loop, a pair of chunks"),
                           ("all", "whole kernel")):
            n = sass[part]
            print(f"B1 SASS opcodes, 16-byte kernel, {what}: " + ", ".join(
                f"{op} {n.get(op, 0)}" for op in ops)
                + f", all {sum(n.values())}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
