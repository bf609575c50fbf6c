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
  4b. drive the other plugins through the registry: LRC k=4 m=2 l=3 over
     `gpu` (BASELINE config 4) at the JAX package's bench_lrc shape, two
     batches of 96 objects of 1 MiB on the card, encode_batch_device
     byte-equal to the inner=jerasure host walk, its GiB/s at the codec
     boundary (CUDA events) against that walk's, one B1 launch a layer,
     and a loss in a local group and a double loss that needs the global
     layer decoded; CLAY k=4 m=2 d=5 with scalar_mds=gpu on 32 objects
     of 4 MiB: encode, every loss of one and two chunks of one object,
     and the repair of each lost chunk from its helpers' repair
     sub-chunks, all byte-equal to scalar_mds=jerasure; the corpus
     vectors of lrc and clay on the card, of shec and isa on the host;
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
  5b. the faults phase, in a child process (``--faults-child``, output in
     chiprun_out/faults.log): a batcher as in phase 5 with every device
     dispatch failing through its encode, decode and delta lanes (each
     from a closed breaker, so each lane's dispatch site trips), every
     op byte-equal to jerasure and the breaker open; in each lane one
     completion fault that abandons a live handle, the probe that
     readmits the card, and a clean pass on B1; the JAX package's seeded
     chaos smoke
     on a 3-OSD cluster; the staging ring idle after the drain;
  6. drive the store (ceph_tpu_torch/store/bluestore.py): one RAM
     BlueStore with its defaults, wired to the batcher of phase 5 as an
     OSD wires it (attach_device_batcher), takes 64 writes of 4 MiB from
     8 threads; each write's checksum batch (1024 blocks of 4 KiB) is one
     crclinear window on B1; every object reads back byte-equal, every
     block's CRC equals the host crc32c, every batch of more than one
     block ran on the card, and no fallback is counted; the same writes
     into a BlueStore with no backend (the host loop) for comparison;
  7. drive the erasure-coded PG backend (ceph_tpu_torch/osd/ecbackend.py)
     for one PG of a k=8 m=4 pool with the 4 KiB stripe unit, its 12
     shards placed on 12 of 13 OSDs by the port's OSDMap (an `indep`
     erasure rule), one in-process host and MemStore a shard, every
     sub-op through the port's frame codec, the primary's EncodeBatcher
     built as in phase 5: 64 writes of 4 MiB from 8 threads (two
     segments each, encode lane), read back; 64 overwrites of two 4 KiB
     columns of one stripe (delta lane, no fallback); 64 degraded reads
     with shards (1, 5, 9, 11) down (decode lane); shard 3 wiped and
     recovered for every object (decode lane; rebuild MB/s); a deep
     scrub with syndromes on all 12 hosts through crclinear on B1
     (windows of 16 MiB, bitmatrices up to [160, 4096] in row groups;
     the first window of every host equal to the CPU route, data CRCs
     equal crc32c, syndromes cancel and show a flipped byte in its
     object alone); and 16 writes of 4 MiB to a cauchy_good k=10 m=4
     pool (B2); then an LRC k=4 m=2 l=3 PG (inner=gpu, 8 shards, 4 KiB
     stripe unit) and a CLAY k=4 m=2 PG (scalar_mds=gpu, 6 shards, 1 MiB
     stripe unit): 32 writes of 4 MiB each, read back, degraded reads
     with shard 1 down, one shard recovered for every object (LRC from
     the 3 others of its local group, CLAY by sub-chunk repair reading
     under 0.8 of whole chunks), a deep scrub.  Every shard equals the
     host encode of the jerasure plugin (or of the same LRC or CLAY code
     over it); any twin route, device error or counted host fallback
     fails the phase;
  7b. drive the port's tools (ceph_tpu_torch/tools) through the entry
     points a user runs: ec_benchmark's main(argv) at k=8 m=4
     reed_sol_van encode and 4-erasure decode of 64 MiB (B1) and
     cauchy_good k=10 m=4 encode at packetsize 2048 (B2) and 1000 (B3),
     each `seconds\tKiB` line printed with bench.sh's GB/s, and the
     tool's payload encoded through `gpu` equal to jerasure's; the
     corpus check (ec_non_regression --check, 9 configs, the `gpu` entry
     reading tpu_k=8_m=4); ec_tool encode and decode of a 16 MiB file
     with 4 chunks deleted; bench_sweep of the `gpu` plugin, 12 rows;
     then `python -m ceph_tpu_torch.tools.vstart -n 3 --ec-pool --mgr
     --rgw` in its own process (output in chiprun_out/vstart.log),
     driven over TCP by the ceph, rados, rbd and cephfs CLIs' main(argv)
     (put/get of 16 objects of 4 MiB on its `gpu` k=2 m=1 pool, rados
     bench write and seq, rbd import/snapshot/clone/export on a
     replicated pool, cephfs put/get with data on the EC pool), its OSDs'
     perf dumps showing encode calls and no twin route or device error,
     and its exit 0 on SIGTERM;
  8. drive the port's daemons (ceph_tpu_torch/cluster.py), twice: the k=8
     m=4 shapes warmed on the shared backend first, then a mon, 13 OSDs
     on RAM BlueStores and a client over the loopback-TCP messenger,
     with the JAX package's 13-OSD settings (heartbeat 2 s, grace
     max(20 s, 12 x machine factor), down->out after 60 s, a 3 ms
     batcher window) and a `gpu` k=8 m=4 pool of 32 PGs (4 KiB stripe
     unit, allow_ec_overwrites).  First with the OSDs of the config
     default, crimson (ceph_tpu_torch/crimson: reactor threads run the
     messenger, the PGs and BlueStore's apply), on 128 objects; then
     with classic OSDs on 32.  Steps: writes of 4 MiB from one deep aio
     queue, read back; overwrites of 8 KiB on two data columns of one
     stripe (all on the delta lane), read back; osd.12 killed with its
     data and degraded reads; its rebuild to clean (rebuild MB/s), every
     object read back and every shard, read from the store of the OSD
     its acting set names, equal to the jerasure encode; a deep scrub of
     every PG through the monitor; 8 writes of 4 MiB to a cauchy_good
     k=8 m=4 pool at packetsize 2048 (B2), read back, every shard equal
     to jerasure's.  The crimson cluster also runs the manager
     (Cluster(with_mgr=True), the reference's vstart layout): its seven
     modules must be active and `mgr module ls` must answer; after the
     writes, with no client I/O, its prometheus scrape over HTTP must
     hold as many batcher encode calls as the OSDs' own perf dumps, with
     the ec_device and ec_device_ledger families; after the rebuild the
     tuner module's decisions are printed; after the deep scrub 8
     entities of 16 MiB go through the striper (StripedIoCtx, the
     default Layout()) to the k=8 m=4 pool (B1), are read back, get
     5,000 bytes at offset 70,000 overwritten on the delta lane and are
     read back again, and every shard of the first entity's first two
     objects must equal the jerasure encode; then lock, version and
     fence class calls from two clients on a replicated pool of size 3,
     and one on the EC pool, must give the reference's errno values.
     Each step prints its host-to-host seconds, its
     launches, the batchers' calls against requests, the process's CPU
     seconds by thread family and its live threads; on crimson also the
     reactors' loop-lag high-water mark and how long each BlueStore
     apply task held its reactor.  BlueStore's checksum batches on the
     card and on the host loop are printed per OSD, and every primary
     of a written PG must have checksummed on the card; any twin route,
     device error, open breaker or counted host fallback fails the
     phase;
  9. fail unless every phase launched the kernel of its path: B1 on the
     byte-code phases, every step of the plugins phase on the card, the
     batcher's encode, decode and delta lanes, the store, the
     ECBackend's writes, overwrites, degraded reads, recovery and scrub,
     the LRC and CLAY PGs' writes, degraded reads and recoveries, the
     tools phase's ec_benchmark k=8 m=4 runs, corpus, ec_tool and sweep,
     and every step of both cluster phases and the crimson striper step,
     the faults child's probes and clean pass,
     B2 on the packetsize-2048 phases (the tools phase's too), the corpus, the batcher's packet lane, the ECBackend's
     cauchy_good pool and the clusters' cauchy_good pools, B3 on the
     packetsize-1000 phases;
 10. time each kernel (median of CUDA-event-timed launches) beside its
     bound and its plain version at the shapes of its path, and B2 and B3
     each at the other's shape too, B1 also at the store's shape and
     at the ECBackend's own deep-scrub window, at LRC's global and local
     layers and at CLAY's plane code and pairwise transform; print each
     one's share of its bound, the registers, local and shared memory
     each kernel's block uses, and the static SASS opcode counts of B1's
     main-path kernel.
Before the last line it prints the card's name and power limit and a
`kernels` JSON line; the last line is the JSON result.  With no CUDA
device, or outside the repo, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import signal
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
STORE_OBJS = 64            # 256 MiB of 4 KiB blocks
STORE_COLL = "1.0s0"
# ecbackend phase: one PG of a k=8 m=4 pool with the 4 KiB stripe unit
# (osd_pool_erasure_code_stripe_unit), 4 MiB objects (RBD/RGW), acting
# set from the OSDMap of 13 OSDs; and a cauchy_good k=10 m=4 pool whose
# 64 KiB stripe unit is the smallest the plugin aligns at packetsize 2048
ECB_OSDS = 13
ECB_PG_NUM = 256
ECB_STRIPE_UNIT = 4096
ECB_OBJ_BYTES = 4 << 20
ECB_OBJS = 64              # 256 MiB of objects
ECB_THREADS = 8
DELTA_COL = 2              # overwrites of columns (2, 3) of one stripe
LOST = 3                   # the shard wiped and recovered
PKT_STRIPE_UNIT = 64 << 10
PKT_ECB_OPS = 16
PKT_ECB_THREADS = 4

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
        decoded, tried = check_corpus(registry, name)
        if decoded != tried:
            raise AssertionError(f"corpus {name}: {decoded} of {tried} "
                                 f"losses decoded")
    launches["corpus"] = counts.read()
    print(f"corpus: {', '.join(CORPUS)}: encode equal, every 1- and "
          f"2-erasure decode equal")
    info.update(d1=d1, d3=d3, bitmatrix=core.bitmatrix,
                ragged_bitmatrix=rcore.bitmatrix)
    return {"launches": launches, "info": info}


def check_corpus(registry, name: str, plugin: str = "gpu",
                 extra=None) -> tuple:
    """One committed corpus vector through ``plugin`` with ``extra`` in
    its profile (by default ``device`` on the card): the encode equals
    the stored chunks, and every loss of one or two chunks that
    minimum_to_decode admits decodes to them from the chunks it names
    (the JAX package's sweep, tools/ec_non_regression.py).  Returns the
    losses decoded and the losses tried."""
    import itertools
    from ceph_tpu_torch.tools import ec_non_regression
    d = os.path.join(HERE, "corpus", name)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    codec = registry.instance().factory(
        plugin, dict(manifest["profile"],
                     **({"device": DEV} if extra is None else extra)))
    n = manifest["chunk_count"]
    stored = {}
    for i in range(n):
        with open(os.path.join(d, f"chunk.{i}"), "rb") as f:
            stored[i] = f.read()
    payload = ec_non_regression.payload()
    if len(payload) != manifest["payload_size"]:
        raise AssertionError(f"corpus {name}: payload of {len(payload)} "
                             f"bytes, the manifest says "
                             f"{manifest['payload_size']}")
    fresh = codec.encode(set(range(n)), payload)
    if any(fresh[i] != stored[i] for i in range(n)):
        raise AssertionError(f"corpus {name}: encode != stored chunks")
    losses = [e for r in (1, 2) for e in itertools.combinations(range(n), r)]
    decoded = 0
    for erased in losses:
        try:
            need = codec.minimum_to_decode(set(erased),
                                           set(range(n)) - set(erased))
        except IOError:
            continue
        dec = codec.decode(set(erased), {i: stored[i] for i in need},
                           len(stored[0]))
        if any(dec[e] != stored[e] for e in erased):
            raise AssertionError(f"corpus {name}: decode of {erased}")
        decoded += 1
    return decoded, len(losses)


# plugins phase: BASELINE config 4 (plugin=lrc k=4 m=2 l=3 inner=gpu) at
# the JAX package's bench_lrc shape (bench.py), then CLAY with a gpu
# scalar code, then the corpus vectors of the other plugins
LRC_PROFILE = {"k": "4", "m": "2", "l": "3"}
LRC_OBJ_BYTES = 1 << 20    # bench_lrc's objects: 256 KiB chunks
LRC_BATCH = 96             # objects a batch
LRC_BUFS = 2               # batches resident on the card
LRC_CYCLES = 2             # passes over them, timed
CLAY_PROFILE = {"k": "4", "m": "2", "d": "5"}
CLAY_OBJS = 32             # objects of 4 MiB: 8 planes of 128 KiB a chunk
CLAY_OBJ_BYTES = 4 << 20
# corpus vector -> (plugin, profile keys added): lrc and clay on the
# card, shec and isa on the host (host codecs in both packages)
PLUGIN_CORPUS = {"lrc_layered": ("lrc", {"inner": "gpu", "device": DEV}),
                 "clay_k=4_m=2": ("clay", {"scalar_mds": "gpu",
                                           "device": DEV}),
                 "shec_c=2_k=4_m=3": ("shec", {}),
                 "isa_k=4_m=2": ("isa", {})}


def plugins_path(torch, np, registry, counts) -> dict:
    """The other codec plugins through the registry on the card.  LRC
    k=4 m=2 l=3 over `gpu` (BASELINE config 4) at bench_lrc's shape:
    LRC_BUFS batches of LRC_BATCH objects of 1 MiB resident on the card,
    encode_batch_device byte-equal to the inner=jerasure host walk for
    every object, its GiB/s at the codec boundary fenced by CUDA events
    against that walk's, one loss in a local group and a double loss
    that needs the global layer decoded; CLAY k=4 m=2 d=5 with
    scalar_mds=gpu on CLAY_OBJS objects of 4 MiB: every object encoded,
    every loss of one and two chunks of one object decoded and every
    single lost chunk repaired from its helpers' repair sub-chunks, all
    byte-equal to scalar_mds=jerasure on the host; then the corpus
    vectors of lrc and clay on the card and of shec and isa (host codecs
    in both packages) on the host.  Returns the launches of each step
    and the row sets and inputs of B1's new shapes."""
    import itertools
    print(f"plugins phase on {card()} (nvidia-smi name, power limit)")
    reg = registry.instance()
    launches, shapes = {}, {}

    # -- a. LRC over gpu
    lrc = reg.factory("lrc", dict(LRC_PROFILE, inner="gpu", device=DEV))
    host = reg.factory("lrc", dict(LRC_PROFILE))
    k, n = lrc.get_data_chunk_count(), lrc.get_chunk_count()
    L = lrc.get_chunk_size(LRC_OBJ_BYTES)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 20)
    bufs = [torch.randint(0, 256, (LRC_BATCH, k, L), dtype=torch.uint8,
                          device=DEV, generator=gen)
            for _ in range(LRC_BUFS)]
    host_s = 0.0
    for i, buf in enumerate(bufs):
        dev = lrc.encode_batch_device(buf).cpu().numpy()
        arr = buf.cpu().numpy()
        t0 = time.monotonic()
        want = host.encode_batch(arr)
        host_s += time.monotonic() - t0
        if not np.array_equal(dev, want):
            raise AssertionError(f"lrc: batch {i} device encode != the "
                                 f"inner=jerasure host walk")
    logical = LRC_BATCH * LRC_OBJ_BYTES
    torch.cuda.synchronize()
    counts.reset()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(LRC_CYCLES):
        for buf in bufs:
            lrc.encode_batch_device(buf)
    b.record()
    b.synchronize()
    launches["plugins_lrc_encode"] = counts.read()
    secs = a.elapsed_time(b) / 1e3
    passes = LRC_CYCLES * LRC_BUFS
    per_batch = launches["plugins_lrc_encode"]["B1"] / passes
    if per_batch != len(lrc.layers):
        raise AssertionError(f"lrc: {per_batch} B1 launches a batch, "
                             f"{len(lrc.layers)} layers")
    gibs = passes * logical / 2**30 / secs
    base = LRC_BUFS * logical / 2**30 / host_s
    print(f"lrc encode: plugin=lrc k=4 m=2 l=3 inner=gpu, {LRC_BUFS} "
          f"batches of {LRC_BATCH} objects of {LRC_OBJ_BYTES >> 20} MiB "
          f"on the card, every object byte-equal to the inner=jerasure "
          f"host walk; {passes} batch encodes in {secs:.6f} s (CUDA "
          f"events) = {gibs:.3f} GiB/s at the codec boundary; B1 "
          f"launches a batch {per_batch:g} (one a layer); baseline "
          f"inner=jerasure batched walk {base:.3f} GiB/s on the host "
          f"({gibs / base:.1f}x)")
    stacks = {}
    for layer in lrc.layers:
        lk = layer.erasure_code.get_data_chunk_count()
        if lk not in stacks:
            stacks[lk] = (layer.erasure_code.core.coding_matrix,
                          bufs[0][:, :lk].contiguous())
    shapes["lrc"] = stacks
    obj = bufs[0][0].cpu().numpy().tobytes()
    encoded = host.encode(set(range(n)), obj)
    if lrc.encode(set(range(n)), obj) != encoded:
        raise AssertionError("lrc: encode of one object != host")
    for lose, what in (((0,), "local"), ((0, 1), "global")):
        avail = {i: c for i, c in encoded.items() if i not in lose}
        counts.reset()
        t0 = time.monotonic()
        dec = lrc.decode(set(lose), avail)
        secs = time.monotonic() - t0
        launches[f"plugins_lrc_decode_{what}"] = counts.read()
        want = host.decode(set(lose), avail)
        if any(dec[e] != want[e] or dec[e] != encoded[e] for e in lose):
            raise AssertionError(f"lrc: decode of {lose} != host")
        print(f"lrc decode of chunks {lose} ({what} layer) of one object: "
              f"{secs:.4f} s host to host, B1 launches "
              f"{launches[f'plugins_lrc_decode_{what}']['B1']}, equal to "
              f"the inner=jerasure decode")
    del bufs

    # -- b. CLAY with scalar_mds=gpu
    clay = reg.factory("clay", dict(CLAY_PROFILE, scalar_mds="gpu",
                                    device=DEV))
    chost = reg.factory("clay", dict(CLAY_PROFILE))
    n = clay.get_chunk_count()
    objs = torch.randint(0, 256, (CLAY_OBJS, CLAY_OBJ_BYTES),
                         dtype=torch.uint8, device=DEV,
                         generator=gen).cpu().numpy()
    blobs = [o.tobytes() for o in objs]
    counts.reset()
    t0 = time.monotonic()
    encs = [clay.encode(set(range(n)), blob) for blob in blobs]
    secs = time.monotonic() - t0
    launches["plugins_clay_encode"] = counts.read()
    t0 = time.monotonic()
    hosts = [chost.encode(set(range(n)), blob) for blob in blobs]
    hsecs = time.monotonic() - t0
    if encs != hosts:
        raise AssertionError("clay: encode != scalar_mds=jerasure")
    cs = len(encs[0][0])
    sub = clay.get_sub_chunk_count()
    print(f"clay encode: plugin=clay k=4 m=2 d=5 scalar_mds=gpu, "
          f"{CLAY_OBJS} objects of {CLAY_OBJ_BYTES >> 20} MiB ({sub} "
          f"planes of {cs // sub} bytes a chunk) in {secs:.4f} s host to "
          f"host, B1 launches {launches['plugins_clay_encode']['B1']}; "
          f"scalar_mds=jerasure on the host {hsecs:.4f} s; every chunk "
          f"equal")
    encoded = encs[0]
    sigs = [e for r in (1, 2) for e in itertools.combinations(range(n), r)]
    counts.reset()
    t0 = time.monotonic()
    for erased in sigs:
        avail = {i: c for i, c in encoded.items() if i not in erased}
        dec = clay.decode(set(erased), avail, cs)
        if any(dec[e] != encoded[e] for e in erased):
            raise AssertionError(f"clay: decode of {erased}")
    secs = time.monotonic() - t0
    launches["plugins_clay_decode"] = counts.read()
    print(f"clay decode: all {len(sigs)} losses of one and two chunks of "
          f"one object in {secs:.4f} s host to host, B1 launches "
          f"{launches['plugins_clay_decode']['B1']}, each equal to the "
          f"host encode")
    sc = cs // sub
    counts.reset()
    t0 = time.monotonic()
    read = 0
    for lost in range(n):
        minimum = clay.minimum_to_decode({lost}, set(range(n)) - {lost})
        helpers = {i: b"".join(encoded[i][o * sc:(o + c) * sc]
                               for o, c in runs)
                   for i, runs in minimum.items()}
        read += sum(len(h) for h in helpers.values())
        out = clay.decode({lost}, helpers, cs)
        if out[lost] != encoded[lost]:
            raise AssertionError(f"clay: repair of chunk {lost}")
    secs = time.monotonic() - t0
    launches["plugins_clay_repair"] = counts.read()
    whole = n * clay.get_data_chunk_count() * cs
    if read * clay.q != n * clay.d * cs:
        raise AssertionError(f"clay: repairs read {read} bytes")
    print(f"clay repair: each of the {n} chunks of one object from "
          f"{clay.d} helpers' repair sub-chunks, {read} bytes read against "
          f"{whole} for whole chunks from k ({read / whole:.3f}), in "
          f"{secs:.4f} s host to host, B1 launches "
          f"{launches['plugins_clay_repair']['B1']}, each equal")
    mds, pft = clay.mds.core, clay.pft.core
    gen2 = torch.Generator(device=DEV).manual_seed(SEED + 21)
    shapes["clay"] = {
        "mds": (mds._recovery_rows(tuple(range(mds.k)),
                                   tuple(range(mds.k, mds.k + mds.m)))[0],
                torch.randint(0, 256, (1, mds.k, sc), dtype=torch.uint8,
                              device=DEV, generator=gen2)),
        "pft": (pft._recovery_rows((0, 1), (2, 3))[0],
                torch.randint(0, 256, (1, pft.k, sc), dtype=torch.uint8,
                              device=DEV, generator=gen2))}
    del objs, blobs, encs, hosts

    # -- c. the corpus vectors of the other plugins
    for name, (plugin, extra) in PLUGIN_CORPUS.items():
        counts.reset()
        n_dec, _ = check_corpus(registry, name, plugin, extra)
        got = counts.read()
        if extra:
            launches[f"plugins_corpus_{name.split('_')[0]}"] = got
        print(f"corpus {name}: encode and {n_dec} decodes equal to the "
              f"stored chunks "
              + (f"on the card, B1 launches {got['B1']}" if extra else
                 "on the host (a host codec in both packages)"))
    return {"launches": launches, "shapes": shapes}


def measure_rows(torch, gf8_kernel, carry, matrix, rows, data) -> dict:
    """B1 and its plain version for one GF(2^8) row set over ``data``
    [B, k, L] on the card."""
    import numpy as np
    rows = np.asarray(rows, dtype=np.int64)
    op = carry.carry_rows(rows, matrix.matrix_to_bitmatrix(rows, 8), DEV)
    B, k, L = data.shape
    m_out = rows.shape[0]
    out = torch.empty((B, m_out, L), dtype=torch.uint8, device=DEV)
    me = measure(
        torch, lambda: gf8_kernel.gf8_apply(op, data, out),
        lambda: gf8_kernel.gf8_apply_plain(op.bitmatrix, data), out,
        data.numel() + out.numel(), 2 * (8 * m_out) * (8 * k) * B * L,
        INT8_OPS)
    me["shape"] = [[B, k, L], [B, m_out, L]]
    return me


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
    4, 8]) and one row group of a data shard's window in the ECBackend's
    deep scrub (32 objects of 512 KiB: [32, 512, 1024] -> [32, 4,
    1024]); that whole window's split apply (one launch a
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


def pg_acting(k: int, m: int, n_osds: int, stripe_unit: int) -> list:
    """The acting set of PG 1.0 of a k+m erasure pool, from the port's
    OSDMap: n_osds OSDs, one host each (build_flat_map), and the `indep`
    erasure rule with a host failure domain that the monitor builds for
    an erasure pool.  Its k+m shards must land on distinct OSDs."""
    from ceph_tpu_torch.crush import build_flat_map
    from ceph_tpu_torch.osd.osdmap import Incremental, OSDMap, PGid, PGPool
    osdmap = OSDMap()
    crush = build_flat_map(n_osds)
    inc = Incremental(1)
    inc.new_crush = crush
    inc.new_max_osd = n_osds
    for o in range(n_osds):
        inc.new_up[o] = ("127.0.0.1", 6800 + o)
    rule = crush.add_simple_rule(f"ecrule_k{k}m{m}", "default", "host",
                                 mode="indep", pool_type="erasure")
    inc.new_pools[1] = PGPool(
        name=f"ec_k{k}m{m}", pool_id=1, type="erasure", size=k + m,
        min_size=k + (1 if m >= 2 else 0), pg_num=ECB_PG_NUM,
        crush_rule=rule, erasure_code_profile=f"k{k}m{m}",
        stripe_width=k * stripe_unit)
    osdmap.apply_incremental(inc)
    _up, _upp, acting, _ap = osdmap.pg_to_up_acting_osds(PGid(1, 0))
    if len(acting) != k + m or None in acting or \
            len(set(acting)) != k + m:
        raise AssertionError(f"PG 1.0 of k={k} m={m} maps to {acting}")
    return acting


class PGCluster:
    """One PG of an erasure pool on in-process hosts, as the reference's
    backend tests drive it and as an OSD would wire it: one host for
    each OSD of the acting set, each with a MemStore and an ECBackend;
    the primary's host carries the OSD's EncodeBatcher; every sub-op
    goes through the port's encode_frame_parts and decode_frame_body on
    its way to the other host (the messenger, minus the socket); one PG
    lock, which the batcher's continuations and the stores' commit
    callbacks re-enter under."""

    def __init__(self, codec, stripe_width: int, acting: list, conf,
                 batcher):
        import threading

        from ceph_tpu_torch.osd.backend import PGHost
        from ceph_tpu_torch.osd.ecbackend import ECBackend
        from ceph_tpu_torch.store import MemStore, Transaction

        self.lock = threading.RLock()
        self.acting = [(s, osd) for s, osd in enumerate(acting)]
        self.store_s = 0.0       # host seconds in the stores' applies
        tally = threading.Lock()
        cl = self

        class Host(PGHost):
            def __init__(self, shard, osd):
                self._shard, self._osd = shard, osd
                self.lock, self.conf = cl.lock, conf
                self.encode_batcher = batcher if shard == 0 else None
                self._store = MemStore()
                self._store.mount()
                self._store.mkfs()
                self._store.queue_transactions(
                    [Transaction().create_collection(self.coll)])
                self.logged = []
                apply = self._store.queue_transactions

                def timed(txns, *a, **kw):
                    t0 = time.monotonic()
                    try:
                        return apply(txns, *a, **kw)
                    finally:
                        with tally:
                            cl.store_s += time.monotonic() - t0
                self._store.queue_transactions = timed

            whoami = property(lambda self: self._osd)
            pgid_str = property(lambda self: "1.0")
            own_shard = property(lambda self: self._shard)
            store = property(lambda self: self._store)
            epoch = property(lambda self: 1)

            def coll_of(self, shard):
                return f"1.0s{shard}"

            def acting_shards(self):
                return cl.acting

            def send_shard(self, osd, msg):
                cl.route(osd, msg)

            def prepare_log_txn(self, txn, log_entries):
                self.logged.extend(log_entries)

            def on_local_commit(self, fn):
                with cl.lock:
                    fn()

        self.hosts = {osd: Host(s, osd) for s, osd in self.acting}
        for host in self.hosts.values():
            host.store.flush()
            host.backend = ECBackend(host, codec, stripe_width)
        self.by_shard = [self.hosts[osd] for osd in acting]
        self.primary = self.by_shard[0].backend
        self.frames = 0
        self.frame_bytes = 0
        self.frame_s = 0.0       # host seconds framing and unframing

    def route(self, osd, msg):
        from ceph_tpu_torch.msg import message as wire
        t0 = time.monotonic()
        parts = wire.encode_frame_parts(msg)
        mtype, seq, plen = wire.decode_frame_header(parts[0])
        got = wire.decode_frame_body(mtype, seq, parts[0],
                                     b"".join(parts[1:-1]), parts[-1])
        dt = time.monotonic() - t0
        with self.lock:
            self.frames += 1
            self.frame_bytes += plen
            self.frame_s += dt
            if not self.hosts[osd].backend.handle_message(got):
                raise AssertionError(f"osd.{osd} did not handle "
                                     f"{type(got).__name__}")

    def flush(self):
        for host in self.hosts.values():
            host.store.flush()

    def shard_bytes(self, shard: int, oid: str) -> bytes:
        from ceph_tpu_torch.store import GHObject
        return self.by_shard[shard].store.read(f"1.0s{shard}",
                                               GHObject(oid, shard))

    def stop(self):
        for host in self.hosts.values():
            host.store.umount()


def drive(cl, n: int, threads: int, start) -> tuple:
    """Start op i with ``start(i, cb)`` under the PG lock from
    ``threads`` threads, as PG workers do, and wait for every callback;
    returns the callbacks' arguments and the seconds from the first
    start to the last callback."""
    import threading
    out = [None] * n
    left = threading.Semaphore(0)

    def one(i):
        def cb(*res):
            out[i] = res
            left.release()
        with cl.lock:
            start(i, cb)
    t0 = time.monotonic()
    fan_out(one, n, threads)
    for _ in range(n):
        if not left.acquire(timeout=600):
            raise AssertionError("an ECBackend op never completed")
    return out, time.monotonic() - t0


def lane_counts(b, cl) -> dict:
    """The batcher's lane counters and the backend's host routes."""
    p = cl.primary
    return {"calls": b.calls, "reqs": b.reqs_total,
            "dec_calls": b.dec_calls, "dec_reqs": b.dec_reqs,
            "delta_calls": b.delta_calls, "delta_reqs": b.delta_reqs,
            "twin_routes": b.cpu_reqs + b.dec_cpu_reqs + b.delta_cpu_reqs
            + p.twin_routes,
            "device_errors": b.device_errors + p.device_errors,
            "delta_rmw_ops": p.delta_rmw_ops,
            "delta_rmw_fallbacks": p.delta_rmw_fallbacks,
            "frames": cl.frames, "frame_bytes": cl.frame_bytes,
            "frame_s": cl.frame_s, "store_s": cl.store_s}


def sub_phase(name, b, cl, counts, n, threads, start, nbytes, calls,
              reqs, kernel) -> tuple:
    """Run one sub-phase of the ecbackend phase with the launch counts
    zeroed just before it; print its line; fail on a twin route, a
    device error or a kernel that did not launch.  ``calls`` None: the
    codec has no batched entry point, so no lane is counted."""
    before = lane_counts(b, cl)
    seen = len(b.ledger_accum.recent())
    counts.reset()
    out, wall = drive(cl, n, threads, start)
    launches = counts.read()
    cl.flush()
    after = lane_counts(b, cl)
    d = {k: after[k] - before[k] for k in after}
    tiles = b.ledger_accum.recent()[seen:]
    span = (max(led["deliver"] for led in tiles)
            - min(led["stage_acquire"] for led in tiles)) if tiles else 0.0
    lane = (f"lane {d[calls]} calls for {d[reqs]} requests" if calls
            else "no batcher lane (the codec has no batched entry point)")
    print(f"ecbackend {name}: {n} ops from {threads} threads, "
          f"{nbytes / 2**30:.3f} GiB in {wall:.4f} s host to host = "
          f"{nbytes / 2**30 / wall:.3f} GiB/s; {lane}; launches B1 "
          f"{launches['B1']} B2 "
          f"{launches['B2']} B3 {launches['B3']}; twin routes "
          f"{d['twin_routes']}, device errors {d['device_errors']}; "
          f"{d['frames']} sub-op frames of {d['frame_bytes'] / 2**30:.3f} "
          f"GiB; host seconds summed over threads: framing "
          f"{d['frame_s']:.4f}, store applies {d['store_s']:.4f}; the "
          f"batcher's {len(tiles)} device tiles span {span:.4f} s from the "
          f"first staged to the last delivered")
    if d["twin_routes"] or d["device_errors"]:
        raise AssertionError(f"ecbackend {name}: {d['twin_routes']} twin "
                             f"routes, {d['device_errors']} device errors "
                             f"({cl.primary.last_device_error!r})")
    if launches[kernel] < 1:
        raise AssertionError(f"ecbackend {name}: {kernel} did not launch")
    return out, wall, launches, d


def ecbackend_path(torch, np, registry, ecutil, counts) -> dict:
    """Drive the port's ECBackend for one PG of a k=8 m=4 pool (4 KiB
    stripe unit, acting set from the OSDMap) over the primary's
    EncodeBatcher at full width: ECB_OBJS writes of 4 MiB from
    ECB_THREADS threads, as many 2-column overwrites, degraded reads of
    every object with shards ERASED down, recovery of every object's
    shard 3 after its store is wiped, and a deep scrub with syndromes on
    all 12 hosts; then a cauchy_good k=10 m=4 pool's writes; then an LRC
    PG and a CLAY PG (codec_pg).  Every shard is held to the host encode
    (the jerasure plugin, or the same LRC or CLAY code over it, through
    ecutil.encode), every read to what was written."""
    from ceph_tpu_torch.osd.backend import Mutation
    from ceph_tpu_torch.osd.batcher import EncodeBatcher
    from ceph_tpu_torch.osd.pglog import MODIFY, LogEntry
    from ceph_tpu_torch.utils.config import default_config
    from ceph_tpu_torch.utils.crc import crc32c

    print(f"ecbackend phase on {card()} (nvidia-smi name, power limit)")
    conf = default_config()
    for name, value in (("ec_tpu_batch_stripes", BATCH_STRIPES),
                        ("ec_tpu_queue_window_us", BATCH_WINDOW_US),
                        ("ec_tpu_fallback_cpu", False),
                        ("osd_ec_prewarm", True)):
        conf.set(name, value)
    EncodeBatcher.reset_learning()
    b = EncodeBatcher(conf)
    out = {"launches": {}}
    clusters = []
    try:
        codec = registry.instance().factory(
            "gpu", {"k": str(K), "m": str(M), "technique": "reed_sol_van",
                    "device": DEV})
        sw = K * ECB_STRIPE_UNIT
        sinfo = ecutil.StripeInfo(K, sw)
        acting = pg_acting(K, M, ECB_OSDS, ECB_STRIPE_UNIT)
        warm = b.prewarm(codec, sinfo)
        if warm is not None:
            warm.join()
        if b.prewarm_error is not None:
            raise AssertionError(f"prewarm: {b.prewarm_error!r}")
        twin = b.cpu_twin(codec, sinfo)
        cl = PGCluster(codec, sw, acting, conf, b)
        clusters.append(cl)
        p = cl.primary
        print(f"ecbackend: PG 1.0 of a k={K} m={M} pool on {ECB_OSDS} OSDs, "
              f"acting {acting}, stripe width {sw}, {ECB_OBJS} objects of "
              f"{ECB_OBJ_BYTES >> 20} MiB, segment {p.seg_bytes} bytes")
        gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
        objs = torch.randint(0, 256, (ECB_OBJS, ECB_OBJ_BYTES),
                             dtype=torch.uint8, device=DEV,
                             generator=gen).cpu().numpy()
        names = [f"rbd_data.ec.{i:016x}" for i in range(ECB_OBJS)]
        blobs = [o.tobytes() for o in objs]
        versions = {}
        nbytes = objs.nbytes
        shard_len = ECB_OBJ_BYTES // K

        def check_shards(what, i, data, hinfo):
            want = ecutil.encode(sinfo, twin, data)
            for s in range(K + M):
                got = cl.shard_bytes(s, names[i])
                if got != bytes(want[s]):
                    raise AssertionError(f"ecbackend {what}: object {i} "
                                         f"shard {s} != host encode")
                if hinfo:
                    from ceph_tpu_torch.store import GHObject
                    h = ecutil.HashInfo.decode(cl.by_shard[s].store.getattr(
                        f"1.0s{s}", GHObject(names[i], s),
                        ecutil.HINFO_KEY))
                    if h.crcs[s] != crc32c(got):
                        raise AssertionError(f"ecbackend {what}: object {i}"
                                             f" shard {s} hinfo CRC")

        def write(i, cb):
            versions[i] = (1, i + 1)
            p.submit_transaction(
                names[i], Mutation(writes=[(0, blobs[i])]), versions[i],
                [LogEntry(MODIFY, names[i], versions[i])], cb)

        def read(i, cb):
            p.objects_read(names[i], 0, ECB_OBJ_BYTES, cb)

        def check_reads(what, res):
            for i, (r, data) in enumerate(res):
                if r != 0 or bytes(data) != blobs[i]:
                    raise AssertionError(f"ecbackend {what}: object {i} "
                                         f"read {r}, bytes differ")

        # 1. writes: two segments each through the encode lane
        res, wall, launches, d = sub_phase(
            "writes", b, cl, counts, ECB_OBJS, ECB_THREADS, write, nbytes,
            "calls", "reqs", "B1")
        if any(r != (0,) for r in res):
            raise AssertionError(f"ecbackend writes: results {set(res)}")
        for i in range(ECB_OBJS):
            check_shards("writes", i, blobs[i], hinfo=True)
        out["launches"]["ecbackend_write"] = launches
        out["write"] = wall
        res, rwall = drive(cl, ECB_OBJS, ECB_THREADS, read)
        check_reads("healthy read", res)
        print(f"ecbackend healthy reads: {ECB_OBJS} objects in {rwall:.4f} s "
              f"host to host = {nbytes / 2**30 / rwall:.3f} GiB/s, every "
              f"byte as written; every shard equal to the host encode, "
              f"every hinfo CRC equal to crc32c")

        # 2. delta overwrites: 8 KiB, two 4 KiB columns of one stripe
        rng = np.random.default_rng(SEED + 8)
        patches = rng.integers(0, 256, (ECB_OBJS, 2 * ECB_STRIPE_UNIT),
                               dtype=np.uint8)
        stripes = ECB_OBJ_BYTES // sw
        offs = [(i % stripes) * sw + DELTA_COL * ECB_STRIPE_UNIT
                for i in range(ECB_OBJS)]

        def overwrite(i, cb):
            versions[i] = (1, ECB_OBJS + i + 1)
            p.submit_transaction(
                names[i], Mutation(writes=[(offs[i], patches[i].tobytes())]),
                versions[i], [LogEntry(MODIFY, names[i], versions[i])], cb)
        res, wall, launches, d = sub_phase(
            "delta overwrites", b, cl, counts, ECB_OBJS, ECB_THREADS,
            overwrite, patches.nbytes, "delta_calls", "delta_reqs", "B1")
        if any(r != (0,) for r in res):
            raise AssertionError(f"ecbackend delta: results {set(res)}")
        if d["delta_rmw_ops"] != ECB_OBJS or d["delta_rmw_fallbacks"]:
            raise AssertionError(
                f"ecbackend delta: {d['delta_rmw_ops']} delta ops, "
                f"{d['delta_rmw_fallbacks']} fallbacks for {ECB_OBJS}")
        for i in range(ECB_OBJS):
            o = objs[i]
            o[offs[i]:offs[i] + patches.shape[1]] = patches[i]
            blobs[i] = o.tobytes()
            check_shards("delta", i, blobs[i], hinfo=False)
        out["launches"]["ecbackend_delta"] = launches
        out["delta"] = wall
        print(f"ecbackend delta: {d['delta_rmw_ops']} of {ECB_OBJS} "
              f"overwrites on the delta lane, {d['delta_rmw_fallbacks']} "
              f"fallbacks; parity equal to a full re-encode")

        # 3. degraded reads with shards ERASED down
        cl.acting = [(s, None if s in ERASED else osd)
                     for s, osd in enumerate(acting)]
        res, wall, launches, d = sub_phase(
            "degraded reads", b, cl, counts, ECB_OBJS, ECB_THREADS, read,
            nbytes, "dec_calls", "dec_reqs", "B1")
        check_reads("degraded read", res)
        out["launches"]["ecbackend_degraded"] = launches
        out["degraded"] = wall
        cl.acting = [(s, osd) for s, osd in enumerate(acting)]

        # 4. recovery: shard LOST's store wiped, every object rebuilt
        from ceph_tpu_torch.store import GHObject, Transaction
        lost_host = cl.by_shard[LOST]
        before = [cl.shard_bytes(LOST, n) for n in names]
        txn = Transaction()
        for n in names:
            txn.remove(f"1.0s{LOST}", GHObject(n, LOST))
        lost_host.store.queue_transactions([txn])
        lost_host.store.flush()

        def recover(i, cb):
            p.recover_object(names[i], versions[i],
                             [(LOST, acting[LOST])], cb)
        res, wall, launches, d = sub_phase(
            f"recovery of shard {LOST}", b, cl, counts, ECB_OBJS,
            ECB_THREADS, recover, ECB_OBJS * shard_len, "dec_calls",
            "dec_reqs", "B1")
        if any(r != (0,) for r in res):
            raise AssertionError(f"ecbackend recovery: results {set(res)}")
        for i, n in enumerate(names):
            if cl.shard_bytes(LOST, n) != before[i]:
                raise AssertionError(f"ecbackend recovery: object {i} shard "
                                     f"{LOST} rebuilt wrong")
        out["launches"]["ecbackend_recovery"] = launches
        out["rebuild_mb_s"] = ECB_OBJS * shard_len / wall / 1e6
        print(f"ecbackend rebuild: {ECB_OBJS} shards of {shard_len} bytes "
              f"in {wall:.4f} s = {out['rebuild_mb_s']:.3f} MB/s of rebuilt "
              f"shard bytes (host clock), each byte-equal to the shard "
              f"before")

        # 5. deep scrub with syndromes on every host
        conf.set("osd_deep_scrub_syndrome", True)
        out["scrub"] = scrub_path(torch, np, codec, cl, counts)
        out["launches"]["scrub"] = out["scrub"]["launches"]

        # 6. packet codes: a cauchy_good k=10 m=4 pool, packetsize 2048
        pcodec = registry.instance().factory(
            "gpu", {"k": str(PK), "m": str(PM), "technique": "cauchy_good",
                    "packetsize": "2048", "device": DEV})
        psw = PK * PKT_STRIPE_UNIT
        psinfo = ecutil.StripeInfo(PK, psw)
        if pcodec.get_chunk_size(psw) != PKT_STRIPE_UNIT:
            raise AssertionError("packet pool: stripe unit not aligned")
        warm = b.prewarm(pcodec, psinfo)
        if warm is not None:
            warm.join()
        pacting = pg_acting(PK, PM, PK + PM + 1, PKT_STRIPE_UNIT)
        pcl = PGCluster(pcodec, psw, pacting, conf, b)
        clusters.append(pcl)
        ptwin = b.cpu_twin(pcodec, psinfo)
        pobjs = torch.randint(0, 256, (PKT_ECB_OPS, ECB_OBJ_BYTES),
                              dtype=torch.uint8, device=DEV,
                              generator=gen).cpu().numpy()
        pblobs = [o.tobytes() for o in pobjs]

        def pwrite(i, cb):
            pcl.primary.submit_transaction(
                names[i], Mutation(writes=[(0, pblobs[i])]), (1, i + 1),
                [LogEntry(MODIFY, names[i], (1, i + 1))], cb)
        res, wall, launches, d = sub_phase(
            "cauchy_good k=10 m=4 writes", b, pcl, counts, PKT_ECB_OPS,
            PKT_ECB_THREADS, pwrite, pobjs.nbytes, "calls", "reqs", "B2")
        if any(r != (0,) for r in res):
            raise AssertionError(f"ecbackend packet: results {set(res)}")
        astripes = -(-ECB_OBJ_BYTES // psw)
        for i in range(PKT_ECB_OPS):
            padded = pblobs[i] + bytes(astripes * psw - ECB_OBJ_BYTES)
            want = ecutil.encode(psinfo, ptwin, padded)
            for s in range(PK + PM):
                if pcl.shard_bytes(s, names[i]) != bytes(want[s]):
                    raise AssertionError(f"ecbackend packet: object {i} "
                                         f"shard {s} != jerasure")
        out["launches"]["ecbackend_packet"] = launches
        print(f"ecbackend packet pool: acting {pacting}, stripe unit "
              f"{PKT_STRIPE_UNIT}, every chunk equal to the jerasure "
              f"plugin's host encode; frames carried {cl.frames + pcl.frames}"
              f" sub-ops, {(cl.frame_bytes + pcl.frame_bytes) / 2**30:.3f} "
              f"GiB of payload")

        # 7. the other plugins: an LRC PG and a CLAY PG, inner codes on B1
        for name, profile, host_profile, su, lost in CODEC_PGS:
            got, ccl = codec_pg(torch, np, registry, ecutil, counts, b, conf,
                                gen, name, profile, host_profile, su, lost)
            clusters.append(ccl)
            out["launches"].update(got)
    finally:
        b.stop()
        for c in clusters:
            c.stop()
    return out


# the ecbackend phase's PGs of the other plugins: (name, profile on the
# card, the same code on the host, stripe unit, shard lost and recovered);
# LRC at Ceph's default 4 KiB stripe unit, CLAY at chunks of 1 MiB so
# that a 4 MiB object is one stripe of 8 planes of 128 KiB (at 4 KiB the
# per-stripe plane walk would run 1024 times an object)
CODEC_PGS = (
    ("lrc", {"plugin": "lrc", "k": "4", "m": "2", "l": "3", "inner": "gpu"},
     {"plugin": "lrc", "k": "4", "m": "2", "l": "3"}, 4096, 2),
    ("clay", {"plugin": "clay", "k": "4", "m": "2", "scalar_mds": "gpu"},
     {"plugin": "clay", "k": "4", "m": "2"}, 1 << 20, 3),
)
CODEC_PG_OBJS = 32         # writes of 4 MiB
CODEC_PG_DOWN = 1          # the shard down for the degraded reads


def codec_pg(torch, np, registry, ecutil, counts, b, conf, gen, name,
             profile, host_profile, su, lost) -> tuple:
    """One PG of an LRC or CLAY pool on the ECBackend: CODEC_PG_OBJS
    writes of 4 MiB (every shard equal to the host code's encode, every
    hinfo CRC equal), read back, degraded reads with shard CODEC_PG_DOWN
    down, recovery of shard ``lost`` for every object, a deep scrub.
    LRC's recovery of a chunk of a local group reads l = 3 shards; CLAY's
    takes the sub-chunk route and reads under 0.8 of whole chunks from
    k.  Returns the launches of each step and the cluster."""
    from ceph_tpu_torch.osd.backend import Mutation
    from ceph_tpu_torch.osd.pglog import MODIFY, LogEntry
    from ceph_tpu_torch.store import GHObject, Transaction
    from ceph_tpu_torch.utils.crc import crc32c

    reg = registry.instance()
    codec = reg.factory(profile["plugin"], dict(profile, device=DEV))
    host = reg.factory(host_profile["plugin"], dict(host_profile))
    k, n = codec.get_data_chunk_count(), codec.get_chunk_count()
    sw = k * su
    if codec.get_chunk_size(sw) != su:
        raise AssertionError(f"{name} pool: stripe unit not aligned")
    sinfo = ecutil.StripeInfo(k, sw)
    acting = pg_acting(k, n - k, ECB_OSDS, su)
    cl = PGCluster(codec, sw, acting, conf, b)
    p = cl.primary
    objs = torch.randint(0, 256, (CODEC_PG_OBJS, ECB_OBJ_BYTES),
                         dtype=torch.uint8, device=DEV,
                         generator=gen).cpu().numpy()
    names = [f"rbd_data.{name}.{i:016x}" for i in range(CODEC_PG_OBJS)]
    blobs = [o.tobytes() for o in objs]
    nbytes = objs.nbytes
    shard_len = ECB_OBJ_BYTES // k
    launches = {}
    print(f"ecbackend {name} PG: {profile}, acting {acting} on {ECB_OSDS} "
          f"OSDs, stripe unit {su}, {CODEC_PG_OBJS} objects of "
          f"{ECB_OBJ_BYTES >> 20} MiB")

    def write(i, cb):
        v = (1, i + 1)
        p.submit_transaction(names[i], Mutation(writes=[(0, blobs[i])]), v,
                             [LogEntry(MODIFY, names[i], v)], cb)

    def read(i, cb):
        p.objects_read(names[i], 0, ECB_OBJ_BYTES, cb)

    def check_reads(what, res):
        for i, (r, data) in enumerate(res):
            if r != 0 or bytes(data) != blobs[i]:
                raise AssertionError(f"{name} {what}: object {i} read {r}, "
                                     f"bytes differ")

    res, wall, launches[f"ecbackend_{name}_write"], _ = sub_phase(
        f"{name} writes", b, cl, counts, CODEC_PG_OBJS, ECB_THREADS, write,
        nbytes, None, None, "B1")
    if any(r != (0,) for r in res):
        raise AssertionError(f"{name} writes: results {set(res)}")
    for i in range(CODEC_PG_OBJS):
        want = ecutil.encode(sinfo, host, blobs[i])
        for s in range(n):
            got = cl.shard_bytes(s, names[i])
            h = ecutil.HashInfo.decode(cl.by_shard[s].store.getattr(
                f"1.0s{s}", GHObject(names[i], s), ecutil.HINFO_KEY))
            if got != bytes(want[s]) or h.crcs[s] != crc32c(got):
                raise AssertionError(f"{name} writes: object {i} shard {s} "
                                     f"!= the host encode or its hinfo")
    res, rwall = drive(cl, CODEC_PG_OBJS, ECB_THREADS, read)
    check_reads("read back", res)
    print(f"ecbackend {name} read back: {CODEC_PG_OBJS} objects in "
          f"{rwall:.4f} s, every byte as written; every shard equal to "
          f"{host_profile} on the host, every hinfo CRC equal to crc32c")

    cl.acting = [(s, None if s == CODEC_PG_DOWN else osd)
                 for s, osd in enumerate(acting)]
    res, wall, launches[f"ecbackend_{name}_degraded"], _ = sub_phase(
        f"{name} degraded reads, shard {CODEC_PG_DOWN} down", b, cl, counts,
        CODEC_PG_OBJS, ECB_THREADS, read, nbytes, None, None, "B1")
    check_reads("degraded read", res)
    cl.acting = [(s, osd) for s, osd in enumerate(acting)]

    before = [cl.shard_bytes(lost, nm) for nm in names]
    txn = Transaction()
    for nm in names:
        txn.remove(f"1.0s{lost}", GHObject(nm, lost))
    cl.by_shard[lost].store.queue_transactions([txn])
    cl.by_shard[lost].store.flush()
    read0 = p.read_bytes_total
    rep0 = (p.subchunk_repairs, p.repair_read_bytes, p.repair_whole_bytes)

    def recover(i, cb):
        p.recover_object(names[i], (1, i + 1), [(lost, acting[lost])], cb)
    res, wall, launches[f"ecbackend_{name}_recovery"], _ = sub_phase(
        f"{name} recovery of shard {lost}", b, cl, counts, CODEC_PG_OBJS,
        ECB_THREADS, recover, CODEC_PG_OBJS * shard_len, None, None, "B1")
    if any(r != (0,) for r in res):
        raise AssertionError(f"{name} recovery: results {set(res)}")
    for i, nm in enumerate(names):
        if cl.shard_bytes(lost, nm) != before[i]:
            raise AssertionError(f"{name} recovery: object {i} shard {lost} "
                                 f"rebuilt wrong")
    read = p.read_bytes_total - read0
    repairs, took, whole = (x - y for x, y in zip(
        (p.subchunk_repairs, p.repair_read_bytes, p.repair_whole_bytes),
        rep0))
    if name == "lrc":
        # a chunk of a local group: the l = 3 others of its group
        if read != 3 * CODEC_PG_OBJS * shard_len or repairs:
            raise AssertionError(f"lrc recovery read {read} bytes, "
                                 f"{repairs} sub-chunk repairs")
        what = (f"read {read} bytes of sub-ops = 3 shards an object (l = 3"
                f"), not k = {k}")
    else:
        if repairs != CODEC_PG_OBJS or not took < 0.8 * whole:
            raise AssertionError(f"clay recovery: {repairs} sub-chunk "
                                 f"repairs, read {took} of {whole}")
        what = (f"{repairs} sub-chunk repairs read {took} bytes against "
                f"{whole} for whole chunks from k ({took / whole:.3f})")
    rate = CODEC_PG_OBJS * shard_len / wall / 1e6
    print(f"ecbackend {name} rebuild: {CODEC_PG_OBJS} shards of {shard_len} "
          f"bytes in {wall:.4f} s = {rate:.3f} MB/s, each byte-equal to the "
          f"shard before; {what}")

    counts.reset()
    t0 = time.monotonic()
    maps = []
    for s in range(n):
        with cl.lock:
            maps.append(cl.by_shard[s].backend.build_scrub_map(deep=True))
    secs = time.monotonic() - t0
    scrub_b1 = counts.read()["B1"]
    backs = [h.backend for h in cl.by_shard]
    for s, smap in enumerate(maps):
        for nm in names:
            e = smap[nm]
            if e["data_crc"] != crc32c(cl.shard_bytes(s, nm)) or \
                    not e["hinfo_ok"]:
                raise AssertionError(f"{name} scrub: shard {s} {nm}")
    if any(be.scrub_host_fallbacks for be in backs):
        raise AssertionError(f"{name} scrub: host fallbacks")
    print(f"ecbackend {name} deep scrub: {n} hosts in {secs:.4f} s, every "
          f"data CRC equal to crc32c and every hinfo good, host fallbacks "
          f"0; B1 launches {scrub_b1} (the codec has no coding matrix of "
          f"its own: its shards' CRCs run on the host loop, as in the JAX "
          f"package)")
    return launches, cl


def scrub_path(torch, np, codec, cl, counts) -> dict:
    """The deep scrub of the ecbackend phase: build_scrub_map(deep=True)
    on all 12 hosts with osd_deep_scrub_syndrome on, each host's objects
    in ec_tpu_scrub_window_bytes windows through crclinear on the codec's
    backend (B1, one launch a row group: [160, 4096] for a data shard's
    five bands).  The first window of every host equals the CPU route;
    every data CRC equals crc32c; the syndrome partials XOR to zero
    across the shards of every object, and a byte flipped in one shard of
    one object shows in that object alone; no window falls back to the
    host."""
    from ceph_tpu_torch.ops import crclinear
    from ceph_tpu_torch.ops import gf8_kernel
    from ceph_tpu_torch.ops.torch_engine import TorchBackend
    from ceph_tpu_torch.store import GHObject, Transaction
    from ceph_tpu_torch.utils.crc import crc32c

    lin = crclinear.shared()
    backend, cpu = codec.core.backend, TorchBackend("cpu")
    fallbacks = lin.host_fallbacks
    windows = []
    apply = lin._apply_window

    def recording(stack, scales, backend=None, strict=False):
        n0 = gf8_kernel.launches
        got = apply(stack, scales, backend=backend, strict=strict)
        windows.append({"stack": stack, "bands": tuple(scales),
                        "got": got, "launches": gf8_kernel.launches - n0,
                        "backend": backend})
        return got

    n = K + M
    lin._apply_window = recording
    try:
        counts.reset()
        t0 = time.monotonic()
        maps = []
        for s in range(n):
            with cl.lock:
                maps.append(cl.by_shard[s].backend.build_scrub_map(
                    deep=True))
            windows[-1]["last_of"] = s
        secs = time.monotonic() - t0
        launches = counts.read()
    finally:
        del lin._apply_window
    backs = [h.backend for h in cl.by_shard]
    if any(be.scrub_host_fallbacks for be in backs) or \
            lin.host_fallbacks != fallbacks or \
            min(be.scrub_device_windows for be in backs) < 1:
        raise AssertionError(
            f"scrub: host fallbacks "
            f"{[be.scrub_host_fallbacks for be in backs]} "
            f"({[repr(be.scrub_last_error) for be in backs]}), device "
            f"windows {[be.scrub_device_windows for be in backs]}")
    if launches["B1"] != sum(w["launches"] for w in windows) or \
            any(w["launches"] != len(w["bands"]) for w in windows):
        raise AssertionError(f"scrub: B1 launches {launches['B1']}, by window"
                             f" {[(len(w['bands']), w['launches']) for w in windows]}")
    five = [w for w in windows if len(w["bands"]) == 5]
    if not five or lin.block_bitmatrix(five[0]["bands"]).shape != (160, 4096):
        raise AssertionError("scrub: no [160, 4096] window")
    # the first window of every host against the CPU route
    starts = [0] + [i + 1 for i, w in enumerate(windows) if "last_of" in w]
    for s, i in enumerate(starts[:n]):
        w = windows[i]
        plain = lin._apply_window(w["stack"], w["bands"], cpu)
        if not np.array_equal(w["got"], plain):
            raise AssertionError(f"scrub: shard {s} window != CPU route")
    oids = sorted(maps[0])

    def syndromes(ms):
        syn = {}
        for oid in oids:
            acc = np.zeros(M, dtype=np.uint64)
            for smap in ms:
                acc ^= np.asarray(smap[oid]["syndrome_partials"],
                                  dtype=np.uint64)
            syn[oid] = acc
        return syn
    for s in range(n):
        if sorted(maps[s]) != oids:
            raise AssertionError(f"scrub: shard {s} lists other objects")
        for oid in oids:
            if maps[s][oid]["data_crc"] != crc32c(cl.shard_bytes(s, oid)):
                raise AssertionError(f"scrub: shard {s} {oid} data_crc")
    if any(v.any() for v in syndromes(maps).values()):
        raise AssertionError("scrub: syndrome partials do not cancel")
    s_bad, o_bad = LOST, oids[len(oids) // 2]
    good = cl.shard_bytes(s_bad, o_bad)
    flip = bytes([good[1000] ^ 0x5A])
    host = cl.by_shard[s_bad]
    host.store.queue_transactions([Transaction().write(
        f"1.0s{s_bad}", GHObject(o_bad, s_bad), 1000, flip)])
    host.store.flush()
    with cl.lock:
        bad_map = host.backend.build_scrub_map(deep=True)
    maps_bad = list(maps)
    maps_bad[s_bad] = bad_map
    hit = [oid for oid, v in syndromes(maps_bad).items() if v.any()]
    if hit != [o_bad] or lin.host_fallbacks != fallbacks:
        raise AssertionError(f"scrub: a flipped byte in {o_bad} shard "
                             f"{s_bad} shows in {hit}")
    host.store.queue_transactions([Transaction().write(
        f"1.0s{s_bad}", GHObject(o_bad, s_bad), 1000, good[1000:1001])])
    host.store.flush()
    nbytes = sum(w["stack"].size for w in windows)
    shapes = sorted({lin.block_bitmatrix(w["bands"]).shape for w in windows},
                    reverse=True)
    print(f"ecbackend deep scrub: {n} hosts, {len(windows)} windows "
          f"({nbytes / 2**30:.3f} GiB), bitmatrices {shapes}, B1 launches "
          f"{launches['B1']} (one a row group) in {secs:.4f} s host to "
          f"host = {nbytes / 2**30 / secs:.3f} GiB/s; device windows "
          f"{sum(be.scrub_device_windows for be in backs)}, host fallbacks "
          f"0; first window of every host equal to the CPU route, data "
          f"CRCs equal crc32c, syndromes cancel, a flipped byte in {o_bad} "
          f"shard {s_bad} shows in {hit}")
    big = five[0]
    return {"launches": launches, "shard": big["stack"],
            "bands": big["bands"], "backend": backend}


# cluster phases: the port's in-process cluster of 13 OSDs over the
# loopback-TCP messenger, a k=8 m=4 `gpu` pool with 32 PGs and the 4 KiB
# stripe unit, RAM BlueStores, one client; the settings of the JAX
# package's own 13-OSD run (bench.py _cluster_run).  The crimson phase
# runs the OSDs of the config default at full depth; the classic phase
# runs the same steps at a cut depth for the comparison on one card
CL_OSDS = 13
CL_PG_NUM = 32
CRIMSON_OBJS = 128         # 512 MiB of 4 MiB objects (RBD's object size)
CLASSIC_OBJS = 32          # 128 MiB: the classic phase's cut depth
CL_OBJ_BYTES = 4 << 20
CL_STRIPE_UNIT = 4096
CL_LOST = 12               # the OSD killed with its data and rebuilt
CL_WARM_BATCHES = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
CL_PKT_OBJS = 8            # cauchy_good k=8 m=4 writes of 4 MiB (B2)
CL_PKT_PG_NUM = 8
CL_PKT_STRIPE_UNIT = 64 << 10   # packetsize 2048 x w 8 x 4: aligned
WATCH_POLL_S = 0.005       # how often the reactors' loop lag is read
STUCK_S = 5.0              # a reactor that has not ticked this long is
                           # reported with its stack


def cluster_conf(test_config, factor: float, **backend):
    """test_config with the JAX package's 13-OSD overrides (heartbeats
    slowed, grace scaled by the machine factor, down->out aging of 60 s,
    32 PGs, a 3 ms batcher window), the route pinned to the card and the
    batcher prewarmed; ``backend`` is ``osd_backend=...`` or nothing, for
    the config default (crimson)."""
    return test_config(osd_heartbeat_interval=2.0,
                       osd_heartbeat_grace=max(20.0, 12.0 * factor),
                       mon_osd_down_out_interval=60.0,
                       osd_pool_default_pg_num=CL_PG_NUM,
                       ec_tpu_queue_window_us=3000,
                       ec_tpu_fallback_cpu=False,
                       osd_ec_prewarm=True, **backend)


def cluster_prewarm(registry, crclinear, profile: dict) -> float:
    """Warm the k=8 m=4 shapes on the shared backend before any daemon
    starts: the staging rings of every batch bucket, the encode, decode
    and delta operands, and crclinear's 4 KiB-block window.  Daemon
    threads then find them hot instead of paying CUDA set-up inside a
    heartbeat's time."""
    t0 = time.monotonic()
    codec = registry.instance().factory("gpu", dict(profile))
    codec.prewarm_geometry(CL_STRIPE_UNIT, batches=CL_WARM_BATCHES)
    codec.prewarm_decode(CL_STRIPE_UNIT, batches=CL_WARM_BATCHES)
    codec.prewarm_delta(CL_STRIPE_UNIT, batches=CL_WARM_BATCHES)
    blocks = [bytes(CL_STRIPE_UNIT)] * 1024
    crclinear.shared().crc_batch(blocks, backend=codec.core.backend)
    return time.monotonic() - t0


def thread_cpu() -> dict:
    """CPU seconds each live thread has used so far, from /proc/self/task
    (Linux): {native id: (family, seconds)}, a family being the thread's
    name with its numbers replaced by #."""
    import re
    import threading
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for t in threading.enumerate():
        try:
            with open(f"/proc/self/task/{t.native_id}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except (OSError, TypeError):
            continue
        out[t.native_id] = (re.sub(r"[\d.]+", "#", t.name),
                            (int(fields[11]) + int(fields[12])) / tick)
    return out


def cpu_split(before: dict, after: dict, top: int = 8) -> str:
    """The CPU seconds of the threads alive at the end of a step, summed
    by family, largest first (threads that ended within it are not
    counted)."""
    fam = {}
    for tid, (name, secs) in after.items():
        fam[name] = fam.get(name, 0.0) + secs - before.get(tid, (name, 0.0))[1]
    rows = sorted(fam.items(), key=lambda kv: -kv[1])[:top]
    return ", ".join(f"{n} {v:.2f}" for n, v in rows)


def live_osds(c) -> list:
    return [(i, o) for i, o in sorted(c.osds.items()) if o is not None]


class ReactorWatch:
    """What the crimson OSDs' reactors show during a step: each reactor's
    loop lag (``Reactor.loop_lag_s``, read every WATCH_POLL_S by a thread
    of this script, and the samples ``util_dump`` keeps), and how long
    each BlueStore apply task holds the reactor it runs on (the store's
    ``_reactor_pump``, which only the apply shard calls, timed around
    each call), and how long the manager's ``perf dump`` commands hold
    the reactor that takes them (each OSD's ``_exec_command``, timed the
    same way).  A reactor that has not finished a tick for STUCK_S is
    reported on stderr with the stack it is in, once a stall.  A classic
    cluster has no reactors: the watch then only counts threads."""

    def __init__(self, c):
        self.c = c
        self.holds = []
        self.dumps = []
        self.lag_hwm = {}
        self.stuck = 0
        self._ticks = {}
        self._stop = None
        self._thread = None

    def _check_stuck(self, r, now: float) -> None:
        last = self._ticks.get(id(r))
        if last is None or last[0] != r.ticks:
            self._ticks[id(r)] = (r.ticks, now, False)
            return
        ticks, since, told = last
        if told or now - since < STUCK_S or r._thread is None:
            return
        import traceback
        frame = sys._current_frames().get(r._thread.ident)
        stack = "".join(traceback.format_stack(frame)) if frame else "?"
        print(f"reactor {r._name} has not ticked for {now - since:.1f} s:"
              f"\n{stack}", file=sys.stderr, flush=True)
        self.stuck += 1
        self._ticks[id(r)] = (ticks, since, True)

    def _wrap_osds(self) -> None:
        for _, o in live_osds(self.c):
            if getattr(o, "reactors", ()) and "_exec_command" not in vars(o):
                run, dumps = o._exec_command, self.dumps

                def timed_command(cmd, run=run, dumps=dumps):
                    t0 = time.perf_counter()
                    try:
                        return run(cmd)
                    finally:
                        if cmd.get("prefix") == "perf dump":
                            dumps.append(time.perf_counter() - t0)
                o._exec_command = timed_command
            st = o.store
            if getattr(st, "_reactor", None) is None or \
                    "_reactor_pump" in vars(st):
                continue
            pump, holds = st._reactor_pump, self.holds

            def timed(pump=pump, holds=holds):
                t0 = time.perf_counter()
                try:
                    pump()
                finally:
                    holds.append(time.perf_counter() - t0)
            st._reactor_pump = timed

    def _poll(self, stop) -> None:
        n = 0
        while not stop.wait(WATCH_POLL_S):
            now = time.monotonic()
            for _, o in live_osds(self.c):
                rs = getattr(o, "reactors", ())
                for r in rs:
                    role = "apply" if r is rs[-1] else "other"
                    if r.loop_lag_s > self.lag_hwm.get(role, 0.0):
                        self.lag_hwm[role] = r.loop_lag_s
                    self._check_stuck(r, now)
            n += 1
            if n % 100 == 0:
                self._wrap_osds()   # a revived OSD brings a new store

    def start(self) -> None:
        import threading
        self.holds.clear()
        self.dumps.clear()
        self.lag_hwm = {}
        self.stuck = 0
        self._ticks = {}
        self.t_wall = time.time()
        self._wrap_osds()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll,
                                        args=(self._stop,),
                                        name="chip-smoke-watch",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> str:
        """End the watch; the step's reactor line."""
        import threading
        self._stop.set()
        self._thread.join()
        threads = threading.active_count()
        reactors = [r for _, o in live_osds(self.c)
                    for r in getattr(o, "reactors", ())]
        if not reactors:
            return f"{threads} threads alive at the step's end"
        samples = [s for r in reactors for s in r.util_dump()
                   if s["ts"] >= self.t_wall]
        holds = sorted(self.holds)
        applied = (f"{len(holds)} apply tasks on the apply shards held "
                   f"their reactor {sum(holds):.4f} s in all, median "
                   f"{median(holds) * 1e3:.4f} ms, max "
                   f"{holds[-1] * 1e3:.4f} ms" if holds
                   else "no apply task ran on a reactor")
        dumps = sorted(self.dumps)
        mgr = (f"; {len(dumps)} perf dumps for the manager held their "
               f"reactor {sum(dumps):.4f} s in all, max "
               f"{dumps[-1] * 1e3:.4f} ms" if dumps else "")
        util = (f"{len(samples)} util_dump samples, max util "
                f"{max(s['util'] for s in samples):.3f}, max loop lag "
                f"{max(s['loop_lag_s'] for s in samples):.6f} s"
                if samples else "no util_dump sample")
        return (f"{len(reactors)} reactors; loop lag high-water mark "
                f"{self.lag_hwm.get('apply', 0.0):.6f} s on the apply "
                f"shards, {self.lag_hwm.get('other', 0.0):.6f} s on the "
                f"others (read every {WATCH_POLL_S * 1e3:.0f} ms); {util}; "
                f"{applied}{mgr}; {self.stuck} reactors stuck {STUCK_S:.0f} s "
                f"or more (stacks on stderr); {threads} threads alive at the "
                f"step's end")


def cluster_lanes(c) -> dict:
    """Each live OSD's batcher lane counters, keyed by the batcher."""
    out = {}
    for _, o in live_osds(c):
        b = o.encode_batcher
        out[id(b)] = {"calls": b.calls, "reqs": b.reqs_total,
                      "dec_calls": b.dec_calls, "dec_reqs": b.dec_reqs,
                      "delta_calls": b.delta_calls,
                      "delta_reqs": b.delta_reqs}
    return out


def lane_delta(before: dict, after: dict) -> dict:
    tot = {}
    for key, row in after.items():
        base = before.get(key, {})
        for name, v in row.items():
            tot[name] = tot.get(name, 0) + v - base.get(name, 0)
    return tot


def ec_backends(c) -> list:
    return [pg.backend for _, o in live_osds(c) for pg in list(o.pgs.values())
            if hasattr(pg.backend, "scrub_host_fallbacks")]


def cluster_faults(c, crclinear, EncodeBatcher) -> dict:
    """Every counted host route and device fault of the live daemons."""
    osds = [o for _, o in live_osds(c)]
    bes = ec_backends(c)
    return {
        "twin_routes": sum(o.encode_batcher.cpu_reqs
                           + o.encode_batcher.dec_cpu_reqs
                           + o.encode_batcher.delta_cpu_reqs for o in osds)
        + sum(be.twin_routes for be in bes),
        "device_errors": sum(o.encode_batcher.device_errors for o in osds)
        + sum(be.device_errors for be in bes),
        "breaker_opens": EncodeBatcher._breaker_opens,
        "csum_device_errors": sum(getattr(o.store, "csum_device_errors", 0)
                                  for o in osds),
        "crclinear_host_fallbacks": crclinear.shared().host_fallbacks,
        "scrub_host_fallbacks": sum(be.scrub_host_fallbacks for be in bes),
        "delta_rmw_fallbacks": sum(be.delta_rmw_fallbacks for be in bes)}


def csum_report(c) -> dict:
    """BlueStore checksum batches per live OSD: (on the card, host loop)."""
    return {i: (o.store.csum_device_batches,
                o.store.csum_batches - o.store.csum_device_batches)
            for i, o in live_osds(c)}


def wait_all(comps, what: str, timeout: float) -> list:
    """Wait for every completion; fail on any result but 0."""
    bad = []
    for i, cp in enumerate(comps):
        if cp.wait(timeout) != 0:
            bad.append((i, cp.result))
    if bad:
        raise AssertionError(f"cluster {what}: {len(bad)} ops failed, first "
                             f"{bad[:4]}")
    return comps


def read_all(io, names, blobs, what: str, timeout: float) -> float:
    """Read every object back through a deep aio queue; each must be
    byte-equal to ``blobs``.  Returns the host-to-host seconds."""
    t0 = time.monotonic()
    comps = wait_all([io.aio_read(n, len(b)) for n, b in zip(names, blobs)],
                     what, timeout)
    wall = time.monotonic() - t0
    for i, cp in enumerate(comps):
        if bytes(cp.reply.out_data[0]) != blobs[i]:
            raise AssertionError(f"cluster {what}: object {i} differs")
    return wall


def check_shards(c, ecutil, GHObject, pgs, names, blobs, sinfo,
                 codec, what: str) -> int:
    """Every shard of every object, read from the store of the OSD its
    acting set names, must equal ``codec``'s host encode; returns how
    many were read."""
    osdmap = c.mon.osdmap
    checked = 0
    for i, n in enumerate(names):
        _, _, acting, _ = osdmap.pg_to_up_acting_osds(pgs[n])
        want = ecutil.encode(sinfo, codec, blobs[i])
        for s, osd_id in enumerate(acting):
            got = bytes(c.stores[osd_id].read(f"{pgs[n]}s{s}",
                                              GHObject(n, s)))
            if got != bytes(want[s]):
                raise AssertionError(f"{what}: {n} shard {s} on osd."
                                     f"{osd_id} != jerasure")
            checked += 1
    return checked


MGR_MODULES = ["alerts", "balancer", "dashboard", "pg_autoscaler",
               "prometheus", "restful", "tuner"]
STRIPER_ENTS = 8           # striped entities of 16 MiB: 128 MiB in all,
STRIPER_BYTES = 16 << 20   # one object set of the default Layout() each
STRIPER_PATCH = (70_000, 5_000)   # (offset, length) of each overwrite
# the client services above the striper, on the crimson cluster
SERVICE_THREADS = 8        # client threads of each service step
RBD_WRITTEN = 128 << 20    # of the 1 GiB default image: 32 objects of 4 MiB
RBD_PATCH = 8 << 10        # an overwrite, two 4 KiB columns of one stripe:
                           # two rounds after the snapshot, one an object
RBD_SHRINK = 96 << 20      # the resize: objects 24-31 leave the head
RBD_SAMPLE = 4             # image objects whose every shard is checked
SHARD_SAMPLE = 8           # data objects whose every shard is checked
FS_DIRS = 4
FS_FILES = 32              # files of 4 MiB: 128 MiB, the default layout
FS_FILE_BYTES = 4 << 20
FS_UNLINKS = 4
RGW_PUTS = 16              # S3 PUTs of 4 MiB over HTTP
RGW_OBJ_BYTES = 4 << 20
RGW_PARTS = 3              # a multipart upload of 3 parts of 5 MiB
RGW_PART_BYTES = 5 << 20
RGW_RANGE = (1_000_000, 2_999_999)   # the ranged GET, inclusive


def mgr_modules(c) -> str:
    """The manager found and runs the reference's seven modules, and
    ``mgr module ls`` through the monitor answers with them."""
    found = sorted(c.mgr.modules.available)
    active = sorted(c.mgr.modules.active)
    if found != MGR_MODULES or active != MGR_MODULES:
        raise AssertionError(f"mgr modules: found {found}, active {active}")
    ret, rs, out = c.mon_command({"prefix": "mgr module ls"})
    if ret != 0 or sorted(out.get("enabled", ())) != MGR_MODULES:
        raise AssertionError(f"mgr module ls: {ret} {rs} {out}")
    host, port = c.mgr.http_addr
    return (f"mgr at http://{host}:{port}, tick "
            f"{c.mgr.conf['mgr_tick_interval']} s, modules active {active};"
            f" `mgr module ls` enabled {sorted(out['enabled'])}")


def mgr_scrape(c) -> str:
    """With no client I/O in flight: the OSDs' own ``perf dump`` of the
    batcher's encode calls, then two manager ticks, then the manager's
    prometheus scrape over HTTP, then the dumps again.  The dumps must
    not have moved, the scrape's total must equal theirs (and the
    batchers' own count), and the ec_device and ec_device_ledger
    families must be in it."""
    import re
    import urllib.request
    osds = live_osds(c)
    tick = c.mgr.conf["mgr_tick_interval"]

    def dumps():
        out = {}
        for i, o in osds:
            ret, rs, d = o._exec_command({"prefix": "perf dump"})
            if ret != 0:
                raise AssertionError(f"osd.{i} perf dump: {ret} {rs}")
            out[f"osd.{i}"] = d["osd"]["ec_batch_calls"]
        return out

    before = dumps()
    t_quiet = time.time()
    deadline = time.monotonic() + 60
    while True:              # every snapshot requested a tick after it
        with c.mgr.lock:
            req = {n: v["req_ts"] for n, v in c.mgr.daemon_perf.items()}
        if len(req) == len(osds) and min(req.values()) >= t_quiet + tick:
            break
        if time.monotonic() > deadline:
            raise AssertionError(f"mgr snapshots not refreshed: {req}")
        time.sleep(tick / 4)
    waited = time.time() - t_quiet
    host, port = c.mgr.http_addr
    ts = time.monotonic()
    body = urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                  timeout=60).read().decode()
    scrape_s = time.monotonic() - ts
    after = dumps()
    if after != before:
        raise AssertionError(f"encode calls moved while quiet: {before} -> "
                             f"{after}")
    got = {m.group(1): int(m.group(2)) for m in re.finditer(
        r'^ceph_osd_ec_batch_calls\{daemon="(osd\.\d+)"\} (\d+)$', body,
        re.M)}
    lanes = sum(o.encode_batcher.calls for _, o in osds)
    if got != after or sum(got.values()) != lanes:
        raise AssertionError(f"scrape {got} != perf dumps {after} (batchers"
                             f" {lanes})")
    fams = {fam: len(re.findall(rf"^# TYPE ceph_{fam}_(?!ledger_)", body,
                                re.M))
            for fam in ("ec_batcher", "ec_device", "ec_device_ledger")}
    if not all(fams.values()):
        raise AssertionError(f"families missing from the scrape: {fams}")
    cpu = {}
    for name, secs in thread_cpu().values():
        if name.startswith("mgr-"):
            cpu[name] = cpu.get(name, 0.0) + secs
    return (f"scrape of {len(body)} bytes, {body.count(chr(10))} lines, "
            f"{body.count('# TYPE')} families in {scrape_s:.4f} s, "
            f"{waited:.4f} s after the quiet moment; encode calls "
            f"{sum(got.values())} in the scrape = {sum(after.values())} in "
            f"the {len(osds)} OSDs' perf dumps = {lanes} in their batchers; "
            f"families ec_batcher {fams['ec_batcher']}, ec_device "
            f"{fams['ec_device']}, ec_device_ledger "
            f"{fams['ec_device_ledger']}; manager threads' CPU s since boot: "
            + ", ".join(f"{n} {v:.2f}" for n, v in sorted(cpu.items())))


def tuner_decisions(c, since: float) -> str:
    """The tuner module's decision ring, each with its time from
    ``since`` (the revive)."""
    ret, rs, out = c.mgr.modules.handle_command("tuner", {})
    if ret != 0:
        raise AssertionError(f"tuner module: {ret} {rs}")
    steps = "; ".join(
        f"{s['time'] - since:+.1f} s {s['action']} {s['old']} -> {s['new']}"
        f" (client burn {s['client_burn']}, recovery burn "
        f"{s['recovery_burn']}, applied {s['applied']})"
        for s in out["steps"]) or "none"
    return (f"mode {out['mode']}, recovery weight {out['recovery_wgt']} "
            f"(baseline {out['baseline_wgt']}), burn now client "
            f"{out['client_burn']} recovery {out['recovery_burn']}; "
            f"{len(out['steps'])} decisions: {steps}")


def sample_shards(c, ecutil, GHObject, jer, sinfo, pool_id, onames, blobs,
                  what: str) -> int:
    """check_shards over ``onames``, placed by the current map in the pool
    ``pool_id``."""
    osdmap = c.mon.osdmap
    pgs = {o: osdmap.object_locator_to_pg(o, pool_id) for o in onames}
    return check_shards(c, ecutil, GHObject, pgs, onames, blobs, sinfo, jer,
                        what)


def striper_entities(torch, gen):
    """STRIPER_ENTS entities of STRIPER_BYTES and their overwrites, made
    on the card from ``gen``."""
    ents = torch.randint(0, 256, (STRIPER_ENTS, STRIPER_BYTES),
                         dtype=torch.uint8, device=DEV, generator=gen)
    patches = torch.randint(0, 256, (STRIPER_ENTS, STRIPER_PATCH[1]),
                            dtype=torch.uint8, device=DEV, generator=gen)
    return ents.cpu().numpy(), patches.cpu().numpy()


def striper_step(c, ecutil, GHObject, jer, sinfo, io, pool_id, ents,
                 patches) -> tuple:
    """Each entity written through StripedIoCtx with the default Layout()
    over the k=8 m=4 pool (one writer thread an entity), read back;
    STRIPER_PATCH overwritten in each (the delta lane), read back; the
    size and layout xattrs and every object's size as the layout places
    them, and every shard of the first entity's first two objects equal
    to the jerasure encode.  -> (write seconds, the rest of the line)."""
    from concurrent.futures import ThreadPoolExecutor
    from ceph_tpu_torch.client.striper import Layout, StripedIoCtx, \
        object_name
    layout = Layout()
    sio = StripedIoCtx(io, layout)
    names = [f"vol.{i}" for i in range(len(ents))]
    n_objs = STRIPER_BYTES // layout.object_size
    per_set = layout.stripe_count * layout.object_size
    if STRIPER_BYTES != per_set:
        raise AssertionError("an entity must be one object set")
    off, n = STRIPER_PATCH
    with ThreadPoolExecutor(len(ents)) as ex:
        ts = time.monotonic()
        list(ex.map(lambda i: sio.write(names[i], ents[i].tobytes()),
                    range(len(ents))))
        wall = time.monotonic() - ts
        ts = time.monotonic()
        got = list(ex.map(sio.read, names))
        rw = time.monotonic() - ts
        for i, g in enumerate(got):
            if g != ents[i].tobytes():
                raise AssertionError(f"striper: {names[i]} read back differs")
        delta0 = sum(be.delta_rmw_ops for be in ec_backends(c))
        ts = time.monotonic()
        list(ex.map(lambda i: sio.write(names[i], patches[i].tobytes(),
                                        off), range(len(ents))))
        ow = time.monotonic() - ts
        delta = sum(be.delta_rmw_ops for be in ec_backends(c)) - delta0
        if delta != len(ents):
            raise AssertionError(f"striper overwrites: {delta} of "
                                 f"{len(ents)} on the delta lane")
        for i in range(len(ents)):
            ents[i][off:off + n] = patches[i]
        ts = time.monotonic()
        got = list(ex.map(sio.read, names))
        rw2 = time.monotonic() - ts
    for i, g in enumerate(got):
        if g != ents[i].tobytes():
            raise AssertionError(f"striper: {names[i]} differs after the "
                                 f"overwrite")
        size, lay = sio.stat(names[i])
        if size != STRIPER_BYTES or lay != layout:
            raise AssertionError(f"striper: {names[i]} stat {size} {lay}")
        for j in range(n_objs):
            osize = io.stat(object_name(names[i], j))[0]
            if osize != layout.object_size:
                raise AssertionError(f"striper: object {j} of {names[i]} "
                                     f"holds {osize} bytes")
    # object j of an entity holds block j of every stripe of the set
    blocks = ents[0].reshape(-1, layout.stripe_count, layout.stripe_unit)
    onames = [object_name(names[0], j) for j in (0, 1)]
    blobs = [blocks[:, j, :].tobytes() for j in (0, 1)]
    checked = sample_shards(c, ecutil, GHObject, jer, sinfo, pool_id, onames,
                            blobs, "striper")
    return wall, (f"; {len(ents)} entities of {STRIPER_BYTES} bytes with "
                  f"the default Layout() (stripe unit {layout.stripe_unit}, "
                  f"count {layout.stripe_count}, object {layout.object_size}"
                  f"), {n_objs} objects each; read back in {rw:.4f} s; "
                  f"{n} bytes at {off} overwritten in each in {ow:.4f} s, "
                  f"{delta} on the delta lane, read back in {rw2:.4f} s; "
                  f"every byte, size and layout as written; {checked} shards"
                  f" of {onames[0]} and {onames[1]} equal to the jerasure "
                  f"encode")


def class_calls(c, ecio) -> str:
    """Class calls on a replicated pool of size 3 from two clients: an
    exclusive lock held by one is busy for the other (16), shared locks,
    unlock, version set, inc and check (125 on a mismatch), a fence that
    refuses the fenced-out writer (1); a call on the EC pool is not
    supported (95).  Every code must be the reference's."""
    import json
    from ceph_tpu_torch.client.rados import RadosError
    ts = time.monotonic()
    c.create_pool("clspool", "replicated", size=3)
    c.wait_for_clean(120)
    ia, ib = (c.rados(timeout=60).open_ioctx("clspool") for _ in range(2))

    def call(io, oid, cls, method, **kv):
        return io.exec_cls(oid, cls, method,
                           json.dumps(kv).encode() if kv else b"")

    def errno_of(io, *a, **kv):
        try:
            call(io, *a, **kv)
        except RadosError as e:
            return e.errno
        return 0

    codes = {}
    call(ia, "img.header", "lock", "lock", name="excl", type="exclusive",
         owner="client.a", cookie="1")
    codes["exclusive lock held by the other client"] = errno_of(
        ib, "img.header", "lock", "lock", name="excl", type="exclusive",
        owner="client.b", cookie="2")
    for io, who in ((ia, "client.a"), (ib, "client.b")):
        call(io, "img.header", "lock", "lock", name="sh", type="shared",
             owner=who, tag="t")
    lockers = json.loads(call(ia, "img.header", "lock", "get_info",
                              name="sh"))["lockers"]
    codes["exclusive over two shared lockers"] = errno_of(
        ib, "img.header", "lock", "lock", name="sh", type="exclusive",
        owner="client.c")
    call(ia, "img.header", "lock", "unlock", name="excl", owner="client.a",
         cookie="1")
    call(ib, "img.header", "lock", "lock", name="excl", type="exclusive",
         owner="client.b", cookie="2")
    codes["unlock of a lock not held"] = errno_of(
        ia, "img.header", "lock", "unlock", name="excl", owner="client.a",
        cookie="1")
    call(ia, "img.version", "version", "set", ver=5)
    ver = json.loads(call(ib, "img.version", "version", "inc"))["ver"]
    call(ia, "img.version", "version", "check", ver=6)
    codes["version check mismatch"] = errno_of(
        ia, "img.version", "version", "check", ver=99)
    call(ia, "mds.journal", "fence", "set", epoch=3)
    call(ia, "mds.journal", "fence", "guarded_append", epoch=3,
         data="entry-1;")
    call(ib, "mds.journal", "fence", "guarded_append", epoch=4,
         data="entry-2;")
    codes["append by the fenced-out writer"] = errno_of(
        ia, "mds.journal", "fence", "guarded_append", epoch=3, data="late;")
    journal = ia.read("mds.journal")
    try:
        ecio.exec_cls("rbd_data.cl.0000000000000000", "version", "read")
        codes["class call on the EC pool"] = 0
    except RadosError as e:
        codes["class call on the EC pool"] = e.errno
    want = {"exclusive lock held by the other client": 16,
            "exclusive over two shared lockers": 16,
            "unlock of a lock not held": 2, "version check mismatch": 125,
            "append by the fenced-out writer": 1,
            "class call on the EC pool": 95}
    if codes != want or len(lockers) != 2 or ver != 6 \
            or journal != b"entry-1;entry-2;":
        raise AssertionError(f"class calls: {codes} (want {want}), shared "
                             f"lockers {sorted(lockers)}, version {ver}, "
                             f"journal {journal!r}")
    return (f"replicated pool clspool of size 3, two clients, in "
            f"{time.monotonic() - ts:.4f} s: errnos " + ", ".join(
                f"{k} {v}" for k, v in codes.items())
            + f"; shared lockers {sorted(lockers)}; version {ver}; journal "
            f"{journal!r}")


def rbd_step(torch, np, c, ecutil, GHObject, jer, sinfo, io, pool_id,
             gen) -> tuple:
    """One RBD image at the reference's defaults (rbd_default_size,
    rbd_default_order, feature layering) on the EC pool ``io``:
    RBD_WRITTEN of it written in object-size writes (SERVICE_THREADS
    writers), a snapshot, then two rounds of one RBD_PATCH overwrite an
    object at seeded stripes and columns: the first clones each object
    (copy on write, a barrier op: the full read-modify-write path), the
    second goes to the delta lane; the head and the snapshot read back
    whole, a shrink to RBD_SHRINK (the snapshot keeps what leaves the
    head), and every shard of RBD_SAMPLE seeded data objects equal to
    the jerasure encode.  -> (write seconds, the rest of the line)."""
    from concurrent.futures import ThreadPoolExecutor
    from ceph_tpu_torch.rbd import RBD, Image
    from ceph_tpu_torch.rbd.image import _data_oid
    RBD(io).create("vol")
    img = Image(io, "vol")
    osize = img.object_size
    if (img.size(), osize, img.header["features"]) != (
            c.conf["rbd_default_size"], 1 << c.conf["rbd_default_order"],
            ["layering"]):
        raise AssertionError(f"rbd: image {img.stat()} "
                             f"{img.header['features']}")
    n_objs = RBD_WRITTEN // osize
    data = torch.randint(0, 256, (RBD_WRITTEN,), dtype=torch.uint8,
                         device=DEV, generator=gen).cpu().numpy()
    rng = np.random.default_rng(SEED + 13)
    sw, su = sinfo.stripe_width, sinfo.chunk_size
    rounds = [[j * osize + int(rng.integers(0, osize // sw)) * sw
               + int(rng.integers(0, sinfo.k - RBD_PATCH // su + 1)) * su
               for j in range(n_objs)] for _ in range(2)]
    patches = rng.integers(0, 256, (2, n_objs, RBD_PATCH), dtype=np.uint8)
    with ThreadPoolExecutor(SERVICE_THREADS) as ex:
        ts = time.monotonic()
        list(ex.map(lambda j: img.write(
            j * osize, data[j * osize:(j + 1) * osize].tobytes()),
            range(n_objs)))
        wall = time.monotonic() - ts
        ts = time.monotonic()
        img.snap_create("s1")
        snap_s = time.monotonic() - ts
        snap = data.copy()
        ow, delta = [], []
        for r, offs in enumerate(rounds):
            delta0 = sum(be.delta_rmw_ops for be in ec_backends(c))
            ts = time.monotonic()
            list(ex.map(lambda j: img.write(offs[j],
                                            patches[r, j].tobytes()),
                        range(n_objs)))
            ow.append(time.monotonic() - ts)
            delta.append(sum(be.delta_rmw_ops for be in ec_backends(c))
                         - delta0)
            for j in range(n_objs):
                data[offs[j]:offs[j] + RBD_PATCH] = patches[r, j]
        view = Image(io, "vol", snap_name="s1")
        ts = time.monotonic()
        head = list(ex.map(lambda j: img.read(j * osize, osize),
                           range(n_objs)))
        old = list(ex.map(lambda j: view.read(j * osize, osize),
                          range(n_objs)))
        rt = time.monotonic() - ts
    for j in range(n_objs):
        if head[j] != data[j * osize:(j + 1) * osize].tobytes():
            raise AssertionError(f"rbd: head object {j} differs")
        if old[j] != snap[j * osize:(j + 1) * osize].tobytes():
            raise AssertionError(f"rbd: snapshot object {j} differs")
    clones = [len(io.list_snaps(_data_oid("vol", j))["clones"])
              for j in range(n_objs)]
    if delta[1] != n_objs or clones != [1] * n_objs:
        raise AssertionError(f"rbd overwrites: {delta} of {n_objs} on the "
                             f"delta lane, clones {clones}")
    ts = time.monotonic()
    img.resize(RBD_SHRINK)
    rs = time.monotonic() - ts
    head = Image(io, "vol")
    tail = head.read(RBD_SHRINK - osize, 2 * osize)
    kept = Image(io, "vol", snap_name="s1").read(RBD_SHRINK, osize)
    if head.size() != RBD_SHRINK or \
            tail != data[RBD_SHRINK - osize:RBD_SHRINK].tobytes() or \
            kept != snap[RBD_SHRINK:RBD_SHRINK + osize].tobytes():
        raise AssertionError(f"rbd resize: size {head.size()}, tail or "
                             f"snapshot differs")
    sample = sorted(int(j) for j in rng.choice(
        RBD_SHRINK // osize, RBD_SAMPLE, replace=False))
    checked = sample_shards(
        c, ecutil, GHObject, jer, sinfo, pool_id,
        [_data_oid("vol", j) for j in sample],
        [data[j * osize:(j + 1) * osize].tobytes() for j in sample], "rbd")
    return wall, (f"; image of {c.conf['rbd_default_size']} bytes, "
                  f"{osize}-byte objects, "
                  f"features {img.header['features']}, {n_objs} objects "
                  f"written; snapshot in {snap_s:.4f} s; {n_objs} overwrites "
                  f"of {RBD_PATCH} bytes cloning each object in {ow[0]:.4f} "
                  f"s ({delta[0]} on the delta lane), {n_objs} more in "
                  f"{ow[1]:.4f} s ({delta[1]} on the delta lane); head and "
                  f"snapshot read back in {rt:.4f} s, every "
                  f"byte as written; shrunk to {RBD_SHRINK} in {rs:.4f} s, "
                  f"the snapshot keeps the rest; {checked} shards of "
                  f"objects {sample} equal to the jerasure encode")


def cephfs_step(torch, np, c, ecutil, GHObject, jer, sinfo, pool,
                pool_id, gen) -> tuple:
    """An MDSDaemon with metadata on a new replicated pool of size 3 and
    data on the EC pool ``pool``, one MDSClient (the default layout):
    FS_FILES files of FS_FILE_BYTES in FS_DIRS directories written
    (SERVICE_THREADS writers) and read back, one directory renamed,
    FS_UNLINKS files unlinked, the listing checked, and every shard of
    SHARD_SAMPLE files' data objects equal to the jerasure encode.
    -> (write seconds, the rest of the line)."""
    from concurrent.futures import ThreadPoolExecutor
    from ceph_tpu_torch.client.striper import object_name
    from ceph_tpu_torch.fs.filesystem import _data_soid
    from ceph_tpu_torch.fs.mdsclient import MDSClient
    from ceph_tpu_torch.mds import MDSDaemon
    ts = time.monotonic()
    c.create_pool("fsmeta", "replicated", size=3)
    c.wait_for_clean(120)
    mds = MDSDaemon(c.mon_addr, "fsmeta", pool, conf=c.conf).start()
    boot = time.monotonic() - ts
    try:
        fs = MDSClient(c.rados(timeout=60), mds.my_addr, pool)
        files = torch.randint(0, 256, (FS_FILES, FS_FILE_BYTES),
                              dtype=torch.uint8, device=DEV,
                              generator=gen).cpu().numpy()
        dirs = [f"/d{i}" for i in range(FS_DIRS)]
        paths = [f"{dirs[i % FS_DIRS]}/f{i:02d}.bin" for i in range(FS_FILES)]
        for d in dirs:
            fs.mkdir(d)
        with ThreadPoolExecutor(SERVICE_THREADS) as ex:
            ts = time.monotonic()
            list(ex.map(lambda i: fs.write_file(paths[i], files[i].tobytes()),
                        range(FS_FILES)))
            wall = time.monotonic() - ts
            ts = time.monotonic()
            got = list(ex.map(fs.read_file, paths))
            rt = time.monotonic() - ts
        for i, g in enumerate(got):
            if g != files[i].tobytes():
                raise AssertionError(f"cephfs: {paths[i]} read back differs")
        ts = time.monotonic()
        moved = dirs[-1] + "r"
        fs.rename(dirs[-1], moved)
        paths = [p.replace(dirs[-1] + "/", moved + "/") for p in paths]
        dirs[-1] = moved
        for i in range(FS_UNLINKS):
            fs.unlink(paths[i])
        ns = time.monotonic() - ts
        want = {d: sorted(p.rsplit("/", 1)[1] for p in paths[FS_UNLINKS:]
                          if p.startswith(d + "/")) for d in dirs}
        have = {d: sorted(e["name"] for e in fs.listdir(d)) for d in dirs}
        top = sorted(e["name"] for e in fs.listdir("/"))
        if have != want or top != sorted(d[1:] for d in dirs):
            raise AssertionError(f"cephfs listing: {top} {have}")
        if fs.read_file(paths[-1]) != files[-1].tobytes():
            raise AssertionError("cephfs: a file differs after the rename")
        rng = np.random.default_rng(SEED + 14)
        sample = sorted(int(i) for i in rng.choice(
            range(FS_UNLINKS, FS_FILES), SHARD_SAMPLE, replace=False))
        onames = [object_name(_data_soid(fs.stat(paths[i])["ino"]), 0)
                  for i in sample]
        checked = sample_shards(c, ecutil, GHObject, jer, sinfo, pool_id,
                                onames, [files[i].tobytes() for i in sample],
                                "cephfs")
        applied = mds._applied
    finally:
        mds.shutdown()
    return wall, (f"; metadata pool fsmeta of size 3 and the MDS up in "
                  f"{boot:.4f} s; {FS_FILES} files of {FS_FILE_BYTES} bytes in"
                  f" {FS_DIRS} directories, read back in {rt:.4f} s, every "
                  f"byte as written; a directory renamed and {FS_UNLINKS} "
                  f"files unlinked in {ns:.4f} s, the listing as expected; "
                  f"{applied} mutations journaled; {checked} shards of "
                  f"{len(sample)} files' data objects equal to the jerasure "
                  f"encode")


def rgw_step(torch, c, gen) -> tuple:
    """An RGWServer on loopback over a new replicated pool of size 3:
    RGW_PUTS S3 PUTs of RGW_OBJ_BYTES over HTTP (SERVICE_THREADS
    clients), each etag the md5 of its bytes; GETs of each and one
    ranged GET, byte-equal; one multipart upload of RGW_PARTS parts of
    RGW_PART_BYTES whose etag is the S3 multipart md5.  -> (PUT
    seconds, the rest of the line)."""
    import hashlib
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor
    from ceph_tpu_torch.rgw.server import RGWServer
    ts = time.monotonic()
    c.create_pool("rgwpool", "replicated", size=3)
    c.wait_for_clean(120)
    srv = RGWServer(c.rados(timeout=60).open_ioctx("rgwpool")).start()
    boot = time.monotonic() - ts
    try:
        host, port = srv.addr
        base = f"http://{host}:{port}"

        def req(method, path, data=None, headers=None):
            r = urllib.request.Request(base + path, data=data, method=method,
                                       headers=headers or {})
            with urllib.request.urlopen(r, timeout=600) as resp:
                return resp.status, dict(resp.headers), resp.read()
        req("PUT", "/smoke")
        objs = torch.randint(0, 256, (RGW_PUTS, RGW_OBJ_BYTES),
                             dtype=torch.uint8, device=DEV,
                             generator=gen).cpu().numpy()
        keys = [f"/smoke/obj/{i:02d}.bin" for i in range(RGW_PUTS)]
        with ThreadPoolExecutor(SERVICE_THREADS) as ex:
            ts = time.monotonic()
            puts = list(ex.map(lambda i: req("PUT", keys[i],
                                             objs[i].tobytes()),
                               range(RGW_PUTS)))
            wall = time.monotonic() - ts
            ts = time.monotonic()
            gets = list(ex.map(lambda k: req("GET", k), keys))
            rt = time.monotonic() - ts
        for i, ((_, ph, _), (st, gh, body)) in enumerate(zip(puts, gets)):
            md5 = hashlib.md5(objs[i].tobytes()).hexdigest()
            if ph["ETag"].strip('"') != md5 or gh["ETag"].strip('"') != md5 \
                    or st != 200 or body != objs[i].tobytes():
                raise AssertionError(f"rgw: {keys[i]} etag or bytes differ")
        lo, hi = RGW_RANGE
        st, _, body = req("GET", keys[0], headers={"Range": f"bytes={lo}-{hi}"})
        if st != 206 or body != objs[0][lo:hi + 1].tobytes():
            raise AssertionError(f"rgw: ranged GET {st}, {len(body)} bytes")
        parts = torch.randint(0, 256, (RGW_PARTS, RGW_PART_BYTES),
                              dtype=torch.uint8, device=DEV,
                              generator=gen).cpu().numpy()
        ts = time.monotonic()
        _, _, xml = req("POST", "/smoke/big.bin?uploads", b"")
        uid = xml.decode().split("<UploadId>")[1].split("<")[0]
        etags = [req("PUT", f"/smoke/big.bin?uploadId={uid}&partNumber={n}",
                     parts[n - 1].tobytes())[1]["ETag"].strip('"')
                 for n in range(1, RGW_PARTS + 1)]
        cx = "".join(f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag>"
                     f"</Part>" for n, e in enumerate(etags, 1))
        _, _, done = req("POST", f"/smoke/big.bin?uploadId={uid}",
                         f"<CompleteMultipartUpload>{cx}"
                         f"</CompleteMultipartUpload>".encode())
        mp = time.monotonic() - ts
        want = hashlib.md5(b"".join(hashlib.md5(p.tobytes()).digest()
                                    for p in parts)).hexdigest() \
            + f"-{RGW_PARTS}"
        _, gh, body = req("GET", "/smoke/big.bin")
        if want not in done.decode() or gh["ETag"].strip('"') != want or \
                body != parts.tobytes():
            raise AssertionError(f"rgw multipart: etag {gh['ETag']} (want "
                                 f"{want}) or bytes differ")
    finally:
        srv.shutdown()
    return wall, (f"; pool rgwpool of size 3 and the gateway up in "
                  f"{boot:.4f} s; {RGW_PUTS} GETs in {rt:.4f} s and a ranged "
                  f"GET of {hi - lo + 1} bytes, every byte and etag as "
                  f"written; multipart of {RGW_PARTS} x {RGW_PART_BYTES} "
                  f"bytes in {mp:.4f} s, etag {want}")


def cluster_path(torch, np, registry, ecutil, counts, prefix: str,
                 n_objs: int, services: bool = False, **backend) -> dict:
    """Drive the port's Cluster: a mon, CL_OSDS OSDs (``backend`` is
    ``osd_backend=...`` or nothing, for the config default: crimson) on
    RAM BlueStores and a client, over the loopback-TCP messenger, with a
    k=8 m=4 `gpu` pool of CL_PG_NUM PGs.  Steps, on ``n_objs`` objects:
    writes of every object (then read back), two-column overwrites (the
    delta lane; then read back), degraded reads with osd.CL_LOST lost,
    its rebuild to clean (then every read and every shard, from the
    store of the OSD its acting set names, equal to the jerasure
    encode), a deep scrub of every PG, and CL_PKT_OBJS writes to a
    cauchy_good k=8 m=4 pool at packetsize 2048 (read back, every shard
    equal to jerasure's).  Each step runs with the launch counts zeroed
    just before it and must launch its kernel (B1; B2 for the packet
    pool); any twin route, device error, open breaker or counted host
    fallback fails the phase.  With ``services`` the cluster also runs
    the manager with its seven modules (``with_mgr=True``, the
    reference's vstart layout), and the phase adds the services above
    the OSD: after the writes the manager's prometheus scrape, held
    against the OSDs' own perf dumps (mgr_scrape); after the rebuild the
    tuner module's decisions; after the deep scrub a striper step on the
    k=8 m=4 pool (striper_step, which must launch B1), class calls on a
    replicated pool (class_calls), and the client services: an RBD image
    (rbd_step) and CephFS through an MDS (cephfs_step) on the k=8 m=4
    pool, each of which must launch B1, and the RGW gateway over HTTP on
    a replicated pool (rgw_step), which must make no batcher call.
    Returns the launches by step, keyed ``{prefix}_{step}``."""
    from ceph_tpu_torch.cluster import Cluster, test_config
    from ceph_tpu_torch.ops import crclinear
    from ceph_tpu_torch.osd.batcher import EncodeBatcher
    from ceph_tpu_torch.osd.ecbackend import ECBackend
    from ceph_tpu_torch.osd.osdmap import PGid
    from ceph_tpu_torch.store import GHObject
    from ceph_tpu_torch.utils.machine import machine_factor

    print(f"{prefix} phase on {card()} (nvidia-smi name, power limit)")
    profile = {"k": str(K), "m": str(M), "technique": "reed_sol_van"}
    secs = cluster_prewarm(registry, crclinear, profile)
    print(f"{prefix} prewarm of the k={K} m={M} shapes outside the daemons: "
          f"{secs:.4f} s")
    EncodeBatcher.reset_learning()
    EncodeBatcher.reset_breaker()
    factor = machine_factor()
    conf = cluster_conf(test_config, factor, **backend)
    sw = K * CL_STRIPE_UNIT
    sinfo = ecutil.StripeInfo(K, sw)
    obj_bytes = CL_OBJ_BYTES
    gen = torch.Generator(device=DEV).manual_seed(SEED + 9)
    objs = torch.randint(0, 256, (n_objs, obj_bytes), dtype=torch.uint8,
                         device=DEV, generator=gen).cpu().numpy()
    names = [f"rbd_data.cl.{i:016x}" for i in range(n_objs)]
    blobs = [o.tobytes() for o in objs]
    nbytes = objs.nbytes
    op_timeout = 600.0
    out = {}
    t0 = time.monotonic()
    c = Cluster(n_osds=CL_OSDS, conf=conf, store_kind="bluestore",
                with_mgr=services)
    try:
        c.start()
        for i in range(CL_OSDS):
            c.wait_for_osd_up(i, 60)
        if services:
            print(f"{prefix}: {mgr_modules(c)}")
        kinds = sorted({type(o).__name__ for _, o in live_osds(c)})
        reactors = {len(getattr(o, "reactors", ())) for _, o in live_osds(c)}
        c.create_ec_profile("k8m4", plugin="gpu", **profile)
        pool_id = c.create_pool("ecpool", "erasure",
                                erasure_code_profile="k8m4",
                                pg_num=CL_PG_NUM)
        ret, rs, _ = c.mon_command({"prefix": "osd pool set",
                                    "pool": "ecpool",
                                    "var": "allow_ec_overwrites",
                                    "val": "true"})
        if ret != 0:
            raise AssertionError(f"allow_ec_overwrites: {ret} {rs}")
        rados = c.rados(timeout=60 * factor)
        rados.op_timeout = op_timeout
        rados.wait_for_epoch(c.mon.osdmap.epoch, 30)
        io = rados.open_ioctx("ecpool")
        c.wait_for_clean(120)
        # the PGs' activation warms, then every batcher's own warm
        ECBackend.join_activation_warms()
        for _, o in live_osds(c):
            for t in list(o.encode_batcher._warm_threads):
                t.join()
        print(f"{prefix}: mon + {CL_OSDS} OSDs of class {kinds} "
              f"(reactors an OSD: {sorted(reactors)}) on RAM BlueStores, "
              f"pool {pool_id} k={K} m={M} plugin=gpu with {CL_PG_NUM} PGs,"
              f" stripe unit {CL_STRIPE_UNIT}, allow_ec_overwrites, "
              f"{n_objs} objects of {obj_bytes} bytes; up and clean in "
              f"{time.monotonic() - t0:.4f} s (machine factor "
              f"{factor:.3f}, heartbeat grace "
              f"{conf['osd_heartbeat_grace']:.1f} s)")
        watch = ReactorWatch(c)

        def step(key, name, fn, nb, kernel="B1"):
            """Run one step with the launch counts zeroed just before it;
            ``fn`` returns the seconds of the step's own timed part and
            the rest of its line.  Print the line; fail on any counted
            fault or a step without a launch of ``kernel``.  A step with
            ``kernel`` None runs on a replicated pool: it must make no
            batcher call and launch no packet kernel, and its B1
            launches are the BlueStores' checksum folds on the card."""
            lanes0 = cluster_lanes(c)
            folds0 = sum(dev for dev, _ in csum_report(c).values())
            cpu0, proc0 = thread_cpu(), os.times()
            watch.start()
            counts.reset()
            ts = time.monotonic()
            try:
                wall, extra = fn()
            finally:
                launches = counts.read()
                seen = watch.stop()
            cpu1, proc1 = thread_cpu(), os.times()
            span = time.monotonic() - ts
            busy = (proc1.user + proc1.system) - (proc0.user + proc0.system)
            d = lane_delta(lanes0, cluster_lanes(c))
            folds = sum(dev for dev, _ in csum_report(c).values()) - folds0
            faults = cluster_faults(c, crclinear, EncodeBatcher)
            rate = (f"{nb / 2**30:.3f} GiB in {wall:.4f} s host to host = "
                    f"{nb / 2**30 / wall:.3f} GiB/s" if nb else
                    f"{wall:.4f} s host to host")
            print(f"{prefix} {name}: {rate}; launches "
                  f"B1 {launches['B1']} B2 {launches['B2']} B3 "
                  f"{launches['B3']}; batcher calls/requests summed over "
                  f"the OSDs: encode {d['calls']}/{d['reqs']}, decode "
                  f"{d['dec_calls']}/{d['dec_reqs']}, delta "
                  f"{d['delta_calls']}/{d['delta_reqs']}; BlueStore checksum "
                  f"folds on the card {folds}{extra}")
            print(f"{prefix} {name} CPU: the process used {busy:.2f} s in "
                  f"the step's {span:.4f} s ({busy / span:.2f} cores); by "
                  f"thread family, s: {cpu_split(cpu0, cpu1)}")
            print(f"{prefix} {name} threads: {seen}")
            if any(faults.values()):
                raise AssertionError(f"{prefix} {name}: {faults}")
            if kernel is None:
                lanes = d["calls"] + d["dec_calls"] + d["delta_calls"]
                if lanes or launches["B2"] or launches["B3"] or \
                        (launches["B1"] and not folds):
                    raise AssertionError(f"{prefix} {name}: {lanes} batcher "
                                         f"calls, launches {launches}")
            elif launches[kernel] < 1:
                raise AssertionError(f"{prefix} {name}: {kernel} did not "
                                     f"launch")
            out[f"{prefix}_{key}"] = launches
            return wall

        # 1. writes: one deep aio queue from the client, then read back
        def writes():
            ts = time.monotonic()
            wait_all([io.aio_write_full(n, b) for n, b in zip(names, blobs)],
                     "writes", op_timeout)
            wall = time.monotonic() - ts
            counts_w = counts.read()["B1"]
            rw = read_all(io, names, blobs, "read back", op_timeout)
            return wall, (f"; then read back {len(names)} objects in "
                          f"{rw:.4f} s ({nbytes / 2**30 / rw:.3f} GiB/s, B1 "
                          f"launches {counts.read()['B1'] - counts_w}), every"
                          f" byte as written")
        step("write", "writes", writes, nbytes)
        if services:
            print(f"{prefix} mgr: {mgr_scrape(c)}")
        osdmap = c.mon.osdmap
        pgs = {names[i]: osdmap.object_locator_to_pg(names[i], pool_id)
               for i in range(n_objs)}
        primaries = {osdmap.pg_to_up_acting_osds(pg)[3]
                     for pg in pgs.values()}

        # 2. overwrites: 8 KiB on two data columns of one stripe each,
        #    the delta lane; then read back
        rng = np.random.default_rng(SEED + 10)
        patches = rng.integers(0, 256, (n_objs, 2 * CL_STRIPE_UNIT),
                               dtype=np.uint8)
        stripes = obj_bytes // sw
        offs = [(i % stripes) * sw + DELTA_COL * CL_STRIPE_UNIT
                for i in range(n_objs)]
        delta0 = sum(be.delta_rmw_ops for be in ec_backends(c))

        def overwrites():
            ts = time.monotonic()
            wait_all([io.aio_write(names[i], patches[i].tobytes(), offs[i])
                      for i in range(n_objs)], "overwrites", op_timeout)
            wall = time.monotonic() - ts
            ops = sum(be.delta_rmw_ops for be in ec_backends(c)) - delta0
            if ops != n_objs:
                raise AssertionError(f"{prefix} overwrites: {ops} of "
                                     f"{n_objs} on the delta lane")
            for i in range(n_objs):
                objs[i][offs[i]:offs[i] + patches.shape[1]] = patches[i]
                blobs[i] = objs[i].tobytes()
            counts_w = counts.read()["B1"]
            rw = read_all(io, names, blobs, "read back after overwrites",
                          op_timeout)
            return wall, (f"; {ops} of {n_objs} on the delta lane; then "
                          f"read back in {rw:.4f} s (B1 launches "
                          f"{counts.read()['B1'] - counts_w}), every byte as"
                          f" written")
        step("overwrite", "overwrites", overwrites, patches.nbytes)
        cs = csum_report(c)
        print(f"{prefix} BlueStore checksum batches by OSD (card, host "
              f"loop): " + ", ".join(f"osd.{i} {d}/{h}"
                                     for i, (d, h) in cs.items())
              + f"; primaries of written PGs: {sorted(primaries)}")
        cold = [i for i in primaries if cs.get(i, (0, 0))[0] == 0]
        if cold:
            raise AssertionError(f"{prefix}: primaries {cold} never "
                                 f"checksummed on the card")

        # 3. degraded reads: osd.CL_LOST killed with its data
        ts = time.monotonic()
        c.kill_osd(CL_LOST, lose_data=True)
        c.wait_for_osd_down(CL_LOST, 120)
        down_s = time.monotonic() - ts

        def degraded():
            rw = read_all(io, names, blobs, "degraded reads", op_timeout)
            return rw, (f"; osd.{CL_LOST} killed with its data, marked down"
                        f" in {down_s:.4f} s before; every byte as written")
        step("degraded", "degraded reads", degraded, nbytes)

        # 4. rebuild: revive osd.CL_LOST empty, wait for clean
        mine = set()             # (object, shard) on osd.CL_LOST

        def rebuild():
            ts = time.monotonic()
            c.revive_osd(CL_LOST)
            c.wait_for_osd_up(CL_LOST, 120)
            c.wait_for_clean(900)
            wall = time.monotonic() - ts
            store, held = c.stores[CL_LOST], 0
            for coll in store.list_collections():
                for obj in store.collection_list(coll):
                    if obj.oid in pgs:
                        held += store.stat(coll, obj).size
                        mine.add((obj.oid, obj.shard))
            return wall, (f"; osd.{CL_LOST} holds {len(mine)} shards, "
                          f"{held} bytes, after clean: {held / wall / 1e6:.3f}"
                          f" MB/s of rebuilt shard bytes from revive to "
                          f"clean")
        t_rebuild = time.time()
        step("rebuild", "rebuild", rebuild, 0)
        if services:
            print(f"{prefix} tuner: {tuner_decisions(c, t_rebuild)}")
        if not mine:
            raise AssertionError(f"{prefix} rebuild: osd.{CL_LOST} holds "
                                 f"no shard")
        rw = read_all(io, names, blobs, "read after rebuild", op_timeout)
        jer = registry.instance().factory("jerasure", {"k": str(K),
                                                       "m": str(M)})
        checked = check_shards(c, ecutil, GHObject, pgs, names, blobs, sinfo,
                               jer, f"{prefix} rebuild")
        osdmap = c.mon.osdmap
        for n in names:
            _, _, acting, _ = osdmap.pg_to_up_acting_osds(pgs[n])
            if CL_LOST in acting and \
                    (n, acting.index(CL_LOST)) not in mine:
                raise AssertionError(f"{prefix} rebuild: {n} missing on "
                                     f"osd.{CL_LOST}")
        print(f"{prefix} after rebuild: every object read back in "
              f"{rw:.4f} s; {checked} shards read from the OSD each acting "
              f"set names, each equal to the jerasure encode")

        # 5. deep scrub of every PG through the monitor
        def scrub():
            ts, t_wall = time.monotonic(), time.time()
            pgids = [str(PGid(pool_id, s)) for s in range(CL_PG_NUM)]
            for pg in pgids:
                ret, rs, _ = c.mon_command({"prefix": "pg deep-scrub",
                                            "pgid": pg})
                if ret != 0:
                    raise AssertionError(f"pg deep-scrub {pg}: {ret} {rs}")
            deadline = time.monotonic() + 600
            while True:
                ret, _, dump = c.mon_command({"prefix": "pg dump"})
                stats = dump.get("pg_stats", {}) if ret == 0 else {}
                done = [p for p in pgids if stats.get(p, {}).get(
                    "last_deep_scrub", 0) >= t_wall]
                if len(done) == len(pgids):
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"deep scrub: {len(done)} of "
                                         f"{len(pgids)} PGs done")
                time.sleep(0.2)
            bad = {p: (stats[p].get("num_scrub_errors"),
                       stats[p].get("inconsistent"))
                   for p in pgids if stats[p].get("num_scrub_errors")
                   or stats[p].get("inconsistent")}
            if bad:
                raise AssertionError(f"deep scrub inconsistencies: {bad}")
            return time.monotonic() - ts, (f"; {len(pgids)} PGs "
                                           f"deep-scrubbed, no "
                                           f"inconsistency")
        step("scrub", "deep scrub", scrub, nbytes * (K + M) // K)
        cs = csum_report(c)
        print(f"{prefix} BlueStore checksum batches by OSD at the end "
              f"(card, host loop): " + ", ".join(f"osd.{i} {d}/{h}"
                                                 for i, (d, h) in cs.items()))
        if services:
            ents, patches = striper_entities(torch, gen)
            step("striper", "striper", lambda: striper_step(
                c, ecutil, GHObject, jer, sinfo, io, pool_id, ents,
                patches), ents.nbytes)
            print(f"{prefix} classes: {class_calls(c, io)}")
            step("rbd", "rbd", lambda: rbd_step(
                torch, np, c, ecutil, GHObject, jer, sinfo, io, pool_id,
                gen), RBD_WRITTEN)
            step("cephfs", "cephfs", lambda: cephfs_step(
                torch, np, c, ecutil, GHObject, jer, sinfo, "ecpool",
                pool_id, gen), FS_FILES * FS_FILE_BYTES)
            step("rgw", "rgw", lambda: rgw_step(torch, c, gen),
                 RGW_PUTS * RGW_OBJ_BYTES, kernel=None)

        # 6. a cauchy_good k=8 m=4 pool at packetsize 2048: B2's lane
        pprofile = {"k": str(K), "m": str(M), "technique": "cauchy_good",
                    "packetsize": "2048"}
        pcodec = registry.instance().factory("gpu", dict(pprofile))
        psinfo = ecutil.StripeInfo(K, K * CL_PKT_STRIPE_UNIT)
        if pcodec.get_chunk_size(psinfo.stripe_width) != CL_PKT_STRIPE_UNIT:
            raise AssertionError("packet pool: stripe unit not aligned")
        c.create_ec_profile("cg84", plugin="gpu",
                            stripe_unit=str(CL_PKT_STRIPE_UNIT), **pprofile)
        ppool = c.create_pool("cgpool", "erasure",
                              erasure_code_profile="cg84",
                              pg_num=CL_PKT_PG_NUM)
        rados.wait_for_epoch(c.mon.osdmap.epoch, 30)
        pio = rados.open_ioctx("cgpool")
        c.wait_for_clean(120)
        ECBackend.join_activation_warms()
        pobjs = torch.randint(0, 256, (CL_PKT_OBJS, obj_bytes),
                              dtype=torch.uint8, device=DEV,
                              generator=gen).cpu().numpy()
        pnames = [f"rbd_data.cg.{i:016x}" for i in range(CL_PKT_OBJS)]
        pblobs = [o.tobytes() for o in pobjs]

        def packet():
            ts = time.monotonic()
            wait_all([pio.aio_write_full(n, b)
                      for n, b in zip(pnames, pblobs)],
                     "cauchy_good writes", op_timeout)
            wall = time.monotonic() - ts
            rw = read_all(pio, pnames, pblobs, "cauchy_good read back",
                          op_timeout)
            posdmap = c.mon.osdmap
            ppgs = {n: posdmap.object_locator_to_pg(n, ppool)
                    for n in pnames}
            pjer = registry.instance().factory("jerasure", dict(pprofile))
            n_sh = check_shards(c, ecutil, GHObject, ppgs, pnames, pblobs,
                                psinfo, pjer, f"{prefix} cauchy_good")
            return wall, (f"; pool {ppool} cauchy_good k={K} m={M} "
                          f"packetsize 2048 with {CL_PKT_PG_NUM} PGs, stripe "
                          f"unit {CL_PKT_STRIPE_UNIT}; read back in "
                          f"{rw:.4f} s, every byte as written; {n_sh} shards "
                          f"equal to the jerasure encode")
        step("packet", "cauchy_good writes", packet, pobjs.nbytes,
             kernel="B2")
    finally:
        c.stop()
    return out


# tools phase: the port's tools through the entry points a user runs
# (ceph_tpu_torch/tools): ec_benchmark's arguments by sub-phase, with
# the kernel each must launch
BENCH_RUNS = (
    ("ec_benchmark_encode", "B1", ["-p", "gpu", "-P",
                                   "k=8,m=4,technique=reed_sol_van", "-S",
                                   "67108864", "-i", "8", "-w", "encode"]),
    ("ec_benchmark_decode", "B1", ["-p", "gpu", "-P",
                                   "k=8,m=4,technique=reed_sol_van", "-S",
                                   "67108864", "-i", "8", "-w", "decode",
                                   "-e", "4"]),
    ("ec_benchmark_packet", "B2", ["-p", "gpu", "-P",
                                   "k=10,m=4,technique=cauchy_good,"
                                   "packetsize=2048", "-S", "67108864",
                                   "-i", "4", "-w", "encode"]),
    ("ec_benchmark_ragged", "B3", ["-p", "gpu", "-P",
                                   "k=10,m=4,technique=cauchy_good,"
                                   "packetsize=1000", "-S", "67108864",
                                   "-i", "4", "-w", "encode"]))
TOOL_FILE_BYTES = 16 << 20   # the file ec_tool encodes and decodes
SWEEP_ARGS = ["--plugins", "gpu", "--workloads", "encode,decode", "--size",
              "16777216", "-i", "3"]
VSTART_OSDS = 3
VSTART_UP_S = 180            # the monitor address must appear by then
VSTART_EXIT_S = 60           # and the process end this long after SIGTERM
VSTART_OBJS = 16             # rados put/get of 4 MiB objects
VSTART_OBJ_BYTES = 4 << 20
VSTART_BENCH_S = 5           # rados bench write, then seq
VSTART_IMAGE_BYTES = 16 << 20    # rbd import on a replicated pool
VSTART_FILE_BYTES = 4 << 20      # cephfs put on the EC pool


def tool_out(main, argv) -> tuple:
    """(return code, standard output) of one tool's ``main(argv)``."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def vstart_path(np, gen, scratch: str, logs: str) -> str:
    """``python -m ceph_tpu_torch.tools.vstart -n VSTART_OSDS --ec-pool
    --mgr --rgw`` as a process of its own (its output into ``logs``),
    then, through the CLIs' ``main(argv)`` over TCP: ``ceph status``,
    ``allow_ec_overwrites`` on its k=2 m=1 `gpu` pool, rados put and get
    of VSTART_OBJS objects (read back equal), ``rados bench`` write and
    seq with no error, rbd import, snapshot, clone and export on a
    replicated pool (equal), cephfs put and get with data on the EC pool
    (equal), and ``ceph tell osd.N perf dump`` of every OSD: the
    batchers' encode calls above 0, no twin route and no device error,
    the evidence that B1 ran in vstart's process.  SIGTERM must end it
    with exit code 0 within VSTART_EXIT_S.  -> the step's line."""
    from ceph_tpu_torch.tools import (ceph_cli, cephfs_cli, rados_cli,
                                      rbd_cli)
    addr_file = os.path.join(scratch, "mon.addr")
    log_path = os.path.join(logs, "vstart.log")
    # the batchers' route pinned to the card, by the config's own
    # environment override: a twin route must show as one, not as a
    # learned crossover
    env = dict(os.environ, PYTHONPATH=HERE, CEPH_TPU_EC_TPU_FALLBACK_CPU="0")
    t0 = time.monotonic()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ceph_tpu_torch.tools.vstart", "-n",
             str(VSTART_OSDS), "--ec-pool", "--mgr", "--rgw", "--out-conf",
             addr_file], cwd=HERE, env=env, stdout=log,
            stderr=subprocess.STDOUT)
    try:
        while not (os.path.exists(addr_file)
                   and open(addr_file).read().strip()):
            if proc.poll() is not None:
                raise AssertionError(f"vstart exited {proc.returncode} "
                                     f"before it came up (see {log_path})")
            if time.monotonic() - t0 > VSTART_UP_S:
                raise AssertionError(f"vstart not up in {VSTART_UP_S} s")
            time.sleep(0.2)
        up_s = time.monotonic() - t0
        mon = open(addr_file).read().strip()

        def ceph(*words):
            rc, out = tool_out(ceph_cli.main, ["-m", mon, "--format", "json",
                                               *words])
            if rc != 0:
                raise AssertionError(f"ceph {' '.join(words)}: rc {rc}")
            return json.loads(out) if out.strip() else {}

        def tool(main, *argv):
            rc, out = tool_out(main, ["-m", mon, *argv])
            if rc != 0:
                raise AssertionError(f"{main.__module__} {argv}: rc {rc}")
            return out

        st = ceph("status")
        if st["osdmap"]["num_up_osds"] != VSTART_OSDS:
            raise AssertionError(f"vstart status: {st['osdmap']}")
        prof = ceph("osd", "erasure-code-profile", "get", "gpuprof")
        if prof.get("plugin") != "gpu" or "device" in prof:
            raise AssertionError(f"vstart profile: {prof}")
        ceph("osd", "pool", "set", "ecpool", "allow_ec_overwrites", "true")
        ceph("osd", "pool", "create", "rbdp", "8", "replicated", "--size",
             str(VSTART_OSDS))
        ceph("osd", "pool", "create", "fsmeta", "8", "replicated", "--size",
             str(VSTART_OSDS))
        blobs = [np.asarray(gen.integers(0, 256, VSTART_OBJ_BYTES,
                                         dtype=np.uint8)).tobytes()
                 for _ in range(VSTART_OBJS)]
        ts = time.monotonic()
        for i, blob in enumerate(blobs):
            path = os.path.join(scratch, f"put.{i}")
            with open(path, "wb") as f:
                f.write(blob)
            tool(rados_cli.main, "-p", "ecpool", "put", f"obj.{i}", path)
        put_s = time.monotonic() - ts
        ts = time.monotonic()
        for i, blob in enumerate(blobs):
            path = os.path.join(scratch, f"get.{i}")
            tool(rados_cli.main, "-p", "ecpool", "get", f"obj.{i}", path)
            with open(path, "rb") as f:
                if f.read() != blob:
                    raise AssertionError(f"rados get obj.{i} differs")
        get_s = time.monotonic() - ts
        bench = {}
        for mode in ("write", "seq"):
            bench[mode] = json.loads(tool(
                rados_cli.main, "-p", "ecpool", "bench", str(VSTART_BENCH_S),
                mode, *(["--no-cleanup"] if mode == "write" else []),
                "--format", "json"))
            if bench[mode]["errors"] or not bench[mode]["total_ops"]:
                raise AssertionError(f"rados bench {mode}: {bench[mode]}")
        image = os.path.join(scratch, "disk.img")
        with open(image, "wb") as f:
            f.write(np.asarray(gen.integers(0, 256, VSTART_IMAGE_BYTES,
                                            dtype=np.uint8)).tobytes())
        ts = time.monotonic()
        tool(rbd_cli.main, "-p", "rbdp", "import", image, "img")
        tool(rbd_cli.main, "-p", "rbdp", "snap", "create", "img@s1")
        tool(rbd_cli.main, "-p", "rbdp", "clone", "img@s1", "child")
        tool(rbd_cli.main, "-p", "rbdp", "export", "child", image + ".out")
        rbd_s = time.monotonic() - ts
        with open(image, "rb") as a, open(image + ".out", "rb") as b:
            if a.read() != b.read():
                raise AssertionError("rbd export of the clone != import")
        local = os.path.join(scratch, "file.bin")
        with open(local, "wb") as f:
            f.write(np.asarray(gen.integers(0, 256, VSTART_FILE_BYTES,
                                            dtype=np.uint8)).tobytes())
        fs = ["--meta-pool", "fsmeta", "--data-pool", "ecpool"]
        ts = time.monotonic()
        tool(cephfs_cli.main, *fs, "mkdir", "/tools")
        tool(cephfs_cli.main, *fs, "put", local, "/tools/file.bin")
        tool(cephfs_cli.main, *fs, "get", "/tools/file.bin", local + ".out")
        fs_s = time.monotonic() - ts
        with open(local, "rb") as a, open(local + ".out", "rb") as b:
            if a.read() != b.read():
                raise AssertionError("cephfs get != put")
        calls = twins = errors = 0
        for osd in range(VSTART_OSDS):
            d = ceph("tell", f"osd.{osd}", "perf", "dump")
            calls += d["osd"]["ec_batch_calls"]
            twins += d["ec_batcher"]["cpu_reqs"]
            errors += d["ec_batcher"]["device_errors"]
        if calls < 1 or twins or errors:
            raise AssertionError(f"vstart OSDs' perf dumps: encode calls "
                                 f"{calls}, twin routes {twins}, device "
                                 f"errors {errors}")
    finally:
        ts = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(VSTART_EXIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise AssertionError(f"vstart did not exit {VSTART_EXIT_S} s "
                                 f"after SIGTERM")
    exit_s = time.monotonic() - ts
    if rc != 0:
        raise AssertionError(f"vstart exited {rc} on SIGTERM (see "
                             f"{log_path})")
    nb = VSTART_OBJS * VSTART_OBJ_BYTES
    return (f"vstart up in {up_s:.4f} s; rados put {VSTART_OBJS} x "
            f"{VSTART_OBJ_BYTES} in {put_s:.4f} s "
            f"({nb / 2**30 / put_s:.3f} GiB/s, one CLI call and client "
            f"an object), get in {get_s:.4f} s, every byte as written; rados "
            f"bench {VSTART_BENCH_S} s write: {bench['write']['total_ops']} "
            f"ops, {bench['write']['bandwidth_mb_sec']} MB/s, seq: "
            f"{bench['seq']['total_ops']} ops, "
            f"{bench['seq']['bandwidth_mb_sec']} MB/s, errors 0; rbd "
            f"import, snapshot, clone, export of {VSTART_IMAGE_BYTES} "
            f"bytes in {rbd_s:.4f} s, equal; cephfs put and get of "
            f"{VSTART_FILE_BYTES} bytes on the EC pool in {fs_s:.4f} s, "
            f"equal; the OSDs' perf dumps: encode calls {calls}, twin "
            f"routes 0, device errors 0; exit 0 {exit_s:.4f} s after "
            f"SIGTERM")


def tools_path(np, registry, counts) -> dict:
    """The port's tools on the card, each through the entry point a user
    runs, each sub-phase with the launch counts zeroed just before it:
    ec_benchmark (BENCH_RUNS) in-process through ``main(argv)``, each
    line printed with bench.sh's GB/s and the card, then the tool's own
    payload encoded through `gpu` and through jerasure, chunks equal;
    ``ec_non_regression --check`` of the committed corpus (9 configs,
    exact; the `gpu` entry reads ``tpu_k=8_m=4``); ``ec_tool`` encode and
    decode of a TOOL_FILE_BYTES file with 4 chunks deleted; the
    ``bench_sweep`` of SWEEP_ARGS, all 12 rows; and vstart_path.
    -> the launches by sub-phase, keyed ``tools_{name}``."""
    import random
    import shutil
    from ceph_tpu_torch.tools import (bench_sweep, ec_benchmark,
                                      ec_non_regression, ec_tool)
    where = card()
    scratch = os.path.join(HERE, "build", "chip_smoke_tools")
    logs = os.path.join(HERE, "chiprun_out")
    shutil.rmtree(scratch, ignore_errors=True)
    os.makedirs(scratch)
    os.makedirs(logs, exist_ok=True)
    gen = np.random.default_rng(SEED + 14)
    out = {}

    def sub(name, fn):
        counts.reset()
        ts = time.monotonic()
        try:
            line = fn()
        finally:
            out[f"tools_{name}"] = launches = counts.read()
        print(f"tools {name}: {time.monotonic() - ts:.4f} s; launches "
              f"B1 {launches['B1']} B2 {launches['B2']} B3 "
              f"{launches['B3']}; {line}")

    for name, _, argv in BENCH_RUNS:
        def bench(argv=argv):
            rc, text = tool_out(ec_benchmark.main, argv)
            lines = text.splitlines()
            if rc != 0 or len(lines) != 1:
                raise AssertionError(f"ec_benchmark {argv}: rc {rc} {text!r}")
            secs, kib = lines[0].split("\t")
            return (f"ec_benchmark {' '.join(argv)}: {lines[0]!r} = "
                    f"{int(kib) / 2**20 / float(secs):.4f} GB/s by bench.sh's "
                    f"KiB / 2^20 / s, on {where}")
        sub(name, bench)
    size = int(BENCH_RUNS[0][2][BENCH_RUNS[0][2].index("-S") + 1])
    data = random.Random(42).randbytes(size)
    profile = {"k": str(K), "m": str(M), "technique": "reed_sol_van"}
    gpu = registry.instance().factory("gpu", dict(profile))
    jer = registry.instance().factory("jerasure", dict(profile))
    want = set(range(K + M))
    got, ref = gpu.encode(want, data), jer.encode(want, data)
    if sorted(got) != sorted(ref) or any(bytes(got[i]) != bytes(ref[i])
                                         for i in ref):
        raise AssertionError("ec_benchmark's payload: gpu chunks != jerasure")
    print(f"tools: ec_benchmark's payload of {size} bytes encoded through "
          f"gpu equals jerasure's, {K + M} chunks")

    def corpus():
        rc, text = tool_out(ec_non_regression.main, [
            "--check", "--base", os.path.join(HERE, "corpus"), "-v"])
        if rc != 0 or "corpus ok: 9 configs" not in text:
            raise AssertionError(f"corpus check: rc {rc} {text!r}")
        if f"ok {os.path.join(HERE, 'corpus', 'tpu_k=8_m=4')} " not in text:
            raise AssertionError(f"corpus: no gpu entry read {text!r}")
        return text.strip().splitlines()[-1]
    sub("corpus", corpus)

    def tool_roundtrip():
        path = os.path.join(scratch, "obj.bin")
        blob = np.asarray(gen.integers(0, 256, TOOL_FILE_BYTES,
                                       dtype=np.uint8)).tobytes()
        with open(path, "wb") as f:
            f.write(blob)
        prof = f"plugin=gpu,k={K},m={M}"
        rc, enc = tool_out(ec_tool.main, ["encode", prof, "4096", "all",
                                          path])
        if rc != 0:
            raise AssertionError(f"ec_tool encode: rc {rc}")
        for i in ERASED:
            os.unlink(f"{path}.{i}")
        rc, dec = tool_out(ec_tool.main, ["decode", prof, "4096", "all",
                                          path])
        with open(path + ".decoded", "rb") as f:
            got = f.read()
        if rc != 0 or got[:len(blob)] != blob or any(got[len(blob):]):
            raise AssertionError(f"ec_tool decode: rc {rc}, output differs")
        return (f"ec_tool {prof}: {enc.strip()}; chunks {list(ERASED)} "
                f"deleted; {dec.strip()}, equal to the input")
    sub("ec_tool", tool_roundtrip)

    def sweep():
        rc, text = tool_out(bench_sweep.main, SWEEP_ARGS)
        rows = [json.loads(ln) for ln in text.splitlines() if ln.strip()]
        got = sorted((r["k"], r["m"], r["workload"]) for r in rows)
        want_rows = sorted((int(k), int(m), w)
                           for k, m in (km.split("/")
                                        for km in bench_sweep.DEFAULT_KM)
                           for w in ("encode", "decode"))
        if rc != 0 or got != want_rows:
            raise AssertionError(f"bench_sweep: rc {rc}, rows {got}")
        return (f"bench_sweep {' '.join(SWEEP_ARGS)}: {len(rows)} rows, GB/s "
                + ", ".join(f"{r['k']}/{r['m']} {r['workload']} "
                            f"{r['gbps']}" for r in rows))
    sub("bench_sweep", sweep)
    sub("vstart", lambda: vstart_path(np, gen, scratch, logs))
    shutil.rmtree(scratch, ignore_errors=True)
    return out


# mesh phase: a dp x sp mesh of MESH_SHARDS logical shards of the card,
# driven in a child process that sets CEPH_TPU_TORCH_FORCE_DEVICE_COUNT
# (the port's counterpart of XLA's forced host device count), so the
# parent's one-card state stays untouched
MESH_SHARDS = 4            # dp=2 x sp=2, device ids 0-3
MESH_INFO = {"dp": 2, "sp": 2, "n_devices": MESH_SHARDS,
             "device_ids": list(range(MESH_SHARDS))}
MESH_ODD = 5               # stripes of the dispatch that needs dp padding
MESH_OPS = 64              # batcher writes of 4 MiB, 256 MiB in all
MESH_CHILD_S = 240         # the child is killed past this


class _Since:
    """A launch counter for run_lane that leaves the module's running
    count alone: read() is the launches since the last reset()."""

    def __init__(self, mod):
        self.mod = mod
        self.base = mod.launches

    def reset(self) -> None:
        self.base = self.mod.launches

    def read(self) -> dict:
        return {"B1": self.mod.launches - self.base, "B2": 0, "B3": 0}


def _digest(np, parity, bits: bool) -> int:
    """The JAX package's digest of a whole parity array: its set bits
    (or bytes) summed modulo 2^32, times 2654435761, modulo 2^32."""
    s = int(np.unpackbits(parity).sum()) if bits else \
        int(parity.astype(np.uint64).sum())
    return (s % 2**32) * 2654435761 % 2**32


def mesh_child() -> int:
    """The mesh phase, run as ``chip_smoke.py --mesh-child`` with
    CEPH_TPU_TORCH_FORCE_DEVICE_COUNT=MESH_SHARDS; everything on the
    card, dp=2 x sp=2, every output byte-exact:
      1. resolve_mesh() and the shared backend's mesh_info() give the
         expected mesh;
      2. the `gpu` plugin's async entries at the headline shape (k=8 m=4
         reed_sol_van, [512, 8, 131072], 512 MiB a dispatch): encode, the
         (1, 5, 9, 11) decode, the 2-column delta and an encode of
         MESH_ODD stripes (dp padding), each one dispatch of one B1
         launch a shard with one ledger lane a shard, each equal to the
         same call with configure_mesh(1, 0) (one launch) and to B1's
         plain version on a slice;
      3. an EncodeBatcher built as in phase 5 takes MESH_OPS writes of 4
         MiB from BATCH_THREADS threads, equal to its CPU twin, with no
         twin route, device error or open breaker, its dump's mesh 2 x 2
         and its ledger lanes 0-3;
      4. sharded_encode_fn at w = 8, 16 and 32 and sharded_encode_gf8_fn
         with their digests, ShardedEncoder and shared_encoder, on small
         shapes, against NumpyBackend;
      5. dryrun_multichip(MESH_SHARDS, "cuda");
    then times the sharded headline encode (CUDA events, median of 20)
    beside single-device B1 at the same shape.  Prints one JSON line
    {"mesh": {...}} with its launches; exits non-zero on any failure."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        return fail("CUDA is not available")
    sys.path.insert(0, HERE)
    from ceph_tpu_torch.ec import registry
    from ceph_tpu_torch.ops import carry, engine, gf8_kernel, matrix
    from ceph_tpu_torch.osd import ecutil
    from ceph_tpu_torch.parallel import dryrun
    from ceph_tpu_torch.parallel import mesh as pmesh
    t_start = time.monotonic()
    report = {"dispatch_launches": {}}
    try:
        # 1. the mesh
        mesh = pmesh.resolve_mesh(device=DEV)
        codec = registry.instance().factory(
            "gpu", {"k": str(K), "m": str(M), "technique": "reed_sol_van",
                    "device": DEV})
        be = codec.core.backend
        for what, info in (("resolve_mesh()", pmesh.mesh_info(mesh)),
                           ("the backend", be.mesh_info())):
            if info != MESH_INFO:
                raise AssertionError(f"{what}: mesh {info}, not {MESH_INFO}")
        print(f"mesh: {mesh} from {pmesh.FORCE_DEVICE_COUNT}="
              f"{os.environ.get(pmesh.FORCE_DEVICE_COUNT)}, "
              f"{torch.cuda.get_device_name(0)}, "
              f"{time.monotonic() - t_start:.1f} s after start")

        # 2. the headline async entries, sharded and single-device
        gen = torch.Generator(device=DEV).manual_seed(SEED + 17)

        def rand(*shape):
            return torch.randint(0, 256, shape, dtype=torch.uint8,
                                 device=DEV, generator=gen).cpu().numpy()

        d1, delta = rand(STRIPES, K, CHUNK), rand(STRIPES, len(DIRTY), CHUNK)
        odd = rand(MESH_ODD, K, CHUNK)
        core = codec.core
        parity = {}

        def present():
            return {i: (d1[:, i] if i < K else parity["p"][:, i - K])
                    for i in range(K + M) if i not in ERASED}
        calls = {
            "encode": lambda: codec.encode_batch_async(d1),
            "decode": lambda: codec.decode_batch_async(present(), CHUNK),
            "delta": lambda: codec.delta_encode_batch_async(delta, DIRTY),
            "odd_encode": lambda: codec.encode_batch_async(odd)}
        out, single = {}, {}
        for name, call in calls.items():
            before = gf8_kernel.launches
            h = call()
            out[name] = h.wait()
            report["dispatch_launches"][name] = gf8_kernel.launches - before
            lanes = [led["device"] for led in (h.ledgers or ())]
            if lanes != MESH_INFO["device_ids"]:
                raise AssertionError(f"mesh {name}: ledger lanes {lanes}")
            if name == "encode":
                parity["p"] = out[name]
        be.configure_mesh(1, 0)
        try:
            if be.mesh_info() is not None:
                raise AssertionError("configure_mesh(1, 0) left a mesh")
            for name, call in calls.items():
                before = gf8_kernel.launches
                h = call()
                single[name] = h.wait()
                n = gf8_kernel.launches - before
                if n != 1 or h.ledgers:
                    raise AssertionError(f"single-device {name}: {n} "
                                         f"launches")
        finally:
            be.configure_mesh(0, 0)
        for name in calls:
            a, b = out[name], single[name]
            if isinstance(a, dict):
                same = sorted(a) == sorted(b) and all(
                    np.array_equal(a[e], b[e]) for e in a)
            else:
                same = np.array_equal(a, b)
            if not same:
                raise AssertionError(f"mesh {name} != single-device")
        # B1's plain version on the first stripes of each dispatch
        cut = 4
        bits = matrix.matrix_to_bitmatrix(core.coding_matrix, 8)
        chosen = tuple(i for i in range(K + M) if i not in ERASED)[:K]
        _, rows_bits = core._recovery_rows(chosen, ERASED)
        block = np.zeros((cut, K, CHUNK), np.uint8)
        block[:, list(DIRTY)] = delta[:cut]
        full = np.concatenate([d1[:cut], out["encode"][:cut]], axis=1)
        for name, bm, src, got in (
                ("encode", bits, d1[:cut], out["encode"][:cut]),
                ("decode", rows_bits, full[:, list(chosen)],
                 np.stack([out["decode"][e][:cut] for e in ERASED], 1)),
                ("delta", bits, block, out["delta"][:cut]),
                ("odd_encode", bits, odd, out["odd_encode"])):
            want = gf8_kernel.gf8_apply_plain(
                bm, torch.from_numpy(np.ascontiguousarray(src)).to(DEV))
            if not np.array_equal(want.cpu().numpy(), got):
                raise AssertionError(f"mesh {name} != plain B1 on a slice")
        for e in ERASED:
            want = d1[:, e] if e < K else out["encode"][:, e - K]
            if not np.array_equal(out["decode"][e], want):
                raise AssertionError(f"mesh decode chunk {e} != original")
        del full, single, parity["p"]
        print(f"mesh headline: encode, decode {ERASED}, delta {DIRTY} of "
              f"[{STRIPES}, {K}, {CHUNK}] and an encode of {MESH_ODD} "
              f"stripes equal to configure_mesh(1, 0) and plain B1; B1 "
              f"launches a dispatch {report['dispatch_launches']}")

        # 3. the batcher of phase 5, MESH_OPS writes of 4 MiB
        from ceph_tpu_torch.osd.batcher import EncodeBatcher
        from ceph_tpu_torch.utils.config import default_config
        conf = default_config()
        for name, value in (("ec_tpu_batch_stripes", BATCH_STRIPES),
                            ("ec_tpu_queue_window_us", BATCH_WINDOW_US),
                            ("ec_tpu_fallback_cpu", False),
                            ("osd_ec_prewarm", True)):
            conf.set(name, value)
        EncodeBatcher.reset_learning()
        b = EncodeBatcher(conf)
        try:
            sinfo = ecutil.StripeInfo(K, K * CHUNK)
            warm = b.prewarm(codec, sinfo)
            if warm is not None:
                warm.join()
            if b.prewarm_error is not None:
                raise AssertionError(f"prewarm: {b.prewarm_error!r}")
            objs = d1[:MESH_OPS * OBJ_STRIPES].reshape(MESH_OPS, -1)
            r = run_lane(b, lambda i, cb: b.submit(codec, sinfo, objs[i],
                                                   cb),
                         MESH_OPS, _Since(gf8_kernel), "encode")
            twin = b.cpu_twin(codec, sinfo)
            for i, got in enumerate(r["out"]):
                if got != ecutil.encode(sinfo, twin, objs[i].tobytes()):
                    raise AssertionError(f"mesh batcher op {i} != CPU twin")
            faults = {"cpu_reqs": b.cpu_reqs,
                      "device_errors": b.device_errors,
                      "breaker_opens": EncodeBatcher._breaker_opens}
            if any(faults.values()):
                raise AssertionError(f"mesh batcher faults {faults}")
            lanes = sorted({led["device"] for led in r["ledgers"]})
            dump = b.device_dump()["mesh"] or {}
            if lanes != MESH_INFO["device_ids"] or \
                    (dump.get("dp"), dump.get("sp")) != (2, 2):
                raise AssertionError(f"mesh batcher lanes {lanes}, dump "
                                     f"mesh {dump}")
        finally:
            b.stop()
            EncodeBatcher.reset_learning()
        report["batcher"] = {"requests": MESH_OPS, "calls": r["calls"],
                             "launches": r["launches"]["B1"],
                             "seconds": r["wall"]}
        print(f"mesh batcher: {MESH_OPS} writes of 4 MiB from "
              f"{BATCH_THREADS} threads in {r['calls']} calls, "
              f"{r['launches']['B1']} B1 launches, {r['wall']:.4f} s host "
              f"to host, equal to the CPU twin; lanes {lanes}, {faults}")

        # 4. the sharded functions on small shapes
        nb = engine.NumpyBackend()
        small = np.random.default_rng(SEED + 18).integers(
            0, 256, (8, 4, 1024), dtype=np.uint8)
        for w in (8, 16, 32):
            Mw = matrix.reed_sol_vandermonde_coding_matrix(4, 2, w)
            before = gf8_kernel.launches
            par, dig = pmesh.sharded_encode_fn(mesh, w)(
                matrix.matrix_to_bitmatrix(Mw, w),
                pmesh.shard_batch(mesh, small))
            par = np.asarray(par)
            want = nb.apply_matrix(Mw, small, w)
            if not np.array_equal(par, want) or \
                    int(dig) != _digest(np, want, bits=True):
                raise AssertionError(f"sharded_encode_fn w={w} diverged")
            if w == 8:
                report["dispatch_launches"]["sharded_encode_w8"] = \
                    gf8_kernel.launches - before
        M4 = matrix.reed_sol_vandermonde_coding_matrix(4, 2, 8)
        before = gf8_kernel.launches
        par, dig = pmesh.sharded_encode_gf8_fn(mesh, M4)(
            pmesh.shard_batch(mesh, small))
        report["dispatch_launches"]["sharded_encode_gf8"] = \
            gf8_kernel.launches - before
        want = nb.apply_matrix(M4, small, 8)
        if not np.array_equal(np.asarray(par), want) or \
                int(dig) != _digest(np, want, bits=False):
            raise AssertionError("sharded_encode_gf8_fn diverged")
        small_codec = registry.instance().factory(
            "gpu", {"k": "4", "m": "2", "device": DEV})
        enc = pmesh.shared_encoder(small_codec)
        if enc is None or (enc.dp, enc.sp) != (2, 2) or \
                pmesh.shared_encoder(small_codec) is not enc:
            raise AssertionError("shared_encoder: no 2 x 2 encoder")
        before = gf8_kernel.launches
        got = enc.encode_async(small[:MESH_ODD]).wait()
        report["dispatch_launches"]["shared_encoder"] = \
            gf8_kernel.launches - before
        if not np.array_equal(got, want[:MESH_ODD]):
            raise AssertionError("ShardedEncoder diverged")
        print("mesh sharded functions: sharded_encode_fn at w = 8, 16, 32 "
              "and sharded_encode_gf8_fn equal to NumpyBackend, with the "
              "JAX package's digests; shared_encoder 2 x 2, a padded batch "
              f"of {MESH_ODD} equal")

        # 5. the dryrun
        dryrun.dryrun_multichip(MESH_SHARDS, DEV)
        report["launches"] = gf8_kernel.launches
        report["seconds_driven"] = time.monotonic() - t_start

        # the sharded headline encode against single-device B1
        data = torch.from_numpy(d1).to(DEV)
        del d1, delta, odd, out
        rows = core.coding_matrix
        op = carry.carry_rows(rows, bits, DEV)
        whole = torch.empty((STRIPES, M, CHUNK), dtype=torch.uint8,
                            device=DEV)
        fn = pmesh.sharded_rows_fn(mesh, rows)
        sharded = pmesh.shard_batch(mesh, data)

        def run_b1():
            gf8_kernel.gf8_apply(op, data, whole)

        def run_sharded():
            return fn(sharded)

        def run_staged():
            return fn(pmesh.shard_batch(mesh, data)).gather()

        for f in (run_b1, run_sharded, run_staged):
            for _ in range(3):
                f()
        b1_ms, _ = cuda_time_ms(run_b1, 20)
        before = gf8_kernel.launches
        sh_ms, sh_runs = cuda_time_ms(run_sharded, 20)
        sh_launches = (gf8_kernel.launches - before) / 20
        st_ms, _ = cuda_time_ms(run_staged, 20)
        b1_again, _ = cuda_time_ms(run_b1, 20)
        got = run_sharded().gather()

        def plain():
            return sharded.map(lambda blk: gf8_kernel.gf8_apply_plain(
                op.bitmatrix, blk)).gather()
        want = plain()
        plain_ms, _ = cuda_time_ms(plain, 3)
        err = int((want.to(torch.int16) - got.to(torch.int16)).abs().max())
        if err or not torch.equal(got, whole):
            raise AssertionError("sharded headline != plain or B1")
        nbytes = data.numel() + whole.numel()
        report["timing"] = {
            "shape": [[STRIPES, K, CHUNK], [STRIPES, M, CHUNK]],
            "sharded_ms": sh_ms, "sharded_runs_ms": sh_runs,
            "launches_per_run": sh_launches, "staged_ms": st_ms,
            "b1_ms": [b1_ms, b1_again], "plain_ms": plain_ms,
            "max_abs_err": err, "bound_ms": nbytes / HBM_BPS * 1e3,
            "bound_by": "bytes"}
        print(f"mesh timing on {card()}: sharded headline encode "
              f"{sh_ms:.4f} ms median of 20 ({sh_launches:g} B1 launches, "
              f"blocks [{STRIPES // 2}, {K}, {CHUNK // 2}]); with the "
              f"shard and gather copies {st_ms:.4f} ms; single-device B1 "
              f"{b1_ms:.4f} / {b1_again:.4f} ms; bound "
              f"{nbytes / HBM_BPS * 1e3:.4f} ms (bytes); plain "
              f"{plain_ms:.4f} ms; max abs err {err}")
    except Exception as e:  # every failure ends the child non-zero
        import traceback
        traceback.print_exc()
        return fail(f"mesh child: {type(e).__name__}: {e}")
    report["seconds"] = time.monotonic() - t_start
    print(json.dumps({"mesh": report}))
    return 0


def mesh_path() -> dict:
    """Run mesh_child in its own process with
    CEPH_TPU_TORCH_FORCE_DEVICE_COUNT=MESH_SHARDS, its output in
    chiprun_out/mesh.log, reusing the kernels this process built; fail
    on a non-zero exit or on fewer than MESH_SHARDS B1 launches in any
    sharded dispatch.  -> the child's report."""
    logs = os.path.join(HERE, "chiprun_out")
    os.makedirs(logs, exist_ok=True)
    log_path = os.path.join(logs, "mesh.log")
    env = dict(os.environ, PYTHONPATH=HERE,
               CEPH_TPU_TORCH_FORCE_DEVICE_COUNT=str(MESH_SHARDS))
    t0 = time.monotonic()
    with open(log_path, "w") as log:
        try:
            rc = subprocess.run(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                 "--mesh-child"], cwd=HERE, env=env, stdout=log,
                stderr=subprocess.STDOUT, timeout=MESH_CHILD_S).returncode
        except subprocess.TimeoutExpired:
            rc = f"none: killed after {MESH_CHILD_S} s"
    wall = time.monotonic() - t0
    with open(log_path) as f:
        lines = f.read().splitlines()
    report = None
    for line in lines:
        if line.startswith('{"mesh": '):
            report = json.loads(line)["mesh"]
        elif line.startswith(("mesh", "dryrun")):
            print(line)
    if rc != 0 or report is None:
        raise AssertionError(f"mesh child: exit {rc}, see "
                             f"chiprun_out/mesh.log; its last lines:\n"
                             + "\n".join(lines[-25:]))
    for name, n in report["dispatch_launches"].items():
        if n < MESH_SHARDS:
            raise AssertionError(f"mesh {name}: {n} B1 launches, fewer "
                                 f"than dp x sp = {MESH_SHARDS}")
    bat = report["batcher"]
    if bat["launches"] < MESH_SHARDS * bat["calls"]:
        raise AssertionError(f"mesh batcher: {bat['launches']} B1 launches "
                             f"in {bat['calls']} calls")
    report["wall"] = wall
    print(f"mesh phase: {wall:.1f} s in its child, CUDA set-up included "
          f"(its driven part {report['seconds_driven']:.1f} s); B1 "
          f"launches {report['launches']}")
    return report


FAULT_OPS = 16             # ops of 4 MiB a lane under armed device faults
FAULT_PROBES = 64          # single writes allowed to reach a probe
CHAOS_OSDS = 3             # the JAX package's chaos recipe
CHAOS_SPEC = "device.dispatch:error:1in20"
CHAOS_SEED = 42
CHAOS_OBJS = 12
CHAOS_BYTES = 32 << 10
FAULTS_CHILD_S = 120       # the child is killed past this
LANES = ("encode", "decode", "delta")


def faults_drive(torch, np, dev: str) -> dict:
    """The faults phase on ``dev``; see faults_child.  Raises on any
    output that is not byte-equal or any count the fault route must
    show; the launch counts are the caller's to check (the CPU runs
    B1's plain version and counts none).  -> the report."""
    import threading

    from ceph_tpu_torch.cluster import Cluster, test_config
    from ceph_tpu_torch.ec import registry
    from ceph_tpu_torch.ec.plugins import gpu as gpumod
    from ceph_tpu_torch.ops import gf8_kernel
    from ceph_tpu_torch.osd import ecutil
    from ceph_tpu_torch.osd.batcher import EncodeBatcher
    from ceph_tpu_torch.utils import faults as faultlib
    from ceph_tpu_torch.utils.config import default_config
    from ceph_tpu_torch.utils.flight_recorder import FlightRecorder
    from ceph_tpu_torch.utils.perf import PerfCountersCollection

    reg = faultlib.registry()
    counts = _Since(gf8_kernel)
    pool = gpumod.shared_backend(dev).staging
    stalls0 = pool.stats()["stall_allocs"]
    report = {}
    codec = registry.instance().factory(
        "gpu", {"k": str(K), "m": str(M), "technique": "reed_sol_van",
                "device": dev})
    sinfo = ecutil.StripeInfo(K, K * CHUNK)
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)

    def rand(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen).cpu().numpy()

    nst = FAULT_OPS * OBJ_STRIPES
    objs = rand(FAULT_OPS, OBJ_STRIPES * K * CHUNK)
    stripes = objs.reshape(nst, K, CHUNK)
    deltas = rand(nst, len(DIRTY), CHUNK)

    def rows(i):
        return slice(i * OBJ_STRIPES, (i + 1) * OBJ_STRIPES)

    conf = default_config()
    for name, value in (("ec_tpu_batch_stripes", BATCH_STRIPES),
                        ("ec_tpu_queue_window_us", BATCH_WINDOW_US),
                        ("ec_tpu_fallback_cpu", False)):
        conf.set(name, value)
    reg.reset()
    EncodeBatcher.reset_learning()
    coll = PerfCountersCollection()
    rec = FlightRecorder(capacity=4096, name="osd.0")
    b = EncodeBatcher(conf, perf_coll=coll, recorder=rec)
    try:
        twin = b.cpu_twin(codec, sinfo)
        parity = twin.encode_batch(stripes)
        dpar = twin.core.delta_parity(deltas, DIRTY)
        # the same values through B1 before any site is armed
        if not (np.array_equal(codec.encode_batch_async(stripes).wait(),
                               parity)
                and np.array_equal(codec.delta_encode_batch_async(
                    deltas, DIRTY).wait(), dpar)):
            raise AssertionError("faults: B1 != jerasure before arming")

        def chunks(i):
            p = parity[rows(i)]
            return {s: np.ascontiguousarray(
                stripes[rows(i), s] if s < K else p[:, s - K]).reshape(-1)
                for s in range(K + M)}
        want = {"encode": chunks,
                "decode": lambda i: {e: chunks(i)[e] for e in ERASED},
                "delta": lambda i: {K + j: np.ascontiguousarray(
                    dpar[rows(i), j]).reshape(-1) for j in range(M)}}
        submit = {
            "encode": lambda i, cb: b.submit(codec, sinfo, objs[i], cb),
            "decode": lambda i, cb: b.submit_decode(
                codec, sinfo, {s: c for s, c in chunks(i).items()
                               if s not in ERASED}, set(ERASED), cb),
            "delta": lambda i, cb: b.submit_delta(
                codec, sinfo, deltas[rows(i)], DIRTY, cb)}

        def check(lane, i, got):
            for s, arr in want[lane](i).items():
                if not np.array_equal(np.frombuffer(got[s], np.uint8), arr):
                    raise AssertionError(f"faults {lane}: op {i} shard {s} "
                                         f"!= jerasure")

        def lanes(which=LANES) -> dict:
            """FAULT_OPS ops of each lane from BATCH_THREADS threads,
            each checked; -> B1 launches by lane."""
            out = {}
            for lane in which:
                r = run_lane(b, submit[lane], FAULT_OPS, counts, lane)
                for i, got in enumerate(r["out"]):
                    check(lane, i, got)
                out[lane] = r["launches"]["B1"]
            return out

        def routes():
            """The reason-coded routing verdicts so far, by counter."""
            return {k: v for k, v in coll.perf_dump()["ec_device"].items()
                    if "route_" in k and v}

        def one(lane, i):
            """One op of ``lane``, alone in its group; -> B1 launches."""
            got, ev = {}, threading.Event()
            counts.reset()
            submit[lane](i, lambda c: (got.update(c=c), ev.set()))
            if not ev.wait(60) or got["c"] is None:
                raise AssertionError(f"faults: a single {lane} op failed")
            check(lane, i, got["c"])
            return counts.read()["B1"]

        def twin_reqs():
            return {"encode": b.cpu_reqs, "decode": b.dec_cpu_reqs,
                    "delta": b.delta_cpu_reqs}

        # 1. every dispatch fails.  Each lane starts with the breaker
        #    closed, so each lane's dispatch site trips; then single
        #    writes until the breaker is open for step 2.
        t0 = time.monotonic()
        reg.arm(faultlib.DEVICE_DISPATCH, mode="error", every=1)
        launches, opens = {}, 0
        for lane in LANES:
            opens += EncodeBatcher._breaker_opens
            EncodeBatcher.reset_breaker()
            launches.update(lanes((lane,)))
        for n in range(FAULT_PROBES):
            if EncodeBatcher._breaker_open:
                break
            launches["encode"] += one("encode", n % FAULT_OPS)
        opens += EncodeBatcher._breaker_opens
        reg.disarm(faultlib.DEVICE_DISPATCH)
        events = [e for e in rec.dump() if e["kind"] == "fault_twin"]
        r1 = {"seconds": time.monotonic() - t0,
              "trips": reg.trips(faultlib.DEVICE_DISPATCH),
              "device_errors": b.device_errors,
              "fault_twin_groups": dict(b.fault_twin_groups),
              "reasons": sorted({e["reason"] for e in events}),
              "twin_reqs": twin_reqs(), "routes": routes(),
              "breaker_opens": opens,
              "breaker_open": EncodeBatcher._breaker_open,
              "launches": launches}
        report["dispatch"] = r1
        # every group sent to the device came back a fault-twin group
        to_device = sum(v for k, v in r1["routes"].items() if not k.endswith(
            ("breaker_open", "pin", "learned")))
        if r1["trips"] < 1 or r1["device_errors"] < 1 \
                or any(r1["fault_twin_groups"][lane] < 1 for lane in LANES) \
                or sum(r1["fault_twin_groups"].values()) != to_device \
                or sum(r1["fault_twin_groups"].values()) \
                != r1["device_errors"] or r1["reasons"] != ["dispatch"] \
                or r1["breaker_opens"] < 1 \
                or not r1["breaker_open"] or any(launches.values()) \
                or any(r1["twin_reqs"][lane] < FAULT_OPS for lane in LANES):
            raise AssertionError(f"faults, every dispatch failing: {r1}")
        print(f"faults dispatch: {FAULT_OPS} writes, degraded reads and "
              f"overwrites of 4 MiB, each lane from a closed breaker, in "
              f"{r1['seconds']:.3f} s, every one byte-equal to jerasure; "
              f"trips {r1['trips']}, device errors {r1['device_errors']}, "
              f"groups the twin served after a fault "
              f"{r1['fault_twin_groups']}, requests on the twin "
              f"{r1['twin_reqs']}, breaker opens {r1['breaker_opens']}, "
              f"route verdicts {r1['routes']}, B1 launches {launches}")

        # 2. one completion fault on a live handle in each lane: single
        #    ops until a probe through the open breaker reaches the
        #    device and its handle is abandoned at completion; the
        #    encode lane goes last and on until a probe readmits
        t0 = time.monotonic()
        errors = b.device_errors
        groups0 = dict(b.fault_twin_groups)
        probes, readmit = {}, None
        for lane in ("decode", "delta", "encode"):
            trips = reg.trips(faultlib.DEVICE_COMPLETION)
            reg.arm(faultlib.DEVICE_COMPLETION, mode="error", one_shot=True)
            for n in range(FAULT_PROBES):
                launched = one(lane, n % FAULT_OPS)
                if reg.trips(faultlib.DEVICE_COMPLETION) > trips:
                    probes[lane] = {"ops": n + 1, "launches": launched}
                    break
        for n in range(FAULT_PROBES):
            launched = one("encode", n % FAULT_OPS)
            if not EncodeBatcher._breaker_open:
                readmit = {"ops": n + 1, "launches": launched}
                break
        events = [e for e in rec.dump() if e["kind"] == "fault_twin"
                  and e["reason"] == "completion"]
        r2 = {"seconds": time.monotonic() - t0, "probes": probes,
              "readmit": readmit,
              "completion_trips": reg.trips(faultlib.DEVICE_COMPLETION),
              "device_errors": b.device_errors - errors,
              "completion_lanes": sorted(e["lane"] for e in events),
              "fault_twin_groups": {lane: b.fault_twin_groups[lane]
                                    - groups0[lane] for lane in LANES},
              "routes": routes(),
              "breaker_closes": EncodeBatcher._breaker_closes}
        report["completion"] = r2
        if sorted(probes) != sorted(LANES) or readmit is None \
                or r2["device_errors"] != 3 \
                or r2["completion_trips"] != 3 \
                or r2["completion_lanes"] != sorted(LANES) \
                or any(v != 1 for v in r2["fault_twin_groups"].values()) \
                or any(r2["routes"].get(f"{p}route_breaker_probe", 0) < 1
                       for p in ("", "dec_", "delta_")) \
                or r2["routes"].get("route_breaker_probe", 0) < 2 \
                or r2["breaker_closes"] != 1:
            raise AssertionError(f"faults, one completion fault a lane: {r2}")
        errors = b.device_errors
        t0 = time.monotonic()
        clean = lanes()
        report["clean"] = {"seconds": time.monotonic() - t0,
                           "launches": clean,
                           "device_errors": b.device_errors - errors}
        if b.device_errors != errors or EncodeBatcher._breaker_open:
            raise AssertionError(f"faults, clean pass: {report['clean']}")
        print(f"faults completion: in each lane a probe through the open "
              f"breaker launched B1 and its live handle was abandoned at "
              f"completion, the twin serving it byte-equal (ops to the "
              f"probe and its launches {probes}); the encode probe "
              f"{readmit['ops']} writes later readmitted the device "
              f"(B1 {readmit['launches']}); then {3 * FAULT_OPS} clean ops "
              f"in {report['clean']['seconds']:.3f} s, B1 launches {clean}, "
              f"no new device error; route verdicts {r2['routes']}")
    finally:
        b.stop()

    # 3. the reference's chaos smoke on the card
    reg.reset()
    EncodeBatcher.reset_learning()
    t0 = time.monotonic()
    cconf = test_config(fault_injection=CHAOS_SPEC,
                        fault_injection_seed=CHAOS_SEED,
                        ec_tpu_fallback_cpu=False)
    counts.reset()
    with Cluster(n_osds=CHAOS_OSDS, conf=cconf) as c:
        for i in range(CHAOS_OSDS):
            c.wait_for_osd_up(i, 60)
        c.create_ec_profile("chaos", plugin="gpu", k="2", m="1",
                            device=dev)
        c.create_pool("chp", "erasure", erasure_code_profile="chaos")
        io = c.rados().open_ioctx("chp")
        blob = bytes(rand(CHAOS_BYTES))
        for i in range(CHAOS_OBJS):
            io.write_full(f"c{i}", blob)
        for i in range(CHAOS_OBJS):
            if io.read(f"c{i}") != blob:
                raise AssertionError(f"faults chaos: c{i} read back wrong")
        ret, _, out = c.osds[0]._exec_command({"prefix": "perf dump"})
        cnt = reg.counters()
        batchers = [o.encode_batcher for o in c.osds.values()
                    if o is not None]
        r3 = {"seconds": time.monotonic() - t0, "perf_dump": out.get(
                  "faults"), "registry": cnt,
              "device_errors": sum(x.device_errors for x in batchers),
              "fault_twin_groups": sum(sum(x.fault_twin_groups.values())
                                       for x in batchers),
              "launches": counts.read()["B1"]}
    report["chaos"] = r3
    if ret != 0 or r3["perf_dump"] != cnt \
            or cnt[faultlib.DEVICE_DISPATCH]["hits"] < 1 \
            or cnt[faultlib.DEVICE_DISPATCH]["armed"] != 1 \
            or r3["fault_twin_groups"] != r3["device_errors"]:
        raise AssertionError(f"faults chaos: {r3}")
    d = cnt[faultlib.DEVICE_DISPATCH]
    print(f"faults chaos: {CHAOS_OSDS} OSDs, a gpu k=2 m=1 pool, "
          f"{CHAOS_SPEC} at seed {CHAOS_SEED}: {CHAOS_OBJS} writes of "
          f"{CHAOS_BYTES >> 10} KiB read back in {r3['seconds']:.3f} s; "
          f"device.dispatch hits {d['hits']}, trips {d['trips']}, device "
          f"errors {r3['device_errors']}, groups the twin served after a "
          f"fault {r3['fault_twin_groups']}; osd.0's perf dump faults "
          f"block equals the registry; B1 launches {r3['launches']}")
    reg.reset()

    # 4. after the drain: no slot in flight, none stall-grown
    st = pool.stats()
    report["staging"] = {"in_flight": st["in_flight"],
                         "stall_allocs": st["stall_allocs"] - stalls0,
                         "slots": st["slots"]}
    if st["in_flight"] or st["stall_allocs"] != stalls0:
        raise AssertionError(f"faults staging after the drain: {st}")
    print(f"faults staging after the drain: {report['staging']}")
    return report


def faults_child() -> int:
    """The faults phase, run as ``chip_smoke.py --faults-child``: in its
    own process, since the fault registry and the breaker are
    process-wide and the parent's later phases assert that neither
    fired.  On the card, at the headline geometry (k=8 m=4 reed_sol_van,
    objects of 4 MiB):
      1. one EncodeBatcher built as in phase 5, with device.dispatch
         armed on every call: FAULT_OPS writes, FAULT_OPS degraded reads
         with shards ERASED lost and FAULT_OPS overwrites of columns
         DIRTY, from BATCH_THREADS threads, the breaker closed at the
         start of each lane, each op byte-equal to jerasure (which B1
         matched before the site was armed); device errors, trips, at
         least one group of every lane the CPU twin served after a
         fault, reason-coded twin verdicts, then single writes until
         the breaker is open, and no device call;
      2. the site disarmed and device.completion armed once a lane, for
         decode, delta and encode in turn: single ops until a probe
         through the open breaker launches B1 and its live handle is
         abandoned at completion (the twin serves it); then single
         writes until the next probe readmits the device; then the
         3 x FAULT_OPS ops again, B1 launched in every lane and no new
         device error;
      3. the JAX package's chaos smoke: CHAOS_OSDS OSDs, a `gpu` k=2 m=1
         pool, CHAOS_SPEC at seed CHAOS_SEED, CHAOS_OBJS writes of 32
         KiB read back, osd.0's perf dump `faults` block equal to the
         registry's counters;
      4. after the drain, the shared backend's staging ring idle
         (in_flight 0) and grown by no stall.
    Prints one JSON line {"faults": {...}}; exits non-zero on any
    failure."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        return fail("CUDA is not available")
    sys.path.insert(0, HERE)
    from ceph_tpu_torch.ops import gf8_kernel
    t_start = time.monotonic()
    try:
        base = gf8_kernel.launches
        report = faults_drive(torch, np, DEV)
        report["launches"] = gf8_kernel.launches - base
        clean = report["clean"]["launches"]
        probes = report["completion"]["probes"]
        if any(probes[lane]["launches"] < 1 for lane in LANES) \
                or report["completion"]["readmit"]["launches"] < 1 \
                or any(clean[lane] < 1 for lane in LANES):
            raise AssertionError(f"faults: B1 not launched where the "
                                 f"device served: {report}")
    except Exception as e:  # every failure ends the child non-zero
        import traceback
        traceback.print_exc()
        return fail(f"faults child: {type(e).__name__}: {e}")
    report["seconds"] = time.monotonic() - t_start
    print(json.dumps({"faults": report}))
    return 0


def faults_path() -> dict:
    """Run faults_child in its own process, its output in
    chiprun_out/faults.log, reusing the kernels this process built; fail
    on a non-zero exit or a missing report.  -> the child's report."""
    logs = os.path.join(HERE, "chiprun_out")
    os.makedirs(logs, exist_ok=True)
    log_path = os.path.join(logs, "faults.log")
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.monotonic()
    with open(log_path, "w") as log:
        try:
            rc = subprocess.run(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                 "--faults-child"], cwd=HERE, env=env, stdout=log,
                stderr=subprocess.STDOUT, timeout=FAULTS_CHILD_S).returncode
        except subprocess.TimeoutExpired:
            rc = f"none: killed after {FAULTS_CHILD_S} s"
    wall = time.monotonic() - t0
    with open(log_path) as f:
        lines = f.read().splitlines()
    report = None
    for line in lines:
        if line.startswith('{"faults": '):
            report = json.loads(line)["faults"]
        elif line.startswith("faults "):
            print(line)
    if rc != 0 or report is None:
        raise AssertionError(f"faults child: exit {rc}, see "
                             f"chiprun_out/faults.log; its last lines:\n"
                             + "\n".join(lines[-25:]))
    report["wall"] = wall
    r1, r2 = report["dispatch"], report["completion"]
    print(f"faults phase: {wall:.1f} s in its child, CUDA set-up included; "
          f"trips {r1['trips']} dispatch, {r2['completion_trips']} "
          f"completion; groups the twin served after a fault "
          f"{r1['fault_twin_groups']} dispatch, {r2['fault_twin_groups']} "
          f"completion; breaker opens "
          f"{r1['breaker_opens']}, readmits {r2['breaker_closes']}; B1 "
          f"launches {report['launches']} (clean pass "
          f"{report['clean']['launches']})")
    return report


# phase -> the kernel its path must launch (None: no codec kernel)
PHASE_KERNEL = {"encode": "B1", "decode": "B1", "delta": "B1",
                "ecutil": "B1", "pkt_encode": "B2",
                "pkt_decode_device": "B2", "pkt_decode": "B2",
                "pkt_ecutil": "B2", "ragged_encode": "B3",
                "ragged_decode": "B3", "corpus": "B2",
                "batcher_encode_1": "B1", "batcher_encode_2": "B1",
                "batcher_encode_burst": "B1",
                "batcher_decode": "B1", "batcher_delta": "B1",
                "batcher_packet": "B2", "store": "B1",
                "ecbackend_write": "B1", "ecbackend_delta": "B1",
                "ecbackend_degraded": "B1", "ecbackend_recovery": "B1",
                "scrub": "B1", "ecbackend_packet": "B2",
                "cluster_packet": "B2", "crimson_packet": "B2",
                "plugins_lrc_encode": "B1", "plugins_lrc_decode_local": "B1",
                "plugins_lrc_decode_global": "B1",
                "plugins_clay_encode": "B1", "plugins_clay_decode": "B1",
                "plugins_clay_repair": "B1", "plugins_corpus_lrc": "B1",
                "plugins_corpus_clay": "B1",
                # the sharded dispatches of the mesh phase's child
                "mesh": "B1",
                # the probes and the clean pass of the faults child
                "faults": "B1"}
PHASE_KERNEL.update({f"ecbackend_{name}_{step}": "B1"
                     for name, *_ in CODEC_PGS
                     for step in ("write", "degraded", "recovery")})
PHASE_KERNEL.update({f"{prefix}_{step}": "B1"
                     for prefix in ("cluster", "crimson")
                     for step in ("write", "overwrite", "degraded",
                                  "rebuild", "scrub")})
PHASE_KERNEL.update({f"tools_{name}": kernel
                     for name, kernel, _ in BENCH_RUNS})
PHASE_KERNEL.update({"tools_corpus": "B1", "tools_ec_tool": "B1",
                     "tools_bench_sweep": "B1",
                     # B1 runs in vstart's own process: its OSDs' perf
                     # dumps stand for it (vstart_path)
                     "tools_vstart": None})
PHASE_KERNEL.update({"crimson_striper": "B1", "crimson_rbd": "B1",
                     "crimson_cephfs": "B1",
                     # a replicated pool: no codec kernel (rgw_step)
                     "crimson_rgw": None})
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

    t_start = time.monotonic()

    def elapsed(what):
        print(f"elapsed after {what}: {time.monotonic() - t_start:.1f} s")

    try:
        secs = build_all(list(mods.values()))
        print(f"build: {secs:.3f} s")
        check_b1(torch, gf8_kernel, carry, matrix, engine)
        check_packet(torch, mods, carry, registry, torch_engine)
        elapsed("the build and the kernel checks")
        run = main_path(torch, np, registry, ecutil, engine, counts)
        pkt = packet_path(torch, np, registry, ecutil, engine, counts)
        elapsed("the codec paths")
        mesh = mesh_path()
        elapsed("the mesh phase")
        plug = plugins_path(torch, np, registry, counts)
        elapsed("the plugins phase")
        bat, batcher = batcher_path(torch, np, registry, ecutil, counts)
        elapsed("the batcher phase")
        try:
            flt = faults_path()
        except BaseException:
            batcher.stop()
            raise
        elapsed("the faults phase")
        try:
            store = store_path(torch, np, lambda: batcher._last_backend,
                               counts)
        finally:
            batcher.stop()
        elapsed("the store phase")
        ecb = ecbackend_path(torch, np, registry, ecutil, counts)
        scrub = ecb["scrub"]
        elapsed("the ecbackend phase")
        tools = tools_path(np, registry, counts)
        elapsed("the tools phase")
        cri = cluster_path(torch, np, registry, ecutil, counts, "crimson",
                           CRIMSON_OBJS, services=True)
        elapsed("the crimson cluster phase")
        clu = cluster_path(torch, np, registry, ecutil, counts, "cluster",
                           CLASSIC_OBJS, osd_backend="classic")
        elapsed("the classic cluster phase")
        launches = {**run["launches"], **pkt["launches"],
                    "mesh": {"B1": mesh["launches"], "B2": 0, "B3": 0},
                    "faults": {"B1": flt["launches"], "B2": 0, "B3": 0},
                    **plug["launches"], **bat, "store": store["launches"],
                    **ecb["launches"], **tools, **cri, **clu}
        for phase, n in launches.items():
            if PHASE_KERNEL[phase] and n[PHASE_KERNEL[phase]] < 1:
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
        # B1 at the shapes of the plugins phase: LRC's global and local
        # layers over a batch, CLAY's plane code and its pairwise
        # transform over one 128 KiB sub-chunk
        plugin_shapes = {}
        for lk, (rows, data) in sorted(plug["shapes"]["lrc"].items(),
                                       reverse=True):
            plugin_shapes[f"lrc {'global' if lk == 4 else 'local'} layer"] \
                = measure_rows(torch, gf8_kernel, carry, matrix, rows, data)
        for part, (rows, data) in plug["shapes"]["clay"].items():
            plugin_shapes[f"clay {part}"] = measure_rows(
                torch, gf8_kernel, carry, matrix, rows, data)
        del plug
        for name, me in [*meas.items(), *cross.items(),
                         *((f"B1 {k}", v) for k, v in crc.items()
                           if k != "staged"),
                         *((f"B1 {k}", v) for k, v in plugin_shapes.items())]:
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
    for name, me in plugin_shapes.items():
        print(f"B1 at the {name} shape {list(me['shape'])}: median "
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
    sys.exit({"--mesh-child": mesh_child, "--faults-child": faults_child}
             .get(" ".join(sys.argv[1:]), main)())
