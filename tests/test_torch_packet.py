"""The packet-layout codes of the port against the JAX package.

Kernels B2 (ops/packet_kernel.py) and B3 (ops/packet_xor_kernel.py) run
their plain PyTorch versions on the CPU; here those are held byte for
byte (tolerance 0) against the TPU kernels they replace,
``_packet_mxu_pallas_fn`` and ``_packet_pallas_fn`` in interpret mode, at
encode bitmatrices and decode rows with w = 7 and 8.  The port's XOR
schedule must equal the reference's tuple for tuple, the carried
operands must round-trip, and numpy emulations of the kernels' word
arithmetic check the operand layouts the kernels read.  The `gpu` plugin
(device="cpu") must match `tpu` and jerasure for all five packet
techniques, through the sync, async and device entry points.  The
kernels themselves run in tests/test_torch_cuda.py, on a card."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.ops.engine import CodecCore as RefCore
from ceph_tpu.ops.jax_engine import (_packet_mxu_pallas_fn, _packet_pallas_fn,
                                     build_xor_schedule as ref_schedule)
from ceph_tpu.ops.matrix import (cauchy_good_coding_matrix,
                                 matrix_to_bitmatrix)
from ceph_tpu_torch.ec import registry
from ceph_tpu_torch.ops import carry, packet_kernel, packet_xor_kernel
from ceph_tpu_torch.ops.torch_engine import TorchBackend, build_xor_schedule

# (k, m, w) of the bitmatrices: cauchy_good at w = 8 and w = 7
CODES = [(4, 2, 8), (3, 2, 7), (10, 4, 8)]


def row_sets(k, m, w):
    """(name, bitmatrix) for a cauchy_good encode bitmatrix and the decode
    rows of two data erasures, from the JAX codec core."""
    B = matrix_to_bitmatrix(cauchy_good_coding_matrix(k, m, w), w)
    core = RefCore(k, m, w, bitmatrix=B, layout="packet", packetsize=8)
    chosen = tuple(range(2, k + 2))
    _, rows = core._decode_rows(chosen, (0, 1))
    return [("encode", B), ("decode", rows)]


def rand(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


@pytest.mark.parametrize("k,m,w", CODES[:2])
def test_b2_plain_matches_pallas_interpret(k, m, w):
    ps = 128
    data = rand(k * w, 2, k, 2 * w * ps)
    for name, B in row_sets(k, m, w):
        want = np.asarray(_packet_mxu_pallas_fn(B, w, ps, interpret=True)(
            jnp.asarray(data)))
        got = packet_kernel.packet_apply_plain(B, torch.from_numpy(data), w,
                                               ps).numpy()
        assert np.array_equal(got, want), (name, k, m, w)


@pytest.mark.parametrize("ps", [128, 36])
@pytest.mark.parametrize("k,m,w", CODES[:2])
def test_b3_plain_matches_pallas_interpret(k, m, w, ps):
    data = rand(k * ps, 2, k, 2 * w * ps)
    for name, B in row_sets(k, m, w):
        sched = ref_schedule(B)
        want = np.asarray(_packet_pallas_fn(sched, w, ps, interpret=True)(
            jnp.asarray(data)))
        got = packet_xor_kernel.packet_xor_plain(
            sched, torch.from_numpy(data), w, ps).numpy()
        assert np.array_equal(got, want), (name, k, m, w, ps)


@pytest.mark.parametrize("k,m,w", CODES)
def test_schedule_matches_reference(k, m, w):
    for name, B in row_sets(k, m, w):
        assert build_xor_schedule(B) == ref_schedule(B), name
    if (k, m, w) == (10, 4, 8):
        enc = build_xor_schedule(row_sets(k, m, w)[0][1])
        assert sum(len(cols) for _, cols in enc) == 790
        assert sum(prev >= 0 for prev, _ in enc) == 24


@pytest.mark.parametrize("k,m,w", CODES)
def test_carried_operands_round_trip(k, m, w):
    for name, B in row_sets(k, m, w):
        op = carry.packet_operand(B, w, "cpu")
        assert (op.k, op.w, op.rows) == (k, w, B.shape[0])
        assert np.array_equal(carry.operand_packet_bitmatrix(op), B)
        assert np.array_equal(op.bitmatrix.numpy(), B)
        sched = ref_schedule(B)
        sop = carry.schedule_operand(sched, k, w, "cpu")
        assert carry.operand_schedule(sop) == sched == sop.schedule
        assert sop.start[-1].item() == sop.cols.numel()
    with pytest.raises(ValueError):
        carry.packet_operand(B[:, :-1], w, "cpu")
    with pytest.raises(ValueError):
        carry.schedule_operand(((1, (0,)),) * w, k, w, "cpu")
    with pytest.raises(ValueError):
        carry.schedule_operand(((-1, (k * w,)),) * w, k, w, "cpu")


def access_unit(ps):
    """The copy unit of csrc/packet_io.cuh for aligned buffers (numpy's
    are): the widest of 16, 8, 4 or 1 bytes that divides ps."""
    return next(u for u in (16, 8, 4, 1) if ps % u == 0)


def stage_walk(tid, tile, unit, w):
    """StageWalk::init of csrc/packet_io.cuh for thread tid."""
    lanes = min(tile // unit, packet_kernel.THREADS)
    c0, rstep = tid // lanes, packet_kernel.THREADS // lanes
    return (tid & (lanes - 1), lanes, c0, rstep, c0 // w, c0 % w,
            rstep // w, rstep % w)


def items(data, w, ps, tile):
    """The kernels' work items, in the C order: (stripe, super-word, byte
    tile) -> (input row c -> its n bytes, output packet (e, i) -> the
    slice of out it writes, n)."""
    batch, k, L = data.shape
    for b, s, t in itertools.product(range(batch), range(L // (w * ps)),
                                     range(-(-ps // tile))):
        off = s * w * ps + t * tile
        n = min(tile, ps - t * tile)
        yield (b, lambda ci, cj, b=b, off=off, n=n:
               data[b, ci, off + cj * ps:off + cj * ps + n],
               lambda e, i, b=b, off=off, n=n:
               (b, e, slice(off + i * ps, off + i * ps + n)), n)


def stage_item(src, kw, w, tile, unit, n, rng):
    """stage_item of csrc/packet_io.cuh: every thread's copies of one
    item into a stage that holds stale bytes; each (row, chunk) must be
    copied exactly once, and the walk's (ci, cj) must name row c.  Row
    k*w is the stage's zero row."""
    stage = rng.integers(0, 256, (kw + 1, tile), dtype=np.uint8)
    stage[kw] = 0
    chunks = n // unit
    seen = np.zeros((kw, chunks), dtype=np.int64)
    for tid in range(packet_kernel.THREADS):
        lane, lanes, c, rstep, ci, cj, dci, dcj = stage_walk(tid, tile, unit,
                                                            w)
        while c < kw:
            assert ci * w + cj == c
            row = src(ci, cj)
            for j in range(lane, chunks, lanes):
                stage[c, j * unit:(j + 1) * unit] = row[j * unit:
                                                        (j + 1) * unit]
                seen[c, j] += 1
            c, ci, cj = c + rstep, ci + dci, cj + dcj
            if cj >= w:
                cj, ci = cj - w, ci + 1
    assert (seen == 1).all()
    return stage


def emulate_b2(op, data, ps):
    """B2's arithmetic in numpy, as csrc/packet_bitplane.cu does it: the
    tile of launch_plan, each item staged once (ragged last tile, stale
    bytes past it); per unit of 4 rows, the columns with a nonzero 4-bit
    mask sorted by mask into 15 classes, each padded with the zero row to
    a multiple of four; the XOR of a class's slices goes to the rows of
    its mask's bits."""
    w, kw, rows = op.w, op.k * op.w, op.rows
    tile, smem = packet_kernel.launch_plan(op, ps)
    assert smem == packet_kernel.bitplane_smem(kw, rows, tile)
    masks = op.masks.numpy().view(np.uint32)
    units = []
    for u in range(-(-rows // 4)):
        nib = (masks[u >> 3] >> np.uint32(4 * (u & 7))) & np.uint32(15)
        classes = []
        for n in range(1, 16):
            lst = [c * tile for c in range(kw) if nib[c] == n]
            classes.append(lst + [kw * tile] * (-len(lst) % 4))
        assert sum(map(len, classes)) <= (kw + 45 + 7) & ~7
        units.append(classes)
    rng = np.random.default_rng(ps)
    out = np.zeros((data.shape[0], rows // w, data.shape[2]), np.uint8)
    for _, src, dst, n in items(data, w, ps, tile):
        words = stage_item(src, kw, w, tile, access_unit(ps), n,
                           rng).reshape(-1).view(np.uint32)
        for u, classes in enumerate(units):
            acc = np.zeros((4, tile // 4), dtype=np.uint32)
            for cls, lst in enumerate(classes, start=1):
                t = np.zeros(tile // 4, dtype=np.uint32)
                for off in lst:
                    t ^= words[off // 4:off // 4 + tile // 4]
                for v in range(4):
                    if cls >> v & 1:
                        acc[v] ^= t
            for v in range(4):
                r = 4 * u + v
                if r < rows:
                    out[dst(r // w, r % w)] = acc[v].view(np.uint8)[:n]
    return out


FIRST, LAST, OFFSET = 1 << 14, 1 << 15, (1 << 14) - 1


def xor_program(op, tile):
    """build_program of csrc/packet_xor.cu: the rows in waves by their
    depth in the prev forest, each to the least loaded of the WARPS
    warps of its wave; a row as max(1, ceil(len/8)) groups of eight
    16-bit stage offsets (16-byte units) padded with the zero row, FIRST
    on the first entry of its first group and LAST on its last group's.
    Returns {(wave, warp): [(row, groups)]}."""
    kw, W = op.k * op.w, packet_kernel.WARPS
    prev, start, cols = (t.numpy() for t in (op.prev, op.start, op.cols))
    wave, segs = [], {}
    for r in range(op.rows):
        wave.append(0 if prev[r] < 0 else wave[prev[r]] + 1)
        load = [sum(len(g) for _, g in segs.get((wave[r], v), ()))
                for v in range(W)]
        v = load.index(min(load))
        lo, hi = start[r], start[r + 1]
        ng = max(1, -(-(hi - lo) // 8))
        row = [int(c) * tile >> 4 for c in cols[lo:hi]]
        row += [kw * tile >> 4] * (8 * ng - len(row))
        row[0] |= FIRST
        row[8 * (ng - 1)] |= LAST
        segs.setdefault((wave[r], v), []).append(
            (r, np.array(row).reshape(ng, 8)))
    ngroups = sum(len(g) for seg in segs.values() for _, g in seg)
    assert ngroups <= (len(cols) + 7) // 8 + op.rows
    return segs, max(wave) + 1


def emulate_b3(op, data, ps):
    """B3's arithmetic in numpy, as csrc/packet_xor.cu does it: the tile of
    launch_plan, each item staged once, the program run wave by wave and
    warp by warp, and a row with prev >= 0 starting from that row of the
    output tile, which an earlier wave wrote (stale bytes before)."""
    w, kw, rows = op.w, op.k * op.w, op.rows
    tile, smem = packet_xor_kernel.launch_plan(op, ps)
    assert smem == packet_xor_kernel.xor_smem(kw, rows, op.cols.numel(),
                                              tile)
    segs, waves = xor_program(op, tile)
    prev = op.prev.numpy()
    rng = np.random.default_rng(ps + 1)
    out = np.zeros((data.shape[0], rows // w, data.shape[2]), np.uint8)
    for _, src, dst, n in items(data, w, ps, tile):
        words = stage_item(src, kw, w, tile, access_unit(ps), n,
                           rng).reshape(-1).view(np.uint32)
        otile = rng.integers(0, 2**32, (rows, tile // 4), dtype=np.uint32)
        done = set()
        for d in range(waves):
            for v in range(packet_kernel.WARPS):
                for r, groups in segs.get((d, v), ()):
                    assert prev[r] < 0 or prev[r] in done
                    acc = (otile[prev[r]].copy() if prev[r] >= 0 else
                           np.zeros(tile // 4, dtype=np.uint32))
                    for gi, grp in enumerate(groups):
                        assert bool(grp[0] & FIRST) == (gi == 0)
                        assert bool(grp[0] & LAST) == (gi == len(groups) - 1)
                        for e in (grp[0] & OFFSET, *grp[1:]):
                            acc ^= words[e * 4:e * 4 + tile // 4]
                    otile[r] = acc
                    out[dst(r // w, r % w)] = acc.view(np.uint8)[:n]
            done |= {r for v in range(packet_kernel.WARPS)
                     for r, _ in segs.get((d, v), ())}
        assert len(done) == rows
    return out


def check_emulations(k, m, w, ps, data):
    for name, B in row_sets(k, m, w):
        want = packet_kernel.packet_apply_plain(
            B, torch.from_numpy(data), w, ps).numpy()
        op = carry.packet_operand(B, w, "cpu")
        assert np.array_equal(emulate_b2(op, data, ps), want), name
        sop = carry.schedule_operand(build_xor_schedule(B), k, w, "cpu")
        assert np.array_equal(emulate_b3(sop, data, ps), want), name


@pytest.mark.parametrize("k,m,w", CODES)
def test_kernel_word_arithmetic_matches_plain(k, m, w):
    ps = 16
    check_emulations(k, m, w, ps, rand(7 * k, 2, k, 3 * w * ps))


@pytest.mark.parametrize("k,m,w", CODES)
@pytest.mark.parametrize("ps", [8, 36, 520, 1000, 1040])
def test_kernel_tile_arithmetic_at_tile_edges(ps, k, m, w):
    """Packet sizes below, inside and across a tile: 1000 and 1040 at
    k*w = 80 are a full tile and a ragged one (512 + 488, 512 + 512 +
    16), 1040 at k*w = 24 or 32 a 1024-byte tile and 16 bytes."""
    check_emulations(k, m, w, ps, rand(ps + k, 2, k, w * ps))


# an H100's shared memory per block with the opt-in attribute
H100_SMEM_OPTIN = 232448


def test_tile_plan():
    B = row_sets(10, 4, 8)[0][1]
    op = carry.packet_operand(B, 8, "cpu")
    sop = carry.schedule_operand(build_xor_schedule(B), 10, 8, "cpu")
    for plan in (packet_kernel.launch_plan, packet_xor_kernel.launch_plan):
        operand = op if plan is packet_kernel.launch_plan else sop
        for ps in (1000, 2048):
            tile, smem = plan(operand, ps)
            assert tile == 512 and smem <= packet_kernel.BLOCK_TARGET
        assert plan(operand, 8)[0] == 16 and plan(operand, 36)[0] == 64
    for kw, rows in ((24, 8), (80, 32), (640, 64), (2040, 16)):
        for ps in (8, 100, 1000, 4096):
            tile, smem = packet_kernel.tile_plan(
                ps, lambda t: packet_kernel.bitplane_smem(kw, rows, t))
            assert tile & (tile - 1) == 0
            assert packet_kernel.TILE_MIN <= tile <= packet_kernel.TILE_MAX
            assert tile < 2 * max(ps, 16)
            assert (smem <= packet_kernel.BLOCK_TARGET
                    or tile == packet_kernel.TILE_MIN)
            if 2 * tile <= min(packet_kernel.TILE_MAX, 2 * max(ps, 16) - 1):
                assert packet_kernel.bitplane_smem(
                    kw, rows, 2 * tile) > packet_kernel.BLOCK_TARGET
    # the largest figures of geometries the first design took (offsets and
    # operand within 48 KiB) still fit an H100 block
    for rows in (8, 16, 32, 64, 96, 256):
        for kw in range(8, 6000, 8):
            first = (kw + rows) * 8 + -(-rows // 32) * kw * 4
            if first <= 48 * 1024:
                assert packet_kernel.tile_plan(
                    16, lambda t: packet_kernel.bitplane_smem(kw, rows, t)
                )[1] <= H100_SMEM_OPTIN
            for nnz in (kw, 4 * kw):
                first = (kw + rows) * 8 + (2 * rows + 1 + nnz) * 4
                if first <= 48 * 1024:
                    assert packet_kernel.tile_plan(
                        16, lambda t: packet_xor_kernel.xor_smem(
                            kw, rows, nnz, t))[1] <= H100_SMEM_OPTIN
    # k=256 m=32 w=8 does not: its row lists alone outgrow a block
    assert packet_kernel.bitplane_smem(2048, 256, 16) > H100_SMEM_OPTIN


@pytest.mark.parametrize("ps,kernel", [
    (128, "B2"), (2048, "B2"), (384, "B2"), (36, "B3"), (1000, "B3"),
    (8, "B3")])
def test_routing_by_packet_size(ps, kernel):
    be = TorchBackend("cpu")
    B = row_sets(4, 2, 8)[0][1]
    fn = be.packet_chain_fn(B, 8, ps)
    want = {"B2": packet_kernel.packet_apply,
            "B3": packet_xor_kernel.packet_xor}[kernel]
    assert fn.func is want and fn.keywords == {"packetsize": ps}
    assert be.packet_chain_fn(B, 8, ps).args[0] is fn.args[0]   # cached
    assert be.memory_stats()["compile_cache_entries"] == 1
    data = rand(ps, 3, 4, 2 * 8 * ps)
    ref = packet_kernel.packet_apply_plain(B, torch.from_numpy(data), 8, ps)
    assert np.array_equal(be.apply_packet_xor(B, data, 8, ps), ref.numpy())
    assert np.array_equal(be.apply_packet_xor_async(B, data, 8, ps).wait(),
                          ref.numpy())
    assert np.array_equal(be.apply_packet_chunks(B, data, 8, ps),
                          ref.numpy())


def test_wrappers_on_cpu_run_plain_count_nothing_and_check_inputs():
    k, m, w, ps = 4, 2, 8, 32
    B = row_sets(k, m, w)[0][1]
    data = torch.from_numpy(rand(5, 2, k, 2 * w * ps))
    ops = [(packet_kernel, packet_kernel.packet_apply,
            carry.packet_operand(B, w, "cpu")),
           (packet_xor_kernel, packet_xor_kernel.packet_xor,
            carry.schedule_operand(build_xor_schedule(B), k, w, "cpu"))]
    want = packet_kernel.packet_apply_plain(B, data, w, ps)
    for mod, apply, op in ops:
        before = mod.launches
        assert torch.equal(apply(op, data, ps), want)
        buf = torch.empty_like(want)
        assert apply(op, data, ps, buf) is buf and torch.equal(buf, want)
        assert mod.launches == before
        for bad in (data.to(torch.int32), data[:, :3], data[:, :, :-ps],
                    data.mT.contiguous().mT, data.to("meta")):
            with pytest.raises(ValueError):
                apply(op, bad, ps)
        with pytest.raises(ValueError):
            apply(op, data, ps, torch.empty((2, m + 1, data.shape[2]),
                                            dtype=torch.uint8))


# the five packet techniques, at packet sizes that route to B2 and to B3
TECHNIQUES = [
    ("cauchy_orig", {"k": "4", "m": "2", "packetsize": "32"}),
    ("cauchy_good", {"k": "4", "m": "2", "packetsize": "128"}),
    ("cauchy_good", {"k": "10", "m": "4", "packetsize": "8"}),
    ("liberation", {"k": "5", "m": "3", "w": "7", "packetsize": "36"}),
    ("blaum_roth", {"k": "4", "m": "2", "w": "7", "packetsize": "128"}),
    ("liber8tion", {"k": "4", "m": "2", "packetsize": "8"}),
]


def trio(technique, profile):
    prof = dict(profile, technique=technique)
    reg = ref_registry.instance()
    return (registry.instance().factory("gpu", dict(prof, device="cpu")),
            reg.factory("tpu", dict(prof)), reg.factory("jerasure", prof))


@pytest.mark.parametrize("technique,profile", TECHNIQUES)
def test_gpu_packet_codec_matches_tpu(technique, profile):
    port, ref, _ = trio(technique, profile)
    k, n = port.k, port.get_chunk_count()
    L = 2 * port.core.chunk_size_multiple()
    data = rand(n, 2, k, L)
    parity = port.encode_batch(data)
    assert np.array_equal(parity, ref.encode_batch(data))
    chunks = {i: (data[:, i] if i < k else parity[:, i - k])
              for i in range(n)}
    for r in (1, 2):
        for erased in itertools.combinations(range(n), r):
            present = {i: c for i, c in chunks.items() if i not in erased}
            got = port.decode_batch(present, L)
            assert set(got) == set(erased)
            for e in erased:
                assert np.array_equal(got[e], chunks[e]), (erased, e)
            if erased in ((0,), (k - 1, n - 1)):
                want = ref.decode_batch(present, L)
                assert all(np.array_equal(want[e], got[e]) for e in erased)
    # the device-resident decode of the reference bench: data erasures
    erased = (0, 1)
    chosen = [i for i in range(n) if i not in erased][:k]
    stack = np.stack([chunks[i] for i in chosen], axis=1)
    dev, batch, Lp = port.stage_batch(stack)
    out = port.decode_batch_device(dev, chosen, erased).numpy()
    want = np.asarray(ref.decode_batch_device(jnp.asarray(stack), chosen,
                                              erased))
    assert np.array_equal(out[:batch, :, :Lp], want[:, :, :L])
    assert np.array_equal(out[:batch, :, :Lp], data[:, list(erased)])
    dev, batch, Lp = port.stage_batch(data)
    assert np.array_equal(port.encode_batch_device(dev).numpy(), parity)


@pytest.mark.parametrize("technique,profile", TECHNIQUES)
def test_encode_batch_async_matches_encode_and_jerasure(technique, profile):
    """Packet codes XOR whole packets per super-word; the async entry
    must give the parity that encode_batch, the reference and jerasure
    give."""
    port, ref, jer = trio(technique, profile)
    data = rand(port.k, 3, port.k, 3 * port.core.chunk_size_multiple())
    want = jer.core.encode_batch(data)
    assert np.array_equal(ref.encode_batch(data), want)
    assert np.array_equal(port.encode_batch(data), want)
    assert np.array_equal(port.encode_batch_async(data).wait(), want)


def test_prewarm_stages_packet_codes_by_super_word():
    port, _, _ = trio("cauchy_good", {"k": "4", "m": "2",
                                      "packetsize": "36"})
    be = port.core.backend
    sw = port.core.chunk_size_multiple()
    port.prewarm_geometry(sw + 1, batches=(3,))
    assert (4, 4, 2 * sw) in be.staging._made
    dev, batch, L = port.stage_batch(np.ones((1, 4, sw + 1), np.uint8))
    assert tuple(dev.shape) == (1, 4, 2 * sw) and (batch, L) == (1, sw + 1)
