"""Tests of the port that need an NVIDIA card; each skips without one.

This file imports neither jax nor the JAX package, so on a machine with
a card and no jax it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Kernels B1, B2 and B3 are held against their plain PyTorch versions and
the numpy oracle, and the `gpu` plugin's CUDA path, byte codes and packet
codes, against the numpy oracle.  B1 also takes crclinear's bitmatrices
of many syndrome bands (split into row groups), BlueStore's checksum
fold runs on it from the store's applier thread, and the ECBackend's
write, degraded read and recovery run on it through the batcher, in
one PG and in the port's 13-OSD cluster, of classic and of crimson
OSDs.  LRC's layers and CLAY's plane codes run on it through the gpu
plugin.  A crimson cluster with its manager writes a striped entity on
it, and the manager's scrape counts the batchers' encode calls."""
import numpy as np
import pytest
import torch

from ceph_tpu_torch.ec import registry
from ceph_tpu_torch.ops import (carry, gf8_kernel, packet_kernel,
                                packet_xor_kernel)
from ceph_tpu_torch.ops.engine import (CodecCore, NumpyBackend,
                                       bytes_to_packets, packets_to_bytes)
from ceph_tpu_torch.ops.matrix import (cauchy_good_coding_matrix,
                                       matrix_to_bitmatrix,
                                       reed_sol_vandermonde_coding_matrix)
from ceph_tpu_torch.ops.torch_engine import build_xor_schedule

GEOMETRIES = [(8, 4), (4, 2), (2, 1)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def row_sets(k, m):
    core = CodecCore(k, m, 8,
                     coding_matrix=reed_sol_vandermonde_coding_matrix(k, m, 8))
    erased = tuple(range(m - 1)) + (k + m - 1,)
    chosen = tuple(i for i in range(k + m) if i not in erased)[:k]
    rows_gf, rows_bits = core._recovery_rows(chosen, erased)
    return [(core.coding_matrix, core.bitmatrix), (rows_gf, rows_bits)]


@pytest.mark.cuda
@pytest.mark.parametrize("L", [100, 192, 320, 4096, 4100, 4104])
@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_kernel_matches_plain_and_oracle(card, k, m, L):
    rng = np.random.default_rng(k * L)
    host = rng.integers(0, 256, (3, k, L), dtype=np.uint8)
    data = torch.from_numpy(host).to(card)
    for rows, bits in row_sets(k, m):
        op = carry.carry_rows(rows, bits, card)
        before = gf8_kernel.launches
        out = gf8_kernel.gf8_apply(op, data)
        torch.cuda.synchronize()
        assert gf8_kernel.launches == before + 1
        assert torch.equal(out, gf8_kernel.gf8_apply_plain(bits, data))
        assert np.array_equal(out.cpu().numpy(),
                              NumpyBackend().apply_matrix(rows, host, 8))


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(card):
    rows, bits = row_sets(4, 2)[0]
    op = carry.carry_rows(rows, bits, card)
    with pytest.raises(ValueError):
        gf8_kernel.gf8_apply(op, torch.zeros((1, 4, 64), dtype=torch.uint8))
    with pytest.raises(ValueError):
        gf8_kernel.gf8_apply(op, torch.zeros((1, 64, 4), dtype=torch.uint8,
                                             device=card).mT)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 4, 8])
def test_kernel_at_misaligned_pointers(card, offset):
    """Views that start 1, 2, 4 or 8 bytes into a buffer take the byte,
    4-byte and 8-byte loads and stores."""
    k, m, L = 8, 4, 4096
    rows, bits = row_sets(k, m)[1]
    rng = np.random.default_rng(offset)
    flat = torch.from_numpy(rng.integers(0, 256, offset + 3 * k * L,
                                         dtype=np.uint8)).to(card)
    data = flat[offset:].view(3, k, L)
    outbuf = torch.zeros(offset + 3 * m * L + 16, dtype=torch.uint8,
                         device=card)
    out = outbuf[offset:offset + 3 * m * L].view(3, m, L)
    gf8_kernel.gf8_apply(carry.carry_rows(rows, bits, card), data, out)
    torch.cuda.synchronize()
    assert torch.equal(out, gf8_kernel.gf8_apply_plain(bits, data))
    # nothing written outside the view
    assert not outbuf[:offset].any() and not outbuf[offset + 3 * m * L:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("m_out", [4, 6, 16])
def test_kernel_at_its_widest_operand(card, m_out):
    """The widest m_out*k whose tables fit the wrapper's shared memory runs
    byte-equal to the plain version (outputs past 4 as further groups);
    one chunk more is refused before any launch."""
    k = gf8_kernel.MAX_TABLE_BYTES // (gf8_kernel.TABLE_BYTES * m_out)
    rng = np.random.default_rng(m_out)
    B = rng.integers(0, 2, (8 * m_out, 8 * k), dtype=np.uint8)
    data = torch.from_numpy(rng.integers(0, 256, (2, k, 100),
                                         dtype=np.uint8)).to(card)
    out = gf8_kernel.gf8_apply(carry.bitmatrix_operand(B, k, card), data)
    torch.cuda.synchronize()
    assert torch.equal(out, gf8_kernel.gf8_apply_plain(B, data))
    wider = np.zeros((8 * m_out, 8 * (k + 1)), dtype=np.uint8)
    before = gf8_kernel.launches
    with pytest.raises(ValueError, match="shared memory"):
        gf8_kernel.gf8_apply(
            carry.bitmatrix_operand(wider, k + 1, card),
            torch.zeros((1, k + 1, 16), dtype=torch.uint8, device=card))
    assert gf8_kernel.launches == before


@pytest.mark.cuda
def test_kernel_uses_no_local_memory(card):
    for unit in gf8_kernel.UNITS:
        nregs, local = gf8_kernel.regs(unit)
        assert 0 < nregs <= 255 and local == 0, (unit, nregs, local)


@pytest.mark.cuda
def test_gpu_plugin_on_cuda(card):
    codec = registry.instance().factory("gpu", {"k": "4", "m": "2"})
    assert codec.core.backend.device.type == "cuda"
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (5, 4, 1000), dtype=np.uint8)
    parity = NumpyBackend().apply_matrix(codec.core.coding_matrix, data, 8)
    before = gf8_kernel.launches
    assert np.array_equal(codec.encode_batch(data), parity)
    assert np.array_equal(codec.encode_batch_async(data).wait(), parity)
    present = {i: data[:, i] for i in (1, 3)}
    present.update({4: parity[:, 0], 5: parity[:, 1]})
    rec = codec.decode_batch_async(present, 1000).wait()
    assert np.array_equal(rec[0], data[:, 0])
    assert np.array_equal(rec[2], data[:, 2])
    assert gf8_kernel.launches >= before + 3
    packet = registry.instance().factory(
        "gpu", {"k": "4", "m": "2", "technique": "cauchy_good",
                "packetsize": "32"})
    data = rng.integers(0, 256, (2, 4, 4 * 8 * 32), dtype=np.uint8)
    before = packet_xor_kernel.launches
    assert np.array_equal(packet.encode_batch(data),
                          packet_oracle(packet.core.bitmatrix, data, 8, 32))
    assert packet_xor_kernel.launches == before + 1


@pytest.mark.cuda
def test_lrc_encode_batch_device_on_cuda(card):
    """LRC k=4 m=2 l=3 over the gpu plugin on the card: the
    device-resident layered encode launches B1 once a layer and equals
    the host walk of inner=jerasure; a loss inside a local group and a
    double loss that needs the global layer decode on B1."""
    codec = registry.instance().factory(
        "lrc", {"k": "4", "m": "2", "l": "3", "inner": "gpu"})
    host = registry.instance().factory(
        "lrc", {"k": "4", "m": "2", "l": "3"})
    assert all(layer.erasure_code.core.backend.is_cuda
               for layer in codec.layers)
    rng = np.random.default_rng(31)
    batch = rng.integers(0, 256, (6, 4, 4096 + 40), dtype=np.uint8)
    before = gf8_kernel.launches
    dev = codec.encode_batch_device(torch.from_numpy(batch).to(card))
    torch.cuda.synchronize()
    assert gf8_kernel.launches == before + len(codec.layers)
    assert dev.device.type == "cuda"
    assert np.array_equal(dev.cpu().numpy(), host.encode_batch(batch))
    data = rng.integers(0, 256, 50000, dtype=np.uint8).tobytes()
    encoded = host.encode(set(range(8)), data)
    assert codec.encode(set(range(8)), data) == encoded
    for lose in ((1,), (0, 1)):
        avail = {i: c for i, c in encoded.items() if i not in lose}
        before = gf8_kernel.launches
        dec = codec.decode(set(lose), avail)
        assert gf8_kernel.launches > before
        assert all(dec[e] == encoded[e] for e in lose)


@pytest.mark.cuda
def test_clay_repair_with_gpu_scalar_code_on_cuda(card):
    """CLAY k=4 m=2 d=5 with scalar_mds=gpu: encode, a double-loss
    decode and the repair of every lost chunk from its helpers' repair
    sub-chunks run their plane codes on B1 and equal scalar_mds=jerasure
    on the host."""
    codec = registry.instance().factory(
        "clay", {"k": "4", "m": "2", "scalar_mds": "gpu"})
    host = registry.instance().factory("clay", {"k": "4", "m": "2"})
    assert codec.mds.core.backend.is_cuda and codec.pft.core.backend.is_cuda
    rng = np.random.default_rng(32)
    size = host.get_chunk_size(1) * 4 * 64
    data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    before = gf8_kernel.launches
    encoded = codec.encode(set(range(6)), data)
    assert gf8_kernel.launches > before
    assert encoded == host.encode(set(range(6)), data)
    cs = len(encoded[0])
    avail = {i: c for i, c in encoded.items() if i not in (0, 5)}
    dec = codec.decode({0, 5}, avail, cs)
    assert dec[0] == encoded[0] and dec[5] == encoded[5]
    sc = cs // codec.get_sub_chunk_count()
    for lost in range(6):
        minimum = codec.minimum_to_decode({lost}, set(range(6)) - {lost})
        helpers = {i: b"".join(encoded[i][o * sc:(o + c) * sc]
                               for o, c in runs)
                   for i, runs in minimum.items()}
        before = gf8_kernel.launches
        out = codec.decode({lost}, helpers, cs)
        assert gf8_kernel.launches > before
        assert out[lost] == encoded[lost]


def packet_oracle(B, data, w, ps):
    pk = bytes_to_packets(data, w, ps)
    return packets_to_bytes(NumpyBackend().apply_bitmatrix_packets(B, pk),
                            w, ps)


def packet_row_sets(k, m, w):
    """A cauchy_good encode bitmatrix and the decode rows of m data
    erasures."""
    B = matrix_to_bitmatrix(cauchy_good_coding_matrix(k, m, w), w)
    core = CodecCore(k, m, w, bitmatrix=B, layout="packet", packetsize=4)
    _, rows = core._decode_rows(tuple(range(m, k + m)), tuple(range(m)))
    return [B, rows]


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [4, 12, 36, 100, 128, 520, 1000, 1040,
                                2048, 4096])
@pytest.mark.parametrize("k,m,w", [(10, 4, 8), (4, 2, 8), (5, 3, 7)])
def test_packet_kernels_match_plain_and_oracle(card, k, m, w, ps):
    rng = np.random.default_rng(k * ps + w)
    host = rng.integers(0, 256, (3, k, 2 * w * ps), dtype=np.uint8)
    data = torch.from_numpy(host).to(card)
    for B in packet_row_sets(k, m, w):
        want = packet_kernel.packet_apply_plain(B, data, w, ps)
        assert np.array_equal(want.cpu().numpy(),
                              packet_oracle(B, host, w, ps))
        op = carry.packet_operand(B, w, card)
        sop = carry.schedule_operand(build_xor_schedule(B), k, w, card)
        for mod, got in ((packet_kernel,
                          lambda: packet_kernel.packet_apply(op, data, ps)),
                         (packet_xor_kernel,
                          lambda: packet_xor_kernel.packet_xor(sop, data,
                                                               ps))):
            before = mod.launches
            out = got()
            torch.cuda.synchronize()
            assert mod.launches == before + 1
            assert torch.equal(out, want), (mod.__name__, k, m, w, ps)
        assert torch.equal(packet_xor_kernel.packet_xor_plain(
            sop.schedule, data, w, ps), want)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 4, 8])
def test_packet_kernels_at_misaligned_pointers(card, offset):
    k, m, w, ps = 4, 2, 8, 64
    B = packet_row_sets(k, m, w)[0]
    L = 2 * w * ps
    rng = np.random.default_rng(offset)
    flat = torch.from_numpy(rng.integers(0, 256, offset + 3 * k * L,
                                         dtype=np.uint8)).to(card)
    data = flat[offset:].view(3, k, L)
    want = packet_kernel.packet_apply_plain(B, data, w, ps)
    outbuf = torch.empty(offset + 3 * m * L, dtype=torch.uint8, device=card)
    out = outbuf[offset:].view(3, m, L)
    packet_kernel.packet_apply(carry.packet_operand(B, w, card), data, ps,
                               out)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    out.zero_()
    packet_xor_kernel.packet_xor(
        carry.schedule_operand(build_xor_schedule(B), k, w, card), data, ps,
        out)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_packet_kernels_refuse_what_they_cannot_take(card):
    k, w, ps = 4, 8, 32
    B = packet_row_sets(k, 2, w)[0]
    good = torch.zeros((1, k, 2 * w * ps), dtype=torch.uint8, device=card)
    for apply, op in ((packet_kernel.packet_apply,
                       carry.packet_operand(B, w, card)),
                      (packet_xor_kernel.packet_xor,
                       carry.schedule_operand(build_xor_schedule(B), k, w,
                                              card))):
        for bad in (good.cpu(), good[:, :, :-ps], good.mT.contiguous().mT,
                    good.to(torch.int16)):
            with pytest.raises(ValueError):
                apply(op, bad, ps)
    # k=256 m=32 w=8: its masks and its schedule outgrow shared memory
    wide = np.random.default_rng(0).integers(0, 2, (256, 2048),
                                             dtype=np.uint8)
    data = torch.zeros((1, 256, 8 * ps), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="shared memory"):
        packet_kernel.packet_apply(carry.packet_operand(wide, 8, card),
                                   data, ps)
    with pytest.raises(ValueError, match="shared memory"):
        packet_xor_kernel.packet_xor(
            carry.schedule_operand(build_xor_schedule(wide), 256, 8, card),
            data, ps)


def parity_rows(k, w):
    """The XOR-parity bitmatrix [w, k*w]: output packet i is the XOR of
    packet i of every chunk, so its schedule has k*w entries."""
    return np.tile(np.eye(w, dtype=np.uint8), (1, k))


@pytest.mark.cuda
def test_packet_kernels_at_their_largest_k(card):
    """The widest k*w each wrapper takes on this card runs byte-equal to
    the plain version; one chunk more is refused before any launch."""
    w, ps = 8, 16
    limit = packet_kernel.smem_limit(card)
    cases = (
        (packet_kernel.packet_apply,
         lambda k: carry.packet_operand(parity_rows(k, w), w, card),
         lambda k: packet_kernel.tile_plan(
             ps, lambda t: packet_kernel.bitplane_smem(k * w, w, t))[1]),
        (packet_xor_kernel.packet_xor,
         lambda k: carry.schedule_operand(
             build_xor_schedule(parity_rows(k, w)), k, w, card),
         lambda k: packet_kernel.tile_plan(
             ps, lambda t: packet_xor_kernel.xor_smem(k * w, w, k * w,
                                                      t))[1]))
    for apply, operand, smem in cases:
        k = 1
        while smem(k + 1) <= limit:
            k += 1
        assert k * w > 4000, (apply.__name__, k)
        rng = np.random.default_rng(k)
        data = torch.from_numpy(rng.integers(0, 256, (2, k, 3 * w * ps),
                                             dtype=np.uint8)).to(card)
        op = operand(k)
        out = apply(op, data, ps)
        torch.cuda.synchronize()
        assert torch.equal(out, packet_kernel.packet_apply_plain(
            parity_rows(k, w), data, w, ps)), apply.__name__
        wider = torch.zeros((1, k + 1, w * ps), dtype=torch.uint8,
                            device=card)
        with pytest.raises(ValueError, match="shared memory"):
            apply(operand(k + 1), wider, ps)


@pytest.mark.cuda
@pytest.mark.parametrize("technique,profile,kernel", [
    ("cauchy_orig", {"k": "4", "m": "2", "packetsize": "32"},
     packet_xor_kernel),
    ("cauchy_good", {"k": "10", "m": "4"}, packet_kernel),
    ("liberation", {"k": "5", "m": "3", "w": "7", "packetsize": "36"},
     packet_xor_kernel),
    ("blaum_roth", {"k": "4", "m": "2", "w": "7", "packetsize": "128"},
     packet_kernel),
    ("liber8tion", {"k": "4", "m": "2", "packetsize": "8"},
     packet_xor_kernel),
])
def test_gpu_packet_codecs_on_cuda(card, technique, profile, kernel):
    codec = registry.instance().factory(
        "gpu", dict(profile, technique=technique))
    core = codec.core
    k, n = codec.k, codec.get_chunk_count()
    L = 2 * core.chunk_size_multiple()
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, (3, k, L), dtype=np.uint8)
    parity = packet_oracle(core.bitmatrix, data, core.w, core.packetsize)
    before = kernel.launches
    assert np.array_equal(codec.encode_batch(data), parity)
    assert np.array_equal(codec.encode_batch_async(data).wait(), parity)
    chunks = {i: (data[:, i] if i < k else parity[:, i - k])
              for i in range(n)}
    erased = (0, n - 1)
    rec = codec.decode_batch({i: c for i, c in chunks.items()
                              if i not in erased}, L)
    assert all(np.array_equal(rec[e], chunks[e]) for e in erased)
    chosen = list(range(2, k + 2))
    dev, batch, Lp = codec.stage_batch(
        np.stack([chunks[i] for i in chosen], axis=1))
    out = codec.decode_batch_device(dev, chosen, (0, 1)).cpu().numpy()
    assert np.array_equal(out[:batch, :, :L], data[:, :2])
    assert kernel.launches >= before + 5


@pytest.mark.cuda
def test_batcher_encode_lane_on_cuda(card):
    """The OSD batcher's encode lane on the card: writes from several
    threads coalesce into fewer B1 launches than requests, every chunk
    map equals the CPU twin's (jerasure), no group is served by the
    twin, and a sampled staging transfer feeds the h2d EWMA."""
    import threading

    from ceph_tpu_torch.osd import ecutil
    from ceph_tpu_torch.osd.batcher import EncodeBatcher

    codec = registry.instance().factory("gpu", {"k": "8", "m": "4"})
    sinfo = ecutil.StripeInfo(8, 8 * 4096)
    rng = np.random.default_rng(8)
    objs = [rng.integers(0, 256, 4 * sinfo.stripe_width,
                         dtype=np.uint8).tobytes() for _ in range(16)]
    EncodeBatcher.reset_learning()
    b = EncodeBatcher({"ec_tpu_batch_stripes": 64,
                       "ec_tpu_queue_window_us": 20_000,
                       "ec_tpu_fallback_cpu": False})
    try:
        codec.core.backend.staging._puts = 0   # sample the first put
        got = [None] * len(objs)
        left = threading.Semaphore(0)

        def write(i):
            b.submit(codec, sinfo, objs[i],
                     lambda c: (got.__setitem__(i, c), left.release()))
        before = gf8_kernel.launches
        threads = [threading.Thread(target=write, args=(i,))
                   for i in range(len(objs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for _ in objs:
            assert left.acquire(timeout=120)
        launched = gf8_kernel.launches - before
        assert 1 <= launched < len(objs)
        assert b.calls == launched and b.reqs_total == len(objs)
        assert b.cpu_reqs == 0 and b.device_errors == 0
        twin = b.cpu_twin(codec, sinfo)
        for obj, chunks in zip(objs, got):
            assert chunks == ecutil.encode(sinfo, twin, obj)
        assert EncodeBatcher._h2d_bps > 0
    finally:
        b.stop()
        EncodeBatcher.reset_learning()


@pytest.mark.cuda
@pytest.mark.parametrize("bands", [(1, 2, 3, 4), (1, 0x8E, 0x47, 0xF4, 3)])
def test_b1_takes_crclinear_windows_of_many_bands(card, bands):
    """A [32 * bands, 4096] bitmatrix is past one launch's tables: the
    backend applies it in row groups of 4 outputs, one launch each,
    byte-equal to the plain version of the whole bitmatrix."""
    from ceph_tpu_torch.ops import crclinear
    from ceph_tpu_torch.ops.torch_engine import TorchBackend

    M = crclinear.shared().block_bitmatrix(bands)
    rng = np.random.default_rng(len(bands))
    x = rng.integers(0, 256, (64, 512, 8), dtype=np.uint8)
    be = TorchBackend()
    before = gf8_kernel.launches
    got = be.apply_bitmatrix_bytes(M, x, 8)
    assert gf8_kernel.launches == before + len(bands)
    want = gf8_kernel.gf8_apply_plain(M, torch.from_numpy(x).to(card))
    assert np.array_equal(got, want.cpu().numpy())


@pytest.mark.cuda
def test_crclinear_at_the_store_shape(card):
    """BlueStore folds one apply entry's checksums at once: a 4 MiB
    write is 1024 blocks of 4 KiB in one window, [1024, 512, 8] on B1,
    equal to the host route and to crc32c."""
    from ceph_tpu_torch.ops import crclinear
    from ceph_tpu_torch.ops.torch_engine import TorchBackend
    from ceph_tpu_torch.utils.crc import crc32c

    lin = crclinear.Crc32cLinear()
    rng = np.random.default_rng(1024)
    flat = rng.integers(0, 256, 1024 * 4096, dtype=np.uint8)
    blocks = [flat[i * 4096:(i + 1) * 4096].tobytes()
              for i in range(1024)]
    before = gf8_kernel.launches
    got = lin.crc_batch(blocks, backend=TorchBackend())
    assert gf8_kernel.launches == before + 1 and lin.host_fallbacks == 0
    assert [int(g) for g in got] == [crc32c(b) for b in blocks]
    assert np.array_equal(got, lin.crc_batch(blocks))


@pytest.mark.cuda
def test_bluestore_checksums_on_b1_from_its_applier(card):
    """Writes from several threads through a RAM BlueStore wired to a
    CUDA backend: every checksum batch of more than one block runs on
    B1 from the applier thread, none falls back, every object reads
    back (verifying each block's CRC)."""
    import threading

    from ceph_tpu_torch.ops import crclinear
    from ceph_tpu_torch.ops.torch_engine import TorchBackend
    from ceph_tpu_torch.store import BlueStore, GHObject, Transaction

    be = TorchBackend()
    store = BlueStore()
    store.mkfs()
    store.mount()
    store.attach_device_batcher(lambda: be)
    store.queue_transactions([Transaction().create_collection("1.0s0")])
    rng = np.random.default_rng(4)
    objs = [rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
            for _ in range(32)]
    fallbacks = crclinear.shared().host_fallbacks
    before = gf8_kernel.launches

    def write(i):
        store.queue_transactions([Transaction().write(
            "1.0s0", GHObject(f"o{i}", 0), 0, objs[i])])
    threads = [threading.Thread(target=write, args=(i,))
               for i in range(len(objs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    store.flush()
    try:
        csum = store.usage()["csum"]
        assert csum["device_batches"] >= 1 and csum["device_errors"] == 0
        assert gf8_kernel.launches - before == csum["device_batches"]
        assert crclinear.shared().host_fallbacks == fallbacks
        for i, obj in enumerate(objs):
            assert store.read("1.0s0", GHObject(f"o{i}", 0)) == obj
    finally:
        store.umount()


@pytest.mark.cuda
def test_ecbackend_write_degraded_read_and_recovery_on_cuda(card):
    """One k=8 m=4 ECBackend (4 KiB stripe unit) over an EncodeBatcher on
    the card: a 4 MiB write (two segments through the encode lane), a
    degraded read with shards (1, 5, 9, 11) down and the recovery of a
    wiped shard 3, both through the decode lane; every shard equals the
    CPU twin's encode, B1 launches in each step, and no request takes the
    twin."""
    import threading

    from ceph_tpu_torch.osd import ecutil
    from ceph_tpu_torch.osd.backend import Mutation, PGHost
    from ceph_tpu_torch.osd.batcher import EncodeBatcher
    from ceph_tpu_torch.osd.ecbackend import ECBackend
    from ceph_tpu_torch.osd.pglog import MODIFY, LogEntry
    from ceph_tpu_torch.store import GHObject, MemStore, Transaction

    k, m, sw = 8, 4, 8 * 4096
    lock = threading.RLock()
    acting = [(s, s) for s in range(k + m)]
    EncodeBatcher.reset_learning()
    b = EncodeBatcher({"ec_tpu_batch_stripes": 512,
                       "ec_tpu_queue_window_us": 2000,
                       "ec_tpu_fallback_cpu": False,
                       "osd_ec_prewarm": False})
    hosts = {}

    class Host(PGHost):
        def __init__(self, s):
            self.s, self.lock = s, lock
            self.encode_batcher = b if s == 0 else None
            self._store = MemStore()
            self._store.mount()
            self._store.mkfs()
            self._store.queue_transactions(
                [Transaction().create_collection(f"1.0s{s}")])

        whoami = property(lambda self: self.s)
        own_shard = property(lambda self: self.s)
        pgid_str = property(lambda self: "1.0")
        store = property(lambda self: self._store)
        epoch = property(lambda self: 1)

        def coll_of(self, shard):
            return f"1.0s{shard}"

        def acting_shards(self):
            return acting

        def send_shard(self, osd, msg):
            with lock:
                assert hosts[osd].backend.handle_message(msg)

        def prepare_log_txn(self, txn, entries):
            pass

        def on_local_commit(self, fn):
            with lock:
                fn()

    codec = registry.instance().factory("gpu", {"k": str(k), "m": str(m)})
    sinfo = ecutil.StripeInfo(k, sw)
    try:
        for s in range(k + m):
            hosts[s] = Host(s)
            hosts[s].backend = ECBackend(hosts[s], codec, sw)
        primary = hosts[0].backend
        data = np.random.default_rng(12).integers(
            0, 256, 4 << 20, dtype=np.uint8).tobytes()

        def run(start):
            done, res = threading.Event(), []
            with lock:
                start(lambda *r: (res.append(r), done.set()))
            assert done.wait(120)
            for h in hosts.values():
                h.store.flush()
            return res[0]

        def shard(s):
            return hosts[s].store.read(f"1.0s{s}", GHObject("obj", s))

        n0 = gf8_kernel.launches
        assert run(lambda cb: primary.submit_transaction(
            "obj", Mutation(writes=[(0, data)]), (1, 1),
            [LogEntry(MODIFY, "obj", (1, 1))], cb)) == (0,)
        n1 = gf8_kernel.launches
        want = ecutil.encode(sinfo, b.cpu_twin(codec, sinfo), data)
        assert all(shard(s) == bytes(want[s]) for s in range(k + m))
        acting[:] = [(s, None if s in (1, 5, 9, 11) else s)
                     for s in range(k + m)]
        res = run(lambda cb: primary.objects_read("obj", 0, len(data), cb))
        assert res[0] == 0 and bytes(res[1]) == data
        n2 = gf8_kernel.launches
        acting[:] = [(s, s) for s in range(k + m)]
        hosts[3].store.queue_transactions([Transaction().remove(
            "1.0s3", GHObject("obj", 3))])
        hosts[3].store.flush()
        assert run(lambda cb: primary.recover_object(
            "obj", (1, 1), [(3, 3)], cb)) == (0,)
        assert shard(3) == bytes(want[3])
        n3 = gf8_kernel.launches
        assert n1 > n0 and n2 > n1 and n3 > n2
        assert b.cpu_reqs == b.dec_cpu_reqs == b.device_errors == 0
        assert primary.twin_routes == primary.device_errors == 0
    finally:
        b.stop()
        for h in hosts.values():
            h.store.umount()
        EncodeBatcher.reset_learning()


def cluster_k8m4_on_cuda(**backend):
    """A mon, 13 OSDs on RAM BlueStores and a client over the loopback
    messenger, a `gpu` k=8 m=4 pool of 4 PGs (no device key: CUDA):
    writes, a degraded read with osd.0 lost, its rebuild to clean.
    Every read byte-exact, every shard on the OSD its acting set names
    equal to the jerasure encode, B1 launched in each step, no twin
    route or device error.  ``backend`` is ``osd_backend=...`` or
    nothing, for the config default.  Returns the OSDs' class names."""
    from ceph_tpu_torch.cluster import Cluster, test_config
    from ceph_tpu_torch.osd import ecutil
    from ceph_tpu_torch.osd.batcher import EncodeBatcher
    from ceph_tpu_torch.store import GHObject

    k, m = 8, 4
    codec = registry.instance().factory("gpu", {"k": str(k), "m": str(m)})
    codec.prewarm_geometry(4096, batches=(1, 2, 4, 8, 16, 32, 64, 128))
    EncodeBatcher.reset_learning()
    conf = test_config(osd_heartbeat_interval=0.5,
                       osd_heartbeat_grace=10.0,
                       mon_osd_down_out_interval=60.0,
                       osd_pool_default_pg_num=4,
                       ec_tpu_fallback_cpu=False, **backend)
    rng = np.random.default_rng(13)
    payloads = {f"c{i}": rng.integers(0, 256, 100_000 + 4096 * i,
                                      dtype=np.uint8).tobytes()
                for i in range(6)}

    def faults(c):
        osds = [o for o in c.osds.values() if o is not None]
        bes = [pg.backend for o in osds for pg in o.pgs.values()
               if hasattr(pg.backend, "twin_routes")]
        return (sum(o.encode_batcher.cpu_reqs + o.encode_batcher.dec_cpu_reqs
                    + o.encode_batcher.device_errors for o in osds)
                + sum(be.twin_routes + be.device_errors for be in bes))

    with Cluster(n_osds=13, conf=conf, store_kind="bluestore") as c:
        for i in range(13):
            c.wait_for_osd_up(i, 60)
        kinds = {type(o).__name__ for o in c.osds.values()}
        c.create_ec_profile("cu", plugin="gpu", k=str(k), m=str(m))
        c.create_pool("cup", "erasure", erasure_code_profile="cu")
        client = c.rados(timeout=30)
        client.op_timeout = 120.0
        io = client.open_ioctx("cup")
        n0 = gf8_kernel.launches
        for name, data in payloads.items():
            io.write_full(name, data)
        n1 = gf8_kernel.launches
        assert all(io.read(n) == d for n, d in payloads.items())
        c.wait_for_clean(60)
        c.kill_osd(0, lose_data=True)
        c.wait_for_osd_down(0, 60)
        n2 = gf8_kernel.launches
        assert all(io.read(n) == d for n, d in payloads.items())
        n3 = gf8_kernel.launches
        c.revive_osd(0)
        c.wait_for_osd_up(0, 60)
        c.wait_for_clean(180)
        n4 = gf8_kernel.launches
        assert all(io.read(n) == d for n, d in payloads.items())
        assert n1 > n0 and n3 > n2 and n4 > n3
        assert faults(c) == 0
        jer = registry.instance().factory("jerasure",
                                          {"k": str(k), "m": str(m)})
        sinfo = ecutil.StripeInfo(k, k * 4096)
        osdmap = c.mon.osdmap
        for name, data in payloads.items():
            pgid = osdmap.object_locator_to_pg(name, io.pool_id)
            _, _, acting, _ = osdmap.pg_to_up_acting_osds(pgid)
            padded = data + bytes(-len(data) % sinfo.stripe_width)
            want = ecutil.encode(sinfo, jer, padded)
            for s, osd_id in enumerate(acting):
                got = c.stores[osd_id].read(f"{pgid}s{s}", GHObject(name, s))
                assert bytes(got) == bytes(want[s]), (name, s, osd_id)
    return kinds


@pytest.mark.cuda
def test_cluster_k8m4_write_degraded_read_and_rebuild_on_cuda(card):
    """The port's 13-OSD k=8 m=4 cluster on the card with classic OSDs
    (cluster_k8m4_on_cuda)."""
    assert cluster_k8m4_on_cuda(osd_backend="classic") == {"OSD"}


@pytest.mark.cuda
def test_crimson_cluster_k8m4_write_degraded_read_and_rebuild_on_cuda(card):
    """The same cluster with osd_backend left at its default: 13 crimson
    OSDs, whose reactors run the PGs and the BlueStore apply that folds
    checksums on B1."""
    assert cluster_k8m4_on_cuda() == {"CrimsonOSD"}


@pytest.mark.cuda
def test_crimson_cluster_with_mgr_stripes_on_cuda(card):
    """A mon, a mgr with its seven modules and 6 crimson OSDs, a `gpu`
    k=4 m=2 pool (no device key: CUDA) with overwrites: an entity of 4
    MiB written through the striper with the default Layout() launches
    B1 and reads back exact, and so does a 5,000-byte overwrite.  Then,
    with the cluster quiet, the manager's prometheus scrape holds as
    many batcher encode calls as the OSDs' own perf dumps."""
    import re
    import time
    import urllib.request

    from ceph_tpu_torch.client.striper import Layout, StripedIoCtx
    from ceph_tpu_torch.cluster import Cluster, test_config

    conf = test_config(mgr_tick_interval=0.3, osd_pool_default_pg_num=8,
                       ec_tpu_fallback_cpu=False)
    rng = np.random.default_rng(12)
    data = bytearray(rng.integers(0, 256, 4 << 20, dtype=np.uint8).tobytes())
    patch = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    with Cluster(n_osds=6, conf=conf, with_mgr=True) as c:
        for i in range(6):
            c.wait_for_osd_up(i, 60)
        assert {type(o).__name__ for o in c.osds.values()} == {"CrimsonOSD"}
        assert sorted(c.mgr.modules.active) == [
            "alerts", "balancer", "dashboard", "pg_autoscaler",
            "prometheus", "restful", "tuner"]
        c.create_ec_profile("cs", plugin="gpu", k="4", m="2")
        c.create_pool("csp", "erasure", erasure_code_profile="cs")
        ret, rs, _ = c.mon_command({"prefix": "osd pool set",
                                    "pool": "csp",
                                    "var": "allow_ec_overwrites",
                                    "val": "true"})
        assert ret == 0, rs
        client = c.rados(timeout=30)
        client.op_timeout = 120.0
        client.wait_for_epoch(c.mon.osdmap.epoch, 30)
        sio = StripedIoCtx(client.open_ioctx("csp"), Layout())
        n0 = gf8_kernel.launches
        sio.write("ent", bytes(data))
        n1 = gf8_kernel.launches
        assert n1 > n0
        assert sio.read("ent") == bytes(data)
        sio.write("ent", patch, 70_000)
        data[70_000:75_000] = patch
        assert sio.read("ent") == bytes(data)
        osds = [(i, o) for i, o in sorted(c.osds.items()) if o is not None]

        def dumps():
            return {f"osd.{i}": o._exec_command({"prefix": "perf dump"})[2][
                "osd"]["ec_batch_calls"] for i, o in osds}

        before = dumps()
        t_quiet = time.time()
        deadline = time.monotonic() + 30
        while True:
            with c.mgr.lock:
                req = [v["req_ts"] for v in c.mgr.daemon_perf.values()]
            if len(req) == 6 and min(req) >= t_quiet + 0.3:
                break
            assert time.monotonic() < deadline, req
            time.sleep(0.1)
        host, port = c.mgr.http_addr
        body = urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                      timeout=30).read().decode()
        assert dumps() == before
        got = {m.group(1): int(m.group(2)) for m in re.finditer(
            r'^ceph_osd_ec_batch_calls\{daemon="(osd\.\d+)"\} (\d+)$',
            body, re.M)}
        assert got == before
        assert sum(got.values()) == sum(o.encode_batcher.calls
                                        for _, o in osds) > 0
        assert sum(o.encode_batcher.cpu_reqs + o.encode_batcher.device_errors
                   for _, o in osds) == 0
