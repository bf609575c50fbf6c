"""Tests of the port that need an NVIDIA card; each skips without one.

This file imports neither jax nor the JAX package, so on a machine with
a card and no jax it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Kernels B1, B2 and B3 are held against their plain PyTorch versions and
the numpy oracle, and the `gpu` plugin's CUDA path, byte codes and packet
codes, against the numpy oracle."""
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
@pytest.mark.parametrize("L", [100, 192, 320, 4096])
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
@pytest.mark.parametrize("ps", [4, 12, 36, 100, 128, 1000, 2048])
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
@pytest.mark.parametrize("offset", [1, 4, 8])
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
