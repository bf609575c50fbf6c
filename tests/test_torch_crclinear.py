"""The port's crclinear (ceph_tpu_torch/ops/crclinear.py) and the split
of a large bitmatrix into blocks that kernel B1 takes, on the CPU.

Twins of the crclinear tests of tests/test_decode_pipeline.py; the split
plan on its own; the split apply against one unsplit plain apply for 1
to 5 syndrome bands; the port's windows through a CPU TorchBackend bit
for bit equal to the JAX package's crclinear through its CPU JaxBackend
(XLA's byte-domain apply, no Pallas); and a counted host fallback.
"""
import numpy as np
import pytest
import torch

from ceph_tpu.ops import crclinear as ref_crclinear
from ceph_tpu.ops.jax_engine import JaxBackend
from ceph_tpu_torch.ec import registry
from ceph_tpu_torch.ops import crclinear
from ceph_tpu_torch.ops.carry import bitmatrix_split
from ceph_tpu_torch.ops.gf8_kernel import (MAX_PAIRS, gf8_apply_plain,
                                           split_plan)
from ceph_tpu_torch.ops.torch_engine import TorchBackend, gf8_apply_split
from ceph_tpu_torch.utils.crc import crc32c

SEED = 20261017
# syndrome scales of a data shard, as deep scrub folds them after the
# data band (osd/ecbackend.py builds (1,) + the shard's nonzero scales)
BANDS = [(1,), (1, 2), (1, 2, 3, 4), (1, 0x8E, 0x47, 0xF4, 0x03),
         (0x1D, 0xFF)]
LENGTHS = (1, 7, 511, 512, 513, 1024 + 5, 3 * 512 + 257)


def make_codec(k, m):
    return registry.instance().factory(
        "gpu", {"k": str(k), "m": str(m), "technique": "reed_sol_van",
                "device": "cpu"})


# ------------------------------ twins of tests/test_decode_pipeline.py

def test_crclinear_bit_exact_vs_crc32c_kernel():
    lin = crclinear.shared()
    rng = np.random.default_rng(7)
    chunks = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in (1, 7, 511, 512, 513, 1024, 4096, 10000)]
    got = lin.crc_batch(chunks)
    for c, g in zip(chunks, got):
        assert int(g) == crc32c(c)


def test_crclinear_backend_apply_matches_host():
    codec = make_codec(2, 1)
    backend = codec.core.backend
    lin = crclinear.shared()
    fallbacks = lin.host_fallbacks
    rng = np.random.default_rng(9)
    chunks = [rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
              for _ in range(5)]
    got = lin.crc_batch(chunks, backend=backend)
    for c, g in zip(chunks, got):
        assert int(g) == crc32c(c)
    assert lin.host_fallbacks == fallbacks


def test_crclinear_syndrome_partials_cancel_on_codeword():
    """Per-shard linear-CRC partials of C[e][s]-scaled chunks XOR to
    zero across a valid codeword, and one corrupted shard breaks the
    cancellation."""
    k, m = 2, 1
    codec = make_codec(k, m)
    cm = codec.core.coding_matrix
    lin = crclinear.shared()
    cs = 2048
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, (1, k, cs), dtype=np.uint8)
    parity = codec.encode_batch(data)
    shards = [np.ascontiguousarray(data[0, s]) for s in range(k)]
    shards += [np.ascontiguousarray(parity[0, e]) for e in range(m)]

    def partials(shard_arrays):
        syn = [0] * m
        for s, arr in enumerate(shard_arrays):
            if s < k:
                scales = [int(cm[e][s]) for e in range(m)]
            else:
                scales = [1 if e == s - k else 0 for e in range(m)]
            nz = sorted({x for x in scales if x})
            if not nz:
                continue
            parts = lin._apply_window(arr.reshape(1, cs), tuple(nz))
            for e, sc in enumerate(scales):
                if sc:
                    syn[e] ^= int(parts[nz.index(sc)][0])
        return syn

    assert partials(shards) == [0] * m, \
        "syndrome partials must cancel on a consistent codeword"
    bad = [a.copy() for a in shards]
    bad[0][100] ^= 0x5A
    assert any(partials(bad)), \
        "corrupted shard must break the syndrome cancellation"


# ------------------------------------------------------ the split plan

@pytest.mark.parametrize("m_out,k", [(4, 8), (4, 512), (8, 512),
                                     (20, 512), (3, 2048), (1, 1),
                                     (2049, 1), (3, 2049), (2, 5000)])
def test_split_plan_covers_each_pair_once(m_out, k):
    plan = split_plan(m_out, k)
    seen = np.zeros((m_out, k), dtype=np.int64)
    for r0, r1, c0, c1 in plan:
        assert 0 <= r0 < r1 <= m_out and 0 <= c0 < c1 <= k
        assert (r1 - r0) * (c1 - c0) <= MAX_PAIRS
        seen[r0:r1, c0:c1] += 1
    assert (seen == 1).all()
    # row groups in order, the blocks of one row group together
    assert [b[0] for b in plan] == sorted(b[0] for b in plan)
    if m_out * k <= MAX_PAIRS:
        assert plan == [(0, m_out, 0, k)]
    elif k <= MAX_PAIRS:
        # whole rows: as many as fit, each block reads every chunk
        assert all((c0, c1) == (0, k) for _, _, c0, c1 in plan)
        assert len(plan) == -(-m_out // (MAX_PAIRS // k))
    else:
        # k alone is too large: one output a block, chunks in groups
        assert all(r1 - r0 == 1 for r0, r1, _, _ in plan)
        assert len(plan) == m_out * -(-k // MAX_PAIRS)


def test_split_plan_scrub_shapes_and_limits():
    # crclinear's window: k = 512 byte positions, 4 outputs a band
    assert split_plan(4, 512) == [(0, 4, 0, 512)]
    assert split_plan(20, 512) == [(4 * g, 4 * g + 4, 0, 512)
                                   for g in range(5)]
    assert split_plan(3, 5, max_pairs=4) == [
        (0, 1, 0, 4), (0, 1, 4, 5), (1, 2, 0, 4), (1, 2, 4, 5),
        (2, 3, 0, 4), (2, 3, 4, 5)]
    for bad in ((0, 4), (4, 0)):
        with pytest.raises(ValueError):
            split_plan(*bad)


@pytest.mark.parametrize("bands", BANDS[:4], ids=lambda b: f"{len(b)}band")
def test_split_apply_equals_unsplit_plain(bands):
    lin = crclinear.shared()
    M = lin.block_bitmatrix(bands)
    rng = np.random.default_rng(SEED + len(bands))
    x = rng.integers(0, 256, (3, lin.block, 5), dtype=np.uint8)
    want = gf8_apply_plain(torch.from_numpy(M), torch.from_numpy(x))
    split = bitmatrix_split(M, lin.block, "cpu")
    assert len(split.blocks) == len(bands)
    got = gf8_apply_split(split, torch.from_numpy(x))
    assert torch.equal(got, want)
    # and through the backend, staged at its own length
    be = TorchBackend("cpu")
    assert np.array_equal(be.apply_bitmatrix_bytes(M, x, 8), want.numpy())


def test_split_apply_xors_chunk_groups():
    """k past MAX_PAIRS: each output sums the blocks of its chunk
    groups, and a given ``out`` is filled in place."""
    rng = np.random.default_rng(SEED)
    k = MAX_PAIRS + 300
    B = rng.integers(0, 2, (16, 8 * k), dtype=np.uint8)
    x = torch.from_numpy(rng.integers(0, 256, (2, k, 3), dtype=np.uint8))
    split = bitmatrix_split(B, k, "cpu")
    assert len(split.blocks) == 4 and split.nbytes > 0
    out = torch.full((2, 2, 3), 0xA5, dtype=torch.uint8)
    assert gf8_apply_split(split, x, out) is out
    assert torch.equal(out, gf8_apply_plain(torch.from_numpy(B), x))
    with pytest.raises(ValueError):
        gf8_apply_split(split, x[:, :k - 1])


def test_backend_caches_one_split_per_bitmatrix():
    be = TorchBackend("cpu")
    M = crclinear.shared().block_bitmatrix(BANDS[3])
    x = np.zeros((2, 512, 8), dtype=np.uint8)
    for _ in range(2):
        be.apply_bitmatrix_bytes(M, x, 8)
    assert be.memory_stats()["compile_cache_entries"] == 1
    assert be.memory_stats()["dev_matrix_bytes"] > M.nbytes


# ------------------------------- the port against the JAX package

@pytest.mark.parametrize("bands", BANDS, ids=lambda b: "-".join(map(str, b)))
def test_apply_window_matches_jax_package(bands):
    port, ref = crclinear.Crc32cLinear(), ref_crclinear.Crc32cLinear()
    be, jbe = TorchBackend("cpu"), JaxBackend()
    rng = np.random.default_rng(SEED + sum(bands))
    for L in LENGTHS:
        stack = rng.integers(0, 256, (3, L), dtype=np.uint8)
        want = ref._apply_window(stack, bands, backend=jbe)
        assert np.array_equal(ref._apply_window(stack, bands), want)
        got = port._apply_window(stack, bands, backend=be)
        assert got.dtype == want.dtype and np.array_equal(got, want), L
        assert np.array_equal(port._apply_window(stack, bands), want)
    assert port.host_fallbacks == 0


def test_crc_batch_matches_jax_package_and_crc32c():
    rng = np.random.default_rng(SEED)
    chunks = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in LENGTHS + (4096, 4096)]
    got = crclinear.Crc32cLinear().crc_batch(chunks,
                                             backend=TorchBackend("cpu"))
    want = ref_crclinear.Crc32cLinear().crc_batch(chunks,
                                                  backend=JaxBackend())
    assert np.array_equal(got, want)
    assert [int(g) for g in got] == [crc32c(c) for c in chunks]


# -------------------------------------------------- counted fallback

def test_failing_backend_is_a_counted_host_fallback():
    class Broken:
        def apply_bitmatrix_bytes(self, B, data, w):
            raise RuntimeError("injected device fault")

    lin = crclinear.Crc32cLinear()
    rng = np.random.default_rng(SEED)
    chunks = [rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
              for _ in range(4)]
    got = lin.crc_batch(chunks, backend=Broken())
    assert [int(g) for g in got] == [crc32c(c) for c in chunks]
    assert lin.host_fallbacks == 1
    assert isinstance(lin.last_error, RuntimeError)
    lin.crc_batch(chunks, backend=TorchBackend("cpu"))
    assert lin.host_fallbacks == 1
