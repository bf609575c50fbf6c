"""Port twins of tests/test_tpu_plugin.py: the `gpu` plugin on the CPU.

Each twin keeps the reference's body, sizes and seeds, with the `gpu`
plugin (``device="cpu"``: every kernel wrapper runs its plain PyTorch
version) where the reference has `tpu`.  Where the reference checks a
value the JAX package computes (chunks, parity, decode output), the twin
computes it with ``ceph_tpu`` on the same inputs too and holds the port
byte-equal to it.  Where a reference test names a JAX-only notion, the
twin tests the port's counterpart and says which in its docstring.

Reference tests not twinned here:

- ``test_packet_pallas_kernel_interpret``: B3's plain version against
  the Pallas kernel in interpret mode is
  tests/test_torch_packet.py::test_b3_plain_matches_pallas_interpret;
  B3's arithmetic as the CUDA source does it is
  ::test_kernel_word_arithmetic_matches_plain and
  ::test_kernel_tile_arithmetic_at_tile_edges.
- ``test_packet_mxu_pallas_kernel_interpret``: B2's plain version against
  the Pallas kernel, encode and decode row sets, is
  tests/test_torch_packet.py::test_b2_plain_matches_pallas_interpret.
- ``test_gf_mxu_pallas_kernel_interpret``: B1's plain version against
  the Pallas kernel and the scalar oracle, at lengths that are not a
  multiple of 128, is ``test_plain_matches_pallas_interpret_and_oracle``
  in tests/test_torch_gf8_kernel.py;
  B1's table arithmetic is ::test_kernel_word_arithmetic_matches_oracle
  and ::test_kernel_arithmetic_at_ragged_lengths.
- ``test_gf8_decode_rows_lru``: the port's ChainLRU serving and evicting
  per-signature decode operands at cap 2 is
  tests/test_torch_engine.py::test_decode_rows_operands_are_lru_cached.
- ``test_staging_slot_released_on_failed_dispatch`` and
  ``test_staging_pool_acquire_stall_grows_ring``: the tests of the same
  names in tests/test_torch_engine.py.
"""
import itertools

import numpy as np
import pytest
import torch

from ceph_tpu.ec import registry as ref_registry
from ceph_tpu_torch.ec import registry as ecreg
from ceph_tpu_torch.ec.plugins import gpu as gpumod
from ceph_tpu_torch.ops import carry, gf8_kernel, torch_engine
from ceph_tpu_torch.ops.engine import NumpyBackend
from ceph_tpu_torch.ops.matrix import (matrix_to_bitmatrix,
                                       reed_sol_vandermonde_coding_matrix)

TECHNIQUES = [
    ("reed_sol_van", {"k": "4", "m": "2"}),
    ("reed_sol_van", {"k": "8", "m": "4"}),
    ("reed_sol_van", {"k": "3", "m": "2", "w": "16"}),
    ("reed_sol_van", {"k": "3", "m": "2", "w": "32"}),
    ("reed_sol_r6_op", {"k": "4", "m": "2"}),
    ("cauchy_orig", {"k": "4", "m": "2", "packetsize": "32"}),
    ("cauchy_good", {"k": "5", "m": "3", "packetsize": "8"}),
    ("liberation", {"k": "4", "m": "2", "w": "7", "packetsize": "32"}),
    ("blaum_roth", {"k": "4", "m": "2", "w": "7", "packetsize": "32"}),
    ("liber8tion", {"k": "4", "m": "2", "w": "8", "packetsize": "32"}),
]


def gpu(profile):
    return ecreg.instance().factory("gpu", dict(profile, device="cpu"))


def jerasure(profile):
    return ecreg.instance().factory("jerasure", dict(profile))


def ref_tpu(profile):
    return ref_registry.instance().factory("tpu", dict(profile))


def ref_jerasure(profile):
    return ref_registry.instance().factory("jerasure", dict(profile))


def pair(technique, profile):
    p = dict(profile, technique=technique)
    return jerasure(p), gpu(p)


class Counting:
    """Wraps a kernel wrapper of torch_engine and counts its calls, to
    show which route a codec call took on the CPU (the wrappers count
    launches only on the card)."""

    def __init__(self, monkeypatch, name):
        self.calls = 0
        real = getattr(torch_engine, name)

        def wrapper(*a, **kw):
            self.calls += 1
            return real(*a, **kw)
        monkeypatch.setattr(torch_engine, name, wrapper)


@pytest.mark.parametrize("technique,profile", TECHNIQUES)
def test_bit_exact_encode(technique, profile):
    cpu, port = pair(technique, profile)
    n = cpu.get_chunk_count()
    rng = np.random.default_rng(123)
    data = rng.integers(0, 256, 40000, dtype=np.uint8).tobytes()
    enc_cpu = cpu.encode(set(range(n)), data)
    enc_gpu = port.encode(set(range(n)), data)
    assert set(enc_cpu) == set(enc_gpu)
    for i in enc_cpu:
        assert enc_cpu[i] == enc_gpu[i], f"chunk {i} differs"
    enc_ref = ref_tpu(dict(profile, technique=technique)).encode(
        set(range(n)), data)
    assert enc_ref == enc_gpu


@pytest.mark.parametrize("technique,profile", TECHNIQUES[:6])
def test_bit_exact_decode(technique, profile):
    """Every signature of 1 and of m erasures decodes through the `gpu`
    plugin to the chunks the JAX package's jerasure encoded."""
    cpu, port = pair(technique, profile)
    n = cpu.get_chunk_count()
    m = cpu.get_coding_chunk_count()
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, 8192, dtype=np.uint8).tobytes()
    encoded = cpu.encode(set(range(n)), data)
    assert encoded == ref_jerasure(dict(profile, technique=technique)
                                   ).encode(set(range(n)), data)
    for nerasures in (1, m):
        for erased in itertools.combinations(range(n), nerasures):
            chunks = {i: c for i, c in encoded.items() if i not in erased}
            dec = port.decode(set(erased), chunks)
            for e in erased:
                assert dec[e] == encoded[e]


def test_encode_batch_matches_sequential():
    port = gpu({"k": "8", "m": "4"})
    cpu = jerasure({"k": "8", "m": "4"})
    rng = np.random.default_rng(9)
    B, L = 17, 4096  # odd batch exercises bucketing/padding
    data = rng.integers(0, 256, (B, 8, L), dtype=np.uint8)
    parity = port.encode_batch(data)
    assert parity.shape == (B, 4, L)
    for b in range(0, B, 5):
        ref = cpu.core.encode(data[b])
        assert np.array_equal(parity[b], ref)
    assert np.array_equal(parity, ref_tpu({"k": "8", "m": "4"})
                          .encode_batch(data))


def test_decode_batch():
    port = gpu({"k": "4", "m": "2"})
    rng = np.random.default_rng(10)
    B, L = 6, 1024
    data = rng.integers(0, 256, (B, 4, L), dtype=np.uint8)
    parity = port.encode_batch(data)
    assert np.array_equal(parity, ref_tpu({"k": "4", "m": "2"})
                          .encode_batch(data))
    present = {i: data[:, i] for i in (0, 2, 3)}
    present[4] = parity[:, 0]
    present[5] = parity[:, 1]
    out = port.decode_batch(present, L)
    assert np.array_equal(out[1], data[:, 1])


@pytest.mark.parametrize("batch", [1, 2, 7, 8])
@pytest.mark.parametrize("length", [128, 129, 1000])
def test_bucketing_shapes(batch, length):
    port = gpu({"k": "2", "m": "1"})
    cpu = jerasure({"k": "2", "m": "1"})
    rng = np.random.default_rng(batch * 1000 + length)
    data = rng.integers(0, 256, (batch, 2, length), dtype=np.uint8)
    parity = port.encode_batch(data)
    for b in range(batch):
        assert np.array_equal(parity[b], cpu.core.encode(data[b]))
    assert np.array_equal(parity, ref_tpu({"k": "2", "m": "1"})
                          .encode_batch(data))
    assert np.array_equal(port.encode_batch_async(data).wait(), parity)


def test_gf8_xor_chain_bit_exact():
    """The reference's fused XOR/xtime chain (``_apply_gf8_xor``) is the
    JAX package's w=8 encode route; the port's is B1's wrapper on a
    carried operand (its plain version on the CPU).  Both must equal the
    scalar GF oracle on one small matrix."""
    import jax.numpy as jnp

    from ceph_tpu.ops.jax_engine import _apply_gf8_xor
    M = reed_sol_vandermonde_coding_matrix(3, 2, 8)
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (2, 3, 256), dtype=np.uint8)
    op = carry.carry_rows(M, matrix_to_bitmatrix(M, 8), "cpu")
    out = gf8_kernel.gf8_apply(op, torch.from_numpy(data)).numpy()
    ref = NumpyBackend().apply_matrix(M, data, 8)
    assert np.array_equal(out, ref)
    coeffs = tuple(tuple(int(v) for v in row) for row in M)
    assert np.array_equal(
        out, np.asarray(_apply_gf8_xor(jnp.asarray(data), coeffs)))


def test_gf8_fast_path_forced_on_cpu(monkeypatch):
    """The reference forces its w=8 XOR-chain route on the CPU.  The
    port's w=8 route is B1 (``gf8_fast_path`` is always true: on the
    card the kernel, on the CPU its plain version); this twin shows the
    plugin's encode, async encode and decode all go through B1's wrapper
    on the CPU, bit-exact with jerasure and the JAX package's `tpu`."""
    b1 = Counting(monkeypatch, "gf8_apply")
    k, m = 4, 2
    prof = {"k": str(k), "m": str(m), "technique": "reed_sol_van"}
    port = gpu(prof)
    cpu = jerasure(prof)
    assert port.core.backend.gf8_fast_path()
    assert port.core.gf8_encode_fast() and port.core.gf8_decode_fast()
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, (3, k, 256), dtype=np.uint8)
    for b in range(3):
        calls = b1.calls
        assert np.array_equal(port.core.encode(data[b]),
                              cpu.core.encode(data[b]))
        assert b1.calls > calls
    # async entry point takes the same route
    calls = b1.calls
    parity = port.encode_batch(data)
    assert b1.calls > calls
    for b in range(3):
        assert np.array_equal(parity[b], cpu.core.encode(data[b]))
    assert np.array_equal(parity, ref_tpu(prof).encode_batch(data))
    # decode with erasures through the plugin API
    full = np.concatenate([data[0], cpu.core.encode(data[0])], axis=0)
    chunks = {i: full[i].tobytes() for i in range(k + m)
              if i not in (0, 3)}
    calls = b1.calls
    dec = port.decode({0, 3}, chunks)
    assert b1.calls > calls
    assert dec[0] == full[0].tobytes()
    assert dec[3] == full[3].tobytes()


def test_empty_object_roundtrip():
    """Zero-length objects must encode/decode without touching the
    device paths."""
    for plugin in ("gpu", "jerasure"):
        prof = {"k": "8", "m": "4"}
        if plugin == "gpu":
            prof["device"] = "cpu"
        codec = ecreg.instance().factory(plugin, prof)
        ch = codec.encode(set(range(12)), b"")
        assert all(c == b"" for c in ch.values())
        assert codec.decode_concat({i: ch[i] for i in range(8)}) == b""
        dec = codec.decode({0, 9}, {i: ch[i] for i in range(12)
                                    if i not in (0, 9)})
        assert dec[0] == b"" and dec[9] == b""


def test_xor_schedule_reconstructs_bitmatrix():
    """build_xor_schedule's delta chains (B3's program) must reproduce
    the original bitmatrix rows exactly, and equal the JAX package's."""
    from ceph_tpu.ops.jax_engine import build_xor_schedule as ref_schedule
    B = matrix_to_bitmatrix(
        reed_sol_vandermonde_coding_matrix(5, 3, 8), 8)
    sched = torch_engine.build_xor_schedule(B)
    assert len(sched) == B.shape[0]
    rows = []
    for prev, cols in sched:
        v = rows[prev].copy() if prev >= 0 else \
            np.zeros(B.shape[1], dtype=np.uint8)
        for c in cols:
            v[c] ^= 1
        rows.append(v)
    assert np.array_equal(np.stack(rows), B)
    assert sched == ref_schedule(B)


@pytest.mark.parametrize("packetsize,kernel", [(8, "packet_xor"),
                                               (128, "packet_apply")])
def test_packet_static_path_forced_on_cpu(monkeypatch, packetsize, kernel):
    """The reference forces its static XOR-schedule packet route on the
    CPU.  The port routes packet codes as the reference does on its
    chip: packets that are a multiple of 128 bytes to B2
    (``packet_apply``), any other size to B3 on the XOR schedule
    (``packet_xor``).  Both routes, selected on the CPU, must stay
    bit-exact with jerasure and the JAX package's `tpu` for encode and
    a two-erasure decode."""
    counted = Counting(monkeypatch, kernel)
    prof = {"k": "3", "m": "2", "technique": "cauchy_good",
            "packetsize": str(packetsize)}
    port = gpu(prof)
    cpu = jerasure(prof)
    assert port.core.packet_static_fast()
    w = port.w
    L = 3 * w * packetsize  # a few super-words
    rng = np.random.default_rng(21)
    data = rng.integers(0, 256, (2, 3, L), dtype=np.uint8)
    parity = port.encode_batch(data)
    ref = cpu.core.encode(data)
    assert np.array_equal(parity, ref)
    assert np.array_equal(parity, ref_tpu(prof).encode_batch(data))
    assert counted.calls >= 1
    # decode two erasures (one data, one parity) through the core
    calls = counted.calls
    present = {1: data[:, 1], 2: data[:, 2], 4: ref[:, 1]}
    out = port.core.decode_chunks(present, L)
    assert np.array_equal(out[0], data[:, 0])
    assert np.array_equal(out[3], ref[:, 0])
    assert counted.calls > calls


def test_jit_cache_reused_across_instances(monkeypatch):
    """The reference's jit caches become the port's operand caches: two
    plugin instances of one profile share ``gpu.shared_backend`` and
    build each operand once (B1's carried operand, in the backend's
    ChainLRU); a w=16 codec's bitmatrix lands in the backend's device
    matrix cache."""
    a = gpu({"k": "4", "m": "2"})
    b = gpu({"k": "4", "m": "2"})
    be = gpumod.shared_backend("cpu")
    assert a.core.backend is b.core.backend is be
    M = a.core.coding_matrix
    key = ("gf8", M.shape, np.asarray(M, dtype=np.int64).tobytes())
    be._chain_lru._d.pop(key, None)
    builds = Counting(monkeypatch, "carry_rows")
    pa = a.encode_batch(np.zeros((2, 4, 256), dtype=np.uint8))
    pb = b.encode_batch(np.zeros((2, 4, 256), dtype=np.uint8))
    pc = b.encode_batch_async(np.zeros((2, 4, 256), dtype=np.uint8)).wait()
    assert np.array_equal(pa, pb) and np.array_equal(pa, pc)
    assert builds.calls == 1
    assert key in be._chain_lru._d
    # the device-matrix cache serves the non-w8 codes: a w=16 codec
    # populates it
    c = gpu({"k": "3", "m": "2", "w": "16"})
    c.encode_batch(np.zeros((2, 3, 256), dtype=np.uint8))
    key16 = (c.core.bitmatrix.shape, c.core.bitmatrix.tobytes())
    assert key16 in be._dev_matrices


def test_staging_pool_reuses_host_arrays():
    """Consecutive async encodes of one shape through the plugin serve
    their host staging from the shared backend's ring (hits, not fresh
    allocs) and release every slot on completion."""
    codec = gpu({"k": "4", "m": "2"})
    pool = codec.core.backend.staging
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, (4, 4, 4096), dtype=np.uint8)
    ref = codec.encode_batch(data)
    assert np.array_equal(ref, ref_tpu({"k": "4", "m": "2"})
                          .encode_batch(data))
    a0, h0 = pool.allocs, pool.hits
    outs = [codec.encode_batch_async(data.copy()).wait()
            for _ in range(6)]
    for out in outs:
        assert np.array_equal(np.asarray(out), ref)
    # at most ring-depth fresh arrays for this shape; the rest reuse
    assert pool.allocs - a0 <= 2
    assert pool.hits - h0 >= 4, \
        "staging ring never reused a host array across encodes"
    # every slot came back: the ring is fully idle after the waits
    shape = (4, 4, 4096)
    assert len(pool._free[shape]) == pool._made[shape]
    assert pool.stats()["in_flight"] == 0


def test_prewarm_geometry_preallocates_and_compiles(monkeypatch):
    """The reference's prewarm leaves the staging ring allocated and the
    encode executable compiled.  The port has no executable to compile:
    prewarm makes the ring slots of the padded shape and builds B1's
    operand, so the first write allocates nothing and builds nothing."""
    codec = gpu({"k": "2", "m": "1"})
    be = codec.core.backend
    pool = be.staging
    codec.prewarm_geometry(8192, batches=(4,))
    shape = (4, 2, 8192)
    assert pool._made.get(shape, 0) >= pool.depth, \
        "prewarm_geometry did not make the ring"
    M = codec.core.coding_matrix
    key = ("gf8", M.shape, np.asarray(M, dtype=np.int64).tobytes())
    assert key in be._chain_lru._d, "prewarm built no B1 operand"
    a1 = pool.allocs
    builds = Counting(monkeypatch, "carry_rows")
    # a real write of the prewarmed shape allocates and builds nothing
    data = np.zeros((4, 2, 8192), dtype=np.uint8)
    out = codec.encode_batch_async(data).wait()
    assert np.asarray(out).shape[1] == 1
    assert pool.allocs == a1, \
        "prewarmed shape still paid a fresh staging alloc"
    assert builds.calls == 0, "the first write built an operand"
    # idempotent
    codec.prewarm_geometry(8192, batches=(4,))
    assert pool.allocs == a1
