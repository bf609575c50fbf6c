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


def packets(data, w, ps):
    """uint8 [batch, k, L] -> uint32 words [batch, nw, k*w, ps/4]."""
    batch, k, L = data.shape
    x = data.reshape(batch, k, L // (w * ps), w, ps).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(x).reshape(batch, -1, k * w, ps).view(
        np.uint32)


def unpackets(words, w):
    batch, nw, R, _ = words.shape
    x = words.view(np.uint8).reshape(batch, nw, R // w, w, -1)
    return x.transpose(0, 2, 1, 3, 4).reshape(batch, R // w, -1)


def emulate_b2(op, data, ps):
    """B2's arithmetic in numpy, word for word: for every column whose
    group mask is not zero, XOR its packet into the rows whose bit is
    set."""
    x = packets(data, op.w, ps)
    masks = op.masks.numpy().view(np.uint32)
    acc = np.zeros(x.shape[:2] + (op.rows, x.shape[3]), dtype=np.uint32)
    for g, c in itertools.product(range(masks.shape[0]), range(x.shape[2])):
        for u in range(32):
            if masks[g, c] >> u & 1:
                acc[:, :, 32 * g + u] ^= x[:, :, c]
    return unpackets(acc, op.w)


def emulate_b3(op, data, ps):
    """B3's arithmetic in numpy from the CSR arrays: row r starts from
    row prev[r] (or zero) and XORs cols[start[r]:start[r+1]]."""
    x = packets(data, op.w, ps)
    prev, start, cols = (t.numpy() for t in (op.prev, op.start, op.cols))
    out = np.zeros(x.shape[:2] + (op.rows, x.shape[3]), dtype=np.uint32)
    for r in range(op.rows):
        acc = out[:, :, prev[r]].copy() if prev[r] >= 0 else 0
        for c in cols[start[r]:start[r + 1]]:
            acc = acc ^ x[:, :, c]
        out[:, :, r] = acc
    return unpackets(out, op.w)


@pytest.mark.parametrize("k,m,w", CODES)
def test_kernel_word_arithmetic_matches_plain(k, m, w):
    ps = 16
    data = rand(7 * k, 2, k, 3 * w * ps)
    for name, B in row_sets(k, m, w):
        want = packet_kernel.packet_apply_plain(
            B, torch.from_numpy(data), w, ps).numpy()
        op = carry.packet_operand(B, w, "cpu")
        assert np.array_equal(emulate_b2(op, data, ps), want), name
        sop = carry.schedule_operand(build_xor_schedule(B), k, w, "cpu")
        assert np.array_equal(emulate_b3(sop, data, ps), want), name


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
