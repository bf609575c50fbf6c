"""The port's `gpu` plugin (device="cpu") against the JAX package's `tpu`.

Same inputs, made from a seed with numpy, go through both plugins:
encode, decode over every 1- and 2-erasure signature, and the parity
delta, through the synchronous and the async entry points, at (8,4),
(4,2) and (2,1); the committed corpus vectors; the coding matrices of all
seven techniques; and the carry of codec state into B1's operand.
Outputs must be byte-equal."""
import itertools
import json
import os

import numpy as np
import pytest
import torch

from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.ops import matrix as ref_matrix
from ceph_tpu.tools.ec_non_regression import payload
from ceph_tpu_torch.ec import registry
from ceph_tpu_torch.ops import carry
from ceph_tpu_torch.ops import matrix as port_matrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRIES = [(8, 4), (4, 2), (2, 1)]


def pair(profile):
    port = registry.instance().factory("gpu", dict(profile, device="cpu"))
    ref = ref_registry.instance().factory("tpu", dict(profile))
    return port, ref


def signatures(n, m):
    return [s for r in range(1, min(2, m) + 1)
            for s in itertools.combinations(range(n), r)]


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_encode_matches_tpu_plugin(k, m):
    port, ref = pair({"k": str(k), "m": str(m)})
    rng = np.random.default_rng(k * 10 + m)
    data = rng.integers(0, 256, (5, k, 320), dtype=np.uint8)
    want = ref.encode_batch(data)
    assert np.array_equal(port.encode_batch(data), want)
    assert np.array_equal(port.encode_batch_async(data).wait(), want)
    assert np.array_equal(np.asarray(ref.encode_batch_async(data).wait()),
                          want)
    blob = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    n = k + m
    assert port.encode(set(range(n)), blob) == ref.encode(set(range(n)),
                                                          blob)


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_decode_every_signature_matches_tpu_plugin(k, m):
    port, ref = pair({"k": str(k), "m": str(m)})
    n = k + m
    rng = np.random.default_rng(100 + k)
    data = rng.integers(0, 256, (3, k, 192), dtype=np.uint8)
    parity = ref.encode_batch(data)
    chunks = {i: (data[:, i] if i < k else parity[:, i - k])
              for i in range(n)}
    for erased in signatures(n, m):
        present = {i: c for i, c in chunks.items() if i not in erased}
        want = ref.decode_batch(present, 192)
        got = port.decode_batch(present, 192)
        got_async = port.decode_batch_async(present, 192).wait()
        assert set(got) == set(want) == set(erased)
        for e in erased:
            assert np.array_equal(want[e], chunks[e])
            assert np.array_equal(got[e], chunks[e]), (erased, e)
            assert np.array_equal(got_async[e], chunks[e]), (erased, e)


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_delta_matches_tpu_plugin(k, m):
    port, ref = pair({"k": str(k), "m": str(m)})
    rng = np.random.default_rng(200 + k)
    data = rng.integers(0, 256, (4, k, 320), dtype=np.uint8)
    for dirty in signatures(k, 2):
        delta = rng.integers(0, 256, (4, len(dirty), 320), dtype=np.uint8)
        want = ref.delta_encode_batch(delta, dirty)
        assert np.array_equal(np.asarray(
            ref.delta_encode_batch_async(delta, dirty).wait()), want)
        assert np.array_equal(port.delta_encode_batch(delta, dirty), want)
        assert np.array_equal(
            port.delta_encode_batch_async(delta, dirty).wait(), want)
        new = data.copy()
        new[:, list(dirty)] ^= delta
        assert np.array_equal(port.encode_batch(data) ^ want,
                              port.encode_batch(new))


@pytest.mark.parametrize("name", [
    "tpu_k=8_m=4", "jerasure_k=8_m=4_technique=reed_sol_van",
    "jerasure_k=4_m=2_technique=cauchy_good",
    "jerasure_k=5_m=3_technique=liberation"])
def test_corpus_vectors(name):
    d = os.path.join(REPO, "corpus", name)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    port = registry.instance().factory(
        "gpu", dict(manifest["profile"], device="cpu"))
    n = manifest["chunk_count"]
    stored = {}
    for i in range(n):
        with open(os.path.join(d, f"chunk.{i}"), "rb") as f:
            stored[i] = f.read()
    fresh = port.encode(set(range(n)), payload())
    assert all(fresh[i] == stored[i] for i in range(n))
    for erased in signatures(n, 2):
        avail = {i: stored[i] for i in range(n) if i not in erased}
        dec = port.decode(set(erased), avail)
        assert all(dec[e] == stored[e] for e in erased), erased


TECHNIQUES = [
    ("reed_sol_van", {"k": "8", "m": "4"}),
    ("reed_sol_r6_op", {"k": "4", "m": "2"}),
    ("cauchy_orig", {"k": "4", "m": "2", "packetsize": "32"}),
    ("cauchy_good", {"k": "5", "m": "3", "packetsize": "8"}),
    ("liberation", {"k": "4", "m": "2", "w": "7", "packetsize": "32"}),
    ("blaum_roth", {"k": "4", "m": "2", "w": "7", "packetsize": "32"}),
    ("liber8tion", {"k": "4", "m": "2", "w": "8", "packetsize": "32"}),
]


@pytest.mark.parametrize("technique,profile", TECHNIQUES)
def test_technique_matrices_and_cpu_codec_match(technique, profile):
    port, ref = pair(dict(profile, technique=technique))
    for attr in ("coding_matrix", "bitmatrix"):
        a, b = getattr(port.core, attr), getattr(ref.core, attr)
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a, b), attr
    k, n = port.k, port.get_chunk_count()
    rng = np.random.default_rng(len(technique))
    blob = rng.integers(0, 256, 3 * port.get_chunk_size(1) * k,
                        dtype=np.uint8).tobytes()
    enc = port.encode(set(range(n)), blob)
    assert enc == ref.encode(set(range(n)), blob)
    erased = {0, n - 1}
    dec = port.decode(erased, {i: c for i, c in enc.items()
                               if i not in erased})
    assert all(dec[e] == enc[e] for e in erased)


def test_matrix_constructions_match_reference():
    for k, m, w in ((8, 4, 8), (4, 2, 8), (3, 2, 16), (5, 3, 4)):
        assert np.array_equal(
            port_matrix.reed_sol_vandermonde_coding_matrix(k, m, w),
            ref_matrix.reed_sol_vandermonde_coding_matrix(k, m, w))
        assert np.array_equal(
            port_matrix.cauchy_original_coding_matrix(k, m, w),
            ref_matrix.cauchy_original_coding_matrix(k, m, w))
        assert np.array_equal(
            port_matrix.cauchy_good_coding_matrix(k, m, w),
            ref_matrix.cauchy_good_coding_matrix(k, m, w))
        M = ref_matrix.cauchy_good_coding_matrix(k, m, w)
        assert np.array_equal(port_matrix.matrix_to_bitmatrix(M, w),
                              ref_matrix.matrix_to_bitmatrix(M, w))
    assert np.array_equal(port_matrix.reed_sol_r6_coding_matrix(6, 8),
                          ref_matrix.reed_sol_r6_coding_matrix(6, 8))


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_carry_round_trips_codec_state(k, m):
    _, ref = pair({"k": str(k), "m": str(m)})
    core = ref.core
    op = carry.carry_codec(core.coding_matrix, core.bitmatrix, k, m, 8,
                           "cpu")
    assert (op.k, op.m_out) == (k, m)
    assert np.array_equal(carry.operand_bitmatrix(op), core.bitmatrix)
    assert np.array_equal(op.bitmatrix.numpy(), core.bitmatrix)
    erased = (0, k) if m > 1 else (0,)
    chosen = tuple(i for i in range(k + m) if i not in erased)[:k]
    rows_gf, rows_bits = core._recovery_rows(chosen, erased)
    rop = carry.carry_rows(rows_gf, rows_bits, "cpu")
    assert np.array_equal(carry.operand_bitmatrix(rop), rows_bits)
    with pytest.raises(ValueError):
        carry.carry_rows(rows_gf, np.zeros_like(rows_bits), "cpu")
    with pytest.raises(ValueError):
        carry.carry_codec(core.coding_matrix, core.bitmatrix, k, m, 16,
                          "cpu")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        registry.instance().factory("gpu", {"k": "4", "m": "2"})
