"""Kernel B1 (ceph_tpu_torch/ops/gf8_kernel.py) against the JAX package.

On the CPU the wrapper runs its plain PyTorch version; here that version
is held byte for byte against the TPU kernel it replaces
(``_gf_mxu_pallas_fn`` in interpret mode) and the numpy oracle, at the
encode matrix and a decode recovery-row set of (8,4), (4,2) and (2,1).
A numpy emulation of the CUDA kernel's arithmetic (byte-permute lookups
in the operand's tables, exact to PTX prmt.b32) checks the tables that
ops/carry.py hands the kernel, the selectors, the interleaved
accumulators, the final reorder and the zero-filled ragged tail.  The
kernel itself runs in tests/test_torch_cuda.py, on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ops.engine import CodecCore as RefCore
from ceph_tpu.ops.engine import NumpyBackend
from ceph_tpu.ops.jax_engine import _gf_mxu_pallas_fn
from ceph_tpu_torch.ops import carry, gf8_kernel
from ceph_tpu_torch.ops.matrix import reed_sol_vandermonde_coding_matrix

GEOMETRIES = [(8, 4), (4, 2), (2, 1)]


def row_sets(k, m):
    """(name, GF rows, bitmatrix) for the encode matrix and the combined
    recovery rows of an m-erasure signature, from the JAX codec."""
    core = RefCore(k, m, 8,
                   coding_matrix=reed_sol_vandermonde_coding_matrix(k, m, 8))
    erased = tuple(range(m - 1)) + (k + m - 1,)
    chosen = tuple(i for i in range(k + m) if i not in erased)[:k]
    rows_gf, rows_bits = core._recovery_rows(chosen, erased)
    return [("encode", core.coding_matrix, core.bitmatrix),
            ("decode", rows_gf, rows_bits)]


@pytest.mark.parametrize("L", [192, 256, 320])
@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_plain_matches_pallas_interpret_and_oracle(k, m, L):
    rng = np.random.default_rng(1000 * k + L)
    data = rng.integers(0, 256, (2, k, L), dtype=np.uint8)
    for name, rows, bits in row_sets(k, m):
        ref = NumpyBackend().apply_matrix(rows, data, 8)
        pallas = np.asarray(_gf_mxu_pallas_fn(bits, k, 8, interpret=True)(
            jnp.asarray(data)))
        plain = gf8_kernel.gf8_apply_plain(
            bits, torch.from_numpy(data)).numpy()
        assert np.array_equal(pallas, ref), (name, k, m, L)
        assert np.array_equal(plain, ref), (name, k, m, L)


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_wrapper_on_cpu_runs_plain_and_counts_nothing(k, m):
    rng = np.random.default_rng(7 * k)
    data = torch.from_numpy(rng.integers(0, 256, (3, k, 320),
                                         dtype=np.uint8))
    before = gf8_kernel.launches
    for name, rows, bits in row_sets(k, m):
        op = carry.bitmatrix_operand(bits, k, "cpu")
        out = gf8_kernel.gf8_apply(op, data)
        assert torch.equal(out, gf8_kernel.gf8_apply_plain(bits, data))
        buf = torch.empty_like(out)
        assert gf8_kernel.gf8_apply(op, data, buf) is buf
        assert torch.equal(buf, out)
    assert gf8_kernel.launches == before


def prmt(lo, hi, sel):
    """PTX prmt.b32 in its default mode, elementwise on uint32: byte n of
    the result is byte (sel >> 4n) & 7 of the 8 bytes {hi:lo}, or, when
    bit 3 of that nibble is set, that byte's top bit copied into all 8."""
    lo, hi, sel = (np.asarray(v, dtype=np.uint32) for v in (lo, hi, sel))
    src = (hi.astype(np.uint64) << np.uint64(32)) | lo
    res = np.zeros(np.broadcast(lo, hi, sel).shape, dtype=np.uint32)
    for n in range(4):
        nib = (sel >> np.uint32(4 * n)) & np.uint32(0xF)
        byte = (src >> (np.uint64(8) * (nib & np.uint32(7)))) \
            & np.uint64(0xFF)
        byte = np.where(nib & np.uint32(8),
                        np.where(byte & np.uint64(0x80), 0xFF, 0), byte)
        res |= byte.astype(np.uint32) << np.uint32(8 * n)
    return res


def bsel(c, x, y):
    """Bitwise c ? x : y."""
    return ((x ^ y) & c) ^ y


# the selector of field g from the word pair (a, b), as selectors() in
# csrc/gf8_bitplane.cu builds it: field of a in the low nibble of each
# byte, field of b in the high nibble
FIELDS = [lambda a, b: bsel(0x07070707, a, (b & 0x77777777) << 4),
          lambda a, b: bsel(0x07070707, a >> 3, (b & 0x38383838) << 1),
          lambda a, b: bsel(0x03030303, a >> 6, (b & 0xC0C0C0C0) >> 2)]


def emulate_kernel(operand, data: np.ndarray) -> np.ndarray:
    """The CUDA kernel's arithmetic in numpy, word for word: each chunk's
    16-byte segments zero-filled past L, one selector per (field, pair of
    words), 12 table lookups per (output, chunk) folded into accumulators
    of columns (0, 4, 1, 5 | 2, 6, 3, 7), then the reorder."""
    tab = operand.tables.numpy().view(np.uint32)         # [e, c, g, 2]
    batch, k, L = data.shape
    nseg = -(-L // 16)
    padded = np.zeros((batch, k, nseg * 16), dtype=np.uint8)
    padded[..., :L] = data
    x = padded.view(np.uint32).reshape(batch, k, nseg, 4)
    acc = np.zeros((batch, operand.m_out, nseg, 4), dtype=np.uint32)
    for c in range(k):
        sel = [[field(x[:, c, :, 2 * p], x[:, c, :, 2 * p + 1])
                for field in FIELDS] for p in range(2)]
        for s in (s for pair in sel for s in pair):
            assert not (s & np.uint32(0x88888888)).any()
        for e in range(operand.m_out):
            for g in range(3):
                lo, hi = tab[e, c, g]
                for p in range(2):
                    acc[:, e, :, 2 * p] ^= prmt(lo, hi, sel[p][g])
                    acc[:, e, :, 2 * p + 1] ^= prmt(lo, hi,
                                                    sel[p][g] >> 16)
    words = np.empty_like(acc)
    for p in range(2):
        words[..., 2 * p] = prmt(acc[..., 2 * p], acc[..., 2 * p + 1],
                                 0x6420)
        words[..., 2 * p + 1] = prmt(acc[..., 2 * p], acc[..., 2 * p + 1],
                                     0x7531)
    return words.view(np.uint8).reshape(batch, operand.m_out,
                                        nseg * 16)[..., :L]


def mod2_product(B, data: np.ndarray) -> np.ndarray:
    """bit i of out[b, e, l] = sum over (c, j) of B[8e+i, 8c+j] * bit j of
    data[b, c, l], mod 2: the function B1 computes, written plainly."""
    batch, k, L = data.shape
    bits = (data[:, :, None, :] >> np.arange(8)[None, None, :, None]) & 1
    prod = np.einsum("rq,bql->brl", B.astype(np.int64),
                     bits.reshape(batch, 8 * k, L).astype(np.int64)) & 1
    prod = prod.reshape(batch, B.shape[0] // 8, 8, L)
    return (prod << np.arange(8)[None, None, :, None]).sum(axis=2
                                                          ).astype(np.uint8)


def test_prmt_matches_ptx_on_hand_worked_selectors():
    lo, hi = 0x33221100, 0x77665544
    assert prmt(lo, hi, 0x3210) == lo
    assert prmt(lo, hi, 0x7654) == hi
    assert prmt(lo, hi, 0x6420) == 0x66442200
    assert prmt(lo, hi, 0x7531) == 0x77553311
    assert prmt(lo, hi, 0x0000) == 0x00000000
    assert prmt(lo, hi, 0x4444) == 0x44444444
    # only the low 16 bits of the selector count
    assert prmt(lo, hi, 0xFFFF3210) == lo
    # bit 3 of a nibble replicates the selected byte's top bit
    assert prmt(0x44338211, 0, 0x0009) == 0x111111FF
    assert prmt(0x44338211, 0, 0x0008) == 0x11111100
    assert prmt(0x44338211, 0x80000000, 0xF000) == 0xFF111111
    assert np.array_equal(prmt([lo, hi], [hi, lo], 0x7654), [hi, lo])


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_kernel_word_arithmetic_matches_oracle(k, m):
    rng = np.random.default_rng(31 * k)
    data = rng.integers(0, 256, (2, k, 256), dtype=np.uint8)
    for name, rows, bits in row_sets(k, m):
        op = carry.bitmatrix_operand(bits, k, "cpu")
        assert np.array_equal(emulate_kernel(op, data),
                              NumpyBackend().apply_matrix(rows, data, 8)), name


def test_kernel_arithmetic_on_an_arbitrary_bitmatrix():
    """Any 0/1 bitmatrix, not only an expansion of GF(2^8) elements."""
    rng = np.random.default_rng(5)
    k, m_out = 5, 3
    B = rng.integers(0, 2, (8 * m_out, 8 * k), dtype=np.uint8)
    data = rng.integers(0, 256, (3, k, 160), dtype=np.uint8)
    op = carry.bitmatrix_operand(B, k, "cpu")
    want = mod2_product(B, data)
    assert np.array_equal(emulate_kernel(op, data), want)
    assert np.array_equal(
        gf8_kernel.gf8_apply_plain(B, torch.from_numpy(data)).numpy(), want)


@pytest.mark.parametrize("L", [100, 264])
def test_kernel_arithmetic_at_ragged_lengths(L):
    """A chunk length that is not a multiple of 16: the last segment
    loads zeros past L and only its valid bytes are kept."""
    rng = np.random.default_rng(L)
    for k, m in GEOMETRIES:
        data = rng.integers(0, 256, (2, k, L), dtype=np.uint8)
        for name, rows, bits in row_sets(k, m):
            op = carry.bitmatrix_operand(bits, k, "cpu")
            got = emulate_kernel(op, data)
            assert got.shape == (2, op.m_out, L)
            assert np.array_equal(
                got, NumpyBackend().apply_matrix(rows, data, 8)), (name, k)


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_tables_round_trip_to_the_bitmatrix(k, m):
    for name, rows, bits in row_sets(k, m):
        op = carry.bitmatrix_operand(bits, k, "cpu")
        assert tuple(op.tables.shape) == (m if name == "encode"
                                          else len(rows), k, 3, 2)
        assert np.array_equal(carry.operand_bitmatrix(op), bits), name
        tab = op.tables.numpy().view(np.uint8).reshape(op.m_out, k, 3, 8)
        assert not tab[:, :, :, 0].any()          # a table maps 0 to 0
        assert not tab[:, :, 2, 4:].any()         # the 2-bit field's tail
        # each entry is the XOR of the entries of its set bits
        for v in (3, 5, 6, 7):
            parts = [tab[:, :, :2, 1 << b] for b in range(3) if v >> b & 1]
            assert np.array_equal(tab[:, :, :2, v],
                                  np.bitwise_xor.reduce(parts))
        assert np.array_equal(tab[:, :, 2, 3],
                              tab[:, :, 2, 1] ^ tab[:, :, 2, 2])


def test_wrapper_rejects_bad_inputs():
    _, rows, bits = row_sets(4, 2)[0]
    op = carry.bitmatrix_operand(bits, 4, "cpu")
    good = torch.zeros((1, 4, 64), dtype=torch.uint8)
    with pytest.raises(ValueError):
        gf8_kernel.gf8_apply(op, good.to(torch.int32))
    with pytest.raises(ValueError):
        gf8_kernel.gf8_apply(op, torch.zeros((1, 3, 64), dtype=torch.uint8))
    with pytest.raises(ValueError):
        gf8_kernel.gf8_apply(op, torch.zeros((1, 64, 4),
                                             dtype=torch.uint8).mT)
    with pytest.raises(ValueError):
        gf8_kernel.gf8_apply(op, good, torch.empty((1, 3, 64),
                                                   dtype=torch.uint8))
    with pytest.raises(ValueError):
        gf8_kernel.gf8_apply(op, good.to("meta"))


SASS = """
        Function : _ZN12_GLOBAL__N_116gf8_table_kernelILi16EEEvPK5uint2
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   PRMT R2, R3, 0x6420, R4 ;
        /*0020*/                   LOP3.LUT R2, R3, 0x7, RZ, 0xc0, !PT ;
        /*0030*/                   PRMT R5, R2, R6, R7 ;
        /*0040*/                   PRMT R5, R2, R6, R7 ;
        /*0050*/               @P0 BRA 0x20 ;
        /*0060*/                   IMAD.HI.U32 R8, R9, 0x10000, RZ ;
        /*0070*/                   PRMT R5, R2, R6, R7 ;
        /*0080*/              @!P1 BRA 0x60 ;
        /*0090*/                   BRA 0x10 ;
        /*00a0*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_116gf8_table_kernelILi8EEEvPK5uint2
        /*0000*/                   PRMT R2, R3, 0x6420, R4 ;
"""


def test_sass_counts_read_the_innermost_hot_loop():
    """chip_smoke.py reports B1's PRMT and LOP3 counts from cuobjdump's
    listing: the whole function, and the innermost loop with the most
    PRMTs (not the outer loop over work items)."""
    from ceph_tpu_torch.ops.cuda_build import count_sass
    got = count_sass(SASS, "gf8_table_kernelILi16E")
    assert got["all"] == {"LDC": 1, "PRMT": 4, "LOP3": 1, "BRA": 3,
                          "IMAD": 1, "EXIT": 1}
    assert got["loop"] == {"LOP3": 1, "PRMT": 2, "BRA": 1}
    assert count_sass(SASS, "nothing") == {"all": {}, "loop": {}}
