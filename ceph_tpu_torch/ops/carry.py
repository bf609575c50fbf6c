"""Carry codec state across to the port's kernel operand.

Both packages build the same numpy state: a codec's ``coding_matrix``
(GF(2^8) elements, [m, k]) and ``bitmatrix`` (0/1, [8m, 8k]), and per
erasure signature the recovery rows ``(rows_gf, rows_bits)`` of
``CodecCore._recovery_rows``.  These functions take that state from
either package, check that its two halves agree, and return the
device-resident ``Gf8Operand`` that kernel B1 reads.

The packet-layout codes carry their bitmatrix ([R, k*w], 0/1) into the
``PacketOperand`` of kernel B2, and its XOR schedule (the tuple that
``build_xor_schedule`` returns in either package) into the CSR arrays of
kernel B3's ``ScheduleOperand``.  Each operand has a function back to
the state it came from, for round-trip checks.  The tests use them to
hand identical matrices to the JAX codec and to the port.
"""
from __future__ import annotations

import numpy as np
import torch

from .gf8_kernel import Gf8Operand
from .matrix import matrix_to_bitmatrix
from .packet_kernel import PacketOperand
from .packet_xor_kernel import ScheduleOperand


def bitmatrix_operand(bitmatrix, k: int, device) -> Gf8Operand:
    """B1 operand for a 0/1 bitmatrix [8*m_out, 8*k]: the bitmatrix itself
    and its byte tables.  With the column bytes col[e, c, j] = sum_i
    B[8e+i, 8c+j] << i, the 8 input bits of chunk c are taken in three
    fields (bits 0-2, 3-5, 6-7), and table (e, c, g) maps a field value v
    to the XOR of col[e, c, 3g+b] over the set bits b of v.  The tables
    are int32 [m_out, k, 3, 2]: the low and high word of 8 bytes, entry v
    in byte v; entries 4-7 of the 2-bit field stay zero."""
    B = np.asarray(bitmatrix, dtype=np.uint8)
    R, KW = B.shape
    if R % 8 or KW != 8 * k:
        raise ValueError(f"bitmatrix {B.shape} does not fit k={k}, w=8")
    if B.max(initial=0) > 1:
        raise ValueError("bitmatrix entries must be 0 or 1")
    m_out = R // 8
    blocks = B.reshape(m_out, 8, k, 8).astype(np.uint32)   # [e, i, c, j]
    col = (blocks << np.arange(8, dtype=np.uint32)[None, :, None, None]
           ).sum(axis=1, dtype=np.uint32).astype(np.uint8)  # [e, c, j]
    v = np.arange(8)
    tab = np.zeros((m_out, k, 3, 8), dtype=np.uint8)
    for g in range(3):
        width = min(3, 8 - 3 * g)
        for b in range(width):
            hit = ((v >> b) & 1).astype(bool) & (v < (1 << width))
            tab[:, :, g] ^= np.where(hit, col[:, :, 3 * g + b, None], 0
                                     ).astype(np.uint8)
    return Gf8Operand(
        bitmatrix=torch.from_numpy(B.copy()).to(device),
        tables=torch.from_numpy(tab.view(np.int32).copy()).to(device),
        k=int(k), m_out=int(m_out))


def operand_bitmatrix(operand: Gf8Operand) -> np.ndarray:
    """The bitmatrix that ``operand.tables`` encodes: entry 1 << b of
    field g is the column byte of input bit 3g+b (for round-trip
    checks)."""
    tab = np.ascontiguousarray(operand.tables.cpu().numpy()).view(np.uint8)
    j = np.arange(8)
    col = tab[:, :, j // 3, 1 << (j % 3)].astype(np.uint32)  # [e, c, j]
    bits = (col[:, None, :, :] >> np.arange(8, dtype=np.uint32)
            [None, :, None, None]) & 1                      # [e, i, c, j]
    return bits.reshape(8 * operand.m_out, 8 * operand.k).astype(np.uint8)


def carry_codec(coding_matrix, bitmatrix, k: int, m: int, w: int,
                device) -> Gf8Operand:
    """A codec's encode operand from its ``core.coding_matrix`` and
    ``core.bitmatrix`` (either package's CodecCore)."""
    if w != 8:
        raise ValueError(f"kernel B1 serves w=8 codes, not w={w}")
    M = np.asarray(coding_matrix, dtype=np.int64)
    if M.shape != (m, k):
        raise ValueError(f"coding matrix {M.shape} is not [m={m}, k={k}]")
    if not np.array_equal(matrix_to_bitmatrix(M, 8),
                          np.asarray(bitmatrix, dtype=np.uint8)):
        raise ValueError("bitmatrix does not expand the coding matrix")
    return bitmatrix_operand(bitmatrix, k, device)


def carry_rows(rows_gf, rows_bits, device) -> Gf8Operand:
    """An erasure signature's recovery rows ``(rows_gf, rows_bits)`` from
    either package's ``CodecCore._recovery_rows``."""
    rows_gf = np.asarray(rows_gf, dtype=np.int64)
    if not np.array_equal(matrix_to_bitmatrix(rows_gf, 8),
                          np.asarray(rows_bits, dtype=np.uint8)):
        raise ValueError("rows_bits does not expand rows_gf")
    return bitmatrix_operand(rows_bits, rows_gf.shape[1], device)


def packet_operand(bitmatrix, w: int, device) -> PacketOperand:
    """B2 operand for a packet-layout 0/1 bitmatrix [R, k*w] (an encode
    bitmatrix or an erasure signature's decode rows): the bitmatrix and
    its column masks, bit u of masks[g, c] = B[32g+u, c]."""
    B = np.asarray(bitmatrix, dtype=np.uint8)
    R, KW = B.shape
    if R % w or KW % w or R == 0:
        raise ValueError(f"bitmatrix {B.shape} does not fit w={w}")
    if B.max(initial=0) > 1:
        raise ValueError("bitmatrix entries must be 0 or 1")
    groups = (R + 31) // 32
    padded = np.zeros((groups * 32, KW), dtype=np.uint32)
    padded[:R] = B
    masks = (padded.reshape(groups, 32, KW)
             << np.arange(32, dtype=np.uint32)[None, :, None]
             ).sum(axis=1, dtype=np.uint32)
    return PacketOperand(
        bitmatrix=torch.from_numpy(B.copy()).to(device),
        masks=torch.from_numpy(masks.view(np.int32)).to(device),
        k=KW // w, w=int(w))


def operand_packet_bitmatrix(operand: PacketOperand) -> np.ndarray:
    """The bitmatrix that ``operand.masks`` encodes."""
    masks = operand.masks.cpu().numpy().view(np.uint32)
    bits = (masks[:, None, :] >> np.arange(32, dtype=np.uint32)
            [None, :, None]) & 1                            # [g, u, c]
    return bits.reshape(-1, masks.shape[1])[:operand.rows].astype(np.uint8)


def schedule_operand(schedule, k: int, w: int, device) -> ScheduleOperand:
    """B3 operand for an XOR schedule over k*w input packet rows: CSR
    arrays prev [R], start [R+1], cols [nnz], all int32."""
    schedule = tuple((int(p), tuple(int(c) for c in cols))
                     for p, cols in schedule)
    R = len(schedule)
    if R == 0 or R % w:
        raise ValueError(f"{R} schedule rows do not fit w={w}")
    for r, (p, cols) in enumerate(schedule):
        if not -1 <= p < r:
            raise ValueError(f"row {r} starts from row {p}, not an "
                             f"earlier one")
        if any(not 0 <= c < k * w for c in cols):
            raise ValueError(f"row {r} reads a column outside k*w = "
                             f"{k * w}")
    prev = np.array([p for p, _ in schedule], dtype=np.int32)
    start = np.cumsum([0] + [len(cols) for _, cols in schedule]
                      ).astype(np.int32)
    cols = np.array([c for _, cs in schedule for c in cs], dtype=np.int32)
    return ScheduleOperand(
        schedule=schedule,
        prev=torch.from_numpy(prev).to(device),
        start=torch.from_numpy(start).to(device),
        cols=torch.from_numpy(cols).to(device), k=int(k), w=int(w))


def operand_schedule(operand: ScheduleOperand) -> tuple:
    """The schedule that the operand's CSR arrays encode."""
    prev, start, cols = (t.cpu().numpy().tolist() for t in
                         (operand.prev, operand.start, operand.cols))
    return tuple((p, tuple(cols[start[r]:start[r + 1]]))
                 for r, p in enumerate(prev))
