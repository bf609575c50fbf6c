"""Kernel B3: the packet-layout apply from an XOR schedule, from
csrc/packet_xor.cu.

``packet_xor(operand, data, packetsize)`` computes the same function as
kernel B2 (ops/packet_kernel.py), uint8 [batch, k, L] -> uint8
[batch, R/w, L], from the XOR schedule of the bitmatrix
(``torch_engine.build_xor_schedule``): each output row is built from
scratch or from an earlier output row XOR the inputs where they differ.
On a CUDA tensor it launches the hand-written kernel, which replaces the
TPU kernel ``_packet_pallas_fn`` (ceph_tpu/ops/jax_engine.py:234), or
raises.  On a CPU tensor it runs the plain PyTorch version,
``packet_xor_plain``, the twin of the reference's ``_packet_chain``.
``launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from .cuda_build import KernelLibrary, launch
from .packet_kernel import (STAGES, WARPS, align16, check_io, check_smem,
                            kernel_regs, stage_bytes, tile_plan)

_LIB = KernelLibrary(
    "packet_xor.cu", "packet_xor_apply",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
     ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    extra={"packet_smem_limit": [ctypes.c_int],
           "packet_xor_regs": [ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_int)]})
build = _LIB.build

launches = 0


@dataclass(frozen=True)
class ScheduleOperand:
    """B3's operand for one XOR schedule, resident on one device.

    ``schedule`` is the tuple of ``(prev_row or -1, (input cols...))``
    per output row (the plain version's input); the kernel reads it as
    CSR int32 arrays: ``prev`` [R], ``start`` [R+1] and ``cols`` [nnz],
    where row r XORs cols[start[r]:start[r+1]] into row prev[r] (or into
    zero)."""
    schedule: tuple
    prev: torch.Tensor
    start: torch.Tensor
    cols: torch.Tensor
    k: int
    w: int

    @property
    def rows(self) -> int:
        return self.prev.numel()

    @property
    def m_out(self) -> int:
        return self.rows // self.w

    @property
    def device(self) -> torch.device:
        return self.prev.device

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.prev, self.start, self.cols))


def xor_smem(kw: int, rows: int, nnz: int, tile: int) -> int:
    """B3's block figure (xor_layout in csrc/packet_xor.cu): the ring, the
    output tile (rows x tile bytes, for rows that start from an earlier
    row), the program (groups of eight 2-byte entries, at most
    ceil(nnz/8) + rows), prev, the rows in program order, and the segment
    table (two ints per (wave, warp), at most WARPS * rows + 1 each, and
    the wave count)."""
    otile = align16(STAGES * stage_bytes(kw, tile))
    prog = align16(otile + rows * tile)
    prev = prog + 16 * ((nnz + 7) // 8 + rows)
    segs = prev + 8 * rows
    return align16(segs + 8 * (WARPS * rows + 1) + 4)


def launch_plan(operand: ScheduleOperand, packetsize: int) -> tuple:
    """(tile, shared-memory bytes) of B3 for this operand and packet
    size."""
    kw, nnz = operand.k * operand.w, operand.cols.numel()
    return tile_plan(packetsize,
                     lambda t: xor_smem(kw, operand.rows, nnz, t))


def regs() -> tuple:
    """(registers, local bytes) per thread of B3's kernel."""
    return kernel_regs(_LIB, "packet_xor_regs")


def packet_xor_plain(schedule, data: torch.Tensor, w: int,
                     packetsize: int) -> torch.Tensor:
    """Plain PyTorch B3: uint8 [batch, k, L] -> uint8 [batch, R/w, L],
    one XOR of whole packet rows per schedule entry."""
    batch, k, L = data.shape
    ps = packetsize
    nw = L // (w * ps)
    x = data.reshape(batch, k, nw, w, ps).permute(0, 2, 1, 3, 4)
    x = x.reshape(batch, nw, k * w, ps)
    outs = []
    for prev, cols in schedule:
        acc = outs[prev] if prev >= 0 else None
        for c in cols:
            acc = x[:, :, c] if acc is None else acc ^ x[:, :, c]
        outs.append(torch.zeros_like(x[:, :, 0]) if acc is None else acc)
    m_out = len(schedule) // w
    out = torch.stack(outs, dim=2).view(batch, nw, m_out, w, ps)
    return out.permute(0, 2, 1, 3, 4).reshape(batch, m_out, L)


def packet_xor(operand: ScheduleOperand, data: torch.Tensor,
               packetsize: int,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply B3.  CUDA tensors launch the kernel on the current stream;
    CPU tensors take packet_xor_plain; any other device raises."""
    global launches
    check_io("B3", operand, data, packetsize, out)
    for t in (operand.prev, operand.start, operand.cols):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("B3 operand arrays must be contiguous int32")
    if data.device.type == "cpu":
        res = packet_xor_plain(operand.schedule, data, operand.w,
                               packetsize)
        if out is not None:
            out.copy_(res)
            return out
        return res
    if data.device.type != "cuda":
        raise ValueError(f"B3 runs on cuda or cpu, not {data.device}")
    tile, smem = launch_plan(operand, packetsize)
    check_smem("B3", _LIB, data.device, smem, operand.k * operand.w)
    batch, k, L = data.shape
    if out is None:
        out = torch.empty((batch, operand.m_out, L), dtype=torch.uint8,
                          device=data.device)
    if out.numel() == 0:
        return out
    launch(_LIB, data.device, operand.prev.data_ptr(),
           operand.start.data_ptr(), operand.cols.data_ptr(),
           data.data_ptr(), out.data_ptr(), batch, k, operand.w,
           operand.rows, operand.cols.numel(), packetsize,
           L // (operand.w * packetsize), tile, smem, data.device.index)
    launches += 1
    return out
