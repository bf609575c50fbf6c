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
from .packet_kernel import check_io

_LIB = KernelLibrary(
    "packet_xor.cu", "packet_xor_apply",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
     ctypes.c_void_p])
build = _LIB.build
# packet offsets and the schedule share the 48 KiB a block gets without
# an opt-in attribute
MAX_SMEM = 48 * 1024

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

    def smem_bytes(self) -> int:
        return ((self.k * self.w + self.rows) * 8
                + (2 * self.rows + 1 + self.cols.numel()) * 4)


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
    if operand.smem_bytes() > MAX_SMEM:
        raise ValueError(f"B3 operand needs {operand.smem_bytes()} bytes "
                         f"of shared memory, more than {MAX_SMEM}")
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
           L // (operand.w * packetsize))
    launches += 1
    return out
