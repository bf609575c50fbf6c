"""Kernel B1: the GF(2^8) bit-plane apply, built from csrc/gf8_bitplane.cu.

``gf8_apply(operand, data)`` maps uint8 [batch, k, L] to uint8
[batch, m_out, L] with the bitmatrix the operand was made from
(ops/carry.py).  On a CUDA tensor it launches the hand-written kernel,
which replaces the TPU kernel ``_gf_mxu_pallas_fn``
(ceph_tpu/ops/jax_engine.py:382), or raises.  The kernel reads the
operand's byte tables: 8-byte lookups per (output chunk, input chunk,
field of 3, 3 or 2 input bits), done with the byte-permute instruction.
On a CPU tensor it runs the plain PyTorch version, ``gf8_apply_plain``:
bit-plane unpack, a mod-2 product, repack.

The CUDA source is compiled with nvcc at first use into build/kernels/
at the repo root and loaded with ctypes (ops/cuda_build.py); a missing
nvcc or a failed build raises.  ``launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from . import cuda_build
from .cuda_build import KernelLibrary, launch

_LIB = KernelLibrary(
    "gf8_bitplane.cu", "gf8_bitplane_apply",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_void_p],
    extra={"gf8_bitplane_regs": [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int)]})
build = _LIB.build
# shared memory holds the tables, 24 bytes per (output, input chunk): stay
# under the 48 KiB a block gets without an opt-in attribute
TABLE_BYTES = 24
MAX_TABLE_BYTES = 48 * 1024
# the load and store widths the kernel is built for (csrc/gf8_bitplane.cu)
UNITS = (16, 8, 4, 1)

launches = 0


@dataclass(frozen=True)
class Gf8Operand:
    """B1's operand for one row set, resident on one device.

    ``bitmatrix`` uint8 [8*m_out, 8*k] is the 0/1 matrix (the plain
    version's input); ``tables`` int32 [m_out, k, 3, 2] is what the kernel
    reads: per (output e, chunk c, field g) 8 bytes, entry v the XOR of
    the column bytes of input bits 3g+b for the set bits b of v
    (ops/carry.py)."""
    bitmatrix: torch.Tensor
    tables: torch.Tensor
    k: int
    m_out: int

    @property
    def device(self) -> torch.device:
        return self.tables.device

    @property
    def nbytes(self) -> int:
        return (self.bitmatrix.numel() * self.bitmatrix.element_size()
                + self.tables.numel() * self.tables.element_size())


def sass_opcodes(unit: int = 16) -> Optional[dict]:
    """Static SASS opcode counts of B1's kernel for ``unit``-byte loads
    and stores (ops/cuda_build.py)."""
    return cuda_build.sass_opcodes(_LIB, f"gf8_table_kernelILi{unit}E")


def regs(unit: int = 16) -> tuple:
    """(registers, local bytes) per thread of B1's kernel built for loads
    and stores of ``unit`` bytes (16 on the main path)."""
    if unit not in UNITS:
        raise ValueError(f"B1 is built for units {UNITS}, not {unit}")
    nregs, local = ctypes.c_int(0), ctypes.c_int(0)
    err = _LIB.fn("gf8_bitplane_regs")(unit, ctypes.byref(nregs),
                                       ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"gf8_bitplane_regs: CUDA error {err}")
    return nregs.value, local.value


def gf8_apply_plain(bitmatrix, data: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch B1: uint8 [batch, k, L] -> uint8 [batch, R/8, L].
    A float32 product of 0/1 planes is exact: sums stay <= 8k << 2^24."""
    B = torch.as_tensor(bitmatrix).to(device=data.device,
                                      dtype=torch.float32)
    batch, k, L = data.shape
    R = B.shape[0]
    if B.shape[1] != 8 * k or R % 8:
        raise ValueError(f"bitmatrix {tuple(B.shape)} does not fit k={k}")
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = (data.unsqueeze(2) >> shifts.view(8, 1)) & 1  # [b, k, 8, L]
    bits = bits.reshape(batch, 8 * k, L).to(torch.float32)
    prod = torch.matmul(B, bits)                          # [b, R, L]
    pb = (prod.to(torch.int32) & 1).to(torch.uint8)
    pb = pb.view(batch, R // 8, 8, L) << shifts.view(8, 1)
    return pb.sum(dim=2).to(torch.uint8)


def _check(operand: Gf8Operand, data: torch.Tensor,
           out: Optional[torch.Tensor]) -> None:
    if data.dtype != torch.uint8 or data.dim() != 3:
        raise ValueError("B1 takes uint8 [batch, k, L] data")
    if data.shape[1] != operand.k:
        raise ValueError(f"data has {data.shape[1]} chunks, operand "
                         f"expects k={operand.k}")
    if data.device != operand.device:
        raise ValueError(f"data on {data.device}, operand on "
                         f"{operand.device}")
    if not data.is_contiguous():
        raise ValueError("B1 takes contiguous data")
    if (operand.tables.dtype != torch.int32
            or tuple(operand.tables.shape) != (operand.m_out, operand.k, 3, 2)
            or not operand.tables.is_contiguous()):
        raise ValueError("B1 operand tables must be contiguous int32 "
                         "[m_out, k, 3, 2]")
    if out is not None:
        want = (data.shape[0], operand.m_out, data.shape[2])
        if (out.dtype != torch.uint8 or tuple(out.shape) != want
                or out.device != data.device or not out.is_contiguous()):
            raise ValueError(f"B1 out must be contiguous uint8 {want} on "
                             f"{data.device}")


def gf8_apply(operand: Gf8Operand, data: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply B1.  CUDA tensors launch the kernel on the current stream;
    CPU tensors take gf8_apply_plain; any other device raises."""
    global launches
    _check(operand, data, out)
    if data.device.type == "cpu":
        res = gf8_apply_plain(operand.bitmatrix, data)
        if out is not None:
            out.copy_(res)
            return out
        return res
    if data.device.type != "cuda":
        raise ValueError(f"B1 runs on cuda or cpu, not {data.device}")
    if operand.m_out * operand.k * TABLE_BYTES > MAX_TABLE_BYTES:
        raise ValueError(
            f"B1 tables need {operand.m_out * operand.k * TABLE_BYTES} "
            f"bytes of shared memory at m_out*k = {operand.m_out}*"
            f"{operand.k}, more than {MAX_TABLE_BYTES}: it takes m_out*k <= "
            f"{MAX_TABLE_BYTES // TABLE_BYTES}")
    batch, k, L = data.shape
    if out is None:
        out = torch.empty((batch, operand.m_out, L), dtype=torch.uint8,
                          device=data.device)
    if out.numel() == 0:
        return out
    launch(_LIB, data.device, operand.tables.data_ptr(), data.data_ptr(),
           out.data_ptr(), batch, k, operand.m_out, L, data.device.index)
    launches += 1
    return out
