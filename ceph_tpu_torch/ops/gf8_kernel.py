"""Kernel B1: the GF(2^8) bit-plane apply, built from csrc/gf8_bitplane.cu.

``gf8_apply(operand, data)`` maps uint8 [batch, k, L] to uint8
[batch, m_out, L] with the bitmatrix the operand was made from
(ops/carry.py).  On a CUDA tensor it launches the hand-written kernel,
which replaces the TPU kernel ``_gf_mxu_pallas_fn``
(ceph_tpu/ops/jax_engine.py:382), or raises.  On a CPU tensor it runs
the plain PyTorch version, ``gf8_apply_plain``: bit-plane unpack, a mod-2
product, repack.

The CUDA source is compiled with nvcc at first use into build/kernels/
at the repo root and loaded with ctypes (ops/cuda_build.py); a missing
nvcc or a failed build raises.  ``launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from .cuda_build import KernelLibrary, launch

_LIB = KernelLibrary(
    "gf8_bitplane.cu", "gf8_bitplane_apply",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])
build = _LIB.build
# shared memory holds cols [m_out, k, 8] of uint32: stay under the
# 48 KiB a block gets without an opt-in attribute
MAX_COLS = (48 * 1024) // 4

launches = 0


@dataclass(frozen=True)
class Gf8Operand:
    """B1's operand for one row set, resident on one device.

    ``bitmatrix`` uint8 [8*m_out, 8*k] is the 0/1 matrix (the plain
    version's input); ``cols`` int32 [m_out, k, 8] is what the kernel
    reads: the byte with bit i = bitmatrix[8e+i, 8c+j], in all four byte
    lanes of word (e, c, j)."""
    bitmatrix: torch.Tensor
    cols: torch.Tensor
    k: int
    m_out: int

    @property
    def device(self) -> torch.device:
        return self.cols.device

    @property
    def nbytes(self) -> int:
        return (self.bitmatrix.numel() * self.bitmatrix.element_size()
                + self.cols.numel() * self.cols.element_size())


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
    if operand.cols.dtype != torch.int32 or not operand.cols.is_contiguous():
        raise ValueError("B1 operand cols must be contiguous int32")
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
    if operand.m_out * operand.k * 8 > MAX_COLS:
        raise ValueError(f"B1 takes m_out*k <= {MAX_COLS // 8}, got "
                         f"{operand.m_out}*{operand.k}")
    batch, k, L = data.shape
    if out is None:
        out = torch.empty((batch, operand.m_out, L), dtype=torch.uint8,
                          device=data.device)
    if out.numel() == 0:
        return out
    launch(_LIB, data.device, operand.cols.data_ptr(), data.data_ptr(),
           out.data_ptr(), batch, k, operand.m_out, L)
    launches += 1
    return out
