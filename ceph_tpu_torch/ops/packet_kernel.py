"""Kernel B2: the packet-layout bitmatrix apply, from csrc/packet_bitplane.cu.

``packet_apply(operand, data, packetsize)`` maps uint8 [batch, k, L]
(L = nw * w * packetsize) to uint8 [batch, R/w, L]: output packet r of
every super-word is the XOR of the input packets that row r of the
operand's bitmatrix selects (ops/carry.py builds the operand).  On a CUDA
tensor it launches the hand-written kernel, which replaces the TPU kernel
``_packet_mxu_pallas_fn`` (ceph_tpu/ops/jax_engine.py:289), or raises.  On
a CPU tensor it runs the plain PyTorch version, ``packet_apply_plain``:
bit-plane unpack, a mod-2 product, repack.  ``launches`` counts the
kernel launches.

Both packet kernels (B2 here, B3 in ops/packet_xor_kernel.py) stage each
item's tile, bytes [t*tile, t*tile + n) of every input packet of one
super-word, in a ring of STAGES tiles in shared memory
(csrc/packet_io.cuh).  ``tile_plan`` picks the tile for a launch and the
block's shared-memory figure; the wrapper refuses a figure above the
device's opt-in limit with a ValueError before anything launches, and the
C entry point recomputes the figure from the same layout and refuses a
launch that disagrees.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from .cuda_build import KernelLibrary, launch

_LIB = KernelLibrary(
    "packet_bitplane.cu", "packet_bitplane_apply",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
     ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_void_p],
    extra={"packet_smem_limit": [ctypes.c_int],
           "packet_bitplane_regs": [ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int)]})
build = _LIB.build

# the staging ring of csrc/packet_io.cuh
THREADS = 256          # threads per block (kThreads)
WARPS = THREADS // 32  # warps share a tile's output rows (kWarps)
STAGES = 2             # tiles in the ring (kStages)
TILE_MIN, TILE_MAX = 16, 1024
# two blocks per SM: an H100 SM has 228 KiB of shared memory, of which the
# runtime reserves 1 KiB per block
BLOCK_TARGET = (228 * 1024 - 2 * 1024) // 2

launches = 0


@dataclass(frozen=True)
class PacketOperand:
    """B2's operand for one bitmatrix, resident on one device.

    ``bitmatrix`` uint8 [R, k*w] is the 0/1 matrix (the plain version's
    input); ``masks`` int32 [ceil(R/32), k*w] is what the kernel reads:
    bit u of masks[g, c] is bitmatrix[32g+u, c]."""
    bitmatrix: torch.Tensor
    masks: torch.Tensor
    k: int
    w: int

    @property
    def rows(self) -> int:
        return self.bitmatrix.shape[0]

    @property
    def m_out(self) -> int:
        return self.rows // self.w

    @property
    def device(self) -> torch.device:
        return self.masks.device

    @property
    def nbytes(self) -> int:
        return (self.bitmatrix.numel() * self.bitmatrix.element_size()
                + self.masks.numel() * self.masks.element_size())


def align16(x: int) -> int:
    return (x + 15) & ~15


def stage_bytes(kw: int, tile: int) -> int:
    """One stage of the ring: the k*w input rows of an item and the zero
    row that empty entries point at (csrc/packet_io.cuh)."""
    return (kw + 1) * tile


def tile_plan(packetsize: int, smem_of) -> tuple:
    """(tile, shared-memory bytes) of a launch: the largest power-of-two
    tile from TILE_MAX down to TILE_MIN, and no larger than the packet
    needs, at which a block's figure ``smem_of(tile)`` leaves room for
    two blocks on an SM; TILE_MIN when none does (the wrapper then checks
    the figure against the device's limit)."""
    tile = min(TILE_MAX, max(TILE_MIN, 1 << (packetsize - 1).bit_length()))
    while tile > TILE_MIN and smem_of(tile) > BLOCK_TARGET:
        tile //= 2
    return tile, smem_of(tile)


def bitplane_smem(kw: int, rows: int, tile: int) -> int:
    """B2's block figure (bitplane_layout in csrc/packet_bitplane.cu): the
    ring, then per unit of 4 rows a list of k*w + 45 2-byte column
    entries (rounded up to 8) and 16 class bounds."""
    units = (rows + 3) // 4
    lists = align16(STAGES * stage_bytes(kw, tile))
    bounds = lists + 2 * units * ((kw + 45 + 7) & ~7)
    return align16(bounds + 64 * units)


def launch_plan(operand: "PacketOperand", packetsize: int) -> tuple:
    """(tile, shared-memory bytes) of B2 for this operand and packet
    size."""
    kw = operand.k * operand.w
    return tile_plan(packetsize,
                     lambda t: bitplane_smem(kw, operand.rows, t))


_SMEM_LIMITS: dict = {}


def smem_limit(device, lib: Optional[KernelLibrary] = None) -> int:
    """The device's opt-in shared memory per block, from the C side (of
    ``lib``, B2's library by default), once per device."""
    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    if idx not in _SMEM_LIMITS:
        _SMEM_LIMITS[idx] = (lib or _LIB).fn("packet_smem_limit")(idx)
    return _SMEM_LIMITS[idx]


def check_smem(kernel: str, lib: KernelLibrary, device, smem: int,
               kw: int) -> None:
    limit = smem_limit(device, lib)
    if smem > limit:
        raise ValueError(f"{kernel} needs {smem} bytes of shared memory at "
                         f"k*w = {kw}, more than the device's {limit}")


def kernel_regs(lib: KernelLibrary, symbol: str) -> tuple:
    """(registers, local bytes) per thread of a compiled packet kernel."""
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.fn(symbol)(ctypes.byref(regs), ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA error {err}")
    return regs.value, local.value


def regs() -> tuple:
    """(registers, local bytes) per thread of B2's kernel."""
    return kernel_regs(_LIB, "packet_bitplane_regs")


def packet_apply_plain(bitmatrix, data: torch.Tensor, w: int,
                       packetsize: int) -> torch.Tensor:
    """Plain PyTorch B2: uint8 [batch, k, L] -> uint8 [batch, R/w, L].
    A float32 product of 0/1 planes is exact: sums stay <= k*w << 2^24."""
    B = torch.as_tensor(bitmatrix).to(device=data.device,
                                      dtype=torch.float32)
    batch, k, L = data.shape
    ps = packetsize
    nw = L // (w * ps)
    x = data.reshape(batch, k, nw, w, ps).permute(0, 2, 1, 3, 4)
    x = x.reshape(batch * nw, k * w, ps)
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = ((x.unsqueeze(-1) >> shifts) & 1).to(torch.float32)
    prod = torch.matmul(B, bits.reshape(batch * nw, k * w, ps * 8))
    R = B.shape[0]
    pb = (prod.to(torch.int32) & 1).to(torch.uint8)
    ob = (pb.view(batch * nw, R, ps, 8) << shifts).sum(dim=-1)
    ob = ob.to(torch.uint8).view(batch, nw, R // w, w, ps)
    return ob.permute(0, 2, 1, 3, 4).reshape(batch, R // w, L)


def check_io(kernel: str, operand, data: torch.Tensor, packetsize: int,
             out: Optional[torch.Tensor]) -> None:
    """What B2 and B3 take: contiguous uint8 [batch, k, L] data on the
    operand's device, L a multiple of w*packetsize, and an ``out`` of the
    output's shape, type and device."""
    if data.dtype != torch.uint8 or data.dim() != 3:
        raise ValueError(f"{kernel} takes uint8 [batch, k, L] data")
    if data.shape[1] != operand.k:
        raise ValueError(f"data has {data.shape[1]} chunks, operand "
                         f"expects k={operand.k}")
    if packetsize <= 0 or data.shape[2] % (operand.w * packetsize):
        raise ValueError(f"chunk length {data.shape[2]} is not a multiple "
                         f"of w*packetsize = {operand.w}*{packetsize}")
    if data.device != operand.device:
        raise ValueError(f"data on {data.device}, operand on "
                         f"{operand.device}")
    if not data.is_contiguous():
        raise ValueError(f"{kernel} takes contiguous data")
    if out is not None:
        want = (data.shape[0], operand.m_out, data.shape[2])
        if (out.dtype != torch.uint8 or tuple(out.shape) != want
                or out.device != data.device or not out.is_contiguous()):
            raise ValueError(f"{kernel} out must be contiguous uint8 {want} "
                             f"on {data.device}")


def packet_apply(operand: PacketOperand, data: torch.Tensor,
                 packetsize: int,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply B2.  CUDA tensors launch the kernel on the current stream;
    CPU tensors take packet_apply_plain; any other device raises."""
    global launches
    check_io("B2", operand, data, packetsize, out)
    if (operand.masks.dtype != torch.int32
            or not operand.masks.is_contiguous()):
        raise ValueError("B2 operand masks must be contiguous int32")
    if data.device.type == "cpu":
        res = packet_apply_plain(operand.bitmatrix, data, operand.w,
                                 packetsize)
        if out is not None:
            out.copy_(res)
            return out
        return res
    if data.device.type != "cuda":
        raise ValueError(f"B2 runs on cuda or cpu, not {data.device}")
    tile, smem = launch_plan(operand, packetsize)
    check_smem("B2", _LIB, data.device, smem, operand.k * operand.w)
    batch, k, L = data.shape
    if out is None:
        out = torch.empty((batch, operand.m_out, L), dtype=torch.uint8,
                          device=data.device)
    if out.numel() == 0:
        return out
    launch(_LIB, data.device, operand.masks.data_ptr(), data.data_ptr(),
           out.data_ptr(), batch, k, operand.w, operand.rows, packetsize,
           L // (operand.w * packetsize), tile, smem, data.device.index)
    launches += 1
    return out
