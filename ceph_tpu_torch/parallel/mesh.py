"""Device-mesh sharding for the batched erasure-code engine.

Twin of the JAX package's parallel/mesh.py.  Stripe batches from the PG
write queue are sharded over a 2-D mesh of devices:

  * ``dp`` (data-parallel) shards the stripe-batch axis, the analog of
    the sharded PG queue fan-out (reference osd/OSD.h:1287);
  * ``sp`` (sequence-parallel) shards the chunk-width axis, the analog of
    the stripe/Striper tiling of large objects (reference
    osdc/Striper.h:26, osd/ECUtil.h:27) — GF codes act per byte
    position, so width splits need no halo exchange.

A batch [batch, C, L] laid out (dp, None, sp) is a ``ShardedArray``:
block (i, j) holds rows i*b..(i+1)*b and columns j*l..(j+1)*l of every
chunk, as its own contiguous tensor on the device of mesh position
(i, j).  Each block is applied by kernel B1 (w=8) or by the plain torch
bit-plane product (w=16, 32) on its own device; the integrity digest,
the JAX package's ``psum``, is a sum over blocks modulo 2^32.

The devices are what ``visible_devices`` returns: every CUDA ordinal, or
the one CPU.  ``CEPH_TPU_TORCH_FORCE_DEVICE_COUNT=n`` instead gives n
logical devices, ids 0..n-1, on the backend's own device — the
counterpart of XLA's ``--xla_force_host_platform_device_count``, a
recipe for tests and for driving the sharded path on one card.  One
device means no mesh (``resolve_mesh`` returns None), so one card keeps
the single-device path.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.carry import bitmatrix_split, carry_rows
from ..ops.gf8_kernel import gf8_apply
from ..ops.matrix import matrix_to_bitmatrix
from ..ops.torch_engine import (_apply_byte_domain_plain, gf8_apply_split,
                                resolve_device)

FORCE_DEVICE_COUNT = "CEPH_TPU_TORCH_FORCE_DEVICE_COUNT"

_MASK32 = 0xFFFFFFFF
_GOLDEN = 2654435761          # the JAX package's digest multiplier


class LogicalDevice:
    """One place of a mesh: its logical id and the torch device that
    holds its blocks (several ids share a device under a forced count)."""

    __slots__ = ("id", "device")

    def __init__(self, id: int, device: torch.device):
        self.id = int(id)
        self.device = device

    def __repr__(self) -> str:
        return f"LogicalDevice(id={self.id}, device={self.device})"


class Mesh:
    """A [dp, sp] grid of logical devices with named axes."""

    def __init__(self, devices: np.ndarray,
                 axis_names: Sequence[str] = ("dp", "sp")):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def device_ids(self) -> list:
        return [d.id for d in self.devices.flat]

    @property
    def physical_devices(self) -> list:
        """The distinct torch devices under the mesh, in mesh order."""
        return list(dict.fromkeys(d.device for d in self.devices.flat))

    @property
    def key(self) -> tuple:
        """Hashable identity for operand caches: shape and placement."""
        return (tuple(self.devices.shape),
                tuple(str(d.device) for d in self.devices.flat))

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape[self.axis_names[0]]}, "
                f"sp={self.shape[self.axis_names[1]]}, "
                f"devices={self.physical_devices})")


def visible_devices(device="cuda") -> list:
    """The logical devices a mesh may use: every CUDA ordinal (for a
    CUDA ``device``) or the one CPU; with FORCE_DEVICE_COUNT=n, n
    logical devices on ``device`` itself.  Raises RuntimeError when
    CUDA is asked for and absent."""
    home = resolve_device(device)
    forced = os.environ.get(FORCE_DEVICE_COUNT, "").strip()
    if forced:
        try:
            n = int(forced)
        except ValueError:
            n = 0
        if n < 1:
            raise ValueError(f"{FORCE_DEVICE_COUNT}={forced!r} is not a "
                             f"positive device count")
        return [LogicalDevice(i, home) for i in range(n)]
    if home.type == "cuda":
        return [LogicalDevice(i, torch.device("cuda", i))
                for i in range(torch.cuda.device_count())]
    return [LogicalDevice(0, home)]


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("dp", "sp"),
              sp: Optional[int] = None, device="cuda") -> Mesh:
    """Build a 2-D mesh over the visible devices.

    ``sp`` (intra-chunk width axis) defaults to the largest factor of n
    that keeps ``dp >= sp`` — the dp axis (stripe batching) carries the
    bigger fan-out because stripe counts dwarf per-chunk width in the
    OSD workload.  Pass ``sp`` explicitly to override (must divide n)."""
    devices = visible_devices(device)
    n = n_devices or len(devices)
    n = min(n, len(devices))
    devices = devices[:n]
    if sp is None:
        sp = 1
        f = 1
        while f * f <= n:
            if n % f == 0:
                sp = f               # largest factor with dp >= sp
            f += 1
    if n % sp != 0:
        raise ValueError(f"sp={sp} does not divide {n} devices")
    dp = n // sp
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devices):
        grid[i] = d
    return Mesh(grid.reshape(dp, sp), axis_names)


def resolve_mesh(n_devices: int = 0, sp: int = 0,
                 device="cuda") -> Optional[Mesh]:
    """Resolve the production mesh from conf-style knobs (0 = auto).

    Returns ``None`` when the effective device count is 1 (or CUDA is
    absent): a 1x1 mesh buys nothing, and the backend treats it as "no
    mesh" so the single-device path stays byte- and launch-identical."""
    try:
        avail = len(visible_devices(device))
    except RuntimeError:
        return None
    n = n_devices or avail
    n = min(n, avail)
    if n <= 1:
        return None
    return make_mesh(n_devices=n, sp=sp or None, device=device)


def mesh_info(mesh: Optional[Mesh]) -> Optional[dict]:
    """JSON-able mesh shape summary for dump_device / bench records."""
    if mesh is None:
        return None
    dp = int(mesh.shape["dp"])
    sp = int(mesh.shape["sp"])
    return {
        "dp": dp,
        "sp": sp,
        "n_devices": dp * sp,
        "device_ids": mesh.device_ids,
    }


# ---------------------------------------------------------------------------
# sharded arrays
# ---------------------------------------------------------------------------

class ShardedArray:
    """A [batch, C, L] array laid out (dp, None, sp) over ``mesh``:
    ``blocks[i][j]`` is the contiguous [batch/dp, C, L/sp] block of dp
    row i and sp column j, on the device of ``mesh.devices[i, j]``."""

    def __init__(self, mesh: Mesh, blocks: list):
        self.mesh = mesh
        self.blocks = blocks
        b, c, l = blocks[0][0].shape
        self.shape = (b * len(blocks), c, l * len(blocks[0]))

    def map(self, fn) -> "ShardedArray":
        """``fn(block)`` on every block, in mesh order."""
        return ShardedArray(self.mesh, [[fn(blk) for blk in row]
                                        for row in self.blocks])

    def gather(self, device=None) -> torch.Tensor:
        """The whole array as one contiguous tensor on ``device`` (the
        first block's by default); the copies are enqueued, not
        waited for."""
        first = self.blocks[0][0]
        out = torch.empty(self.shape, dtype=first.dtype,
                          device=device or first.device)
        b, _, l = first.shape
        for i, row in enumerate(self.blocks):
            for j, blk in enumerate(row):
                out[i * b:(i + 1) * b, :, j * l:(j + 1) * l].copy_(
                    blk, non_blocking=True)
        return out

    def numpy(self) -> np.ndarray:
        return self.gather().cpu().numpy()

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        out = self.numpy()
        return out if dtype is None else out.astype(dtype)


def shard_batch(mesh: Mesh, data) -> ShardedArray:
    """Place a batch [batch, k, L] (numpy or torch) onto the mesh (dp,
    None, sp): each block becomes a contiguous tensor on its device, as
    ``jax.device_put`` does with a NamedSharding.  A block that already
    is one (an sp=1 block of a tensor on that device) is used as it is,
    without a copy."""
    if isinstance(data, np.ndarray):
        data = torch.from_numpy(np.ascontiguousarray(data))
    batch, _, L = data.shape
    dp, sp = mesh.devices.shape
    if batch % dp or L % sp:
        raise ValueError(f"batch {batch} and length {L} do not shard over "
                         f"dp={dp} x sp={sp}")
    b, l = batch // dp, L // sp
    return ShardedArray(mesh, [
        [data[i * b:(i + 1) * b, :, j * l:(j + 1) * l].to(
            mesh.devices[i, j].device, non_blocking=True).contiguous()
         for j in range(sp)] for i in range(dp)])


# ---------------------------------------------------------------------------
# the digest
# ---------------------------------------------------------------------------

def _fold_digest(parity_sum: torch.Tensor) -> torch.Tensor:
    """Cheap integrity digest of a parity block (scrub analog, reference
    ECBackend.cc:2475 per-shard CRC): the block's sum, modulo 2^32,
    times a 32-bit multiplier, modulo 2^32 — the JAX package's uint32
    arithmetic in int64, the product split in 16-bit halves so no step
    passes 2^63."""
    s = parity_sum.to(torch.int64) & _MASK32
    lo = s * (_GOLDEN & 0xFFFF)
    hi = ((s * (_GOLDEN >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _bit_sum(block: torch.Tensor) -> torch.Tensor:
    """Set bits of a parity block (the sum of the JAX package's
    ``out_bits``)."""
    return sum(((block >> b) & 1).sum(dtype=torch.int64) for b in range(8))


def _byte_sum(block: torch.Tensor) -> torch.Tensor:
    return block.sum(dtype=torch.int64)


def _psum(parity: ShardedArray, block_sum) -> torch.Tensor:
    """The folded digests of every block, summed modulo 2^32 (the JAX
    package's psum over dp and sp): an int64 scalar tensor on the first
    block's device."""
    home = parity.blocks[0][0].device
    total = sum(_fold_digest(block_sum(blk)).to(home)
                for row in parity.blocks for blk in row)
    return total & _MASK32


# ---------------------------------------------------------------------------
# sharded applies
# ---------------------------------------------------------------------------

class Replicated:
    """A bitmatrix operand with one copy on each physical device of a
    mesh (the P(None, None) layout): at w=8 B1's split operands, else
    the 0/1 matrix of the plain bit-plane product."""

    def __init__(self, mesh: Mesh, bitmatrix, w: int):
        B = np.asarray(bitmatrix).astype(np.uint8)
        self.w = int(w)
        if self.w == 8:
            self.ops = {d: bitmatrix_split(B, B.shape[1] // 8, d)
                        for d in mesh.physical_devices}
        else:
            self.ops = {d: torch.from_numpy(B.copy()).to(d)
                        for d in mesh.physical_devices}

    @property
    def nbytes(self) -> int:
        if self.w == 8:
            return sum(op.nbytes for op in self.ops.values())
        return sum(op.numel() for op in self.ops.values())

    def apply(self, block: torch.Tensor) -> torch.Tensor:
        wbytes = max(1, self.w // 8)
        if block.shape[-1] % wbytes:
            raise ValueError(f"an sp block of {block.shape[-1]} bytes holds "
                             f"no whole number of w={self.w} words")
        op = self.ops[block.device]
        if self.w == 8:
            return gf8_apply_split(op, block)
        return _apply_byte_domain_plain(op, block, self.w)


def sharded_apply_fn(mesh: Mesh, w: int):
    """Sharded generic-w bitmatrix apply: fn(B, data) -> parity, with
    ``B`` a ``Replicated`` operand (or a host bitmatrix, replicated per
    call) and ``data`` a ShardedArray; the output is sharded the same
    way.  The mesh twin of the backend's bitmatrix apply: B1 at w=8, the
    plain bit-plane product at w=16 and 32 (the JAX package's per-shard
    body, ``_matmul_mod2``, runs outside any Pallas kernel too)."""

    def fn(B, data: ShardedArray) -> ShardedArray:
        rep = B if isinstance(B, Replicated) else Replicated(mesh, B, w)
        return data.map(rep.apply)
    return fn


def sharded_encode_fn(mesh: Mesh, w: int):
    """fn(B, data) -> (parity, digest): ``sharded_apply_fn`` plus the
    digest of the parity's set bits (the JAX package folds the sum of
    its output bit-planes), summed over every block."""
    apply = sharded_apply_fn(mesh, w)

    def fn(B, data: ShardedArray):
        parity = apply(B, data)
        return parity, _psum(parity, _bit_sum)
    return fn


class ShardedRows:
    """Sharded w=8 GF row apply: fn(data) -> parity over a ShardedArray,
    each block through B1 with ``TorchBackend.gf8_fn``'s operand, one
    operand a physical device (logical devices of one card share it)."""

    def __init__(self, mesh: Mesh, rows):
        rows = np.asarray(rows, dtype=np.int64)
        bits = matrix_to_bitmatrix(rows, 8)
        self.ops = {d: carry_rows(rows, bits, d)
                    for d in mesh.physical_devices}

    @property
    def nbytes(self) -> int:
        return sum(op.nbytes for op in self.ops.values())

    def __call__(self, data: ShardedArray) -> ShardedArray:
        return data.map(lambda blk: gf8_apply(self.ops[blk.device], blk))


def sharded_rows_fn(mesh: Mesh, rows, donate: bool = False) -> ShardedRows:
    """Sharded w=8 GF row apply for the production dispatch path: encode
    (rows = the coding matrix) and the decode recovery rows.  ``donate``
    is accepted for the JAX package's signature and means nothing here:
    each block's output is a fresh tensor."""
    return ShardedRows(mesh, rows)


def sharded_encode_gf8_fn(mesh: Mesh, coding_matrix,
                          with_digest: bool = True):
    """Sharded w=8 fast path: the per-block kernel is the one the
    single-device backend routes to (B1).  Returns fn(data) -> (parity,
    digest of the parity's bytes), or fn(data) -> parity without the
    digest (the production path: ShardedEncoder)."""
    rows = ShardedRows(mesh, coding_matrix)
    if not with_digest:
        return rows

    def fn(data: ShardedArray):
        parity = rows(data)
        return parity, _psum(parity, _byte_sum)
    return fn


# ---------------------------------------------------------------------------
# process-wide encoder, as the JAX package wires it
# ---------------------------------------------------------------------------

_DEFAULT_MESH: dict = {}       # str(device) -> Mesh or None
_ENCODERS: dict = {}


def reset() -> None:
    """Forget the cached default meshes and encoders (tests that change
    the visible device count call it before and after)."""
    _DEFAULT_MESH.clear()
    _ENCODERS.clear()


def default_mesh(device="cuda") -> Optional[Mesh]:
    """Process-wide mesh over every visible device; None on a
    single-device host (the common case) or without CUDA, cached after
    the first probe."""
    key = str(device)
    if key not in _DEFAULT_MESH:
        try:
            many = len(visible_devices(device)) > 1
        except RuntimeError:
            many = False
        _DEFAULT_MESH[key] = make_mesh(device=device) if many else None
    return _DEFAULT_MESH[key]


class _ShardedAsync:
    """AsyncBatch-shaped handle for a mesh-sharded encode (the batcher
    completion path calls wait() -> parity [B, m, L])."""

    def __init__(self, parity: ShardedArray, batch: int, L: int):
        self._parity = parity
        self._batch = batch
        self._L = L

    def wait(self) -> np.ndarray:
        return self._parity.numpy()[:self._batch, :, :self._L]


class ShardedEncoder:
    """Mesh-wide encode with the single-device async API shape.  Pads the
    stripe-batch axis to a dp multiple (zero stripes are harmless: the
    code is GF-linear); requires chunk length divisible by sp."""

    def __init__(self, mesh: Mesh, coding_matrix):
        self.mesh = mesh
        self.dp = mesh.shape["dp"]
        self.sp = mesh.shape["sp"]
        self._fn = sharded_encode_gf8_fn(mesh, coding_matrix,
                                         with_digest=False)

    def encode_async(self, data: np.ndarray) -> Optional[_ShardedAsync]:
        B, k, L = data.shape
        if L % self.sp:
            return None
        Bp = -(-B // self.dp) * self.dp
        if Bp != B:
            data = np.concatenate(
                [data, np.zeros((Bp - B, k, L), np.uint8)], axis=0)
        return _ShardedAsync(self._fn(shard_batch(self.mesh, data)), B, L)


def shared_encoder(ec_impl) -> Optional[ShardedEncoder]:
    """The process-cached mesh encoder for a codec, or None when its
    device has no mesh or the codec isn't the w=8 byte-domain family
    (packet codes keep the single-device path)."""
    mesh = default_mesh(getattr(ec_impl, "device", "cuda"))
    if mesh is None:
        return None
    core = getattr(ec_impl, "core", None)
    if core is None or core.layout != "byte" or core.w != 8 \
            or core.coding_matrix is None:
        return None
    key = (mesh.key, tuple(tuple(int(v) for v in row)
                           for row in core.coding_matrix))
    enc = _ENCODERS.get(key)
    if enc is None:
        enc = ShardedEncoder(mesh, core.coding_matrix)
        _ENCODERS[key] = enc
    return enc
