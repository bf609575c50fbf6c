"""PyTorch codec engine: erasure codes as batched GF(2) bitmatrix applies.

Twin of the JAX package's ops/jax_engine.py.  Every GF(2^8) constant
multiply is an 8x8 binary matrix, so a k -> m Reed-Solomon code is one
(8m x 8k) 0/1 matrix applied to the bit-planes of a [batch, k, L] stripe
batch.  On the card that apply is kernel B1 (ops/gf8_kernel.py,
csrc/gf8_bitplane.cu), which serves encode (the pool coding matrix),
decode (per-erasure-signature recovery rows, cached like ISA-L's decode
table LRU) and the parity delta.  On the CPU the same wrapper runs its
plain PyTorch version.

The packet-layout (cauchy/liberation) codes XOR whole packets per a 0/1
bitmatrix.  On the card that is kernel B2 (ops/packet_kernel.py,
csrc/packet_bitplane.cu) for packets that are a multiple of 128 bytes and
kernel B3 (ops/packet_xor_kernel.py, csrc/packet_xor.cu), which runs the
bitmatrix's XOR schedule, for every other packet size, as the reference
routes them.  Codes with w = 16 or 32 apply in plain torch ops.

Shapes are bucketed (batch to the next power of two, length to a
multiple of 128) so staging rings and cached operands stay few while the
OSD feeds variable-size stripe batches.  A synchronous w=8 bitmatrix
apply (crclinear's checksum windows) is staged at its own batch and
length: B1 has no per-shape build to share.

Every backend names its device.  ``TorchBackend()`` means CUDA and
raises where there is none; the CPU is used only when asked for.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from .carry import (bitmatrix_split, carry_rows, packet_operand,
                    schedule_operand)
from .gf8_kernel import Gf8Split, gf8_apply
from .matrix import matrix_to_bitmatrix
from .packet_kernel import packet_apply
from .packet_xor_kernel import packet_xor

LENGTH_QUANTUM = 128
# packet sizes that are a multiple of this take kernel B2, others B3
B2_PACKET_QUANTUM = 128


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; CUDA must exist when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "codec on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class ChainLRU:
    """LRU of built per-signature kernel operands — the moral equivalent
    of ISA-L's decode-table cache (reference
    isa/ErasureCodeIsaTableCache.cc:253-306): erasure signatures are few
    (C(k+m, <=m)) and recovery hammers one signature for a whole
    rebuild, so caching the device operand amortizes its build while the
    cap bounds device memory."""

    def __init__(self, cap: int = 256):
        self.cap = cap
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        # per-key in-progress markers: builder() runs OUTSIDE the lock,
        # one build per key, builds of different keys concurrently
        self._building: dict = {}

    def get_or_build(self, key, builder):
        while True:
            with self._lock:
                hit = self._d.get(key)
                if hit is not None:
                    self._d.move_to_end(key)
                    return hit
                ev = self._building.get(key)
                if ev is None:
                    ev = threading.Event()
                    self._building[key] = ev
                    owner = True
                else:
                    owner = False
            if not owner:
                # another thread builds this key; wait and re-check (it
                # may have failed — then we take over)
                ev.wait()
                continue
            try:
                val = builder()
            except BaseException:
                with self._lock:
                    self._building.pop(key, None)
                ev.set()
                raise
            with self._lock:
                self._d[key] = val
                self._d.move_to_end(key)
                while len(self._d) > self.cap:
                    self._d.popitem(last=False)
                self._building.pop(key, None)
            ev.set()
            return val


# ---------------------------------------------------------------------------
# XOR schedules and plain torch applies
# ---------------------------------------------------------------------------

def build_xor_schedule(B: np.ndarray) -> tuple:
    """Greedy delta schedule for a GF(2) bitmatrix: output row i is
    either XOR-ed from scratch, or derived from an earlier output row
    XOR the differing inputs — jerasure's 'smart scheduling' for the
    cauchy/liberation families (reference ErasureCodeJerasure.cc:265
    jerasure_smart_bitmatrix_to_schedule).  Entry = (prev_row_or_-1,
    (input cols to XOR...)); kernel B3 runs it."""
    sets = [frozenset(np.nonzero(np.asarray(r))[0].tolist()) for r in B]
    sched = []
    for i, s in enumerate(sets):
        best_j, best_cost = -1, len(s)
        for j in range(i):
            d = len(sets[j] ^ s) + 1
            if d < best_cost:
                best_cost, best_j = d, j
        if best_j >= 0:
            sched.append((best_j, tuple(sorted(sets[best_j] ^ s))))
        else:
            sched.append((-1, tuple(sorted(s))))
    return tuple(sched)


def _matmul_mod2(B: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """B [R, C] @ bits [batch, C, L] mod 2 -> uint8 [batch, R, L].  CUDA
    matmul takes no int8; a float32 product of 0/1 values is exact (sums
    <= C << 2^24)."""
    out = torch.matmul(B.to(torch.float32), bits.to(torch.float32))
    return (out.to(torch.int32) & 1).to(torch.uint8)


def _apply_byte_domain_plain(B: torch.Tensor, data: torch.Tensor,
                             w: int) -> torch.Tensor:
    """uint8 [batch, k, L] -> uint8 [batch, R/w, L] for a GF(2^w) matrix
    code (w = 8, 16, 32) expanded to bit-planes."""
    batch, k, L = data.shape
    wbytes = max(1, w // 8)
    x = data.to(torch.int64).view(batch, k, L // wbytes, wbytes)
    words = torch.zeros((batch, k, L // wbytes), dtype=torch.int64,
                        device=data.device)
    for i in range(wbytes):
        words |= x[..., i] << (8 * i)
    shifts = torch.arange(w, dtype=torch.int64, device=data.device)
    bits = (words.unsqueeze(2) >> shifts.view(w, 1)) & 1  # [b, k, w, Lw]
    out_bits = _matmul_mod2(B, bits.reshape(batch, k * w, -1))
    m = out_bits.shape[1] // w
    out_bits = out_bits.view(batch, m, w, -1).to(torch.int64)
    out_words = (out_bits << shifts.view(w, 1)).sum(dim=2)  # [b, m, Lw]
    parts = [(out_words >> (8 * i)) & 0xFF for i in range(wbytes)]
    return torch.stack(parts, dim=-1).reshape(batch, m, L).to(torch.uint8)


def gf8_apply_split(split: Gf8Split, data: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B1 over every block of ``split``: uint8 [batch, k, L] -> [batch,
    m_out, L], one gf8_apply a block.  A single block writes ``out``
    directly; otherwise each block writes a contiguous output that is
    copied into its rows, and a block of part of the chunks reads a
    contiguous copy of them, its output XOR-ed into the rows (the map is
    GF(2)-linear, so the sum is exact).  Every block re-reads its input:
    a split into n row groups reads ``data`` n times."""
    if data.dim() != 3 or data.shape[1] != split.k:
        raise ValueError(f"data {tuple(data.shape)} does not fit k="
                         f"{split.k}")
    if len(split.blocks) == 1:
        return gf8_apply(split.blocks[0][1], data, out)
    batch, k, L = data.shape
    if out is None:
        out = torch.empty((batch, split.m_out, L), dtype=torch.uint8,
                          device=data.device)
    for (r0, r1, c0, c1), op in split.blocks:
        part = data if (c0, c1) == (0, k) else data[:, c0:c1].contiguous()
        res = gf8_apply(op, part)
        if c0 == 0:
            out[:, r0:r1].copy_(res)
        else:
            out[:, r0:r1] ^= res
    return out


def _round_up(x: int, q: int) -> int:
    return ((x + q - 1) // q) * q


def _bucket_batch(b: int) -> int:
    if b <= 1:
        return 1
    return 1 << (b - 1).bit_length()


# ---------------------------------------------------------------------------
# staging
# ---------------------------------------------------------------------------

class _StageSlot:
    """One reusable host staging buffer plus the fence that guards it.

    ``fence`` is a CUDA event recorded after the h2d copy out of this
    slot; once it has completed, the host bytes may be overwritten.  On
    the CPU the copy is synchronous and the fence stays None."""

    __slots__ = ("host", "fence", "max_l", "max_b")

    def __init__(self, host: torch.Tensor):
        self.host = host
        self.fence = None
        self.max_l = 0          # column high-water mark (pad hygiene)
        self.max_b = 0          # row (stripe) high-water mark

    @property
    def array(self) -> np.ndarray:
        return self.host.numpy()


class StagingPool:
    """Persistent per-shape host staging rings (double-buffered h2d).

    The pool keeps ``depth`` reusable host buffers per padded
    [batch, k, L] shape — pinned when it stages for CUDA, so the h2d copy
    runs asynchronously: while slot A's batch is still being copied,
    slot B is filled, and re-acquiring A waits only on A's fence.  Shapes
    are few (bucketed), and a shape LRU caps the footprint.

    The pool also keeps the h2d link estimate: every ``sample_every``-th
    staging is fenced end to end and folded into an EWMA (``h2d_bps``)
    that the OSD batcher reads for its crossover model.
    """

    MAX_SHAPES = 16
    STALL_S = 5.0               # acquire() stall cap before the pool
                                # assumes a slot leaked and grows

    def __init__(self, depth: int = 2, sample_every: int = 16,
                 pinned: bool = False):
        self.depth = max(1, int(depth))
        self.sample_every = max(1, int(sample_every))
        self.pinned = bool(pinned)
        self._free: "OrderedDict[tuple, list]" = OrderedDict()
        self._made: dict = {}
        self._cv = threading.Condition()
        self._puts = 0
        self.hits = 0            # stagings served from a reused buffer
        self.allocs = 0          # host staging buffers ever allocated
        self.stall_allocs = 0    # ring grown after an acquire stall
        self.h2d_bps = 0.0       # warm-transfer EWMA (fenced samples)
        self.h2d_samples = 0
        self.host_bytes = 0      # live host-ring footprint (all rings)
        self.host_bytes_peak = 0

    def _new_slot_locked(self, shape: tuple) -> _StageSlot:
        self._made[shape] = self._made.get(shape, 0) + 1
        slot = _StageSlot(torch.zeros(shape, dtype=torch.uint8,
                                      pin_memory=self.pinned))
        self.allocs += 1
        self.host_bytes += slot.host.numel()
        self.host_bytes_peak = max(self.host_bytes_peak, self.host_bytes)
        return slot

    # -- slot checkout -----------------------------------------------
    def acquire(self, shape: tuple) -> _StageSlot:
        deadline = None
        with self._cv:
            while True:
                free = self._free.get(shape)
                if free is None:
                    free = self._free[shape] = []
                self._free.move_to_end(shape)
                if free:
                    slot = free.pop()
                    self.hits += 1
                    break
                if self._made.get(shape, 0) < self.depth:
                    slot = self._new_slot_locked(shape)
                    self._evict_locked()
                    break
                # every slot in flight: wait for a release, bounded so a
                # lost notify can't wedge the encode path; a ring stalled
                # past any plausible fence latency means a slot leaked,
                # so grow by one rather than wedge the OSD write path
                now = time.monotonic()
                if deadline is None:
                    deadline = now + self.STALL_S
                elif now >= deadline:
                    slot = self._new_slot_locked(shape)
                    self.stall_allocs += 1
                    self._evict_locked()
                    break
                self._cv.wait(timeout=0.5)
        fence = slot.fence
        if fence is not None:
            slot.fence = None
            fence.synchronize()
        return slot

    def release(self, shape: tuple, slot: _StageSlot, fence) -> None:
        slot.fence = fence
        with self._cv:
            self._free.setdefault(shape, []).append(slot)
            self._cv.notify_all()

    def _evict_locked(self) -> None:
        # drop the least-recently-used shape's idle ring when the shape
        # set outgrows the cap (only fully idle shapes qualify)
        while len(self._free) > self.MAX_SHAPES:
            for shape in list(self._free):
                if len(self._free[shape]) >= self._made.get(shape, 0):
                    for s in self._free[shape]:
                        self.host_bytes -= s.host.numel()
                    del self._free[shape]
                    self._made.pop(shape, None)
                    break
            else:
                return

    # -- h2d link estimate -------------------------------------------
    def should_sample(self) -> bool:
        self._puts += 1
        return self._puts % self.sample_every == 1

    def note_h2d(self, nbytes: int, seconds: float) -> None:
        if seconds <= 0 or nbytes <= 0:
            return
        bps = nbytes / seconds
        self.h2d_bps = bps if self.h2d_bps <= 0 else (
            0.7 * self.h2d_bps + 0.3 * bps)
        self.h2d_samples += 1

    def stats(self) -> dict:
        """Telemetry snapshot for the ``ec_device`` perf subsystem.
        ``in_flight`` is the number of checked-out slots across every
        shape ring."""
        with self._cv:
            made = sum(self._made.values())
            free = sum(len(v) for v in self._free.values())
            return {"hits": self.hits, "allocs": self.allocs,
                    "stall_allocs": self.stall_allocs,
                    "h2d_bps": self.h2d_bps,
                    "h2d_samples": self.h2d_samples,
                    "shapes": len(self._made),
                    "slots": made,
                    "in_flight": max(0, made - free),
                    "host_bytes": self.host_bytes,
                    "host_bytes_peak": self.host_bytes_peak}

    def set_depth(self, depth: int) -> None:
        """Retarget the per-shape ring depth live (the
        ``ec_tpu_staging_depth`` knob).  Raising it admits more
        allocations on future acquires; lowering it stops further
        growth — slots already made keep cycling."""
        depth = max(1, int(depth))
        with self._cv:
            if depth == self.depth:
                return
            self.depth = depth
            self._cv.notify_all()

    def ensure(self, shape: tuple) -> None:
        """Preallocate a full ring for ``shape`` (prewarm path)."""
        with self._cv:
            free = self._free.setdefault(shape, [])
            self._free.move_to_end(shape)
            while self._made.get(shape, 0) < self.depth:
                free.append(self._new_slot_locked(shape))
            self._evict_locked()


class AsyncBatch:
    """Handle to an in-flight batched apply: the kernel and the
    device->host copy are both enqueued; wait() joins and returns the
    trimmed host array.  On CUDA two events split the join into the
    compute fence and the d2h fence; on the CPU the work is already
    done."""

    def __init__(self, dev_out: torch.Tensor, batch: int, L: int,
                 lead: tuple, ledger: Optional[dict] = None):
        self._batch = batch
        self._L = L
        self._lead = lead
        # fenced h2d link sample from the staging pool, when this batch
        # happened to be the sampled one (batcher EWMA feed)
        self.h2d_bytes = 0
        self.h2d_seconds = 0.0
        # device-phase ledger: absolute stamps, finalized by wait(),
        # keyed by CUDA ordinal (0 on the CPU)
        self.ledger = ledger
        if ledger is not None and "device" not in ledger:
            ledger["device"] = dev_out.device.index or 0
        if dev_out.device.type == "cuda":
            stream = torch.cuda.current_stream(dev_out.device)
            self._compute_ev = torch.cuda.Event()
            self._compute_ev.record(stream)
            self._host = torch.empty(dev_out.shape, dtype=torch.uint8,
                                     pin_memory=True)
            self._host.copy_(dev_out, non_blocking=True)
            self._d2h_ev = torch.cuda.Event()
            self._d2h_ev.record(stream)
        else:
            self._compute_ev = self._d2h_ev = None
            self._host = dev_out

    def wait(self) -> np.ndarray:
        led = self.ledger
        if self._compute_ev is not None:
            self._compute_ev.synchronize()
        if led is not None:
            led["compute_done"] = time.time()
        if self._d2h_ev is not None:
            self._d2h_ev.synchronize()
        if led is not None:
            led["d2h_done"] = time.time()
        out = self._host.numpy()[:self._batch, :, :self._L]
        out = out.reshape(self._lead + out.shape[-2:])
        if led is not None:
            led["deliver"] = time.time()
            led["bytes"] = out.nbytes
        return out


# ---------------------------------------------------------------------------
# backend
# ---------------------------------------------------------------------------

class TorchBackend:
    """Backend for CodecCore on one torch device: CUDA unless the caller
    asks for the CPU."""

    name = "torch"

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._dev_matrices: dict = {}
        self._chain_lru = ChainLRU(256)
        self.staging = StagingPool(pinned=self.device.type == "cuda")

    @property
    def is_cuda(self) -> bool:
        return self.device.type == "cuda"

    # -- knobs ---------------------------------------------------------
    def configure_staging(self, depth: int = 0) -> None:
        """Apply the ``ec_tpu_staging_depth`` knob to the live
        StagingPool; 0 or negative leaves the pool as built."""
        if depth and depth > 0:
            self.staging.set_depth(depth)

    def configure_mesh(self, n_devices: int = 0, sp: int = 0) -> None:
        """Accept the ``ec_tpu_mesh_devices`` / ``ec_tpu_mesh_sp`` knobs.
        One card means no mesh: the single-device path always serves."""

    # no mesh was ever built, so there are no mesh_build events
    mesh_events: tuple = ()

    def mesh_info(self) -> Optional[dict]:
        """The active device mesh as {dp, sp, n_devices, device_ids}, or
        None: one card, no mesh.  The OSD batcher keys its learned
        crossover and link estimate by this shape."""
        return None

    def memory_stats(self) -> dict:
        """Footprint snapshot for the memory-accounting gauges: host
        staging rings, device-resident kernel operands and matrices, and
        operand cache occupancy."""
        dev_bytes = sum(int(m.numel() * m.element_size())
                        for m in list(self._dev_matrices.values()))
        dev_bytes += sum(op.nbytes for op in list(
            self._chain_lru._d.values()))
        st = self.staging.stats()
        return {
            "staging_host_bytes": st["host_bytes"],
            "staging_host_bytes_peak": st["host_bytes_peak"],
            "staging_slots": st["slots"],
            "dev_matrix_bytes": dev_bytes,
            "dev_matrix_entries": (len(self._dev_matrices)
                                   + len(self._chain_lru._d)),
            "compile_cache_entries": len(self._chain_lru._d),
            "compile_cache_cap": self._chain_lru.cap,
        }

    def _device_matrix(self, B: np.ndarray) -> torch.Tensor:
        key = (B.shape, B.tobytes())
        hit = self._dev_matrices.get(key)
        if hit is None:
            hit = torch.from_numpy(np.asarray(B, dtype=np.uint8).copy()
                                   ).to(self.device)
            self._dev_matrices[key] = hit
        return hit

    # -- host <-> device -----------------------------------------------
    def _padded(self, data: np.ndarray, quantum: int, bucket: bool = True):
        """Pad [batch, k, L] to [batch', k, L'], L' a multiple of
        ``quantum`` and batch' the next power of two when ``bucket``
        (zeros are harmless: the code is GF-linear)."""
        batch, k, L = data.shape
        bb = _bucket_batch(batch) if bucket else batch
        Lb = _round_up(L, quantum)
        if bb == batch and Lb == L:
            return data, batch, L
        out = np.zeros((bb, k, Lb), dtype=np.uint8)
        out[:batch, :, :L] = data
        return out, batch, L

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:   # torch wraps only writable arrays
            arr = arr.copy()
        return torch.from_numpy(arr).to(self.device)

    def _run_sync(self, fn, data: np.ndarray, quantum: int,
                  bucket: bool = True) -> np.ndarray:
        """Pad, run ``fn`` on the device copy, and return the trimmed
        host result, keeping any leading batch axes.  Any thread may
        call it (BlueStore's applier does): the work goes on the current
        stream of this backend's device."""
        squeeze = data.ndim == 2
        if squeeze:
            data = data[None]
        lead = data.shape[:-2]
        data = data.reshape((-1,) + data.shape[-2:])
        padded, batch, L = self._padded(data, quantum, bucket)
        with (torch.cuda.device(self.device) if self.is_cuda
              else contextlib.nullcontext()):
            out = fn(self._to_device(padded)).cpu().numpy()[:batch, :, :L]
        out = out.reshape(lead + out.shape[-2:])
        return out[0] if squeeze else out

    def _staged_put(self, data: np.ndarray, quantum: int):
        """Pad [batch, k, L] into a persistent staging slot and start its
        h2d copy.  Returns ``(dev, batch, L, done, sampled, ledger)``; the
        caller MUST invoke ``done()`` right after dispatching the kernel
        on ``dev`` — that records the fence which lets a later batch
        overwrite the slot.  Every Nth staging is fenced and timed for
        the pool's h2d EWMA.  ``ledger`` carries the device-phase stamps
        so far (stage_acquire, h2d_start, h2d_done)."""
        batch, k, L = data.shape
        shape = (_bucket_batch(batch), k, _round_up(L, quantum))
        slot = self.staging.acquire(shape)
        ledger = {"stage_acquire": time.time()}
        try:
            host = slot.array
            host[:batch, :, :L] = data
            if slot.max_l > L:
                # stale columns from a longer previous batch: packet
                # layouts mix columns within a super-word window, so the
                # pad region must stay zero (GF-linear: zeros are inert)
                host[:, :, L:slot.max_l] = 0
            slot.max_l = max(slot.max_l, L)
            if slot.max_b > batch:
                # padding rows past the live batch are zero-stripes
                host[batch:slot.max_b, :, :] = 0
            slot.max_b = max(slot.max_b, batch)
            sample = None
            ledger["h2d_start"] = time.time()
            if self.is_cuda:
                dev = torch.empty(shape, dtype=torch.uint8,
                                  device=self.device)
                if self.staging.should_sample():
                    t0 = time.monotonic()
                    dev.copy_(slot.host, non_blocking=True)
                    torch.cuda.current_stream(self.device).synchronize()
                    dt = time.monotonic() - t0
                    self.staging.note_h2d(slot.host.numel(), dt)
                    sample = (slot.host.numel(), dt)
                else:
                    dev.copy_(slot.host, non_blocking=True)
            else:
                # CPU: the kernel reads the slot directly; it runs to
                # completion before the slot can be handed out again
                dev = slot.host
            ledger["h2d_done"] = time.time()
        except BaseException:
            # staging failed before a fence existed: return the slot
            # unfenced, or the ring leaks a slot per failure
            self.staging.release(shape, slot, None)
            raise

        def done(_shape=shape, _slot=slot):
            fence = None
            if self.is_cuda:
                fence = torch.cuda.Event()
                fence.record(torch.cuda.current_stream(self.device))
            self.staging.release(_shape, _slot, fence)
        return dev, batch, L, done, sample, ledger

    def _dispatch_async(self, fn, data: np.ndarray,
                        quantum: int) -> AsyncBatch:
        squeeze = data.ndim == 2
        if squeeze:
            data = data[None]
        lead = data.shape[:-2] if not squeeze else ()
        data = data.reshape((-1,) + data.shape[-2:])
        # callers dispatch from several threads (the OSD batcher's
        # collector and prewarm): each enqueues its h2d copy, kernel and
        # d2h copy on the current stream of this backend's device
        with (torch.cuda.device(self.device) if self.is_cuda
              else contextlib.nullcontext()):
            dev, batch, L, done, sample, ledger = self._staged_put(
                data, quantum)
            try:
                out = fn(dev)
                ledger["compute_start"] = time.time()
            finally:
                # on success the fence follows the kernel; on failure it
                # follows the h2d copy — either way the slot comes back
                done()
            ab = AsyncBatch(out, batch, L, lead, ledger)
        if sample is not None:
            ab.h2d_bytes, ab.h2d_seconds = sample
        return ab

    @staticmethod
    def quantum(w: int, packetsize: int = 0) -> int:
        """The chunk-length multiple a dispatch pads to: a super-word
        (w packets) for packet-layout codes, else LENGTH_QUANTUM words."""
        if packetsize:
            return w * packetsize
        return LENGTH_QUANTUM * max(1, w // 8)

    def stage(self, data: np.ndarray, w: int, packetsize: int = 0):
        """Pad + transfer a [batch, k, L] host array to the device."""
        padded, batch, L = self._padded(data, self.quantum(w, packetsize))
        dev = self._to_device(padded)
        if self.is_cuda:
            torch.cuda.current_stream(self.device).synchronize()
        return dev, batch, L

    def prewarm_geometry(self, k: int, chunk_size: int,
                         batches=(1,), w: int = 8,
                         packetsize: int = 0) -> None:
        """Preallocate the staging rings a (k, chunk_size) geometry will
        dispatch, so the first client write reuses warm buffers.
        Idempotent and host-side only."""
        Lp = _round_up(chunk_size, self.quantum(w, packetsize))
        for nb in batches:
            self.staging.ensure((_bucket_batch(max(1, int(nb))), k, Lp))

    # -- GF(2^8): kernel B1 --------------------------------------------
    def gf8_fast_path(self) -> bool:
        """Whether w=8 GF-matrix codes route through ``gf8_fn`` (kernel
        B1).  Always true: on CUDA that is the kernel, on the CPU its
        plain version, and neither has a per-matrix compile to amortize."""
        return True

    def gf8_fn(self, rows: np.ndarray):
        """B1 apply for a GF(2^8) row set over [batch, C, L] byte chunks,
        with the device operand LRU-cached per row set — per-pool coding
        matrices AND per-erasure-signature recovery rows."""
        rows = np.asarray(rows, dtype=np.int64)
        key = ("gf8", rows.shape, rows.tobytes())
        operand = self._chain_lru.get_or_build(
            key, lambda: carry_rows(rows, matrix_to_bitmatrix(rows, 8),
                                    self.device))
        return functools.partial(gf8_apply, operand)

    def _bitmatrix_fn(self, B: np.ndarray, w: int):
        """The apply of a bitmatrix over [batch, C, L] byte chunks: at
        w=8 B1 in the blocks of ``split_plan`` (one launch each; the
        operands LRU-cached per bitmatrix), else plain torch ops."""
        if w == 8:
            B = np.asarray(B, dtype=np.uint8)
            key = ("bm8", B.shape, B.tobytes())
            split = self._chain_lru.get_or_build(
                key, lambda: bitmatrix_split(B, B.shape[1] // 8,
                                             self.device))
            return functools.partial(gf8_apply_split, split)
        return functools.partial(_apply_byte_domain_plain,
                                 self._device_matrix(B), w=w)

    def apply_gf8_matrix(self, M: np.ndarray, data: np.ndarray
                         ) -> np.ndarray:
        """Byte-domain w=8 apply of a GF coding matrix (encode)."""
        return self._run_sync(self.gf8_fn(M), data, LENGTH_QUANTUM)

    def apply_gf8_matrix_device(self, M: np.ndarray, dev_data):
        """Device-resident byte-domain apply (codec-kernel boundary)."""
        return self.gf8_fn(M)(dev_data)

    def apply_gf8_rows(self, rows: np.ndarray, data: np.ndarray
                       ) -> np.ndarray:
        """Decode-side twin of apply_gf8_matrix: per-signature rows."""
        return self._run_sync(self.gf8_fn(rows), data, LENGTH_QUANTUM)

    def apply_gf8_matrix_async(self, M: np.ndarray,
                               data: np.ndarray) -> AsyncBatch:
        """Non-blocking apply_gf8_matrix (double-buffering entry)."""
        return self._dispatch_async(self.gf8_fn(M), data, LENGTH_QUANTUM)

    def apply_gf8_rows_async(self, rows: np.ndarray,
                             data: np.ndarray) -> AsyncBatch:
        """Non-blocking apply_gf8_rows — decode groups ride the same
        staging rings, cached operands and device-phase ledger as
        encode."""
        return self._dispatch_async(self.gf8_fn(rows), data,
                                    LENGTH_QUANTUM)

    # -- generic-w bitmatrix -------------------------------------------
    @staticmethod
    def _check_words(data: np.ndarray, w: int) -> int:
        wbytes = max(1, w // 8)
        if data.shape[-1] % wbytes:
            raise ValueError(
                f"chunk length must be a multiple of {wbytes} for w={w}")
        return wbytes

    def apply_bitmatrix_bytes(self, B: np.ndarray, data: np.ndarray,
                              w: int) -> np.ndarray:
        """Byte-domain apply of a GF(2) bitmatrix [R, w*C] over [..., C,
        L] chunks.  At w=8 (B1) the data is staged at its own batch and
        length, unpadded."""
        wbytes = self._check_words(data, w)
        if w == 8:
            return self._run_sync(self._bitmatrix_fn(B, w), data, 1,
                                  bucket=False)
        return self._run_sync(self._bitmatrix_fn(B, w), data,
                              LENGTH_QUANTUM * wbytes)

    def apply_bitmatrix_bytes_async(self, B: np.ndarray, data: np.ndarray,
                                    w: int) -> AsyncBatch:
        """Non-blocking apply_bitmatrix_bytes: enqueues the h2d copy, the
        apply and the d2h copy, returning a handle."""
        wbytes = self._check_words(data, w)
        return self._dispatch_async(self._bitmatrix_fn(B, w), data,
                                    LENGTH_QUANTUM * wbytes)

    def apply_bitmatrix_bytes_device(self, B: np.ndarray, dev_data, w: int):
        """Device-resident apply: input already on the device (padded by
        the caller via stage()); output stays on the device."""
        return self._bitmatrix_fn(B, w)(dev_data)

    # -- packet layout: kernels B2 and B3 ------------------------------
    def _packet_b2_fn(self, B: np.ndarray, w: int, packetsize: int):
        B = np.asarray(B, dtype=np.uint8)
        key = ("pkt", B.shape, B.tobytes(), w)
        operand = self._chain_lru.get_or_build(
            key, lambda: packet_operand(B, w, self.device))
        return functools.partial(packet_apply, operand,
                                 packetsize=packetsize)

    def packet_chain_fn(self, B: np.ndarray, w: int, packetsize: int):
        """[batch, k, L] -> [batch, R/w, L] for a packet-layout bitmatrix,
        with the kernel operand LRU-cached per bitmatrix.  Routed as the
        reference routes it (jax_engine.py:1230-1246): packets that are a
        multiple of B2_PACKET_QUANTUM bytes take kernel B2, every other
        packet size takes kernel B3 on the bitmatrix's XOR schedule.  On
        the CPU each wrapper runs its plain version."""
        if packetsize % B2_PACKET_QUANTUM == 0:
            return self._packet_b2_fn(B, w, packetsize)
        B = np.asarray(B, dtype=np.uint8)
        key = ("sched", B.shape, B.tobytes(), w)
        operand = self._chain_lru.get_or_build(
            key, lambda: schedule_operand(build_xor_schedule(B),
                                          B.shape[1] // w, w, self.device))
        return functools.partial(packet_xor, operand, packetsize=packetsize)

    def apply_packet_xor(self, B: np.ndarray, data: np.ndarray, w: int,
                         packetsize: int) -> np.ndarray:
        """Packet-layout apply for encode (the coding bitmatrix) and
        decode (an erasure signature's rows), through packet_chain_fn."""
        return self._run_sync(self.packet_chain_fn(B, w, packetsize),
                              data, w * packetsize)

    def apply_packet_xor_async(self, B: np.ndarray, data: np.ndarray,
                               w: int, packetsize: int) -> AsyncBatch:
        """Non-blocking apply_packet_xor: packet codes' double-buffering
        entry, on the same staging rings and ledger as the byte codes."""
        return self._dispatch_async(self.packet_chain_fn(B, w, packetsize),
                                    data, w * packetsize)

    def apply_packet_chunks(self, B: np.ndarray, data: np.ndarray, w: int,
                            packetsize: int) -> np.ndarray:
        """Dense packet-layout bitmatrix apply, kernel B2 at any packet
        size (the JAX backend's apply_packet_chunks)."""
        return self._run_sync(self._packet_b2_fn(B, w, packetsize), data,
                              w * packetsize)
