"""The flagship `gpu` erasure-code plugin, twin of the JAX package's `tpu`.

Registers alongside the CPU plugins in the same registry: a profile of
``plugin=gpu technique=reed_sol_van k=8 m=4`` yields a codec whose
encode_chunks/decode_chunks run as batched GF(2^8) bitmatrix applies on
the card through kernel B1 (ops/torch_engine.py, ops/gf8_kernel.py),
bit-exact with the CPU `jerasure` plugin because both build identical
coding matrices.

The profile key ``device`` picks the torch device, ``cuda`` by default;
without a card the codec raises unless the profile says ``device=cpu``,
which runs the plain PyTorch versions (the tests do).  All seven
jerasure-compatible techniques are registered and run on the card.
reed_sol_van and reed_sol_r6_op ride B1; the five packet techniques
(cauchy_orig, cauchy_good, liberation, blaum_roth, liber8tion) ride
kernel B2 (ops/packet_kernel.py) when the packet size is a multiple of
128 bytes and kernel B3 (ops/packet_xor_kernel.py) otherwise, for
encode, decode and the re-encode of erased parity.

Beyond the reference's synchronous per-stripe API, this plugin exposes
the batched entry points the OSD write pipeline uses to amortize
host->device transfers across the PG queue (SURVEY.md section 3.1
"batching point"):

    encode_batch(data[B, k, L])  -> parity[B, m, L]
    decode_batch(present {id: [B, L]}, chunk_len) -> {id: [B, L]}
"""
from __future__ import annotations

import threading
from typing import Dict, Mapping

import numpy as np

from ...ops.torch_engine import TorchBackend, resolve_device
from ..interface import ErasureCodeProfile, ErasureCodeValidationError
from ..registry import ErasureCodePlugin
from . import jerasure as jr

_SHARED_BACKENDS: Dict[str, TorchBackend] = {}
_SHARED_LOCK = threading.Lock()

# (device, geometry, batch-shape) keys already staged and run by the
# prewarm calls — PG activation calls them per PG, the work is
# per-process
_PREWARMED_SHAPES: set = set()


def shared_backend(device="cuda") -> TorchBackend:
    """One backend per process and device, so cached kernel operands and
    staging rings are shared across codec instances (each PG constructs
    its own codec, reference osd/PGBackend.cc:555-591)."""
    key = str(resolve_device(device))
    with _SHARED_LOCK:
        be = _SHARED_BACKENDS.get(key)
        if be is None:
            be = _SHARED_BACKENDS[key] = TorchBackend(key)
        return be


class _DecodeHandle:
    """AsyncBatch wrapper for a decode group: ``wait()`` splits the
    combined-recovery-row output [B, E, L] back into per-erased-chunk
    arrays.  Exposes the underlying seven-phase DeviceLedger and h2d
    sample so the OSD batcher folds decode groups into the same
    waterfall/crossover machinery as encode groups."""

    __slots__ = ("_ab", "_erased")

    def __init__(self, ab, erased):
        self._ab = ab
        self._erased = tuple(erased)

    @property
    def ledger(self):
        return getattr(self._ab, "ledger", None)

    @property
    def ledgers(self):
        """Per-device ledger clones of a mesh-sharded dispatch (one lane
        a logical device), None on a single device — AsyncBatch.ledgers."""
        return getattr(self._ab, "ledgers", None)

    @property
    def h2d_bytes(self):
        return getattr(self._ab, "h2d_bytes", 0)

    @property
    def h2d_seconds(self):
        return getattr(self._ab, "h2d_seconds", 0.0)

    def wait(self) -> Dict[int, np.ndarray]:
        out = self._ab.wait()
        return {e: out[..., i, :] for i, e in enumerate(self._erased)}


class GpuCodecMixin:
    """Overrides the backend and adds the batched API."""

    device = "cuda"

    def parse(self, profile: ErasureCodeProfile) -> None:
        self.device = self.to_string("device", profile, "cuda")
        super().parse(profile)

    def make_backend(self):
        return shared_backend(self.device)

    # -- batched entry points (the device value-add) ----------------------
    def encode_batch(self, data: np.ndarray) -> np.ndarray:
        """uint8 [B, k, L] -> parity uint8 [B, m, L]; one device call for
        the whole stripe batch."""
        data = np.asarray(data, dtype=np.uint8)
        if data.ndim != 3 or data.shape[1] != self.k:
            raise ValueError(f"expected [batch, k={self.k}, L] input")
        return self.core.encode_batch(data)

    def decode_batch(self, present: Mapping[int, np.ndarray],
                     chunk_len: int) -> Dict[int, np.ndarray]:
        """Reconstruct all missing chunk ids for a batch: present maps
        chunk id -> uint8 [B, L]."""
        arrays = {i: np.asarray(c, dtype=np.uint8)
                  for i, c in present.items()}
        return self.core.decode_chunks(arrays, chunk_len)

    def encode_batch_async(self, data: np.ndarray):
        """Non-blocking encode_batch: returns an AsyncBatch whose wait()
        yields parity [B, m, L].  Submitting the next batch before
        waiting keeps the card busy while the host fills the next
        staging slot — the OSD write pipeline's double-buffering entry
        point."""
        data = np.asarray(data, dtype=np.uint8)
        if data.ndim != 3 or data.shape[1] != self.k:
            raise ValueError(f"expected [batch, k={self.k}, L] input")
        core = self.core
        if core.gf8_encode_fast():
            return core.backend.apply_gf8_matrix_async(
                core.coding_matrix, data)
        if core.layout == "packet":
            # packets XOR whole, per super-word: the byte-domain apply
            # below would give other parity than encode_batch
            return core.backend.apply_packet_xor_async(
                core.bitmatrix, data, core.w, core.packetsize)
        return core.backend.apply_bitmatrix_bytes_async(
            core.bitmatrix, data, self.w)

    def decode_async_supported(self) -> bool:
        """True when this geometry can ride the async device decode
        pipeline (combined recovery rows need a GF coding matrix;
        the async staging path is byte-domain w=8)."""
        core = self.core
        return (core.layout == "byte" and core.w == 8
                and core.coding_matrix is not None)

    def decode_batch_async(self, present: Mapping[int, np.ndarray],
                           chunk_len: int) -> _DecodeHandle:
        """Non-blocking decode_batch: one staged device dispatch
        reconstructs EVERY missing chunk id for the batch.  The
        per-erasure-signature combined recovery rows (CodecCore
        `_recovery_rows` — inverse map for data erasures, encode row
        composed through it for parity erasures) make reconstruction a
        single matmul, so decode groups pipeline through the same
        StagingPool rings and inflight-group machinery as encode —
        the decode twin of encode_batch_async."""
        if not self.decode_async_supported():
            raise ValueError("async device decode needs a byte-domain "
                             "w=8 GF coding matrix")
        core = self.core
        n = self.k + self.m
        avail = sorted(i for i in present if i < n)
        if len(avail) < self.k:
            raise ValueError(
                f"need {self.k} chunks, have {len(avail)}")
        erased = tuple(i for i in range(n) if i not in present)
        chosen = tuple(avail[:self.k])
        rows_gf, _ = core._recovery_rows(chosen, erased)
        stack = np.stack(
            [np.asarray(present[i], dtype=np.uint8)
             .reshape(-1, int(chunk_len)) for i in chosen], axis=1)
        return _DecodeHandle(
            core.backend.apply_gf8_rows_async(rows_gf, stack), erased)

    def delta_async_supported(self) -> bool:
        """True when this geometry can ride the async device
        parity-delta pipeline (same gate as device decode: byte-domain
        w=8 with a GF coding matrix in hand)."""
        return self.decode_async_supported()

    def delta_encode_batch_async(self, delta: np.ndarray, dirty_cols):
        """Non-blocking parity delta: Δdata uint8 [B, D, L] for the
        D dirty data columns -> AsyncBatch whose wait() yields
        Δparity uint8 [B, m, L] (new_parity = old_parity XOR Δparity,
        applied shard-side via the store's xor_write op).

        The dirty columns are scattered into a zero [B, k, L] block
        and dispatched with the SAME per-pool operand as
        encode_batch_async — GF linearity makes the zero columns
        inert, so M·pad(Δ) == M[:, dirty]·Δ bit for bit — so a delta
        shares encode's staging rings, cached operand and ledger."""
        if not self.delta_async_supported():
            raise ValueError("async device delta needs a byte-domain "
                             "w=8 GF coding matrix")
        core = self.core
        cols = [int(c) for c in dirty_cols]
        delta = np.asarray(delta, dtype=np.uint8)
        if delta.ndim != 3 or delta.shape[1] != len(cols):
            raise ValueError(
                f"expected [batch, D={len(cols)}, L] delta input")
        block = np.zeros((delta.shape[0], self.k, delta.shape[2]),
                         dtype=np.uint8)
        block[:, cols, :] = delta
        return core.backend.apply_gf8_matrix_async(
            core.coding_matrix, block)

    def delta_encode_batch(self, delta: np.ndarray,
                           dirty_cols) -> np.ndarray:
        """Synchronous parity delta (the CPU-twin / oracle route):
        Δdata [B, D, L] -> Δparity [B, m, L] via CodecCore."""
        return self.core.delta_parity(
            np.asarray(delta, dtype=np.uint8), dirty_cols)

    def prewarm_delta(self, chunk_size: int, dirty_cols=None,
                      batches=(1,)) -> None:
        """Make the delta lane hot before the first sub-stripe
        overwrite.  Delta dispatches ride the per-pool encode operand
        (dirty columns zero-padded to [B, k, L]), so there is nothing
        per signature to warm — just the staging ring and the pool
        operand at the encode shape.  Idempotent per
        (geometry, chunk_size); ``dirty_cols`` is accepted for API
        compatibility but no longer selects an executable."""
        if not self.delta_async_supported():
            return
        pre = getattr(self.core.backend, "prewarm_geometry", None)
        if pre is not None:
            pre(self.k, chunk_size, batches=batches, w=self.w)
        key = ("delta", self.device, type(self).__name__, self.k, self.m,
               self.w, int(chunk_size))
        if key in _PREWARMED_SHAPES:
            return
        _PREWARMED_SHAPES.add(key)
        z = np.zeros((1, 1, int(chunk_size)), dtype=np.uint8)
        try:
            self.delta_encode_batch_async(z, (0,)).wait()
        except Exception:
            _PREWARMED_SHAPES.discard(key)  # best-effort

    def prewarm_decode(self, chunk_size: int, batches=(1,)) -> None:
        """Make the common recovery signatures hot before the first
        rebuild window: host-side combined recovery rows for every
        single-erasure signature, the staging ring for the window
        shape, and one decode run through the kernel.  Idempotent per
        (geometry, chunk_size)."""
        if not self.decode_async_supported():
            return
        core = self.core
        n = self.k + self.m
        try:
            for e in range(n):
                chosen = tuple(i for i in range(n) if i != e)[:self.k]
                core._recovery_rows(chosen, (e,))
        except Exception:
            return
        pre = getattr(core.backend, "prewarm_geometry", None)
        if pre is not None:
            pre(self.k, chunk_size, batches=batches, w=self.w)
        key = ("dec", self.device, type(self).__name__, self.k, self.m,
               self.w, int(chunk_size))
        if key in _PREWARMED_SHAPES:
            return
        _PREWARMED_SHAPES.add(key)
        z = {i: np.zeros((1, int(chunk_size)), dtype=np.uint8)
             for i in range(n) if i != 0}
        try:
            self.decode_batch_async(z, int(chunk_size)).wait()
        except Exception:
            _PREWARMED_SHAPES.discard(key)  # best-effort

    def prewarm_geometry(self, chunk_size: int,
                         batches=(1,)) -> None:
        """Make this pool geometry hot before the first client write:
        preallocate the persistent staging rings for the batch shapes
        the OSD coalescer dispatches (torch_engine StagingPool), build
        the kernel and the pool operand by running one zero batch per
        shape through the real async path.  Idempotent per
        (geometry, shape) process-wide; synchronous — callers (PG
        activation) run it on a background thread."""
        backend = self.core.backend
        pre = getattr(backend, "prewarm_geometry", None)
        if pre is not None:
            pre(self.k, chunk_size, batches=batches, w=self.w,
                packetsize=self.core.packetsize)
        for nb in batches:
            key = (self.device, type(self).__name__, self.k, self.m,
                   self.w, int(chunk_size), int(nb))
            if key in _PREWARMED_SHAPES:
                continue
            _PREWARMED_SHAPES.add(key)
            z = np.zeros((max(1, int(nb)), self.k, int(chunk_size)),
                         dtype=np.uint8)
            try:
                self.encode_batch_async(z).wait()
            except Exception:
                _PREWARMED_SHAPES.discard(key)  # best-effort

    def stage_batch(self, data: np.ndarray):
        """Transfer a stripe batch to device memory ahead of encode."""
        data = np.asarray(data, dtype=np.uint8)
        return self.core.backend.stage(data, self.w, self.core.packetsize)

    def encode_batch_device(self, dev_data):
        """Device-resident encode: device array in, device array out (no
        host round trip) — the codec-kernel boundary.  w=8 byte-domain
        codes ride kernel B1 (torch_engine gf8_fn), packet codes B2 or
        B3 (packet_chain_fn), others the plain bit-plane path."""
        core = self.core
        if core.layout == "byte" and core.w == 8 \
                and core.coding_matrix is not None:
            return core.backend.apply_gf8_matrix_device(
                core.coding_matrix, dev_data)
        if core.layout == "packet":
            return core.backend.packet_chain_fn(
                core.bitmatrix, core.w, core.packetsize)(dev_data)
        return core.backend.apply_bitmatrix_bytes_device(
            core.bitmatrix, dev_data, self.w)

    def decode_batch_device(self, dev_stack, chosen, data_erased):
        """Device-resident per-erasure-signature decode: reconstruct
        ``data_erased`` chunk ids from the staged ``chosen`` chunk
        stack [B, k, L] (device tensor in/out).  Uses the same
        signature-cached operands the OSD recovery path does
        (torch_engine gf8_fn / packet_chain_fn, so B1, B2 or B3 — the
        analog of ISA-L's decode-table LRU, reference
        isa/ErasureCodeIsaTableCache.cc:253-306)."""
        core = self.core
        rows_gf, rows_bits = core._decode_rows(tuple(chosen),
                                               tuple(data_erased))
        if core.layout == "byte" and core.w == 8 and rows_gf is not None:
            return core.backend.gf8_fn(rows_gf)(dev_stack)
        if core.layout == "packet":
            return core.backend.packet_chain_fn(
                rows_bits, core.w, core.packetsize)(dev_stack)
        return core.backend.apply_bitmatrix_bytes_device(
            rows_bits, dev_stack, core.w)


class GpuReedSolomonVandermonde(GpuCodecMixin, jr.ReedSolomonVandermonde):
    DEFAULT_K, DEFAULT_M, DEFAULT_W = "8", "4", "8"  # north-star config


class GpuReedSolomonRAID6(GpuCodecMixin, jr.ReedSolomonRAID6):
    pass


class GpuCauchyOrig(GpuCodecMixin, jr.CauchyOrig):
    pass


class GpuCauchyGood(GpuCodecMixin, jr.CauchyGood):
    pass


class GpuLiberation(GpuCodecMixin, jr.Liberation):
    pass


class GpuBlaumRoth(GpuCodecMixin, jr.BlaumRoth):
    pass


class GpuLiber8tion(GpuCodecMixin, jr.Liber8tion):
    pass


TECHNIQUES = {
    "reed_sol_van": GpuReedSolomonVandermonde,
    "reed_sol_r6_op": GpuReedSolomonRAID6,
    "cauchy_orig": GpuCauchyOrig,
    "cauchy_good": GpuCauchyGood,
    "liberation": GpuLiberation,
    "blaum_roth": GpuBlaumRoth,
    "liber8tion": GpuLiber8tion,
}


class ErasureCodePluginGpu(ErasureCodePlugin):
    def factory(self, profile: ErasureCodeProfile):
        technique = profile.get("technique", "reed_sol_van")
        cls = TECHNIQUES.get(technique)
        if cls is None:
            raise ErasureCodeValidationError(
                f"technique={technique} is not a valid coding technique")
        codec = cls()
        codec.init(profile)
        return codec


def __erasure_code_init__(registry) -> None:
    registry.add("gpu", ErasureCodePluginGpu())
