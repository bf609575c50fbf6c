"""CRC32C as a GF(2)-affine map: batched checksum + GF syndrome
partials as ONE bitmatrix matmul per scrub window.

The reflected CRC32C register update is linear over GF(2):

    s' = (s >> 8) ^ tbl[s & 0xFF] ^ tbl[b]        (tbl is GF(2)-linear)

so for a whole message  crc(m) = T^L(I) ^ sum_i T^{L-1-i} E(b_i) ^ F
with I = F = 0xFFFFFFFF (the utils/crc chaining convention).  The
message-dependent middle term — the *linear part* — is a [32, 8L]
GF(2) bitmatrix applied to the message bits, which is exactly the
primitive the codec engine already executes as a batched bitmatrix
apply, kernel B1 on the card (`apply_bitmatrix_bytes`).  Dense
[32, 8L] is intractable for multi-MiB shards, so the map factors
blockwise:

* per BLOCK-byte block, one cached [32, 8*BLOCK] bitmatrix produces the
  block's raw remainder (device op, batched over objects x blocks);
* the tiny [B, nblocks] uint32 partials fold on the host with
  shift-by-2^j lookup tables (log2(nblocks) vectorized numpy steps);
* the affine constant T^L(I) ^ F ("crc of the zero message") comes
  from binary powering of T.

Because a GF(2^8) constant multiply is itself GF(2)-linear on bits,
the same machinery yields *syndrome partials*: the linear CRC of
``gfmul(a, chunk)`` is one more 32-row band of the same window matmul
(scale matrix folded into the block bitmatrix).  XOR-ing those 4-byte
partials across an EC group's shards equals the linear CRC of the GF
syndrome vector — zero iff the stripe is consistent (up to the 2^-32
CRC collision odds) — so deep scrub gets a distributed
whole-code-word check that ships 4 bytes per syndrome row instead of
the chunk bytes (reference deep scrub only self-checks per-shard CRCs,
ECBackend.cc:2475)."""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..utils.crc import crc32c
from .gf import gf

BLOCK = 512                      # bytes per device-matmul block
_INIT = 0xFFFFFFFF               # register init (utils/crc convention)
_FINAL = 0xFFFFFFFF              # final xor


def _crc_table() -> np.ndarray:
    poly = 0x82F63B78
    tbl = np.zeros(256, dtype=np.uint64)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (poly ^ (c >> 1)) if (c & 1) else (c >> 1)
        tbl[i] = c
    return tbl


def _mat_from_cols(cols: np.ndarray) -> "_Mat":
    return _Mat(np.asarray(cols, dtype=np.uint64))


class _Mat:
    """32x32 GF(2) matrix as 32 uint32 column vectors (column j =
    image of basis vector e_j), with vectorized numpy application."""

    __slots__ = ("cols", "_tables")

    def __init__(self, cols: np.ndarray):
        self.cols = cols                 # uint64[32] (low 32 bits used)
        self._tables: Optional[np.ndarray] = None

    def apply_int(self, x: int) -> int:
        v = 0
        for j in range(32):
            if (x >> j) & 1:
                v ^= int(self.cols[j])
        return v

    def matmul(self, other: "_Mat") -> "_Mat":
        out = np.zeros(32, dtype=np.uint64)
        for j in range(32):
            out[j] = self.apply_int(int(other.cols[j]))
        return _Mat(out)

    def tables(self) -> np.ndarray:
        """[4, 256] uint32 byte-lookup tables for vectorized apply."""
        if self._tables is None:
            t = np.zeros((4, 256), dtype=np.uint64)
            for p in range(4):
                base = self.cols[8 * p:8 * p + 8]
                for v in range(256):
                    acc = np.uint64(0)
                    for b in range(8):
                        if (v >> b) & 1:
                            acc ^= base[b]
                    t[p, v] = acc
            self._tables = t.astype(np.uint32)
        return self._tables

    def apply_vec(self, x: np.ndarray) -> np.ndarray:
        """Apply to a uint32 array elementwise."""
        t = self.tables()
        x = x.astype(np.uint32)
        return (t[0][x & 0xFF] ^ t[1][(x >> 8) & 0xFF]
                ^ t[2][(x >> 16) & 0xFF] ^ t[3][(x >> 24) & 0xFF])


class Crc32cLinear:
    """Process-wide factory for the blockwise linear-CRC machinery:
    block bitmatrices (per GF scale), fold tables (per span), and the
    affine zero-message constants.  Thread-safe; everything caches."""

    def __init__(self, block: int = BLOCK):
        self.block = int(block)
        self._lock = threading.Lock()
        tbl = _crc_table()
        # T: shift the register by one zero byte; E: inject one byte
        tcols = np.zeros(32, dtype=np.uint64)
        for j in range(32):
            s = np.uint64(1 << j)
            tcols[j] = (s >> np.uint64(8)) ^ tbl[int(s) & 0xFF]
        self._T = _Mat(tcols)
        self._E = np.array([tbl[1 << b] for b in range(8)],
                           dtype=np.uint64)      # [8] cols of E
        self._pow2: Dict[int, _Mat] = {0: self._T}   # T^(2^j)
        self._block_mats: Dict[Tuple[int, ...], np.ndarray] = {}
        self._w_stack: Optional[np.ndarray] = None
        # windows a backend was given for but the host computed, and the
        # exception that sent the last one there
        self.host_fallbacks = 0
        self.last_error: Optional[BaseException] = None

    # -- matrix powers ------------------------------------------------
    def _t_pow2(self, j: int) -> _Mat:
        with self._lock:
            m = self._pow2.get(j)
            while m is None:
                top = max(self._pow2)
                prev = self._pow2[top]
                self._pow2[top + 1] = prev.matmul(prev)
                m = self._pow2.get(j)
            return m

    def _t_pow_vec(self, n: int, x: int) -> int:
        """T^n applied to one register value (binary powering)."""
        j = 0
        while n:
            if n & 1:
                x = self._t_pow2(j).apply_int(x)
            n >>= 1
            j += 1
        return x

    def zero_crc(self, length: int) -> int:
        """crc32c of ``length`` zero bytes — the affine constant."""
        return self._t_pow_vec(int(length), _INIT) ^ _FINAL

    # -- block bitmatrix ----------------------------------------------
    def _weight_stack(self) -> np.ndarray:
        """W[i] = T^{block-1-i} E as a [block, 8] uint32 array: the
        per-byte-position contribution maps inside one block."""
        if self._w_stack is None:
            w = np.zeros((self.block, 8), dtype=np.uint64)
            cur = self._E.copy()
            for i in range(self.block - 1, -1, -1):
                w[i] = cur
                if i:
                    for b in range(8):
                        cur[b] = self._T.apply_int(int(cur[b]))
            self._w_stack = w
        return self._w_stack

    def block_bitmatrix(self, scales: Sequence[int] = (1,)
                        ) -> np.ndarray:
        """[32*len(scales), 8*block] uint8 bitmatrix: band s computes
        the linear CRC of ``gfmul(scales[s], block_bytes)``.  Column
        layout matches the engine's byte-domain w=8 contraction (byte
        position major, bit LSB-first); row r of a band is bit r of
        the partial, so the 4 output bytes are the partial
        little-endian."""
        key = tuple(int(s) for s in scales)
        with self._lock:
            hit = self._block_mats.get(key)
        if hit is not None:
            return hit
        W = self._weight_stack()                  # [block, 8] uint64
        f = gf(8)
        bands = []
        for a in key:
            if a == 1:
                Wa = W
            else:
                # fold the GF(2^8) scale into the byte-injection map:
                # col b of the scaled block matrix is the XOR of W's
                # cols at the set bits of gfmul(a, 1<<b)
                Wa = np.zeros_like(W)
                for b in range(8):
                    prod = int(f.mul(a, 1 << b)) if a else 0
                    for j in range(8):
                        if (prod >> j) & 1:
                            Wa[:, b] ^= W[:, j]
            # bits: [block, 8 in-bits, 32 out-bits] -> [32, block*8]
            bits = ((Wa[:, :, None] >> np.arange(32, dtype=np.uint64))
                    & np.uint64(1)).astype(np.uint8)
            bands.append(np.ascontiguousarray(
                bits.transpose(2, 0, 1).reshape(32, -1)))
        B = np.concatenate(bands, axis=0)
        with self._lock:
            self._block_mats[key] = B
        return B

    # -- host fold ----------------------------------------------------
    def fold_partials(self, partials: np.ndarray) -> np.ndarray:
        """[B, nblk] uint32 per-block raw remainders (block 0 first)
        -> [B] uint32 linear CRC of the concatenation.  Pure linear —
        no init/final convention — so XOR across EC shards of folded
        syndrome partials stays meaningful."""
        p = np.asarray(partials, dtype=np.uint32)
        if p.ndim == 1:
            p = p[None]
        nblk = p.shape[1]
        # leading zero blocks are inert (shift of 0 is 0): pad the
        # FRONT to a power of two so the fold is a balanced tree
        n2 = 1 if nblk <= 1 else 1 << (nblk - 1).bit_length()
        if n2 != nblk:
            p = np.concatenate(
                [np.zeros((p.shape[0], n2 - nblk), dtype=np.uint32),
                 p], axis=1)
        span = self.block                 # bytes covered by the RIGHT
        while p.shape[1] > 1:
            left, right = p[:, 0::2], p[:, 1::2]
            # T^span (T already steps one byte) via lookup tables
            j = 0
            n = span
            shifted = left
            while n:
                if n & 1:
                    shifted = self._t_pow2(j).apply_vec(shifted)
                n >>= 1
                j += 1
            p = shifted ^ right
            span *= 2
        return p[:, 0]

    # -- whole-message entry points ------------------------------------
    def stack_blocks(self, stack: np.ndarray) -> np.ndarray:
        """[B, L] uint8 -> [B, block, nblk] layout for the engine's
        byte-domain apply (byte position = chunk axis, block index =
        lane axis), front-padded to a block multiple (leading zeros
        are inert for the linear part)."""
        stack = np.asarray(stack, dtype=np.uint8)
        Bn, L = stack.shape
        pad = (-L) % self.block
        if pad:
            stack = np.concatenate(
                [np.zeros((Bn, pad), dtype=np.uint8), stack], axis=1)
        nblk = stack.shape[1] // self.block
        return np.ascontiguousarray(
            stack.reshape(Bn, nblk, self.block).transpose(0, 2, 1))

    def partials_from_apply(self, out: np.ndarray,
                            nbands: int = 1) -> np.ndarray:
        """Engine apply output [B, 4*nbands, nblk] uint8 ->
        [nbands, B, nblk] uint32 partials."""
        Bn, rows, nblk = out.shape
        le = np.ascontiguousarray(
            out.reshape(Bn, nbands, 4, nblk).transpose(1, 0, 3, 2))
        return le.reshape(nbands, Bn, nblk * 4).view("<u4").reshape(
            nbands, Bn, nblk)

    def _apply_window(self, stack: np.ndarray, scales: Sequence[int],
                      backend=None, strict: bool = False) -> np.ndarray:
        """[B, L] uint8 window -> [nbands, B] folded LINEAR partials.
        One bitmatrix apply for the whole window (device when a codec
        backend is supplied — same byte-domain contraction as the EC
        kernels — else a host matmul).  A backend that raises costs no
        checksum: the host computes the window, and ``host_fallbacks``
        and ``last_error`` record it.  With ``strict`` the exception
        propagates instead, for a caller that counts its own
        fallback (the ECBackend's deep scrub)."""
        stack = np.asarray(stack, dtype=np.uint8)
        Bn = stack.shape[0]
        x = self.stack_blocks(stack)                 # [B, block, nblk]
        M = self.block_bitmatrix(tuple(scales))
        out = None
        if backend is not None:
            try:
                out = np.asarray(
                    backend.apply_bitmatrix_bytes(M, x, 8))
            except Exception as e:
                if strict:
                    raise
                with self._lock:
                    self.host_fallbacks += 1
                    self.last_error = e
        if out is None:
            from .engine import bytes_to_bitplanes
            bits = bytes_to_bitplanes(x, 8)
            ob = (M.astype(np.int64) @ bits.astype(np.int64)) & 1
            w8 = (np.uint32(1) << np.arange(8, dtype=np.uint32))
            out = (ob.reshape(Bn, 4 * len(scales), 8, -1)
                   .astype(np.uint32)
                   * w8[None, None, :, None]).sum(axis=2)
        parts = self.partials_from_apply(
            np.asarray(out, dtype=np.uint8), nbands=len(scales))
        return np.stack([self.fold_partials(parts[s])
                         for s in range(len(scales))], axis=0)

    def crc_batch(self, chunks: Sequence, backend=None,
                  strict: bool = False) -> np.ndarray:
        """Batch crc32c (full init/final convention) over a window of
        byte strings in one apply; rows are front-padded to a common
        length (leading zeros are inert for the linear part, and the
        affine constant uses each row's true length)."""
        lens = [len(c) for c in chunks]
        Lmax = max(lens) if lens else 0
        stack = np.zeros((len(chunks), Lmax), dtype=np.uint8)
        for i, c in enumerate(chunks):
            if lens[i]:
                stack[i, Lmax - lens[i]:] = np.frombuffer(
                    bytes(c), dtype=np.uint8)
        lin = self._apply_window(stack, (1,), backend=backend,
                                 strict=strict)[0]
        zero = np.array([self.zero_crc(n) for n in lens],
                        dtype=np.uint32)
        return lin ^ zero

    def crc_batch_host(self, stack: np.ndarray) -> np.ndarray:
        """Pure-numpy reference: [B, L] -> [B] uint32 crc32c (full
        convention).  The device path runs the same block matmul
        through the codec backend; this is the oracle and the
        no-backend fallback."""
        from .engine import bytes_to_bitplanes
        Bn, L = np.asarray(stack, dtype=np.uint8).shape
        x = self.stack_blocks(stack)
        bits = bytes_to_bitplanes(x, 8)              # [B, blk*8, nblk]
        M = self.block_bitmatrix((1,)).astype(np.int64)
        ob = (M @ bits.astype(np.int64)) & 1         # [B, 32, nblk]
        weights = (np.uint32(1) << np.arange(8, dtype=np.uint32))
        by = (ob.reshape(Bn, 4, 8, -1).astype(np.uint32)
              * weights[None, None, :, None]).sum(axis=2)
        lin = self.fold_partials(
            self.partials_from_apply(by.astype(np.uint8))[0])
        return lin ^ np.uint32(self.zero_crc(L))


_SHARED: Optional[Crc32cLinear] = None
_SHARED_LOCK = threading.Lock()


def shared() -> Crc32cLinear:
    with _SHARED_LOCK:
        global _SHARED
        if _SHARED is None:
            _SHARED = Crc32cLinear()
        return _SHARED


def self_test() -> bool:
    """One-shot bit-exactness probe against utils/crc.crc32c."""
    try:
        lin = shared()
        rng = np.random.default_rng(11)
        for L in (1, 7, BLOCK, BLOCK + 13, 3 * BLOCK + 257):
            x = rng.integers(0, 256, (2, L), dtype=np.uint8)
            got = lin.crc_batch_host(x)
            for i in range(2):
                if int(got[i]) != crc32c(x[i].tobytes()):
                    return False
        return True
    except Exception:
        return False
