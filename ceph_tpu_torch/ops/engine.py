"""Codec execution core: run a GF(2^w) matrix / GF(2) bitmatrix erasure
code over byte buffers, batched, with pluggable backends.

Two data layouts, matching the reference's two kernel families:

* ``byte`` — each chunk is a stream of GF(2^w) words (w/8 bytes each,
  little-endian); the code is a true GF(2^w) matrix multiply per word.
  This is jerasure_matrix_encode semantics (reed_sol_van / reed_sol_r6;
  reference ErasureCodeJerasure.cc:162).
* ``packet`` — each chunk is a sequence of super-words of w *packets* of
  ``packetsize`` bytes; the code XORs whole packets per a GF(2)
  bitmatrix.  This is jerasure_schedule_encode semantics (cauchy /
  liberation family; reference ErasureCodeJerasure.cc:265).

Both layouts reduce to one primitive — a 0/1 matrix applied over GF(2) to
a stack of bit-rows — which the torch engine (ops/torch_engine.py)
executes on the card through kernel B1 for the byte layout and kernels
B2/B3 for the packet layout.  The numpy backend here is the bit-exact CPU
reference oracle.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .gf import gf
from .matrix import (bitmatrix_invert, make_decoding_matrix,
                     matrix_to_bitmatrix)


# ---------------------------------------------------------------------------
# byte-domain word helpers
# ---------------------------------------------------------------------------

def _as_words(data: np.ndarray, w: int) -> np.ndarray:
    """uint8[..., L] -> little-endian uint{w}[..., L/(w//8)] view-copy."""
    if w == 8:
        return data
    wb = w // 8
    dt = {16: np.uint16, 32: np.uint32}[w]
    if data.shape[-1] % wb:
        raise ValueError(f"chunk length must be a multiple of {wb} for w={w}")
    return np.ascontiguousarray(data).view(dt)


def _as_bytes(words: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(words).view(np.uint8)


def region_mul_xor(c: int, src: np.ndarray, dst: np.ndarray, w: int) -> None:
    """dst ^= c * src over GF(2^w) word regions (numpy arrays of uint{w})."""
    f = gf(w)
    if c == 0:
        return
    if c == 1:
        np.bitwise_xor(dst, src, out=dst)
        return
    if w == 8:
        np.bitwise_xor(dst, f._mul_row(c)[src], out=dst)
    elif w == 16:
        s = src.astype(np.int64)
        prod = f.exp_tbl[f.log_tbl[s] + f.log_tbl[c]]
        prod = np.where(s == 0, 0, prod).astype(np.uint16)
        np.bitwise_xor(dst, prod, out=dst)
    else:  # w == 32: vectorized shift-xor with constant multiplier
        acc = np.zeros_like(src)
        cur = src.astype(np.uint64)
        poly = np.uint64(f.poly & 0xFFFFFFFF)
        top = np.uint64(1 << 32)
        for b in range(32):
            if (c >> b) & 1:
                acc ^= cur.astype(np.uint32)
            cur <<= np.uint64(1)
            hi = (cur & top).astype(bool)
            cur = (cur & np.uint64(0xFFFFFFFF)) ^ np.where(hi, poly, 0).astype(np.uint64)
        np.bitwise_xor(dst, acc, out=dst)


# ---------------------------------------------------------------------------
# bit-plane layout helpers (shared contract with the torch engine)
# ---------------------------------------------------------------------------

def bytes_to_bitplanes(data: np.ndarray, w: int) -> np.ndarray:
    """byte layout: uint8[..., k, L] -> uint8 bits [..., k*w, L*8//w].

    Word bits become the contraction axis: row j*w + b holds bit b of each
    GF word of chunk j."""
    words = _as_words(data, w)  # [..., k, Lw]
    shifts = np.arange(w, dtype=words.dtype if w < 32 else np.uint32)
    bits = (words[..., None] >> shifts) & 1  # [..., k, Lw, w]
    bits = np.moveaxis(bits, -1, -2)  # [..., k, w, Lw]
    s = bits.shape
    return bits.reshape(s[:-3] + (s[-3] * w, s[-1])).astype(np.uint8)


def bitplanes_to_bytes(bits: np.ndarray, w: int) -> np.ndarray:
    """Inverse of bytes_to_bitplanes: [..., m*w, Lw] -> uint8[..., m, L]."""
    s = bits.shape
    m = s[-2] // w
    bits = bits.reshape(s[:-2] + (m, w, s[-1]))
    dt = {8: np.uint8, 16: np.uint16, 32: np.uint32}[w]
    weights = (np.uint64(1) << np.arange(w, dtype=np.uint64))
    words = (bits.astype(np.uint64) *
             weights[None, :, None]).sum(axis=-2).astype(dt)
    out = _as_bytes(words)
    return out.reshape(s[:-2] + (m, -1))


def bytes_to_packets(data: np.ndarray, w: int, packetsize: int) -> np.ndarray:
    """packet layout: uint8[..., k, L] -> uint8[..., nw, k*w, packetsize]
    where L = nw * w * packetsize."""
    *lead, k, L = data.shape
    sw = w * packetsize
    if L % sw:
        raise ValueError(f"chunk length {L} not a multiple of w*packetsize={sw}")
    nw = L // sw
    x = data.reshape(*lead, k, nw, w, packetsize)
    x = np.moveaxis(x, -4, -3)  # [..., nw, k, w, ps]
    return x.reshape(*lead, nw, k * w, packetsize)


def packets_to_bytes(pk: np.ndarray, w: int, packetsize: int) -> np.ndarray:
    *lead, nw, mw, ps = pk.shape
    m = mw // w
    x = pk.reshape(*lead, nw, m, w, ps)
    x = np.moveaxis(x, -4, -3)  # [..., m, nw, w, ps]
    return x.reshape(*lead, m, nw * w * ps)


# ---------------------------------------------------------------------------
# numpy backend
# ---------------------------------------------------------------------------

class NumpyBackend:
    """Bit-exact CPU reference backend."""

    name = "numpy"
    supported_widths = None  # None = all widths

    def apply_matrix(self, M: np.ndarray, data: np.ndarray, w: int
                     ) -> np.ndarray:
        """byte layout: out[..., i, :] = XOR_j M[i,j]*data[..., j, :]."""
        rows, k = M.shape
        words = _as_words(data, w)
        out = np.zeros(words.shape[:-2] + (rows,) + words.shape[-1:],
                       dtype=words.dtype)
        for i in range(rows):
            for j in range(k):
                region_mul_xor(int(M[i, j]), words[..., j, :],
                               out[..., i, :], w)
        ob = _as_bytes(out)
        return ob.reshape(out.shape[:-1] + (-1,))

    def apply_bitmatrix_packets(self, B: np.ndarray, pk: np.ndarray
                                ) -> np.ndarray:
        """packet layout: XOR packets per B [R, C] over pk [..., nw, C, ps]."""
        R = B.shape[0]
        out = np.zeros(pk.shape[:-2] + (R,) + pk.shape[-1:], dtype=np.uint8)
        Bb = B.astype(bool)
        for r in range(R):
            sel = pk[..., Bb[r], :]
            if sel.shape[-2]:
                out[..., r, :] = np.bitwise_xor.reduce(sel, axis=-2)
        return out


# ---------------------------------------------------------------------------
# codec core
# ---------------------------------------------------------------------------

class CodecCore:
    """Executes one erasure code: k data + m coding chunks, either from a
    GF(2^w) coding matrix (layout 'byte') or a GF(2) bitmatrix (layout
    'packet'), single-shot or batched, with decode-matrix caching per
    erasure signature (the moral equivalent of ISA-L's table cache,
    reference src/erasure-code/isa/ErasureCodeIsaTableCache.cc)."""

    def __init__(self, k: int, m: int, w: int,
                 coding_matrix: Optional[np.ndarray] = None,
                 bitmatrix: Optional[np.ndarray] = None,
                 layout: str = "byte",
                 packetsize: int = 0,
                 backend=None):
        if layout not in ("byte", "packet"):
            raise ValueError(f"unknown layout {layout}")
        if layout == "packet" and packetsize <= 0:
            raise ValueError("packet layout requires packetsize > 0")
        self.k, self.m, self.w = k, m, w
        self.layout = layout
        self.packetsize = packetsize
        self.backend = backend or NumpyBackend()
        self.coding_matrix = None if coding_matrix is None \
            else np.asarray(coding_matrix, dtype=np.int64)
        if bitmatrix is None:
            if self.coding_matrix is None:
                raise ValueError("need coding_matrix or bitmatrix")
            bitmatrix = matrix_to_bitmatrix(self.coding_matrix, w)
        self.bitmatrix = np.asarray(bitmatrix, dtype=np.uint8)
        self._decode_cache: dict = {}

    def gf8_encode_fast(self) -> bool:
        """Single source of truth for the w=8 XOR-chain eligibility:
        byte-domain, a GF coding matrix in hand, and a backend whose
        platform makes per-matrix static compilation worthwhile."""
        return (self.layout == "byte" and self.w == 8
                and self.coding_matrix is not None
                and hasattr(self.backend, "apply_gf8_matrix")
                and self.backend.gf8_fast_path())

    def gf8_decode_fast(self) -> bool:
        """Decode twin of gf8_encode_fast: inverse rows vary per erasure
        signature, but the signature set is tiny (C(k+m, <=m)) and a
        rebuild hammers one signature, so per-signature compiled chains
        behind the backend's ChainLRU beat the runtime-argument
        bit-plane path (VERDICT r2: that gap was 64x)."""
        return (self.layout == "byte" and self.w == 8
                and self.coding_matrix is not None
                and hasattr(self.backend, "apply_gf8_rows")
                and self.backend.gf8_fast_path())

    def packet_static_fast(self) -> bool:
        """Packet-layout analog: static XOR schedules (smart-scheduling
        style) compiled per bitmatrix, for encode and decode."""
        return (self.layout == "packet"
                and hasattr(self.backend, "apply_packet_xor")
                and self.backend.gf8_fast_path())

    # -- encode -----------------------------------------------------------
    def encode_batch(self, data: np.ndarray) -> np.ndarray:
        """data uint8 [..., k, L] -> parity uint8 [..., m, L]."""
        if data.shape[-2] != self.k:
            raise ValueError(f"expected {self.k} data chunks")
        if data.shape[-1] == 0:      # empty object: parity is empty too
            return np.zeros(data.shape[:-2] + (self.m, 0),
                            dtype=np.uint8)
        if self.gf8_encode_fast():
            return self.backend.apply_gf8_matrix(self.coding_matrix,
                                                 data)
        return self._apply(self.bitmatrix, self.coding_matrix, data)

    def encode(self, data: np.ndarray) -> np.ndarray:
        return self.encode_batch(data)

    def delta_parity(self, delta: np.ndarray,
                     dirty_cols) -> np.ndarray:
        """Parity delta for a partial-stripe overwrite: GF(2^w)
        linearity gives ``new_parity = old_parity XOR M[:,dirty]·Δdata``
        (Δdata = old XOR new), so only the dirty data columns ride the
        matmul.  delta uint8 [..., D, L] for D = len(dirty_cols) ->
        Δparity uint8 [..., m, L].  Byte-domain GF-matrix geometries
        only — the same eligibility gate as device decode."""
        if self.layout != "byte" or self.coding_matrix is None:
            raise ValueError("delta parity needs a byte-domain GF "
                             "coding matrix")
        cols = list(dirty_cols)
        if delta.shape[-2] != len(cols):
            raise ValueError(f"expected {len(cols)} dirty columns")
        if delta.shape[-1] == 0:
            return np.zeros(delta.shape[:-2] + (self.m, 0),
                            dtype=np.uint8)
        if self.gf8_encode_fast():
            # compiled backends: scatter Δ into a zero [..., k, L]
            # block and reuse the per-pool encode kernel (zero
            # columns are GF-inert) — a per-dirty-signature kernel
            # would pay a fresh XLA compile for every (signature,
            # shape) pair the overwrite mix sprays at it
            block = np.zeros(
                delta.shape[:-2] + (self.k, delta.shape[-1]),
                dtype=np.uint8)
            block[..., cols, :] = delta
            return self.backend.apply_gf8_matrix(self.coding_matrix,
                                                 block)
        sub = np.ascontiguousarray(self.coding_matrix[:, cols])
        return self._apply(matrix_to_bitmatrix(sub, self.w), sub,
                           delta)

    def _apply(self, B: np.ndarray, M: Optional[np.ndarray],
               data: np.ndarray) -> np.ndarray:
        if self.layout == "byte":
            widths = getattr(self.backend, "supported_widths", None)
            if widths is not None and self.w not in widths:
                return self._apply_bitmatrix_bytes(B, data)
            if hasattr(self.backend, "apply_bitmatrix_bytes"):
                return self.backend.apply_bitmatrix_bytes(B, data, self.w)
            if M is not None:
                return self.backend.apply_matrix(M, data, self.w)
            return self._apply_bitmatrix_bytes(B, data)
        if self.packet_static_fast():
            return self.backend.apply_packet_xor(B, data, self.w,
                                                 self.packetsize)
        if hasattr(self.backend, "apply_packet_chunks"):
            return self.backend.apply_packet_chunks(B, data, self.w,
                                                    self.packetsize)
        pk = bytes_to_packets(data, self.w, self.packetsize)
        out = self.backend.apply_bitmatrix_packets(B, pk)
        return packets_to_bytes(out, self.w, self.packetsize)

    def _apply_bitmatrix_bytes(self, B: np.ndarray, data: np.ndarray
                               ) -> np.ndarray:
        bits = bytes_to_bitplanes(data, self.w)
        out = np.matmul(B.astype(np.int64), bits.astype(np.int64)) & 1
        return bitplanes_to_bytes(out.astype(np.uint8), self.w)

    # -- decode -----------------------------------------------------------
    def chunk_size_multiple(self) -> int:
        """Chunk length must be a multiple of this for the layout."""
        if self.layout == "byte":
            return self.w // 8 if self.w >= 8 else 1
        return self.w * self.packetsize

    def decode_chunks(self, present: dict[int, np.ndarray],
                      chunk_len: int) -> dict[int, np.ndarray]:
        """Reconstruct every missing chunk id in 0..k+m-1.

        `present` maps chunk id -> uint8 array [..., L] (leading batch axes
        allowed but must agree); every chunk must be `chunk_len` long."""
        for i, c in present.items():
            if c.shape[-1] != chunk_len:
                raise ValueError(
                    f"chunk {i} length {c.shape[-1]} != {chunk_len}")
        n = self.k + self.m
        erased = [i for i in range(n) if i not in present]
        if not erased:
            return {}
        avail = sorted(present.keys())
        if len(avail) < self.k:
            raise ValueError("not enough chunks to decode")
        if chunk_len == 0:           # empty object: all chunks empty
            shape = next(iter(present.values())).shape
            return {e: np.zeros(shape, dtype=np.uint8) for e in erased}
        chosen = avail[:self.k]
        out: dict[int, np.ndarray] = {}
        if self.coding_matrix is not None:
            # combined recovery rows: ONE matrix maps the chosen k
            # survivors straight to every erased chunk (data AND
            # parity), so the whole reconstruction is a single apply
            # — one device dispatch per batch instead of a decode
            # apply chained into a re-encode apply
            rows_gf, rows_bits = self._recovery_rows(tuple(chosen),
                                                     tuple(erased))
            stack = np.stack([present[i] for i in chosen], axis=-2)
            if self.gf8_decode_fast():
                dec = self.backend.apply_gf8_rows(rows_gf, stack)
            else:
                dec = self._apply(rows_bits, rows_gf, stack)
            for idx, e in enumerate(erased):
                out[e] = dec[..., idx, :]
            return out
        data_erased = [e for e in erased if e < self.k]
        if data_erased:
            rows_gf, rows_bits = self._decode_rows(tuple(chosen),
                                                   tuple(data_erased))
            stack = np.stack([present[i] for i in chosen], axis=-2)
            if rows_gf is not None and self.gf8_decode_fast():
                dec = self.backend.apply_gf8_rows(rows_gf, stack)
            else:
                dec = self._apply(rows_bits, rows_gf, stack)
            for idx, e in enumerate(data_erased):
                out[e] = dec[..., idx, :]
        coding_erased = [e for e in erased if e >= self.k]
        if coding_erased:
            full = np.stack(
                [present[i] if i in present else out[i]
                 for i in range(self.k)], axis=-2)
            enc_rows_bits = np.concatenate(
                [self.bitmatrix[(e - self.k) * self.w:(e - self.k + 1) * self.w]
                 for e in coding_erased], axis=0)
            enc_rows_gf = None if self.coding_matrix is None else \
                self.coding_matrix[[e - self.k for e in coding_erased]]
            if enc_rows_gf is not None and self.gf8_decode_fast():
                enc = self.backend.apply_gf8_rows(enc_rows_gf, full)
            else:
                enc = self._apply(enc_rows_bits, enc_rows_gf, full)
            for idx, e in enumerate(coding_erased):
                out[e] = enc[..., idx, :]
        return out

    def _recovery_rows(self, chosen: tuple, erased: tuple):
        """(GF rows, bit rows) mapping the chosen k survivors to EVERY
        erased chunk id — data rows come straight from the inverse map
        R (chosen -> data), parity row e >= k composes the encode row
        through it: coding_matrix[e-k] · R over GF(2^w).  Cached per
        erasure signature; this is the matrix the device decode
        pipeline jit-caches per (geometry, erasure-set)."""
        key = ("rec", chosen, erased)
        hit = self._decode_cache.get(key)
        if hit is not None:
            return hit
        if self.coding_matrix is None:
            raise ValueError("combined recovery rows need a GF "
                             "coding matrix")
        R = make_decoding_matrix(self.coding_matrix, self.w,
                                 list(chosen))
        f = gf(self.w)
        rows = [R[e] if e < self.k else
                f.matmul(self.coding_matrix[e - self.k][None, :], R)[0]
                for e in erased]
        rows_gf = np.stack(rows, axis=0).astype(np.int64)
        rows_bits = matrix_to_bitmatrix(rows_gf, self.w)
        self._decode_cache[key] = (rows_gf, rows_bits)
        return rows_gf, rows_bits

    def _decode_rows(self, chosen: tuple, data_erased: tuple):
        """(GF rows or None, bit rows) mapping chosen chunks -> erased data
        chunks; cached per erasure signature."""
        key = (chosen, data_erased)
        hit = self._decode_cache.get(key)
        if hit is not None:
            return hit
        if self.coding_matrix is not None:
            R = make_decoding_matrix(self.coding_matrix, self.w, list(chosen))
            rows_gf = R[list(data_erased)]
            rows_bits = matrix_to_bitmatrix(rows_gf, self.w)
        else:
            kw = self.k * self.w
            Gbits = np.concatenate([np.eye(kw, dtype=np.uint8),
                                    self.bitmatrix], axis=0)
            A = np.concatenate(
                [Gbits[c * self.w:(c + 1) * self.w] for c in chosen], axis=0)
            Rbits = bitmatrix_invert(A)
            rows_gf = None
            rows_bits = np.concatenate(
                [Rbits[e * self.w:(e + 1) * self.w] for e in data_erased],
                axis=0)
        self._decode_cache[key] = (rows_gf, rows_bits)
        return rows_gf, rows_bits
