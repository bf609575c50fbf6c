"""Shingled erasure code plugin (reference
src/erasure-code/shec/ErasureCodeShec.{h,cc} + ErasureCodePluginShec.cc).

SHEC(k, m, c): m parities each covering a sliding "shingle" window of the
data chunks, trading MDS-ness for cheaper single-failure recovery.  The
matrix is a Vandermonde matrix with each parity's window complement
zeroed (reference shec_reedsolomon_coding_matrix, :465-529); decoding
searches parity subsets for the minimal chunk set whose system is
invertible (reference shec_make_decoding_matrix, :531-760), with results
cached per (want, avails) signature like the reference's table cache
(ErasureCodeShecTableCache).

Techniques: ``multiple`` (default; splits parities into two groups
minimizing the recovery-efficiency estimator) and ``single``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Mapping, Optional, Set, Tuple

import numpy as np

from ...ops import matrix as mat
from ...ops.engine import CodecCore
from ...ops.gf import gf
from ..interface import (ErasureCode, ErasureCodeProfile,
                         ErasureCodeValidationError)
from ..registry import ErasureCodePlugin


class ErasureCodeShec(ErasureCode):
    DEFAULT_K, DEFAULT_M, DEFAULT_C, DEFAULT_W = 4, 3, 2, 8

    def __init__(self, technique: str = "multiple"):
        super().__init__()
        self.technique = technique
        self.k = 0
        self.m = 0
        self.c = 0
        self.w = 8
        self.matrix: np.ndarray = None
        self.core: CodecCore = None
        # LRU-bounded per-codec cache of decode solutions, the moral
        # equivalent of the reference's shared table cache
        # (ErasureCodeShecTableCache.cc:277-283 evicts the LRU front)
        self._decode_cache: "OrderedDict[tuple, tuple]" = OrderedDict()

    DECODE_CACHE_MAX = 2048

    def _cache_put(self, key: tuple, value) -> None:
        self._decode_cache[key] = value
        if len(self._decode_cache) > self.DECODE_CACHE_MAX:
            self._decode_cache.popitem(last=False)

    def make_backend(self):
        return None

    # -- init / parse (reference ErasureCodeShec.cc:276-377) --------------
    def init(self, profile: ErasureCodeProfile) -> None:
        self.parse(profile)
        self.prepare()
        super().init(profile)

    def parse(self, profile: ErasureCodeProfile) -> None:
        # NB: no super().parse() — the reference SHEC never parses the
        # base 'mapping=' key (ErasureCodeShec.cc:276), so chunk ids are
        # always raw code positions here.
        has = [x for x in ("k", "m", "c") if x in profile]
        if not has:
            self.k, self.m, self.c = (self.DEFAULT_K, self.DEFAULT_M,
                                      self.DEFAULT_C)
        elif len(has) != 3:
            raise ErasureCodeValidationError("(k, m, c) must be chosen")
        else:
            try:
                self.k = int(profile["k"])
                self.m = int(profile["m"])
                self.c = int(profile["c"])
            except ValueError as e:
                raise ErasureCodeValidationError(str(e))
        if self.k <= 0 or self.m <= 0 or self.c <= 0:
            raise ErasureCodeValidationError(
                f"(k, m, c)=({self.k}, {self.m}, {self.c}) must be positive")
        if self.m < self.c:
            raise ErasureCodeValidationError(
                f"c={self.c} must be less than or equal to m={self.m}")
        if self.k > 12:
            raise ErasureCodeValidationError(
                f"k={self.k} must be less than or equal to 12")
        if self.k + self.m > 20:
            raise ErasureCodeValidationError(
                f"k+m={self.k + self.m} must be less than or equal to 20")
        if self.k < self.m:
            raise ErasureCodeValidationError(
                f"m={self.m} must be less than or equal to k={self.k}")
        w = profile.get("w")
        self.w = self.DEFAULT_W
        if w is not None:
            try:
                wi = int(w)
                if wi in (8, 16, 32):
                    self.w = wi
            except ValueError:
                pass  # reference falls back to the default silently

    def prepare(self) -> None:
        self.matrix = mat.shec_coding_matrix(
            self.k, self.m, self.c, self.w,
            single=(self.technique == "single"))
        self.core = CodecCore(self.k, self.m, self.w,
                              coding_matrix=self.matrix, layout="byte",
                              backend=self.make_backend())

    # -- interface --------------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_alignment(self) -> int:
        return self.k * self.w * 4

    def get_chunk_size(self, object_size: int) -> int:
        alignment = self.get_alignment()
        tail = object_size % alignment
        padded = object_size + (alignment - tail if tail else 0)
        assert padded % self.k == 0
        return padded // self.k

    # -- minimum_to_decode (reference :71-123) ----------------------------
    def _minimum_to_decode(self, want_to_read: Set[int],
                           available_chunks: Set[int]) -> Set[int]:
        n = self.k + self.m
        for s in (want_to_read, available_chunks):
            for i in s:
                if i < 0 or i >= n:
                    raise ValueError(f"chunk id {i} out of range")
        res = self._make_decoding_matrix(
            tuple(sorted(want_to_read)), tuple(sorted(available_chunks)))
        if res is None:
            raise IOError("cannot find recover matrix")
        return set(res[0])

    # -- decode search (reference shec_make_decoding_matrix :531-760) -----
    def _make_decoding_matrix(self, want_ids: tuple, avail_ids: tuple
                              ) -> Optional[tuple]:
        """Returns (minimum_ids, dm_rows, dm_cols, inverse) or None.

        dm_rows: chunk ids (data or k+parity) forming the equations;
        dm_cols: data chunk ids recovered by those equations;
        inverse: dup x dup GF matrix mapping dm_rows values -> dm_cols."""
        key = (want_ids, avail_ids)
        if key in self._decode_cache:
            self._decode_cache.move_to_end(key)
            return self._decode_cache[key]
        k, m = self.k, self.m
        f = gf(self.w)
        want = [0] * (k + m)
        avails = [0] * (k + m)
        for i in want_ids:
            want[i] = 1
        for i in avail_ids:
            avails[i] = 1
        # a wanted-but-missing parity pulls in its data columns
        for i in range(m):
            if want[k + i] and not avails[k + i]:
                for j in range(k):
                    if self.matrix[i, j] > 0:
                        want[j] = 1

        mindup, minp = k + 1, k + 1
        best_rows: List[int] = []
        best_cols: List[int] = []
        for pp in range(1 << m):
            parities = [i for i in range(m) if pp & (1 << i)]
            if len(parities) > minp:
                continue
            if any(not avails[k + p] for p in parities):
                continue
            tmprow = [0] * (k + m)
            tmpcol = [0] * k
            for i in range(k):
                if want[i] and not avails[i]:
                    tmpcol[i] = 1
            for p in parities:
                tmprow[k + p] = 1
                for j in range(k):
                    if self.matrix[p, j] != 0:
                        tmpcol[j] = 1
                        if avails[j]:
                            tmprow[j] = 1
            dup_row = sum(tmprow)
            dup_col = sum(tmpcol)
            if dup_row != dup_col:
                continue
            dup = dup_row
            if dup == 0:
                mindup = 0
                best_rows, best_cols = [], []
                break
            if dup < mindup:
                rows = [i for i in range(k + m) if tmprow[i]]
                cols = [i for i in range(k) if tmpcol[i]]
                A = self._system_matrix(rows, cols)
                try:
                    f.mat_invert(A)
                except np.linalg.LinAlgError:
                    continue
                mindup = dup
                best_rows, best_cols = rows, cols
                minp = len(parities)

        if mindup == k + 1:
            self._cache_put(key, None)
            return None

        minimum = set(best_rows)
        for i in range(k):
            if want[i] and avails[i]:
                minimum.add(i)
        for i in range(m):
            if want[k + i] and avails[k + i] and (k + i) not in minimum:
                if any(self.matrix[i, j] > 0 and not want[j]
                       for j in range(k)):
                    minimum.add(k + i)

        inverse = None
        if mindup:
            A = self._system_matrix(best_rows, best_cols)
            inverse = f.mat_invert(A)
        result = (tuple(sorted(minimum)), tuple(best_rows),
                  tuple(best_cols), inverse)
        self._cache_put(key, result)
        return result

    def _system_matrix(self, rows: List[int], cols: List[int]) -> np.ndarray:
        A = np.zeros((len(rows), len(cols)), dtype=np.int64)
        for ri, i in enumerate(rows):
            for ci, j in enumerate(cols):
                if i < self.k:
                    A[ri, ci] = 1 if i == j else 0
                else:
                    A[ri, ci] = self.matrix[i - self.k, j]
        return A

    # -- encode / decode --------------------------------------------------
    def encode_chunks(self, want_to_encode: Set[int],
                      encoded: Dict[int, np.ndarray]) -> None:
        data = np.stack([encoded[i] for i in range(self.k)])
        parity = self.core.encode(data)
        for i in range(self.m):
            encoded[self.k + i][:] = parity[i]

    def decode_chunks(self, want_to_read: Set[int],
                      chunks: Mapping[int, np.ndarray],
                      decoded: Dict[int, np.ndarray]) -> None:
        """Only wanted-and-missing chunks are reconstructed (reference
        decode_chunks :216-250: erased = missing AND wanted)."""
        k, m = self.k, self.m
        avail_ids = tuple(sorted(chunks))
        erased = [i for i in sorted(want_to_read) if i not in chunks]
        if not erased:
            return
        res = self._make_decoding_matrix(tuple(sorted(want_to_read)),
                                         avail_ids)
        if res is None:
            raise IOError("cannot find recover matrix")
        _, dm_rows, dm_cols, inverse = res
        backend = self.core.backend
        if inverse is not None and dm_cols:
            # only solve the rows for genuinely missing columns (the
            # reference skips avail columns too, ErasureCodeShec.cc:795)
            missing = [ci for ci, col in enumerate(dm_cols)
                       if col not in chunks]
            if missing:
                b = np.stack([decoded[i] for i in dm_rows])
                sol = backend.apply_matrix(inverse[missing], b, self.w)
                for si, ci in enumerate(missing):
                    decoded[dm_cols[ci]][:] = sol[si]
        # re-encode wanted erased parities from (now complete) data
        for i in range(m):
            if (k + i) in want_to_read and (k + i) not in chunks:
                row = self.matrix[i][None, :]
                out = backend.apply_matrix(
                    row, np.stack([decoded[j] for j in range(k)]), self.w)
                decoded[k + i][:] = out[0]


class ErasureCodeShecTableCache:
    """Placeholder mirroring the reference's shared table cache
    (ErasureCodeShecTableCache.cc); our per-codec _decode_cache fills the
    same role since matrices are cheap to rebuild in numpy."""


class ErasureCodePluginShec(ErasureCodePlugin):
    TECHNIQUES = ("single", "multiple")

    def factory(self, profile: ErasureCodeProfile):
        technique = profile.get("technique", "multiple")
        if technique not in self.TECHNIQUES:
            raise ErasureCodeValidationError(
                f"technique={technique} is not a valid coding technique")
        codec = ErasureCodeShec(technique)
        codec.init(profile)
        return codec


def __erasure_code_init__(registry) -> None:
    registry.add("shec", ErasureCodePluginShec())
