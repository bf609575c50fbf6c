"""Coding-matrix constructions for the erasure-code plugins.

Re-implements, from the published algorithms (J. S. Plank et al.,
"Note: Correction to the 1997 Tutorial on Reed-Solomon Coding", 2005;
"Optimizing Cauchy Reed-Solomon Codes for Fault-Tolerant Network Storage
Applications", 2006), the constructions the reference obtains from the
jerasure library (vendored submodule, empty in this checkout; call sites:
reference src/erasure-code/jerasure/ErasureCodeJerasure.cc:203,255,323,333).

Everything here returns small numpy int64 matrices of GF(2^w) elements,
plus conversions to GF(2) *bitmatrices* — the representation the device
engine executes (one (w*m x w*k) 0/1 matrix; encode == a mod-2 product
of that matrix with the data's bit-planes, kernel B1 on the card).

Bitmatrix convention (matches jerasure_matrix_to_bitmatrix semantics):
block (i, j) is a w x w 0/1 matrix B with B[r, c] = bit r of
(M[i][j] * 2^c), i.e. out-bit r of the product is XOR over in-bits c.
"""
from __future__ import annotations

import numpy as np

from .gf import GF, gf


# ---------------------------------------------------------------------------
# Reed-Solomon (Vandermonde)
# ---------------------------------------------------------------------------

def reed_sol_big_vandermonde_distribution_matrix(
        rows: int, cols: int, w: int) -> np.ndarray:
    """rows x cols distribution matrix: top cols x cols identity, bottom in
    the normalized Vandermonde-derived form (first coding row and first
    column all ones).  Algorithm per Plank & Ding 2005:

    1. V[i][j] = i^j in GF(2^w)  (0^0 == 1).
    2. Systematize the top cols x cols block with elementary *column*
       operations (column ops preserve the any-k-rows-invertible property).
    3. Scale the coding part: columns so the first coding row is all ones,
       then rows so the first column is all ones.
    """
    f = gf(w)
    if cols >= rows:
        raise ValueError("rows must exceed cols")
    if rows > f.size:
        raise ValueError(f"rows={rows} exceeds field size 2^{w}")
    V = np.zeros((rows, cols), dtype=np.int64)
    for i in range(rows):
        V[i, 0] = 1
        for j in range(1, cols):
            V[i, j] = f.mul(int(V[i, j - 1]), i)

    # -- step 2: column-op Gauss-Jordan on the top block
    for i in range(1, cols):
        if V[i, i] == 0:
            for j in range(i + 1, cols):
                if V[i, j]:
                    V[:, [i, j]] = V[:, [j, i]]
                    break
            else:
                raise np.linalg.LinAlgError("vandermonde systematization failed")
        if V[i, i] != 1:
            V[:, i] = f.mul(f.inv(int(V[i, i])), V[:, i])
        for j in range(cols):
            if j != i and V[i, j]:
                V[:, j] ^= np.asarray(f.mul(int(V[i, j]), V[:, i]),
                                      dtype=np.int64)

    # -- step 3a: scale coding-part columns so row `cols` is all ones
    for j in range(cols):
        e = int(V[cols, j])
        if e != 1:
            V[cols:, j] = f.mul(f.inv(e), V[cols:, j])
    # -- step 3b: scale remaining coding rows so column 0 is all ones
    for i in range(cols + 1, rows):
        e = int(V[i, 0])
        if e != 1:
            V[i] = f.mul(f.inv(e), V[i])
    return V


def reed_sol_vandermonde_coding_matrix(k: int, m: int, w: int) -> np.ndarray:
    """m x k coding matrix: bottom m rows of the distribution matrix.
    (reference call site: ErasureCodeJerasure.cc:203 `prepare()`)."""
    return reed_sol_big_vandermonde_distribution_matrix(k + m, k, w)[k:].copy()


def reed_sol_r6_coding_matrix(k: int, w: int) -> np.ndarray:
    """RAID-6 (m=2): P row all ones, Q row powers of 2.
    (reference call site: ErasureCodeJerasure.cc:255)."""
    f = gf(w)
    M = np.zeros((2, k), dtype=np.int64)
    M[0] = 1
    x = 1
    for j in range(k):
        M[1, j] = x
        x = f.mul(x, 2)
    return M


# ---------------------------------------------------------------------------
# Cauchy
# ---------------------------------------------------------------------------

def cauchy_original_coding_matrix(k: int, m: int, w: int) -> np.ndarray:
    """M[i][j] = 1 / (i XOR (m+j)) in GF(2^w).
    (reference call site: ErasureCodeJerasure.cc:323)."""
    f = gf(w)
    if k + m > f.size:
        raise ValueError("k + m must be <= 2^w for cauchy")
    M = np.zeros((m, k), dtype=np.int64)
    for i in range(m):
        for j in range(k):
            M[i, j] = f.inv(i ^ (m + j))
    return M


def cauchy_n_ones(n: int, w: int) -> int:
    """Number of ones in the w x w bitmatrix of the GF constant n."""
    f = gf(w)
    total = 0
    e = n
    for _ in range(w):
        total += bin(e).count("1")
        e = f.mul(e, 2) if w <= 16 else f._mul_slow(e, 2)
    return total
def cauchy_good_coding_matrix(k: int, m: int, w: int) -> np.ndarray:
    """Cauchy matrix optimized to minimize bitmatrix ones ("cauchy_good"):
    scale columns so row 0 is all ones, then scale each later row by the
    element whose removal minimizes the row's total bitmatrix ones.
    (reference call site: ErasureCodeJerasure.cc:333.  Note: jerasure
    additionally special-cases m==2 with precomputed tables; we apply the
    general optimization uniformly.)"""
    f = gf(w)
    M = cauchy_original_coding_matrix(k, m, w)
    for j in range(k):
        e = int(M[0, j])
        if e != 1:
            M[:, j] = f.mul(f.inv(e), M[:, j])
    for i in range(1, m):
        best_j, best_ones = 0, None
        for j in range(k):
            inv = f.inv(int(M[i, j]))
            ones = sum(cauchy_n_ones(int(f.mul(inv, int(M[i, x]))), w)
                       for x in range(k))
            if best_ones is None or ones < best_ones:
                best_j, best_ones = j, ones
        e = int(M[i, best_j])
        if e != 1:
            M[i] = f.mul(f.inv(e), M[i])
    return M


# ---------------------------------------------------------------------------
# ISA-L-compatible constructions (reference isa/ErasureCodeIsa.cc:385-387)
# ---------------------------------------------------------------------------

def isa_rs_vandermonde_matrix(k: int, m: int) -> np.ndarray:
    """ISA-L gf_gen_rs_matrix coding rows: row i = powers of 2^i
    (row 0 all ones).  NOT MDS for large (k, m) — the reference clamps to
    k<=32, m<=4 (isa/README)."""
    f = gf(8)
    M = np.zeros((m, k), dtype=np.int64)
    gen = 1
    for i in range(m):
        p = 1
        for j in range(k):
            M[i, j] = p
            p = f.mul(p, gen)
        gen = f.mul(gen, 2)
    return M


def isa_cauchy_matrix(k: int, m: int) -> np.ndarray:
    """ISA-L gf_gen_cauchy1_matrix coding rows: entry = 1/((k+i) XOR j)."""
    f = gf(8)
    M = np.zeros((m, k), dtype=np.int64)
    for i in range(m):
        for j in range(k):
            M[i, j] = f.inv((k + i) ^ j)
    return M


# ---------------------------------------------------------------------------
# SHEC construction (reference shec/ErasureCodeShec.cc:465-529)
# ---------------------------------------------------------------------------

def shec_recovery_efficiency(k: int, m1: int, m2: int, c1: int,
                             c2: int) -> float:
    """Recovery-efficiency estimator used to pick the best multi-SHEC
    split (reference shec_calc_recovery_efficiency1)."""
    if m1 < c1 or m2 < c2:
        return -1.0
    if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
        return -1.0
    r_eff_k = [10**8] * k
    r_e1 = 0.0
    for (mm, cc_) in ((m1, c1), (m2, c2)):
        for rr in range(mm):
            start = ((rr * k) // mm) % k
            end = (((rr + cc_) * k) // mm) % k
            cc = start
            first = True
            while first or cc != end:
                first = False
                r_eff_k[cc] = min(r_eff_k[cc],
                                  ((rr + cc_) * k) // mm - (rr * k) // mm)
                cc = (cc + 1) % k
            r_e1 += ((rr + cc_) * k) // mm - (rr * k) // mm
    r_e1 += sum(r_eff_k)
    return r_e1 / (k + m1 + m2)


def shec_coding_matrix(k: int, m: int, c: int, w: int,
                       single: bool) -> np.ndarray:
    """Shingled-EC matrix: Vandermonde rows with the complement of each
    parity's shingle window zeroed.  `single` uses one parity group;
    otherwise the (m1, c1) split minimizing the recovery-efficiency
    estimator is chosen."""
    if single:
        m1, c1 = 0, 0
    else:
        best = None
        for c1_ in range(c // 2 + 1):
            for m1_ in range(m + 1):
                c2_, m2_ = c - c1_, m - m1_
                if m1_ < c1_ or m2_ < c2_:
                    continue
                if (m1_ == 0 and c1_ != 0) or (m2_ == 0 and c2_ != 0):
                    continue
                if (m1_ != 0 and c1_ == 0) or (m2_ != 0 and c2_ == 0):
                    continue
                r = shec_recovery_efficiency(k, m1_, m2_, c1_, c2_)
                if best is None or r < best[0] - 1e-12:
                    best = (r, c1_, m1_)
        _, c1, m1 = best
    m2, c2 = m - m1, c - c1

    M = reed_sol_vandermonde_coding_matrix(k, m, w)
    for rr in range(m1):
        end = ((rr * k) // m1) % k
        cc = (((rr + c1) * k) // m1) % k
        while cc != end:
            M[rr, cc] = 0
            cc = (cc + 1) % k
    for rr in range(m2):
        end = ((rr * k) // m2) % k
        cc = (((rr + c2) * k) // m2) % k
        while cc != end:
            M[m1 + rr, cc] = 0
            cc = (cc + 1) % k
    return M


# ---------------------------------------------------------------------------
# GF(2) bitmatrices — the representation the device engine executes
# ---------------------------------------------------------------------------

def constant_to_bitmatrix(e: int, w: int) -> np.ndarray:
    """w x w 0/1 matrix B with B[r, c] = bit r of (e * 2^c): product bits
    are GF(2)-linear in the input bits."""
    # column c is e * x^c, and x^c is the element 1 << c
    cols = gf(w).mul(e, 1 << np.arange(w, dtype=np.int64)).astype(np.int64)
    return ((cols[None, :] >> np.arange(w)[:, None]) & 1).astype(np.uint8)


def matrix_to_bitmatrix(M: np.ndarray, w: int) -> np.ndarray:
    """Expand an (m x k) GF(2^w) matrix into an (m*w x k*w) GF(2) matrix
    (equivalent of jerasure_matrix_to_bitmatrix)."""
    m, k = M.shape
    B = np.zeros((m * w, k * w), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            B[i * w:(i + 1) * w, j * w:(j + 1) * w] = \
                constant_to_bitmatrix(int(M[i, j]), w)
    return B


def bitmatrix_invert(B: np.ndarray) -> np.ndarray:
    """Invert a square 0/1 matrix over GF(2) (Gauss-Jordan with XOR)."""
    B = np.array(B, dtype=np.uint8)
    n = B.shape[0]
    if B.shape != (n, n):
        raise ValueError("bitmatrix must be square")
    aug = np.concatenate([B, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = None
        for r in range(col, n):
            if aug[r, col]:
                piv = r
                break
        if piv is None:
            raise np.linalg.LinAlgError("singular GF(2) matrix")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        mask = aug[:, col].copy()
        mask[col] = 0
        aug ^= np.outer(mask, aug[col])
    return aug[:, n:]


# ---------------------------------------------------------------------------
# Decode-matrix derivation (shared by all matrix codes)
# ---------------------------------------------------------------------------

def make_decoding_matrix(coding: np.ndarray, w: int,
                         available_rows: list[int]) -> np.ndarray:
    """Rows of the inverse generator restricted to `available_rows`.

    Generator G = [I_k ; C] (n x k).  Given k available chunk ids
    (sorted), A = G[available_rows] is k x k; returns R = A^{-1} so that
    data = R @ chunks[available_rows].  Semantics match
    jerasure_make_decoding_matrix / ErasureCode::_minimum_to_decode
    (first k available chunks in id order)."""
    f = gf(w)
    m, k = coding.shape
    if len(available_rows) != k:
        raise ValueError("need exactly k available rows")
    G = np.concatenate([np.eye(k, dtype=np.int64), coding], axis=0)
    A = G[list(available_rows)]
    return f.mat_invert(A)
