// B1: GF(2^8) byte-domain bitmatrix apply for the erasure-code hot path.
//
// Replaces the TPU kernel _gf_mxu_pallas_fn (ceph_tpu/ops/jax_engine.py:382,
// pl.pallas_call at :434), which serves encode (the pool coding matrix),
// decode (the combined recovery rows) and the parity delta (dirty
// columns zero-padded to [batch, k, L]).
//
// What it computes, for data uint8 [batch, k, L] and a 0/1 bitmatrix B
// [8*m_out, 8*k]:
//   bit i of out[b, e, l] = XOR over (c, j) with B[8e+i, 8c+j] = 1
//                           of bit j of data[b, c, l].
// Bit j of an input byte enters the output linearly, so the 8 bits of
// each byte are taken in three fields (bits 0-2, 3-5 and 6-7), and
// out[e] = XOR over (c, g) of T[e][c][g][field g of data[c]], where the
// table T[e][c][g] (ops/carry.py) holds at entry v the XOR of the column
// bytes of bits 3g+b for the set bits b of v: 8 bytes, two 32-bit words.
//
// One PRMT (byte permute, prmt.b32) looks up four bytes of an 8-byte
// table at once: each nibble of its selector picks a byte.  A thread holds
// 16 bytes of one chunk as two pairs of words (x0, x1); per field the
// selector s = (field of x0 in the low nibble of each byte) | (field of x1
// in the high nibble), so prmt(T, s) gives the field's contribution to
// columns (0, 4, 1, 5) of the pair and prmt(T, s >> 16) to (2, 6, 3, 7).
// Each field is masked before it is shifted into place (selectors()), so
// bit 3 of every nibble is zero and no selector ever sets PRMT's
// sign-replicate flag; the upper 16 bits of a selector are ignored.
// Accumulators keep the interleaved order through every chunk and output,
// and two PRMTs per pair (0x6420, 0x7531) restore it once, before the
// store.
//
// Design: each thread takes 16 bytes at one offset of every chunk of one
// stripe and keeps 4 output chunks x 4 words of accumulators in registers;
// more than 4 outputs run as further groups over the same input, and the
// group's output count is a template parameter, so no output is
// predicated.  Chunks go in pairs: a pair's 24 selectors are built once and
// serve every output, whose 6 tables come from shared memory as
// warp-uniform 8-byte loads (a broadcast, on the load pipe), and each
// accumulator word takes the pair's 6 lookups in three 3-input XORs.  The
// selectors' right shifts are multiply-highs, on the multiply pipe, so the
// integer pipe does little besides PRMT and LOP3.  The next pair's 32
// bytes are loaded before the current pair's arithmetic (also across
// groups and a thread's work items), and at 3 blocks an SM (80 registers,
// 16-byte loads) 24 warps keep those loads in flight.  Loads and stores
// use the widest unit (16, 8, 4 or 1 bytes) that divides L and both
// pointers, one kernel instantiation per unit; the ragged last segment of
// a chunk loads zeros past L (every table maps 0 to 0) and stores only
// its valid bytes.
//
// Bound at the headline shape (k=8, m=4, 512 stripes x 128 KiB chunks):
// it reads 512 MiB and writes 256 MiB, 805 MB in all, 0.240 ms at
// 3.35 TB/s.  Each input byte is read once (m_out <= 4).  Integer-pipe
// work per pair of chunks at m_out=4, as compiled for sm_90a: 96 PRMTs,
// 76 LOP3s (48 fold lookups, 24 build selectors) and about 9 other ops,
// about 90 per 16 bytes of one chunk, or about 46 per column byte at k=8
// with the reorder (3.1 G a launch); the first design's bit masks and
// LOP3 folds took 112 (7.52 G) and ran at 85-90% of the H100's 64 integer
// ops per clock per SM.  Tensor cores do not pay here: an int8 mma needs
// each column's 64 input bits spread into 64 int8 values (>= 32 ops) and
// returns 32 int32 output bits that each need about 2 ops to take the low
// bit and pack it, >= 64-96 ops per column before the product itself, more
// than this design.
#include "packet_io.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;       // output chunks per register group
constexpr int kTableWords = 6;  // 3 fields x 8 bytes per (output, chunk)
constexpr int kMaxTableBytes = 48 * 1024;  // no opt-in attribute needed

// Resident blocks an SM should hold: 3 caps a thread at 80 registers,
// which the 16-byte kernel (the main path) fits without spilling; the
// kernels for narrower loads (ragged lengths and misaligned views) need
// more registers and get 2 (128).
__host__ __device__ constexpr int min_blocks(int unit) {
  return unit == 16 ? 3 : 2;
}

// PTX prmt.b32 in its default mode: byte n of the result is byte
// (sel >> 4n) & 7 of the 8 bytes {hi:lo}; bit 3 of the nibble, which would
// replicate that byte's sign, is always zero in this kernel's selectors.
__device__ __forceinline__ uint32_t prmt(uint32_t lo, uint32_t hi,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(lo), "r"(hi), "r"(sel));
  return d;
}

// x >> n as a multiply-high, which issues on the multiply pipe and leaves
// the integer pipe (PRMT, LOP3) to the lookups.
__device__ __forceinline__ uint32_t shr(uint32_t x, int n) {
  uint32_t d;
  asm("mul.hi.u32 %0, %1, %2;" : "=r"(d) : "r"(x), "r"(1u << (32 - n)));
  return d;
}

// Bitwise c ? x : y (one LOP3).
__device__ __forceinline__ uint32_t bsel(uint32_t c, uint32_t x,
                                         uint32_t y) {
  return ((x ^ y) & c) ^ y;
}

// 16 bytes at p, of which the first n (a multiple of kUnit, 1..16) are
// valid, into x; the rest are zero.  Fully unrolled, so x stays in
// registers.
template <int kUnit>
__device__ __forceinline__ void load16(const uint8_t* p, int n,
                                       uint32_t x[4]) {
  if (kUnit == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if (kUnit == 8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint2 v = 8 * h < n ? *reinterpret_cast<const uint2*>(p + 8 * h)
                                : make_uint2(0u, 0u);
      x[2 * h] = v.x;
      x[2 * h + 1] = v.y;
    }
  } else if (kUnit == 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      x[q] = 4 * q < n ? *reinterpret_cast<const uint32_t*>(p + 4 * q) : 0u;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = 0u;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < n) x[i >> 2] |= static_cast<uint32_t>(p[i]) << (8 * (i & 3));
  }
}

// The selectors of one chunk's 16 bytes: sel[g][p] for field g of the
// word pair p = (x[2p], x[2p+1]), the field of x[2p] in the low nibble of
// each byte and that of x[2p+1] in the high nibble.  Each y-side operand
// is masked before it is shifted, so bits 3 and 7 of every byte of a
// selector are zero.
__device__ __forceinline__ void selectors(const uint32_t x[4],
                                          uint32_t sel[3][2]) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const uint32_t a = x[2 * p], b = x[2 * p + 1];
    sel[0][p] = bsel(0x07070707u, a, (b & 0x77777777u) << 4);
    sel[1][p] = bsel(0x07070707u, shr(a, 3), (b & 0x38383838u) << 1);
    sel[2][p] = bsel(0x03030303u, shr(a, 6), shr(b & 0xC0C0C0C0u, 2));
  }
}

// Selector for half h of a word pair: columns (0, 4, 1, 5) from its low
// 16 bits, (2, 6, 3, 7) from its high 16 bits.
__device__ __forceinline__ uint32_t half(uint32_t sel, int h) {
  return h ? shr(sel, 16) : sel;
}

// One chunk's contribution to one output: te = its 3 tables, 12 lookups.
__device__ __forceinline__ void lookup(const uint2* te,
                                       const uint32_t s[3][2],
                                       uint32_t acc[4]) {
  const uint2 t0 = te[0], t1 = te[1], t2 = te[2];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      acc[2 * p + h] ^= prmt(t0.x, t0.y, half(s[0][p], h)) ^
                        prmt(t1.x, t1.y, half(s[1][p], h)) ^
                        prmt(t2.x, t2.y, half(s[2][p], h));
}

// Two chunks' contributions to one output (te, tf their tables), folded
// together: three 3-input XORs per 6 lookups.
__device__ __forceinline__ void lookup2(const uint2* te, const uint2* tf,
                                        const uint32_t s[3][2],
                                        const uint32_t r[3][2],
                                        uint32_t acc[4]) {
  const uint2 t0 = te[0], t1 = te[1], t2 = te[2];
  const uint2 u0 = tf[0], u1 = tf[1], u2 = tf[2];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t v = acc[2 * p + h] ^ prmt(t0.x, t0.y, half(s[0][p], h)) ^
                   prmt(t1.x, t1.y, half(s[1][p], h));
      v ^= prmt(t2.x, t2.y, half(s[2][p], h)) ^
           prmt(u0.x, u0.y, half(r[0][p], h));
      acc[2 * p + h] = v ^ prmt(u1.x, u1.y, half(r[1][p], h)) ^
                       prmt(u2.x, u2.y, half(r[2][p], h));
    }
}

// One thread's work item: 16 bytes at one offset of every chunk of one
// stripe, n of them inside L.
struct Segment {
  const uint8_t* in;
  uint8_t* out;
  int n;
};

__device__ __forceinline__ Segment segment(long long t, const uint8_t* data,
                                           uint8_t* out, int k, int m_out,
                                           long long L, long long nseg) {
  const long long b = t / nseg;
  const long long off = (t - b * nseg) * 16;
  return {data + b * k * L + off, out + b * m_out * L + off,
          static_cast<int>(L - off < 16 ? L - off : 16)};
}

// The next one or two chunks a thread will read, loaded ahead of use.
struct Ahead {
  uint32_t x[4], y[4];
};

// Load the first chunks of a group (chunk 0 at p, and chunk 1 when k > 1).
template <int kUnit>
__device__ __forceinline__ void load_ahead(Ahead& a, const uint8_t* p, int n,
                                           bool second, long long L) {
  load16<kUnit>(p, n, a.x);
  if (second) load16<kUnit>(p + L, n, a.y);
}

// One group of NU outputs of one item over all k chunks, in pairs of
// chunks and a last single chunk when k is odd.  On entry `ah` holds the
// group's first chunks; on exit those of the next group, at nin (n valid
// bytes).
template <int kUnit, int NU>
__device__ __forceinline__ void run_group(const uint2* tab, int k,
                                          long long L, const Segment& cur,
                                          const uint8_t* nin, int nn,
                                          uint8_t* outp, Ahead& ah) {
  uint32_t acc[NU][4];
#pragma unroll
  for (int u = 0; u < NU; ++u)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[u][q] = 0u;
  const int tstep = k * 3;  // table words from one output to the next
  const uint8_t* p = cur.in;
  int c = 0;
  for (; c + 1 < k; c += 2, tab += 6) {
    uint32_t x[4], y[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x[q] = ah.x[q];
      y[q] = ah.y[q];
    }
    // the next step's chunks: c+2 (and c+3) here, or the next group's
    const bool here = c + 2 < k;
    p += 2 * L;
    load_ahead<kUnit>(ah, here ? p : nin, here ? cur.n : nn,
                      here ? c + 3 < k : k > 1, L);
    uint32_t s[3][2], r[3][2];
    selectors(x, s);
    selectors(y, r);
#pragma unroll
    for (int u = 0; u < NU; ++u)
      lookup2(tab + u * tstep, tab + u * tstep + 3, s, r, acc[u]);
  }
  if (c < k) {
    uint32_t x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = ah.x[q];
    load_ahead<kUnit>(ah, nin, nn, k > 1, L);
    uint32_t s[3][2];
    selectors(x, s);
#pragma unroll
    for (int u = 0; u < NU; ++u) lookup(tab + u * tstep, s, acc[u]);
  }
  // columns (0, 4, 1, 5 | 2, 6, 3, 7) of each word pair back in order
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    uint4 w;
    w.x = prmt(acc[u][0], acc[u][1], 0x6420u);
    w.y = prmt(acc[u][0], acc[u][1], 0x7531u);
    w.z = prmt(acc[u][2], acc[u][3], 0x6420u);
    w.w = prmt(acc[u][2], acc[u][3], 0x7531u);
    packet_io::store16(outp + u * L, kUnit, cur.n, w);
  }
}

template <int kUnit>
__global__ void __launch_bounds__(kThreads, min_blocks(kUnit))
gf8_table_kernel(const uint2* __restrict__ tables,
                 const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
                 long long batch, int k, int m_out, long long L,
                 long long nseg) {
  extern __shared__ uint2 s_tab[];
  const int ntab = m_out * k * 3;
  for (int i = threadIdx.x; i < ntab; i += blockDim.x) s_tab[i] = tables[i];
  __syncthreads();

  const long long total = batch * nseg;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  Segment cur = segment(t, data, out, k, m_out, L, nseg);
  Ahead ah;
  load_ahead<kUnit>(ah, cur.in, cur.n, k > 1, L);
  for (;;) {
    const long long tn = t + stride;
    const bool more = tn < total;
    // past the last item the loads ahead reread this one (never used)
    const Segment next =
        more ? segment(tn, data, out, k, m_out, L, nseg) : cur;
    for (int e0 = 0; e0 < m_out; e0 += kGroup) {
      const bool last = e0 + kGroup >= m_out;
      const uint8_t* nin = last ? next.in : cur.in;
      const int nn = last ? next.n : cur.n;
      const uint2* tab = s_tab + e0 * k * 3;
      uint8_t* outp = cur.out + e0 * L;
      switch (m_out - e0) {
        case 1:
          run_group<kUnit, 1>(tab, k, L, cur, nin, nn, outp, ah);
          break;
        case 2:
          run_group<kUnit, 2>(tab, k, L, cur, nin, nn, outp, ah);
          break;
        case 3:
          run_group<kUnit, 3>(tab, k, L, cur, nin, nn, outp, ah);
          break;
        default:
          run_group<kUnit, 4>(tab, k, L, cur, nin, nn, outp, ah);
          break;
      }
    }
    if (!more) break;
    t = tn;
    cur = next;
  }
}

template <int kUnit>
cudaError_t launch_unit(const uint2* tables, const uint8_t* data,
                        uint8_t* out, long long batch, int k, int m_out,
                        long long L, int sms, cudaStream_t stream) {
  const long long nseg = (L + 15) / 16;
  const size_t smem = static_cast<size_t>(m_out) * k * kTableWords * 4;
  const long long need = (batch * nseg + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms > 0 ? sms : 132) * 32;
  const int blocks = static_cast<int>(need < cap ? need : cap);
  gf8_table_kernel<kUnit><<<blocks, kThreads, smem, stream>>>(
      tables, data, out, batch, k, m_out, L, nseg);
  return cudaGetLastError();
}

}  // namespace

// tables: int32 [m_out, k, 3, 2] (ops/carry.py); data: uint8 [batch, k, L];
// out: uint8 [batch, m_out, L]; all contiguous on device `device`.
// Launches on `stream`, allocates nothing, and returns cudaGetLastError(),
// or kNoRoom (packet_io.cuh) without launching when the tables exceed
// 48 KiB of shared memory.
extern "C" int gf8_bitplane_apply(const void* tables, const void* data,
                                  void* out, long long batch, int k,
                                  int m_out, long long L, int device,
                                  void* stream) {
  if (batch <= 0 || L <= 0 || k <= 0 || m_out <= 0) return 0;
  if (static_cast<long long>(m_out) * k * kTableWords * 4 > kMaxTableBytes)
    return packet_io::kNoRoom;
  const int sms = packet_io::device_info(device).sms;
  const uint2* tab = static_cast<const uint2*>(tables);
  const uint8_t* in = static_cast<const uint8_t*>(data);
  uint8_t* o = static_cast<uint8_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (packet_io::access_unit(data, out, L)) {
    case 16:
      return static_cast<int>(
          launch_unit<16>(tab, in, o, batch, k, m_out, L, sms, s));
    case 8:
      return static_cast<int>(
          launch_unit<8>(tab, in, o, batch, k, m_out, L, sms, s));
    case 4:
      return static_cast<int>(
          launch_unit<4>(tab, in, o, batch, k, m_out, L, sms, s));
    default:
      return static_cast<int>(
          launch_unit<1>(tab, in, o, batch, k, m_out, L, sms, s));
  }
}

// Registers and local (spill) bytes per thread of the kernel built for
// `unit`-byte loads and stores (16, 8, 4 or 1).
extern "C" int gf8_bitplane_regs(int unit, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t err;
  switch (unit) {
    case 16: err = cudaFuncGetAttributes(&a, gf8_table_kernel<16>); break;
    case 8: err = cudaFuncGetAttributes(&a, gf8_table_kernel<8>); break;
    case 4: err = cudaFuncGetAttributes(&a, gf8_table_kernel<4>); break;
    default: err = cudaFuncGetAttributes(&a, gf8_table_kernel<1>); break;
  }
  *regs = err == cudaSuccess ? a.numRegs : 0;
  *local_bytes = err == cudaSuccess ? static_cast<int>(a.localSizeBytes) : 0;
  return static_cast<int>(err);
}
