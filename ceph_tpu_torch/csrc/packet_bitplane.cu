// B2: packet-layout bitmatrix apply for the cauchy/liberation codes.
//
// Replaces the TPU kernel _packet_mxu_pallas_fn (ceph_tpu/ops/jax_engine.py
// :289, pl.pallas_call at :352), which serves encode (the pool's coding
// bitmatrix), decode (the inverted rows of an erasure signature) and the
// re-encode of erased parity, for packet sizes that are a multiple of 128.
//
// What it computes, for data uint8 [batch, k, L] (L = nw * w * ps) and a
// 0/1 bitmatrix B [rows, k*w] (rows = m_out * w):
//   out[b, e, s, i, :] = XOR over (c, j) with B[e*w+i, c*w+j] = 1
//                        of in[b, c, s, j, :]
// where [s, j, :] is packet j of super-word s (packet_io.cuh).  The TPU
// kernel splits the bytes into 8 bit-planes only to feed its int8 matrix
// unit; bit j of an XOR of bytes is the mod-2 sum of their bit j, so XOR on
// whole words computes the same bytes with no unpacking.
//
// The operand (ops/carry.py) is B by input column: masks[g][c] holds rows
// 32g .. 32g+31 of column c, bit u for row 32g+u.  Each thread takes one
// 16-byte slice of one packet position, walks the k*w input packets four
// at a time (four loads in flight before their XORs), skips a column whose
// mask is zero (888 of 2,560 entries are ones for cauchy_good k=10 m=4
// w=8), and folds each loaded slice into the register accumulators of the
// rows whose bit is set.  masks sits in shared memory and every thread
// reads the same word, so the tests are warp-uniform.  Rows run in groups
// of up to 32 accumulators of 16 bytes; more than 32 rows run as further
// groups over the same input, served from L2 where it still holds it.
//
// Bound at the cauchy_good k=10 m=4 decode-bench shape ([128, 10, 409600]
// -> [128, 4, 409600], ps = 2048): it reads 524,288,000 B and writes
// 209,715,200 B, 0.219 ms at 3.35 TB/s; as a mod-2 int8 product it is
// 268 G operations, 0.136 ms at 1,979 TOP/s, so the function is bound by
// bytes.  This design does about 2.7 G integer ops there (per slice, 888 x
// 4 word XORs and 2,560 row tests), about 0.16 ms at the H100's 64 integer
// ops per clock per SM (132 SMs, 1.98 GHz), under the memory time.
#include "packet_io.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBatch = 4;  // input packets loaded ahead of their XORs

template <int G>
__global__ void __launch_bounds__(kThreads)
packet_bitplane_kernel(const uint32_t* __restrict__ masks,
                       const uint8_t* __restrict__ data,
                       uint8_t* __restrict__ out, long long batch, int k,
                       int w, int rows, long long ps, long long nw,
                       long long nseg, int unit) {
  extern __shared__ long long s_mem[];
  const int kw = k * w;
  const int ngroups = (rows + 31) / 32;
  long long* s_in = s_mem;
  long long* s_out = s_in + kw;
  uint32_t* s_masks = reinterpret_cast<uint32_t*>(s_out + rows);
  const long long L = nw * w * ps;
  packet_io::packet_offsets(s_in, s_out, k, w, rows, L, ps);
  for (int i = threadIdx.x; i < ngroups * kw; i += blockDim.x)
    s_masks[i] = masks[i];
  __syncthreads();

  const int m_out = rows / w;
  const long long total = batch * nw * nseg;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const long long seg = t % nseg;
    const long long bs = t / nseg;
    const long long b = bs / nw;
    const long long off = (bs - b * nw) * w * ps + seg * 16;
    const long long left = ps - seg * 16;
    const int n = left < 16 ? static_cast<int>(left) : 16;
    const uint8_t* in_b = data + b * k * L + off;
    uint8_t* out_b = out + b * m_out * L + off;

    for (int g = 0; g < ngroups; ++g) {
      const uint32_t* gm = s_masks + g * kw;
      uint32_t acc[G][4];
#pragma unroll
      for (int u = 0; u < G; ++u)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[u][q] = 0u;

      for (int c0 = 0; c0 < kw; c0 += kBatch) {
        uint32_t mk[kBatch];
        uint32_t x[kBatch][4];
#pragma unroll
        for (int p = 0; p < kBatch; ++p) {
          mk[p] = c0 + p < kw ? gm[c0 + p] : 0u;
          if (mk[p]) {
            packet_io::load16(in_b + s_in[c0 + p], unit, n, x[p]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) x[p][q] = 0u;
          }
        }
#pragma unroll
        for (int p = 0; p < kBatch; ++p)
#pragma unroll
          for (int u = 0; u < G; ++u)
            if (mk[p] & (1u << u)) {
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[u][q] ^= x[p][q];
            }
      }
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int r = g * 32 + u;
        if (r < rows) packet_io::store16(out_b + s_out[r], unit, n, acc[u]);
      }
    }
  }
}

}  // namespace

// masks: uint32 [ceil(rows/32), k*w] (ops/carry.py); data: uint8
// [batch, k, nw*w*ps]; out: uint8 [batch, rows/w, nw*w*ps]; all contiguous
// on the current device.  Launches on `stream`, allocates nothing, and
// returns cudaGetLastError().
extern "C" int packet_bitplane_apply(const void* masks, const void* data,
                                     void* out, long long batch, int k,
                                     int w, int rows, long long ps,
                                     long long nw, void* stream) {
  if (batch <= 0 || nw <= 0 || ps <= 0 || k <= 0 || w <= 0 || rows <= 0)
    return 0;
  const long long nseg = (ps + 15) / 16;
  const int unit = packet_io::access_unit(data, out, ps);
  const int kw = k * w;
  const size_t smem = static_cast<size_t>(kw + rows) * sizeof(long long) +
                      static_cast<size_t>((rows + 31) / 32) * kw *
                          sizeof(uint32_t);
  const int blocks =
      packet_io::grid_blocks(batch * nw * nseg, kThreads, 16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* m = static_cast<const uint32_t*>(masks);
  const uint8_t* in = static_cast<const uint8_t*>(data);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (rows <= 8)
    packet_bitplane_kernel<8><<<blocks, kThreads, smem, st>>>(
        m, in, o, batch, k, w, rows, ps, nw, nseg, unit);
  else if (rows <= 16)
    packet_bitplane_kernel<16><<<blocks, kThreads, smem, st>>>(
        m, in, o, batch, k, w, rows, ps, nw, nseg, unit);
  else
    packet_bitplane_kernel<32><<<blocks, kThreads, smem, st>>>(
        m, in, o, batch, k, w, rows, ps, nw, nseg, unit);
  return static_cast<int>(cudaGetLastError());
}
