// B3: packet-layout apply from an XOR schedule, for the cauchy/liberation
// codes at packet sizes that are not a multiple of 128.
//
// Replaces the TPU kernel _packet_pallas_fn (ceph_tpu/ops/jax_engine.py
// :234, pl.pallas_call at :272).  It computes the same function as B2
// (packet_bitplane.cu): output packet r of every super-word is the XOR of
// the input packets that row r of the bitmatrix selects.  The schedule
// (build_xor_schedule, jerasure's smart scheduling) builds row r either
// from scratch, or from an earlier output row prev[r] XOR the input packets
// where the two rows differ, which cuts the XORs: 790 instead of 888 for
// cauchy_good k=10 m=4 w=8.
//
// The schedule is a runtime operand, not a compiled constant: CSR int32
// arrays prev[rows], start[rows+1] and cols[nnz] (ops/carry.py), copied
// into shared memory.  Each thread takes one 16-byte slice of one packet
// position of one super-word (packet_io.cuh), builds the rows in order in
// four registers, loads four input slices ahead of their XORs, and stores
// each row as it is done.  A row with prev >= 0 starts from that earlier
// row, reread from `out`, where the same thread has just written it.
// Every thread reads the same schedule entry, so the loops are
// warp-uniform.
//
// Bound at [128, 10, 416000] -> [128, 4, 416000] (ps = 1000): it reads
// 532,480,000 B and writes 212,992,000 B, 0.223 ms at 3.35 TB/s, so it is
// bound by bytes.  This design reads each input slice once for every row
// that uses it (790 + 24 rereads of 16 bytes per slice against 80 + 32
// compulsory), so it leans on L1 and L2 to keep the extra reads off
// device memory.
#include "packet_io.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 4;  // input packets loaded ahead of their XORs

__global__ void __launch_bounds__(kThreads)
packet_xor_kernel(const int* __restrict__ prev, const int* __restrict__ start,
                  const int* __restrict__ cols,
                  const uint8_t* __restrict__ data,
                  uint8_t* __restrict__ out, long long batch, int k, int w,
                  int rows, int nnz, long long ps, long long nw,
                  long long nseg, int unit) {
  extern __shared__ long long s_mem[];
  const int kw = k * w;
  long long* s_in = s_mem;
  long long* s_out = s_in + kw;
  int* s_prev = reinterpret_cast<int*>(s_out + rows);
  int* s_start = s_prev + rows;
  int* s_cols = s_start + rows + 1;
  const long long L = nw * w * ps;
  packet_io::packet_offsets(s_in, s_out, k, w, rows, L, ps);
  for (int i = threadIdx.x; i < rows; i += blockDim.x) s_prev[i] = prev[i];
  for (int i = threadIdx.x; i <= rows; i += blockDim.x) s_start[i] = start[i];
  for (int i = threadIdx.x; i < nnz; i += blockDim.x) s_cols[i] = cols[i];
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

    for (int r = 0; r < rows; ++r) {
      uint32_t acc[4] = {0u, 0u, 0u, 0u};
      const int p = s_prev[r];
      if (p >= 0) packet_io::load16(out_b + s_out[p], unit, n, acc);
      const int end = s_start[r + 1];
      for (int i0 = s_start[r]; i0 < end; i0 += kBatch) {
        uint32_t x[kBatch][4];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          if (i0 + q < end) {
            packet_io::load16(in_b + s_in[s_cols[i0 + q]], unit, n, x[q]);
          } else {
#pragma unroll
            for (int v = 0; v < 4; ++v) x[q][v] = 0u;
          }
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[v] ^= x[q][v];
      }
      packet_io::store16(out_b + s_out[r], unit, n, acc);
    }
  }
}

}  // namespace

// prev: int32 [rows], start: int32 [rows+1], cols: int32 [nnz]
// (ops/carry.py); data: uint8 [batch, k, nw*w*ps]; out: uint8
// [batch, rows/w, nw*w*ps]; all contiguous on the current device.
// Launches on `stream`, allocates nothing, and returns cudaGetLastError().
extern "C" int packet_xor_apply(const void* prev, const void* start,
                                const void* cols, const void* data,
                                void* out, long long batch, int k, int w,
                                int rows, int nnz, long long ps,
                                long long nw, void* stream) {
  if (batch <= 0 || nw <= 0 || ps <= 0 || k <= 0 || w <= 0 || rows <= 0)
    return 0;
  const long long nseg = (ps + 15) / 16;
  const int unit = packet_io::access_unit(data, out, ps);
  const size_t smem =
      static_cast<size_t>(k * w + rows) * sizeof(long long) +
      static_cast<size_t>(2 * rows + 1 + nnz) * sizeof(int);
  const int blocks = packet_io::grid_blocks(batch * nw * nseg, kThreads, 8);
  packet_xor_kernel<<<blocks, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(prev), static_cast<const int*>(start),
      static_cast<const int*>(cols), static_cast<const uint8_t*>(data),
      static_cast<uint8_t*>(out), batch, k, w, rows, nnz, ps, nw, nseg,
      unit);
  return static_cast<int>(cudaGetLastError());
}
