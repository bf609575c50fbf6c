// Shared by the packet-layout kernels B2 (packet_bitplane.cu) and B3
// (packet_xor.cu).
//
// Both map uint8 data [batch, k, L] to uint8 out [batch, rows/w, L], where
// each chunk is nw super-words of w packets of ps bytes (L = nw * w * ps):
// input packet c = ci*w + j of super-word s starts at ci*L + s*w*ps + j*ps of
// its stripe, output packet r = e*w + i at e*L + s*w*ps + i*ps.  One thread
// takes one 16-byte slice (seg) of one packet position of one super-word of
// one stripe, and moves that slice of every packet it reads or writes.
//
// Every packet start is a multiple of ps from a base pointer, so the widest
// access unit that divides ps and both base pointers (16, 8, 4 or 1 bytes)
// is safe for every slice.  A ragged last slice (ps not a multiple of 16)
// holds a multiple of that unit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace packet_io {

inline int access_unit(const void* a, const void* b, long long ps) {
  const uintptr_t mix = reinterpret_cast<uintptr_t>(a) |
                        reinterpret_cast<uintptr_t>(b) |
                        static_cast<uintptr_t>(ps);
  for (int u = 16; u > 1; u >>= 1)
    if (mix % u == 0) return u;
  return 1;
}

// x = the n (<= 16) bytes at p as four little-endian words, zero past n.
__device__ __forceinline__ void load16(const uint8_t* p, int unit, int n,
                                       uint32_t x[4]) {
  if (unit == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    return;
  }
  if (unit == 8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint2 v = make_uint2(0u, 0u);
      if (8 * h < n) v = *reinterpret_cast<const uint2*>(p + 8 * h);
      x[2 * h] = v.x; x[2 * h + 1] = v.y;
    }
    return;
  }
  if (unit == 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      x[q] = 4 * q < n ? *reinterpret_cast<const uint32_t*>(p + 4 * q) : 0u;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) x[q] = 0u;
  // fully unrolled so x stays in registers
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < n) x[i >> 2] |= static_cast<uint32_t>(p[i]) << (8 * (i & 3));
}

// The first n (<= 16) bytes of the four words a, stored at p.
__device__ __forceinline__ void store16(uint8_t* p, int unit, int n,
                                        const uint32_t a[4]) {
  if (unit == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(a[0], a[1], a[2], a[3]);
    return;
  }
  if (unit == 8) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (8 * h < n)
        *reinterpret_cast<uint2*>(p + 8 * h) =
            make_uint2(a[2 * h], a[2 * h + 1]);
    return;
  }
  if (unit == 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (4 * q < n) *reinterpret_cast<uint32_t*>(p + 4 * q) = a[q];
    return;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < n) p[i] = static_cast<uint8_t>(a[i >> 2] >> (8 * (i & 3)));
}

// Offsets of every input packet (k*w of them) and output packet (rows of
// them) within one stripe's super-word, in shared memory.
__device__ __forceinline__ void packet_offsets(long long* s_in,
                                               long long* s_out, int k,
                                               int w, int rows, long long L,
                                               long long ps) {
  for (int c = threadIdx.x; c < k * w; c += blockDim.x)
    s_in[c] = (c / w) * L + (c % w) * ps;
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    s_out[r] = (r / w) * L + (r % w) * ps;
}

// Blocks for a grid-stride loop over `items`: enough to fill the card
// `per_sm` times over, and no more than the items need.
inline int grid_blocks(long long items, int threads, int per_sm) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (items + threads - 1) / threads;
  const long long cap = static_cast<long long>(sms > 0 ? sms : 132) * per_sm;
  return static_cast<int>(need < cap ? need : cap);
}

}  // namespace packet_io
