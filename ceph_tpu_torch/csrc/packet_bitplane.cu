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
// 32g .. 32g+31 of column c, bit u for row 32g+u.  The kernel works in
// units of 4 rows: unit u's mask of column c is the nibble
// (masks[u/8][c] >> 4*(u%8)) & 15.  At block start each unit's columns
// with a nonzero nibble are sorted by nibble into 15 classes (a counting
// sort with warp ballots), so that per item a unit XORs each class's
// staged slices once and then adds that sum to the rows of the class's
// bits: 15 x 2 row updates instead of a masked update of 4 rows per
// column, which bounded the first design by its integer work.  Each
// item's tile is staged in shared memory once (packet_io.cuh); each lane
// owns a 16-byte column of it and the eight warps take the units, so a
// staged slice is read from shared memory once per unit it feeds.  The
// lists keep 2-byte entries, at most k*w + 45 per unit, and class bounds.
//
// Bound at the cauchy_good k=10 m=4 decode-bench shape ([128, 10, 409600]
// -> [128, 4, 409600], ps = 2048): it reads 524,288,000 B and writes
// 209,715,200 B, 0.219 ms at 3.35 TB/s; as a mod-2 int8 product it is
// 268 G operations, 0.136 ms at 1,979 TOP/s, so the function is bound by
// bytes.  Here the 8 units read about 660 staged slices an item (plus
// padding), about 0.17 ms of shared-memory reads at 124 B per clock per
// SM, so device memory stays the limit the design aims at.
#include "packet_io.cuh"

namespace {

using packet_io::kStages;
using packet_io::kThreads;

using packet_io::kWarps;

// A unit is 4 output rows (4u .. 4u+3); its 4-bit mask of column c is
// (masks[u/8][c] >> 4*(u%8)) & 15.  Per unit the kernel keeps the columns
// with a nonzero mask sorted by mask into 15 classes, each padded with
// the zero row to a multiple of four entries (16-bit stage offsets in
// 16-byte units): at most k*w + 45 entries, rounded up to eight.
__host__ __device__ inline int unit_capacity(int kw) {
  return (kw + 45 + 7) & ~7;
}

// Byte offsets of the block's shared memory: the ring, the units' column
// lists, and each unit's 16 class bounds (class n is [b[n-1], b[n])).
struct BitplaneLayout {
  long long lists, bounds, total;
};

__host__ __device__ inline BitplaneLayout bitplane_layout(int kw, int rows,
                                                          int tile) {
  const long long units = (rows + 3) / 4;
  BitplaneLayout l;
  l.lists = packet_io::align16(kStages * packet_io::stage_bytes(kw, tile));
  l.bounds = l.lists + 2 * units * unit_capacity(kw);
  l.total = packet_io::align16(l.bounds + 64 * units);
  return l;
}

__global__ void __launch_bounds__(kThreads, packet_io::kMinBlocks)
packet_bitplane_kernel(const uint32_t* __restrict__ masks,
                       packet_io::Geometry g, int rows, long long total) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int kw = g.kw;
  const int tile = g.tile;
  const int units = (rows + 3) / 4;
  const int cap = unit_capacity(kw);
  const BitplaneLayout lay = bitplane_layout(kw, rows, tile);
  uint16_t* lists = reinterpret_cast<uint16_t*>(smem + lay.lists);
  int* bounds = reinterpret_cast<int*>(smem + lay.bounds);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  packet_io::run_ring(
      g, smem, total,
      [&] {
        // counting sort of each unit's columns by mask, one warp a unit
        const uint16_t zero = static_cast<uint16_t>((kw * tile) >> 4);
        const uint32_t below = (1u << lane) - 1u;
        for (int u = warp; u < units; u += kWarps) {
          const uint32_t* col = masks + (u >> 3) * kw;
          const int shift = 4 * (u & 7);
          uint16_t* lst = lists + u * cap;
          int* b = bounds + 16 * u;
          int cnt[16];
#pragma unroll
          for (int n = 0; n < 16; ++n) cnt[n] = 0;
          for (int c0 = 0; c0 < kw; c0 += 32) {
            const int c = c0 + lane;
            const uint32_t nib = c < kw ? (col[c] >> shift) & 15u : 0u;
#pragma unroll
            for (int n = 1; n < 16; ++n)
              cnt[n] += __popc(__ballot_sync(0xFFFFFFFFu, nib == n));
          }
          int at[16];  // where each class starts, then its next slot
          at[0] = 0;
#pragma unroll
          for (int n = 1; n < 16; ++n)
            at[n] = n == 1 ? 0 : at[n - 1] + ((cnt[n - 1] + 3) & ~3);
          if (lane == 0) {
#pragma unroll
            for (int n = 1; n < 16; ++n) b[n - 1] = at[n];
            b[15] = at[15] + ((cnt[15] + 3) & ~3);
          }
#pragma unroll
          for (int n = 1; n < 16; ++n)
            for (int i = at[n] + cnt[n] + lane;
                 i < at[n] + ((cnt[n] + 3) & ~3); i += 32)
              lst[i] = zero;
          for (int c0 = 0; c0 < kw; c0 += 32) {
            const int c = c0 + lane;
            const uint32_t nib = c < kw ? (col[c] >> shift) & 15u : 0u;
#pragma unroll
            for (int n = 1; n < 16; ++n) {
              const uint32_t hit = __ballot_sync(0xFFFFFFFFu, nib == n);
              if (nib == n)
                lst[at[n] + __popc(hit & below)] =
                    static_cast<uint16_t>((c * tile) >> 4);
              at[n] += __popc(hit);
            }
          }
        }
      },
      [&](const packet_io::Item& it, const uint8_t* stage) {
        const int ncs = tile > 512 ? 2 : 1;  // 16-byte columns per lane
        for (int u = warp; u < units; u += kWarps) {
          const uint16_t* lst = lists + u * cap;
          const int* b = bounds + 16 * u;
#pragma unroll 1
          for (int cs = 0; cs < ncs; ++cs) {
            const int cb = lane * 16 + cs * 512;
            if (cb >= tile) break;
            const uint8_t* sb = stage + cb;
            uint4 acc[4];
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[v] = make_uint4(0u, 0u, 0u, 0u);
            // class n: the XOR of its columns goes to the rows of n's bits
#pragma unroll
            for (int n = 1; n < 16; ++n) {
              uint4 t = make_uint4(0u, 0u, 0u, 0u);
              for (int i = b[n - 1]; i < b[n]; i += 4) {
                const uint2 q = *reinterpret_cast<const uint2*>(lst + i);
                t = packet_io::xor2(
                    t, packet_io::xor4(
                           packet_io::lds128(sb + ((q.x & 0xFFFFu) << 4)),
                           packet_io::lds128(sb + ((q.x >> 16) << 4)),
                           packet_io::lds128(sb + ((q.y & 0xFFFFu) << 4)),
                           packet_io::lds128(sb + ((q.y >> 16) << 4))));
              }
#pragma unroll
              for (int v = 0; v < 4; ++v)
                if (n & (1 << v)) acc[v] = packet_io::xor2(acc[v], t);
            }
            if (cb < it.n) {
#pragma unroll
              for (int v = 0; v < 4; ++v) {
                const int r = 4 * u + v;
                if (r < rows)
                  packet_io::store16(
                      it.out + (r / g.w) * g.L + (r % g.w) * g.ps + cb,
                      g.unit, it.n - cb < 16 ? it.n - cb : 16, acc[v]);
              }
            }
          }
        }
      });
}

std::atomic<bool> g_smem_ready[packet_io::kMaxDevices];

}  // namespace

// masks: uint32 [ceil(rows/32), k*w] (ops/carry.py); data: uint8
// [batch, k, nw*w*ps]; out: uint8 [batch, rows/w, nw*w*ps]; all contiguous
// on device `device`.  `tile` and `smem` are the wrapper's plan
// (ops/packet_kernel.py launch_plan).  Launches on `stream`, allocates
// nothing, and returns cudaGetLastError(), or kBadPlan / kNoRoom
// (packet_io.cuh) without launching.
extern "C" int packet_bitplane_apply(const void* masks, const void* data,
                                     void* out, long long batch, int k,
                                     int w, int rows, long long ps,
                                     long long nw, int tile, long long smem,
                                     int device, void* stream) {
  if (batch <= 0 || nw <= 0 || ps <= 0 || k <= 0 || w <= 0 || rows <= 0)
    return 0;
  const int kw = k * w;
  if (!packet_io::valid_tile(tile) ||
      bitplane_layout(kw, rows, tile).total != smem)
    return packet_io::kBadPlan;
  const packet_io::DeviceInfo dev = packet_io::device_info(device);
  if (smem > dev.smem_optin) return packet_io::kNoRoom;
  cudaError_t err = packet_io::allow_smem(packet_bitplane_kernel, device,
                                          dev, g_smem_ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  packet_io::Geometry g;
  g.data = static_cast<const uint8_t*>(data);
  g.out = static_cast<uint8_t*>(out);
  g.L = nw * w * ps;
  g.ps = ps;
  g.nw = nw;
  g.ntiles = (ps + tile - 1) / tile;
  g.k = k;
  g.w = w;
  g.kw = kw;
  g.m_out = rows / w;
  g.tile = tile;
  g.unit = packet_io::access_unit(data, out, ps);
  const long long total = batch * nw * g.ntiles;
  packet_bitplane_kernel<<<packet_io::grid_blocks(total, smem, dev),
                           kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(masks), g, rows, total);
  return static_cast<int>(cudaGetLastError());
}

// Registers and local (spill) bytes per thread of the compiled kernel.
extern "C" int packet_bitplane_regs(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, packet_bitplane_kernel);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(err);
}
