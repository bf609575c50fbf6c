// Shared by the packet-layout kernels B2 (packet_bitplane.cu) and B3
// (packet_xor.cu): the staging ring both are built on.  Kernel B1
// (gf8_bitplane.cu) takes its device information, access unit and store16
// from here too.
//
// Both map uint8 data [batch, k, L] to uint8 out [batch, rows/w, L], where
// each chunk is nw super-words of w packets of ps bytes (L = nw * w * ps):
// input packet c = ci*w + j of super-word s starts at ci*L + s*w*ps + j*ps of
// its stripe, output packet r = e*w + i at e*L + s*w*ps + i*ps.
//
// One work item is (stripe, super-word, byte tile): bytes [t*tile,
// t*tile + n) of each of the k*w input packets of one super-word, n = tile
// except in the ragged last tile of a packet.  A block walks its items in a
// persistent loop and stages each one in shared memory exactly once, row c
// of the item at byte c*tile of a stage, in a ring of kStages stages: the
// next item's asynchronous copies (cp.async) are in flight while the
// current item is computed, so every input byte leaves device memory once
// and the copies, not the threads, keep the card's bytes in flight.
//
// Every packet start is a multiple of ps from a base pointer, so the widest
// copy unit that divides ps and both base pointers (16, 8, 4 or 1 bytes) is
// safe for every chunk; n is a multiple of it.  cp.async copies 16, 8 or 4
// bytes; a unit of 1 (a misaligned view) is staged with plain byte loads.
// Shared memory is always 16-byte aligned, so the kernels read the staged
// tile with full-width loads whatever the unit.
//
// The tile and the shared-memory figure come from the caller
// (ops/packet_kernel.py tile_plan); the entry points recompute the figure
// from the same layout and refuse a launch that disagrees with it or that
// exceeds the device's opt-in limit, before launching.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace packet_io {

// Threads per block; its warps share a tile's output rows.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;  // resident blocks an SM should hold
constexpr int kStages = 2;     // item tiles in the shared-memory ring
constexpr int kMaxDevices = 64;
constexpr int kMaxBlocksPerSm = 8;

// Entry-point refusals (CUDA's own errors are >= 0).
constexpr int kBadPlan = -1;  // tile or shared-memory figure disagrees
constexpr int kNoRoom = -2;   // figure above the device's opt-in limit

// The widest of 16, 8, 4 or 1 bytes that divides ps and both pointers
// (never 2: the copies and loads know no 2-byte unit).
inline int access_unit(const void* a, const void* b, long long ps) {
  const uintptr_t mix = reinterpret_cast<uintptr_t>(a) |
                        reinterpret_cast<uintptr_t>(b) |
                        static_cast<uintptr_t>(ps);
  for (int u = 16; u > 2; u >>= 1)
    if (mix % u == 0) return u;
  return 1;
}

__host__ __device__ inline long long align16(long long x) {
  return (x + 15) & ~15LL;
}

// A tile is a power of two from 16 to 1024 bytes (ops/packet_kernel.py).
inline bool valid_tile(int tile) {
  return tile >= 16 && tile <= 1024 && (tile & (tile - 1)) == 0;
}

// The SM count and shared-memory limits of a device, queried once.
struct DeviceInfo {
  int sms;
  int smem_optin;     // per block, with the opt-in attribute
  int smem_per_sm;
  int smem_reserved;  // per block, by the runtime
};

inline DeviceInfo device_info(int dev) {
  static std::atomic<int> cache[kMaxDevices][4];
  DeviceInfo d{0, 0, 0, 0};
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && cache[dev][0].load(std::memory_order_acquire) > 0) {
    d.smem_optin = cache[dev][1].load(std::memory_order_relaxed);
    d.smem_per_sm = cache[dev][2].load(std::memory_order_relaxed);
    d.smem_reserved = cache[dev][3].load(std::memory_order_relaxed);
    d.sms = cache[dev][0].load(std::memory_order_relaxed);
    return d;
  }
  cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&d.smem_optin,
                         cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&d.smem_per_sm,
                         cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  cudaDeviceGetAttribute(&d.smem_reserved,
                         cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (cached && d.sms > 0) {
    cache[dev][1].store(d.smem_optin, std::memory_order_relaxed);
    cache[dev][2].store(d.smem_per_sm, std::memory_order_relaxed);
    cache[dev][3].store(d.smem_reserved, std::memory_order_relaxed);
    cache[dev][0].store(d.sms, std::memory_order_release);
  }
  return d;
}

// Lets `kernel` take up to the device's opt-in shared memory, once per
// device (`done` is the kernel's own flag array).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int dev, const DeviceInfo& d,
                              std::atomic<bool>* done) {
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, d.smem_optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && cached)
    done[dev].store(true, std::memory_order_release);
  return err;
}

// Persistent blocks: as many as fit on the card at `smem` bytes each, and
// no more than there are items.
inline int grid_blocks(long long items, long long smem, const DeviceInfo& d) {
  long long per_sm = d.smem_per_sm / (smem + d.smem_reserved);
  if (per_sm < 1) per_sm = 1;
  if (per_sm > kMaxBlocksPerSm) per_sm = kMaxBlocksPerSm;
  const long long cap = static_cast<long long>(d.sms > 0 ? d.sms : 132) *
                        per_sm;
  return static_cast<int>(items < cap ? items : cap);
}

// One work item: the first byte of its tile in input packet 0 and output
// packet 0 of its super-word, and its valid bytes.
struct Item {
  const uint8_t* in;
  uint8_t* out;
  int n;
};

struct Geometry {
  const uint8_t* data;
  uint8_t* out;
  long long L, ps, nw, ntiles;
  int k, w, kw, m_out, tile, unit;

  __device__ __forceinline__ Item item(long long it) const {
    const long long t = it % ntiles;
    const long long bs = it / ntiles;
    const long long b = bs / nw;
    const long long off = (bs - b * nw) * w * ps + t * tile;
    const long long left = ps - t * tile;
    return {data + b * k * L + off, out + b * m_out * L + off,
            left < tile ? static_cast<int>(left) : tile};
  }
};

// How one thread walks the input rows of an item when staging it: P lanes
// (a power of two, P = min(tile / unit, kThreads)) cover a row in
// unit-byte chunks, kThreads / P rows at a time.  Row c = ci*w + cj is
// tracked as (ci, cj) by increments, with no division in the loop.
struct StageWalk {
  int lane, lanes, c0, rstep, ci0, cj0, dci, dcj;

  __device__ __forceinline__ void init(int tile, int unit, int w) {
    const int chunks = tile / unit;
    lanes = chunks < kThreads ? chunks : kThreads;
    lane = threadIdx.x & (lanes - 1);
    c0 = threadIdx.x / lanes;
    rstep = kThreads / lanes;
    ci0 = c0 / w;
    cj0 = c0 % w;
    dci = rstep / w;
    dcj = rstep % w;
  }
};

__device__ __forceinline__ void copy_chunk(uint8_t* dst, const uint8_t* src,
                                           int unit) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (unit == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else if (unit == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else if (unit == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else {
    *dst = *src;
  }
}

// Issue the copies of item `it` into `stage` (kw rows of g.tile bytes).
__device__ __forceinline__ void stage_item(uint8_t* stage, const Item& it,
                                           const Geometry& g,
                                           const StageWalk& sw) {
  const int chunks = it.n / g.unit;
  int ci = sw.ci0, cj = sw.cj0;
  for (int c = sw.c0; c < g.kw; c += sw.rstep) {
    const uint8_t* src = it.in + ci * g.L + cj * g.ps;
    uint8_t* dst = stage + c * g.tile;
    for (int j = sw.lane; j < chunks; j += sw.lanes)
      copy_chunk(dst + j * g.unit, src + j * g.unit, g.unit);
    ci += sw.dci;
    cj += sw.dcj;
    if (cj >= g.w) {
      cj -= g.w;
      ++ci;
    }
  }
}

// Bytes of one stage: the k*w input rows of an item and a zero row (row
// k*w, which no copy writes), where empty entries of a kernel's lists point.
__host__ __device__ inline long long stage_bytes(int kw, int tile) {
  return static_cast<long long>(kw + 1) * tile;
}

// Named barrier 1 (0 is __syncthreads) orders the warps' output rows
// within an item.
constexpr int kBarRows = 1;

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The persistent loop over this block's items (blockIdx.x, + gridDim.x,
// ...): the first kStages-1 items' copies are issued, the stages' zero
// rows written and setup() run (the kernel's operand tables) while they
// are in flight; then item j+kStages-1 is staged while item j is computed.
// compute(item, stage) may read the whole stage; bytes past item.n hold
// stale data.
template <typename Setup, typename Compute>
__device__ __forceinline__ void run_ring(const Geometry& g, uint8_t* ring,
                                         long long total, Setup&& setup,
                                         Compute&& compute) {
  StageWalk sw;
  sw.init(g.tile, g.unit, g.w);
  const int sbytes = static_cast<int>(stage_bytes(g.kw, g.tile));
  const long long step = gridDim.x;
  for (int s = 0; s + 1 < kStages; ++s) {
    const long long it = blockIdx.x + s * step;
    if (it < total) stage_item(ring + s * sbytes, g.item(it), g, sw);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int s = 0; s < kStages; ++s)
    for (int j = 4 * threadIdx.x; j < g.tile; j += 4 * kThreads)
      *reinterpret_cast<uint32_t*>(ring + s * sbytes + g.kw * g.tile + j) =
          0u;
  setup();
  int j = 0;
  for (long long it = blockIdx.x; it < total; it += step, ++j) {
    // every thread is done with item j-1, whose stage the next item takes
    __syncthreads();
    const long long next = it + (kStages - 1) * step;
    if (next < total)
      stage_item(ring + ((j + kStages - 1) % kStages) * sbytes, g.item(next),
                 g, sw);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    __syncthreads();
    compute(g.item(it), ring + (j % kStages) * sbytes);
  }
}

// Both kernels give each lane of a warp a 16-byte column of the tile
// (lane*16, plus 512 for the second half of a 1024-byte tile) and split
// the output rows among the warps.

__device__ __forceinline__ uint4 lds128(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b, uint4 c, uint4 d) {
  return make_uint4(a.x ^ b.x ^ c.x ^ d.x, a.y ^ b.y ^ c.y ^ d.y,
                    a.z ^ b.z ^ c.z ^ d.z, a.w ^ b.w ^ c.w ^ d.w);
}

__device__ __forceinline__ uint4 xor2(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

// The first n (<= 16) bytes of the four words a, stored at p.
__device__ __forceinline__ void store16(uint8_t* p, int unit, int n,
                                        uint4 v) {
  const uint32_t a[4] = {v.x, v.y, v.z, v.w};
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

}  // namespace packet_io

// The device's opt-in shared memory per block, for the wrappers' check.
extern "C" int packet_smem_limit(int device) {
  return packet_io::device_info(device).smem_optin;
}
