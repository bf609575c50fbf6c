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
// arrays prev[rows], start[rows+1] and cols[nnz] (ops/carry.py), which
// each block turns into a program in shared memory at its start.  Like
// the TPU kernel, which brings one [k, w, ps] super-word block into VMEM
// and computes every row from that one read, each item's tile is staged
// in shared memory once (packet_io.cuh) and every row is built from there.
// Each lane of a warp owns a 16-byte column of the tile and the eight
// warps split the rows: a warp reads its program two groups of eight
// 16-bit entries at a time (one broadcast 16-byte load a group), so
// sixteen conflict-free 16-byte shared loads are in flight before their
// XORs.  A row with prev >= 0 starts from the earlier row, kept in an
// output tile in shared memory (rows x tile bytes); rows run in waves by
// their depth in the prev forest, with a barrier between waves, since the
// earlier row may belong to another warp.  Each row is stored to `out` as
// the warp's 512 contiguous bytes.
//
// Bound at [128, 10, 416000] -> [128, 4, 416000] (ps = 1000): it reads
// 532,480,000 B and writes 212,992,000 B, 0.223 ms at 3.35 TB/s, so it is
// bound by bytes.  Staged, the schedule's 790 + 24 reads of each slice
// (padded to whole groups) come from shared memory, about 11x the input
// bytes; at about 124 B per clock per SM that is some 0.19 ms, so shared
// memory, not device memory, is this design's floor, and the copies of
// the next item have to hide under it.
#include "packet_io.cuh"

namespace {

using packet_io::kStages;
using packet_io::kThreads;
using packet_io::kWarps;

// A program entry is a 16-bit stage offset in 16-byte units (offsets stay
// below 2^14 since a block has under 256 KiB); the first entry of a
// group carries the flags.
constexpr uint32_t kFirst = 1u << 14;  // the group starts its row
constexpr uint32_t kLast = 1u << 15;   // the group ends its row
constexpr uint32_t kOffset = kFirst - 1;

// Byte offsets of each part of the block's shared memory: the ring, the
// output tile, the program (groups of eight 16-bit entries; row r takes
// max(1, ceil(len_r / 8)) of them, at most ceil(nnz/8) + rows in all),
// prev, the rows in program order, and the segment table (start group and
// start row of each (wave, warp), at most kWarps * rows + 1 of each).
struct XorLayout {
  long long otile, prog, prev, order, segs, total;
};

__host__ __device__ inline XorLayout xor_layout(int kw, int rows, int nnz,
                                                int tile) {
  XorLayout l;
  l.otile = packet_io::align16(kStages * packet_io::stage_bytes(kw, tile));
  l.prog = packet_io::align16(l.otile + static_cast<long long>(rows) * tile);
  l.prev = l.prog + 16LL * ((nnz + 7) / 8 + rows);
  l.order = l.prev + 4LL * rows;
  l.segs = l.order + 4LL * rows;
  l.total = packet_io::align16(l.segs + 8LL * (kWarps * rows + 1) + 4);
  return l;
}

// The schedule as a program for the block's warps.  A row that starts
// from an earlier row has to wait for it, so the rows are laid out in
// waves by their depth in the prev forest (wave 0: rows from scratch; wave
// d: rows whose prev is in wave d-1); within a wave each row goes to the
// warp with the fewest groups so far, and the warps meet at a barrier
// between waves.  Segment (wave d, warp v) is the contiguous run of groups
// and of rows (in `order`) that warp v computes in wave d; its rows are in
// increasing order, each as max(1, ceil(len/8)) groups of stage offsets
// (c*tile/16) padded with the zero row's offset, kFirst on the first
// entry of its first group and kLast on the first entry of its last.
// The number of waves goes to *s_waves.  `scratch` holds four ints per
// row.
__device__ void build_program(const int* __restrict__ prev,
                              const int* __restrict__ start,
                              const int* __restrict__ cols, int rows, int kw,
                              int tile, uint16_t* prog, int* s_prev,
                              int* order, int* seg_g, int* seg_r,
                              int* scratch, int* s_waves) {
  int* ng = scratch;              // groups of each row
  int* wave = scratch + rows;     // wave of each row
  int* pos_g = scratch + 2 * rows;  // first group of each row
  int* pos_r = scratch + 3 * rows;  // place of each row in `order`
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int len = start[r + 1] - start[r];
    ng[r] = len > 8 ? (len + 7) >> 3 : 1;
    s_prev[r] = prev[r];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int waves = 1;
    for (int r = 0; r < rows; ++r) {
      wave[r] = s_prev[r] < 0 ? 0 : wave[s_prev[r]] + 1;
      if (wave[r] >= waves) waves = wave[r] + 1;
    }
    // segment sg = kWarps*wave + warp; count groups and rows at sg + 1
    const int nseg = kWarps * waves;
    for (int i = 0; i <= nseg; ++i) seg_g[i] = seg_r[i] = 0;
    for (int r = 0; r < rows; ++r) {
      const int base = kWarps * wave[r] + 1;
      int best = base;
      for (int v = base + 1; v < base + kWarps; ++v)
        if (seg_g[v] < seg_g[best]) best = v;
      seg_g[best] += ng[r];
      seg_r[best] += 1;
      pos_r[r] = best - 1;  // the row's segment, for now
    }
    for (int i = 1; i <= nseg; ++i) {  // counts -> segment starts
      seg_g[i] += seg_g[i - 1];
      seg_r[i] += seg_r[i - 1];
    }
    // place the rows, using each segment's start as its cursor: after
    // this loop seg[sg] holds the start of segment sg + 1
    for (int r = 0; r < rows; ++r) {
      const int sg = pos_r[r];
      pos_g[r] = seg_g[sg];
      pos_r[r] = seg_r[sg];
      seg_g[sg] += ng[r];
      seg_r[sg] += 1;
    }
    for (int i = nseg; i > 0; --i) {
      seg_g[i] = seg_g[i - 1];
      seg_r[i] = seg_r[i - 1];
    }
    seg_g[0] = seg_r[0] = 0;
    *s_waves = waves;
  }
  __syncthreads();
  const uint32_t zero = static_cast<uint32_t>(kw * tile) >> 4;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int lo = start[r], len = start[r + 1] - lo, n = 8 * ng[r];
    uint16_t* row = prog + 8 * pos_g[r];
    for (int j = 0; j < n; ++j) {
      uint32_t v = j < len ? static_cast<uint32_t>(cols[lo + j] * tile) >> 4
                           : zero;
      if (j == 0) v |= kFirst;
      if (j == n - 8) v |= kLast;
      row[j] = static_cast<uint16_t>(v);
    }
    order[pos_r[r]] = r;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += kThreads)
    s_prev[r] = s_prev[r] >= 0 ? s_prev[r] * tile : -1;
}

// The XOR of the eight staged 16-byte slices that group q names.
__device__ __forceinline__ uint4 group_xor(const uint8_t* sb, uint4 q) {
  using packet_io::lds128;
  return packet_io::xor2(
      packet_io::xor4(lds128(sb + ((q.x & kOffset) << 4)),
                      lds128(sb + ((q.x >> 16) << 4)),
                      lds128(sb + ((q.y & 0xFFFFu) << 4)),
                      lds128(sb + ((q.y >> 16) << 4))),
      packet_io::xor4(lds128(sb + ((q.z & 0xFFFFu) << 4)),
                      lds128(sb + ((q.z >> 16) << 4)),
                      lds128(sb + ((q.w & 0xFFFFu) << 4)),
                      lds128(sb + ((q.w >> 16) << 4))));
}

__global__ void __launch_bounds__(kThreads, packet_io::kMinBlocks)
packet_xor_kernel(const int* __restrict__ prev, const int* __restrict__ start,
                  const int* __restrict__ cols, packet_io::Geometry g,
                  int rows, int nnz, long long total) {
  extern __shared__ __align__(16) uint8_t smem[];
  const XorLayout lay = xor_layout(g.kw, rows, nnz, g.tile);
  uint8_t* otile = smem + lay.otile;
  const uint4* prog = reinterpret_cast<const uint4*>(smem + lay.prog);
  int* s_prev = reinterpret_cast<int*>(smem + lay.prev);
  int* order = reinterpret_cast<int*>(smem + lay.order);
  int* seg_g = reinterpret_cast<int*>(smem + lay.segs);
  int* seg_r = seg_g + kWarps * rows + 1;
  int* s_waves = seg_r + kWarps * rows + 1;
  const int tile = g.tile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  packet_io::run_ring(
      g, smem, total,
      [&] {
        // the output tile is free until the first item: scratch
        build_program(prev, start, cols, rows, g.kw, tile,
                      reinterpret_cast<uint16_t*>(smem + lay.prog), s_prev,
                      order, seg_g, seg_r, reinterpret_cast<int*>(otile),
                      s_waves);
      },
      [&](const packet_io::Item& it, const uint8_t* stage) {
        const int waves = *s_waves;
        const uint32_t z = static_cast<uint32_t>(g.kw * tile) >> 4;
        const uint4 empty = make_uint4(z | z << 16, z | z << 16, z | z << 16,
                                       z | z << 16);
        // one or two 16-byte columns per lane, each through every wave
        for (int cb = lane * 16; cb < (tile > 512 ? tile : 512); cb += 512) {
          const bool live = cb < tile;  // a tile under 512 bytes idles lanes
          const uint8_t* sb = stage + cb;
          for (int d = 0; d < waves; ++d) {
            const int sg = kWarps * d + warp;
            const int end = seg_g[sg + 1];
            int ri = seg_r[sg], r = 0;
            uint4 acc = make_uint4(0u, 0u, 0u, 0u);
            // the row step of one group: start the row, fold, finish it
            auto step = [&](uint32_t h, uint4 x) {
              if (h & kFirst) {
                r = order[ri];
                const int po = s_prev[r];
                acc = po >= 0 && live ? packet_io::lds128(otile + po + cb)
                                      : make_uint4(0u, 0u, 0u, 0u);
              }
              acc = packet_io::xor2(acc, x);
              if ((h & kLast) && live) {
                *reinterpret_cast<uint4*>(otile + r * tile + cb) = acc;
                if (cb < it.n)
                  packet_io::store16(
                      it.out + (r / g.w) * g.L + (r % g.w) * g.ps + cb,
                      g.unit, it.n - cb < 16 ? it.n - cb : 16, acc);
              }
              if (h & kLast) ++ri;
            };
            // two groups at a time: sixteen staged slices in flight
            for (int gi = seg_g[sg]; gi < end; gi += 2) {
              const uint4 qa = prog[gi];
              const uint4 qb = gi + 1 < end ? prog[gi + 1] : empty;
              uint4 xa = make_uint4(0u, 0u, 0u, 0u), xb = xa;
              if (live) {
                xa = group_xor(sb, qa);
                xb = group_xor(sb, qb);
              }
              step(qa.x, xa);
              step(qb.x, xb);
            }
            // rows of the next wave start from rows of this one
            if (d + 1 < waves)
              packet_io::bar_sync(packet_io::kBarRows, kThreads);
          }
        }
      });
}

std::atomic<bool> g_smem_ready[packet_io::kMaxDevices];

}  // namespace

// prev: int32 [rows], start: int32 [rows+1], cols: int32 [nnz]
// (ops/carry.py); data: uint8 [batch, k, nw*w*ps]; out: uint8
// [batch, rows/w, nw*w*ps]; all contiguous on device `device`.  `tile` and
// `smem` are the wrapper's plan (ops/packet_xor_kernel.py launch_plan).
// Launches on `stream`, allocates nothing, and returns cudaGetLastError(),
// or kBadPlan / kNoRoom (packet_io.cuh) without launching.
extern "C" int packet_xor_apply(const void* prev, const void* start,
                                const void* cols, const void* data,
                                void* out, long long batch, int k, int w,
                                int rows, int nnz, long long ps,
                                long long nw, int tile, long long smem,
                                int device, void* stream) {
  if (batch <= 0 || nw <= 0 || ps <= 0 || k <= 0 || w <= 0 || rows <= 0)
    return 0;
  const int kw = k * w;
  if (!packet_io::valid_tile(tile) ||
      xor_layout(kw, rows, nnz, tile).total != smem)
    return packet_io::kBadPlan;
  const packet_io::DeviceInfo dev = packet_io::device_info(device);
  if (smem > dev.smem_optin) return packet_io::kNoRoom;
  cudaError_t err =
      packet_io::allow_smem(packet_xor_kernel, device, dev, g_smem_ready);
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
  packet_xor_kernel<<<packet_io::grid_blocks(total, smem, dev),
                      kThreads,
                      smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(prev), static_cast<const int*>(start),
      static_cast<const int*>(cols), g, rows, nnz, total);
  return static_cast<int>(cudaGetLastError());
}

// Registers and local (spill) bytes per thread of the compiled kernel.
extern "C" int packet_xor_regs(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, packet_xor_kernel);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(err);
}
