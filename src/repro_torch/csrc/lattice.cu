// Per-tile lattice query: each centroid's first `nsample` points within L1
// range L, in index order, plus a mask.
//
// Replaces: lattice_tiles_pallas / _lattice_kernel,
// src/repro/kernels/lattice/kernel.py:50 (body at :25), and the flat
// lattice_pallas at :97, which runs the same body over one point set: its
// wrapper (kernels/lattice/kernel.py, lattice_query_cuda) launches this
// kernel as one tile of all M centroids and P points.  Same function: for
// centroid c of tile t, slot s holds the index of the (s+1)-th point j of
// tile t (in index order) with (|cx-px| + |cy-py|) + |cz-pz| <= L, and
// mask[s] says whether such a point exists.  Empty slots take the first hit,
// or 0 when there is none.  L arrives as the float32 value of the Python
// double radius * 1.6, compared with <=, like the reference.
//
// Bound on an H100 SXM: at the cls main-path shapes (8 clouds: T=32 tiles,
// K=64 centroids, P=256 points, nsample=32) the kernel reads ~123 KB and
// writes T*K*nsample*(4+1) = ~330 KB, ~0.13 us at 3.35 TB/s; the distance
// work, 6 single f32 instructions a point scanned (3 sub, 2 add, 1
// compare; the abs is a free source modifier of the add), at the FP32
// pipes' 33.5 T instructions a second, is below that there.  Seg (8 clouds
// of 4096 points) gives T=64 tiles of K=128 centroids, P=512 points, whose
// scans (~3 M points, ~0.53 us) take about as long as their bytes (~0.54
// us), and T=64 of K=32, P=128; a flat query of M=1024 centroids among
// P=4096 points is instruction-bound (~0.49 us).
//
// Design: a block serves `rows_per_block` centroids (rows) of one tile.  It
// copies the block's centroids and the tile's points into shared memory
// with cp.async (16 bytes a copy where the tile is 16-byte aligned, as at
// every main-path shape), at most `chunk` points at a time, the points' tail
// padded with NaN points to whole steps (a NaN distance is never <= L, so
// they never hit, whatever L is), and its warps read them from there.  A
// warp walks a row U chunks of 32 points a step (U = 2 or 4, a template
// parameter): U independent distance tests and ballots, then one prefix
// update of the row's count, so the walk stops at the end of the step that
// fills the row's nsample slots, and hits take their slots in index order
// (__popc of the lower lanes' ballot bits).  Where rows are few (the flat
// query at M = 64), `warps_per_row` warps share a row: each walks its own
// segment of the chunk, keeping at most the row's remaining slots of hits
// in shared memory; an exclusive scan of the segment counts gives each
// segment its first slot.  Slot 0 holds the row's first hit, which empty
// slots repeat.  A row's count and first hit carry from chunk to chunk in
// shared memory.  The host's lattice_plan chooses warps_per_row,
// rows_per_block, U, the chunk and the block size from the shapes.
//
// What bounds it: a point tested costs a lane ~22 instructions (3 loads, 6
// f32, the ballot and the slot bookkeeping), not the bound's 6, so long
// walks are issue-bound; and a call pays a fixed cost for the staging's
// memory latency, the barriers and the fill, even where every row fills in
// its first step.  Giving each lane of a row its own contiguous segment
// instead (a store a hit, no ballot) measured slower at every main-path
// shape: its lanes walk whole segments without the early stop.

#include <math.h>
#include <stdint.h>

#include <atomic>

#include "pc2im_capi.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a Hopper block may use
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float l1_distance(float cx, float cy, float cz, const float* p) {
  return __fadd_rn(__fadd_rn(fabsf(__fsub_rn(cx, p[0])), fabsf(__fsub_rn(cy, p[1]))),
                   fabsf(__fsub_rn(cz, p[2])));
}

// Asynchronous global-to-shared copies (cp.async): a thread issues all of
// its copies of a staging pass back to back, so the pass waits for one
// memory latency, not one for each element.
__device__ __forceinline__ void copy_async_4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copy_async_16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copy_async_wait() { asm volatile("cp.async.wait_all;\n" ::); }

// Copy n floats from global `src` to 16-byte aligned shared `dst`, 16
// bytes a copy where `src` is aligned for it and n is a multiple of 4.
__device__ __forceinline__ void stage_floats(float* dst, const float* src, int n) {
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0 && (n & 3) == 0) {
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) copy_async_16(dst + 4 * i, src + 4 * i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) copy_async_4(dst + i, src + i);
  }
}

// One warp walks staged points [lo, hi) of a row (hi - lo a multiple of
// 32 * U, the tail padded with points that never hit), U chunks of 32 a
// step, and hands each of the first `cap` hits to put(slot, point).
// Returns the hits counted, possibly more than cap: the walk stops at the
// end of the step that fills the row.
template <int U, typename Put>
__device__ __forceinline__ int walk(const float* sp, int lo, int hi, float cx, float cy, float cz,
                                    float L, int cap, Put put) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int count = 0;
  for (int base = lo; base < hi && count < cap; base += 32 * U) {
    const float* p = sp + 3 * (base + lane);
    bool hit[U];
    unsigned ballot[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      hit[u] = l1_distance(cx, cy, cz, p + 96 * u) <= L;
      ballot[u] = __ballot_sync(kFull, hit[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int slot = count + __popc(ballot[u] & below);
      if (hit[u] && slot < cap) put(slot, base + 32 * u + lane);
      count += __popc(ballot[u]);
    }
  }
  return count;
}

template <int U>
__global__ void __launch_bounds__(kMaxThreads)
    lattice_kernel(const float* __restrict__ coords, const float* __restrict__ centroids,
                   int* __restrict__ idx, unsigned char* __restrict__ mask, int K, int P,
                   int nsample, float L, int warps_per_row, int rows_per_block, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const int W = warps_per_row;
  const int step = 32 * U * W;  // a staged chunk is padded to whole steps of every segment
  const int padded = (chunk + step - 1) / step * step;
  float* sp = smem;                                                     // 3 * padded
  float* cent = sp + 3 * padded;                                        // 3 * rows_per_block
  int* row_count = reinterpret_cast<int*>(cent + 3 * rows_per_block);  // rows_per_block
  int* row_first = row_count + rows_per_block;                         // rows_per_block
  int* seg_count = row_first + rows_per_block;                         // warps (W > 1)
  int* seg_hits = seg_count + warps;                                   // warps * nsample (W > 1)

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int groups = warps / W;
  const int grp = warp / W;
  const int wseg = warp % W;
  const int slices = (K + rows_per_block - 1) / rows_per_block;
  const long long tile = blockIdx.x / slices;
  const int row0 = (blockIdx.x % slices) * rows_per_block;
  const int nrows = min(rows_per_block, K - row0);
  const int rounds = (nrows + groups - 1) / groups;
  const float* tp = coords + tile * P * 3;
  const float* cp = centroids + (tile * K + row0) * 3;

  stage_floats(cent, cp, 3 * nrows);  // waited for with the first chunk
  for (int i = threadIdx.x; i < nrows; i += blockDim.x) row_count[i] = 0;
  for (int cb = 0; cb < P; cb += chunk) {
    const int cn = min(chunk, P - cb);
    const int cpad = (cn + step - 1) / step * step;
    __syncthreads();  // every warp is done with the previous chunk
    stage_floats(sp, tp + static_cast<long long>(cb) * 3, 3 * cn);
    for (int i = 3 * cn + threadIdx.x; i < 3 * cpad; i += blockDim.x) sp[i] = NAN;
    copy_async_wait();
    __syncthreads();
    const int seg = cpad / W;  // a multiple of 32 * U
    const int lo = wseg * seg;
    for (int rd = 0; rd < rounds; ++rd) {
      const int rl = rd * groups + grp;
      const bool live = rl < nrows;
      const int count = live ? row_count[rl] : nsample;  // a missing row has no slot left
      const int cap = nsample - count;
      const float* c = cent + 3 * (live ? rl : 0);
      int* orow = idx + (tile * K + row0 + rl) * nsample;
      if (W == 1) {
        const int hits = walk<U>(sp, 0, cpad, c[0], c[1], c[2], L, cap, [&](int slot, int i) {
          orow[count + slot] = cb + i;
          if (count + slot == 0) row_first[rl] = cb + i;
        });
        if (live && lane == 0) row_count[rl] = count + min(hits, cap);
        continue;
      }
      int* hits_buf = seg_hits + warp * nsample;
      const int hits = walk<U>(sp, lo, lo + seg, c[0], c[1], c[2], L, cap,
                               [&](int slot, int i) { hits_buf[slot] = cb + i; });
      if (lane == 0) seg_count[warp] = min(hits, cap);
      __syncthreads();
      // exclusive scan of the group's segment counts: this segment's first slot
      const int gw = grp * W;
      int before = 0;
      for (int w = 0; w < wseg; ++w) before += seg_count[gw + w];
      const int mine = seg_count[warp];
      for (int s = lane; s < mine && before + s < cap; s += 32) {
        orow[count + before + s] = hits_buf[s];
      }
      if (live && count == 0 && before == 0 && mine > 0 && lane == 0) row_first[rl] = hits_buf[0];
      if (live && wseg == 0 && lane == 0) {
        int total = 0;
        for (int w = 0; w < W; ++w) total += seg_count[gw + w];
        row_count[rl] = count + min(total, cap);
      }
      __syncthreads();  // the segment buffers are free again
    }
  }
  __syncthreads();  // every row's count and first hit are final
  // empty slots take the row's first hit (0 if none); the mask marks real hits
  for (int rl = warp; rl < nrows; rl += warps) {
    const long long row = tile * K + row0 + rl;
    const int count = row_count[rl];
    const int first = count > 0 ? row_first[rl] : 0;
    int* orow = idx + row * nsample;
    unsigned char* mrow = mask + row * nsample;
    for (int s = lane; s < nsample; s += 32) {
      const bool filled = s < count;
      if (!filled) orow[s] = first;
      mrow[s] = filled ? 1 : 0;
    }
  }
}

}  // namespace

// Shared memory a launch with this plan takes (bytes).
static long long lattice_smem_bytes(int nsample, int warps_per_row, int rows_per_block, int unroll,
                                    int chunk, int threads) {
  const long long step = 32LL * unroll * warps_per_row;
  const long long padded = (chunk + step - 1) / step * step;
  long long bytes = 4LL * (3 * padded + 5LL * rows_per_block);
  if (warps_per_row > 1) bytes += 4LL * (threads / 32) * (1LL + nsample);
  return bytes;
}

// coords: (T, P, 3) float32; centroids: (T, K, 3) float32; idx: (T, K,
// nsample) int32; mask: (T, K, nsample) bool (one byte each).  All
// contiguous on `device`.  Indices are local to each tile.  The plan
// (kernels/lattice/kernel.py::lattice_plan): `warps_per_row` warps share a
// row (a power of two dividing the block's warps), a block serves
// `rows_per_block` rows of one tile and stages `chunk` points at a time,
// `unroll` (2 or 4) chunks of 32 points a step, `threads` a block (a
// multiple of 32 up to 256); a plan outside these, or one needing more
// shared memory than a block has, is refused.
PC2IM_API int pc2im_lattice_tiles(int device, const float* coords, const float* centroids,
                                  int* idx, unsigned char* mask, int T, int K, int P,
                                  int nsample, float L, int warps_per_row, int rows_per_block,
                                  int unroll, int chunk, int threads, void* stream) {
  if (T < 1 || K < 1 || P < 1 || nsample < 1) return cudaErrorInvalidValue;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) return cudaErrorInvalidValue;
  const int warps = threads / 32;
  if (warps_per_row < 1 || (warps_per_row & (warps_per_row - 1)) != 0 ||
      warps % warps_per_row != 0) {
    return cudaErrorInvalidValue;
  }
  if (rows_per_block < 1 || chunk < 1 || (unroll != 2 && unroll != 4)) {
    return cudaErrorInvalidValue;
  }
  const long long smem =
      lattice_smem_bytes(nsample, warps_per_row, rows_per_block, unroll, chunk, threads);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int dev_err = pc2im_set_device(device);
  if (dev_err != 0) return dev_err;
  const long long slices = (K + rows_per_block - 1) / rows_per_block;
  const long long blocks = static_cast<long long>(T) * slices;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto kernel = unroll == 2 ? lattice_kernel<2> : lattice_kernel<4>;
  if (smem > 48 * 1024) {
    // once for each instantiation on each device: allow a block all of it
    static std::atomic<bool> allowed[2][kMaxDevices];
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    std::atomic<bool>& done = allowed[unroll == 2 ? 0 : 1][device];
    if (!done.load(std::memory_order_acquire)) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
      done.store(true, std::memory_order_release);
    }
  }
  kernel<<<static_cast<unsigned>(blocks), threads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(coords, centroids, idx, mask, K, P, nsample, L,
                                                warps_per_row, rows_per_block, chunk);
  return static_cast<int>(cudaGetLastError());
}
