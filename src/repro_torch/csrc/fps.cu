// Farthest point sampling over a batch of tiles.
//
// Replaces: fps_tiles_pallas / _fps_kernel, src/repro/kernels/fps/kernel.py:66
// (body at :37).  Same function: per tile, start at index 0, dmin starts at
// 1e30; each step dmin = min(dmin, d(last)) and the next sample is the FIRST
// index of the largest dmin.  k indices come out, the start included.
// Metric: L1 (|dx| + |dy|) + |dz|, or squared L2 (dx*dx + dy*dy) + dz*dz,
// summed in that order with round-to-nearest intrinsics so no FMA
// contraction changes a bit against the plain version.
//
// Bound on an H100 SXM: at the main-path shapes (cls: T=32 tiles of P=256,
// k=64, then P=64, k=16; seg: T=64 of P=512, k=128, then P=128, k=32) the
// work is ~10 f32 operations per point per step and ~100-400 KB of traffic,
// well under a microsecond at 67 TFLOP/s or 3.35 TB/s.  What sets the time
// is the chain of k dependent argmax reductions, i.e. the latency of a step.
//
// Design, P <= 1024 (every main-path tile): one warp a tile, several tiles
// (warps) a block only when the tiles outnumber the SMs.  Each lane keeps
// its points (index lane + 32 j) and their dmin in registers; the warp's
// copy of the tile in shared memory serves the last sample's coordinates as
// one broadcast load.  A step is a register min-update of every point, a
// branch-free tree over the lane's own points for its largest dmin and the
// lowest index holding it, then two redux.sync instructions: the max of the
// lanes' dmin bits (non-negative floats order like their bits read as int),
// then the min index over the lanes holding it.  A missing point keeps
// dmin = -1, whose bits are negative, so it never wins, not even a tie at a
// dmin of 0.  No block barrier in the loop.
// P > 1024: one block a tile, a warp-shuffle argmax, one __syncthreads a
// step and a redundant per-warp reduction of the per-warp winners from a
// double-buffered shared array, which removes the second barrier.  Ties go
// to the lower index everywhere; no atomics, so the result is deterministic.
#include <climits>

#include "pc2im_capi.cuh"

namespace {

constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;

// (v1, i1) beats (v2, i2): larger value, then lower index.
__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Halve W pairs of (value, index) entries, each covering a run of
// consecutive j: entry j takes the larger of entries 2j and 2j+1, the lower
// run on a tie; then the next level.  Indices are compile-time constants, so
// the arrays stay in registers.
template <int W>
__device__ __forceinline__ void pair_tree(float* bv, int* bi) {
  if constexpr (W >= 1) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const bool hi = bv[2 * j + 1] > bv[2 * j];
      bi[j] = hi ? bi[2 * j + 1] : bi[2 * j];
      bv[j] = fmaxf(bv[2 * j], bv[2 * j + 1]);
    }
    pair_tree<W / 2>(bv, bi);
  }
}

// One warp a tile, J = points a lane (32 J >= P); tiles past T are absent.
template <int J, bool L1>
__global__ void __launch_bounds__(128) fps_warp_kernel(const float* __restrict__ points,
                                                       int* __restrict__ out, int T, int P,
                                                       int k) {
  extern __shared__ float smem[];  // per warp: xs[P], ys[P], zs[P]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x * (blockDim.x >> 5) + warp;
  if (tile >= T) return;  // the whole warp; nothing below waits on the block
  float* xs = smem + warp * 3 * P;
  float* ys = xs + P;
  float* zs = ys + P;
  const float* tp = points + static_cast<size_t>(tile) * P * 3;
  int* to = out + static_cast<size_t>(tile) * k;
  for (int e = lane; e < 3 * P; e += 32) {
    const float v = tp[e];
    const int i = e / 3, c = e - 3 * i;
    (c == 0 ? xs : c == 1 ? ys : zs)[i] = v;
  }
  __syncwarp();

  // A missing point (index >= P) keeps dmin = -1: min(-1, d) stays -1, and
  // its bits read as int are negative, below every real dmin's.
  float px[J], py[J], pz[J], dmin[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = lane + 32 * j;
    const bool ok = i < P;
    px[j] = ok ? xs[i] : 0.f;
    py[j] = ok ? ys[i] : 0.f;
    pz[j] = ok ? zs[i] : 0.f;
    dmin[j] = ok ? kBig : -1.f;
  }

  int last = 0;
#pragma unroll 1  // kept rolled: unrolled, the 16-point step ran several times slower
  for (int s = 1; s < k; ++s) {
    if (lane == 0) to[s - 1] = last;
    const float lx = xs[last], ly = ys[last], lz = zs[last];
    // The lane's largest dmin and its lowest index, by a branch-free tree.
    float bv[J];
    int bi[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float dx = px[j] - lx, dy = py[j] - ly, dz = pz[j] - lz;
      float d;
      if (L1) {
        d = __fadd_rn(__fadd_rn(fabsf(dx), fabsf(dy)), fabsf(dz));
      } else {
        d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      }
      dmin[j] = fminf(dmin[j], d);
      bv[j] = dmin[j];
      bi[j] = lane + 32 * j;
    }
    pair_tree<J / 2>(bv, bi);
    // Then the warp's: the max of the dmin bits (non-negative floats order
    // like their bits read as int), and the lowest index holding it.
    const int best = __reduce_max_sync(kFull, __float_as_int(bv[0]));
    last = __reduce_min_sync(kFull, __float_as_int(bv[0]) == best ? bi[0] : INT_MAX);
  }
  if (lane == 0) to[k - 1] = last;
}

// fps_tiles_kernel's static shared memory: its two per-warp winner buffers.
constexpr size_t kStaticSmem = 2 * 32 * (sizeof(float) + sizeof(int));

template <int ITEMS, bool L1>
__global__ void __launch_bounds__(1024) fps_tiles_kernel(const float* __restrict__ points,
                                 int* __restrict__ out, int P, int k) {
  extern __shared__ float smem[];  // xs[P], ys[P], zs[P]
  float* xs = smem;
  float* ys = xs + P;
  float* zs = ys + P;
  __shared__ float red_v[2][32];  // kStaticSmem bytes of static shared memory
  __shared__ int red_i[2][32];

  const float* tp = points + static_cast<size_t>(blockIdx.x) * P * 3;
  int* to = out + static_cast<size_t>(blockIdx.x) * k;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;

  float px[ITEMS], py[ITEMS], pz[ITEMS], dmin[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = tid + j * nt;
    px[j] = py[j] = pz[j] = 0.f;
    dmin[j] = kBig;
    if (i < P) {
      px[j] = tp[3 * i];
      py[j] = tp[3 * i + 1];
      pz[j] = tp[3 * i + 2];
      xs[i] = px[j];
      ys[i] = py[j];
      zs[i] = pz[j];
    }
  }
  __syncthreads();

  int last = 0;
  for (int s = 1; s < k; ++s) {
    if (tid == 0) to[s - 1] = last;
    const float lx = xs[last], ly = ys[last], lz = zs[last];
    float bv = -1.f;  // real dmin values are >= 0, so this never wins
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = tid + j * nt;
      if (i < P) {
        const float dx = px[j] - lx, dy = py[j] - ly, dz = pz[j] - lz;
        float d;
        if (L1) {
          d = __fadd_rn(__fadd_rn(fabsf(dx), fabsf(dy)), fabsf(dz));
        } else {
          d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                        __fmul_rn(dz, dz));
        }
        dmin[j] = fminf(dmin[j], d);
        if (dmin[j] > bv) {  // items run in index order: strict > keeps the lowest
          bv = dmin[j];
          bi = i;
        }
      }
    }
    warp_argmax(bv, bi);
    const int buf = s & 1;
    if (lane == 0) {
      red_v[buf][warp] = bv;
      red_i[buf][warp] = bi;
    }
    __syncthreads();
    // Every warp reduces the per-warp winners itself.  The buffer alternates
    // by step: a warp can only write this buffer again two steps later, after
    // the next barrier, by which time every warp has finished reading it.
    bv = lane < nwarps ? red_v[buf][lane] : -1.f;
    bi = lane < nwarps ? red_i[buf][lane] : INT_MAX;
    warp_argmax(bv, bi);
    last = bi;
  }
  if (tid == 0) to[k - 1] = last;
}

// Both launchers set the shared-memory attribute on every call whose static
// and dynamic shared memory together exceed the 48 KB a block gets without
// it.  No pc2im call does (512 points a tile at most: 24 KB); baseline-1's
// global tiles of 4096 points do (48 KB of points + kStaticSmem).  Setting a
// function attribute is no stream operation, so under a CUDA graph capture
// the capture records the launch alone.
template <int ITEMS, bool L1>
cudaError_t launch(const float* points, int* out, int T, int P, int k,
                   cudaStream_t stream) {
  const int per_thread = (P + ITEMS - 1) / ITEMS;
  const int threads = ((per_thread + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(3) * P * sizeof(float);
  if (smem + kStaticSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fps_tiles_kernel<ITEMS, L1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  fps_tiles_kernel<ITEMS, L1><<<T, threads, smem, stream>>>(points, out, P, k);
  return cudaGetLastError();
}

template <int J, bool L1>
cudaError_t launch_warps(const float* points, int* out, int T, int P, int k,
                         cudaStream_t stream) {
  // One warp a block while the tiles fit on the SMs, up to 4 beyond that.
  const int per_block = T >= 4 * 132 ? 4 : (T >= 2 * 132 ? 2 : 1);
  const size_t smem = static_cast<size_t>(per_block) * 3 * P * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fps_warp_kernel<J, L1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (T + per_block - 1) / per_block;
  fps_warp_kernel<J, L1><<<blocks, 32 * per_block, smem, stream>>>(points, out, T, P, k);
  return cudaGetLastError();
}

template <bool L1>
cudaError_t dispatch(const float* points, int* out, int T, int P, int k,
                     cudaStream_t stream) {
  if (P <= 32) return launch_warps<1, L1>(points, out, T, P, k, stream);
  if (P <= 64) return launch_warps<2, L1>(points, out, T, P, k, stream);
  if (P <= 128) return launch_warps<4, L1>(points, out, T, P, k, stream);
  if (P <= 256) return launch_warps<8, L1>(points, out, T, P, k, stream);
  if (P <= 512) return launch_warps<16, L1>(points, out, T, P, k, stream);
  if (P <= 1024) return launch_warps<32, L1>(points, out, T, P, k, stream);
  if (P <= 2048) return launch<2, L1>(points, out, T, P, k, stream);
  if (P <= 4096) return launch<4, L1>(points, out, T, P, k, stream);
  return launch<8, L1>(points, out, T, P, k, stream);
}

}  // namespace

// points: (T, P, 3) float32, contiguous, on `device`; out: (T, k) int32.
// 1 <= P <= 8192 and k >= 1 (checked by the Python wrapper as well).
PC2IM_API int pc2im_fps_tiles(int device, const float* points, int* out, int T,
                              int P, int k, int metric_l1, void* stream) {
  if (T < 1 || P < 1 || P > 8192 || k < 1) return cudaErrorInvalidValue;
  const int dev_err = pc2im_set_device(device);
  if (dev_err != 0) return dev_err;
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = metric_l1
                              ? dispatch<true>(points, out, T, P, k, s)
                              : dispatch<false>(points, out, T, P, k, s);
  return static_cast<int>(err);
}
