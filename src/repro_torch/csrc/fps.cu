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
// Bound on an H100 SXM: at the main-path shapes (8 clouds of 1024 points:
// T=32 tiles, P=256, k=64; then P=64, k=16) the work is ~10 f32 operations
// per point per step (5.2 Mop for stage 1) and ~100 KB of traffic, well
// under a microsecond at 67 TFLOP/s or 3.35 TB/s.  What sets the time is the
// chain of k dependent block-wide argmax reductions, i.e. latency.
//
// Design: one block per tile.  Each thread keeps its points and their dmin
// in registers for the whole loop (ITEMS points a thread, strided so that
// index order matches thread-then-item order); the tile's coordinates are
// also staged once in shared memory so every thread can read the last
// sample's coordinates with one broadcast load.  A step is a register
// min-update, a warp-shuffle argmax, one __syncthreads, and a redundant
// per-warp reduction of the per-warp winners from a double-buffered shared
// array, which removes the second barrier.  Ties go to the lower index; no
// atomics, so the result is deterministic.
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

template <int ITEMS, bool L1>
__global__ void __launch_bounds__(1024) fps_tiles_kernel(const float* __restrict__ points,
                                 int* __restrict__ out, int P, int k) {
  extern __shared__ float smem[];  // xs[P], ys[P], zs[P]
  float* xs = smem;
  float* ys = xs + P;
  float* zs = ys + P;
  __shared__ float red_v[2][32];
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

template <int ITEMS, bool L1>
cudaError_t launch(const float* points, int* out, int T, int P, int k,
                   cudaStream_t stream) {
  const int per_thread = (P + ITEMS - 1) / ITEMS;
  const int threads = ((per_thread + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(3) * P * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fps_tiles_kernel<ITEMS, L1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  fps_tiles_kernel<ITEMS, L1><<<T, threads, smem, stream>>>(points, out, P, k);
  return cudaGetLastError();
}

template <bool L1>
cudaError_t dispatch_items(const float* points, int* out, int T, int P, int k,
                           cudaStream_t stream) {
  if (P <= 1024) return launch<1, L1>(points, out, T, P, k, stream);
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
                              ? dispatch_items<true>(points, out, T, P, k, s)
                              : dispatch_items<false>(points, out, T, P, k, s);
  return static_cast<int>(err);
}
