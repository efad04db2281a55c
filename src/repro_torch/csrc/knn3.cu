// k nearest neighbours of every query among its cloud's points (the
// segmentation model's 3-NN up-sampling).
//
// Replaces: knn3_pallas / _knn3_kernel, src/repro/kernels/knn3/kernel.py:47
// (body at :27).  Same function: for query q of cloud b, the k smallest
// distances to the P points of cloud b and their indices, as k rounds of
// min, first argmin and mask-out, i.e. the first k of a stable sort by
// (distance, index).  Metric: squared L2 (dx*dx + dy*dy) + dz*dz, or L1
// (|dx| + |dy|) + |dz|, with d = query - point, summed in that order with
// round-to-nearest intrinsics (and the build's --fmad=false), so distances
// are bitwise those of the plain version.
//
// Bound on an H100 SXM: at the main-path shapes (8 clouds; FP0: 1024
// queries among 256 points, FP1: 4096 among 1024) the work is ~9 f32
// operations per (query, point) pair, 0.30 Gop for FP1, ~4.5 us at
// 67 TFLOP/s, while the bytes (1.3 MB in and out) take ~0.4 us at
// 3.35 TB/s: operations set the bound.
//
// Design: one thread per query keeps its running top-k, sorted, in
// registers (k is a template parameter, so the arrays are indexed with
// constants; ptxas reports 32-40 registers and at most a 4-byte spill).
// A block of 128 queries stages its cloud's points through shared memory
// in chunks of 1024, and every thread reads each point with a broadcast
// load.  Points are scanned in index order and a point displaces
// an entry only when its distance is strictly smaller, so among equal
// distances the lower index stays ahead: exactly the reference's first
// argmin.  The batch is folded into the grid: block x covers queries
// [128 * (x % qblocks), ...) of cloud x / qblocks.
#include <math.h>

#include "pc2im_capi.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 1024;  // points staged a pass: 12 KB of shared memory
constexpr int kMaxK = 8;

template <int K, bool L1>
__global__ void __launch_bounds__(kThreads)
    knn3_kernel(const float* __restrict__ queries, const float* __restrict__ points,
                int* __restrict__ idx, float* __restrict__ dist, int Q, int P,
                int qblocks) {
  __shared__ float xs[kChunk];
  __shared__ float ys[kChunk];
  __shared__ float zs[kChunk];

  const long long b = blockIdx.x / qblocks;
  const int q = (blockIdx.x % qblocks) * kThreads + threadIdx.x;
  const bool active = q < Q;
  const float* cloud = points + b * P * 3;
  const long long row = b * Q + q;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = queries[row * 3];
    qy = queries[row * 3 + 1];
    qz = queries[row * 3 + 2];
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = 0;
  }

  for (int base = 0; base < P; base += kChunk) {
    const int n = min(kChunk, P - base);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float* p = cloud + static_cast<long long>(base + i) * 3;
      xs[i] = p[0];
      ys[i] = p[1];
      zs[i] = p[2];
    }
    __syncthreads();
    if (!active) continue;
    for (int i = 0; i < n; ++i) {
      const float dx = __fsub_rn(qx, xs[i]);
      const float dy = __fsub_rn(qy, ys[i]);
      const float dz = __fsub_rn(qz, zs[i]);
      float d;
      if (L1) {
        d = __fadd_rn(__fadd_rn(fabsf(dx), fabsf(dy)), fabsf(dz));
      } else {
        d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      }
      if (d < bd[K - 1]) {
        // insert behind every entry <= d; slots are updated from the back,
        // so each reads its own and its predecessor's old values
        const int j = base + i;
#pragma unroll
        for (int s = K - 1; s > 0; --s) {
          if (d < bd[s - 1]) {
            bd[s] = bd[s - 1];
            bi[s] = bi[s - 1];
          } else if (d < bd[s]) {
            bd[s] = d;
            bi[s] = j;
          }
        }
        if (d < bd[0]) {
          bd[0] = d;
          bi[0] = j;
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      idx[row * K + s] = bi[s];
      dist[row * K + s] = bd[s];
    }
  }
}

template <int K>
cudaError_t launch(bool l1, unsigned blocks, cudaStream_t stream, const float* queries,
                   const float* points, int* idx, float* dist, int Q, int P, int qblocks) {
  if (l1) {
    knn3_kernel<K, true><<<blocks, kThreads, 0, stream>>>(queries, points, idx, dist, Q, P,
                                                          qblocks);
  } else {
    knn3_kernel<K, false><<<blocks, kThreads, 0, stream>>>(queries, points, idx, dist, Q, P,
                                                           qblocks);
  }
  return cudaGetLastError();
}

}  // namespace

// queries: (B, Q, 3) float32; points: (B, P, 3) float32; idx: (B, Q, k)
// int32; dist: (B, Q, k) float32.  All contiguous on `device`.  1 <= k <= 8
// and P >= k; indices are local to each cloud.
PC2IM_API int pc2im_knn3(int device, const float* queries, const float* points, int* idx,
                         float* dist, int B, int Q, int P, int k, int l1, void* stream) {
  if (B < 1 || Q < 1 || P < k || k < 1 || k > kMaxK) return cudaErrorInvalidValue;
  const int dev_err = pc2im_set_device(device);
  if (dev_err != 0) return dev_err;
  const int qblocks = (Q + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(B) * qblocks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto nb = static_cast<unsigned>(blocks);
  const bool m = l1 != 0;
  cudaError_t err;
  switch (k) {
    case 1: err = launch<1>(m, nb, s, queries, points, idx, dist, Q, P, qblocks); break;
    case 2: err = launch<2>(m, nb, s, queries, points, idx, dist, Q, P, qblocks); break;
    case 3: err = launch<3>(m, nb, s, queries, points, idx, dist, Q, P, qblocks); break;
    case 4: err = launch<4>(m, nb, s, queries, points, idx, dist, Q, P, qblocks); break;
    case 5: err = launch<5>(m, nb, s, queries, points, idx, dist, Q, P, qblocks); break;
    case 6: err = launch<6>(m, nb, s, queries, points, idx, dist, Q, P, qblocks); break;
    case 7: err = launch<7>(m, nb, s, queries, points, idx, dist, Q, P, qblocks); break;
    default: err = launch<8>(m, nb, s, queries, points, idx, dist, Q, P, qblocks); break;
  }
  return static_cast<int>(err);
}
