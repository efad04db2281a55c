// k nearest neighbours of every query among its cloud's points (the
// segmentation model's 3-NN up-sampling).
//
// Replaces: knn3_pallas / _knn3_kernel, src/repro/kernels/knn3/kernel.py:47
// (body at :27).  Same function: for query q of cloud b, the k smallest
// distances to the P points of cloud b and their indices, as k rounds of
// min, first argmin and mask-out, i.e. the first k of a stable sort by
// (distance, index) among the finite distances; a slot that no finite
// distance fills reads (inf, 0).  Metric: squared L2 (dx*dx + dy*dy) + dz*dz,
// or L1 (|dx| + |dy|) + |dz|, with d = query - point, summed in that order
// with round-to-nearest intrinsics (and the build's --fmad=false), so
// distances are bitwise those of the plain version.
//
// Bound on an H100 SXM: at the main-path shapes (8 clouds; FP0: 1024
// queries among 256 points, FP1: 4096 among 1024; squared L2) a (query,
// point) pair needs 9 single f32 instructions (3 sub, 3 mul, 2 add, 1
// compare; no FMA, the build forbids contraction), 0.30 G for FP1.  Under
// L1 it needs 6: the abs is a free source modifier of the add.  The FP32
// pipes issue 33.5 T such instructions a second (132 SMs x 128 lanes x
// 1.98 GHz), so FP1 needs ~9.0 us and FP0 ~0.6 us, while the bytes (1.3 MB
// in and out) take ~0.4 us at 3.35 TB/s: instructions set the bound.
//
// Design: a group of G adjacent lanes (G a power of two, from the host's
// knn3_plan) serves R = 2 queries; lane g of the group takes the points g,
// g + G, g + 2G, ... of each staged chunk, so every lane holds R running
// top-k lists, sorted, in registers (k is a template parameter and R a
// constant, so the arrays are indexed with constants; R = 4 measured
// slower).  A chunk of the cloud's points is staged in shared memory by
// cp.async as one float4 (x, y, z, pad) a point, padded with +inf points to
// a whole number of steps (their distance is inf or NaN, which never
// enters a list), and a lane reads U points a step, each a single LDS.128
// that feeds R independent distance chains.
//
// Ties and overflow: a lane scans its points in index order and inserts a
// point only when its distance is strictly below the lane's k-th, behind
// every equal one, so each lane's list is the first k of a stable sort of
// its share; a distance of inf never enters, and an empty entry is (inf, 0).
// The group then merges its lists by shuffles in log2(G) rounds, ordering
// entries by (distance, index): the union's first k, the same in every lane.
//
// The insertion is a chain of selects, not a branch: lanes of one warp
// insert at different points, and a divergent insert (two nested branches a
// pair, each with its own reconvergence) measured slower on the card than
// selecting every slot of every pair.  A pair then costs ~20
// instructions, 8 of them the distance, about twice the bound's 9.
//
// Launch: block x covers QPB = (threads / G) * R queries of cloud
// x / qblocks; the grid is B * ceil(Q / QPB) blocks, one launch a call.
#include <math.h>

#include "pc2im_capi.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 1024;   // points staged a pass: 16 KB of float4
constexpr int kUnroll = 4;     // points a lane reads a step
constexpr int kMaxK = 8;
constexpr int kMaxThreads = 256;
constexpr int R = 2;           // queries a lane

// Asynchronous global-to-shared copies (cp.async): a thread issues all of
// its copies of a staging pass back to back, so the pass waits for one
// memory latency, not one for each element.
__device__ __forceinline__ void copy_async_4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copy_async_wait() { asm volatile("cp.async.wait_all;\n" ::); }

template <bool L1>
__device__ __forceinline__ float distance(float qx, float qy, float qz, float4 p) {
  const float dx = __fsub_rn(qx, p.x);
  const float dy = __fsub_rn(qy, p.y);
  const float dz = __fsub_rn(qz, p.z);
  if (L1) return __fadd_rn(__fadd_rn(fabsf(dx), fabsf(dy)), fabsf(dz));
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Insert (d, j) into the sorted list behind every entry <= d, without a
// branch: every slot takes a select, so a point with d >= bd[K-1] leaves the
// list as it was.  Slots are updated from the back, so each reads its own
// and its predecessor's old values.
template <int K>
__device__ __forceinline__ void insert_select(float (&bd)[K], int (&bi)[K], float d, int j) {
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    const bool before = d < bd[s - 1];
    const bool here = d < bd[s];
    bd[s] = before ? bd[s - 1] : (here ? d : bd[s]);
    bi[s] = before ? bi[s - 1] : (here ? j : bi[s]);
  }
  const bool first = d < bd[0];
  bd[0] = first ? d : bd[0];
  bi[0] = first ? j : bi[0];
}

__device__ __forceinline__ bool lex_less(float d, int j, float e, int i) {
  return d < e || (d == e && j < i);
}

// Insert (d, j) into a list sorted by (distance, index), dropping the last.
template <int K>
__device__ __forceinline__ void insert_lex(float (&bd)[K], int (&bi)[K], float d, int j) {
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (lex_less(d, j, bd[s - 1], bi[s - 1])) {
      bd[s] = bd[s - 1];
      bi[s] = bi[s - 1];
    } else if (lex_less(d, j, bd[s], bi[s])) {
      bd[s] = d;
      bi[s] = j;
    }
  }
  if (lex_less(d, j, bd[0], bi[0])) {
    bd[0] = d;
    bi[0] = j;
  }
}

template <int K, bool L1>
__global__ void __launch_bounds__(kMaxThreads)
    knn3_kernel(const float* __restrict__ queries, const float* __restrict__ points,
                int* __restrict__ idx, float* __restrict__ dist, int Q, int P, int log2g,
                int qblocks) {
  __shared__ float4 sp[kChunk];

  const int G = 1 << log2g;
  const int g = threadIdx.x & (G - 1);
  const int groups = blockDim.x >> log2g;
  const long long b = blockIdx.x / qblocks;
  const int q0 = (blockIdx.x % qblocks) * groups * R + (threadIdx.x >> log2g) * R;
  const float* cloud = points + b * P * 3;

  float qx[R], qy[R], qz[R];
  float bd[R][K];
  int bi[R][K];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int q = min(q0 + r, Q - 1);  // a missing query repeats the last and is not written
    const float* qp = queries + (b * Q + q) * 3;
    qx[r] = qp[0];
    qy[r] = qp[1];
    qz[r] = qp[2];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[r][s] = INFINITY;
      bi[r][s] = 0;
    }
  }

  const int step_pts = G * kUnroll;
  for (int base = 0; base < P; base += kChunk) {
    const int n = min(kChunk, P - base);
    const int padded = (n + step_pts - 1) / step_pts * step_pts;
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < padded; i += blockDim.x) {
      if (i < n) {  // x, y, z into the float4's first three words; w is never read
        const float* p = cloud + static_cast<long long>(base + i) * 3;
        copy_async_4(&sp[i].x, p);
        copy_async_4(&sp[i].y, p + 1);
        copy_async_4(&sp[i].z, p + 2);
      } else {
        sp[i] = make_float4(INFINITY, INFINITY, INFINITY, 0.f);
      }
    }
    copy_async_wait();
    __syncthreads();
    for (int i0 = g; i0 < padded; i0 += step_pts) {
      float4 pt[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) pt[u] = sp[i0 + u * G];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          insert_select<K>(bd[r], bi[r], distance<L1>(qx[r], qy[r], qz[r], pt[u]),
                           base + i0 + u * G);
        }
      }
    }
  }

  // merge the group's lists: after round `off`, lanes that differ only in
  // bits below 2 * off hold the same list
  for (int off = 1; off < G; off <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float od[K];
      int oi[K];
#pragma unroll
      for (int s = 0; s < K; ++s) {
        od[s] = __shfl_xor_sync(kFull, bd[r][s], off);
        oi[s] = __shfl_xor_sync(kFull, bi[r][s], off);
      }
#pragma unroll
      for (int s = 0; s < K; ++s) insert_lex<K>(bd[r], bi[r], od[s], oi[s]);
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int q = q0 + r;
    if (q < Q && g == r % G) {
      const long long row = b * Q + q;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        idx[row * K + s] = bi[r][s];
        dist[row * K + s] = bd[r][s];
      }
    }
  }
}

template <int K>
cudaError_t launch(bool l1, unsigned blocks, int threads, cudaStream_t stream,
                   const float* queries, const float* points, int* idx, float* dist, int Q,
                   int P, int log2g, int qblocks) {
  if (l1) {
    knn3_kernel<K, true><<<blocks, threads, 0, stream>>>(queries, points, idx, dist, Q, P, log2g,
                                                         qblocks);
  } else {
    knn3_kernel<K, false><<<blocks, threads, 0, stream>>>(queries, points, idx, dist, Q, P, log2g,
                                                          qblocks);
  }
  return cudaGetLastError();
}

}  // namespace

// queries: (B, Q, 3) float32; points: (B, P, 3) float32; idx: (B, Q, k)
// int32; dist: (B, Q, k) float32.  All contiguous on `device`.  1 <= k <= 8
// and P >= k; indices are local to each cloud.  The plan (kernels/knn3/
// kernel.py::knn3_plan): `group` lanes a query (a power of two up to 32),
// each lane carrying R = 2 queries, `threads` a block (a multiple of 32 and
// of `group`, up to 256); any other plan is refused.
PC2IM_API int pc2im_knn3(int device, const float* queries, const float* points, int* idx,
                         float* dist, int B, int Q, int P, int k, int l1, int group,
                         int threads, void* stream) {
  if (B < 1 || Q < 1 || P < k || k < 1 || k > kMaxK) return cudaErrorInvalidValue;
  if (group < 1 || group > 32 || (group & (group - 1)) != 0) return cudaErrorInvalidValue;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) return cudaErrorInvalidValue;
  const int dev_err = pc2im_set_device(device);
  if (dev_err != 0) return dev_err;
  const int log2g = __builtin_ctz(static_cast<unsigned>(group));
  const int per_block = (threads / group) * R;
  const int qblocks = (Q + per_block - 1) / per_block;
  const long long blocks = static_cast<long long>(B) * qblocks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto nb = static_cast<unsigned>(blocks);
  const bool m = l1 != 0;
  cudaError_t err;
  switch (k) {
    case 1: err = launch<1>(m, nb, threads, s, queries, points, idx, dist, Q, P, log2g, qblocks); break;
    case 2: err = launch<2>(m, nb, threads, s, queries, points, idx, dist, Q, P, log2g, qblocks); break;
    case 3: err = launch<3>(m, nb, threads, s, queries, points, idx, dist, Q, P, log2g, qblocks); break;
    case 4: err = launch<4>(m, nb, threads, s, queries, points, idx, dist, Q, P, log2g, qblocks); break;
    case 5: err = launch<5>(m, nb, threads, s, queries, points, idx, dist, Q, P, log2g, qblocks); break;
    case 6: err = launch<6>(m, nb, threads, s, queries, points, idx, dist, Q, P, log2g, qblocks); break;
    case 7: err = launch<7>(m, nb, threads, s, queries, points, idx, dist, Q, P, log2g, qblocks); break;
    default: err = launch<8>(m, nb, threads, s, queries, points, idx, dist, Q, P, log2g, qblocks); break;
  }
  return static_cast<int>(err);
}
