// Delayed aggregation's gather and masked max-pool in one pass (paper C5:
// mlp -> group -> pool; core/grouping.aggregate_delayed).
//
// Replaces no TPU kernel.  The JAX package gathers (take_along_axis) and
// max-pools (where, max) in plain ops, and XLA fuses them on the TPU, so the
// grouped tensor never reaches HBM there.  The port had left them as
// separate PyTorch ops: take_along_dim broadcast its (B, M*S, 1) index to the
// output's shape and wrapped it with an int64 remainder, gather wrote the
// (B, M, S, C) grouped tensor, and masked_maxpool read it three more times
// (where, amax, then any and a second where): about 32 bytes of device
// memory an element, ~3.2 GB a batch at the benchmark's two SA stages.
//
// Same function as masked_maxpool(group_features(features, nbrs), mask), bit
// for bit: for row (b, m), out[c] is the max over the row's valid slots s of
// features[b, idx[b, m, s], c], taken as amax takes it (x replaces the
// running v when isnan(x) || x > v, so a NaN wins), started from the plain
// version's -1e30 sentinel where some slot of the row is padded (its where
// puts the sentinel there) and from -inf where none is (the max of the values
// alone); a row with no valid slot is +0.  Only the valid slots' indices are
// read, and each must lie in [0, N).  Of equal values the first slot's bits
// stay (of NaNs the last's), where amax keeps the one its own reduction order
// meets: the two differ only for a max that is both +0 and -0, or two NaNs of
// different bits, which the model's ReLU features never hold.
//
// Bound on an H100 SXM: bytes; a value costs one compare.  At the
// benchmark's shapes (level 1: 16 x 1024 or 64 x 256 rows of 32 slots, C =
// 128; level 2: 4096 rows, C = 256) the least device-memory traffic is each
// feature table read once (33.5 + 16.8 MB), the int32 index and the mask (2.6
// MB) and the (B, M, C) output (8.4 + 4.2 MB): ~66 MB, ~20 us at 3.35 TB/s.
// A table row is read by ~8 centroids; those re-reads (at most 268 + 134 MB,
// fewer where slots are padded) come from L2, which holds a cloud's table
// (2 MB for a seg level-1 cloud) many times over.
//
// Design: a warp a row (b, m).  Lane s loads idx[b, m, s] and mask[b, m, s]
// once (one coalesced 128 B load for S = 32); __ballot_sync compacts the
// valid slots and __shfl_sync broadcasts their indices, so a padded slot
// (which repeats the row's first hit) costs no row read.  The lanes cover
// the channels as float4, 16 B a lane, neighbouring lanes on neighbouring
// addresses: a C = 128 row is one 512 B transaction, C = 256 two float4 a
// lane.  U rows go out a step, their loads issued back to back through the
// read-only path and then max'd in slot order, so each warp keeps 8 (C <=
// 128) or 4 (wider) row reads of L2 latency in flight.  Scalar lanes serve a
// C that is not a multiple of 4 or a table that is not 16 B aligned.  Blocks
// of a few warps take consecutive rows, so the blocks in flight share one
// cloud's table in L2.  No shared memory and no atomics: each output element
// is one lane's max in slot order, deterministic.
//
// Launch: grid ceil(rows / (threads / 32)) blocks, one launch for both
// clouds and centroids.
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "pc2im_capi.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kSentinel = -1e30f;  // masked_maxpool's fill of a padded slot
constexpr int kMaxThreads = 256;

__device__ __forceinline__ float take(float v, float x) { return (isnan(x) || x > v) ? x : v; }

__device__ __forceinline__ float4 take(float4 v, float4 x) {
  return make_float4(take(v.x, x.x), take(v.y, x.y), take(v.z, x.z), take(v.w, x.w));
}

template <typename T>
__device__ __forceinline__ T splat(float v);

template <>
__device__ __forceinline__ float splat<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float4 splat<float4>(float v) {
  return make_float4(v, v, v, v);
}

// Vec4: float4 lanes (16 B a lane), else float; T is that type.  V: chunks
// of T a lane holds a pass over the channels; U: valid rows loaded a step.
// CT: chunks of T a row.
template <bool Vec4, int V, int U>
__global__ void __launch_bounds__(kMaxThreads)
    group_maxpool_kernel(const float* __restrict__ features, const int* __restrict__ idx,
                         const unsigned char* __restrict__ mask, float* __restrict__ out,
                         long long rows, int M, int N, int S, int CT) {
  using T = typename std::conditional<Vec4, float4, float>::type;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: a row is a warp's
  const T* table =
      reinterpret_cast<const T*>(features) + (row / M) * static_cast<long long>(N) * CT;
  const int* ridx = idx + row * S;
  const unsigned char* rmask = mask + row * S;
  T* orow = reinterpret_cast<T*>(out) + row * CT;

  // a padded slot puts the sentinel among the plain version's values
  bool padded = false;
  for (int g = 0; g < S; g += 32) {
    const int s = g + lane;
    padded |= __any_sync(kFull, s < S && rmask[s] == 0);
  }
  const T init = splat<T>(padded ? kSentinel : -INFINITY);

  for (int c0 = 0; c0 < CT; c0 += 32 * V) {
    T acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = init;
    bool any = false;
    for (int g = 0; g < S; g += 32) {
      const int s = g + lane;
      const bool ok = s < S && rmask[s] != 0;
      const int mine = ok ? ridx[s] : 0;
      unsigned bits = __ballot_sync(kFull, ok);  // the same in every lane
      any |= bits != 0;
      while (bits) {
        // the next U valid slots, lowest first; once they run out, a step
        // repeats the last one, whose value taken again changes nothing
        long long base[U];
        int slot = 0;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (bits) {
            slot = __ffs(bits) - 1;
            bits &= bits - 1;
          }
          base[u] = static_cast<long long>(__shfl_sync(kFull, mine, slot)) * CT;
        }
        // every load unconditional, so all U * V go out before the first max;
        // a lane past the row's end reads its last chunk and stores nothing
        T x[U][V];
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            x[u][v] = __ldg(table + base[u] + min(c0 + v * 32 + lane, CT - 1));
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = take(acc[v], x[u][v]);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = c0 + v * 32 + lane;
      if (c < CT) orow[c] = any ? acc[v] : splat<T>(0.f);
    }
  }
}

template <bool Vec4>
cudaError_t launch(unsigned blocks, int threads, cudaStream_t stream, const float* features,
                   const int* idx, const unsigned char* mask, float* out, long long rows, int M,
                   int N, int S, int CT) {
  if (CT > 32) {
    group_maxpool_kernel<Vec4, 2, 4><<<blocks, threads, 0, stream>>>(features, idx, mask, out,
                                                                     rows, M, N, S, CT);
  } else {
    group_maxpool_kernel<Vec4, 1, 8><<<blocks, threads, 0, stream>>>(features, idx, mask, out,
                                                                     rows, M, N, S, CT);
  }
  return cudaGetLastError();
}

}  // namespace

// features: (B, N, C) float32; idx: (B, M, S) int32; mask: (B, M, S) bool
// (one byte, 0 or 1); out: (B, M, C) float32.  All contiguous on `device`;
// rows = B * M.  vec4: the float4 lanes (C a multiple of 4, features and out
// 16 B aligned; refused otherwise); threads: a multiple of 32 up to 256.
PC2IM_API int pc2im_group_maxpool(int device, const float* features, const int* idx,
                                  const unsigned char* mask, float* out, long long rows, int M,
                                  int N, int S, int C, int vec4, int threads, void* stream) {
  if (rows < 1 || M < 1 || rows % M != 0 || N < 1 || S < 1 || C < 1) {
    return cudaErrorInvalidValue;
  }
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) return cudaErrorInvalidValue;
  if (vec4 && (C % 4 != 0 || reinterpret_cast<uintptr_t>(features) % 16 != 0 ||
               reinterpret_cast<uintptr_t>(out) % 16 != 0)) {
    return cudaErrorInvalidValue;
  }
  const int dev_err = pc2im_set_device(device);
  if (dev_err != 0) return dev_err;
  const long long warps = threads / 32;
  const long long blocks = (rows + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto nb = static_cast<unsigned>(blocks);
  const cudaError_t err =
      vec4 ? launch<true>(nb, threads, s, features, idx, mask, out, rows, M, N, S, C / 4)
           : launch<false>(nb, threads, s, features, idx, mask, out, rows, M, N, S, C);
  return static_cast<int>(err);
}
