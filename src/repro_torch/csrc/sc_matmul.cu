// Split-concatenate (SC) integer matmul, the paper's C4 SC-CIM engine.
//
// Replaces: sc_matmul_pallas / _sc_matmul_kernel,
// src/repro/kernels/sc_matmul/kernel.py:89 (body at :48).  Same function:
// x (M, K) and w (K, N) hold int32 values of `4 * n_planes` bits; both are
// split into 4-bit planes (low planes q >> 4i & 0xF in [0, 15], the top
// plane the arithmetic shift q >> 4(n-1) in [-8, 7]); every plane pair's dot
// product goes to an exact int32 sum per diagonal d = i + j; the f32 result
// is sum_d float(acc_d) * 16^d, combined in diagonal order from 0.0.
// The integer sums are exact, so the blocking below cannot change a bit.
//
// Bound on an H100 SXM: counted as int8 work, a W16A16 product is
// 16 * 2*M*K*N operations, ~19.6 G for one 8-cloud pointnet2-cls forward,
// ~10 us at the 1,979 TOP/s int8 tensor-core rate; per call the operands
// and output are at most a few MB.  The large calls are therefore bound by
// operations, the small ones (head, K=3) by launch latency.
//
// Design (simple, not yet near the bound): 32x32 output tiles, 256 threads,
// each thread 2x2 outputs with 2*n_planes-1 int32 diagonal accumulators
// apiece.  Operands are split into planes once, while the K-tile is staged in
// shared memory, and packed four planes to a 32-bit word: x's planes in byte
// order, w's reversed.  Then diagonal d is one __dp4a of x's word against
// w's word shifted by whole bytes, so a k step costs 2n-1 dp4a per output
// instead of n*n multiply-adds.  Tensor-core s8 MMA (mma.sync / wgmma) is
// later work.
#include "pc2im_capi.cuh"

namespace {

constexpr int kTile = 32;  // BM = BN = BK
constexpr int kThreads = 256;

// Planes of q packed in bytes: byte i = plane i, or byte n-1-i if reversed.
template <int NP>
__device__ __forceinline__ unsigned pack_planes(int q, bool reversed) {
  unsigned word = 0u;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int plane = (i < NP - 1) ? ((q >> (4 * i)) & 0xF) : (q >> (4 * i));
    const int pos = reversed ? (NP - 1 - i) : i;
    word |= (static_cast<unsigned>(plane) & 0xFFu) << (8 * pos);
  }
  return word;
}

// acc[d] += sum_{i+j=d} x_i * w_j for one k, with a = packed x planes and
// b = reversed packed w planes: shifting b by whole bytes lines up the pairs
// of one diagonal under dp4a (signed bytes, int32 accumulate).
template <int NP>
__device__ __forceinline__ void diag_dots(int (&acc)[2 * NP - 1], unsigned a,
                                          unsigned b) {
#pragma unroll
  for (int d = 0; d < 2 * NP - 1; ++d) {
    const int shift = d - (NP - 1);
    const unsigned bs = shift < 0 ? (b >> (-8 * shift)) : (b << (8 * shift));
    acc[d] = __dp4a(static_cast<int>(a), static_cast<int>(bs), acc[d]);
  }
}

template <int NP>
__device__ __forceinline__ float combine(const int (&acc)[2 * NP - 1]) {
  float out = 0.f;
#pragma unroll
  for (int d = 0; d < 2 * NP - 1; ++d) {
    out = __fadd_rn(out, __fmul_rn(__int2float_rn(acc[d]),
                                   static_cast<float>(1 << (4 * d))));
  }
  return out;
}

template <int NP>
__global__ void __launch_bounds__(kThreads)
    sc_matmul_kernel(const int* __restrict__ x, const int* __restrict__ w,
                     float* __restrict__ out, int M, int N, int K) {
  __shared__ unsigned xs[kTile][kTile + 1];  // [m][k]
  __shared__ unsigned ws[kTile][kTile + 1];  // [k][n]
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;

  int acc[2][2][2 * NP - 1];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int d = 0; d < 2 * NP - 1; ++d) acc[r][c][d] = 0;

  for (int k0 = 0; k0 < K; k0 += kTile) {
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile, c = e % kTile;
      const int gm = m0 + r, gk = k0 + c;
      const int q = (gm < M && gk < K) ? x[static_cast<size_t>(gm) * K + gk] : 0;
      xs[r][c] = pack_planes<NP>(q, false);
      const int wk = k0 + r, wn = n0 + c;
      const int v = (wk < K && wn < N) ? w[static_cast<size_t>(wk) * N + wn] : 0;
      ws[r][c] = pack_planes<NP>(v, true);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      const unsigned a0 = xs[ty][kk], a1 = xs[ty + 16][kk];
      const unsigned b0 = ws[kk][tx], b1 = ws[kk][tx + 16];
      diag_dots<NP>(acc[0][0], a0, b0);
      diag_dots<NP>(acc[0][1], a0, b1);
      diag_dots<NP>(acc[1][0], a1, b0);
      diag_dots<NP>(acc[1][1], a1, b1);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int gm = m0 + ty + 16 * r, gn = n0 + tx + 16 * c;
      if (gm < M && gn < N) out[static_cast<size_t>(gm) * N + gn] = combine<NP>(acc[r][c]);
    }
  }
}

template <int NP>
cudaError_t launch(const int* x, const int* w, float* out, int M, int N, int K,
                   cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  sc_matmul_kernel<NP><<<grid, kThreads, 0, stream>>>(x, w, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// x: (M, K) int32; w: (K, N) int32; out: (M, N) float32; all contiguous on
// `device`.  n_planes in 1..4 (4 for 16-bit operands, 2 for 8-bit).
PC2IM_API int pc2im_sc_matmul(int device, const int* x, const int* w,
                              float* out, int M, int N, int K, int n_planes,
                              void* stream) {
  if (M < 1 || N < 1 || K < 1 || (M + kTile - 1) / kTile > 65535)
    return cudaErrorInvalidValue;
  const int dev_err = pc2im_set_device(device);
  if (dev_err != 0) return dev_err;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n_planes) {
    case 1: err = launch<1>(x, w, out, M, N, K, s); break;
    case 2: err = launch<2>(x, w, out, M, N, K, s); break;
    case 3: err = launch<3>(x, w, out, M, N, K, s); break;
    case 4: err = launch<4>(x, w, out, M, N, K, s); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
