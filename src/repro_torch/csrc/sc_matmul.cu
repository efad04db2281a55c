// Split-concatenate (SC) integer matmul, the paper's C4 SC-CIM engine.
//
// Replaces: sc_matmul_pallas / _sc_matmul_kernel,
// src/repro/kernels/sc_matmul/kernel.py:89 (body at :48).  Same function:
// x (M, K) and w (K, N) hold int32 values of `4 * n_planes` bits, or
// 2^(4 * n_planes - 1), which a bf16 quantizer gives (see split4); both are
// split into 4-bit planes (low planes q >> 4i & 0xF in [0, 15], the top
// plane the arithmetic shift q >> 4(n-1) in [-8, 8]); every plane pair's dot
// product goes to an exact int32 sum per diagonal d = i + j; the f32 result
// is sum_d float(acc_d) * 16^d, combined in diagonal order from 0.0.
// The integer sums are exact, so neither the blocking nor the split of K
// below can change a bit.  They cannot overflow int32: a diagonal sums at
// most 4 plane pairs of products of magnitude <= 15 * 15 = 225 (the top
// plane lies in [-8, 8]), so |acc_d| <= 4 * 225 * K, which is 3.0e7 < 2^31 at the largest K of the
// LM configs (command-r-plus-104b's d_ff, 33792) and holds up to K = 2.38e6.
//
// Bound on an H100 SXM: counted as int8 work, a W16A16 product is
// 16 * 2*M*K*N operations, ~72 us for one 8-cloud pointnet2-seg forward at
// the 1,979 TOP/s int8 tensor-core rate; per call the operands and output
// are at most a few MB.  The large calls are bound by operations, the small
// ones (the M = 8 head, K = 3) by latency.  What holds the kernel back is
// not the MMAs but splitting the int32 operands into planes on the way in.
//
// Design: every plane fits in s8, so each plane pair is an exact
// s8 x s8 -> s32 tensor-core product: wgmma m64n32k32, A from registers,
// B from shared memory.  A block of 384 threads computes 64 x 64 output
// tiles: 2 consumer warpgroups of 64 x 32 outputs each keep 2*n_planes-1
// diagonal accumulator sets in registers (112 for W16A16) and issue
// n_planes^2 wgmma a k step of 32; 4 producer warps copy int32 tiles into a
// shared-memory ring by 16-byte cp.async (an x row that does not start
// 16-byte aligned, as at K = 3, 131 or 259, is copied from the aligned
// address below it and read at its offset; w falls back to 4-byte copies
// only where N % 4 != 0; everything past M, N, K and the end of x is zero,
// which is exact) and split each step once into plane-major s8 tiles.
// Full / empty named barriers pass the ring between the two sides, so the
// copies and splits of later steps overlap the MMAs.  Blocks are
// persistent, so loads run ahead across tiles.  Two kernels:
//  - resident (no split of K, w's planes fit in shared memory): a block
//    keeps one column tile of w, split once, for the whole of K and walks
//    row tiles; per step only x is copied and split.  Splitting w per step
//    instead would repeat it M / 64 times.
//  - streaming (everything else): a block walks output tiles, n fastest,
//    copying and splitting x and w every step.  Small M starves the grid
//    (the cls head has M = 8: a handful of tiles), so the wrapper may split
//    K: each share adds its int32 partial diagonals into a zeroed workspace
//    with atomics (exact in any order), and the last share of a tile to
//    finish, found by a counter, does the f32 combine.
// Plane tiles for ldmatrix (x) have rows padded to 48 bytes, so each
// 8-row matrix hits 32 distinct banks; w's planes are laid out in 8-row x
// 16-byte core matrices, K-major, as the wgmma descriptor without swizzle
// reads them.
#include "pc2im_capi.cuh"

#include <cstdint>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;                  // k elements a step: one wgmma k step
constexpr int kConsumers = 256;          // 2 warpgroups: columns 0-31 and 32-63
constexpr int kProducers = 128;          // two a row of the x tile
constexpr int kThreads = kConsumers + kProducers;
constexpr int kStages = 5;               // int32 staging ring
constexpr int kPlaneBufs = 3;            // split s8 tiles in flight
constexpr int kXRow = kBK + 4;           // ints a staged x row: 32, and up to 3
                                         // before them where it is unaligned
constexpr int kWRow = kBN + 4;           // ints a staged w row ([k][n]), padded
constexpr int kPlaneRow = kBK / 4 + 4;   // words an x plane row (32 s8 + 16 pad)
constexpr int kXPlaneWords = kBM * kPlaneRow;
constexpr int kWPlaneWords = kBN * kBK / 4;  // core-matrix layout, no padding
constexpr size_t kMaxSmem = 226 * 1024;   // dynamic shared memory a block, below
                                         // the card's 227 KB with the static rest
constexpr int kResMinRows = 1024;        // rows enough to keep w resident

// Named barriers (0 is __syncthreads): producers, consumers, then a full and
// an empty barrier per plane buffer.
constexpr int kBarProducers = 1;
constexpr int kBarConsumers = 2;
constexpr int kBarFull = 3;
constexpr int kBarEmpty = kBarFull + kPlaneBufs;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Copy BYTES (4 or 16) to shared dst, of which the first src_bytes come from
// src and the rest are zero.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Planes of four int32 values q0..q3 (consecutive k), one packed word per
// plane: byte c of word i is plane i of q_c.  The low planes are nibbles;
// the top plane is the low byte of the arithmetic shift q >> 4(NP-1), as the
// reference's split takes it, so it is exact for every q whose shift fits
// in s8: the 4*NP-bit range and beyond it, up to 2^(4*NP+3) - 1.  A bf16
// quantizer reaches 2^(4*NP-1) (its qmax 2^(4*NP-1) - 1 rounds up to a
// power of two in bf16), whose top plane is 8 where a sign-extended top
// nibble would be -8.
template <int NP>
__device__ __forceinline__ void split4(int q0, int q1, int q2, int q3, unsigned (&p)[NP]) {
  const unsigned b0 = __byte_perm(__byte_perm(q0, q1, 0x0040), __byte_perm(q2, q3, 0x0040),
                                  0x5410);  // byte 0 of each q
  unsigned b1 = 0u;
  if constexpr (NP > 3) {
    b1 = __byte_perm(__byte_perm(q0, q1, 0x0051), __byte_perm(q2, q3, 0x0051), 0x5410);
  }
#pragma unroll
  for (int i = 0; i < NP - 1; ++i) {
    const unsigned src = (i < 2) ? b0 : b1;
    p[i] = (src >> (4 * (i & 1))) & 0x0F0F0F0Fu;
  }
  constexpr int kTop = 4 * (NP - 1);
  p[NP - 1] = __byte_perm(__byte_perm(q0 >> kTop, q1 >> kTop, 0x0040),
                          __byte_perm(q2 >> kTop, q3 >> kTop, 0x0040), 0x5410);
}

// sum_d float(acc_d) * 16^d in diagonal order from 0.0.  float(acc_d) * 16^d
// is exact (a power-of-two scaling of a float below 2^21), so one fused
// multiply-add rounds exactly as the multiply and then the add would; and
// 0 + float(acc_0) is float(acc_0).
template <int NP>
__device__ __forceinline__ float combine(const int (&acc)[2 * NP - 1]) {
  float out = __int2float_rn(acc[0]);
#pragma unroll
  for (int d = 1; d < 2 * NP - 1; ++d)
    out = __fmaf_rn(__int2float_rn(acc[d]), static_cast<float>(1 << (4 * d)), out);
  return out;
}

// Offset in ints of x row `row`, step k0, within its 16-byte aligned copy.
__device__ __forceinline__ int x_offset(const int* x, int K, int row, int k0) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(x + static_cast<size_t>(row) * K + k0)
                           & 15) >> 2);
}

// Copy one k step of x (BM x BK int32, rows m0.., k0..) into xs; producers.
template <bool XVEC>
__device__ __forceinline__ void load_x(int* xs, const int* __restrict__ x, int M, int K, int m0,
                                       int k0, int ptid) {
  if constexpr (XVEC) {  // K % 4 == 0: whole 16-byte chunks lie in or out of range
#pragma unroll
    for (int it = 0; it < kBM * kBK / 4 / kProducers; ++it) {
      const int c = ptid + it * kProducers;
      const int r = c / (kBK / 4), kc = 4 * (c % (kBK / 4));
      const bool ok = m0 + r < M && k0 + kc < K;
      cp_async<16>(xs + r * kXRow + kc, ok ? x + static_cast<size_t>(m0 + r) * K + k0 + kc : x,
                   ok ? 16 : 0);
    }
  } else {  // 9 aligned chunks from the 16-byte boundary at or below the row's start
    const char* end = reinterpret_cast<const char*>(x + static_cast<size_t>(M) * K);
    for (int c = ptid; c < kBM * 9; c += kProducers) {
      const int r = c / 9, kc = 4 * (c % 9);
      const char* start = reinterpret_cast<const char*>(
          reinterpret_cast<uintptr_t>(x + static_cast<size_t>(m0 + r) * K + k0) &
          ~static_cast<uintptr_t>(15)) + 4 * kc;
      const long long left = end - start;
      const int bytes = m0 + r >= M || left <= 0 ? 0 : (left < 16 ? static_cast<int>(left) : 16);
      cp_async<16>(xs + r * kXRow + kc, start, bytes);
    }
  }
}

// Copy one k step of w (BK x BN int32, rows k0.., columns n0..) into ws.
template <bool WVEC>
__device__ __forceinline__ void load_w(int* ws, const int* __restrict__ w, int K, int N, int n0,
                                       int k0, int ptid) {
  if constexpr (WVEC) {  // N % 4 == 0
#pragma unroll
    for (int it = 0; it < kBK * kBN / 4 / kProducers; ++it) {
      const int c = ptid + it * kProducers;
      const int r = c / (kBN / 4), nc = 4 * (c % (kBN / 4));
      const bool ok = k0 + r < K && n0 + nc < N;
      cp_async<16>(ws + r * kWRow + nc, ok ? w + static_cast<size_t>(k0 + r) * N + n0 + nc : w,
                   ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < kBK * kBN / kProducers; ++it) {
      const int e = ptid + it * kProducers;
      const int r = e / kBN, nc = e % kBN;
      const bool ok = k0 + r < K && n0 + nc < N;
      cp_async<4>(ws + r * kWRow + nc, ok ? w + static_cast<size_t>(k0 + r) * N + n0 + nc : w,
                  ok ? 4 : 0);
    }
  }
}

// Split a staged x step into plane-major s8 xp[p][m][k], kPlaneRow words a
// row; producers only.  A producer takes 16 consecutive k of one row and
// stores 16 bytes a plane.  Past K the copy holds the next row: zero it.
template <int NP, bool XVEC>
__device__ __forceinline__ void split_x(const int* xs, unsigned* xp, const int* x, int K, int m0,
                                        int k0, int ptid) {
  static_assert(kBM * 2 == kProducers, "a producer takes half a row of a step");
  const int r = ptid >> 1, h = ptid & 1;
  int4 q[4];
  if constexpr (XVEC) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      q[c] = *reinterpret_cast<const int4*>(xs + r * kXRow + 16 * h + 4 * c);
  } else {
    const int kvalid = K - k0;
    const int* p = xs + r * kXRow + x_offset(x, K, m0 + r, k0) + 16 * h;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = 16 * h + 4 * c;
      q[c] = make_int4(k < kvalid ? p[4 * c] : 0, k + 1 < kvalid ? p[4 * c + 1] : 0,
                       k + 2 < kvalid ? p[4 * c + 2] : 0, k + 3 < kvalid ? p[4 * c + 3] : 0);
    }
  }
  unsigned pl[4][NP];
#pragma unroll
  for (int c = 0; c < 4; ++c) split4<NP>(q[c].x, q[c].y, q[c].z, q[c].w, pl[c]);
#pragma unroll
  for (int i = 0; i < NP; ++i)
    *reinterpret_cast<uint4*>(xp + (i * kBM + r) * kPlaneRow + 4 * h) =
        make_uint4(pl[0][i], pl[1][i], pl[2][i], pl[3][i]);
}

// Word of plane i, column n, k word kq (4 k) in w's core-matrix layout with
// kq4 k words a row: 8-column groups of kq4 / 4 core matrices of 128 bytes.
__device__ __forceinline__ int w_word(int i, int n, int kq, int kq4) {
  return ((i * (kBN / 8) + n / 8) * (kq4 / 4) + kq / 4) * 32 + (n & 7) * 4 + (kq & 3);
}

// Split a staged w step (4 consecutive k of a column a thread; a warp
// covers 8 columns x 4 k words) into its plane tiles; producers only.
template <int NP>
__device__ __forceinline__ void split_w(const int* ws, unsigned* wp, int ptid) {
  constexpr int kGroups = kBN * kBK / 4 / kProducers;
  int q[kGroups][4];
#pragma unroll
  for (int it = 0; it < kGroups; ++it) {
    const int g = ptid + it * kProducers;
    const int lane = g & 31, warp = g >> 5;
    const int* col = ws + 4 * ((warp / (kBN / 8)) * 4 + (lane >> 3)) * kWRow +
                     (warp % (kBN / 8)) * 8 + (lane & 7);
#pragma unroll
    for (int c = 0; c < 4; ++c) q[it][c] = col[c * kWRow];
  }
#pragma unroll
  for (int it = 0; it < kGroups; ++it) {
    const int g = ptid + it * kProducers;
    const int lane = g & 31, warp = g >> 5;
    const int n = (warp % (kBN / 8)) * 8 + (lane & 7);
    const int kq = (warp / (kBN / 8)) * 4 + (lane >> 3);
    unsigned p[NP];
    split4<NP>(q[it][0], q[it][1], q[it][2], q[it][3], p);
#pragma unroll
    for (int i = 0; i < NP; ++i) wp[w_word(i, n, kq, kBK / 4)] = p[i];
  }
}

// Four 8 x 16-byte matrices from shared memory, one register each (lanes
// 8i..8i+7 give the row addresses of matrix i).
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const unsigned* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row))
               : "memory");
}

// wgmma shared-memory descriptor, no swizzle: core matrices adjacent in K
// 128 bytes apart, 8-row groups `sbo` bytes apart.
__device__ __forceinline__ unsigned long long make_desc(const void* p, unsigned sbo) {
  const unsigned long long a = smem_addr(p);
  return ((a & 0x3FFFFull) >> 4) | (static_cast<unsigned long long>(128 >> 4) << 16) |
         (static_cast<unsigned long long>((sbo >> 4) & 0x3FFF) << 32);
}

// d (64 x 32 s32, this warpgroup's) += A (64 x 32 s8, registers) * B (32 x 32
// s8, shared memory).
__device__ __forceinline__ void wgmma_s8(int (&d)[16], const unsigned (&a)[4],
                                         unsigned long long desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// One k step of a consumer warpgroup: A fragments of x's planes by ldmatrix
// (rows 16 wq.., then the x buffer may be released), n_planes^2 wgmma into
// the diagonal accumulators, and the wait for them; the empty asm keeps the
// compiler from touching accumulators or A registers while wgmma runs.
template <int NP>
__device__ __forceinline__ void mma_step(int (&acc)[2 * NP - 1][16], const unsigned* xp,
                                         const unsigned* wk, int kq4, int wq, int release_bar) {
  const int lane = threadIdx.x & 31;
  const int mat = lane >> 3, row8 = lane & 7;
  unsigned a[NP][4];
#pragma unroll
  for (int i = 0; i < NP; ++i)
    ldmatrix_x4(a[i], xp + (i * kBM + wq * 16 + (mat & 1) * 8 + row8) * kPlaneRow + (mat >> 1) * 4);
  if (release_bar >= 0) bar_arrive(release_bar, kThreads);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int j = 0; j < NP; ++j)
      wgmma_s8(acc[i + j], a[i], make_desc(wk + w_word(j, 0, 0, kq4), 32 * kq4));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int d = 0; d < 2 * NP - 1; ++d)
#pragma unroll
    for (int r = 0; r < 16; ++r) asm volatile("" : "+r"(acc[d][r])::"memory");
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r])::"memory");
}

template <int NP>
__device__ __forceinline__ void zero(int (&acc)[2 * NP - 1][16]) {
#pragma unroll
  for (int d = 0; d < 2 * NP - 1; ++d)
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[d][r] = 0;
}

// Write a tile from the consumers' registers: the f32 combine directly, or
// (split K, ws not null) the partial diagonals into ws and, from the tile's
// last share (found by `counter`), the combine of their sums.  Register
// 4 jn + r of warp wq of warpgroup wg: row 16 wq + g (+8 for r >= 2),
// column 32 wg + 8 jn + 2t + (r & 1).
template <int NP>
__device__ __forceinline__ void store_tile(const int (&acc)[2 * NP - 1][16],
                                           float* __restrict__ out, int* __restrict__ ws,
                                           int* counter, int splits, int M, int N, int m0, int n0,
                                           int wg, int wq) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t plane = static_cast<size_t>(M) * N;
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gm = m0 + wq * 16 + g + (r >= 2 ? 8 : 0);
      const int gn = n0 + wg * 32 + jn * 8 + 2 * t + (r & 1);
      if (gm < M && gn < N) {
        if (ws == nullptr) {
          int a[2 * NP - 1];
#pragma unroll
          for (int d = 0; d < 2 * NP - 1; ++d) a[d] = acc[d][4 * jn + r];
          out[static_cast<size_t>(gm) * N + gn] = combine<NP>(a);
        } else {
#pragma unroll
          for (int d = 0; d < 2 * NP - 1; ++d)
            atomicAdd(ws + d * plane + static_cast<size_t>(gm) * N + gn, acc[d][4 * jn + r]);
        }
      }
    }
  if (ws == nullptr) return;
  __threadfence();
  bar_sync(kBarConsumers, kConsumers);
  __shared__ int last;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == splits - 1;
  bar_sync(kBarConsumers, kConsumers);
  if (!last) return;
  __threadfence();
  for (int e = threadIdx.x; e < kBM * kBN; e += kConsumers) {
    const int gm = m0 + e / kBN, gn = n0 + e % kBN;
    if (gm < M && gn < N) {
      int a[2 * NP - 1];
#pragma unroll
      for (int d = 0; d < 2 * NP - 1; ++d)
        a[d] = __ldcg(ws + d * plane + static_cast<size_t>(gm) * N + gn);
      out[static_cast<size_t>(gm) * N + gn] = combine<NP>(a);
    }
  }
}

// ---- streaming kernel -------------------------------------------------------

// The units of work: output tiles, n fastest (neighbouring units share x
// rows), then the shares of K.  A share holds `per` k steps, the last one
// the rest.
struct Units {
  int M, N, K, tiles_n, tiles, count, k_steps, per;

  __device__ Units(int M_, int N_, int K_, int splits)
      : M(M_), N(N_), K(K_), tiles_n((N_ + kBN - 1) / kBN) {
    tiles = ((M + kBM - 1) / kBM) * tiles_n;
    count = tiles * splits;
    k_steps = (K + kBK - 1) / kBK;
    per = (k_steps + splits - 1) / splits;
  }
  __device__ int steps(int u) const { return min(per, k_steps - (u / tiles) * per); }
  __device__ int m0(int u) const { return ((u % tiles) / tiles_n) * kBM; }
  __device__ int n0(int u) const { return ((u % tiles) % tiles_n) * kBN; }
  __device__ int k0(int u, int kt) const { return ((u / tiles) * per + kt) * kBK; }
};

// A block's place in its flat sequence of k steps.
struct Cursor {
  int unit, kt, nk;

  __device__ explicit Cursor(const Units& us) : unit(blockIdx.x), kt(0), nk(0) {
    if (unit < us.count) nk = us.steps(unit);
  }
  // Move one step on; true where that ends the unit.
  __device__ bool advance(const Units& us) {
    if (++kt < nk) return false;
    unit += gridDim.x;
    kt = 0;
    nk = unit < us.count ? us.steps(unit) : 0;
    return true;
  }
};

constexpr int kRawInts = kBM * kXRow + kBK * kWRow;  // a stage: x, then w
template <int NP>
__host__ __device__ constexpr int plane_buf_words() { return NP * (kXPlaneWords + kWPlaneWords); }

template <int NP>
constexpr size_t smem_bytes() {
  return sizeof(int) * (static_cast<size_t>(kStages) * kRawInts +
                        static_cast<size_t>(kPlaneBufs) * plane_buf_words<NP>());
}

// ws: null for a single share of K; else (2*NP-1) * M * N int32 partial
// diagonals followed by one arrival counter a tile, all zero on entry.
template <int NP, bool XVEC, bool WVEC>
__global__ void __launch_bounds__(kThreads, 1)
    sc_matmul_kernel(const int* __restrict__ x, const int* __restrict__ w,
                     float* __restrict__ out, int* __restrict__ ws, int M, int N, int K,
                     int splits) {
  extern __shared__ __align__(128) int smem[];
  int* raw = smem;                                                            // [stage][kRawInts]
  unsigned* planes = reinterpret_cast<unsigned*>(smem + kStages * kRawInts);  // [buf][x, w planes]
  const Units us(M, N, K, splits);
  int total = 0;  // k steps of this block, over all its units
  for (int u = blockIdx.x; u < us.count; u += gridDim.x) total += us.steps(u);

  if (threadIdx.x >= kConsumers) {  // producers
    const int ptid = threadIdx.x - kConsumers;
    Cursor ld(us), sp(us);  // the step to copy next, the step to split next
    for (int f = 0; f < total + kStages - 1; ++f) {
      if (f >= kStages - 1) {  // split step s = f - (kStages - 1)
        const int s = f - (kStages - 1);
        cp_async_wait<kStages - 2>();
        // Step s's ints have landed for every producer, and every producer
        // has split step s-1, whose ring slot the copy below reuses.
        bar_sync(kBarProducers, kProducers);
        if (f < total) {
          int* stage = raw + (f % kStages) * kRawInts;
          load_x<XVEC>(stage, x, M, K, us.m0(ld.unit), us.k0(ld.unit, ld.kt), ptid);
          load_w<WVEC>(stage + kBM * kXRow, w, K, N, us.n0(ld.unit), us.k0(ld.unit, ld.kt), ptid);
          ld.advance(us);
        }
        cp_async_commit();
        const int buf = s % kPlaneBufs;
        if (s >= kPlaneBufs) bar_sync(kBarEmpty + buf, kThreads);  // consumers done with it
        const int* stage = raw + (s % kStages) * kRawInts;
        unsigned* xp = planes + buf * plane_buf_words<NP>();
        split_x<NP, XVEC>(stage, xp, x, K, us.m0(sp.unit), us.k0(sp.unit, sp.kt), ptid);
        split_w<NP>(stage + kBM * kXRow, xp + NP * kXPlaneWords, ptid);
        sp.advance(us);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
        bar_arrive(kBarFull + buf, kThreads);
      } else {  // the first stages
        if (f < total) {
          int* stage = raw + f * kRawInts;
          load_x<XVEC>(stage, x, M, K, us.m0(ld.unit), us.k0(ld.unit, ld.kt), ptid);
          load_w<WVEC>(stage + kBM * kXRow, w, K, N, us.n0(ld.unit), us.k0(ld.unit, ld.kt), ptid);
          ld.advance(us);
        }
        cp_async_commit();
      }
    }
    cp_async_wait<0>();
    return;
  }

  const int wg = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3;
  int acc[2 * NP - 1][16];
  zero<NP>(acc);
  Cursor cu(us);
  for (int f = 0; f < total; ++f) {
    const int buf = f % kPlaneBufs;
    bar_sync(kBarFull + buf, kThreads);
    const unsigned* xp = planes + buf * plane_buf_words<NP>();
    mma_step<NP>(acc, xp, xp + NP * kXPlaneWords + w_word(0, 32 * wg, 0, kBK / 4), kBK / 4, wq, -1);
    // wgmma has read this buffer's w planes; the producers wait for it only
    // where they fill it again.
    if (f + kPlaneBufs < total) bar_arrive(kBarEmpty + buf, kThreads);
    const int unit = cu.unit;
    if (cu.advance(us)) {
      store_tile<NP>(acc, out, ws, ws + (2 * NP - 1) * static_cast<size_t>(M) * N + unit % us.tiles,
                     splits, M, N, us.m0(unit), us.n0(unit), wg, wq);
      zero<NP>(acc);
    }
  }
}

// ---- resident kernel -----------------------------------------------------------

constexpr int kResRawInts = kBM * kXRow;  // a stage: x only

template <int NP>
size_t res_smem_bytes(int K) {
  const int kp = (K + kBK - 1) / kBK * kBK;
  return sizeof(int) * (static_cast<size_t>(kStages) * kResRawInts +
                        static_cast<size_t>(kPlaneBufs) * NP * kXPlaneWords +
                        static_cast<size_t>(NP) * kBN * (kp / 4));
}

// gridDim.x = tiles_n * per_n: block b keeps column tile b / per_n of w and
// walks row tiles b % per_n, + per_n, ...
template <int NP, bool XVEC>
__global__ void __launch_bounds__(kThreads, 1)
    sc_matmul_res_kernel(const int* __restrict__ x, const int* __restrict__ w,
                         float* __restrict__ out, int M, int N, int K, int per_n) {
  extern __shared__ __align__(128) int smem[];
  const int kq4 = (K + kBK - 1) / kBK * (kBK / 4);  // k words of a resident plane row
  int* raw = smem;                                                               // [stage][kResRawInts]
  unsigned* planes = reinterpret_cast<unsigned*>(smem + kStages * kResRawInts);  // [buf][NP][x plane]
  unsigned* wr = planes + kPlaneBufs * NP * kXPlaneWords;                        // w, core matrices
  const int n0 = (blockIdx.x / per_n) * kBN;
  const int tiles_m = (M + kBM - 1) / kBM;
  const int k_steps = kq4 / (kBK / 4);
  int units = 0;
  for (int mt = blockIdx.x % per_n; mt < tiles_m; mt += per_n) ++units;
  const int total = units * k_steps;
  const int ptid = threadIdx.x - kConsumers;

  // The producers start the first copies of x; then every thread splits
  // w's planes for this column tile, once.
  int lm = blockIdx.x % per_n, lk = 0;  // the row tile and step to copy next
  if (ptid >= 0) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < total) {
        load_x<XVEC>(raw + s * kResRawInts, x, M, K, lm * kBM, lk * kBK, ptid);
        if (++lk == k_steps) { lk = 0; lm += per_n; }
      }
      cp_async_commit();
    }
  }
  auto put = [&](int n, int kq, int q0, int q1, int q2, int q3) {
    unsigned p[NP];
    split4<NP>(q0, q1, q2, q3, p);
#pragma unroll
    for (int i = 0; i < NP; ++i) wr[w_word(i, n, kq, kq4)] = p[i];
  };
  if (N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) {
    // 4 consecutive k of 4 neighbouring columns a thread, 16-byte loads
    for (int e = threadIdx.x; e < (kBN / 4) * kq4; e += kThreads) {
      const int n4 = e % (kBN / 4), kq = e / (kBN / 4);
      int4 v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = 4 * kq + c;
        v[c] = (k < K && n0 + 4 * n4 < N)
                   ? *reinterpret_cast<const int4*>(w + static_cast<size_t>(k) * N + n0 + 4 * n4)
                   : make_int4(0, 0, 0, 0);
      }
      put(4 * n4, kq, v[0].x, v[1].x, v[2].x, v[3].x);
      put(4 * n4 + 1, kq, v[0].y, v[1].y, v[2].y, v[3].y);
      put(4 * n4 + 2, kq, v[0].z, v[1].z, v[2].z, v[3].z);
      put(4 * n4 + 3, kq, v[0].w, v[1].w, v[2].w, v[3].w);
    }
  } else {  // 4 consecutive k of one column a thread
    for (int e = threadIdx.x; e < kBN * kq4; e += kThreads) {
      const int n = e % kBN, kq = e / kBN;
      int q[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = 4 * kq + c;
        q[c] = (k < K && n0 + n < N) ? w[static_cast<size_t>(k) * N + n0 + n] : 0;
      }
      put(n, kq, q[0], q[1], q[2], q[3]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
  __syncthreads();

  if (ptid >= 0) {  // producers
    int sm = blockIdx.x % per_n, sk = 0;  // the row tile and step to split next
    for (int f = 0; f < total; ++f) {
      cp_async_wait<kStages - 2>();
      // Step f's ints have landed for every producer, and every producer has
      // split step f-1, whose ring slot the next copy reuses.
      bar_sync(kBarProducers, kProducers);
      if (f + kStages - 1 < total) {
        load_x<XVEC>(raw + ((f + kStages - 1) % kStages) * kResRawInts, x, M, K, lm * kBM,
                     lk * kBK, ptid);
        if (++lk == k_steps) { lk = 0; lm += per_n; }
      }
      cp_async_commit();
      const int buf = f % kPlaneBufs;
      if (f >= kPlaneBufs) bar_sync(kBarEmpty + buf, kThreads);  // consumers done with it
      split_x<NP, XVEC>(raw + (f % kStages) * kResRawInts, planes + buf * NP * kXPlaneWords, x,
                        K, sm * kBM, sk * kBK, ptid);
      if (++sk == k_steps) { sk = 0; sm += per_n; }
      bar_arrive(kBarFull + buf, kThreads);
    }
    cp_async_wait<0>();
    return;
  }

  const int wg = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3;
  int acc[2 * NP - 1][16];
  zero<NP>(acc);
  int mt = blockIdx.x % per_n, kt = 0;
  for (int f = 0; f < total; ++f) {
    const int buf = f % kPlaneBufs;
    bar_sync(kBarFull + buf, kThreads);
    // The x planes are released once in registers (where they are refilled).
    mma_step<NP>(acc, planes + buf * NP * kXPlaneWords, wr + w_word(0, 32 * wg, 8 * kt, kq4),
                 kq4, wq, f + kPlaneBufs < total ? kBarEmpty + buf : -1);
    if (++kt == k_steps) {
      store_tile<NP>(acc, out, nullptr, nullptr, 1, M, N, mt * kBM, n0, wg, wq);
      zero<NP>(acc);
      kt = 0;
      mt += per_n;
    }
  }
}

// ---- launch -------------------------------------------------------------------------

// Set the kernel's shared-memory limit and read the card's SM count, once a
// device (a race only stores the same numbers twice).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int device, int (&sms)[64]) {
  if (sms[device] != 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kMaxSmem));
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
}

template <int NP, bool XVEC, bool WVEC>
cudaError_t launch(int device, const int* x, const int* w, float* out, int* ws, int M, int N,
                   int K, int splits, cudaStream_t stream) {
  auto kernel = sc_matmul_kernel<NP, XVEC, WVEC>;
  static int sms[64] = {};
  const cudaError_t err = prepare(kernel, device, sms);
  if (err != cudaSuccess) return err;
  const long long units = static_cast<long long>((M + kBM - 1) / kBM) *
                          ((N + kBN - 1) / kBN) * splits;
  const int grid = static_cast<int>(units < sms[device] ? units : sms[device]);
  kernel<<<grid, kThreads, smem_bytes<NP>(), stream>>>(x, w, out, ws, M, N, K, splits);
  return cudaGetLastError();
}

template <int NP, bool XVEC>
cudaError_t launch_res(int device, const int* x, const int* w, float* out, int M, int N, int K,
                       cudaStream_t stream) {
  auto kernel = sc_matmul_res_kernel<NP, XVEC>;
  static int sms[64] = {};
  const cudaError_t err = prepare(kernel, device, sms);
  if (err != cudaSuccess) return err;
  const int tiles_n = (N + kBN - 1) / kBN, tiles_m = (M + kBM - 1) / kBM;
  const int per_n = max(1, min(tiles_m, sms[device] / tiles_n));
  kernel<<<tiles_n * per_n, kThreads, res_smem_bytes<NP>(K), stream>>>(x, w, out, M, N, K, per_n);
  return cudaGetLastError();
}

template <int NP>
cudaError_t dispatch(int device, const int* x, const int* w, float* out, int* ws, int M, int N,
                     int K, int splits, cudaStream_t stream) {
  // x rows start 16-byte aligned, or are copied from the boundary below;
  // w takes 16-byte copies only where every row starts aligned.
  const bool xvec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool wvec = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  // Keep w resident where it fits and there are rows enough to reuse it.
  if (ws == nullptr && M >= kResMinRows && res_smem_bytes<NP>(K) <= kMaxSmem) {
    return xvec ? launch_res<NP, true>(device, x, w, out, M, N, K, stream)
                : launch_res<NP, false>(device, x, w, out, M, N, K, stream);
  }
  if (xvec && wvec) return launch<NP, true, true>(device, x, w, out, ws, M, N, K, splits, stream);
  if (xvec) return launch<NP, true, false>(device, x, w, out, ws, M, N, K, splits, stream);
  if (wvec) return launch<NP, false, true>(device, x, w, out, ws, M, N, K, splits, stream);
  return launch<NP, false, false>(device, x, w, out, ws, M, N, K, splits, stream);
}

}  // namespace

// x: (M, K) int32; w: (K, N) int32; out: (M, N) float32; all contiguous on
// `device`.  n_planes in 1..4 (4 for 16-bit operands, 2 for 8-bit).
// splits: how many shares of K each output tile's sum is cut into, none of
// them empty.  With splits > 1, ws holds ws_len >= (2*n_planes-1)*M*N +
// tiles int32 zeros, tiles = ceil(M/64) * ceil(N/64).
PC2IM_API int pc2im_sc_matmul(int device, const int* x, const int* w, float* out, int* ws,
                              long long ws_len, int M, int N, int K, int n_planes,
                              int splits, void* stream) {
  if (M < 1 || N < 1 || K < 1 || splits < 1 || n_planes < 1 || n_planes > 4 || device < 0 ||
      device >= 64)
    return cudaErrorInvalidValue;
  const int k_steps = (K + kBK - 1) / kBK;
  const int per = (k_steps + splits - 1) / splits;
  if (splits > k_steps || (splits - 1) * per >= k_steps)
    return cudaErrorInvalidValue;  // an empty share
  const long long tiles =
      static_cast<long long>((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  if (tiles * splits > (1LL << 31) - 1) return cudaErrorInvalidValue;
  if (splits > 1 &&
      (ws == nullptr || ws_len < (2LL * n_planes - 1) * M * N + tiles))
    return cudaErrorInvalidValue;
  const int dev_err = pc2im_set_device(device);
  if (dev_err != 0) return dev_err;
  auto s = static_cast<cudaStream_t>(stream);
  int* wsp = splits > 1 ? ws : nullptr;
  cudaError_t err;
  switch (n_planes) {
    case 1: err = dispatch<1>(device, x, w, out, wsp, M, N, K, splits, s); break;
    case 2: err = dispatch<2>(device, x, w, out, wsp, M, N, K, splits, s); break;
    case 3: err = dispatch<3>(device, x, w, out, wsp, M, N, K, splits, s); break;
    default: err = dispatch<4>(device, x, w, out, wsp, M, N, K, splits, s); break;
  }
  return static_cast<int>(err);
}
