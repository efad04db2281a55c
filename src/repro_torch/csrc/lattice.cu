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
// work (~9 operations per point scanned) is far below the f32 rate, so
// bytes set the bound.  Seg (8 clouds of 4096 points) gives T=64 tiles of
// K=128 centroids, P=512 points and T=64 of K=32, P=128; a flat query of
// M=1024 centroids among P=4096 points scans up to 4M pairs, still a few
// microseconds of f32 work at most.
//
// Design: one warp per centroid.  The warp walks the tile in chunks of 32
// points, one point a lane; __ballot_sync of the hit flags plus __popc of the
// lower lanes gives each hit its slot without a scan through memory.  The
// walk stops as soon as the row holds nsample hits, so dense neighbourhoods
// read only a prefix of the tile.  The tile's points are shared by its K
// centroids, so after the first warp they come from L1/L2.
#include "pc2im_capi.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

__global__ void lattice_tiles_kernel(const float* __restrict__ coords,
                                     const float* __restrict__ centroids,
                                     int* __restrict__ idx,
                                     unsigned char* __restrict__ mask, int T,
                                     int K, int P, int nsample, float L) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock +
                        (threadIdx.x >> 5);
  if (row >= static_cast<long long>(T) * K) return;  // whole warp leaves together
  const int lane = threadIdx.x & 31;
  const long long tile = row / K;
  const float* pts = coords + tile * P * 3;
  const float cx = centroids[row * 3];
  const float cy = centroids[row * 3 + 1];
  const float cz = centroids[row * 3 + 2];
  int* orow = idx + row * nsample;
  unsigned char* mrow = mask + row * nsample;

  int count = 0;  // hits so far, the same in every lane
  int first = 0;  // index of the first hit (0 while there is none)
  for (int base = 0; base < P && count < nsample; base += 32) {
    const int i = base + lane;
    bool hit = false;
    if (i < P) {
      const float d = __fadd_rn(
          __fadd_rn(fabsf(cx - pts[3 * i]), fabsf(cy - pts[3 * i + 1])),
          fabsf(cz - pts[3 * i + 2]));
      hit = d <= L;
    }
    const unsigned ballot = __ballot_sync(kFull, hit);
    if (count == 0 && ballot != 0u) first = base + __ffs(ballot) - 1;
    const int slot = count + __popc(ballot & ((1u << lane) - 1u));
    if (hit && slot < nsample) orow[slot] = i;
    count += __popc(ballot);
  }
  for (int s = lane; s < nsample; s += 32) {
    const bool filled = s < count;
    if (!filled) orow[s] = first;
    mrow[s] = filled ? 1 : 0;
  }
}

}  // namespace

// coords: (T, P, 3) float32; centroids: (T, K, 3) float32; idx: (T, K,
// nsample) int32; mask: (T, K, nsample) bool (one byte each).  All
// contiguous on `device`.  Indices are local to each tile.
PC2IM_API int pc2im_lattice_tiles(int device, const float* coords,
                                  const float* centroids, int* idx,
                                  unsigned char* mask, int T, int K, int P,
                                  int nsample, float L, void* stream) {
  if (T < 1 || K < 1 || P < 1 || nsample < 1) return cudaErrorInvalidValue;
  const int dev_err = pc2im_set_device(device);
  if (dev_err != 0) return dev_err;
  const long long rows = static_cast<long long>(T) * K;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  lattice_tiles_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      coords, centroids, idx, mask, T, K, P, nsample, L);
  return static_cast<int>(cudaGetLastError());
}
