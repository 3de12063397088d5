// CIVS ROI filter: distance of every candidate to its seed's ROI center,
// the radius + validity mask, and the -dist scores top-delta ranks.
//
// Replaces the TPU kernel `roi_filter_pallas` (src/repro/kernels/
// roi_filter.py, `_roi_kernel`). For candidate rows vc (B*C, d) f32, where
// the C rows of seed b sit at rows [b*C, (b+1)*C), centers (B, d), radii
// (B,) and a validity mask (B*C,) it writes dist = sqrt(sum((v - c)^2)) (the
// DIRECT form, not the |v|^2 + |c|^2 - 2vc expansion), ok = valid & (dist
// <= r) and neg = -dist where ok, else -inf. The seed batch, which the JAX
// package vmapped, is the row blocks of one launch.
//
// What bounds it on an H100: bytes. Each row is read once (d f32) and three
// scalars are written; at the main path's B = 32, C = 7168, d = 128 that is
// ~118 MB, ~35 us at 3.35 TB/s, against 3 flops per element. The design is
// one warp per row: the 32 lanes read the row with coalesced loads, keep a
// private sum of squares and combine it with a butterfly of shuffles, so
// no shared memory and no second pass are needed. The sum is taken in the
// pinned order of kernels/ref.py, so the kernel gives its plain version's
// bits. Rows whose valid flag is
// false may hold NaN or Inf: they come out ok = false, neg = -inf, and no
// other row reads them. The candidate rows may be stored as f32 or bf16
// (the centre and radii are f32): a bf16 element is widened to f32 as it
// is read, exactly, so on bf16 rows the kernel gives the bits it gives on
// the upcast rows.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "static_smem.cuh"

namespace {

constexpr int kThreads = 256;

template <class T>
__global__ void roi_filter_kernel(const T* __restrict__ vc,
                                  const float* __restrict__ center,
                                  const float* __restrict__ radius,
                                  const uint8_t* __restrict__ valid,
                                  float* __restrict__ dist,
                                  uint8_t* __restrict__ ok,
                                  float* __restrict__ neg,
                                  long rows, int per_seed, int d) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * (blockDim.x / 32) +
                   (threadIdx.x >> 5);
  if (row >= rows) return;
  const long b = row / per_seed;
  const T* v = vc + row * d;
  const float* c = center + b * d;
  // lane l: the running sum of the squares at t = l, l + 32, ... (the
  // pinned order of kernels/ref.py), then the butterfly over the lanes
  float acc = 0.f;
  for (int t = lane; t - lane < d; t += 32) {
    float sq = 0.f;
    if (t < d) {
      const float diff =
          __fsub_rn(repro_kernels::load_f32(v + t), c[t]);
      sq = __fmul_rn(diff, diff);
    }
    acc = t == lane ? sq : __fadd_rn(acc, sq);
  }
  acc = repro_kernels::warp_tree32(acc);
  if (lane == 0) {
    const float dd = sqrtf(acc);
    const bool keep = valid[row] != 0 && dd <= radius[b];
    dist[row] = dd;
    ok[row] = keep ? 1 : 0;
    neg[row] = keep ? -dd : -INFINITY;
  }
}

template <class T>
int launch(const T* vc, const float* center, const float* radius,
           const uint8_t* valid, float* dist, uint8_t* ok, float* neg,
           int rows, int per_seed, int d, void* stream) {
  const int warps = kThreads / 32;
  const int grid = (rows + warps - 1) / warps;
  if (grid > 0) {
    roi_filter_kernel<T><<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        vc, center, radius, valid, dist, ok, neg, rows, per_seed, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vc is f32 (roi_filter_launch) or bf16 (roi_filter_bf16_launch)
extern "C" int roi_filter_launch(const float* vc, const float* center,
                                 const float* radius, const uint8_t* valid,
                                 float* dist, uint8_t* ok, float* neg,
                                 int rows, int per_seed, int d,
                                 void* stream) {
  return launch(vc, center, radius, valid, dist, ok, neg, rows, per_seed, d,
                stream);
}

extern "C" int roi_filter_bf16_launch(const __nv_bfloat16* vc,
                                      const float* center,
                                      const float* radius,
                                      const uint8_t* valid, float* dist,
                                      uint8_t* ok, float* neg, int rows,
                                      int per_seed, int d, void* stream) {
  return launch(vc, center, radius, valid, dist, ok, neg, rows, per_seed, d,
                stream);
}

// the static shared bytes of this source's kernels (static_smem.cuh)
extern "C" int roi_filter_static_smem(int* bytes) {
  return repro_smem::max_static(
      {repro_smem::fn(roi_filter_kernel<float>),
       repro_smem::fn(roi_filter_kernel<__nv_bfloat16>)},
      bytes);
}
