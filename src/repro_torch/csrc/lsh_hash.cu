// p-stable LSH bucket keys: projection, floor-quantize, per-table fold.
//
// Replaces the TPU kernel `lsh_hash_pallas` (src/repro/kernels/lsh_hash.py,
// `_lsh_kernel`). For x (n, d) f32, proj (L*m, d) f32 and bias (L*m,) f32 it
// computes z = x . proj^T + bias in f32, h = floor(z / seg_len) with IEEE
// division by the f32-rounded seg_len (never a reciprocal multiply), and per
// table l the fold acc = 0x811C9DC5; acc = (acc ^ h) * 0x9E3779B1 mod 2^32;
// acc ^= acc >> 15 over its m words. Keys are written as int32 bits (n, L).
//
// What bounds it on an H100: at the main path's widths (d = 128, L*m = 32)
// each point costs 512 bytes of reads and 8 KFLOP, so one pass over 1M
// points is ~0.15 ms of HBM traffic against ~0.13 ms of f32 FMA: balanced
// between bytes and operations. The design keeps x read exactly once:
// each block is persistent, stages the (L*m, d) projections in shared memory
// once, then walks tiles of points, staging each tile with coalesced loads.
// Shared rows are padded to d+1 floats so that the lanes of a warp (one
// projection each) read distinct banks. Each thread takes one projection
// against kRows points, so one shared read of the projection feeds kRows
// FMAs. The d-sum is one FMA chain per (point, projection): it is not the
// plain version's pinned order, so a key flips where z / seg_len lies
// within rounding of an integer; keys are integers and a flip moves one
// point to a neighbouring bucket of one table, which the checks count and
// bound (kernels/lsh_hash.py `key_flips`).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // points per thread; the tile is a multiple of it

__global__ void lsh_hash_kernel(const float* __restrict__ x,
                                const float* __restrict__ proj,
                                const float* __restrict__ bias,
                                int32_t* __restrict__ out,
                                int n, int d, int n_tables, int n_proj,
                                int pts, float seg) {
  extern __shared__ float smem[];
  const int lm = n_tables * n_proj;
  const int ds = d + 1;
  float* ps = smem;                 // (lm, ds) projections
  float* xs = ps + lm * ds;         // (pts, ds) point tile
  // (pts, lm) quantized lattice words
  int32_t* hs = reinterpret_cast<int32_t*>(xs + pts * ds);

  repro_kernels::stage_rows(ps, ds, proj, lm, d);
  const int n_tiles = (n + pts - 1) / pts;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long base = static_cast<long>(tile) * pts;
    const int rows = min(pts, static_cast<int>(n - base));
    __syncthreads();  // previous tile's xs/hs fully consumed
    repro_kernels::stage_rows(xs, ds, x + base * d, rows, d);
    __syncthreads();
    const int groups = (rows + kRows - 1) / kRows;
    for (int e = threadIdx.x; e < groups * lm; e += blockDim.x) {
      const int p0 = (e / lm) * kRows;
      const int q = e % lm;
      const float* w = ps + q * ds;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      // rows past `rows` read stale tile data; their sums are never stored
      for (int j = 0; j < d; ++j) {
        const float wj = w[j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[r] = fmaf(xs[(p0 + r) * ds + j], wj, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (p0 + r < rows) {
          const float z = __fadd_rn(acc[r], bias[q]);
          // floor of the IEEE quotient, converted with saturation (NaN -> 0)
          hs[(p0 + r) * lm + q] = __float2int_rd(__fdiv_rn(z, seg));
        }
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rows * n_tables; e += blockDim.x) {
      const int p = e / n_tables;
      const int l = e % n_tables;
      uint32_t acc = 0x811C9DC5u;
      for (int j = 0; j < n_proj; ++j) {
        acc = (acc ^ static_cast<uint32_t>(hs[p * lm + l * n_proj + j])) *
              0x9E3779B1u;
        acc ^= acc >> 15;
      }
      out[(base + p) * n_tables + l] = static_cast<int32_t>(acc);
    }
  }
}

}  // namespace

extern "C" int lsh_hash_launch(const float* x, const float* proj,
                               const float* bias, int32_t* out, int n, int d,
                               int n_tables, int n_proj, int pts, float seg,
                               void* stream) {
  const int lm = n_tables * n_proj;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(lm + pts) * (d + 1) +
                       static_cast<size_t>(pts) * lm);
  // raise the dynamic shared-memory limit only when a launch needs more
  // than before, so that repeated launches (and CUDA graph captures of
  // them) make no further API call
  static int smem_limit = 0;
  const int smem_need = static_cast<int>(smem);
  if (smem_need > smem_limit) {
    const cudaError_t err = cudaFuncSetAttribute(
        lsh_hash_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_need);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_limit = smem_need;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_tiles = (n + pts - 1) / pts;
  const int grid = n_tiles < 4 * sms ? n_tiles : 4 * sms;
  if (grid > 0) {
    lsh_hash_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        x, proj, bias, out, n, d, n_tables, n_proj, pts, seg);
  }
  return static_cast<int>(cudaGetLastError());
}
