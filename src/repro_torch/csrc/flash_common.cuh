// Pieces shared by the attention kernels of flash_attention.cu and
// flash_wgmma.cuh: the launch parameters, the mask in logical positions,
// the attended range of a tile, and the dynamic shared-memory opt-in.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace repro_flash {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_start;
  void* out;
  float* scratch;                       // the split kernel's partials
  float* lse;  // flash_wgmma_kernel: (B, H, Sq) f32 natural log-sum-exp
               // of each real row (+inf where it attends nothing), or null
  int h, hkv, sq, sk, dh;
  long long q_sb, q_sh, q_ss;  // strides (elements); the dh stride is 1
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  int q_offset, causal, window, chunk;  // window, chunk: 0 = none
  float softcap, scale;                 // softcap: 0 = none
  int hb, ppt, n_hc, bc, rp, dh4;       // tile plan, see smem_plan
  int blocks_per_row;                   // query tiles x head chunks
  int b0;                               // the launch's first batch row
  int batch_on_z;                       // flash_kernel: the batch on grid.z
  int n_split, split_lo, split_len;     // split plan, see kernel_plan
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// a // b for b > 0, rounding toward -inf as Python and JAX do
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// the logit of an attended pair: scale, then softcap
__device__ __forceinline__ float logit(const Params& p, float dot) {
  const float s = dot * p.scale;
  return p.softcap > 0.f ? p.softcap * tanhf(s / p.softcap) : s;
}

// whether query position qp attends key position kp, both logical (slot -
// kv_start); kp < 0 is a pad slot
__device__ __forceinline__ bool attends(const Params& p, int kp, int qp) {
  bool ok = kp >= 0;
  if (p.causal) ok = ok && kp <= qp;
  if (p.window > 0) ok = ok && kp > qp - p.window;
  if (p.chunk > 0) {
    ok = ok && floor_div(kp, p.chunk) == floor_div(qp, p.chunk);
  }
  return ok;
}

// every query position of [qf, ql] attends every key position of [kp0,
// kp1] (logical positions; the caller knows both ranges real)
__device__ __forceinline__ bool all_attend(const Params& p, int kp0, int kp1,
                                           int qf, int ql) {
  if (kp0 < 0) return false;
  if (p.causal && kp1 > qf) return false;
  if (p.window > 0 && kp0 <= ql - p.window) return false;
  if (p.chunk > 0) {
    const int c = floor_div(kp0, p.chunk);
    if (floor_div(kp1, p.chunk) != c || floor_div(qf, p.chunk) != c ||
        floor_div(ql, p.chunk) != c) {
      return false;
    }
  }
  return true;
}

// the query positions [*qlo, *qhi] that can attend some key in [j0, j1]
// (no kv_start, no q_offset: the backward's positions are slots)
__device__ __forceinline__ void q_range(const Params& m, int j0, int j1,
                                        int* qlo, int* qhi) {
  int lo = 0, hi = m.sq - 1;
  if (m.causal) lo = max(lo, j0);
  if (m.window > 0) hi = min(hi, j1 + m.window - 1);
  if (m.chunk > 0) {
    lo = max(lo, floor_div(j0, m.chunk) * m.chunk);
    hi = min(hi, (floor_div(j1, m.chunk) + 1) * m.chunk - 1);
  }
  *qlo = lo;
  *qhi = hi;
}

// the kv slots [lo, hi] that some query at slots first..last can attend
__device__ __forceinline__ void kv_range(const Params& p, int start,
                                         int first, int last, int* lo_out,
                                         int* hi_out) {
  int lo = max(start, 0), hi = p.sk - 1;
  if (p.causal) hi = min(hi, last);
  if (p.window > 0) lo = max(lo, first - p.window + 1);
  if (p.chunk > 0) {
    lo = max(lo, start + floor_div(first - start, p.chunk) * p.chunk);
    hi = min(hi, start + (floor_div(last - start, p.chunk) + 1) * p.chunk - 1);
  }
  *lo_out = lo;
  *hi_out = hi;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int* limit) {
  if (bytes > *limit && bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    *limit = bytes;
  }
  return cudaSuccess;
}

// Launch a tile kernel (flash_kernel, flash_wgmma_kernel) over its grid:
// (query tiles x head chunks, Hkv, B) with the batch on grid.z where
// p.batch_on_z, else the batch rows folded into grid.x, as many a launch as
// grid.x holds (one launch unless the grid would pass 2**31 - 1 blocks).
template <typename K>
cudaError_t launch_tile_grid(K kernel, const Params& p, int batch,
                             int threads, int smem_bytes, int* smem_limit,
                             cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem_bytes, smem_limit);
  if (err != cudaSuccess) return err;
  const long long per_row =
      static_cast<long long>((p.sq + p.ppt - 1) / p.ppt) * p.n_hc;
  if (per_row > 0x7fffffffLL || p.hkv > 65535) return cudaErrorInvalidValue;
  Params lp = p;
  lp.blocks_per_row = static_cast<int>(per_row);
  if (p.batch_on_z) {
    if (batch > 65535) return cudaErrorInvalidValue;
    const dim3 grid(static_cast<unsigned>(per_row), p.hkv, batch);
    kernel<<<grid, threads, smem_bytes, stream>>>(lp);
    return cudaGetLastError();
  }
  const long long rows = 0x7fffffffLL / per_row;
  for (long long b0 = 0; b0 < batch; b0 += rows) {
    const long long n = batch - b0 < rows ? batch - b0 : rows;
    lp.b0 = static_cast<int>(b0);
    const dim3 grid(static_cast<unsigned>(n * per_row), p.hkv, 1);
    kernel<<<grid, threads, smem_bytes, stream>>>(lp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The block's place in that grid: batch row b and tile (query tile x head
// chunk) within the row.
__device__ __forceinline__ void tile_of_block(const Params& p, int* b,
                                              int* tile) {
  if (p.batch_on_z) {
    *b = blockIdx.z;
    *tile = blockIdx.x;
  } else {
    const int bl = blockIdx.x / p.blocks_per_row;
    *b = p.b0 + bl;
    *tile = blockIdx.x - bl * p.blocks_per_row;
  }
}

// the tensor-core prefill kernel of flash_wgmma.cuh, for bf16 q, k, v with
// p.dh a multiple of 16 up to 128 (kernels/flash_attention.py
// `kernel_plan`); with p.lse set (dh 64, 80, 128) its lse-writing kernels
cudaError_t launch_wgmma(const Params& p, int batch, int smem_bytes,
                         cudaStream_t stream);
// those lse-writing kernels (flash_wgmma_lse.cu)
cudaError_t launch_wgmma_lse(const Params& p, int batch, int smem_bytes,
                             cudaStream_t stream);

}  // namespace repro_flash
