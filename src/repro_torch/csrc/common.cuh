// Helpers shared by the kernels of repro_torch/csrc.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_kernels {

// Copy `rows` rows of `d` floats from device memory (row stride d) into
// shared memory (row stride ld >= d). Where d is a multiple of 4 and the
// source is 16-byte aligned, each thread moves float4s and keeps several
// loads in flight; otherwise it moves floats.
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* __restrict__ src,
                                           int rows, int d) {
  if ((d & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = rows * (d >> 2);
    const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll 4
    for (int e4 = threadIdx.x; e4 < n4; e4 += blockDim.x) {
      const float4 v = __ldg(s4 + e4);
      const int e = e4 << 2;
      const int r = e / d;
      float* o = dst + r * ld + (e - r * d);
      o[0] = v.x;
      o[1] = v.y;
      o[2] = v.z;
      o[3] = v.w;
    }
  } else {
    for (int e = threadIdx.x; e < rows * d; e += blockDim.x) {
      const int r = e / d;
      dst[r * ld + (e - r * d)] = src[e];
    }
  }
}

// The pinned order of every d-long sum (kernels/ref.py `pinned_sum`):
// products rounded, element t added to running sum t mod 32 chunk after
// chunk (zero-padded to a multiple of 32), then a halving tree over the 32
// sums. One thread computes the whole sum here, in 32 registers.
__device__ __forceinline__ float pinned_dot(const float* a, const float* b,
                                           int d) {
  float acc[32];
  if ((d & 31) == 0) {  // whole chunks: no padding to test for
#pragma unroll
    for (int l = 0; l < 32; ++l) acc[l] = __fmul_rn(a[l], b[l]);
    for (int c = 32; c < d; c += 32) {
#pragma unroll
      for (int l = 0; l < 32; ++l) {
        acc[l] = __fadd_rn(acc[l], __fmul_rn(a[c + l], b[c + l]));
      }
    }
  } else {
#pragma unroll
    for (int l = 0; l < 32; ++l) acc[l] = l < d ? __fmul_rn(a[l], b[l]) : 0.f;
    for (int c = 32; c < d; c += 32) {
#pragma unroll
      for (int l = 0; l < 32; ++l) {
        acc[l] = __fadd_rn(acc[l], c + l < d ? __fmul_rn(a[c + l], b[c + l])
                                             : 0.f);
      }
    }
  }
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) {
#pragma unroll
    for (int l = 0; l < h; ++l) acc[l] = __fadd_rn(acc[l], acc[l + h]);
  }
  return acc[0];
}

// The same order spread over a warp: lane l holds running sum l; the
// butterfly below gives every lane the halving tree's result (each pair is
// added once, and IEEE addition commutes).
__device__ __forceinline__ float warp_tree32(float acc) {
  for (int off = 16; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  return acc;
}

// The argmax order of torch.argmax and jnp.argmax: (score a, index ja)
// wins over (b, jb) with the larger score, NaN above every number, and on
// equal scores (or two NaNs) the lower index.
__device__ __forceinline__ bool beats(float sa, int ja, float sb, int jb) {
  const bool na = isnan(sa), nb = isnan(sb);
  if (na != nb) return na;
  if (!na && sa != sb) return sa > sb;
  return ja < jb;
}

// torch.clamp_min(v, 0) / clamp_max(v, c): NaN passes, -0 stays -0
__device__ __forceinline__ float clamp_min0(float v) {
  return v < 0.f ? 0.f : v;
}
__device__ __forceinline__ float clamp_max(float v, float c) {
  return v > c ? c : v;
}

// the Laplacian affinity exp(-k sqrt(max((a2 + b2) - 2 dot, 0))), with the
// same IEEE operations in the same order as the plain PyTorch version
__device__ __forceinline__ float affinity(float a2, float b2, float dot,
                                         float k) {
  const float d2 = __fsub_rn(__fadd_rn(a2, b2), __fmul_rn(2.f, dot));
  return expf(__fmul_rn(-k, sqrtf(clamp_min0(d2))));
}

}  // namespace repro_kernels
