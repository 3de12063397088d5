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

// The register tile of pinned dots that the assign and affinity kernels
// share: a block of kTileThreads threads; thread t holds the TQ x kTA dots
// of query rows t / kSupGroups + kQueryGroups * r (r < TQ) against the rows
// t % kSupGroups + kSupGroups * c (c < kTA) of a kChunkRows-row chunk, both
// staged in shared memory as zero-padded rows of stride ld.
constexpr int kTileThreads = 128;
constexpr int kTA = 4;                                // chunk rows per thread
constexpr int kChunkRows = 32;                        // rows of a chunk
constexpr int kSupGroups = kChunkRows / kTA;          // 8
constexpr int kQueryGroups = kTileThreads / kSupGroups;  // 16

// leaf J of the halving tree over 32 running sums, in the order in which a
// streaming evaluation meets them: running sum kLane, and the number of
// completed left siblings it closes (the trailing one bits of J)
template <int J>
struct Leaf {
  static constexpr int kLane = ((J & 1) << 4) | ((J & 2) << 2) | (J & 4) |
                               ((J & 8) >> 2) | ((J & 16) >> 4);
  static constexpr int kMerges =
      (J & 1) ? ((J & 2) ? ((J & 4) ? ((J & 8) ? ((J & 16) ? 5 : 4) : 3)
                                    : 2)
                         : 1)
              : 0;
};

// The TQ x kTA dots of one thread, q rows tq + 16 r against support rows
// ta + 8 t, each in the pinned order: running sum l = q[l] s[l] + q[l+32]
// s[l+32] + ... (columns past d are zero in shared memory, so their
// products are +0 as in the zero-padded plain version), folded into the
// halving tree s[l] + s[l + half] as soon as it is complete.
template <int TQ, int J>
struct PinnedDots {
  static __device__ __forceinline__ void run(
      const float* qs, const float* ss, int ld, int nch, int tq, int ta,
      float (&stack)[5][TQ][kTA], float (&dot)[TQ][kTA]) {
    constexpr int l = Leaf<J>::kLane;
    float leaf[TQ][kTA];
    {
      float qv[TQ], sv[kTA];
#pragma unroll
      for (int r = 0; r < TQ; ++r) {
        qv[r] = qs[(tq + kQueryGroups * r) * ld + l];
      }
#pragma unroll
      for (int t = 0; t < kTA; ++t) sv[t] = ss[(ta + kSupGroups * t) * ld + l];
#pragma unroll
      for (int r = 0; r < TQ; ++r) {
#pragma unroll
        for (int t = 0; t < kTA; ++t) leaf[r][t] = __fmul_rn(qv[r], sv[t]);
      }
    }
    for (int c = 1; c < nch; ++c) {
      const int col = (c << 5) + l;
      float qv[TQ], sv[kTA];
#pragma unroll
      for (int r = 0; r < TQ; ++r) {
        qv[r] = qs[(tq + kQueryGroups * r) * ld + col];
      }
#pragma unroll
      for (int t = 0; t < kTA; ++t) {
        sv[t] = ss[(ta + kSupGroups * t) * ld + col];
      }
#pragma unroll
      for (int r = 0; r < TQ; ++r) {
#pragma unroll
        for (int t = 0; t < kTA; ++t) {
          leaf[r][t] = __fadd_rn(leaf[r][t], __fmul_rn(qv[r], sv[t]));
        }
      }
    }
    constexpr int merges = Leaf<J>::kMerges;
#pragma unroll
    for (int r = 0; r < TQ; ++r) {
#pragma unroll
      for (int t = 0; t < kTA; ++t) {
        float v = leaf[r][t];
#pragma unroll
        for (int lvl = 0; lvl < merges; ++lvl) {
          v = __fadd_rn(stack[lvl][r][t], v);
        }
        if constexpr (merges < 5) {
          stack[merges][r][t] = v;
        } else {
          dot[r][t] = v;
        }
      }
    }
    PinnedDots<TQ, J + 1>::run(qs, ss, ld, nch, tq, ta, stack, dot);
  }
};

template <int TQ>
struct PinnedDots<TQ, 32> {
  static __device__ __forceinline__ void run(
      const float*, const float*, int, int, int, int,
      float (&)[5][TQ][kTA], float (&)[TQ][kTA]) {}
};

// |r|^2 of one zero-padded shared row, by a warp, in the pinned order
__device__ __forceinline__ float warp_row_sq(const float* row, int nch,
                                             int lane) {
  float acc = __fmul_rn(row[lane], row[lane]);
  for (int c = 1; c < nch; ++c) {
    const float v = row[(c << 5) + lane];
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  return warp_tree32(acc);
}

// Copy `rows` rows of d floats (row stride d) into n_rows shared rows of
// stride ld, zero past column d and past the last real row.
__device__ __forceinline__ void stage(float* dst, int ld, int dp,
                                      const float* __restrict__ src,
                                      int rows, int d, int n_rows) {
  for (int e = threadIdx.x; e < n_rows * dp; e += blockDim.x) {
    const int r = e / dp;
    const int col = e - r * dp;
    dst[r * ld + col] =
        (r < rows && col < d) ? __ldg(src + static_cast<long>(r) * d + col)
                              : 0.f;
  }
}

}  // namespace repro_kernels
