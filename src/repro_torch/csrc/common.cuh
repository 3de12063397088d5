// Helpers shared by the kernels of repro_torch/csrc.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_kernels {

// ---- storage loads: points are stored as f32 or bf16 and every sum runs
// on their f32 values; widening a bf16 (its 16 bits above 16 zero bits) is
// exact, so a kernel gives on bf16 rows the bits it gives on the upcast
// rows ----
__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  const unsigned short u =
      __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

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

// ---- leaf-major rows (the fit kernels: affinity_matvec, lid_sweep) ----
//
// The pinned order's leaf l of a d-long dot is the running sum of the
// products at t = l, l + 32, l + 64, ... (chunk c = t / 32), started from
// the first product. A leaf-major row holds element t = 32 c + l at
// l * ldl + c, with ldl = 4 ng (ng = ceil(nch / 4) float4 groups a leaf,
// nch = ceil(d / 32) chunks) and zeros past d, so that one float4 load
// brings four consecutive chunks of one leaf. The fit kernels add all 4 ng
// chunks of a leaf: the chunks past nch hold zeros, and adding their +0
// products changes no output bit (a leaf of -0 may become +0, which only
// the sign of a zero dot can show, and the distance (|a|^2 + |b|^2) -
// 2 dot, whose first term is never -0, is the same for either zero).
// Two sources of such groups:

// a leaf-major row (shared memory, local or a cluster peer's)
struct LeafMajor {
  using Elem = float;
  static __device__ __forceinline__ float4 group(const float* row, int l,
                                                 int g, int ldl) {
    return *reinterpret_cast<const float4*>(row + l * ldl + 4 * g);
  }
};

// a row of d elements (T: float or __nv_bfloat16) in device memory, read
// in place and widened to f32 (zeros past d; the loads are clamped to the
// row and unconditional, so that they all issue before their first use)
template <class T>
struct NaturalT {
  using Elem = T;
  static __device__ __forceinline__ float4 group(const T* row, int l, int g,
                                                 int d) {
    const int t = 128 * g + l;
    float4 v;
    v.x = load_f32(row + min(t, d - 1));
    v.y = load_f32(row + min(t + 32, d - 1));
    v.z = load_f32(row + min(t + 64, d - 1));
    v.w = load_f32(row + min(t + 96, d - 1));
    v.x = t < d ? v.x : 0.f;
    v.y = t + 32 < d ? v.y : 0.f;
    v.z = t + 64 < d ? v.z : 0.f;
    v.w = t + 96 < d ? v.w : 0.f;
    return v;
  }
};
using Natural = NaturalT<float>;

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// float4 groups a leaf of a leaf-major row
__host__ __device__ __forceinline__ int leaf_groups(int d) {
  return ((d + 31) / 32 + 3) / 4;
}

// Copy rows of d elements (T: float or __nv_bfloat16, widened to f32) into
// leaf-major shared rows of stride ld (4 ng floats a leaf), zero past d
// and for rows whose source is null: row r comes from src(r). A warp takes a row at a time: lane l loads the
// floats t = l + 32 c (128 contiguous bytes a load across the warp) and
// stores leaf l's float4s; a null row reads the `fallback` row and stores
// zeros, so that every load issues unconditionally.
template <class T, class RowSrc>
__device__ __forceinline__ void stage_leaf_major(float* dst, int ld, int ng,
                                                 int d, int n_rows,
                                                 const T* fallback,
                                                 RowSrc src) {
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
#pragma unroll 4
  for (int r = threadIdx.x >> 5; r < n_rows; r += nw) {
    const T* row = src(r);
    const bool on = row != nullptr;
    const float4 v = NaturalT<T>::group(on ? row : fallback, lane, 0, d);
    float* out = dst + r * ld + lane * 4 * ng;
    *reinterpret_cast<float4*>(out) =
        on ? v : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g = 1; g < ng; ++g) {
      const float4 w = NaturalT<T>::group(on ? row : fallback, lane, g, d);
      *reinterpret_cast<float4*>(out + 4 * g) =
          on ? w : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// leaf l of the dot of leaf-major rows (or rows in place): the running sum
// of the products at t = l, l + 32, ..., from the first, over 4 ng chunks
template <class Src>
__device__ __forceinline__ float leaf_dot(const typename Src::Elem* a,
                                          const typename Src::Elem* b,
                                          int l, int ng, int prm) {
  float4 x = Src::group(a, l, 0, prm), y = Src::group(b, l, 0, prm);
  float leaf = __fmul_rn(x.x, y.x);
  leaf = __fadd_rn(leaf, __fmul_rn(x.y, y.y));
  leaf = __fadd_rn(leaf, __fmul_rn(x.z, y.z));
  leaf = __fadd_rn(leaf, __fmul_rn(x.w, y.w));
  for (int g = 1; g < ng; ++g) {
    x = Src::group(a, l, g, prm);
    y = Src::group(b, l, g, prm);
    leaf = __fadd_rn(leaf, __fmul_rn(x.x, y.x));
    leaf = __fadd_rn(leaf, __fmul_rn(x.y, y.y));
    leaf = __fadd_rn(leaf, __fmul_rn(x.z, y.z));
    leaf = __fadd_rn(leaf, __fmul_rn(x.w, y.w));
  }
  return leaf;
}

// Leaf P of thread t's subtree: running sum t + 4 brev3(P), folded on a
// 3-deep stack (template recursion keeps the indices constant)
template <class Src, int P>
struct QuadWalk {
  static __device__ __forceinline__ void run(const typename Src::Elem* a,
                                             const typename Src::Elem* b,
                                             int t, int ng, int prm,
                                             float (&st)[3], float& v) {
    constexpr int u = ((P & 1) << 2) | (P & 2) | ((P & 4) >> 2);
    constexpr int merges = (P & 1) ? ((P & 2) ? ((P & 4) ? 3 : 2) : 1) : 0;
    float leaf = leaf_dot<Src>(a, b, t + 4 * u, ng, prm);
#pragma unroll
    for (int k = 0; k < merges; ++k) leaf = __fadd_rn(st[k], leaf);
    if constexpr (merges < 3) {
      st[merges] = leaf;
    } else {
      v = leaf;
    }
    QuadWalk<Src, P + 1>::run(a, b, t, ng, prm, st, v);
  }
};

template <class Src>
struct QuadWalk<Src, 8> {
  static __device__ __forceinline__ void run(const typename Src::Elem*,
                                             const typename Src::Elem*, int,
                                             int, int, float (&)[3],
                                             float&) {}
};

// Leaf P of thread t's subtree from groups already in registers
template <int P>
struct QuadFold {
  static __device__ __forceinline__ void run(const float4 (&a)[8],
                                             const float4 (&b)[8],
                                             float (&st)[3], float& v) {
    constexpr int merges = (P & 1) ? ((P & 2) ? ((P & 4) ? 3 : 2) : 1) : 0;
    float leaf = __fmul_rn(a[P].x, b[P].x);
    leaf = __fadd_rn(leaf, __fmul_rn(a[P].y, b[P].y));
    leaf = __fadd_rn(leaf, __fmul_rn(a[P].z, b[P].z));
    leaf = __fadd_rn(leaf, __fmul_rn(a[P].w, b[P].w));
#pragma unroll
    for (int k = 0; k < merges; ++k) leaf = __fadd_rn(st[k], leaf);
    if constexpr (merges < 3) {
      st[merges] = leaf;
    } else {
      v = leaf;
    }
    QuadFold<P + 1>::run(a, b, st, v);
  }
};

template <>
struct QuadFold<8> {
  static __device__ __forceinline__ void run(const float4 (&)[8],
                                             const float4 (&)[8],
                                             float (&)[3], float&) {}
};

// The pinned dot of rows a and b by the four threads of a quad (lanes
// 4k .. 4k+3, all of the warp calling): thread t meets its running sums
// l = t + 4u in bit-reversed order of u and folds them on a 3-deep stack
// (the subtree of the leaves l = t mod 4); the shuffles 2, 1 are the tree's
// top two levels. Every thread of the quad gets the dot. Up to d = 128
// (one group a leaf) a thread loads its 16 float4s before the first add.
template <class Src>
__device__ __forceinline__ float quad_dot(const typename Src::Elem* a,
                                          const typename Src::Elem* b,
                                          int t, int ng, int prm) {
  float st[3];
  float v;
  if (ng == 1) {
    float4 av[8], bv[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int l = t + 4 * (((p & 1) << 2) | (p & 2) | ((p & 4) >> 2));
      av[p] = Src::group(a, l, 0, prm);
      bv[p] = Src::group(b, l, 0, prm);
    }
    QuadFold<0>::run(av, bv, st, v);
  } else {
    QuadWalk<Src, 0>::run(a, b, t, ng, prm, st, v);
  }
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
}

// The halving tree over 2^D leaves met in bit-reversed order: leaf number
// p (in the order met) is merged with the completed left siblings on the
// stack, as many as p has trailing one bits, and pushed. After leaf 2^D - 1
// the tree's sum sits at depth D. Indices are resolved by unrolled selects,
// so the stack stays in registers.
template <int kDepth>
struct TreeStack {
  float s[kDepth];
  __device__ __forceinline__ void push(float v, int p) {
    const int merges = __popc(p ^ (p + 1)) - 1;  // trailing ones of p
#pragma unroll
    for (int k = 0; k < kDepth - 1; ++k) {
      if (k < merges) v = __fadd_rn(s[k], v);
    }
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      if (k == merges) s[k] = v;
    }
  }
  __device__ __forceinline__ float top(int depth) const {
    float v = s[0];
#pragma unroll
    for (int k = 1; k < kDepth; ++k) {
      if (k == depth) v = s[k];
    }
    return v;
  }
};

__device__ __forceinline__ int bit_reverse(int p, int bits) {
  return bits == 0 ? 0 : static_cast<int>(__brev(static_cast<unsigned>(p))
                                          >> (32 - bits));
}

}  // namespace repro_kernels
