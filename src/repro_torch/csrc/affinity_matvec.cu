// Masked affinity x weights matvec behind the Ax refreshes (paper Eq. 13/17):
//   out[b, i] = sum_j [q_idx[b, i] != c_idx[b, j]] exp(-k ||q_bi - c_bj||) w_bj
//
// Replaces the TPU kernel `affinity_matvec_pallas` (src/repro/kernels/
// affinity_matvec.py, `_matvec_kernel`). The distance is the clamped
// expansion sqrt(max((|q|^2 + |c|^2) - 2 q.c, 0)), the diagonal is zeroed
// by comparing indices, |q|^2, |c|^2 and the dots are summed in the pinned
// order of kernels/ref.py (`pinned_sum`), and the n products of each output
// row in `tree_matvec`'s (zero-padded to a power of two P, halved), every
// multiply and add a separate IEEE operation: on equal inputs the kernel
// gives its plain version's bits. The seed batch is grid.y.
//
// What bounds it on an H100: the operations. Kept separate, as the pinned
// order needs them, the multiplies and adds of the m n dots (255 a pair at
// d = 128) are ~470 M FP32 instructions at 32 x 240 x 240, ~15 us of the
// card's issue rate; bytes (~8 MB) and the exps are far below that. So the
// design spends nothing on data movement that the dots could use:
//
// - a block takes 64 output rows of one seed (4 a thread, in 16 groups) and
//   stages them, and the columns it needs, in shared memory LEAF-MAJOR: the
//   four terms t = l, l+32, l+64, l+96 of a dot's running sum l sit in one
//   float4, so a thread's 4 x 4 register tile of pairs takes 8 float4 loads
//   for 128 multiply-adds;
// - a thread walks the 32 running sums in bit-reversed order, folding each
//   into the halving tree on a stack (four quarters of eight, each a
//   complete subtree): no shuffle per pair;
// - the j-sum: the 16 threads of a row group own the column classes
//   j = r mod 16, each a complete subtree of tree_matvec's halving tree.
//   A thread meets its class's columns in bit-reversed order, four at a
//   time (a complete subtree of four, summed in registers), folds them on a
//   stack, and the top four levels are xor shuffles 8, 4, 2, 1. No shared
//   memory tree and no barrier inside the sum.
//
// Columns are staged in passes of whole groups when they do not all fit;
// past the d whose rows fit in shared memory ("global" route) the same
// schedule, one output row a thread, reads the rows in place from device
// memory. Ragged d adds zero chunks (common.cuh), which change no bit.
// q and c may be stored as f32 or bf16 (one dtype for both; w stays f32):
// the smem route widens bf16 rows to f32 as it stages them, so one
// instantiation of its register tiles serves both (the staging branches
// on `bf16_rows`); the global route widens each element as it reads it
// (an instantiation a storage type). Widening is exact, so on bf16 rows
// the kernel gives the bits it gives on the upcast f32 rows.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "static_smem.cuh"

namespace {

using repro_kernels::LeafMajor;
using repro_kernels::NaturalT;
using repro_kernels::bit_reverse;
using repro_kernels::comp;
using repro_kernels::leaf_groups;
using repro_kernels::quad_dot;

constexpr int kTC = 4;         // columns a thread holds: one group
constexpr int kSlots = 16;     // threads of a row group: column classes
constexpr int kGroupSlots = kSlots * kTC;  // staged columns of a group
constexpr int kDepth = 8;      // the j stack: up to 128 groups a class
constexpr int kThreads = 256;

// group g (chunks 4g .. 4g+3) of leaf l of the tile's TQ x kTC dots; the
// first group's first chunk starts each running sum
template <class Src, int TQ, bool kFirst>
__device__ __forceinline__ void leaf_group(
    const typename Src::Elem* const (&qr)[TQ],
    const typename Src::Elem* const (&cr)[kTC], int l, int g, int prm,
                                           float (&leaf)[TQ][kTC]) {
  float4 a[TQ], b[kTC];
#pragma unroll
  for (int r = 0; r < TQ; ++r) a[r] = Src::group(qr[r], l, g, prm);
#pragma unroll
  for (int t = 0; t < kTC; ++t) b[t] = Src::group(cr[t], l, g, prm);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int r = 0; r < TQ; ++r) {
#pragma unroll
      for (int t = 0; t < kTC; ++t) {
        const float p = __fmul_rn(comp(a[r], e), comp(b[t], e));
        leaf[r][t] = (kFirst && e == 0) ? p : __fadd_rn(leaf[r][t], p);
      }
    }
  }
}

// Leaf JJ of a quarter: running sum res + 4 brev3(JJ), folded on the
// quarter's 3-deep stack (template recursion keeps every index constant,
// so the stack stays in registers)
template <class Src, int TQ, int JJ>
struct Quarter {
  static __device__ __forceinline__ void run(
      const typename Src::Elem* const (&qr)[TQ],
      const typename Src::Elem* const (&cr)[kTC], int res, int ng, int prm,
      float (&st)[3][TQ][kTC], float (&v)[TQ][kTC]) {
    constexpr int u = ((JJ & 1) << 2) | (JJ & 2) | ((JJ & 4) >> 2);
    constexpr int merges =
        (JJ & 1) ? ((JJ & 2) ? ((JJ & 4) ? 3 : 2) : 1) : 0;
    const int l = res + 4 * u;
    float leaf[TQ][kTC];
    leaf_group<Src, TQ, true>(qr, cr, l, 0, prm, leaf);
#pragma unroll 1
    for (int g = 1; g < ng; ++g) {
      leaf_group<Src, TQ, false>(qr, cr, l, g, prm, leaf);
    }
#pragma unroll
    for (int r = 0; r < TQ; ++r) {
#pragma unroll
      for (int t = 0; t < kTC; ++t) {
        float x = leaf[r][t];
#pragma unroll
        for (int lvl = 0; lvl < merges; ++lvl) {
          x = __fadd_rn(st[lvl][r][t], x);
        }
        if constexpr (merges < 3) {
          st[merges][r][t] = x;
        } else {
          v[r][t] = x;
        }
      }
    }
    Quarter<Src, TQ, JJ + 1>::run(qr, cr, res, ng, prm, st, v);
  }
};

template <class Src, int TQ>
struct Quarter<Src, TQ, 8> {
  static __device__ __forceinline__ void run(
      const typename Src::Elem* const (&)[TQ],
      const typename Src::Elem* const (&)[kTC], int, int, int,
      float (&)[3][TQ][kTC], float (&)[TQ][kTC]) {}
};

// The tile's TQ x kTC dots in the pinned order. Leaf J (bit-reversed
// order) is running sum l = 4 brev3(J mod 8) + brev2(J / 8): the quarter
// qq = J / 8 holds the leaves l = brev2(qq) mod 4, a complete subtree of
// eight; the four quarters' sums are the tree's top two levels, folded in
// turn.
template <class Src, int TQ>
__device__ __forceinline__ void tile_dots(
    const typename Src::Elem* const (&qr)[TQ],
    const typename Src::Elem* const (&cr)[kTC], int ng, int prm,
                                          float (&dot)[TQ][kTC]) {
  float hi[2][TQ][kTC];  // completed quarter (level 3), half (level 4)
#pragma unroll 1
  for (int qq = 0; qq < 4; ++qq) {
    float st[3][TQ][kTC];
    float v[TQ][kTC];
    Quarter<Src, TQ, 0>::run(qr, cr, ((qq & 1) << 1) | (qq >> 1), ng, prm,
                             st, v);
#pragma unroll
    for (int r = 0; r < TQ; ++r) {
#pragma unroll
      for (int t = 0; t < kTC; ++t) {
        float x = v[r][t];
        if (qq & 1) {
          x = __fadd_rn(hi[0][r][t], x);
          if (qq & 2) {
            dot[r][t] = __fadd_rn(hi[1][r][t], x);
          } else {
            hi[1][r][t] = x;
          }
        } else {
          hi[0][r][t] = x;
        }
      }
    }
  }
}

// rows: output rows of a block (TQ a thread, 16 threads a row group);
// classes, ubits, tc, groups: the column classes G, log2 of a class's
// columns U = P / G, the columns a group sums in registers, U / tc groups
// a class; gpp: groups a pass. T: the storage type of the rows the global
// route reads in place; the smem route is instantiated for T = float and
// reads q and c as bf16 rows where bf16_rows is set.
template <class T, bool kSmemRows, int TQ>
__global__ void __launch_bounds__(kThreads) matvec_kernel(
    const T* __restrict__ q, const int32_t* __restrict__ q_idx,
    const T* __restrict__ c, const int32_t* __restrict__ c_idx,
    const float* __restrict__ w, float* __restrict__ out, int m, int n,
    int d, float k, int rows, int classes, int ubits, int tc, int groups,
    int gpp, int bf16_rows) {
  using Src =
      typename std::conditional<kSmemRows, LeafMajor, NaturalT<T>>::type;
  using Row = typename Src::Elem;  // a row as the dots read it
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ng = leaf_groups(d);
  const int ld = 128 * ng + 4;  // row stride: 16 bytes off the bank period
  const int prm = kSmemRows ? 4 * ng : d;
  const int pass_slots = gpp * kGroupSlots;
  float* qs = smem;
  float* cs = qs + (kSmemRows ? rows * ld : 0);
  float* q2s = cs + (kSmemRows ? pass_slots * ld : 0);
  int* qis = reinterpret_cast<int*>(q2s + rows);
  float* c2s = reinterpret_cast<float*>(qis + rows);
  float* ws = c2s + pass_slots;
  int* cis = reinterpret_cast<int*>(ws + pass_slots);
  int* cjs = cis + pass_slots;

  const int tid = threadIdx.x;
  const int r = tid & (kSlots - 1);   // column class slot
  const int qg = tid / kSlots;        // row group
  const long b = blockIdx.y;
  const int i0 = blockIdx.x * rows;
  const T* qb = q + b * m * static_cast<long>(d);
  const T* cb = c + b * n * static_cast<long>(d);
  auto q_row = [&](int row) -> const T* {  // in place, clamped
    return qb + min(i0 + row, m - 1) * static_cast<long>(d);
  };
  // output row `row` and staged column slot `s` as the dots read them
  auto q_src = [&](int row) -> const Row* {
    if constexpr (kSmemRows) {
      return qs + row * ld;
    } else {
      return q_row(row);
    }
  };
  auto c_src = [&](int s) -> const Row* {
    if constexpr (kSmemRows) {
      return cs + s * ld;
    } else {
      return cb + max(cjs[s], 0) * static_cast<long>(d);
    }
  };
  // the smem route's staging: n_rows rows of `base` (q or c), row r the
  // element row row_at(r) or none (-1), widened to f32: the one place the
  // smem route reads the storage type
  auto stage = [&](float* dst, int n_rows, const T* base, auto row_at) {
    auto go = [&](auto* src) {
      repro_kernels::stage_leaf_major(
          dst, ld, ng, d, n_rows, src, [&](int r) -> decltype(src) {
            const long i = row_at(r);
            return i >= 0 ? src + i * d : nullptr;
          });
    };
    if (bf16_rows) {
      go(reinterpret_cast<const __nv_bfloat16*>(base));
    } else {
      go(reinterpret_cast<const float*>(base));
    }
  };

  if constexpr (kSmemRows) {
    stage(qs, rows, q, [&](int row) -> long {
      return i0 + row < m ? b * m + i0 + row : -1;
    });
    __syncthreads();
  }
  // |q|^2 and |c|^2 in the pinned order, four threads a row (quad_dot);
  // every thread runs every round, so that the shuffles see whole warps
  const int quad = tid >> 2, t4 = tid & 3, nquads = blockDim.x >> 2;
  for (int row0 = 0; row0 < rows; row0 += nquads) {
    const int row = min(row0 + quad, rows - 1);
    const Row* qrow = q_src(row);
    const float v = quad_dot<Src>(qrow, qrow, t4, ng, prm);
    if (t4 == 0 && row0 + quad < rows) {
      q2s[row] = v;
      qis[row] = i0 + row < m ? q_idx[b * m + i0 + row] : -2;
    }
  }

  const Row* qr[TQ];
#pragma unroll
  for (int rr = 0; rr < TQ; ++rr) qr[rr] = q_src(qg * TQ + rr);
  // the class's groups folded in walk order (local memory: one access a
  // group and row)
  float jst[TQ][kDepth];

  for (int g0 = 0; g0 < groups; g0 += gpp) {
    const int slots = min(gpp, groups - g0) * kGroupSlots;
    __syncthreads();  // the previous pass is done with the slots
    for (int s = tid; s < slots; s += blockDim.x) {
      const int gg = s / kGroupSlots, tt = (s / kSlots) % kTC;
      const int cls = s % kSlots;
      int j = -1;
      if (cls < classes && tt < tc) {
        const int u = bit_reverse((g0 + gg) * tc + tt, ubits);
        j = cls + classes * u;
        if (j >= n) j = -1;
      }
      cjs[s] = j;
      ws[s] = j >= 0 ? w[b * n + j] : 0.f;
      cis[s] = j >= 0 ? c_idx[b * n + j] : 0;
    }
    __syncthreads();
    if constexpr (kSmemRows) {
      stage(cs, slots, c, [&](int s) -> long {
        const int j = cjs[s];
        return j >= 0 ? b * n + j : -1;
      });
      __syncthreads();
    }
    for (int s0 = 0; s0 < slots; s0 += nquads) {
      const int s = min(s0 + quad, slots - 1);
      const Row* crow = c_src(s);
      const float v = quad_dot<Src>(crow, crow, t4, ng, prm);
      if (t4 == 0 && s0 + quad < slots) c2s[s] = v;
    }
    __syncthreads();

    for (int gg = 0; gg * kGroupSlots < slots; ++gg) {
      const int sb = gg * kGroupSlots + r;
      const Row* cr[kTC];
#pragma unroll
      for (int tt = 0; tt < kTC; ++tt) cr[tt] = c_src(sb + tt * kSlots);
      float dot[TQ][kTC];
      tile_dots<Src, TQ>(qr, cr, ng, prm, dot);
      float prod[TQ][kTC];
#pragma unroll
      for (int tt = 0; tt < kTC; ++tt) {
        const int s = sb + tt * kSlots;
        const bool on = cjs[s] >= 0;
        const float c2 = c2s[s], wj = ws[s];
        const int cj = cis[s];
#pragma unroll
        for (int rr = 0; rr < TQ; ++rr) {
          const int row = qg * TQ + rr;
          const float a = qis[row] == cj
              ? 0.f : repro_kernels::affinity(q2s[row], c2, dot[rr][tt], k);
          prod[rr][tt] = on ? __fmul_rn(a, wj) : 0.f;
        }
      }
      const int p = g0 + gg;
      const int merges = __popc(p ^ (p + 1)) - 1;
#pragma unroll
      for (int rr = 0; rr < TQ; ++rr) {
        float v = prod[rr][0];
        if (tc == 2) v = __fadd_rn(prod[rr][0], prod[rr][1]);
        if (tc == 4) {
          v = __fadd_rn(__fadd_rn(prod[rr][0], prod[rr][1]),
                        __fadd_rn(prod[rr][2], prod[rr][3]));
        }
        for (int lvl = 0; lvl < merges; ++lvl) v = __fadd_rn(jst[rr][lvl], v);
        jst[rr][merges] = v;
      }
    }
  }

  const int depth = 31 - __clz(groups);  // groups is a power of two
#pragma unroll
  for (int rr = 0; rr < TQ; ++rr) {
    float v = jst[rr][depth];
    for (int off = classes >> 1; off > 0; off >>= 1) {
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
    }
    const int i = i0 + qg * TQ + rr;
    if (r == 0 && i < m) out[b * m + i] = v;
  }
}

template <class T, bool kSmemRows, int TQ>
int launch(const T* q, const int32_t* q_idx, const T* c,
           const int32_t* c_idx, const float* w, float* out, int batch,
           int m, int n, int d, float k, int rows, int classes, int ubits,
           int tc, int groups, int gpp, int smem_bytes, int bf16_rows,
           cudaStream_t stream) {
  // raise the dynamic shared-memory limit only when a launch needs more
  // than before, so that repeated launches (and CUDA graph captures of
  // them) make no further API call
  static int smem_limit = 0;
  if (smem_bytes > smem_limit) {
    const cudaError_t err = cudaFuncSetAttribute(
        matvec_kernel<T, kSmemRows, TQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_limit = smem_bytes;
  }
  const dim3 grid((m + rows - 1) / rows, batch);
  matvec_kernel<T, kSmemRows, TQ><<<grid, rows / TQ * kSlots, smem_bytes,
                                    stream>>>(
      q, q_idx, c, c_idx, w, out, m, n, d, k, rows, classes, ubits, tc,
      groups, gpp, bf16_rows);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_route(const T* q, const int32_t* q_idx, const T* c,
                 const int32_t* c_idx, const float* w, float* out, int batch,
                 int m, int n, int d, float k, int smem_rows, int rows,
                 int classes, int ubits, int tc, int groups, int gpp,
                 int smem_bytes, void* stream) {
  if (batch <= 0 || m <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the smem route's one instantiation takes the rows' type at run time
  return smem_rows
      ? launch<float, true, 4>(reinterpret_cast<const float*>(q), q_idx,
                               reinterpret_cast<const float*>(c), c_idx, w,
                               out, batch, m, n, d, k, rows, classes, ubits,
                               tc, groups, gpp, smem_bytes,
                               std::is_same<T, __nv_bfloat16>::value, s)
      : launch<T, false, 1>(q, q_idx, c, c_idx, w, out, batch, m, n, d, k,
                            rows, classes, ubits, tc, groups, gpp,
                            smem_bytes, 0, s);
}

}  // namespace

// The plan (route, rows, classes, ubits, tc, groups, gpp, smem_bytes) comes
// from kernels/affinity_matvec.py `plan`: 4 output rows a thread on the
// "smem" route, 1 on the "global" route. q and c are f32
// (affinity_matvec_launch) or bf16 (affinity_matvec_bf16_launch).
extern "C" int affinity_matvec_launch(
    const float* q, const int32_t* q_idx, const float* c,
    const int32_t* c_idx, const float* w, float* out, int batch, int m,
    int n, int d, float k, int smem_rows, int rows, int classes, int ubits,
    int tc, int groups, int gpp, int smem_bytes, void* stream) {
  return launch_route(q, q_idx, c, c_idx, w, out, batch, m, n, d, k,
                      smem_rows, rows, classes, ubits, tc, groups, gpp,
                      smem_bytes, stream);
}

extern "C" int affinity_matvec_bf16_launch(
    const __nv_bfloat16* q, const int32_t* q_idx, const __nv_bfloat16* c,
    const int32_t* c_idx, const float* w, float* out, int batch, int m,
    int n, int d, float k, int smem_rows, int rows, int classes, int ubits,
    int tc, int groups, int gpp, int smem_bytes, void* stream) {
  return launch_route(q, q_idx, c, c_idx, w, out, batch, m, n, d, k,
                      smem_rows, rows, classes, ubits, tc, groups, gpp,
                      smem_bytes, stream);
}

// the static shared bytes of this source's kernels (static_smem.cuh)
extern "C" int affinity_matvec_static_smem(int* bytes) {
  return repro_smem::max_static(
      {repro_smem::fn(matvec_kernel<float, true, 4>),
       repro_smem::fn(matvec_kernel<float, false, 1>),
       repro_smem::fn(matvec_kernel<__nv_bfloat16, false, 1>)},
      bytes);
}
