// Fused cluster assignment behind Clustering.predict and the serving layer:
//   score[i, c] = sum_a w[c, a] exp(-k ||q_i - s_ca||)
//   best[i]     = argmax_c score[i, c]  (first index on ties, NaN wins)
//   label[i]    = best[i] if score[i, best] >= t * dens[best] else -1
// and, where a validity mask is given, label -1 and score 0 on the rows it
// marks invalid (the padded slots of a serving batch).
//
// Replaces the TPU kernel `assign_pallas` (src/repro/kernels/assign.py,
// `_assign_kernel`). That kernel holds the whole (C*A, d) support panel and
// a (C*A, C) block-diagonal weight matrix in VMEM and turns the sum over a
// into a second matmul; at 2,048 clusters of A = 240 the matrix alone is
// 4 GB. Here the weights stay (C, A) and the sum over a is a segment sum
// inside the block. Blocks run in no order, so the argmax over clusters is
// a second pass:
//   1. assign_scores_kernel: one block per (query tile, cluster). The tile's
//      queries sit in shared memory; the cluster's supports pass through it
//      32 rows at a time, so A * d never has to fit in a block's 227 KB.
//      Each thread takes a 4-query x 4-support register tile (1 x 4 where
//      d is too wide for a 64-row query tile), so every shared-memory load
//      feeds four products. The block writes score (m, C) to device memory.
//   2. assign_pick_kernel: one warp per query: the argmax over C, dens[best],
//      the threshold, the mask.
//
// What bounds it on an H100: operations. One 64-query batch at full width
// (C = 2,048, A = 240, d = 128) is 2 m C A d = 8.05 GFLOP, 0.120 ms at the
// f32 peak of 67 TFLOP/s, against 0.075 ms to read the 252 MB table. The
// pinned order below rules out fused multiply-adds, so the SIMT ceiling is
// half that peak; this first kernel uses no tensor cores.
//
// Every sum is the plain PyTorch version's (kernels/ref.py `assign_ref`),
// in its order, so on equal inputs the kernel gives its bits: |q|^2, |s|^2
// and each q.s in the pinned order (32 running sums over t mod 32, then a
// halving tree), the distance and exp as in `affinity`, and the sum over a
// in the same pinned order (running sum l over a = l, l + 32, ..., then the
// tree), with separate IEEE multiplies and adds. A thread computes a dot's
// 32 running sums one after another, in bit-reversed order, and folds each
// into the halving tree as it completes, so a dot holds six registers
// instead of 32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_kernels::affinity;
using repro_kernels::beats;
using repro_kernels::warp_tree32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;                 // supports staged at a time
constexpr int kTA = 4;                     // supports per thread
constexpr int kSupGroups = kChunk / kTA;   // 8
constexpr int kQueryGroups = kThreads / kSupGroups;  // 16
constexpr int kRedLd = 33;                 // row stride of the lane sums

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
struct Dots {
  static __device__ __forceinline__ void run(
      const float* qs, const float* ss, int ld, int nch, int tq, int ta,
      float (&stack)[5][TQ][kTA], float (&dot)[TQ][kTA]) {
    constexpr int l = Leaf<J>::kLane;
    float leaf[TQ][kTA];
    {
      float qv[TQ], sv[kTA];
#pragma unroll
      for (int r = 0; r < TQ; ++r) qv[r] = qs[(tq + kQueryGroups * r) * ld + l];
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
    Dots<TQ, J + 1>::run(qs, ss, ld, nch, tq, ta, stack, dot);
  }
};

template <int TQ>
struct Dots<TQ, 32> {
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

template <int TQ>
__global__ void __launch_bounds__(kThreads) assign_scores_kernel(
    const float* __restrict__ q, const float* __restrict__ s,
    const float* __restrict__ w, float* __restrict__ scores, int m,
    int n_clusters, int a_cap, int d, int n_tiles, float k) {
  constexpr int kTileQ = kQueryGroups * TQ;
  extern __shared__ float smem[];
  const int dp = (d + 31) & ~31;
  const int nch = dp >> 5;
  const int ld = dp + 1;  // odd: a warp's rows land in distinct banks
  float* qs = smem;                     // (kTileQ, ld) queries
  float* ss = qs + kTileQ * ld;         // (kChunk, ld) supports
  float* red = ss + kChunk * ld;        // (kTileQ, kRedLd) lane sums
  float* q2s = red + kTileQ * kRedLd;   // (kTileQ,)
  float* s2s = q2s + kTileQ;            // (kChunk,)
  float* ws = s2s + kChunk;             // (kChunk,)

  const int tile = blockIdx.x % n_tiles;
  const long c = blockIdx.x / n_tiles;
  const int i0 = tile * kTileQ;
  const int rows = min(kTileQ, m - i0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tq = tid / kSupGroups, ta = tid % kSupGroups;
  // row tq is the thread's lowest query row: past the tile's last real
  // query the thread only helps stage
  const bool live = tq < rows;

  stage(qs, ld, dp, q + static_cast<long>(i0) * d, rows, d, kTileQ);
  __syncthreads();
  for (int r = warp; r < kTileQ; r += kWarps) {
    const float v = warp_row_sq(qs + r * ld, nch, lane);
    if (lane == 0) q2s[r] = v;
  }

  const float* sc = s + c * a_cap * d;
  const float* wc = w + c * a_cap;
  float run[TQ][kTA];  // running sum ta + 8 t of query tq + 16 r
  for (int a0 = 0; a0 < a_cap; a0 += kChunk) {
    __syncthreads();  // the previous chunk is read; q2s is written
    const int n_sup = min(kChunk, a_cap - a0);
    stage(ss, ld, dp, sc + static_cast<long>(a0) * d, n_sup, d, kChunk);
    if (tid < kChunk) ws[tid] = tid < n_sup ? __ldg(wc + a0 + tid) : 0.f;
    __syncthreads();
    for (int r = warp; r < kChunk; r += kWarps) {
      const float v = warp_row_sq(ss + r * ld, nch, lane);
      if (lane == 0) s2s[r] = v;
    }
    __syncthreads();
    if (!live) continue;
    float stack[5][TQ][kTA];
    float dot[TQ][kTA];
    Dots<TQ, 0>::run(qs, ss, ld, nch, tq, ta, stack, dot);
#pragma unroll
    for (int r = 0; r < TQ; ++r) {
#pragma unroll
      for (int t = 0; t < kTA; ++t) {
        const int j = ta + kSupGroups * t;
        // products past the last support are the plain version's zero pad
        const float p =
            j < n_sup ? __fmul_rn(affinity(q2s[tq + kQueryGroups * r],
                                           s2s[j], dot[r][t], k),
                                  ws[j])
                      : 0.f;
        run[r][t] = a0 == 0 ? p : __fadd_rn(run[r][t], p);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int r = 0; r < TQ; ++r) {
#pragma unroll
      for (int t = 0; t < kTA; ++t) {
        red[(tq + kQueryGroups * r) * kRedLd + ta + kSupGroups * t] =
            run[r][t];
      }
    }
  }
  __syncthreads();
  for (int r = warp; r < rows; r += kWarps) {
    const float v = warp_tree32(red[r * kRedLd + lane]);
    if (lane == 0) scores[static_cast<long>(i0 + r) * n_clusters + c] = v;
  }
}

__global__ void __launch_bounds__(kThreads) assign_pick_kernel(
    const float* __restrict__ scores, const float* __restrict__ dens,
    const uint8_t* __restrict__ valid, int32_t* __restrict__ labels,
    float* __restrict__ bscore, int m, int n_clusters, float t) {
  const int lane = threadIdx.x & 31;
  const long i = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (i >= m) return;
  const float* row = scores + i * n_clusters;
  float bs = -INFINITY;
  int bj = 0x7fffffff;  // loses to every real entry
  for (int c = lane; c < n_clusters; c += 32) {
    const float v = row[c];
    if (beats(v, c, bs, bj)) { bs = v; bj = c; }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float so = __shfl_xor_sync(0xffffffffu, bs, off);
    const int jo = __shfl_xor_sync(0xffffffffu, bj, off);
    if (beats(so, jo, bs, bj)) { bs = so; bj = jo; }
  }
  if (lane == 0) {
    const bool in = valid == nullptr || valid[i] != 0;
    const bool ok = bs >= __fmul_rn(t, dens[bj]);
    labels[i] = in && ok ? bj : -1;
    bscore[i] = in ? bs : 0.f;
  }
}

template <int TQ>
cudaError_t launch_scores(const float* q, const float* s, const float* w,
                          float* scores, int m, int n_clusters, int a_cap,
                          int d, float k, int smem_bytes,
                          cudaStream_t stream) {
  // raise the dynamic shared-memory limit only when a launch needs more
  // than before, so that repeated launches (and CUDA graph captures of
  // them) make no further API call
  static int smem_limit = 0;
  if (smem_bytes > smem_limit) {
    const cudaError_t err = cudaFuncSetAttribute(
        assign_scores_kernel<TQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    smem_limit = smem_bytes;
  }
  constexpr int kTileQ = kQueryGroups * TQ;
  const int n_tiles = (m + kTileQ - 1) / kTileQ;
  const long blocks = static_cast<long>(n_tiles) * n_clusters;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  assign_scores_kernel<TQ><<<static_cast<unsigned>(blocks), kThreads,
                             smem_bytes, stream>>>(
      q, s, w, scores, m, n_clusters, a_cap, d, n_tiles, k);
  return cudaGetLastError();
}

}  // namespace

// tq (4 or 1) and smem_bytes come from kernels/assign.py `smem_plan`, whose
// byte count is the layout carved at the top of assign_scores_kernel.
extern "C" int assign_launch(const float* q, const float* s, const float* w,
                             const float* dens, const uint8_t* valid,
                             float* scores, int32_t* labels, float* bscore,
                             int m, int n_clusters, int a_cap, int d, int tq,
                             int smem_bytes, float k, float t, void* stream) {
  if (m <= 0 || n_clusters <= 0 || a_cap <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (tq == 4) {
    err = launch_scores<4>(q, s, w, scores, m, n_clusters, a_cap, d, k,
                           smem_bytes, st);
  } else if (tq == 1) {
    err = launch_scores<1>(q, s, w, scores, m, n_clusters, a_cap, d, k,
                           smem_bytes, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  assign_pick_kernel<<<(m + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      scores, dens, valid, labels, bscore, m, n_clusters, t);
  return static_cast<int>(cudaGetLastError());
}
