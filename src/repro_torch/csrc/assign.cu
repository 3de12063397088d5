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
// inside a warp or a block. Blocks run in no order, so the argmax over
// clusters is a second pass (assign_pick_kernel: a warp per query). The
// scores come from one of two kernels, which kernels/assign.py `plan`
// picks from m, C, A and d:
//
// 1. assign_lanes_kernel (few rows: serving's occupied slots, and any d).
//    What bounds it: bytes, each support row read once (252 MB at 2,048 x
//    240 x 128, 0.0757 ms at 3.35 TB/s). A warp takes one cluster and a
//    group of M <= 16 queries, and streams the cluster's supports straight
//    from device memory, G = 32 / M rows at a time, d in chunks of 32
//    columns: lane l holds the terms t = l (mod 32) of every (query,
//    support) dot, which are exactly the pinned order's 32 running sums,
//    so d may be anything (C2). A transposing reduction (each step halves
//    the values a lane keeps) then ends with the halving tree of dot p in
//    lane p, 31 shuffles for 32 dots. Lane (i, k) keeps the sum over a in
//    its residues a = g G + k (mod 32), so the tree over a is adds in the
//    lane and shuffles across it. No shared memory, no block barrier.
// 2. assign_tiles_kernel (many rows: bulk predict, a full 64-slot batch).
//    What bounds it: operations (2 m C A d: 8.05 GFLOP for a 64-row batch,
//    0.120 ms at the f32 peak of 67 TFLOP/s; the pinned order rules out
//    fused multiply-adds, so the SIMT ceiling is half that). A block of
//    128 threads holds a 64-query tile in shared memory and walks a slice
//    of the clusters, so the tile and its norms are staged once; support
//    chunks of 32 rows stream through two cp.async buffers, the next
//    loading while the current one is computed; each thread computes a
//    4-query x 4-support register tile of dots (every shared-memory load
//    feeds four products), and the sum over a ends in shuffles among the
//    eight threads of a query row. 68 KB a block at d = 128.
//
// Every sum is the plain PyTorch version's (kernels/ref.py `assign_ref`),
// in its order, so on equal inputs both kernels give its bits: |q|^2, |s|^2
// and each q.s in the pinned order (32 running sums over t mod 32, then a
// halving tree), the distance and exp as in `affinity`, and the sum over a
// in the same pinned order (running sum l over a = l, l + 32, ..., then the
// tree), with separate IEEE multiplies and adds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_kernels::affinity;
using repro_kernels::beats;
using repro_kernels::kQueryGroups;
using repro_kernels::kSupGroups;
using repro_kernels::kTA;
using repro_kernels::PinnedDots;
using repro_kernels::warp_row_sq;

constexpr int kThreads = repro_kernels::kTileThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = repro_kernels::kChunkRows;  // supports staged at a time
constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------ 1. lanes ----
// The transposing reduction of V = 2^LV values a lane holds: at each step
// of the halving tree (offsets 16, 8, ..., 1) a lane keeps half of its
// values, the half its lane bit names, and adds its partner's copy of that
// half; once one value is left, the steps add it across lanes. Each sum is
// the tree's s[l] + s[l + off] (IEEE addition commutes), and value j ends in
// the lanes whose top LV bits are j.
// c ? a : b as one select instruction, so that the compiler cannot turn a
// choice between two elements of a register array into an index into
// local memory
__device__ __forceinline__ float select(int c, float a, float b) {
  float r;
  asm("{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\nselp.f32 %0, %1, %2, p;\n}\n"
      : "=f"(r)
      : "f"(a), "f"(b), "r"(c));
  return r;
}

// one step of it at lane offset `off`, HALF values kept (0: one value,
// added across the lanes)
template <int HALF>
__device__ __forceinline__ void transpose_step(float* x, int lane, int off) {
  if constexpr (HALF == 0) {
    x[0] = __fadd_rn(x[0], __shfl_xor_sync(kFull, x[0], off));
  } else {
    const int upper = lane & off;
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const float keep = select(upper, x[j + HALF], x[j]);
      const float send = select(upper, x[j], x[j + HALF]);
      x[j] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, off));
    }
  }
}

template <int LV>
__device__ __forceinline__ float transpose_tree(float (&x)[1 << LV],
                                                int lane) {
  constexpr int V = 1 << LV;
  transpose_step<V / 2>(x, lane, 16);
  transpose_step<V / 4>(x, lane, 8);
  transpose_step<V / 8>(x, lane, 4);
  transpose_step<V / 16>(x, lane, 2);
  transpose_step<V / 32>(x, lane, 1);
  return x[0];
}

template <int N>
struct Log2 {
  static constexpr int value = N <= 1 ? 0 : 1 + Log2<N / 2>::value;
};
template <>
struct Log2<1> {
  static constexpr int value = 0;
};

// One warp per (cluster c, group of M queries). Lane p = i G + k holds, after
// each group of G supports, the dot of query i with support k.
template <int M>
__global__ void __launch_bounds__(kThreads) assign_lanes_kernel(
    const float* __restrict__ q, const float* __restrict__ s,
    const float* __restrict__ w, float* __restrict__ scores, int m,
    int n_clusters, int a_cap, int d, long n_tasks, float k) {
  constexpr int G = 32 / M;                 // supports a group
  constexpr int CH = M < 4 ? M : 4;         // chunks of d a batch of loads
  constexpr int LM = Log2<M>::value, LG = Log2<G>::value;
  const long task = static_cast<long>(blockIdx.x) * kWarps +
                    (threadIdx.x >> 5);
  if (task >= n_tasks) return;
  const int lane = threadIdx.x & 31;
  const int c = static_cast<int>(task % n_clusters);
  const int i0 = static_cast<int>(task / n_clusters) * M;
  const int nch = (d + 31) >> 5;
  const int my_i = lane >> LG, my_k = lane & (G - 1);

  // |q_i|^2 of the group, query i's in the lanes of query i
  float q2;
  {
    float acc[M];
#pragma unroll
    for (int i = 0; i < M; ++i) acc[i] = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      const int t = (ch << 5) + lane;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const float x = t < d && i0 + i < m
                            ? __ldg(q + static_cast<long>(i0 + i) * d + t)
                            : 0.f;
        const float pr = __fmul_rn(x, x);
        acc[i] = ch == 0 ? pr : __fadd_rn(acc[i], pr);
      }
    }
    q2 = transpose_tree<LM>(acc, lane);
  }

  const float* sc = s + static_cast<long>(c) * a_cap * d;
  const float* wc = w + static_cast<long>(c) * a_cap;
  // running sums of the residues g G + my_k, g < M; run[0] is the current
  // group's, and the array turns by one after each group, so that every
  // index is known to the compiler
  float run[M];
  for (int a32 = 0; a32 < a_cap; a32 += 32) {
#pragma unroll 1
    for (int g = 0; g < M; ++g) {
      const int a0 = a32 + g * G;
      float dot[32], sq[G];
      // d in batches of CH chunks: the batch's CH x G support loads (32 for
      // M <= 4) are issued together, then each chunk's query loads (from
      // L1) and products
      for (int ch0 = 0; ch0 < nch; ch0 += CH) {
        float sv[CH][G];
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          const int t = ((ch0 + u) << 5) + lane;
#pragma unroll
          for (int kk = 0; kk < G; ++kk) {
            sv[u][kk] = t < d && a0 + kk < a_cap
                            ? __ldg(sc + static_cast<long>(a0 + kk) * d + t)
                            : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          const int ch = ch0 + u;
          if (ch >= nch) break;  // no chunk past the zero pad to 32
          const int t = (ch << 5) + lane;
          float qv[M];
#pragma unroll
          for (int i = 0; i < M; ++i) {
            qv[i] = t < d && i0 + i < m
                        ? __ldg(q + static_cast<long>(i0 + i) * d + t)
                        : 0.f;
          }
#pragma unroll
          for (int kk = 0; kk < G; ++kk) {
            const float pr = __fmul_rn(sv[u][kk], sv[u][kk]);
            sq[kk] = ch == 0 ? pr : __fadd_rn(sq[kk], pr);
          }
#pragma unroll
          for (int i = 0; i < M; ++i) {
#pragma unroll
            for (int kk = 0; kk < G; ++kk) {
              const float pr = __fmul_rn(qv[i], sv[u][kk]);
              dot[i * G + kk] =
                  ch == 0 ? pr : __fadd_rn(dot[i * G + kk], pr);
            }
          }
        }
      }
      const float dv = transpose_tree<5>(dot, lane);
      const float s2all = transpose_tree<LG>(sq, lane);
      const float s2 = __shfl_sync(kFull, s2all, my_k << (5 - LG));
      const int a = a0 + my_k;
      // products past the last support are the plain version's zero pad
      const float pr =
          a < a_cap ? __fmul_rn(affinity(q2, s2, dv, k), __ldg(wc + a)) : 0.f;
      run[0] = a32 == 0 ? pr : __fadd_rn(run[0], pr);
      const float first = run[0];
#pragma unroll
      for (int r = 0; r + 1 < M; ++r) run[r] = run[r + 1];
      run[M - 1] = first;
    }
  }
  // the halving tree over the 32 residues r = g G + my_k: levels of offset
  // >= G inside the lane, the rest across the lanes of query my_i
#pragma unroll
  for (int off = 16; off >= G; off >>= 1) {
#pragma unroll
    for (int g = 0; g < off / G; ++g) {
      run[g] = __fadd_rn(run[g], run[g + off / G]);
    }
  }
  float v = run[0];
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  }
  if (my_k == 0 && i0 + my_i < m) {
    scores[static_cast<long>(i0 + my_i) * n_clusters + c] = v;
  }
}

// ------------------------------------------------------------ 2. tiles ----
constexpr int kTileQ = kQueryGroups * 4;   // 64 queries a tile

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// rows x d floats (row stride d) into shared rows of stride ld, zero-filled
// past d and past the last real row, asynchronously
__device__ __forceinline__ void stage_async(float* dst, int ld, int dp,
                                            const float* src, int rows,
                                            int d, int rows_cap) {
  for (int e = threadIdx.x; e < rows_cap * dp; e += kThreads) {
    const int r = e / dp, col = e - r * dp;
    const bool ok = r < rows && col < d;
    cp_async4(dst + r * ld + col, ok ? src + static_cast<long>(r) * d + col
                                     : src,
              ok);
  }
}

__global__ void __launch_bounds__(kThreads) assign_tiles_kernel(
    const float* __restrict__ q, const float* __restrict__ s,
    const float* __restrict__ w, float* __restrict__ scores, int m,
    int n_clusters, int a_cap, int d, float k) {
  extern __shared__ float smem[];
  const int dp = (d + 31) & ~31;
  const int nch = dp >> 5;
  const int ld = dp + 4;  // 16-byte rows; a warp's 8 rows in distinct banks
  float* qs = smem;                       // (kTileQ, ld) queries
  float* ss = qs + kTileQ * ld;           // [2] (kChunk, ld) supports
  float* q2s = ss + 2 * kChunk * ld;      // (kTileQ,)
  float* s2s = q2s + kTileQ;              // [2] (kChunk,)
  float* ws = s2s + 2 * kChunk;           // [2] (kChunk,)

  const int i0 = blockIdx.x * kTileQ;
  const int rows = min(kTileQ, m - i0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tq = tid / kSupGroups, ta = tid % kSupGroups;
  const bool live = tq < rows;
  const int n_a = (a_cap + kChunk - 1) / kChunk;
  // this block's steps: (cluster c, chunk a0) for c = blockIdx.y, +
  // gridDim.y, ..., every chunk of each
  const int n_mine = (n_clusters - static_cast<int>(blockIdx.y) +
                      static_cast<int>(gridDim.y) - 1) / gridDim.y;
  const long n_steps = static_cast<long>(n_mine) * n_a;
  auto prefetch = [&](long step, int buf) {
    const long c = blockIdx.y + (step / n_a) * static_cast<long>(gridDim.y);
    const int a0 = static_cast<int>(step % n_a) * kChunk;
    const int n_sup = min(kChunk, a_cap - a0);
    stage_async(ss + buf * kChunk * ld, ld, dp, s + (c * a_cap + a0) * d,
                n_sup, d, kChunk);
    if (tid < kChunk) {
      const bool ok = tid < n_sup;
      cp_async4(ws + buf * kChunk + tid, ok ? w + c * a_cap + a0 + tid : w,
                ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  stage_async(qs, ld, dp, q + static_cast<long>(i0) * d, rows, d, kTileQ);
  if (n_steps > 0) prefetch(0, 0);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  for (int r = warp; r < kTileQ; r += kWarps) {
    const float v = warp_row_sq(qs + r * ld, nch, lane);
    if (lane == 0) q2s[r] = v;
  }

  float run[4][kTA] = {};  // running sum ta + 8 t of query tq + 16 r
  for (long step = 0; step < n_steps; ++step) {
    const int buf = static_cast<int>(step & 1);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // chunk `step` in place; the other buffer is free
    if (step + 1 < n_steps) prefetch(step + 1, buf ^ 1);
    const float* ssb = ss + buf * kChunk * ld;
    const float* wsb = ws + buf * kChunk;
    float* s2b = s2s + buf * kChunk;
    for (int r = warp; r < kChunk; r += kWarps) {
      const float v = warp_row_sq(ssb + r * ld, nch, lane);
      if (lane == 0) s2b[r] = v;
    }
    __syncthreads();
    const long c = blockIdx.y + (step / n_a) * static_cast<long>(gridDim.y);
    const int a0 = static_cast<int>(step % n_a) * kChunk;
    const int n_sup = min(kChunk, a_cap - a0);
    if (live) {
      float stack[5][4][kTA];
      float dot[4][kTA];
      PinnedDots<4, 0>::run(qs, ssb, ld, nch, tq, ta, stack, dot);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int t = 0; t < kTA; ++t) {
          const int j = ta + kSupGroups * t;
          // products past the last support are the plain version's zero pad
          const float p =
              j < n_sup ? __fmul_rn(affinity(q2s[tq + kQueryGroups * r],
                                             s2b[j], dot[r][t], k),
                                    wsb[j])
                        : 0.f;
          run[r][t] = a0 == 0 ? p : __fadd_rn(run[r][t], p);
        }
      }
    }
    if (a0 + kChunk >= a_cap) {
      // the cluster's last chunk: the tree over residue ta + 8 t, offsets
      // 16 and 8 inside the thread, 4, 2, 1 across the row's 8 lanes
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float v0 = __fadd_rn(run[r][0], run[r][2]);
        const float v1 = __fadd_rn(run[r][1], run[r][3]);
        v0 = __fadd_rn(v0, v1);
#pragma unroll
        for (int off = 4; off > 0; off >>= 1) {
          v0 = __fadd_rn(v0, __shfl_xor_sync(kFull, v0, off));
        }
        const int row = tq + kQueryGroups * r;
        if (ta == 0 && row < rows) {
          scores[static_cast<long>(i0 + row) * n_clusters + c] = v0;
        }
      }
    }
  }
}

// ------------------------------------------------------------- 3. pick ----
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
    const float so = __shfl_xor_sync(kFull, bs, off);
    const int jo = __shfl_xor_sync(kFull, bj, off);
    if (beats(so, jo, bs, bj)) { bs = so; bj = jo; }
  }
  if (lane == 0) {
    const bool in = valid == nullptr || valid[i] != 0;
    const bool ok = bs >= __fmul_rn(t, dens[bj]);
    labels[i] = in && ok ? bj : -1;
    bscore[i] = in ? bs : 0.f;
  }
}

template <int M>
cudaError_t launch_lanes(const float* q, const float* s, const float* w,
                         float* scores, int m, int n_clusters, int a_cap,
                         int d, float k, cudaStream_t stream) {
  const long n_tasks =
      static_cast<long>((m + M - 1) / M) * static_cast<long>(n_clusters);
  const long blocks = (n_tasks + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  assign_lanes_kernel<M><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(q, s, w, scores, m, n_clusters, a_cap,
                                     d, n_tasks, k);
  return cudaGetLastError();
}

cudaError_t launch_tiles(const float* q, const float* s, const float* w,
                         float* scores, int m, int n_clusters, int a_cap,
                         int d, float k, int slices, int smem_bytes,
                         cudaStream_t stream) {
  // raise the dynamic shared-memory limit only when a launch needs more
  // than before, so that repeated launches (and CUDA graph captures of
  // them) make no further API call
  static int smem_limit = 0;
  if (smem_bytes > smem_limit) {
    const cudaError_t err = cudaFuncSetAttribute(
        assign_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return err;
    smem_limit = smem_bytes;
  }
  const int n_tiles = (m + kTileQ - 1) / kTileQ;
  if (slices <= 0 || slices > 65535 || slices > n_clusters) {
    return cudaErrorInvalidValue;
  }
  assign_tiles_kernel<<<dim3(n_tiles, slices), kThreads, smem_bytes,
                        stream>>>(q, s, w, scores, m, n_clusters, a_cap, d,
                                  k);
  return cudaGetLastError();
}

}  // namespace

// path, rows, slices and smem_bytes come from kernels/assign.py `plan`:
// path 0 the lanes kernel with M = rows queries a warp (1, 2, 4, 8 or 16);
// path 1 the tiles kernel over `slices` slices of the clusters, its shared
// bytes the layout carved at the top of assign_tiles_kernel.
extern "C" int assign_launch(const float* q, const float* s, const float* w,
                             const float* dens, const uint8_t* valid,
                             float* scores, int32_t* labels, float* bscore,
                             int m, int n_clusters, int a_cap, int d,
                             int path, int rows, int slices, int smem_bytes,
                             float k, float t, void* stream) {
  if (m <= 0 || n_clusters <= 0 || a_cap <= 0 || d <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (path == 0) {
    switch (rows) {
      case 1: err = launch_lanes<1>(q, s, w, scores, m, n_clusters, a_cap, d,
                                    k, st); break;
      case 2: err = launch_lanes<2>(q, s, w, scores, m, n_clusters, a_cap, d,
                                    k, st); break;
      case 4: err = launch_lanes<4>(q, s, w, scores, m, n_clusters, a_cap, d,
                                    k, st); break;
      case 8: err = launch_lanes<8>(q, s, w, scores, m, n_clusters, a_cap, d,
                                    k, st); break;
      case 16: err = launch_lanes<16>(q, s, w, scores, m, n_clusters, a_cap,
                                      d, k, st); break;
      default: break;
    }
  } else if (path == 1) {
    err = launch_tiles(q, s, w, scores, m, n_clusters, a_cap, d, k, slices,
                       smem_bytes, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  assign_pick_kernel<<<(m + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      scores, dens, valid, labels, bscore, m, n_clusters, t);
  return static_cast<int>(cudaGetLastError());
}
