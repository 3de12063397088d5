// Fused multi-iteration LID sweep (paper Sec. 4.1, Eq. 9-14), one thread-
// block cluster per seed.
//
// Replaces the TPU kernel `lid_sweep_pallas` (src/repro/kernels/
// lid_sweep.py, `_make_kernel`). For each seed b it runs up to n_steps
// infection-immunization iterations over the seed's (cap, d) support block,
// each guarded by ~converged & n_iters < max_iters:
//   pi = x . Ax; r = mask ? Ax - pi : 0; C1 = r > tol, C2 = r < -tol & x > 0;
//   i = argmax over C1 u C2 of |r| (ties to the LOWEST slot, as jnp.argmax);
//   done = |r_i| <= tol; unless done: the invasion share eps (Eq. 9/11/12),
//   the affinity column exp(-k ||v_j - v_i||) (expansion form, zeroed on the
//   same global id and off-mask), x += eps*mu*(e_i - x) clamped at 0, and
//   Ax += eps*mu*(col - Ax); optionally, every refresh_every iterations, Ax
//   is recomputed exactly as the masked matvec over the support, contracted
//   in the pinned `tree_matvec` order. n_iters is cumulative across calls.
//
// What bounds it on an H100: latency. A step is a chain (pi, an argmax over
// cap, a few scalar divisions, cap d-long dots, the update) of ~60 KFLOP at
// cap = 240, d = 128, far from the card's byte or flop peaks, and a launch
// first has to bring the seed's rows on chip. The design:
//
// - a seed runs on a cluster of cs blocks (cs from B: B x cs <= 132 SMs,
//   kernels/lid_sweep.py `plan`); block q stages only its slice of
//   ceil(cap / cs) rows, leaf-major (common.cuh), into shared memory;
// - every block keeps the full cap-long lanes x, Ax (two buffers each, one
//   read and one written by a step), |v|^2, ids and mask, and computes pi,
//   the argmax, the scalars and the x update for ALL slots itself: in
//   every warp, with no barrier (the argmax by __reduce_max/min_sync on a
//   key that orders scores as torch.argmax does);
// - a block computes the column, and the new Ax, for its own rows only,
//   four threads a row: thread t owns the running sums l = t mod 4 of the
//   pinned dot, a complete subtree of its halving tree, and two xor
//   shuffles finish it. v_i is read from its owner's shared memory
//   (distributed shared memory) and the new Ax of a row is stored into
//   every block of the cluster: one cluster barrier a step;
// - a lane converged, or at max_iters, on entry copies its lanes out and
//   returns before staging anything.
//
// Where a slice does not fit in shared memory even at cs = 8, the same
// schedule reads the rows in place from device memory ("global" route).
// The rows may be stored as f32 or bf16 (the JAX package's storage dtype):
// the smem route widens bf16 rows to f32 as it stages them, so its shared
// layout and every line of arithmetic are the f32 kernel's, and one
// instantiation serves both (the staging branches on `bf16_rows`); the
// global route widens each element as it reads it (an instantiation a
// storage type). Widening is exact, so on bf16 rows the kernel gives the
// bits it gives on the upcast f32 rows.
// Every operation is the plain PyTorch version's, in its order: pi, |v|^2
// and the d-long dots in the pinned order of kernels/ref.py (`pinned_sum`),
// the refresh's contraction in `tree_matvec`'s (a stack over the columns in
// bit-reversed order), the scalar chain and the x/Ax updates as separate
// IEEE multiplies and adds (__fmul_rn/__fadd_rn keep the compiler from
// fusing them), so on equal inputs the kernel gives its plain version's
// bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using repro_kernels::LeafMajor;
using repro_kernels::NaturalT;
using repro_kernels::TreeStack;
using repro_kernels::affinity;
using repro_kernels::bit_reverse;
using repro_kernels::clamp_max;
using repro_kernels::clamp_min0;
using repro_kernels::quad_dot;
using repro_kernels::leaf_groups;

constexpr int kMaxThreads = 256;
constexpr int kRefreshDepth = 14;  // the refresh's stack: cap <= 8192
constexpr int kNone = 0x7fffffff;

// A candidate's score |r| as an unsigned key whose order is the argmax's:
// a candidate has r > tol or r < -tol, so |r| is +0 .. +inf, never NaN,
// and its bits grow with its value; 0 is "no candidate" (score -inf).
__device__ __forceinline__ unsigned score_key(float s) {
  return __float_as_uint(s) + 1u;
}

__device__ __forceinline__ float key_score(unsigned key) {
  return key == 0u ? -INFINITY : __uint_as_float(key - 1u);
}

// every thread of the cluster arrives, stores before the arrival are
// visible to every thread after the wait
__device__ __forceinline__ void cluster_barrier(int cs) {
  if (cs > 1) {
    asm volatile(
        "barrier.cluster.arrive.release.aligned;\n\t"
        "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  } else {
    __syncthreads();
  }
}

// store v at slot j of the buffer `buf` of every block of the cluster, the
// four threads of a quad taking the ranks t, t + 4
__device__ __forceinline__ void store_all(float* buf, int j, float v, int t,
                                          int cs, int rank) {
  if (cs == 1) {
    if (t == 0) buf[j] = v;
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  for (int q = t; q < cs; q += 4) {
    float* dst = q == rank ? buf + j : cluster.map_shared_rank(buf + j, q);
    *dst = v;
  }
}

// T: the storage type of the rows the global route reads in place, float
// or __nv_bfloat16; the smem route is instantiated for T = float and reads
// v_g as bf16 rows where bf16_rows is set
template <class T, bool kSmemRows>
__global__ void __launch_bounds__(kMaxThreads) lid_sweep_kernel(
    const T* __restrict__ v_g, const int32_t* __restrict__ idx_g,
    const uint8_t* __restrict__ mask_g, const float* __restrict__ x_g,
    const float* __restrict__ ax_g, const int32_t* __restrict__ it_g,
    const uint8_t* __restrict__ cv_g, float* __restrict__ x_out,
    float* __restrict__ ax_out, int32_t* __restrict__ it_out,
    uint8_t* __restrict__ cv_out, int cap, int d, float k, int n_steps,
    int max_iters, float tol, int refresh_every, float support_eps, int cs,
    int rows_per, int bf16_rows) {
  using Src =
      typename std::conditional<kSmemRows, LeafMajor, NaturalT<T>>::type;
  using Row = typename Src::Elem;  // a row as the dots read it
  extern __shared__ float4 smem4[];
  const int rank = cs > 1 ? static_cast<int>(cg::this_cluster().block_rank())
                          : 0;
  const long b = blockIdx.x / cs;
  const int r0 = rank * rows_per;
  const int r1 = min(cap, r0 + rows_per);
  const int tid = threadIdx.x, lane = tid & 31, t = tid & 3;
  const int quad = tid >> 2, nquads = blockDim.x >> 2;
  const long lb = b * cap;

  int it = it_g[b];
  bool cv = cv_g[b] != 0;
  if (cv || it >= max_iters || n_steps <= 0) {  // nothing to run
    for (int j = r0 + tid; j < r1; j += blockDim.x) {
      x_out[lb + j] = x_g[lb + j];
      ax_out[lb + j] = ax_g[lb + j];
    }
    if (rank == 0 && tid == 0) {
      it_out[b] = it;
      cv_out[b] = cv ? 1 : 0;
    }
    return;
  }

  const int ng = leaf_groups(d);
  const int ldr = 128 * ng + 16;  // two rows of a quarter-warp: all banks
  const int prm = kSmemRows ? 4 * ng : d;
  // the lanes, padded to a multiple of 32 slots with zeros (x = Ax = 0,
  // mask off): pi's and the argmax's loops then need no bounds test, and
  // the pads add +0 products and -inf scores at the highest slots, as the
  // plain version's zero padding does
  const int capp = (cap + 31) & ~31;
  float* smem = reinterpret_cast<float*>(smem4);
  float* xb = smem;               // x, two buffers
  float* axb = xb + 2 * capp;     // Ax, two buffers
  float* v2 = axb + 2 * capp;     // |v_j|^2
  int* idx = reinterpret_cast<int*>(v2 + capp);
  int* msk = idx + capp;
  float* rows = smem + 7 * capp;  // this block's slice

  for (int j = tid; j < capp; j += blockDim.x) {
    const bool in = j < cap;
    xb[j] = xb[capp + j] = in ? x_g[lb + j] : 0.f;
    axb[j] = axb[capp + j] = in ? ax_g[lb + j] : 0.f;
    idx[j] = in ? idx_g[lb + j] : -1;
    msk[j] = in && mask_g[lb + j] != 0;
  }
  if constexpr (kSmemRows) {
    // this block's slice widened to f32 as it is staged: the one place
    // the smem route reads the storage type
    auto stage = [&](auto* v) {
      repro_kernels::stage_leaf_major(
          rows, ldr, ng, d, rows_per, v + lb * d,
          [&](int r) -> decltype(v) {
            return r0 + r < r1 ? v + (lb + r0 + r) * static_cast<long>(d)
                               : nullptr;
          });
    };
    if (bf16_rows) {
      stage(reinterpret_cast<const __nv_bfloat16*>(v_g));
    } else {
      stage(reinterpret_cast<const float*>(v_g));
    }
  }
  __syncthreads();

  // a row of the seed: this block's (or a peer's) slice, or device memory
  auto row_of = [&](int j) -> const Row* {
    if constexpr (kSmemRows) {
      const int owner = j / rows_per;
      const float* base = rows + (j - owner * rows_per) * ldr;
      return owner == rank ? base
                           : cg::this_cluster().map_shared_rank(base, owner);
    } else {
      return v_g + (lb + j) * static_cast<long>(d);
    }
  };
  // this block's rows a quad at a time; every thread runs every round so
  // that the quads' shuffles see whole warps
  const int rounds = (rows_per + nquads - 1) / nquads;
  auto own_row = [&](int jj) -> const Row* {
    if constexpr (kSmemRows) {
      return rows + min(jj, rows_per - 1) * ldr;
    } else {
      return v_g + (lb + min(r0 + jj, cap - 1)) * static_cast<long>(d);
    }
  };

  for (int rd = 0; rd < rounds; ++rd) {  // |v_j|^2 of this block's rows
    const int jj = quad + rd * nquads;
    const Row* vj = own_row(jj);
    const float s = quad_dot<Src>(vj, vj, t, ng, prm);
    if (t == 0 && r0 + jj < r1) v2[r0 + jj] = s;
  }
  cluster_barrier(cs);  // every block started, every slice's |v|^2 made
  if (cs > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    for (int j = tid; j < cap; j += blockDim.x) {
      const int owner = j / rows_per;
      if (owner != rank) v2[j] = *cluster.map_shared_rank(v2 + j, owner);
    }
  }
  __syncthreads();
  bool peers_quiet = cs == 1;  // no peer reads this block's memory any more

  int cur = 0;
  for (int step = 0; step < n_steps; ++step) {
    if (cv || it >= max_iters) break;  // cluster-uniform guard
    const float* x = xb + cur * capp;
    const float* ax = axb + cur * capp;
    // pi in the pinned order, by every warp
    float acc = __fmul_rn(x[lane], ax[lane]);
#pragma unroll 4
    for (int c = 32; c < capp; c += 32) {
      acc = __fadd_rn(acc, __fmul_rn(x[c + lane], ax[c + lane]));
    }
    const float pi = repro_kernels::warp_tree32(acc);
    // the argmax, by every warp: the lowest slot of the largest key (a
    // lane keeps its first slot unless a later one has a larger key)
    unsigned best = 0u;
    int bj = lane;
#pragma unroll 4
    for (int j = lane; j < capp; j += 32) {
      // every load and test unconditional (bitwise & and |), so that the
      // slots' loads all issue ahead of their use
      const bool mj = msk[j] != 0;
      const float xj = x[j], axj = ax[j];
      const float r = mj ? __fsub_rn(axj, pi) : 0.f;
      const bool cand = mj & ((r > tol) | ((r < -tol) & (xj > 0.f)));
      const unsigned key = cand ? score_key(fabsf(r)) : 0u;
      const bool better = key > best;
      best = better ? key : best;
      bj = better ? j : bj;
    }
    const unsigned top = __reduce_max_sync(0xffffffffu, best);
    const int i = __reduce_min_sync(0xffffffffu, best == top ? bj : kNone);
    const bool done = key_score(top) <= tol;

    if (!done) {
      const float axi = ax[i];
      const float xi = x[i];
      const float ri = __fsub_rn(axi, pi);  // mask[i] holds: score > tol
      const float mu = ri > 0.f
          ? 1.f : __fdiv_rn(xi, clamp_max(__fsub_rn(xi, 1.f), -1e-12f));
      const float num = __fmul_rn(mu, ri);
      const float den = __fmul_rn(__fmul_rn(mu, mu),
                                  __fadd_rn(__fmul_rn(-2.f, axi), pi));
      const float eps =
          den < 0.f ? clamp_max(__fdiv_rn(-num, den), 1.f) : 1.f;
      const float scale = __fmul_rn(eps, mu);
      const int nxt = cur ^ 1;
      float* xn = xb + nxt * capp;
      float* axn = axb + nxt * capp;
      for (int j = tid; j < cap; j += blockDim.x) {  // x of every slot
        const float onehot = j == i ? 1.f : 0.f;
        const float xj = x[j];
        xn[j] = clamp_min0(
            __fadd_rn(xj, __fmul_rn(scale, __fsub_rn(onehot, xj))));
      }
      if (refresh_every <= 0 || (it + 1) % refresh_every != 0) {
        // the column and Ax of this block's rows
        const Row* vi = row_of(i);
        const float v2i = v2[i];
        const int idi = idx[i];
        for (int rd = 0; rd < rounds; ++rd) {
          const int jj = quad + rd * nquads;
          const int j = min(r0 + jj, cap - 1);
          const float dot = quad_dot<Src>(own_row(jj), vi, t, ng, prm);
          float col = affinity(v2[j], v2i, dot, k);
          if (idx[j] == idi || !msk[j]) col = 0.f;
          const float axj = ax[j];
          if (r0 + jj < r1) {
            store_all(axn, j,
                      __fadd_rn(axj, __fmul_rn(scale, __fsub_rn(col, axj))),
                      t, cs, rank);
          }
        }
      } else {
        // exact Ax of this block's rows = the masked matvec over the
        // support at the new x, the columns l met in bit-reversed order
        __syncthreads();  // xn complete
        int pow2 = 1, bits = 0;
        while (pow2 < cap) {
          pow2 <<= 1;
          ++bits;
        }
        for (int rd = 0; rd < rounds; ++rd) {
          const int jj = quad + rd * nquads;
          const int j = min(r0 + jj, cap - 1);
          const Row* vj = own_row(jj);
          TreeStack<kRefreshDepth> st;
          for (int p = 0; p < pow2; ++p) {
            const int l = bit_reverse(p, bits);
            float prod = 0.f;
            if (l < cap) {  // the same l in every thread
              const float dot = quad_dot<Src>(vj, row_of(l), t, ng, prm);
              const float wl =
                  (msk[l] && xn[l] > support_eps) ? xn[l] : 0.f;
              const float a = idx[j] == idx[l]
                  ? 0.f : affinity(v2[j], v2[l], dot, k);
              prod = __fmul_rn(a, wl);
            }
            st.push(prod, p);
          }
          if (r0 + jj < r1) {
            store_all(axn, j, msk[j] ? st.top(bits) : 0.f, t, cs, rank);
          }
        }
      }
      cluster_barrier(cs);  // every block's Ax rows stored everywhere
      peers_quiet = true;
      cur = nxt;
    }
    it += 1;
    cv = done;
  }

  const float* x = xb + cur * capp;
  const float* ax = axb + cur * capp;
  for (int j = r0 + tid; j < r1; j += blockDim.x) {
    x_out[lb + j] = x[j];
    ax_out[lb + j] = ax[j];
  }
  if (rank == 0 && tid == 0) {
    it_out[b] = it;
    cv_out[b] = cv ? 1 : 0;
  }
  // a block leaves only once no peer can still read its shared memory
  if (!peers_quiet) cluster_barrier(cs);
}

template <class T, bool kSmemRows>
int launch(const T* v, const int32_t* idx, const uint8_t* mask,
           const float* x, const float* ax, const int32_t* it,
           const uint8_t* cv, float* x_out, float* ax_out, int32_t* it_out,
           uint8_t* cv_out, int batch, int cap, int d, float k, int n_steps,
           int max_iters, float tol, int refresh_every, float support_eps,
           int cs, int threads, int rows_per, int smem_bytes, int bf16_rows,
           cudaStream_t stream) {
  // raise the dynamic shared-memory limit only when a launch needs more
  // than before, so that repeated launches (and CUDA graph captures of
  // them) make no further API call
  static int smem_limit = 0;
  if (smem_bytes > smem_limit) {
    const cudaError_t err = cudaFuncSetAttribute(
        lid_sweep_kernel<T, kSmemRows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_limit = smem_bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * cs);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, lid_sweep_kernel<T, kSmemRows>, v, idx, mask, x, ax, it, cv, x_out,
      ax_out, it_out, cv_out, cap, d, k, n_steps, max_iters, tol,
      refresh_every, support_eps, cs, rows_per, bf16_rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_route(const T* v, const int32_t* idx, const uint8_t* mask,
                 const float* x, const float* ax, const int32_t* it,
                 const uint8_t* cv, float* x_out, float* ax_out,
                 int32_t* it_out, uint8_t* cv_out, int batch, int cap, int d,
                 float k, int n_steps, int max_iters, float tol,
                 int refresh_every, float support_eps, int cs, int threads,
                 int rows_per, int smem_rows, int smem_bytes, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the smem route's one instantiation takes the rows' type at run time
  return smem_rows
      ? launch<float, true>(reinterpret_cast<const float*>(v), idx, mask, x,
                            ax, it, cv, x_out, ax_out, it_out, cv_out, batch,
                            cap, d, k, n_steps, max_iters, tol,
                            refresh_every, support_eps, cs, threads,
                            rows_per, smem_bytes,
                            std::is_same<T, __nv_bfloat16>::value, s)
      : launch<T, false>(v, idx, mask, x, ax, it, cv, x_out, ax_out, it_out,
                         cv_out, batch, cap, d, k, n_steps, max_iters, tol,
                         refresh_every, support_eps, cs, threads, rows_per,
                         smem_bytes, 0, s);
}

}  // namespace

// The plan (cs, threads, rows_per, smem_rows, smem_bytes) comes from
// kernels/lid_sweep.py `plan`. A refused cluster launch returns its error.
// v_beta is f32 (lid_sweep_launch) or bf16 (lid_sweep_bf16_launch); every
// other argument is the same.
extern "C" int lid_sweep_launch(
    const float* v, const int32_t* idx, const uint8_t* mask, const float* x,
    const float* ax, const int32_t* it, const uint8_t* cv, float* x_out,
    float* ax_out, int32_t* it_out, uint8_t* cv_out, int batch, int cap,
    int d, float k, int n_steps, int max_iters, float tol, int refresh_every,
    float support_eps, int cs, int threads, int rows_per, int smem_rows,
    int smem_bytes, void* stream) {
  return launch_route(v, idx, mask, x, ax, it, cv, x_out, ax_out, it_out,
                      cv_out, batch, cap, d, k, n_steps, max_iters, tol,
                      refresh_every, support_eps, cs, threads, rows_per,
                      smem_rows, smem_bytes, stream);
}

extern "C" int lid_sweep_bf16_launch(
    const __nv_bfloat16* v, const int32_t* idx, const uint8_t* mask,
    const float* x, const float* ax, const int32_t* it, const uint8_t* cv,
    float* x_out, float* ax_out, int32_t* it_out, uint8_t* cv_out, int batch,
    int cap, int d, float k, int n_steps, int max_iters, float tol,
    int refresh_every, float support_eps, int cs, int threads, int rows_per,
    int smem_rows, int smem_bytes, void* stream) {
  return launch_route(v, idx, mask, x, ax, it, cv, x_out, ax_out, it_out,
                      cv_out, batch, cap, d, k, n_steps, max_iters, tol,
                      refresh_every, support_eps, cs, threads, rows_per,
                      smem_rows, smem_bytes, stream);
}
