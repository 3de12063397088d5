// Fused multi-iteration LID sweep (paper Sec. 4.1, Eq. 9-14), one block per
// seed.
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
// The seed batch, which the JAX package vmapped, is the grid.
//
// What bounds it on an H100: latency. One iteration does O(cap*d) flops
// (~60 KFLOP at cap = 240, d = 128) behind two block-wide reductions (pi,
// argmax) that every later step depends on, so the card is far from its
// byte or flop peaks and the time is the chain of synchronised steps. The
// design keeps the whole working set in shared memory for the entire sweep:
// the (cap, d) rows (padded to d+1 floats per row so the threads of a warp,
// one row each, hit distinct banks), |v_j|^2 computed once, x, Ax, ids and
// mask, so nothing but the final state touches device memory. A block
// holds at most 227 KB; where cap*(d+1)*4 bytes plus the lanes exceed
// that (for example d = 256 at cap = 240) the rows are read from device
// memory, where they stay L2-resident across steps, and only the lanes
// live in shared memory. Every operation is the plain PyTorch version's,
// in its order: pi, |v|^2 and the d-long dots in the pinned order of
// kernels/ref.py (`pinned_sum`), the refresh's contraction in
// `tree_matvec`'s, the scalar chain and the x/Ax updates as separate IEEE
// multiplies and adds (__fmul_rn/__fadd_rn keep the compiler from fusing
// them), so on equal inputs the kernel gives its plain version's bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_kernels::affinity;
using repro_kernels::beats;
using repro_kernels::clamp_max;
using repro_kernels::clamp_min0;
using repro_kernels::pinned_dot;
using repro_kernels::stage_rows;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// pi = sum_j x[j] * ax[j] in the pinned order, by warp 0; every thread
// gets it through shared memory
__device__ float pinned_pi(const float* x, const float* ax, int cap,
                           float* slot) {
  if (threadIdx.x < 32) {
    const int l = threadIdx.x;
    float acc = l < cap ? __fmul_rn(x[l], ax[l]) : 0.f;
    for (int c = 32; c < cap; c += 32) {
      acc = __fadd_rn(acc, c + l < cap ? __fmul_rn(x[c + l], ax[c + l])
                                       : 0.f);
    }
    acc = repro_kernels::warp_tree32(acc);
    if (l == 0) *slot = acc;
  }
  __syncthreads();
  return *slot;
}

__device__ void block_argmax(float s, int j, float* red_s, int* red_j,
                             float* out_s, int* out_j) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const float so = __shfl_down_sync(0xffffffffu, s, off);
    const int jo = __shfl_down_sync(0xffffffffu, j, off);
    if (beats(so, jo, s, j)) { s = so; j = jo; }
  }
  if (lane == 0) { red_s[warp] = s; red_j[warp] = j; }
  __syncthreads();
  float bs = red_s[0];
  int bj = red_j[0];
  for (int w = 1; w < kWarps; ++w) {
    if (beats(red_s[w], red_j[w], bs, bj)) { bs = red_s[w]; bj = red_j[w]; }
  }
  __syncthreads();
  *out_s = bs;
  *out_j = bj;
}

__global__ void lid_sweep_kernel(
    const float* __restrict__ v_g, const int32_t* __restrict__ idx_g,
    const uint8_t* __restrict__ mask_g, const float* __restrict__ x_g,
    const float* __restrict__ ax_g, const int32_t* __restrict__ it_g,
    const uint8_t* __restrict__ cv_g, float* __restrict__ x_out,
    float* __restrict__ ax_out, int32_t* __restrict__ it_out,
    uint8_t* __restrict__ cv_out, int cap, int d, float k, int n_steps,
    int max_iters, float tol, int refresh_every, float support_eps,
    int use_smem, int pow2) {
  extern __shared__ float smem[];
  const long b = blockIdx.x;
  // lanes first, then the optional refresh trees, then the optional rows
  float* x = smem;
  float* ax = x + cap;
  float* v2 = ax + cap;
  int32_t* idx = reinterpret_cast<int32_t*>(v2 + cap);
  int32_t* msk = idx + cap;
  float* tree = reinterpret_cast<float*>(msk + cap);
  float* vs = tree + (refresh_every > 0 ? kWarps * pow2 : 0);
  __shared__ float red_s[kWarps];
  __shared__ int red_j[kWarps];
  __shared__ float pi_slot;

  const float* vrow = v_g + b * cap * d;
  const int ld = use_smem ? d + 1 : d;
  const float* V = use_smem ? vs : vrow;
  if (use_smem) stage_rows(vs, ld, vrow, cap, d);
  for (int j = threadIdx.x; j < cap; j += blockDim.x) {
    x[j] = x_g[b * cap + j];
    ax[j] = ax_g[b * cap + j];
    idx[j] = idx_g[b * cap + j];
    msk[j] = mask_g[b * cap + j] != 0;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cap; j += blockDim.x) {
    v2[j] = pinned_dot(V + j * ld, V + j * ld, d);
  }
  int it = it_g[b];
  bool cv = cv_g[b] != 0;
  __syncthreads();

  for (int step = 0; step < n_steps; ++step) {
    if (cv || it >= max_iters) break;  // block-uniform guard
    const float pi = pinned_pi(x, ax, cap, &pi_slot);

    float bs = -INFINITY;
    int bj = 0x7fffffff;
    for (int j = threadIdx.x; j < cap; j += blockDim.x) {
      const float r = msk[j] ? __fsub_rn(ax[j], pi) : 0.f;
      const bool c1 = msk[j] && r > tol;
      const bool c2 = msk[j] && r < -tol && x[j] > 0.f;
      const float s = (c1 || c2) ? fabsf(r) : -INFINITY;
      if (bj == 0x7fffffff || beats(s, j, bs, bj)) { bs = s; bj = j; }
    }
    float si;
    int i;
    block_argmax(bs, bj, red_s, red_j, &si, &i);
    const bool done = si <= tol;

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
      const float* vi = V + i * ld;
      const float v2i = v2[i];
      const int idi = idx[i];
      __syncthreads();  // every thread has read x[i], ax[i]
      for (int j = threadIdx.x; j < cap; j += blockDim.x) {
        float col = affinity(v2[j], v2i, pinned_dot(V + j * ld, vi, d), k);
        if (idx[j] == idi || !msk[j]) col = 0.f;
        const float onehot = j == i ? 1.f : 0.f;
        const float xj = x[j];
        const float axj = ax[j];
        x[j] = clamp_min0(
            __fadd_rn(xj, __fmul_rn(scale, __fsub_rn(onehot, xj))));
        ax[j] = __fadd_rn(axj, __fmul_rn(scale, __fsub_rn(col, axj)));
      }
      __syncthreads();
      if (refresh_every > 0 && (it + 1) % refresh_every == 0) {
        // exact Ax = masked matvec over the support, one warp per row,
        // reduced in the pinned tree_matvec order in the warp's buffer
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        float* buf = tree + warp * pow2;
        for (int j = warp; j < cap; j += kWarps) {
          const float* vj = V + j * ld;
          for (int l = lane; l < pow2; l += 32) {
            float prod = 0.f;
            if (l < cap) {
              const float wl = (msk[l] && x[l] > support_eps) ? x[l] : 0.f;
              float a = affinity(v2[j], v2[l], pinned_dot(vj, V + l * ld, d),
                                 k);
              if (idx[j] == idx[l]) a = 0.f;
              prod = __fmul_rn(a, wl);
            }
            buf[l] = prod;
          }
          __syncwarp();
          for (int half = pow2 >> 1; half > 0; half >>= 1) {
            for (int l = lane; l < half; l += 32) {
              buf[l] = __fadd_rn(buf[l], buf[l + half]);
            }
            __syncwarp();
          }
          if (lane == 0) ax[j] = msk[j] ? buf[0] : 0.f;
          __syncwarp();
        }
        __syncthreads();
      }
    }
    it += 1;
    cv = done;
  }

  for (int j = threadIdx.x; j < cap; j += blockDim.x) {
    x_out[b * cap + j] = x[j];
    ax_out[b * cap + j] = ax[j];
  }
  if (threadIdx.x == 0) {
    it_out[b] = it;
    cv_out[b] = cv ? 1 : 0;
  }
}

}  // namespace

extern "C" int lid_sweep_launch(
    const float* v, const int32_t* idx, const uint8_t* mask, const float* x,
    const float* ax, const int32_t* it, const uint8_t* cv, float* x_out,
    float* ax_out, int32_t* it_out, uint8_t* cv_out, int batch, int cap,
    int d, float k, int n_steps, int max_iters, float tol, int refresh_every,
    float support_eps, int use_smem, int smem_bytes, void* stream) {
  int pow2 = 1;
  while (pow2 < cap) pow2 <<= 1;
  // raise the dynamic shared-memory limit only when a launch needs more
  // than before, so that repeated launches (and CUDA graph captures of
  // them) make no further API call
  static int smem_limit = 0;
  const int smem_need = smem_bytes;
  if (smem_need > smem_limit) {
    const cudaError_t err = cudaFuncSetAttribute(
        lid_sweep_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_need);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_limit = smem_need;
  }
  if (batch > 0) {
    lid_sweep_kernel<<<batch, kThreads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
        v, idx, mask, x, ax, it, cv, x_out, ax_out, it_out, cv_out, cap, d,
        k, n_steps, max_iters, tol, refresh_every, support_eps, use_smem,
        pow2);
  }
  return static_cast<int>(cudaGetLastError());
}
