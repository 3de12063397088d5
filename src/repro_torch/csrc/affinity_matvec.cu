// Masked affinity x weights matvec behind the Ax refreshes (paper Eq. 13/17):
//   out[b, i] = sum_j [q_idx[b, i] != c_idx[b, j]] exp(-k ||q_bi - c_bj||) w_bj
//
// Replaces the TPU kernel `affinity_matvec_pallas` (src/repro/kernels/
// affinity_matvec.py, `_matvec_kernel`). The distance is the clamped
// expansion sqrt(max((|q|^2 + |c|^2) - 2 q.c, 0)), the diagonal is zeroed
// by comparing indices, and the n products of each output row are
// contracted in the pinned `tree_matvec` order: zero-padded to a power of
// two P and summed by halving, s[j] += s[j + half], in shared memory. Given
// equal products the sum is therefore bit-equal to the plain PyTorch
// version's. The seed batch is the grid's second dimension (the JAX
// package vmapped this op).
//
// What bounds it on an H100: neither bytes nor flops at the main path's
// sizes (m = cap = 240, n <= 240, d = 128, 32 seeds: ~0.5 GFLOP over ~8 MB
// of L2-resident rows); it is latency-bound, by the log2(P) synchronised
// levels of the pinned tree. One block takes kRows = 8 output rows: their q
// rows sit in shared memory, each warp reads whole c rows with coalesced
// loads and reduces |c|^2 and the 8 dots with shuffles, so every c row is
// read once per 8 outputs, and the 8 trees share their synchronised levels.
// |q|^2, |c|^2 and the dots are summed in the pinned order of
// kernels/ref.py (`pinned_sum`) with separate IEEE multiplies and adds, so
// on equal inputs the kernel gives its plain version's bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // output rows per block, one per warp for |q|^2

__global__ void affinity_matvec_kernel(const float* __restrict__ q,
                                       const int32_t* __restrict__ q_idx,
                                       const float* __restrict__ c,
                                       const int32_t* __restrict__ c_idx,
                                       const float* __restrict__ w,
                                       float* __restrict__ out,
                                       int m, int n, int d, int pow2,
                                       float k) {
  extern __shared__ float smem[];
  const int sp = pow2 + 1;          // tree row stride, off the bank period
  float* qs = smem;                 // (kRows, d) q rows of this block
  float* s = qs + kRows * d;        // (kRows, sp) products, then the trees
  __shared__ float q2s[kRows];
  __shared__ int qis[kRows];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long b = blockIdx.y;
  const int i0 = blockIdx.x * kRows;
  const int rows = min(kRows, m - i0);

  for (int e = threadIdx.x; e < kRows * d; e += blockDim.x) {
    const int r = e / d;
    qs[e] = r < rows ? q[(b * m + i0 + r) * d + (e - r * d)] : 0.f;
  }
  __syncthreads();
  {  // warp r: |q_r|^2 and the row's index (-2 past the ragged edge)
    const float* qr = qs + warp * d;
    float acc = lane < d ? __fmul_rn(qr[lane], qr[lane]) : 0.f;
    for (int t = lane + 32; t - lane < d; t += 32) {
      acc = __fadd_rn(acc, t < d ? __fmul_rn(qr[t], qr[t]) : 0.f);
    }
    acc = repro_kernels::warp_tree32(acc);
    if (lane == 0) {
      q2s[warp] = acc;
      qis[warp] = warp < rows ? q_idx[b * m + i0 + warp] : -2;
    }
  }
  __syncthreads();

  for (int j = warp; j < pow2; j += kWarps) {
    if (j >= n) {
      if (lane < kRows) s[lane * sp + j] = 0.f;
      continue;
    }
    // lane l: running sums of the products at t = l, l + 32, ... (the
    // pinned order), then the butterfly over the lanes
    const float* cr = c + (b * n + j) * d;
    float c2 = 0.f;
    float dot[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) dot[r] = 0.f;
    for (int t = lane; t - lane < d; t += 32) {
      const bool in = t < d;
      const float cv = in ? __ldg(cr + t) : 0.f;
      const float p2 = in ? __fmul_rn(cv, cv) : 0.f;
      c2 = t == lane ? p2 : __fadd_rn(c2, p2);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pr = in ? __fmul_rn(qs[r * d + t], cv) : 0.f;
        dot[r] = t == lane ? pr : __fadd_rn(dot[r], pr);
      }
    }
    c2 = repro_kernels::warp_tree32(c2);
#pragma unroll
    for (int r = 0; r < kRows; ++r) dot[r] = repro_kernels::warp_tree32(dot[r]);
    float mine = 0.f;  // lane r < kRows takes output row r
#pragma unroll
    for (int r = 0; r < kRows; ++r) mine = lane == r ? dot[r] : mine;
    if (lane < kRows) {
      const float a = repro_kernels::affinity(q2s[lane], c2, mine, k);
      s[lane * sp + j] =
          __fmul_rn(qis[lane] == c_idx[b * n + j] ? 0.f : a, w[b * n + j]);
    }
  }
  __syncthreads();
  for (int half = pow2 >> 1; half > 0; half >>= 1) {
    for (int e = threadIdx.x; e < kRows * half; e += blockDim.x) {
      const int r = e / half;
      const int jj = e - r * half;
      s[r * sp + jj] = __fadd_rn(s[r * sp + jj], s[r * sp + jj + half]);
    }
    __syncthreads();
  }
  if (threadIdx.x < rows) out[b * m + i0 + threadIdx.x] = s[threadIdx.x * sp];
}

}  // namespace

extern "C" int affinity_matvec_launch(const float* q, const int32_t* q_idx,
                                      const float* c, const int32_t* c_idx,
                                      const float* w, float* out, int batch,
                                      int m, int n, int d, float k,
                                      void* stream) {
  int pow2 = 1;
  while (pow2 < n) pow2 <<= 1;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kRows) * (d + pow2 + 1));
  // raise the dynamic shared-memory limit only when a launch needs more
  // than before, so that repeated launches (and CUDA graph captures of
  // them) make no further API call
  static int smem_limit = 0;
  const int smem_need = static_cast<int>(smem);
  if (smem_need > smem_limit) {
    const cudaError_t err = cudaFuncSetAttribute(
        affinity_matvec_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_need);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_limit = smem_need;
  }
  if (batch > 0 && m > 0) {
    dim3 grid((m + kRows - 1) / kRows, batch);
    affinity_matvec_kernel<<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        q, q_idx, c, c_idx, w, out, m, n, d, pow2, k);
  }
  return static_cast<int>(cudaGetLastError());
}
