// The backward passes of the two segment sums, segment_matmul.cu and
// embedding_bag.cu. The JAX package has no backward kernel for either: it
// differentiates its plain versions (src/repro/kernels/ref.py
// `segment_matmul_ref`, `embedding_bag_ref`), where the TPU kernels
// `segment_matmul_pallas` and `embedding_bag_pallas` serve the forward.
// These two kernels are the port's own.
//
// 1. `segment_matmul_bwd_kernel`, the gradient of the messages:
//      d_msg[e, :] = d_out[seg_ids[e], :] where 0 <= seg_ids[e] < n_seg,
//                    0 elsewhere (the pads, never read by the forward)
//    a row gather in the messages' type, a thread a vector of up to 16
//    bytes of a row, so it is bit-equal to its plain version
//    (kernels/ref.py `segment_matmul_bwd_ref`). What bounds it: bytes, the
//    ids read once, each row of d_msg written once and d_out's rows read
//    (from L2 where a node is named again).
// 2. `embedding_bag_bwd_kernel`, the gradient of the table:
//      d_table[v, :] = sum over the entries e whose id names row v of
//                      d_out[bag_ids[e], :] (divided by the bag's count for
//                      the mean)
//    over the entries the forward read whose id names a row: an id in
//    [0, V) in a bag of [0, n_bags). The forward reads row V - 1 for an id
//    at or past V, but its gradient is dropped, as in the JAX package,
//    whose transpose of the clamped gather is a scatter that skips
//    out-of-bounds rows. The wrapper lays the entries
//    out by table row (kernels/segment_matmul.py `segment_layout`, a stable
//    sort, the skipped entries in an overflow bin), and one group of lanes
//    sums one table row's entries in input order from +0, in f32, as
//    segment_sum.cuh does for the forward; a row no entry names is 0. So it
//    is bit-equal to its plain version (kernels/ref.py
//    `embedding_bag_bwd_ref`). What bounds it: bytes, the layout and bag
//    ids read once, d_table written once, d_out's rows read once per entry
//    (L2 holds BST's 65,536 x 2 bags of 128 bytes).

#include "segment_sum.cuh"
#include "static_smem.cuh"

namespace {

using repro_kernels::Raw;
using repro_kernels::seg_store;
using repro_kernels::seg_to_f32;

constexpr int kThreads = 256;

template <typename T, int VEC, typename I>
__global__ void __launch_bounds__(kThreads)
    segment_matmul_bwd_kernel(const T* __restrict__ d_out,
                              const I* __restrict__ seg,
                              T* __restrict__ d_msg, long long n_rows,
                              long long n_seg, int d) {
  using raw_t = typename Raw<sizeof(T) * VEC>::type;
  const int per_row = d / VEC;
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const long long e = t / per_row;
  if (e >= n_rows) return;
  const int c0 = static_cast<int>(t - e * per_row) * VEC;
  const long long s = static_cast<long long>(seg[e]);
  raw_t raw;
  if (s >= 0 && s < n_seg) {
    raw = __ldg(reinterpret_cast<const raw_t*>(d_out + s * d + c0));
  } else {
    memset(&raw, 0, sizeof(raw));
  }
  *reinterpret_cast<raw_t*>(d_msg + e * d + c0) = raw;
}

template <typename T, int VEC, typename I>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_bwd_kernel(const T* __restrict__ d_out,
                             const I* __restrict__ bag_ids,
                             const float* __restrict__ counts,
                             const long long* __restrict__ perm,
                             const long long* __restrict__ bounds,
                             T* __restrict__ d_table, long long v_rows,
                             int dim, int group) {
  using raw_t = typename Raw<sizeof(T) * VEC>::type;
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const long long row = t / group;
  if (row >= v_rows) return;
  const int lane = static_cast<int>(t - row * group);
  const long long lo = bounds[row], hi = bounds[row + 1];
  for (int c0 = lane * VEC; c0 < dim; c0 += group * VEC) {
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    for (long long i = lo; i < hi; ++i) {
      const long long bag = static_cast<long long>(bag_ids[perm[i]]);
      const raw_t raw = __ldg(reinterpret_cast<const raw_t*>(
          d_out + bag * dim + c0));
      T x[VEC];
      memcpy(x, &raw, sizeof(raw));
      const float cnt = counts != nullptr ? counts[bag] : 1.f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float g = seg_to_f32(x[j]);
        acc[j] = __fadd_rn(acc[j], counts != nullptr ? __fdiv_rn(g, cnt) : g);
      }
    }
    T* o = d_table + row * static_cast<long long>(dim) + c0;
#pragma unroll
    for (int j = 0; j < VEC; ++j) seg_store(o + j, acc[j]);
  }
}

template <typename K, typename... Args>
cudaError_t launch_threads(K kernel, long long threads, cudaStream_t stream,
                           Args... args) {
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t seg_bwd(const void* d_out, const void* seg, void* d_msg,
                    long long n_rows, long long n_seg, int d, int ids64,
                    cudaStream_t st) {
  const long long threads = n_rows * (d / VEC);
  const T* g = static_cast<const T*>(d_out);
  T* out = static_cast<T*>(d_msg);
  if (ids64) {
    return launch_threads(segment_matmul_bwd_kernel<T, VEC, long long>,
                          threads, st, g,
                          static_cast<const long long*>(seg), out, n_rows,
                          n_seg, d);
  }
  return launch_threads(segment_matmul_bwd_kernel<T, VEC, int>, threads, st,
                        g, static_cast<const int*>(seg), out, n_rows, n_seg,
                        d);
}

template <typename T, int VEC>
cudaError_t bag_bwd(const void* d_out, const void* bag_ids,
                    const float* counts, const long long* perm,
                    const long long* bounds, void* d_table, long long v_rows,
                    int dim, int ids64, int group, cudaStream_t st) {
  const T* g = static_cast<const T*>(d_out);
  T* out = static_cast<T*>(d_table);
  if (ids64) {
    return launch_threads(embedding_bag_bwd_kernel<T, VEC, long long>,
                          v_rows * group, st, g,
                          static_cast<const long long*>(bag_ids), counts,
                          perm, bounds, out, v_rows, dim, group);
  }
  return launch_threads(embedding_bag_bwd_kernel<T, VEC, int>,
                        v_rows * group, st, g,
                        static_cast<const int*>(bag_ids), counts, perm,
                        bounds, out, v_rows, dim, group);
}

}  // namespace

// d_out (n_seg, d), d_msg (n_rows, d) in one type, seg_ids (n_rows,) int32
// or int64 (ids64); vec elements a load (dividing d and both bases, from
// kernels/segment_matmul.py `lane_plan`).
extern "C" int segment_matmul_bwd_launch(const void* d_out,
                                         const void* seg_ids, void* d_msg,
                                         long long n_rows, long long n_seg,
                                         int d, int is_bf16, int ids64,
                                         int vec, void* stream) {
  if (n_rows < 0 || n_seg < 0 || d <= 0 || vec <= 0 || d % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define REPRO_SEG_BWD(T, V) \
  err = seg_bwd<T, V>(d_out, seg_ids, d_msg, n_rows, n_seg, d, ids64, st)
  if (is_bf16) {
    switch (vec) {
      case 8: REPRO_SEG_BWD(__nv_bfloat16, 8); break;
      case 4: REPRO_SEG_BWD(__nv_bfloat16, 4); break;
      case 2: REPRO_SEG_BWD(__nv_bfloat16, 2); break;
      case 1: REPRO_SEG_BWD(__nv_bfloat16, 1); break;
    }
  } else {
    switch (vec) {
      case 4: REPRO_SEG_BWD(float, 4); break;
      case 2: REPRO_SEG_BWD(float, 2); break;
      case 1: REPRO_SEG_BWD(float, 1); break;
    }
  }
#undef REPRO_SEG_BWD
  return static_cast<int>(err);
}

// d_out (n_bags, dim) and d_table (v_rows, dim) in one type; bag_ids (N,)
// int32 or int64 (ids64); counts (n_bags,) f32 for the mean, else null;
// perm (N,) and bounds (v_rows + 1,) int64, the layout by table row
// (kernels/segment_matmul.py `segment_layout`); vec and group from its
// `lane_plan`.
extern "C" int embedding_bag_bwd_launch(const void* d_out,
                                        const void* bag_ids,
                                        const float* counts,
                                        const long long* perm,
                                        const long long* bounds,
                                        void* d_table, long long v_rows,
                                        int dim, int n_bags, int is_bf16,
                                        int ids64, int vec, int group,
                                        void* stream) {
  if (v_rows <= 0 || dim <= 0 || n_bags < 0 || group <= 0 || group > 32 ||
      (group & (group - 1)) != 0 || vec <= 0 || dim % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define REPRO_BAG_BWD(T, V)                                                  \
  err = bag_bwd<T, V>(d_out, bag_ids, counts, perm, bounds, d_table, v_rows, \
                      dim, ids64, group, st)
  if (is_bf16) {
    switch (vec) {
      case 8: REPRO_BAG_BWD(__nv_bfloat16, 8); break;
      case 4: REPRO_BAG_BWD(__nv_bfloat16, 4); break;
      case 2: REPRO_BAG_BWD(__nv_bfloat16, 2); break;
      case 1: REPRO_BAG_BWD(__nv_bfloat16, 1); break;
    }
  } else {
    switch (vec) {
      case 4: REPRO_BAG_BWD(float, 4); break;
      case 2: REPRO_BAG_BWD(float, 2); break;
      case 1: REPRO_BAG_BWD(float, 1); break;
    }
  }
#undef REPRO_BAG_BWD
  return static_cast<int>(err);
}

// the static shared bytes of this source's kernels (static_smem.cuh)
extern "C" int segment_bwd_static_smem(int* bytes) {
  return repro_smem::max_static(
      {repro_smem::fn(segment_matmul_bwd_kernel<float, 4, int>),
       repro_smem::fn(segment_matmul_bwd_kernel<float, 4, long long>),
       repro_smem::fn(segment_matmul_bwd_kernel<__nv_bfloat16, 8, int>),
       repro_smem::fn(embedding_bag_bwd_kernel<float, 4, int>),
       repro_smem::fn(embedding_bag_bwd_kernel<float, 4, long long>),
       repro_smem::fn(embedding_bag_bwd_kernel<__nv_bfloat16, 8, int>)},
      bytes);
}
